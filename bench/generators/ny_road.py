"""A road lattice at a road network's size: a frozen copy of
``repro_torch.graphs.generators.road_grid`` (a 2-D lattice plus a few random
shortcuts), laid row-major over exactly ``n`` nodes, with two changes: a
seeded share of lattice cells gets a diagonal, so that the graph has
triangles, and the simple edge set is thinned from the seed to exactly
``m`` edges. Each edge is one record, in generation order; the driver
orders them per session.
"""
from __future__ import annotations

import numpy as np


def canonical_edges(raw: np.ndarray) -> np.ndarray:
    """Self-loops dropped, multi-edges merged, each edge as (lo, hi),
    sorted: ``repro_torch.graphs.formats.canonical_edges`` without its
    container."""
    raw = np.asarray(raw, dtype=np.int64).reshape(-1, 2)
    u = np.minimum(raw[:, 0], raw[:, 1])
    v = np.maximum(raw[:, 0], raw[:, 1])
    keep = u != v
    return np.unique(np.stack([u[keep], v[keep]], axis=1), axis=0)


def generate(params: dict, seed: int) -> tuple[int, np.ndarray]:
    """(n, int32 (m, 2) records): a lattice over ``n`` nodes (``cols`` =
    ceil(sqrt(n)) a row, the last row partial), a diagonal in a
    ``diagonal_share`` of its cells, ``shortcut_share``·n random shortcuts,
    thinned to ``m`` edges."""
    n, m = int(params["n"]), int(params["m"])
    rng = np.random.default_rng(seed)
    cols = int(np.ceil(np.sqrt(n)))
    i = np.arange(n, dtype=np.int64)
    right = i[(i % cols != cols - 1) & (i + 1 < n)]
    down = i[i + cols < n]
    cell = right[right + cols + 1 < n]  # top-left corner of a whole cell
    diag = cell[rng.random(len(cell)) < float(params["diagonal_share"])]
    k = int(float(params["shortcut_share"]) * n)
    edges = canonical_edges(np.concatenate([
        np.stack([right, right + 1], 1), np.stack([down, down + cols], 1),
        np.stack([diag, diag + cols + 1], 1), rng.integers(0, n, size=(k, 2))]))
    if len(edges) < m:
        raise ValueError(f"the lattice has {len(edges)} edges, fewer than m={m}")
    keep = np.sort(rng.choice(len(edges), size=m, replace=False))
    return n, edges[keep].astype(np.int32)
