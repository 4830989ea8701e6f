"""Benchmark graph generators (Table 1 of the paper, synthetic analogues).

DSJC.* are Erdős–Rényi-style G(n, p) at densities .1/.5/.9 (the DIMACS DSJC
coloring instances are random graphs of exactly this family); FNA.* fix the
number of arcs at 10M and shrink n to raise density; NY is a sparse
road-network-like grid (avg degree ~2.8, density ~1e-5); Facebook-SNAP(107)
is a small dense-community power-law graph.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.formats import Graph, canonical_edges


def gnp_edge_blocks(n: int, p: float, seed: int = 0):
    """Row-block edge generator behind ``gnp``: yields each row block's (B, 2)
    canonical edges without ever materializing the full edge list. The rng
    call sequence is identical to ``gnp``'s, so consuming the whole stream
    reproduces exactly ``gnp(n, p, seed).edges`` — the streaming regime sees
    the same graph the resident paths do."""
    rng = np.random.default_rng(seed)
    # Row-block construction to bound peak memory at O(block * n).
    block = max(1, min(n, int(4e7 // max(n, 1))))
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        mask = rng.random((r1 - r0, n)) < p
        rows, cols = np.nonzero(mask)
        rows = rows + r0
        keep = cols > rows  # upper triangle only
        yield np.stack([rows[keep], cols[keep]], axis=1)


def gnp(n: int, p: float, seed: int = 0) -> Graph:
    """G(n, p): each of the n(n-1)/2 edges present independently w.p. p."""
    blocks = list(gnp_edge_blocks(n, p, seed=seed))
    edges = np.concatenate(blocks, axis=0) if blocks else np.zeros((0, 2), np.int64)
    return Graph(edges=edges.astype(np.int32), n_nodes=n)


def fixed_arcs(n: int, m: int, seed: int = 0) -> Graph:
    """FNA family: exactly m distinct undirected edges over n nodes."""
    max_m = n * (n - 1) // 2
    if m > max_m:
        raise ValueError(f"m={m} exceeds max {max_m} for n={n}")
    rng = np.random.default_rng(seed)
    if m > max_m // 3:
        # Dense regime: sample without replacement from the edge index space.
        idx = rng.choice(max_m, size=m, replace=False)
        # invert the triangular index: edge k -> (u, v), u < v
        u = (np.floor((2 * n - 1 - np.sqrt((2 * n - 1) ** 2 - 8.0 * idx)) / 2)).astype(np.int64)
        base = u * (2 * n - u - 1) // 2
        v = (idx - base + u + 1).astype(np.int64)
        edges = np.stack([u, v], axis=1)
        return Graph(edges=edges.astype(np.int32), n_nodes=n)
    # Sparse regime: rejection sampling.
    got = np.zeros((0, 2), dtype=np.int64)
    while got.shape[0] < m:
        need = int((m - got.shape[0]) * 1.3) + 16
        cand = rng.integers(0, n, size=(need, 2))
        cand = cand[cand[:, 0] != cand[:, 1]]
        lo = np.minimum(cand[:, 0], cand[:, 1])
        hi = np.maximum(cand[:, 0], cand[:, 1])
        got = np.unique(np.concatenate([got, np.stack([lo, hi], 1)], axis=0), axis=0)
    keep = rng.permutation(got.shape[0])[:m]
    return Graph(edges=got[np.sort(keep)].astype(np.int32), n_nodes=n)


def road_grid(rows: int, cols: int, seed: int = 0, extra_frac: float = 0.05) -> Graph:
    """NY-road-like: 2D lattice + a few shortcut edges. Density ~O(1/n)."""
    n = rows * cols
    idx = np.arange(n).reshape(rows, cols)
    horiz = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    vert = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    edges = [horiz, vert]
    if extra_frac > 0:
        rng = np.random.default_rng(seed)
        k = int(extra_frac * n)
        cand = rng.integers(0, n, size=(k, 2))
        edges.append(cand)
    return canonical_edges(np.concatenate(edges, axis=0), n_nodes=n)


def powerlaw(n: int, m_per_node: int = 8, seed: int = 0) -> Graph:
    """Barabási–Albert preferential attachment (Facebook-ego-like topology)."""
    rng = np.random.default_rng(seed)
    m0 = m_per_node + 1
    src, dst = [], []
    # seed clique
    for i in range(m0):
        for j in range(i + 1, m0):
            src.append(i)
            dst.append(j)
    targets = np.array(src + dst, dtype=np.int64)  # endpoint multiset ~ degree
    for v in range(m0, n):
        picks = targets[rng.integers(0, len(targets), size=m_per_node * 2)]
        picks = np.unique(picks)[:m_per_node]
        for t in picks:
            src.append(int(t))
            dst.append(v)
        targets = np.concatenate([targets, picks, np.full(len(picks), v)])
    raw = np.stack([np.array(src), np.array(dst)], axis=1)
    return canonical_edges(raw, n_nodes=n)
