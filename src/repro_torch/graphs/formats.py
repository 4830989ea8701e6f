"""Graph containers and format conversions.

The paper's precondition is an undirected *simple* graph delivered as an
unordered edge stream; multi-edges are filtered in a pre-processing stage.
``canonical_edges`` is that stage. All host-side construction is numpy (the
data pipeline layer); PyTorch consumes the padded / dense artifacts.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected simple graph as a canonical edge list.

    edges: (m, 2) int32 with edges[i, 0] < edges[i, 1], unique rows.
    n_nodes: number of vertices (ids are 0..n_nodes-1; isolated nodes allowed).
    """

    edges: np.ndarray
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def density(self) -> float:
        n = self.n_nodes
        return 0.0 if n < 2 else self.n_edges / (n * (n - 1) / 2)

    def degrees(self) -> np.ndarray:
        deg = np.zeros(self.n_nodes, dtype=np.int64)
        np.add.at(deg, self.edges[:, 0], 1)
        np.add.at(deg, self.edges[:, 1], 1)
        return deg


def canonical_edges(raw: np.ndarray, n_nodes: int | None = None) -> Graph:
    """Pre-processing stage: drop self loops + multi-edges, canonicalize u<v."""
    raw = np.asarray(raw, dtype=np.int64).reshape(-1, 2)
    u = np.minimum(raw[:, 0], raw[:, 1])
    v = np.maximum(raw[:, 0], raw[:, 1])
    keep = u != v
    uv = np.stack([u[keep], v[keep]], axis=1)
    uv = np.unique(uv, axis=0)
    if n_nodes is None:
        n_nodes = int(uv.max()) + 1 if uv.size else 0
    return Graph(edges=uv.astype(np.int32), n_nodes=n_nodes)


def degree_order(g: Graph, *, mode: str = "degree") -> np.ndarray:
    """Total order on nodes → rank[node].

    ``degree``: descending degree (min-rank endpoint of each edge gets the edge;
    high-degree nodes become responsible early, bounding forward degrees — the
    load-balancing refinement of the paper's arrival order).
    ``arrival``: paper-faithful — order of first appearance in the edge stream.
    """
    if mode == "degree":
        deg = g.degrees()
        order = np.argsort(-deg, kind="stable")
    elif mode == "arrival":
        flat = g.edges.reshape(-1)
        _, first_idx = np.unique(flat, return_index=True)
        seen = flat[np.sort(first_idx)]
        rest = np.setdiff1d(np.arange(g.n_nodes), seen, assume_unique=False)
        order = np.concatenate([seen, rest])
    else:
        raise ValueError(f"unknown order mode {mode!r}")
    rank = np.empty(g.n_nodes, dtype=np.int32)
    rank[order] = np.arange(g.n_nodes, dtype=np.int32)
    return rank


def dense_adjacency(g: Graph, dtype=np.float32) -> np.ndarray:
    """Symmetric dense adjacency (n, n)."""
    a = np.zeros((g.n_nodes, g.n_nodes), dtype=dtype)
    a[g.edges[:, 0], g.edges[:, 1]] = 1
    a[g.edges[:, 1], g.edges[:, 0]] = 1
    return a


def forward_adjacency_dense(g: Graph, rank: np.ndarray | None = None, dtype=np.float32) -> np.ndarray:
    """Strictly upper-triangular adjacency U under the rank permutation.

    U[r, s] = 1 iff the edge exists and rank r < rank s. Node ids are the
    RANKS (rows/cols are rank-permuted). sum(U ⊙ (U @ U)) counts each triangle
    exactly once, at its min-rank vertex — the dynamic-pipeline counting
    semantics.
    """
    if rank is None:
        rank = degree_order(g)
    ru = rank[g.edges[:, 0]]
    rv = rank[g.edges[:, 1]]
    lo = np.minimum(ru, rv)
    hi = np.maximum(ru, rv)
    u = np.zeros((g.n_nodes, g.n_nodes), dtype=dtype)
    u[lo, hi] = 1
    return u


def forward_adjacency_padded(
    g: Graph, rank: np.ndarray | None = None, max_deg: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Padded sorted forward-adjacency in rank space.

    Returns (nbrs, deg): nbrs is (n, max_deg) int32 — row r lists the ranks of
    forward neighbors of the node with rank r, ascending, padded with n (an
    out-of-range sentinel that never matches a real rank); deg is (n,).
    """
    if rank is None:
        rank = degree_order(g)
    n = g.n_nodes
    ru = rank[g.edges[:, 0]]
    rv = rank[g.edges[:, 1]]
    lo = np.minimum(ru, rv)
    hi = np.maximum(ru, rv)
    order = np.lexsort((hi, lo))
    lo, hi = lo[order], hi[order]
    deg = np.bincount(lo, minlength=n).astype(np.int32)
    md = int(deg.max()) if deg.size and deg.max() > 0 else 1
    if max_deg is not None:
        if max_deg < md:
            raise ValueError(f"max_deg {max_deg} < required {md}")
        md = max_deg
    nbrs = np.full((n, md), n, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(deg)])[:-1]
    col = np.arange(len(lo)) - starts[lo]
    nbrs[lo, col] = hi
    return nbrs, deg


def to_csr(g: Graph) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric CSR (indptr, indices) over original node ids, sorted rows."""
    n = g.n_nodes
    src = np.concatenate([g.edges[:, 0], g.edges[:, 1]])
    dst = np.concatenate([g.edges[:, 1], g.edges[:, 0]])
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, dst.astype(np.int32)
