"""Oracle triangle counters (numpy, host-side, used only by tests/benches)."""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.formats import Graph, dense_adjacency


def count_triangles_brute(g: Graph) -> int:
    """trace(A^3)/6 in float64 — exact for any graph that fits densely."""
    a = dense_adjacency(g, dtype=np.float64)
    return int(round(np.einsum("ij,jk,ki->", a, a, a) / 6.0))


def count_triangles_dense_ref(u: np.ndarray) -> int:
    """sum(U ⊙ (U @ U)) on a strictly-upper-triangular forward adjacency."""
    u = np.asarray(u, dtype=np.float64)
    return int(round(float(((u @ u) * u).sum())))
