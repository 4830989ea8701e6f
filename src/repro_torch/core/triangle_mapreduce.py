"""Suri–Vassilvitskii two-round MapReduce triangle counting (the baseline).

Faithful to the paper's Go implementation of [Suri & Vassilvitskii, WWW'11]:

Round I  (Map/Shuffle/Reduce): group edges by node (adjacency lists), then
          each reducer enumerates ALL 2-paths (a, v, b) through its nodes —
          the O(Σ_v deg(v)²) replication factor that makes MapReduce blow up
          on dense graphs is materialized work here, exactly as in the paper.
Round II (Map/Shuffle/Reduce): key both path-triples and edge-triples by
          their endpoints {a, b}; a reducer holding an edge and k paths
          reports k triangles. Every triangle is reported 3× (once per apex),
          so the collector divides by 3.

The PyTorch rendering: the per-node pair enumeration is the reducer, node
batches are the mappers, the endpoint join is a batched ``torch.searchsorted``
over int64 keys. The keys are int64 on every device, so the u·base + v
encoding needs no clamp. ``streaming=True`` follows the paper's
MapReduce-Online choice (rounds pipelined, 2-paths probed as produced);
``streaming=False`` materializes the full Round-I output the way stock
Hadoop would, for the virtual-memory comparison figure.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.formats import Graph
from repro_torch.utils import count_dtype, resolve_device


def build_mapreduce_operands(g: Graph, *, max_deg: int | None = None,
                             key_base: int | None = None) -> tuple[np.ndarray, np.ndarray, int]:
    """Symmetric padded adjacency (n, dmax) + sorted edge keys (m,).

    ``key_base`` overrides the base of the (u, v) -> u*base + v key encoding
    (default: n). Callers that re-pad the operands into a larger padded node
    space (the api counter's shape buckets) pass their bucket size so the
    keys are built — and sorted — once."""
    n = g.n_nodes
    deg = g.degrees()
    dmax = int(deg.max()) if len(deg) else 1
    if max_deg is not None:
        dmax = max(dmax, max_deg)
    nbrs = np.full((n, dmax), n, dtype=np.int64)
    src = np.concatenate([g.edges[:, 0], g.edges[:, 1]]).astype(np.int64)
    dst = np.concatenate([g.edges[:, 1], g.edges[:, 0]]).astype(np.int64)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    col = np.arange(len(src)) - starts[src]
    nbrs[src, col] = dst
    base = n if key_base is None else key_base
    keys = np.sort(g.edges[:, 0].astype(np.int64) * base + g.edges[:, 1].astype(np.int64))
    return nbrs, keys, n


def _probe(path_keys: torch.Tensor, edge_keys: torch.Tensor) -> torch.Tensor:
    """Bool per key: is it one of the sorted ``edge_keys`` (the Round-II join)."""
    pos = torch.searchsorted(edge_keys, path_keys).clamp_(0, edge_keys.shape[0] - 1)
    return edge_keys[pos] == path_keys


def _mapreduce_count(nbrs: torch.Tensor, edge_keys: torch.Tensor, *, n: int,
                     node_batch: int) -> torch.Tensor:
    """Streaming (MapReduce-Online) fused rounds: per node batch, enumerate
    2-paths and immediately probe the edge-key set. ``nbrs`` (n_nodes, dmax)
    int64 holds sentinel ``n`` past each row's fill; ``n`` is also the key
    base. Returns the int64 count on the operands' device."""
    total = torch.zeros((), dtype=count_dtype(), device=nbrs.device)
    for s in range(0, nbrs.shape[0], node_batch):
        rows = nbrs[s:s + node_batch]
        a, b = rows[:, :, None], rows[:, None, :]
        valid = (a < b) & (b < n)  # unordered pair once; sentinel n excluded
        hit = _probe((a * n + b).reshape(-1), edge_keys) & valid.reshape(-1)
        total += hit.sum()
    return total // 3


def _mapreduce_two_round(nbrs: torch.Tensor, edge_keys: torch.Tensor, *,
                         n: int) -> torch.Tensor:
    """Literal two-round version: Round I materializes the complete 2-path
    key multiset (the replication-factor memory blowup), Round II sorts and
    joins. Intentionally memory-hungry — used by the VM figure."""
    a, b = nbrs[:, :, None], nbrs[:, None, :]
    valid = (a < b) & (b < n)
    path_keys = torch.where(valid, a * n + b, -1).reshape(-1)  # Round-I output
    path_keys = torch.sort(path_keys).values  # Shuffle of Round II
    hit = _probe(path_keys, edge_keys) & (path_keys >= 0)
    return hit.sum(dtype=count_dtype()) // 3


def count_triangles_mapreduce(g: Graph, *, node_batch: int = 256,
                              streaming: bool = True, device=None) -> int:
    dev = resolve_device(device)
    nbrs, keys, n = build_mapreduce_operands(g)
    nbrs_t = torch.from_numpy(nbrs).to(dev)
    keys_t = torch.from_numpy(keys).to(dev)
    if streaming:
        return int(_mapreduce_count(nbrs_t, keys_t, n=n, node_batch=node_batch))
    return int(_mapreduce_two_round(nbrs_t, keys_t, n=n))


def mapreduce_replication_factor(g: Graph) -> int:
    """|Round-I output| = Σ_v C(deg(v), 2) — the paper's scaling culprit."""
    deg = g.degrees()
    return int((deg * (deg - 1) // 2).sum())
