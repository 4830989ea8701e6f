"""Responsible-node partitioning and stage load balancing.

The paper's pipeline spawns one filter per responsible node; the filter's
work is |adj(r)| during partition and |adj(r)|-pair checks during counting.
On a fixed-size device ring we instead assign responsible nodes to S stages.
The counting work of rank r is ~fwd_deg(r)² (pairs of forward neighbors),
so the "curse of the last reducer" (stage skew / stragglers) is avoided by
balancing Σ fwd_deg² per stage. ``ring_partition`` produces a total order
whose contiguous R-row blocks have near-equal cost, so the dense ring can
use plain contiguous row blocks and still be balanced.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.formats import Graph, degree_order


@dataclasses.dataclass(frozen=True)
class RingPartition:
    """Stage-balanced total order, padded so every stage owns exactly R ranks.

    rank: (n_nodes,) int32 — rank of each real node in padded rank space
          [0, n_stages*rows_per_stage). Phantom (padding) ranks have no edges.
    n_stages, rows_per_stage: block geometry; stage s owns ranks
          [s*R, (s+1)*R).
    """

    rank: np.ndarray
    n_stages: int
    rows_per_stage: int

    @property
    def n_pad(self) -> int:
        return self.n_stages * self.rows_per_stage


def forward_degrees(g: Graph, rank: np.ndarray) -> np.ndarray:
    """fwd_deg in rank space: fwd_deg[r] = #neighbors with larger rank."""
    ru = rank[g.edges[:, 0]]
    rv = rank[g.edges[:, 1]]
    lo = np.minimum(ru, rv)
    fdeg = np.bincount(lo, minlength=g.n_nodes)
    return fdeg.astype(np.int64)


def snake_assign(cost: np.ndarray, n_stages: int) -> np.ndarray:
    """Assign items (desc-sorted by cost) to stages in snake order.

    Near-LPT balance at O(n log n); per-stage item counts differ by ≤ 1.
    Returns stage id per item.
    """
    order = np.argsort(-cost, kind="stable")
    stage = np.empty(len(cost), dtype=np.int32)
    fwd = np.arange(n_stages)
    snake = np.concatenate([fwd, fwd[::-1]])
    stage[order] = snake[np.arange(len(cost)) % (2 * n_stages)]
    return stage


def ring_partition(
    g: Graph, n_stages: int, *, base: str = "degree", balance: bool = True, pad_to: int = 1
) -> RingPartition:
    """Build the stage-balanced padded rank order for the dense/bitset ring.

    Any total order gives a correct forward count (each triangle counted once,
    at its min-rank vertex); this one additionally equalizes stage work.
    ``balance=False`` keeps plain contiguous degree-order blocks (the
    unbalanced baseline the hillclimb starts from). ``pad_to`` rounds
    rows_per_stage up (e.g. 64 for tile-aligned kernel blocks).
    """
    rank0 = degree_order(g, mode=base)
    if balance:
        fdeg = forward_degrees(g, rank0)
        cost = np.empty(g.n_nodes, dtype=np.float64)
        cost[rank0] = fdeg.astype(np.float64) ** 2  # cost indexed by node
        stage_of_node = snake_assign(cost, n_stages)
    else:
        rows = -(-g.n_nodes // n_stages)
        stage_of_node = (rank0 // rows).astype(np.int32)
    counts = np.bincount(stage_of_node, minlength=n_stages)
    rows = int(counts.max())
    rows = -(-rows // pad_to) * pad_to
    rank = np.empty(g.n_nodes, dtype=np.int32)
    for s in range(n_stages):
        nodes = np.nonzero(stage_of_node == s)[0]
        nodes = nodes[np.argsort(rank0[nodes], kind="stable")]  # keep base order
        rank[nodes] = s * rows + np.arange(len(nodes), dtype=np.int32)
    return RingPartition(rank=rank, n_stages=n_stages, rows_per_stage=rows)


def stage_costs(g: Graph, part: RingPartition) -> np.ndarray:
    """Σ fwd_deg² per stage under the partition — the straggler diagnostic."""
    ru = part.rank[g.edges[:, 0]]
    rv = part.rank[g.edges[:, 1]]
    lo = np.minimum(ru, rv)
    fdeg = np.bincount(lo, minlength=part.n_pad).astype(np.float64)
    per_rank = fdeg**2
    return per_rank.reshape(part.n_stages, part.rows_per_stage).sum(axis=1)


def choose_n_stages_for(n_nodes: int, max_stages: int, *, min_rows_per_stage: int = 8) -> int:
    """``choose_n_stages`` on a bare node count (what the api planner has
    when the graph only exists as stats)."""
    return int(max(1, min(max_stages, n_nodes // min_rows_per_stage or 1)))


def choose_n_stages(g: Graph, max_stages: int, *, min_rows_per_stage: int = 8) -> int:
    """Adaptive stage count — the device-ring analogue of the pipeline growing/shrinking.

    Small inputs use fewer stages (less ring latency); never more stages than
    rows to fill. Mirrors the paper's |V|-1 upper bound on filter count.
    """
    return choose_n_stages_for(g.n_nodes, max_stages, min_rows_per_stage=min_rows_per_stage)
