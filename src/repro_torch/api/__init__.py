"""Unified counting API: one planned front door, on one device.

The paper ("Comparing MapReduce and Pipeline Implementations for Counting
Triangles") shows that the right Divide-and-Conquer *shape* is a function of
measurable input properties; this package encodes that finding as
``plan(GraphStats, Resources) -> Plan`` and executes every plan through one
``TriangleCounter`` returning one ``CountResult`` contract — the reference's
API, in PyTorch, on a CUDA device.

Plan method → paper section map:

- ``dense`` / ``ring``   — the dynamic pipeline (§3, Figs 4–9): filters hold
  forward adjacency; on the card the filter chain is the dense U·U⊙U
  contraction (the live-grid kernel), row-block-split over stages for
  ``ring`` (one masked matmul-sum kernel per stage × block visit). Wins on
  the dense DSJC/FNA families (§5, Figs 10–13).
- ``sparse``             — the same pipeline semantics on padded sorted
  forward-adjacency; the memory-bound rendering that handles the NY road
  network (§5 Table 1's sparse extreme).
- ``bitset_ring``        — the most literal edge-streaming pipeline: stage-
  resident membership bitsets, edge blocks flowing through the stages (§3's
  filter/forward loop), each visit one bitset edge-count kernel.
- ``mapreduce``          — the Suri–Vassilvitskii two-round baseline (§4).
  The planner refuses it when the replication factor Σ_v C(deg(v), 2)
  (Afrati–Ullman's communication cost, §2 related work) exceeds
  ``MR_RF_FACTOR``× the input — the paper's dense-graph blowup.
- ``stream``             — planned as in the reference; executing it comes
  with the port's streaming slice.
"""
from repro_torch.api.planner import (
    ADMISSION_ONLY,
    METHODS,
    MR_RF_FACTOR,
    GraphStats,
    HybridSizing,
    Plan,
    Resources,
    backend_exec_flags,
    hybrid_sizing,
    plan,
    plan_for_graph,
    stream_sizing,
)
from repro_torch.api.counter import (
    CountResult,
    TriangleCounter,
    bucket,
    count_triangles,
)

__all__ = [
    "ADMISSION_ONLY",
    "METHODS",
    "MR_RF_FACTOR",
    "GraphStats",
    "HybridSizing",
    "Plan",
    "Resources",
    "backend_exec_flags",
    "hybrid_sizing",
    "plan",
    "plan_for_graph",
    "stream_sizing",
    "CountResult",
    "TriangleCounter",
    "bucket",
    "count_triangles",
]
