"""Assigned input-shape sets per architecture family (the 40 cells), a copy
of the reference's ``repro/configs/shapes.py``.

Each shape names the step function it lowers: ``train_step`` for training
shapes, ``prefill`` for inference-prefill, ``serve_step`` (one new token with
a seq_len KV cache) for decode shapes. ``chip_smoke.py`` [gnn] takes its
graph sizes from ``GNN_SHAPES``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


LM_SHAPES = [
    LMShape("train_4k", 4_096, 256, "train"),
    LMShape("prefill_32k", 32_768, 32, "prefill"),
    LMShape("decode_32k", 32_768, 128, "decode"),
    LMShape("long_500k", 524_288, 1, "decode"),
]


@dataclasses.dataclass(frozen=True)
class GraphShape:
    name: str
    n_nodes: int
    n_edges: int
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple[int, ...] = ()
    batch_graphs: int = 0
    kind: str = "full"  # full | minibatch | batched_small


GNN_SHAPES = [
    GraphShape("full_graph_sm", 2_708, 10_556, d_feat=1_433, kind="full"),
    GraphShape(
        "minibatch_lg", 232_965, 114_615_892, batch_nodes=1_024, fanout=(15, 10), kind="minibatch"
    ),
    GraphShape("ogb_products", 2_449_029, 61_859_140, d_feat=100, kind="full"),
    GraphShape("molecule", 30, 64, batch_graphs=128, kind="batched_small"),
]


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    batch: int
    n_candidates: int = 0
    kind: str = "train"  # train | serve | retrieval


RECSYS_SHAPES = [
    RecsysShape("train_batch", 65_536, kind="train"),
    RecsysShape("serve_p99", 512, kind="serve"),
    RecsysShape("serve_bulk", 262_144, kind="serve"),
    RecsysShape("retrieval_cand", 1, n_candidates=1_000_000, kind="retrieval"),
]


@dataclasses.dataclass(frozen=True)
class TriangleShape:
    name: str
    n_nodes: int
    density: float
    kind: str = "count"


TRIANGLE_SHAPES = [
    TriangleShape("dsjc_like", 1_000, 0.5),
    TriangleShape("fna_like", 10_000, 0.1),
    TriangleShape("dense_64k", 65_536, 0.3),
]


def shapes_for(arch: str):
    if arch in ("mace", "dimenet", "graphcast", "gin_tu"):
        return GNN_SHAPES
    if arch == "autoint":
        return RECSYS_SHAPES
    if arch == "triangle":
        return TRIANGLE_SHAPES
    return LM_SHAPES
