"""Fanout neighbor sampler for minibatch GNN training (GraphSAGE-style),
a copy of the reference's ``repro/graphs/sampler.py``: host numpy with
``np.random.default_rng(seed)``, so the same seed gives the reference's
samples bit for bit.

Produces fixed-shape (padded) blocks: the ``minibatch_lg`` shape (232,965
nodes / 114.6M edges / batch 1024 / fanout 15-10) uses exactly this
sampler, and the padded output shapes are deterministic functions of
(batch, fanouts).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """One hop: for each destination node, up to ``fanout`` source neighbors.

    nodes:      (n_dst,) int32 global ids of destination nodes
    src_nodes:  (n_dst * fanout,) int32 global ids of sampled sources
                (padded with the dst node itself => a self-loop message)
    mask:       (n_dst * fanout,) bool, True where the sample is real
    dst_index:  (n_dst * fanout,) int32 local index of the dst each src feeds
    """

    nodes: np.ndarray
    src_nodes: np.ndarray
    mask: np.ndarray
    dst_index: np.ndarray


@dataclasses.dataclass(frozen=True)
class MiniBatch:
    """Multi-hop sampled computation graph: blocks[0] is the outermost hop."""

    seed_nodes: np.ndarray
    blocks: list[SampledBlock]
    input_nodes: np.ndarray  # nodes whose raw features are needed


class NeighborSampler:
    def __init__(self, indptr: np.ndarray, indices: np.ndarray, fanouts: list[int], seed: int = 0):
        self.indptr = indptr
        self.indices = indices
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)

    def sample_hop(self, nodes: np.ndarray, fanout: int) -> SampledBlock:
        n_dst = len(nodes)
        deg = (self.indptr[nodes + 1] - self.indptr[nodes]).astype(np.int64)
        # uniform with replacement (standard GraphSAGE); deg==0 -> self loop pad
        offs = self.rng.integers(0, np.maximum(deg, 1)[:, None], size=(n_dst, fanout))
        flat = self.indptr[nodes][:, None] + offs
        src = self.indices[np.minimum(flat, len(self.indices) - 1)]
        mask = (np.arange(fanout)[None, :] < np.minimum(deg, fanout)[:, None]) & (deg[:, None] > 0)
        src = np.where(mask, src, nodes[:, None])
        dst_index = np.repeat(np.arange(n_dst, dtype=np.int32), fanout)
        return SampledBlock(
            nodes=nodes.astype(np.int32),
            src_nodes=src.reshape(-1).astype(np.int32),
            mask=mask.reshape(-1),
            dst_index=dst_index,
        )

    def sample(self, seed_nodes: np.ndarray) -> MiniBatch:
        blocks: list[SampledBlock] = []
        frontier = np.asarray(seed_nodes, dtype=np.int64)
        for fanout in self.fanouts:
            blk = self.sample_hop(frontier, fanout)
            blocks.append(blk)
            frontier = np.unique(np.concatenate([frontier, blk.src_nodes[blk.mask]]))
        return MiniBatch(
            seed_nodes=np.asarray(seed_nodes, dtype=np.int32),
            blocks=blocks,
            input_nodes=frontier.astype(np.int32),
        )
