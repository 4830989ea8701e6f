"""Deterministic sharded data pipeline, the port's own numpy copy of
``repro/data/pipeline.py``: its batches equal the reference's bit for bit.

Every batch is a pure function of (seed, step), so a restarted job resumes
exactly where it left off after a checkpoint restore, and every host can
produce its own shard of the global batch without coordination. Synthetic
sources stand in for real corpora; ``batch_at(step)`` is the interface a
real loader would keep. Batches are numpy arrays; the train steps move
them to the model's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import LMConfig, RecsysConfig


@dataclasses.dataclass(frozen=True)
class LMTokenPipeline:
    cfg: LMConfig
    global_batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        # zipf-ish token distribution so the cross-entropy has structure to learn
        raw = rng.zipf(1.3, size=(self.global_batch, self.seq_len + 1))
        tokens = np.minimum(raw, self.cfg.vocab - 1).astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


@dataclasses.dataclass(frozen=True)
class RecsysPipeline:
    cfg: RecsysConfig
    batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        ids = rng.integers(0, self.cfg.vocab_per_field,
                           size=(self.batch, self.cfg.n_sparse)).astype(np.int32)
        # labels correlated with a fixed random direction: a learnable CTR
        w = np.random.default_rng(self.seed).normal(size=self.cfg.n_sparse)
        logit = (ids % 97 / 97.0 - 0.5) @ w
        labels = (logit + rng.normal(size=self.batch) * 0.1 > 0).astype(np.float32)
        return {"sparse_ids": ids, "labels": labels}


@dataclasses.dataclass(frozen=True)
class GraphStreamPipeline:
    """Edge-stream source for the triangle workload: the graph as an
    unordered edge sequence (the paper's input model — the graph may be
    generated on the fly and never held whole on the host)."""

    n_nodes: int
    density: float
    seed: int = 0

    def edge_stream(self, block_size: int = 65536):
        """Yield (≤ block_size, 2) int32 edge blocks, each shuffled with a
        seed of its own. Generation is row-blocked (``gnp_edge_blocks``) and
        buffering is bounded by one emitted block plus one generator row
        block, so peak host memory is O(block_size)."""
        from repro_torch.graphs.generators import gnp_edge_blocks

        buf = np.zeros((0, 2), np.int32)
        out_idx = 0
        for chunk in gnp_edge_blocks(self.n_nodes, self.density, seed=self.seed):
            buf = np.concatenate([buf, chunk.astype(np.int32)])
            while len(buf) >= block_size:
                block, buf = buf[:block_size], buf[block_size:]
                rng = np.random.default_rng((self.seed, out_idx))
                yield block[rng.permutation(block_size)]
                out_idx += 1
        if len(buf):
            rng = np.random.default_rng((self.seed, out_idx))
            yield buf[rng.permutation(len(buf))]
