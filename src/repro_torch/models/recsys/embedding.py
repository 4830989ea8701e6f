"""Sparse-feature embedding layer for recsys (EmbeddingBag semantics), as
in the reference (``repro/models/recsys/embedding.py``): one table for all
fields, each field's ids offset into its own row range.

``lookup_multihot(use_kernel=True)`` runs K7 (``kernels.embedding_bag``:
the plain version on the CPU, the CUDA kernel on the card); with
``use_kernel=False`` it is the gather plus masked sum."""
from __future__ import annotations

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.layers import normal_
from repro_torch.utils import resolve_device


def table_shape(cfg: RecsysConfig) -> tuple[int, int]:
    return (cfg.n_sparse * cfg.vocab_per_field, cfg.embed_dim)


def init_table(generator: torch.Generator, cfg: RecsysConfig, dtype=torch.float32, *,
               device=None) -> torch.Tensor:
    """The (V, D) table, N(0, 0.01²), drawn from ``generator`` on ``device``."""
    t = torch.empty(table_shape(cfg), dtype=dtype, device=resolve_device(device))
    return normal_(t, generator, 0.01)


def field_offsets(cfg: RecsysConfig, *, device=None) -> torch.Tensor:
    return (torch.arange(cfg.n_sparse, device=resolve_device(device))
            * cfg.vocab_per_field).to(torch.int32)


def lookup(table: torch.Tensor, cfg: RecsysConfig, sparse_ids: torch.Tensor) -> torch.Tensor:
    """sparse_ids: (B, n_sparse) per-field ids in [0, vocab_per_field).
    Returns (B, n_sparse, embed_dim)."""
    ids = sparse_ids + field_offsets(cfg, device=table.device)[None, :]
    return table[ids.long()]


def lookup_multihot(table: torch.Tensor, cfg: RecsysConfig, bags: torch.Tensor, *,
                    use_kernel: bool = False) -> torch.Tensor:
    """bags: (B, n_sparse, L) multi-hot ids, an id ≥ vocab_per_field being
    padding. Returns (B, n_sparse, embed_dim) bag sums (EmbeddingBag)."""
    b, f, l = bags.shape
    v = table.shape[0]
    offs = field_offsets(cfg, device=table.device)[None, :, None]
    ids = torch.where(bags >= cfg.vocab_per_field, v, bags + offs)  # global sentinel = v
    if use_kernel:
        from repro_torch.kernels.embedding_bag.ops import embedding_bag

        out = embedding_bag(table, ids.reshape(b * f, l).to(torch.int32))
        return out.reshape(b, f, cfg.embed_dim)
    rows = table[ids.clamp(max=v - 1).long()]
    return torch.sum(rows * (ids < v)[..., None].to(table.dtype), dim=2)
