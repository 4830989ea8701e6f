"""AutoInt [arXiv:1810.11921]: field embeddings → multi-head self-attention
interaction layers (residual) → MLP head → CTR logit; and the retrieval
score of queries against N candidates as one batched product, and the
training loss ``bce_loss``. The reference is ``repro/models/recsys/
autoint.py``. The functions follow the caller's grad mode (the weights are
created with ``requires_grad=False``; a train step turns it on)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.gnn.common import DenseMLP, mlp_apply, mlp_normal_
from repro_torch.models.layers import fan_in_normal_, normal_
from repro_torch.models.recsys.embedding import lookup, table_shape
from repro_torch.utils import resolve_device


class InteractLayer(nn.Module):
    """``wq``, ``wk``, ``wv``, ``w_res``, each (d_in, heads · d_attn)."""

    def __init__(self, d_in: int, d_out: int, dtype=torch.float32, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        for name in ("wq", "wk", "wv", "w_res"):
            self.register_parameter(name, nn.Parameter(
                torch.empty((d_in, d_out), dtype=dtype, device=dev), requires_grad=False))


class AutoInt(nn.Module):
    """``table`` (V, D), ``attn`` (a ModuleList of :class:`InteractLayer`),
    ``head`` and ``cand_proj`` (:class:`~repro_torch.models.gnn.common.
    DenseMLP`), as the reference's parameter tree."""

    def __init__(self, cfg: RecsysConfig, dtype=torch.float32, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        d_e, d_a, h = cfg.embed_dim, cfg.d_attn, cfg.n_heads
        self.table = nn.Parameter(torch.empty(table_shape(cfg), dtype=dtype, device=dev),
                                  requires_grad=False)
        self.attn = nn.ModuleList(
            InteractLayer(d_e if i == 0 else h * d_a, h * d_a, dtype, device=dev)
            for i in range(cfg.n_attn_layers))
        d_flat = cfg.n_sparse * h * d_a
        self.head = DenseMLP([d_flat, *cfg.mlp_hidden, 1], dtype, device=dev)
        self.cand_proj = DenseMLP([d_flat, cfg.embed_dim], dtype, device=dev)


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: RecsysConfig, dtype=torch.float32, *,
                device=None) -> AutoInt:
    """An :class:`AutoInt` with the reference's initial scales, drawn from
    ``generator`` (on ``device``)."""
    model = AutoInt(cfg, dtype, device=device)
    normal_(model.table, generator, 0.01)  # init_table's scale, drawn in place
    for layer in model.attn:
        fan_in_normal_(layer, generator)
    mlp_normal_(model.head, generator)
    mlp_normal_(model.cand_proj, generator)
    return model


def _interact(layers: nn.ModuleList, e: torch.Tensor, n_heads: int, d_attn: int) -> torch.Tensor:
    """e: (B, F, d) field embeddings → (B, F, h·d_attn) after the attention stack."""
    b, f, _ = e.shape
    for p in layers:
        q = (e @ p.wq).reshape(b, f, n_heads, d_attn)
        k = (e @ p.wk).reshape(b, f, n_heads, d_attn)
        v = (e @ p.wv).reshape(b, f, n_heads, d_attn)
        logits = torch.einsum("bfhd,bghd->bhfg", q, k) * (d_attn**-0.5)
        w = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhfg,bghd->bfhd", w, v).reshape(b, f, n_heads * d_attn)
        e = F.relu(o + e @ p.w_res)
    return e


def user_repr(model: AutoInt, cfg: RecsysConfig, sparse_ids: torch.Tensor) -> torch.Tensor:
    """(B, n_sparse) ids → flattened interaction representation (B, d_flat)."""
    e = lookup(model.table, cfg, sparse_ids)
    z = _interact(model.attn, e, cfg.n_heads, cfg.d_attn)
    return z.reshape(z.shape[0], -1)


def ctr_logits(model: AutoInt, cfg: RecsysConfig, sparse_ids: torch.Tensor) -> torch.Tensor:
    return mlp_apply(model.head, user_repr(model, cfg, sparse_ids), act=F.relu)[:, 0]


def bce_loss(model: AutoInt, cfg: RecsysConfig, batch: dict) -> torch.Tensor:
    """Mean binary cross-entropy with logits of ``batch`` (``"sparse_ids"``
    (B, n_sparse), ``"labels"`` (B,) in {0, 1}; tensors or numpy arrays),
    in the reference's stable form max(z, 0) − z·y + log1p(e^−|z|)."""
    dev = model.table.device
    logits = ctr_logits(model, cfg, torch.as_tensor(batch["sparse_ids"], device=dev)).float()
    y = torch.as_tensor(batch["labels"], device=dev).float()
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def retrieval_scores(model: AutoInt, cfg: RecsysConfig, sparse_ids: torch.Tensor,
                     candidates: torch.Tensor) -> torch.Tensor:
    """Score queries against (N_cand, embed_dim) candidates: one
    (B, d) @ (d, N) product."""
    u = mlp_apply(model.cand_proj, user_repr(model, cfg, sparse_ids), act=F.relu)
    return u @ candidates.T  # (B, N_cand)
