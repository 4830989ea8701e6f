"""The dense decoder LM (Yi, Granite, Nemotron-4 families): an
:class:`nn.Module` holding the layers in a ``ModuleList``, and beside it the
reference's entry points (``repro/models/transformer.py``) as functions
that take the model: ``init_params``, ``hidden``, ``forward``,
``cache_init``, ``prefill``, ``decode_step``.

Where the reference scans a stacked layer axis, the port loops over its
layers. The KV cache keeps the reference's stacked layout
(``{"dense": {"k": (L, B, Hkv, S_max, hd), "v": ...}}``) and is written in
place: ``prefill`` fills a fresh one, ``decode_step`` writes one position
of the cache it is given and returns that same cache. MoE and MLA configs
raise (ROADMAP.md queue A item 6a); the training losses come with
training (item 6d).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    MLP,
    fan_in_normal_,
    mlp_apply,
    normal_,
    rms_norm,
    rotary_cos_sin,
)
from repro_torch.utils import resolve_device


def _check_dense(cfg: LMConfig) -> None:
    if cfg.moe is not None or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA are not in the port yet (ROADMAP.md queue A item 6a); "
            "the port runs the dense GQA configurations")


class Block(nn.Module):
    """One decoder layer: ``ln1``, ``attn`` (GQA), ``ln2``, ``mlp``. The
    norm scales stay float32 whatever the weights' dtype."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, device=dev), requires_grad=False)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, device=dev), requires_grad=False)
        self.attn = attn.GQA(cfg, dtype, device=dev)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, device=dev)


class Transformer(nn.Module):
    """``embed`` (V, D), ``layers`` (a ModuleList of :class:`Block`),
    ``final_norm`` (D,) float32, ``unembed`` (D, V). Weights are created
    empty on ``device``; :func:`init_params` fills them."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, *, device=None):
        super().__init__()
        _check_dense(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        v, d = cfg.vocab, cfg.d_model
        self.embed = nn.Parameter(torch.empty((v, d), dtype=dtype, device=dev),
                                  requires_grad=False)
        self.layers = nn.ModuleList(Block(cfg, dtype, device=dev) for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.ones(d, device=dev), requires_grad=False)
        self.unembed = nn.Parameter(torch.empty((d, v), dtype=dtype, device=dev),
                                    requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(generator: torch.Generator, cfg: LMConfig, dtype=torch.float32, *,
                device=None) -> Transformer:
    """A :class:`Transformer` with the reference's initial scales: embed
    N(0, 0.02²), unembed N(0, 1/D), every projection N(0, 1/fan-in), norms
    1. ``generator`` lies on ``device`` (a full-size model is drawn on the
    card)."""
    model = Transformer(cfg, dtype, device=device)
    normal_(model.embed, generator, 0.02)
    normal_(model.unembed, generator, cfg.d_model**-0.5)
    for blk in model.layers:
        fan_in_normal_(blk.attn, generator)
        fan_in_normal_(blk.mlp, generator)
    return model


def _block(cfg: LMConfig, p: Block, x: torch.Tensor, cos, sin, *, use_flash: bool,
           chunk_q: int) -> torch.Tensor:
    h = x + attn.gqa_full(p.attn, cfg, rms_norm(x, p.ln1.to(x.dtype), cfg.norm_eps), cos, sin,
                          use_flash=use_flash, chunk_q=chunk_q)
    z = rms_norm(h, p.ln2.to(h.dtype), cfg.norm_eps)
    return h + mlp_apply(p.mlp, z, cfg.act)


def _positions(start, n: int, device) -> torch.Tensor:
    if isinstance(start, torch.Tensor):
        return start.reshape(1).to(device) + torch.arange(n, device=device)
    return torch.arange(start, start + n, device=device)


@torch.no_grad()
def hidden(model: Transformer, cfg: LMConfig, tokens: torch.Tensor, *,
           use_flash: bool = False, chunk_q: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) → (final-norm hidden (B, S, D), aux loss 0)."""
    x = model.embed[tokens.long()]
    cos, sin = rotary_cos_sin(_positions(0, tokens.shape[1], x.device), cfg.hd, cfg.rope_theta)
    for blk in model.layers:
        x = _block(cfg, blk, x, cos, sin, use_flash=use_flash, chunk_q=chunk_q)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(x, model.final_norm.to(x.dtype), cfg.norm_eps), aux


@torch.no_grad()
def forward(model: Transformer, cfg: LMConfig, tokens: torch.Tensor, *,
            use_flash: bool = False, chunk_q: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) → (logits (B, S, V) in float32, aux loss 0)."""
    x, aux = hidden(model, cfg, tokens, use_flash=use_flash, chunk_q=chunk_q)
    return (x @ model.unembed).float(), aux


def cache_init(cfg: LMConfig, batch: int, s_max: int, dtype=torch.float32, *,
               device=None) -> dict:
    """Zeroed KV cache for every layer: ``{"dense": {"k", "v"}}``, each
    (L, B, Hkv, S_max, hd); layer i's cache is the view ``[i]``."""
    _check_dense(cfg)
    one = attn.gqa_cache_init(cfg, batch, s_max, dtype, device=device)
    return {"dense": {name: torch.zeros((cfg.n_layers, *x.shape), dtype=dtype, device=x.device)
                      for name, x in one.items()}}


def _layer_cache(cache: dict, i: int) -> dict:
    return {name: x[i] for name, x in cache["dense"].items()}


@torch.no_grad()
def prefill(model: Transformer, cfg: LMConfig, tokens: torch.Tensor, s_max: int, *,
            cache_dtype=torch.float32, use_flash: bool = False,
            chunk_q: int = 1024) -> tuple[torch.Tensor, dict]:
    """Fill a new KV cache for positions [0, S) and return the last token's
    logits (B, V) in float32 — never the (B, S, V) logits."""
    b, s = tokens.shape
    x = model.embed[tokens.long()]
    cos, sin = rotary_cos_sin(_positions(0, s, x.device), cfg.hd, cfg.rope_theta)
    cache = cache_init(cfg, b, s_max, cache_dtype, device=x.device)
    for i, blk in enumerate(model.layers):
        attn.gqa_prefill_cache(blk.attn, cfg, rms_norm(x, blk.ln1.to(x.dtype), cfg.norm_eps),
                               cos, sin, _layer_cache(cache, i))
        x = _block(cfg, blk, x, cos, sin, use_flash=use_flash, chunk_q=chunk_q)
    x = rms_norm(x[:, -1:], model.final_norm.to(x.dtype), cfg.norm_eps)
    return (x[:, 0] @ model.unembed).float(), cache


@torch.no_grad()
def decode_step(model: Transformer, cfg: LMConfig, cache: dict, token: torch.Tensor,
                cur_len) -> tuple[torch.Tensor, dict]:
    """One serving step: token (B, 1), cur_len (int or 0-d tensor) — the
    number of positions already in the cache. Writes this token's keys and
    values at cur_len, in place, and returns (logits (B, V) float32, the
    same cache)."""
    x = model.embed[token.long()]  # (B, 1, D)
    cos, sin = rotary_cos_sin(_positions(cur_len, 1, x.device), cfg.hd, cfg.rope_theta)
    for i, blk in enumerate(model.layers):
        y, _ = attn.gqa_decode(blk.attn, cfg, rms_norm(x, blk.ln1.to(x.dtype), cfg.norm_eps),
                               cos, sin, _layer_cache(cache, i), cur_len)
        h = x + y
        x = h + mlp_apply(blk.mlp, rms_norm(h, blk.ln2.to(h.dtype), cfg.norm_eps), cfg.act)
    x = rms_norm(x, model.final_norm.to(x.dtype), cfg.norm_eps)
    return (x[:, 0] @ model.unembed).float(), cache
