"""The decoder LM (Yi, Granite, Nemotron-4 and DeepSeek-V2 families): an
:class:`nn.Module` holding the layers in a ``ModuleList``, and beside it the
reference's entry points (``repro/models/transformer.py``) as functions
that take the model: ``init_params``, ``hidden``, ``forward``,
``loss_fn``, ``cache_init``, ``prefill``, ``decode_step``. ``hidden``,
``forward`` and ``loss_fn`` follow the caller's grad mode (the weights are
created with ``requires_grad=False``; a train step turns it on for the
model it trains); the serving entry points run without grad.

Where the reference scans a stacked layer axis, the port loops over its
layers: an MoE model's first ``n_dense_layers`` blocks hold an MLP and the
rest a :class:`~repro_torch.models.moe.MoE`, the reference's ``dense`` and
``moe_stack``. Attention is GQA, or MLA where the config has one. The
cache keeps the reference's stacked layout (``{"dense": {"k": (L, B, Hkv,
S_max, hd), "v": ...}}``; MLA's ``{"c": (L, B, S_max, r), "kr": (L, B,
S_max, dr)}``, and an MoE model's ``"moe_stack"`` beside ``"dense"``) and
is written in place: ``prefill`` fills a fresh one, ``decode_step`` writes
one position of the cache it is given and returns that same cache.

``hidden``, ``forward``, ``loss_fn`` and ``prefill`` take the reference's
``ep_mesh`` (an MoE layer then runs ``moe.moe_apply_ep`` on that mesh) and
``constrain(x, role)``, a hook applied to the residual stream after the
embedding and after every block (role ``"residual"``): in the reference a
sharding constraint, here a function that may check x and must return it
unchanged (``train.steps.make_lm_constrain``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    MLP,
    chunked_cross_entropy,
    cross_entropy,
    mlp_apply,
    normal_,
    rms_norm,
    rotary_cos_sin,
)
from repro_torch.models.moe import MoE, moe_apply, moe_apply_ep
from repro_torch.utils import resolve_device

AUX_COEF = 0.001  # the MoE load-balance loss's weight in loss_fn


def _is_mla(cfg: LMConfig) -> bool:
    return cfg.mla is not None


def _rope_dim(cfg: LMConfig) -> int:
    """The rotary tables' width: MLA rotates only its rope_head_dim part."""
    return cfg.mla.rope_head_dim if _is_mla(cfg) else cfg.hd


def _n_dense(cfg: LMConfig) -> int:
    return cfg.moe.n_dense_layers if cfg.moe else cfg.n_layers


class Block(nn.Module):
    """One decoder layer: ``ln1``, ``attn`` (:class:`~repro_torch.models.
    attention.GQA` or :class:`~repro_torch.models.attention.MLA`), ``ln2``,
    and ``mlp`` or (``moe_layer``) ``moe``. The norm scales stay float32
    whatever the weights' dtype."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, *, moe_layer: bool = False,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, device=dev), requires_grad=False)
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, device=dev), requires_grad=False)
        self.attn = (attn.MLA if _is_mla(cfg) else attn.GQA)(cfg, dtype, device=dev)
        self.moe_layer = moe_layer
        if moe_layer:
            self.moe = MoE(cfg, dtype, device=dev)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, device=dev)

    @property
    def ffn(self) -> nn.Module:
        return self.moe if self.moe_layer else self.mlp


class Transformer(nn.Module):
    """``embed`` (V, D), ``layers`` (a ModuleList of :class:`Block`: the
    dense ones first, then the MoE ones), ``final_norm`` (D,) float32,
    ``unembed`` (D, V). Weights are created empty on ``device``;
    :func:`init_params` fills them."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        v, d = cfg.vocab, cfg.d_model
        self.embed = nn.Parameter(torch.empty((v, d), dtype=dtype, device=dev),
                                  requires_grad=False)
        self.layers = nn.ModuleList(
            Block(cfg, dtype, moe_layer=i >= _n_dense(cfg), device=dev)
            for i in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.ones(d, device=dev), requires_grad=False)
        self.unembed = nn.Parameter(torch.empty((d, v), dtype=dtype, device=dev),
                                    requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(generator: torch.Generator, cfg: LMConfig, dtype=torch.float32, *,
                device=None) -> Transformer:
    """A :class:`Transformer` with the reference's initial scales: embed
    N(0, 0.02²), unembed N(0, 1/D), every projection N(0, 1/fan-in)
    (stacked expert weights at their D or F, not their expert axis), norms
    1. ``generator`` lies on ``device`` (a full-size model is drawn on the
    card)."""
    model = Transformer(cfg, dtype, device=device)
    normal_(model.embed, generator, 0.02)
    normal_(model.unembed, generator, cfg.d_model**-0.5)
    for blk in model.layers:
        blk.attn.draw_(generator)
        blk.ffn.draw_(generator)
    return model


def _ffn(cfg: LMConfig, p: Block, h: torch.Tensor, ep_mesh=None):
    """h + the layer's MLP or MoE of rms_norm(h) → (x, the MoE's aux loss,
    or None for an MLP layer). With ``ep_mesh`` the MoE is expert-parallel
    on that mesh."""
    z = rms_norm(h, p.ln2.to(h.dtype), cfg.norm_eps)
    if p.moe_layer:
        b, s, d = z.shape
        if ep_mesh is not None:
            y, aux = moe_apply_ep(p.moe, cfg, z.reshape(b * s, d), mesh=ep_mesh)
        else:
            y, aux = moe_apply(p.moe, cfg, z.reshape(b * s, d))
        return h + y.reshape(b, s, d), aux
    return h + mlp_apply(p.mlp, z, cfg.act), None


def _block(cfg: LMConfig, p: Block, x: torch.Tensor, cos, sin, *, use_flash: bool,
           chunk_q: int, ep_mesh=None):
    """One layer over x (B, S, D) → (x, aux or None)."""
    full = attn.mla_full if _is_mla(cfg) else attn.gqa_full
    h = x + full(p.attn, cfg, rms_norm(x, p.ln1.to(x.dtype), cfg.norm_eps), cos, sin,
                 use_flash=use_flash, chunk_q=chunk_q)
    return _ffn(cfg, p, h, ep_mesh)


def _no_constraint(x: torch.Tensor, role: str) -> torch.Tensor:
    return x


def _positions(start, n: int, device) -> torch.Tensor:
    if isinstance(start, torch.Tensor):
        return start.reshape(1).to(device) + torch.arange(n, device=device)
    return torch.arange(start, start + n, device=device)


def hidden(model: Transformer, cfg: LMConfig, tokens: torch.Tensor, *,
           use_flash: bool = False, chunk_q: int = 1024, remat: bool = False,
           constrain=None, ep_mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) → (final-norm hidden (B, S, D), the MoE layers'
    summed aux loss, a float32 scalar: 0 for a dense model).

    Follows the caller's grad mode. ``remat=True`` checkpoints each block
    (``torch.utils.checkpoint``, non-reentrant): the backward pass
    recomputes a block's activations from its input, as the reference's
    ``jax.checkpoint`` on the block. ``constrain`` and ``ep_mesh``: the
    module docstring."""
    cst = constrain or _no_constraint
    x = cst(model.embed[tokens.long()], "residual")
    cos, sin = rotary_cos_sin(_positions(0, tokens.shape[1], x.device), _rope_dim(cfg),
                              cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in model.layers:
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(_block, cfg, blk, x, cos, sin, use_flash=use_flash,
                              chunk_q=chunk_q, ep_mesh=ep_mesh, use_reentrant=False)
        else:
            x, a = _block(cfg, blk, x, cos, sin, use_flash=use_flash, chunk_q=chunk_q,
                          ep_mesh=ep_mesh)
        x = cst(x, "residual")
        if a is not None:
            aux = aux + a
    return rms_norm(x, model.final_norm.to(x.dtype), cfg.norm_eps), aux


def forward(model: Transformer, cfg: LMConfig, tokens: torch.Tensor, *,
            use_flash: bool = False, chunk_q: int = 1024, remat: bool = False,
            constrain=None, ep_mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) → (logits (B, S, V) in float32, aux loss)."""
    x, aux = hidden(model, cfg, tokens, use_flash=use_flash, chunk_q=chunk_q, remat=remat,
                    constrain=constrain, ep_mesh=ep_mesh)
    return (x @ model.unembed).float(), aux


def loss_fn(model: Transformer, cfg: LMConfig, batch: dict, *, use_flash: bool = False,
            chunk_q: int = 1024, remat: bool = False, constrain=None,
            ce_chunk: int | None = None, ep_mesh=None) -> torch.Tensor:
    """Token-mean next-token cross-entropy of ``batch`` (``"tokens"`` and
    ``"labels"``, (B, S) each, tensors or numpy arrays) plus ``AUX_COEF``
    times the MoE aux loss, a float32 scalar on the model's device.
    ``ce_chunk=None`` computes the full (B, S, V) logits; an int uses
    :func:`~repro_torch.models.layers.chunked_cross_entropy`, which never
    holds more than a (B, ce_chunk, V) block of them."""
    dev = model.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev)
    kw = dict(use_flash=use_flash, chunk_q=chunk_q, remat=remat, constrain=constrain,
              ep_mesh=ep_mesh)
    if ce_chunk:
        x, aux = hidden(model, cfg, tokens, **kw)
        return chunked_cross_entropy(x, model.unembed, labels, chunk=ce_chunk) + AUX_COEF * aux
    logits, aux = forward(model, cfg, tokens, **kw)
    return cross_entropy(logits, labels) + AUX_COEF * aux


def cache_init(cfg: LMConfig, batch: int, s_max: int, dtype=torch.float32, *,
               device=None) -> dict:
    """Zeroed cache for every layer, stacked as the reference's: ``"dense"``
    (and, for an MoE model, ``"moe_stack"``) each holding the layer cache's
    arrays with a leading layer axis; layer i's cache is a view
    (:func:`_layer_cache`)."""
    dev = resolve_device(device)
    one = (attn.mla_cache_init if _is_mla(cfg) else attn.gqa_cache_init)(
        cfg, batch, s_max, dtype, device="meta")  # shapes only
    out = {}
    for stack, n in (("dense", _n_dense(cfg)), ("moe_stack", cfg.n_layers - _n_dense(cfg))):
        if n:
            out[stack] = {name: torch.zeros((n, *x.shape), dtype=dtype, device=dev)
                          for name, x in one.items()}
    return out


def _layer_cache(cfg: LMConfig, cache: dict, i: int) -> dict:
    n_dense = _n_dense(cfg)
    stack, j = ("dense", i) if i < n_dense else ("moe_stack", i - n_dense)
    return {name: x[j] for name, x in cache[stack].items()}


@torch.no_grad()
def prefill(model: Transformer, cfg: LMConfig, tokens: torch.Tensor, s_max: int, *,
            cache_dtype=torch.float32, use_flash: bool = False, chunk_q: int = 1024,
            constrain=None, ep_mesh=None) -> tuple[torch.Tensor, dict]:
    """Fill a new KV cache for positions [0, S) and return the last token's
    logits (B, V) in float32 — never the (B, S, V) logits. ``constrain``
    and ``ep_mesh``: the module docstring."""
    b, s = tokens.shape
    cst = constrain or _no_constraint
    x = cst(model.embed[tokens.long()], "residual")
    cos, sin = rotary_cos_sin(_positions(0, s, x.device), _rope_dim(cfg), cfg.rope_theta)
    cache = cache_init(cfg, b, s_max, cache_dtype, device=x.device)
    fill = attn.mla_prefill_cache if _is_mla(cfg) else attn.gqa_prefill_cache
    for i, blk in enumerate(model.layers):
        fill(blk.attn, cfg, rms_norm(x, blk.ln1.to(x.dtype), cfg.norm_eps), cos, sin,
             _layer_cache(cfg, cache, i))
        x, _ = _block(cfg, blk, x, cos, sin, use_flash=use_flash, chunk_q=chunk_q,
                      ep_mesh=ep_mesh)
        x = cst(x, "residual")
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
    cos, sin = rotary_cos_sin(_positions(cur_len, 1, x.device), _rope_dim(cfg), cfg.rope_theta)
    dec = attn.mla_decode if _is_mla(cfg) else attn.gqa_decode
    for i, blk in enumerate(model.layers):
        y, _ = dec(blk.attn, cfg, rms_norm(x, blk.ln1.to(x.dtype), cfg.norm_eps), cos, sin,
                   _layer_cache(cfg, cache, i), cur_len)
        x, _ = _ffn(cfg, blk, x + y)
    x = rms_norm(x, model.final_norm.to(x.dtype), cfg.norm_eps)
    return (x[:, 0] @ model.unembed).float(), cache
