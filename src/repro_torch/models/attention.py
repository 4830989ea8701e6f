"""Attention of the decoder LM: GQA (llama-family) and MLA (DeepSeek-V2).

As in the reference (``repro/models/attention.py``), each variant has
  *_init(generator, cfg, dtype)                     -> weights  (a module)
  *_full(p, cfg, x, cos, sin, use_flash)            -> y        (prefill/forward)
  *_cache_init(cfg, batch, s_max, dtype)            -> cache    (per layer)
  *_prefill_cache(p, cfg, x, cos, sin, cache)       -> cache    (fill [0, S))
  *_decode(p, cfg, x, cos, sin, cache, cur_len)     -> (y, cache) (one token)
The cache is written in place: the returned cache is the one passed in.

MLA decodes **absorbed** in latent space (DeepSeek-V2 §2.1.3): the cache
holds only the latent ``c`` (rank r) and the shared rotary key ``kr``
(rope_head_dim) per position; W_uk is folded into the query and W_uv into
the output. Its flash prefill runs K6 at head dims (nope + rope, v) —
(192, 128) at V2-Lite — with V unpadded, where the reference pads V to
nope + rope.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.models.chunked_attention import chunked_attention, decode_attention
from repro_torch.models.layers import apply_rotary, fan_in_normal_, normal_, rms_norm
from repro_torch.utils import resolve_device


class GQA(nn.Module):
    """GQA projections ``wq`` (D, H·hd), ``wk``/``wv`` (D, Hkv·hd), ``wo``
    (H·hd, D), the reference's leaf names and orientation."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, *, device=None):
        super().__init__()
        d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dev = resolve_device(device)
        for name, shape in (("wq", (d, h * hd)), ("wk", (d, hk * hd)), ("wv", (d, hk * hd)),
                            ("wo", (h * hd, d))):
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=dev), requires_grad=False))

    def draw_(self, generator: torch.Generator) -> None:
        """Every projection N(0, 1/fan-in), drawn from ``generator``."""
        fan_in_normal_(self, generator)


def gqa_init(generator: torch.Generator, cfg: LMConfig, dtype=torch.float32, *,
             device=None) -> GQA:
    return fan_in_normal_(GQA(cfg, dtype, device=device), generator)


def _split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, hd).transpose(1, 2)  # (B, H, S, hd), a view


def gqa_full(p: GQA, cfg: LMConfig, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
             use_flash: bool = False, chunk_q: int = 1024):
    """Causal GQA over x (B, S, D) → (B, S, D). ``use_flash`` runs K6
    (``kernels.flash_attention``: the plain version on the CPU, the CUDA
    kernel on the card), else :func:`chunked_attention`."""
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = apply_rotary(_split_heads(x @ p.wq, h, hd), cos, sin)
    k = apply_rotary(_split_heads(x @ p.wk, hk, hd), cos, sin)
    v = _split_heads(x @ p.wv, hk, hd)
    if use_flash:
        from repro_torch.kernels.flash_attention.ops import flash_attention

        o = flash_attention(q, k, v, causal=True)
    else:
        o = chunked_attention(q, k, v, causal=True, chunk_q=chunk_q)
    b, s = x.shape[:2]
    return o.transpose(1, 2).reshape(b, s, h * hd) @ p.wo


def gqa_cache_init(cfg: LMConfig, batch: int, s_max: int, dtype=torch.float32, *,
                   device=None) -> dict:
    hk, hd = cfg.n_kv_heads, cfg.hd
    dev = resolve_device(device)
    return {"k": torch.zeros((batch, hk, s_max, hd), dtype=dtype, device=dev),
            "v": torch.zeros((batch, hk, s_max, hd), dtype=dtype, device=dev)}


def _write(buf: torch.Tensor, x: torch.Tensor, start, dim: int) -> None:
    """Write x into positions [start, start + n) of ``buf`` along ``dim``,
    in place, cast to buf's dtype; ``start`` is an int or a 0-d tensor on
    buf's device (then no host sync)."""
    n = x.shape[dim]
    if isinstance(start, torch.Tensor):
        idx = start.reshape(1).long() + torch.arange(n, device=start.device)
        buf.index_copy_(dim, idx, x.to(buf.dtype))
    else:
        buf.narrow(dim, start, n).copy_(x)


def gqa_prefill_cache(p: GQA, cfg: LMConfig, x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, cache: dict) -> dict:
    hk, hd = cfg.n_kv_heads, cfg.hd
    k = apply_rotary(_split_heads(x @ p.wk, hk, hd), cos, sin)
    v = _split_heads(x @ p.wv, hk, hd)
    _write(cache["k"], k, 0, 2)
    _write(cache["v"], v, 0, 2)
    return cache


def gqa_decode(p: GQA, cfg: LMConfig, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               cache: dict, cur_len):
    """x: (B, 1, D); cos/sin for position cur_len; returns (y (B, 1, D),
    cache) with the new key and value written at cur_len in place."""
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b = x.shape[0]
    q = apply_rotary(_split_heads(x @ p.wq, h, hd), cos, sin)[:, :, 0]  # (B, H, hd)
    k = apply_rotary(_split_heads(x @ p.wk, hk, hd), cos, sin)
    v = _split_heads(x @ p.wv, hk, hd)
    _write(cache["k"], k, cur_len, 2)
    _write(cache["v"], v, cur_len, 2)
    o = decode_attention(q, cache["k"], cache["v"], cur_len + 1)  # (B, H, hd)
    return o.reshape(b, 1, h * hd) @ p.wo, cache


# ===========================================================================
# MLA (DeepSeek-V2)
# ===========================================================================
class MLA(nn.Module):
    """MLA's projections, the reference's leaves in (in, out) orientation:
    ``w_q`` (D, H·(dn+dr)), or with q-LoRA ``w_dq`` (D, q_rank), ``q_norm``
    (q_rank,) and ``w_uq`` (q_rank, H·(dn+dr)); ``w_dkv`` (D, r),
    ``kv_norm`` (r,), ``w_kr`` (D, dr), ``w_uk`` (r, H·dn), ``w_uv`` (r,
    H·dv) and ``wo`` (H·dv, D). The norm scales are float32 ones whatever
    the weights' dtype, as in the reference."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, *, device=None):
        super().__init__()
        m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
        dn, dr, dv, r = m.nope_head_dim, m.rope_head_dim, m.v_head_dim, m.kv_lora_rank
        dev = resolve_device(device)
        if m.q_lora_rank:
            shapes = {"w_dq": (d, m.q_lora_rank), "q_norm": (m.q_lora_rank,),
                      "w_uq": (m.q_lora_rank, h * (dn + dr))}
        else:
            shapes = {"w_q": (d, h * (dn + dr))}
        shapes.update(w_dkv=(d, r), kv_norm=(r,), w_kr=(d, dr), w_uk=(r, h * dn),
                      w_uv=(r, h * dv), wo=(h * dv, d))
        for name, shape in shapes.items():
            w = (torch.ones(shape, device=dev) if name.endswith("_norm") else
                 torch.empty(shape, dtype=dtype, device=dev))
            self.register_parameter(name, nn.Parameter(w, requires_grad=False))

    def draw_(self, generator: torch.Generator) -> None:
        """Each projection N(0, 1/fan-in), its (in, out) weight's first
        axis, as the reference draws them; the norm scales stay ones."""
        for name, w in self.named_parameters():
            if not name.endswith("_norm"):
                normal_(w, generator, w.shape[0] ** -0.5)


def mla_init(generator: torch.Generator, cfg: LMConfig, dtype=torch.float32, *,
             device=None) -> MLA:
    m = MLA(cfg, dtype, device=device)
    m.draw_(generator)
    return m


def _mla_q(p: MLA, cfg: LMConfig, x: torch.Tensor, cos, sin):
    """x (B, S, D) → (q_nope (B, H, S, dn), q_rope (B, H, S, dr) rotated)."""
    m, h = cfg.mla, cfg.n_heads
    dn, dr = m.nope_head_dim, m.rope_head_dim
    if m.q_lora_rank:
        q = rms_norm(x @ p.w_dq, p.q_norm.to(x.dtype), cfg.norm_eps) @ p.w_uq
    else:
        q = x @ p.w_q
    b, s = x.shape[:2]
    q = q.reshape(b, s, h, dn + dr).transpose(1, 2)
    return q[..., :dn], apply_rotary(q[..., dn:], cos, sin)


def _mla_latent(p: MLA, cfg: LMConfig, x: torch.Tensor, cos, sin):
    """x (B, S, D) → (c_kv (B, S, r) normed, k_rope (B, S, dr) rotated):
    what the cache holds per position."""
    c_kv = rms_norm(x @ p.w_dkv, p.kv_norm.to(x.dtype), cfg.norm_eps)
    return c_kv, apply_rotary((x @ p.w_kr)[:, None], cos, sin)[:, 0]


def mla_full(p: MLA, cfg: LMConfig, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
             use_flash: bool = False, chunk_q: int = 1024) -> torch.Tensor:
    """Causal MLA over x (B, S, D) → (B, S, D), keys and values expanded
    from the latent. ``use_flash`` runs K6 at head dims (dn + dr, dv), its
    scale (dn + dr)^-½ MLA's; else :func:`chunked_attention` with Dv = dv.
    Port-only difference: the reference pads V to dn + dr for its kernel and
    slices the output back to dv; K6 here takes Dv apart (on the card's
    tensor-core routes at (192, 128), so P·V skips the zero columns), the
    same function."""
    m, h = cfg.mla, cfg.n_heads
    dn, dr, dv = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(p, cfg, x, cos, sin)
    c_kv, k_rope = _mla_latent(p, cfg, x, cos, sin)
    k_nope = (c_kv @ p.w_uk).reshape(b, s, h, dn).transpose(1, 2)
    v = (c_kv @ p.w_uv).reshape(b, s, h, dv).transpose(1, 2)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, None].expand(b, h, s, dr)], dim=-1)
    if use_flash:
        from repro_torch.kernels.flash_attention.ops import flash_attention

        o = flash_attention(q, k, v, causal=True)
    else:
        o = chunked_attention(q, k, v, causal=True, chunk_q=chunk_q, scale=(dn + dr) ** -0.5)
    return o.transpose(1, 2).reshape(b, s, h * dv) @ p.wo


def mla_cache_init(cfg: LMConfig, batch: int, s_max: int, dtype=torch.float32, *,
                   device=None) -> dict:
    m = cfg.mla
    dev = resolve_device(device)
    return {"c": torch.zeros((batch, s_max, m.kv_lora_rank), dtype=dtype, device=dev),
            "kr": torch.zeros((batch, s_max, m.rope_head_dim), dtype=dtype, device=dev)}


def mla_prefill_cache(p: MLA, cfg: LMConfig, x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, cache: dict) -> dict:
    c_kv, k_rope = _mla_latent(p, cfg, x, cos, sin)
    _write(cache["c"], c_kv, 0, 1)
    _write(cache["kr"], k_rope, 0, 1)
    return cache


def mla_decode(p: MLA, cfg: LMConfig, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               cache: dict, cur_len):
    """Absorbed latent-space decode. x: (B, 1, D); cos/sin for position
    cur_len. Writes this token's latent and rotary key at cur_len in place
    and returns (y (B, 1, D), cache). The logits are float32 whatever the
    dtypes (the reference's ``preferred_element_type``), positions past
    cur_len are masked with -1e30, and the probabilities are cast to the
    cache's dtype before the context product."""
    m, h = cfg.mla, cfg.n_heads
    dn, dr, dv, r = m.nope_head_dim, m.rope_head_dim, m.v_head_dim, m.kv_lora_rank
    b = x.shape[0]
    q_nope, q_rope = _mla_q(p, cfg, x, cos, sin)  # (B, H, 1, dn), (B, H, 1, dr)
    c_new, kr_new = _mla_latent(p, cfg, x, cos, sin)
    c, kr = cache["c"], cache["kr"]
    _write(c, c_new, cur_len, 1)
    _write(kr, kr_new, cur_len, 1)
    # absorb W_uk into the query: q_eff (B, H, r)
    q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, :, 0], p.w_uk.reshape(r, h, dn))
    logits = (torch.einsum("bhr,bsr->bhs", q_eff.float(), c.float())
              + torch.einsum("bhd,bsd->bhs", q_rope[:, :, 0].float(), kr.float())
              ) * ((dn + dr) ** -0.5)
    mask = torch.arange(c.shape[1], device=c.device) < cur_len + 1
    prob = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", prob.to(c.dtype), c)  # (B, H, r)
    # absorb W_uv into the output (in the wider of the two dtypes, as JAX promotes)
    dt = torch.promote_types(ctx.dtype, p.w_uv.dtype)
    o = torch.einsum("bhr,rhd->bhd", ctx.to(dt), p.w_uv.reshape(r, h, dv).to(dt))
    return o.reshape(b, 1, h * dv).to(x.dtype) @ p.wo, cache
