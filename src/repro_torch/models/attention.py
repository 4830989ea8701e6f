"""Attention of the decoder LM: GQA (llama-family). MLA (DeepSeek-V2) comes
with MoE (ROADMAP.md queue A item 6a); its functions raise until then.

As in the reference (``repro/models/attention.py``):
  gqa_init(generator, cfg, dtype)                    -> weights  (a GQA module)
  gqa_full(p, cfg, x, cos, sin, use_flash)           -> y        (prefill/forward)
  gqa_cache_init(cfg, batch, s_max, dtype)           -> cache    (per layer)
  gqa_prefill_cache(p, cfg, x, cos, sin, cache)      -> cache    (fill [0, S))
  gqa_decode(p, cfg, x, cos, sin, cache, cur_len)    -> (y, cache) (one token)
The cache is written in place: the returned cache is the one passed in.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.models.chunked_attention import chunked_attention, decode_attention
from repro_torch.models.layers import apply_rotary, fan_in_normal_
from repro_torch.utils import resolve_device

MLA_TODO = "MLA attention is not in the port yet: ROADMAP.md queue A item 6a ports it"


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


def _write(cache: dict, k: torch.Tensor, v: torch.Tensor, start) -> None:
    """Write k, v (B, Hkv, n, hd) into positions [start, start + n) of the
    cache, in place; ``start`` is an int or a 0-d tensor on the cache's
    device (then no host sync)."""
    n = k.shape[2]
    if isinstance(start, torch.Tensor):
        idx = start.reshape(1).long() + torch.arange(n, device=start.device)
        cache["k"].index_copy_(2, idx, k.to(cache["k"].dtype))
        cache["v"].index_copy_(2, idx, v.to(cache["v"].dtype))
    else:
        cache["k"][:, :, start:start + n] = k
        cache["v"][:, :, start:start + n] = v


def gqa_prefill_cache(p: GQA, cfg: LMConfig, x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, cache: dict) -> dict:
    hk, hd = cfg.n_kv_heads, cfg.hd
    k = apply_rotary(_split_heads(x @ p.wk, hk, hd), cos, sin)
    v = _split_heads(x @ p.wv, hk, hd)
    _write(cache, k, v, 0)
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
    _write(cache, k, v, cur_len)
    o = decode_attention(q, cache["k"], cache["v"], cur_len + 1)  # (B, H, hd)
    return o.reshape(b, 1, h * hd) @ p.wo, cache


def mla_init(*args, **kwargs):
    raise NotImplementedError(MLA_TODO)


mla_full = mla_cache_init = mla_prefill_cache = mla_decode = mla_init
