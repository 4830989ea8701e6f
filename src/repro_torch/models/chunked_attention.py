"""Memory-efficient attention in plain PyTorch: the LM's attention when
``use_flash=False`` (the reference's XLA path, ``repro/models/
chunked_attention.py``), and single-token attention against a KV cache.

Both fold GQA as kv head = q head // group, the same map as K6's."""
from __future__ import annotations

import torch

from repro_torch.utils import records_grad


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, chunk_q: int = 1024,
                      scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, S, Dk); k: (B, Hkv, S, Dk); v: (B, Hkv, S, Dv). Returns
    (B, Hq, S, Dv) in q's dtype.

    Query rows go ``chunk_q`` at a time, each chunk a full-width softmax in
    float32 over its (chunk, S) scores, so live memory is O(chunk · S) and
    not O(S²). The last chunk is ragged (the reference pads it). Where
    autograd records no graph the scores are scaled, masked and
    exponentiated in place; where it does, out of place (the row max is
    held constant, the reference's ``stop_gradient``)."""
    b, hq, s, dk = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    group = hq // hkv
    if scale is None:
        scale = dk**-0.5
    cq = min(chunk_q, s)
    inplace = not records_grad(q, k, v)
    qg = q.reshape(b, hkv, group, s, dk)      # fold q heads onto kv heads
    kt = k.unsqueeze(2).transpose(-1, -2)     # (B, Hkv, 1, Dk, S)
    vg = v.unsqueeze(2)                       # (B, Hkv, 1, S, Dv)
    if q.dtype != torch.float32:              # logits in f32, as the reference
        kt = kt.float()
    out = (torch.empty((b, hkv, group, s, dv), dtype=q.dtype, device=q.device) if inplace
           else None)
    parts = []
    for i in range(0, s, cq):
        q_i = qg[:, :, :, i:i + cq]
        logits = torch.matmul(q_i if q_i.dtype == kt.dtype else q_i.float(), kt)
        logits = logits.mul_(scale) if inplace else logits * scale
        if causal:
            rows = torch.arange(i, i + q_i.shape[3], device=q.device)[:, None]
            cols = torch.arange(s, device=q.device)[None, :]
            logits = (logits.masked_fill_(rows < cols, -1e30) if inplace
                      else logits.masked_fill(rows < cols, -1e30))
        m = logits.amax(-1, keepdim=True).detach()
        p = logits.sub_(m).exp_() if inplace else torch.exp(logits - m)
        num = torch.matmul(p.to(v.dtype), vg)
        den = p.sum(-1, keepdim=True).to(v.dtype)
        if inplace:
            out[:, :, :, i:i + cq] = num / den.clamp_min(1e-30)
        else:
            parts.append((num / den.clamp_min(1e-30)).to(q.dtype))
    if not inplace:
        out = torch.cat(parts, dim=3)
    return out.reshape(b, hq, s, dv)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cur_len, *, scale: float | None = None) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: (B, Hq, Dk); k_cache: (B, Hkv, S_max, Dk); v_cache: (B, Hkv, S_max,
    Dv); cur_len: int or 0-d tensor — the number of valid cache positions
    (attends [0, cur_len)). Returns (B, Hq, Dv) in q's dtype."""
    b, hq, dk = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    if scale is None:
        scale = dk**-0.5
    qg = q.reshape(b, hkv, group, dk)
    kc = k_cache if k_cache.dtype == torch.float32 else k_cache.float()
    logits = torch.matmul(qg.to(kc.dtype), kc.transpose(-1, -2)).mul_(scale)  # (B,Hkv,g,S)
    mask = torch.arange(s_max, device=q.device) < cur_len
    logits.masked_fill_(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.matmul(p.to(v_cache.dtype), v_cache)
    return out.reshape(b, hq, v_cache.shape[-1]).to(q.dtype)
