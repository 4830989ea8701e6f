"""Plain PyTorch version of K6: causal (or full) GQA attention.

The reference oracle (``repro/kernels/flash_attention/ref.py``) written in
torch. Logits and probabilities are float32 whatever the input type; bf16
inputs are widened before the products (the reference rounds its bf16
logits to bf16 first), which is also what the CUDA kernel computes."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, S, D); k: (B, Hkv, S, D); v: (B, Hkv, S, Dv), any Dv (MLA's
    128 beside D = 192: the same function as v zero-padded to D with the
    output sliced back to Dv); Hq % Hkv == 0. Returns (B, Hq, S, Dv) in q's
    dtype, the scale D^-½ unless given. Query head h reads kv head
    h // (Hq // Hkv)."""
    s, d = q.shape[2], q.shape[3]
    group = q.shape[1] // k.shape[1]
    if scale is None:
        scale = d**-0.5
    k = k.float().repeat_interleave(group, dim=1)
    v = v.float().repeat_interleave(group, dim=1)
    logits = torch.matmul(q.float(), k.transpose(-1, -2)).mul_(scale)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril_()
        logits.masked_fill_(~mask, float("-inf"))
    logits.sub_(logits.amax(-1, keepdim=True)).exp_()
    logits.div_(logits.sum(-1, keepdim=True))
    return torch.matmul(logits, v).to(q.dtype)
