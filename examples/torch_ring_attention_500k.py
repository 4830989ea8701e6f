"""The dynamic-pipeline runtime applied beyond the paper: ring attention,
on the PyTorch port (the card unless ``--device cpu``).

KV blocks stream through query stages exactly like edges stream through
filters, and the blockwise online softmax gives exact attention with
O(S·block) memory per stage. Validated here against the full-attention
oracle on a small shape (the long_500k LM cells use the same schedule at
scale); ``repro_torch.models.ring_attention`` runs the same schedule on the
pipeline runtime, checked beside it.

    PYTHONPATH=src python examples/torch_ring_attention_500k.py [--device cpu]
"""
import argparse

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.ring_attention import ring_attention


def ring_attention_sequential(q, k, v, n_stages):
    """q,k,v: (B, H, S, D). Stage s owns the s-th query block; KV blocks
    stream around the ring with online-softmax accumulation."""
    b, h, s, d = q.shape
    blk = s // n_stages
    qs, ks, vs = (x.reshape(b, h, n_stages, blk, d).permute(2, 0, 1, 3, 4) for x in (q, k, v))

    def process(state, kv_blk, me, src):
        k_b, v_b = kv_blk
        logits = torch.einsum("bhqd,bhkd->bhqk", state["q"], k_b) * (d**-0.5)
        # causal: stage owns rows [me*blk, ...), kv block covers [src*blk, ...)
        rows = me * blk + torch.arange(blk, device=q.device)[:, None]
        cols = src * blk + torch.arange(blk, device=q.device)[None, :]
        logits = torch.where(rows >= cols, logits, -1e30)
        m_new = torch.maximum(state["m"], logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(state["m"] - m_new)
        return {"q": state["q"], "m": m_new,
                "l": alpha * state["l"] + p.sum(-1, keepdim=True),
                "acc": alpha * state["acc"] + torch.einsum("bhqk,bhkd->bhqd", p, v_b)}

    outs = []
    for stage in range(n_stages):
        st = {"q": qs[stage], "m": q.new_full((b, h, blk, 1), -1e30),
              "l": q.new_zeros((b, h, blk, 1)), "acc": q.new_zeros((b, h, blk, d))}
        for t in range(n_stages):
            st = process(st, (ks[t], vs[t]), stage, t)
        outs.append(st["acc"] / torch.clamp(st["l"], min=1e-30))
    out = torch.stack(outs, dim=0)  # (stages, B, H, blk, D)
    return out.permute(1, 2, 0, 3, 4).reshape(b, h, s, d)


ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

gen = torch.Generator(device=args.device).manual_seed(0)
b, h, s, d = 1, 2, 256, 32
q, k, v = (torch.randn((b, h, s, d), generator=gen, device=args.device) for _ in range(3))
want = attention_ref(q, k, v, causal=True)
got = ring_attention_sequential(q, k, v, n_stages=4)
torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
print(f"ring attention ({s} tokens, 4 stages) == full attention oracle  ✓")
with torch.no_grad():
    runtime = ring_attention(q, k, v, n_stages=4, causal=True)
torch.testing.assert_close(runtime, want, rtol=2e-4, atol=2e-5)
print("repro_torch.models.ring_attention (the pipeline runtime's stage chain) agrees  ✓")
print("the long_500k cells run this schedule with 524288 tokens across the pod ring")
