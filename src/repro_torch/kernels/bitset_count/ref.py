"""Plain PyTorch version of the bitset edge-closure kernel (any device).

Bitset words travel as int32 with the bit pattern of the reference's uint32
(``np.uint32`` arrays ``.view(np.int32)`` at the host boundary): torch has
no popcount op, and on the CPU no ``<<`` or ``index_put`` for uint32."""
from __future__ import annotations

import torch

# Edges closed per step of the plain version: bounds its gathered rows to
# about 2**26 words whatever W is.
_GATHER_WORDS = 1 << 26


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit words held as int32, as int64. Widening to
    int64 and masking with 0xFFFFFFFF first keeps the right shifts logical
    for words whose top bit is set (negative as int32)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def bitset_edge_count_ref(masks: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Σ_e popcount(masks[u_e] & masks[v_e]) as an int64 scalar.

    masks: (n_pad, W) int32 bitset rows; edges: (B, 2) non-negative ids.
    Phantom edges (u ≥ n_pad) count 0, and v is clamped to n_pad − 1, as in
    the reference's oracle."""
    n_pad, w = masks.shape
    total = torch.zeros((), dtype=torch.int64, device=masks.device)
    step = max(1, _GATHER_WORDS // max(w, 1))
    for s in range(0, edges.shape[0], step):
        e = edges[s:s + step].to(torch.int64)
        u, v = e[:, 0], e[:, 1]
        valid = u < n_pad
        both = masks[u.clamp(0, n_pad - 1)] & masks[v.clamp(0, n_pad - 1)]
        pc = popcount32(both).sum(dim=-1)
        total += torch.where(valid, pc, 0).sum()
    return total
