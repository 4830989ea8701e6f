"""Plain PyTorch versions of the triangle-count kernels (any device).

The CPU tests run these, and ``chip_smoke.py`` holds the CUDA kernels
against them on the card. The products run in float32, which is exact for
0/1 operands (every entry of A @ B is at most K < 2²⁴), and every sum is
taken in int64."""
from __future__ import annotations

import torch

# K2's output tile edge and contraction chunk, and so the block of its
# upper-triangular skip: the reference kernel's own default block (128)
TILE = 128


def masked_matmul_sum_ref(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor, *,
                          upper_triangular: bool = False,
                          block: int = TILE) -> torch.Tensor:
    """sum((A @ B) ⊙ M) as an int64 scalar, for 0/1 operands.

    ``upper_triangular`` keeps only the live block triples of a ``block``
    grid — output tiles i ≤ j and contraction chunks i ≤ k ≤ j — which is
    what the kernel computes under the structural skip. For a strictly upper
    triangular U·U⊙U it changes nothing."""
    a, b, m = a.to(torch.float32), b.to(torch.float32), m.to(torch.float32)
    if upper_triangular:
        rb = torch.arange(a.shape[0], device=a.device) // block
        kb = torch.arange(a.shape[1], device=a.device) // block
        cb = torch.arange(b.shape[1], device=a.device) // block
        a = a * (kb[None, :] >= rb[:, None])
        b = b * (kb[:, None] <= cb[None, :])
        m = m * (cb[None, :] >= rb[:, None])
    prod = a @ b
    return (prod.to(torch.int64) * m.to(torch.int64)).sum()


def triangle_count_ref(u: torch.Tensor) -> torch.Tensor:
    """sum(U ⊙ (U @ U)) for strictly upper triangular 0/1 U: an int64 scalar
    for (n, n), a (B,) int64 vector for a (B, n, n) batch."""
    uf = u.to(torch.float32)
    prod = uf @ uf
    return (prod.to(torch.int64) * u.to(torch.int64)).sum(dim=(-2, -1))
