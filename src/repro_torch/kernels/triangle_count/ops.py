"""Wrappers of the triangle-count CUDA kernels (``csrc/triangle_count.cu``).

On a CPU tensor a wrapper runs the kernel's plain version (``ref.py``); on a
CUDA tensor it launches the kernel or raises. Operands are uint8 0/1
matrices; counts come back as int64 on the operands' device."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.triangle_count.ref import (
    TILE,
    masked_matmul_sum_ref,
    triangle_count_ref,
)

_P, _L = ctypes.c_void_p, ctypes.c_longlong
_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
LIVE = CudaKernel("triangle_count", "tc_live", [_P, _L, _L, _P], "tc_error_string")
MASKED = CudaKernel("triangle_count", "tc_masked",
                    [_P, _L, _P, _L, _P, _L, _L, _L, _L, ctypes.c_int, _P],
                    "tc_error_string")


def _check_cuda(*xs: torch.Tensor) -> torch.device:
    dev = xs[0].device
    if dev.type != "cuda":
        raise ValueError(f"expected CPU or CUDA tensors, got {dev}")
    for x in xs:
        if x.device != dev:
            raise ValueError(f"operands on different devices: {x.device} vs {dev}")
        if x.dtype != torch.uint8:
            raise TypeError(f"the CUDA kernel takes uint8 0/1 operands, got {x.dtype}")
    return dev


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x with unit column stride (row stride free), as the kernel reads it."""
    return x if x.stride(-1) == 1 else x.contiguous()


def live_grid_size(n_blocks: int) -> int:
    """C(nb+2, 3): the live block triples {i ≤ k ≤ j} of an nb-tile grid."""
    return n_blocks * (n_blocks + 1) * (n_blocks + 2) // 6


def masked_matmul_sum(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor, *,
                      upper_triangular: bool = False) -> torch.Tensor:
    """sum((A @ B) ⊙ M) for A (R, K), B (K, N), M (R, N), as an int64 scalar.

    Any sizes; the kernel zero-fills ragged tiles. ``upper_triangular`` adds
    the structural skip of the single-matrix count U·U⊙U (output tiles
    j < i skipped, k over [i, j])."""
    if a.dim() != 2 or b.dim() != 2 or m.dim() != 2 \
            or a.shape[1] != b.shape[0] or m.shape != (a.shape[0], b.shape[1]):
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)} vs mask "
                         f"{tuple(m.shape)}")
    if a.device.type == "cpu":
        return masked_matmul_sum_ref(a, b, m, upper_triangular=upper_triangular)
    dev = _check_cuda(a, b, m)
    if -(-a.shape[0] // TILE) > _GRID_YZ:
        raise ValueError(f"{a.shape[0]} rows exceed the kernel's grid "
                         f"({_GRID_YZ} row tiles of {TILE})")
    a, b, m = _rows(a), _rows(b), _rows(m)
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    (R, K), N = a.shape, b.shape[1]
    if R and K and N:
        with torch.cuda.device(dev):
            MASKED(a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
                   m.data_ptr(), m.stride(0), R, K, N, int(upper_triangular),
                   out.data_ptr(), stream=torch.cuda.current_stream(dev).cuda_stream)
    return out[0]


def triangle_count(u: torch.Tensor, *, live_grid: bool = True) -> torch.Tensor:
    """sum(U ⊙ (U @ U)) for strictly upper triangular 0/1 U.

    ``u`` is (n, n) → int64 scalar, or a (B, n, n) batch → (B,) int64.
    ``live_grid=True`` runs the live-grid kernel: one CTA per output tile
    i ≤ j, k over [i, j] — C(nb+2, 3) tile products instead of nb³.
    ``live_grid=False`` runs the full-grid kernel with the upper-triangular
    skip, kept as the comparison baseline."""
    if u.dim() not in (2, 3) or u.shape[-1] != u.shape[-2]:
        raise ValueError(f"expected (n, n) or (B, n, n), got {tuple(u.shape)}")
    if u.device.type == "cpu":
        return triangle_count_ref(u)
    dev = _check_cuda(u)
    if u.dim() == 3 and u.shape[0] > _GRID_YZ:
        raise ValueError(f"a batch of {u.shape[0]} exceeds the kernel's grid "
                         f"({_GRID_YZ} matrices)")
    ub = (u if u.dim() == 3 else u[None]).contiguous()
    batch, n = ub.shape[0], ub.shape[-1]
    out = torch.zeros(batch, dtype=torch.int64, device=dev)
    if batch and n:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if live_grid:
                LIVE(ub.data_ptr(), n, batch, out.data_ptr(), stream=stream)
            else:
                for i in range(batch):
                    MASKED(ub[i].data_ptr(), n, ub[i].data_ptr(), n,
                           ub[i].data_ptr(), n, n, n, n, 1, out[i:].data_ptr(),
                           stream=stream)
    return out if u.dim() == 3 else out[0]

