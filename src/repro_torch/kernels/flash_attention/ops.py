"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``),
K6.

On CPU tensors :func:`flash_attention` runs the plain version
(``ref.attention_ref``); on CUDA tensors it launches the kernel or raises.
The kernel masks a ragged sequence itself, so unlike the reference wrapper
nothing is padded and ``causal=False`` is taken at any S."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.flash_attention.ref import attention_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
FLASH = CudaKernel(
    "flash_attention", "fa_forward",
    [_P, _P, _P, _P,                 # q, k, v, out
     _I, _I, _I, _I, _I,             # B, Hq, Hkv, S, D
     _L, _L, _L, _L, _L, _L,         # q, k strides over (b, h, s)
     _L, _L, _L, _L, _L, _L,         # v, out strides over (b, h, s)
     _I, ctypes.c_float, _I],        # causal, scale, dtype code
    "fa_error_string")
MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Causal (or full) GQA attention, scale D^-½, f32 accumulation, out in
    q's dtype. q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0;
    query head h reads kv head h // (Hq // Hkv).

    On the card q, k and v may be any strided views whose last dimension
    is contiguous (the transposed head views of ``attention._split_heads``
    are read in place); anything else is copied contiguous first. The
    output has q's layout, so transposing it back to (B, S, Hq·D) is free.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or q.shape[0] != k.shape[0] \
            or q.shape[2:] != k.shape[2:] or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"expected q (B, Hq, S, D) and k, v (B, Hkv, S, D) with "
                         f"Hq % Hkv == 0, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    dev = q.device
    if dev.type == "cpu" and k.device == dev and v.device == dev:
        return attention_ref(q, k, v, causal=causal)
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"q, k and v must share one CPU or CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, s, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dims up to {MAX_HEAD_DIM}, got {d}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty_like(q)  # q's layout; its last dimension is contiguous
    if out.numel():
        with torch.cuda.device(dev):
            FLASH(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, hq, k.shape[1], s, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                  int(causal), d**-0.5, _DTYPE_CODE[q.dtype],
                  stream=torch.cuda.current_stream(dev).cuda_stream)
    return out
