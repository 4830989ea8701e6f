"""Wrappers of the three flash-attention CUDA kernels, K6.

On CPU tensors :func:`flash_attention` runs the plain version
(``ref.attention_ref``); on CUDA tensors it launches one of three kernels
or raises, and :func:`kernel_route` alone decides which from (dtype, D, Dv),
the head dims of q and k and of v: at (D, Dv) in :data:`TC_HEAD_DIMS` —
(64, 64), (128, 128) and MLA's (192, 128) — bf16 goes to
``csrc/flash_attention_sm90.cu`` (``wgmma`` on the bf16 tensor cores, fed by
TMA) and f32 to ``csrc/flash_attention_tf32x3_sm90.cu`` (three-pass TF32
``wgmma``, fed by TMA); every other shape goes to the f32 FMA kernel of
``csrc/flash_attention.cu``, with v zero-padded to D when Dv < D (as the
reference's ``mla_full`` pads it) and the output sliced back. The choice is
by shape, never by failure: a build or launch error raises. All three
kernels mask a ragged sequence themselves, so unlike the reference wrapper
nothing is padded along S and ``causal=False`` is taken at any S.

The three-pass kernel's arithmetic is pinned here by pure functions that
the CPU tests hold against the reference: :func:`tf32_split` (what a TF32
``wgmma`` reads of an f32 word, and the rest) and :func:`pv_key_order` /
:func:`vt_operand` (the layout in which its prep kernel writes Vᵀ)."""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.utils import records_grad

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
FLASH = CudaKernel(
    "flash_attention", "fa_forward",
    [_P, _P, _P, _P,                 # q, k, v, out
     _I, _I, _I, _I, _I,             # B, Hq, Hkv, S, D
     _L, _L, _L, _L, _L, _L,         # q, k strides over (b, h, s)
     _L, _L, _L, _L, _L, _L,         # v, out strides over (b, h, s)
     _I, ctypes.c_float, _I],        # causal, scale, dtype code
    "fa_error_string")
FLASH_WGMMA = CudaKernel(
    "flash_attention_sm90", "fa_forward_wgmma",
    [_P, _P, _P, _P,                 # q, k, v, out
     _I, _I, _I, _I, _I, _I,         # B, Hq, Hkv, S, D, Dv
     _L, _L, _L, _L, _L, _L,         # q, k strides over (b, h, s)
     _L, _L, _L, _L, _L, _L,         # v, out strides over (b, h, s)
     _I, ctypes.c_float],            # causal, scale
    "fa_wgmma_error_string")
FLASH_TF32X3 = CudaKernel(
    "flash_attention_tf32x3_sm90", "fa_forward_tf32x3",
    [_P, _P, _P, _P,                 # q, k, v, out
     _P, _P, _P,                     # scratch: k_lo, vt, vt_lo
     _I, _I, _I, _I, _I, _I,         # B, Hq, Hkv, S, D, Dv
     _L, _L, _L, _L, _L, _L,         # q, k strides over (b, h, s)
     _L, _L, _L, _L, _L, _L,         # v, out strides over (b, h, s)
     _I, ctypes.c_float],            # causal, scale
    "fa_tf32x3_error_string")
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = ((64, 64), (128, 128), (192, 128))  # (D, Dv) of the tensor-core routes
_TC_ROUTE = {torch.bfloat16: "wgmma", torch.float32: "tf32x3"}
TF32_MASK = -(1 << 13)  # 0xFFFFE000 as int32: the bits of an f32 word a TF32 wgmma reads
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TMA_ALIGN = 16  # bytes: TMA's rule for a base address and every stride


def kernel_route(dtype: torch.dtype, head_dim: int, v_head_dim: int | None = None) -> str:
    """The kernel a CUDA call takes: at (D, Dv) = (``head_dim``,
    ``v_head_dim``, default ``head_dim``) in :data:`TC_HEAD_DIMS`,
    ``"wgmma"`` for bf16 and ``"tf32x3"`` for f32; else ``"fma"``."""
    dims = (head_dim, head_dim if v_head_dim is None else v_head_dim)
    return _TC_ROUTE.get(dtype, "fma") if dims in TC_HEAD_DIMS else "fma"


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of f32 ``x``: hi is what a TF32 ``wgmma`` reads of each
    word (its 13 low mantissa bits dropped, so truncated toward zero) and
    lo = x - hi, exact in f32. The tensor cores read lo truncated in turn,
    which leaves hi + tf32(lo) within 2^-21 |x| of x."""
    hi = (x.view(torch.int32) & TF32_MASK).view(torch.float32)
    return hi, x - hi


def pv_key_order() -> tuple[int, ...]:
    """Which key of each 8-key group sits at position p of P·V's
    contraction in the three-pass kernel. Position p of a TF32 ``wgmma``
    register A fragment is register p // 4 of the quad's thread p % 4, and
    that register holds the Q·Kᵀ accumulator's column 2·(p % 4) + p // 4,
    so the softmax's registers feed P·V unchanged when Vᵀ's keys are in this
    order (the C copy: ``key_order`` in the kernel's source)."""
    return tuple(2 * (p % 4) + p // 4 for p in range(8))


def vt_operand(v: torch.Tensor) -> torch.Tensor:
    """Vᵀ as the three-pass kernel's prep writes it: (B, Hkv, Dv, S8), S8 = S
    rounded up to 8, keys ≥ S zero, each 8-key group in
    :func:`pv_key_order`."""
    b, h, s, d = v.shape
    s8 = -(-s // 8) * 8
    padded = v.new_zeros(b, h, s8, d)
    padded[:, :, :s] = v
    keys = torch.arange(s8, device=v.device).view(-1, 8)[:, list(pv_key_order())]
    return padded[:, :, keys.reshape(-1)].transpose(-1, -2).contiguous()


def _tma_strides(x: torch.Tensor) -> tuple[int, int, int] | None:
    """x's (b, h, s) element strides as TMA takes them, or None when its
    base or a stride breaks TMA's 16-byte rule. A dimension of size 1 is
    never stepped over, so its stride is replaced by the contiguous one."""
    if x.stride(-1) != 1 or x.data_ptr() % _TMA_ALIGN:
        return None
    b, h, s, d = x.shape
    out = []
    for st, n, dense in zip(x.stride()[:3], (b, h, s), (h * s * d, s * d, d)):
        st = st if n > 1 else dense
        if st <= 0 or st * x.element_size() % _TMA_ALIGN:
            return None
        out.append(st)
    return tuple(out)


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """x itself when TMA can read it in place, else a fresh contiguous copy
    (a new allocation, so an already contiguous x whose base breaks the
    16-byte rule is copied too)."""
    return x if _tma_strides(x) else x.clone(memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Causal (or full) GQA attention, scale D^-½, f32 accumulation, out in
    q's dtype. q: (B, Hq, S, D); k: (B, Hkv, S, D); v: (B, Hkv, S, Dv) with
    1 <= Dv <= D and Hq % Hkv == 0; out: (B, Hq, S, Dv). Query head h reads
    kv head h // (Hq // Hkv). Dv < D is MLA's (DeepSeek-V2: D = nope + rope
    = 192, Dv = 128, scale (nope + rope)^-½); the reference pads v to D and
    slices the output, the same function.

    On the card q, k and v may be any strided views whose last dimension
    is contiguous (the transposed head views of ``attention._split_heads``
    are read in place); on the ``wgmma`` route q, k and v, and on the
    ``tf32x3`` route q and k, must also keep TMA's 16-byte rule in their
    bases and strides. Anything else is copied contiguous first.
    At Dv == D the output has q's layout, so transposing it back to
    (B, S, Hq·D) is free.

    Raises ``RuntimeError``, on the CPU and on the card alike, when grad
    mode is on and an input requires grad: the kernel has no backward.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3] \
            or not 1 <= v.shape[3] <= q.shape[3] or q.shape[0] != k.shape[0] \
            or q.shape[2:] != k.shape[2:] or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"expected q (B, Hq, S, D), k (B, Hkv, S, D) and v (B, Hkv, S, Dv) "
                         f"with Hq % Hkv == 0 and 1 <= Dv <= D, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if records_grad(q, k, v):
        raise RuntimeError(
            "flash_attention has no backward (neither has the reference's kernel): call it "
            "under torch.no_grad() or on tensors that do not require grad, and train "
            "through chunked_attention (use_flash=False)")
    dev = q.device
    if dev.type == "cpu" and k.device == dev and v.device == dev:
        return attention_ref(q, k, v, causal=causal)
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"q, k and v must share one CPU or CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    d, dv = q.shape[-1], v.shape[-1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dims up to {MAX_HEAD_DIM}, got {d}")
    route = kernel_route(q.dtype, d, dv)
    if route == "wgmma":
        return _launch_wgmma(q, k, v, causal)
    if route == "tf32x3":
        return _launch_tf32x3(q, k, v, causal)
    if dv < d:
        return _launch_fma(q, k, F.pad(v, (0, d - dv)), causal)[..., :dv]
    return _launch_fma(q, k, v, causal)


def _out(q: torch.Tensor, dv: int) -> torch.Tensor:
    """The output (B, Hq, S, Dv): q's layout at Dv == D, else contiguous.
    Its last dimension is contiguous either way."""
    return torch.empty_like(q) if dv == q.shape[-1] else q.new_empty(*q.shape[:3], dv)


def _launch_fma(q, k, v, causal: bool) -> torch.Tensor:
    """The f32 FMA kernel (f32 or bf16 inputs, any D <= 256, v as wide as
    q and k)."""
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty_like(q)  # q's layout; its last dimension is contiguous
    b, hq, s, d = q.shape
    if out.numel():
        with torch.cuda.device(q.device):
            FLASH(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, hq, k.shape[1], s, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                  int(causal), d**-0.5, _DTYPE_CODE[q.dtype],
                  stream=torch.cuda.current_stream(q.device).cuda_stream)
    return out


def _launch_wgmma(q, k, v, causal: bool) -> torch.Tensor:
    """bf16 at (D, Dv) in :data:`TC_HEAD_DIMS`: the TMA + ``wgmma`` kernel.
    An input whose base or strides break TMA's 16-byte rule (each at its own
    head dim) is copied contiguous first."""
    q, k, v = (_tma_ready(x) for x in (q, k, v))
    b, hq, s, d = q.shape
    out = _out(q, v.shape[-1])
    if out.numel():
        with torch.cuda.device(q.device):
            FLASH_WGMMA(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        b, hq, k.shape[1], s, d, v.shape[-1],
                        *_tma_strides(q), *_tma_strides(k), *_tma_strides(v),
                        *out.stride()[:3], int(causal), d**-0.5,
                        stream=torch.cuda.current_stream(q.device).cuda_stream)
    return out


def _launch_tf32x3(q, k, v, causal: bool) -> torch.Tensor:
    """f32 at (D, Dv) in :data:`TC_HEAD_DIMS`: the three-pass TF32 kernel.
    TMA reads q and k, so those that break its 16-byte rule are copied; v is
    read by the prep kernel through its strides. The scratch the prep writes
    (K_lo, and Vᵀ and Vᵀ_lo as :func:`vt_operand` lays them out) is
    allocated here."""
    q, k = _tma_ready(q), _tma_ready(k)
    v = v if v.stride(-1) == 1 else v.contiguous()
    b, hq, s, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    out = _out(q, dv)
    if out.numel():
        k_lo = torch.empty(b, hkv, s, d, dtype=torch.float32, device=q.device)
        vt = torch.empty(2, b, hkv, dv, -(-s // 8) * 8, dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            FLASH_TF32X3(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         k_lo.data_ptr(), vt[0].data_ptr(), vt[1].data_ptr(),
                         b, hq, hkv, s, d, dv,
                         *_tma_strides(q), *_tma_strides(k), *v.stride()[:3],
                         *out.stride()[:3], int(causal), d**-0.5,
                         stream=torch.cuda.current_stream(q.device).cuda_stream)
    return out
