"""Wrappers of the triangle-count CUDA kernels.

Both run one kernel body of ``csrc/triangle_count_sm90.cu`` (int8 ``wgmma``
fed by TMA, the contraction split across CTAs): K2, the masked matmul-sum,
through ``tc_masked_wgmma``, and K1, the live-grid count of a whole batch
in one launch, through ``tc_live_wgmma``. On a CPU tensor a wrapper runs
the kernel's plain version (``ref.py``); on a CUDA tensor it launches the
kernel or raises. Operands are uint8 0/1 matrices; counts come back as
int64 on the operands' device.

K2 computes Σ (A·B) ⊙ M as Σ A ⊙ (M·Bᵀ), so the tensor cores contract over
N, the contiguous dimension of both M and B; K1 is K2 with A = B = M = U
under the upper-triangular skip. :func:`split_plan` and :func:`work_item`
are the kernel's work decomposition, written here so that the CPU tests can
pin what the kernel decodes; :func:`tma_row_stride` and
:func:`tma_batch_strides` are TMA's rule for the operands it loads."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.triangle_count.ref import (
    TILE,
    masked_matmul_sum_ref,
    triangle_count_ref,
)

_P, _L = ctypes.c_void_p, ctypes.c_longlong
_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
LIVE = CudaKernel("triangle_count_sm90", "tc_live_wgmma", [_P, _L, _L, _L, _L, _L, _L, _P],
                  "tc_wgmma_error_string")
MASKED = CudaKernel("triangle_count_sm90", "tc_masked_wgmma",
                    [_P, _L, _P, _L, _P, _L, _L, _L, _L, ctypes.c_int, _L, _L, _P],
                    "tc_wgmma_error_string")
# TMA's box coordinates are signed 32-bit, and a 1-D grid holds at most
# this many CTAs
_INT32_MAX = 2**31 - 1
_TMA_ALIGN = 16  # bytes: TMA's rule for a base address and a row stride
# K2's split: aim for this many waves of CTAs, one CTA an SM (130 KB of
# shared memory each), but give no slice fewer chunks than MIN_SLICE, so
# that its pipeline fill and epilogue stay small beside its products
SPLIT_WAVES = 8
MIN_SLICE = 8
GROUP = 8  # row tiles per raster group (csrc/triangle_count_sm90.cu)


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def live_grid_size(n_blocks: int) -> int:
    """C(nb+2, 3): the live block triples {i ≤ k ≤ j} of an nb-tile grid."""
    return n_blocks * (n_blocks + 1) * (n_blocks + 2) // 6


def _upper_pairs(x: int, nr: int) -> int:
    """Output tiles rb ≤ kb < x with rb < nr."""
    if x <= 0:
        return 0
    if x <= nr:
        return x * (x + 1) // 2
    return nr * (nr + 1) // 2 + (x - nr) * nr


def split_plan(R: int, K: int, N: int, upper: bool, sms: int) -> tuple[int, int]:
    """K2's work decomposition for A (R, K), B (K, N), M (R, N) on a card
    with ``sms`` SMs: ``(slice, items)``, the contraction chunks (of
    ``TILE`` bytes of N) per slice and the number of work items, one CTA
    each. Output tiles are ``TILE`` × ``TILE`` of M·Bᵀ; under ``upper`` only
    tiles kb ≥ rb live, over chunks cb ≥ kb. Few output tiles are split
    along N until the grid fills the card ``SPLIT_WAVES`` times, with no
    slice under ``MIN_SLICE`` chunks."""
    nr, nk, nc = _cdiv(R, TILE), _cdiv(K, TILE), _cdiv(N, TILE)
    tiles = _upper_pairs(min(nk, nc), nr) if upper else nr * nk
    if tiles == 0:
        return max(nc, 1), 0
    want = _cdiv(SPLIT_WAVES * sms, tiles)
    slice_ = min(max(MIN_SLICE, _cdiv(nc, want)), nc)
    if upper:
        items = sum(_upper_pairs(min(nk, nc - j * slice_), nr)
                    for j in range(_cdiv(nc, slice_)))
    else:
        items = tiles * _cdiv(nc, slice_)
    return slice_, items


def work_item(i: int, R: int, K: int, N: int, upper: bool,
              slice_: int) -> tuple[int, int, int, int]:
    """Work item ``i`` of :func:`split_plan`'s grid → (rb, kb, c0, c1):
    output tile (rb, kb) over chunks [c0, c1). The kernel's ``work_item``
    decodes ``blockIdx.x`` by the same steps."""
    nr, nk, nc = _cdiv(R, TILE), _cdiv(K, TILE), _cdiv(N, TILE)
    if not upper:
        # slices outermost; within a slice, groups of GROUP row tiles, each
        # group walked column by column
        tiles = nr * nk
        j, t = divmod(i, tiles)
        per_group = GROUP * nk
        rb0 = (t // per_group) * GROUP
        gm = min(GROUP, nr - rb0)
        t %= per_group
        rb, kb = rb0 + t % gm, t // gm
        c0 = j * slice_
    else:
        # slice j of tile (rb, kb) starts at chunk kb + j·slice; slice j has
        # _upper_pairs(min(nk, nc - j·slice)) live tiles, kb-major
        j = 0
        while True:
            x = min(nk, nc - j * slice_)
            cnt = _upper_pairs(x, nr)
            if i < cnt:
                break
            i -= cnt
            j += 1
        y = min(x, nr)
        tri = y * (y + 1) // 2
        if i < tri:
            kb = int(((8 * i + 1) ** 0.5 - 1) / 2)
            while (kb + 1) * (kb + 2) // 2 <= i:
                kb += 1
            while kb * (kb + 1) // 2 > i:
                kb -= 1
            rb = i - kb * (kb + 1) // 2
        else:
            i -= tri
            kb, rb = nr + i // nr, i % nr
        c0 = kb + j * slice_
    return rb, kb, c0, min(c0 + slice_, nc)


def tma_row_stride(x: torch.Tensor) -> int | None:
    """The row stride in bytes at which TMA reads the uint8 matrix ``x``,
    or None when x breaks TMA's rule: unit column stride, a 16-byte aligned
    base, and a row stride that is a multiple of 16 and covers a row. A
    single row is never stepped over, so its stride is the row rounded up
    to 16."""
    rows, cols = x.shape
    if (x.stride(1) != 1 and cols > 1) or x.data_ptr() % _TMA_ALIGN:
        return None
    if rows == 1:
        return _cdiv(cols, _TMA_ALIGN) * _TMA_ALIGN
    st = x.stride(0)
    if st < cols or st % _TMA_ALIGN:
        return None
    return st


def tma_batch_strides(x: torch.Tensor) -> tuple[int, int] | None:
    """(row stride, matrix stride) in bytes at which TMA reads the (B, rows,
    cols) uint8 batch ``x``, or None when x breaks TMA's rule: each matrix
    as :func:`tma_row_stride` takes it, and a matrix stride that is a
    multiple of 16 and covers a matrix. A single matrix is never stepped
    over, so its stride is its rows times the row stride. A view
    ``u[:, :n, :n]`` of an aligned (B, n_b, n_b) buffer is read in place."""
    mats, rows = x.shape[0], x.shape[1]
    ld = tma_row_stride(x[0])
    if ld is None:
        return None
    if mats == 1:
        return ld, rows * ld
    st = x.stride(0)
    if st < rows * ld or st % _TMA_ALIGN:
        return None
    return ld, st


def _tma_operand(x: torch.Tensor) -> torch.Tensor:
    """x (a matrix, or a batch of them) itself when TMA can read it, else a
    copy into zeros whose rows are rounded up to 16 bytes (the padding is
    never read: the tensor map's width stays x's)."""
    if (tma_row_stride(x) if x.dim() == 2 else tma_batch_strides(x)) is not None:
        return x
    *lead, cols = x.shape
    buf = torch.zeros((*lead, _cdiv(cols, _TMA_ALIGN) * _TMA_ALIGN), dtype=x.dtype,
                      device=x.device)
    buf[..., :cols] = x
    return buf


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def masked_matmul_sum(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor, *,
                      upper_triangular: bool = False) -> torch.Tensor:
    """sum((A @ B) ⊙ M) for A (R, K), B (K, N), M (R, N), as an int64 scalar.

    Any sizes; the kernel's loads zero-fill ragged tiles. A is read in place
    through its row stride; B and M are copied only where they break TMA's
    16-byte rule (:func:`tma_row_stride`). ``upper_triangular`` adds the
    structural skip of the single-matrix count U·U⊙U at ``TILE``: output
    tiles of M·Bᵀ below the diagonal skipped, contraction chunks from the
    tile's column on."""
    if a.dim() != 2 or b.dim() != 2 or m.dim() != 2 \
            or a.shape[1] != b.shape[0] or m.shape != (a.shape[0], b.shape[1]):
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)} vs mask "
                         f"{tuple(m.shape)}")
    if a.device.type == "cpu":
        return masked_matmul_sum_ref(a, b, m, upper_triangular=upper_triangular)
    dev = _check_cuda(a, b, m)
    (R, K), N = a.shape, b.shape[1]
    if max(R, K, N) > _INT32_MAX:
        raise ValueError(f"{R} rows, {K} inner and {N} columns exceed the kernel's "
                         f"reach: TMA's 32-bit coordinates take at most {_INT32_MAX}")
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    if not (R and K and N):
        return out[0]
    slice_, items = split_plan(R, K, N, upper_triangular, _sm_count(dev.index))
    if items > _INT32_MAX:
        raise ValueError(f"{items} work items exceed the kernel's 1-D grid "
                         f"({_INT32_MAX} CTAs)")
    a = a if a.stride(1) == 1 else a.contiguous()
    b, m = _tma_operand(b), _tma_operand(m)
    if items:
        with torch.cuda.device(dev):
            MASKED(a.data_ptr(), a.stride(0), b.data_ptr(), tma_row_stride(b),
                   m.data_ptr(), tma_row_stride(m), R, K, N, int(upper_triangular),
                   slice_, items, out.data_ptr(),
                   stream=torch.cuda.current_stream(dev).cuda_stream)
    return out[0]


def triangle_count(u: torch.Tensor, *, live_grid: bool = True) -> torch.Tensor:
    """sum(U ⊙ (U @ U)) for strictly upper triangular 0/1 U.

    ``u`` is (n, n) → int64 scalar, or a (B, n, n) batch → (B,) int64.
    ``live_grid=True`` runs K1, one launch for the whole batch: output tiles
    i ≤ k of U·Uᵀ over chunks j ≥ k — C(nb+2, 3) tile products instead of
    nb³. Any strides with a unit column stride: a view ``u[:, :n, :n]`` of
    an aligned buffer is read in place, anything else TMA cannot read is
    copied (:func:`tma_batch_strides`). ``live_grid=False`` runs K2 with the
    upper-triangular skip, one launch per matrix, kept as the comparison
    baseline."""
    if u.dim() not in (2, 3) or u.shape[-1] != u.shape[-2]:
        raise ValueError(f"expected (n, n) or (B, n, n), got {tuple(u.shape)}")
    if u.device.type == "cpu":
        return triangle_count_ref(u)
    dev = _check_cuda(u)
    if u.dim() == 3 and u.shape[0] > _GRID_YZ:
        raise ValueError(f"a batch of {u.shape[0]} exceeds the kernel's grid "
                         f"({_GRID_YZ} matrices)")
    ub = u if u.dim() == 3 else u[None]
    batch, n = ub.shape[0], ub.shape[-1]
    if not live_grid:
        out = torch.stack([masked_matmul_sum(x, x, x, upper_triangular=True) for x in ub]) \
            if batch else torch.zeros(0, dtype=torch.int64, device=dev)
        return out if u.dim() == 3 else out[0]
    out = torch.zeros(batch, dtype=torch.int64, device=dev)
    if batch and n:
        slice_, items = split_plan(n, n, n, True, _sm_count(dev.index))
        if items > _INT32_MAX:
            raise ValueError(f"{items} work items exceed the kernel's 1-D grid "
                             f"({_INT32_MAX} CTAs)")
        ub = _tma_operand(ub)
        ld, mat_stride = tma_batch_strides(ub)
        with torch.cuda.device(dev):
            LIVE(ub.data_ptr(), n, ld, mat_stride, batch, slice_, items, out.data_ptr(),
                 stream=torch.cuda.current_stream(dev).cuda_stream)
    return out if u.dim() == 3 else out[0]


def triangle_count_grid_steps(n: int, *, sms: int | None = None) -> int:
    """CTAs :func:`triangle_count` launches for an (n, n) input: the work
    items of :func:`split_plan` under the upper-triangular skip, one CTA
    each, on a card with ``sms`` SMs (by default the current CUDA device's
    count, which the kernels read). The reference counts its Pallas grid
    steps here; in the port K1 and K2 under the skip decode the same items
    (:func:`work_item`), so this is both kernels' count."""
    if not n:
        return 0
    if sms is None:
        sms = _sm_count(torch.cuda.current_device())
    return split_plan(n, n, n, True, sms)[1]
