"""Wrappers of the bitset closure CUDA kernels (``csrc/bitset_count.cu``):
the one-table edge count (K3), the two-table pair count (K4) and the
one-table count with one CTA per edge (K5).

On CPU tensors a wrapper runs the plain version (``ref.py``); on CUDA
tensors it launches the kernel or raises."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.bitset_count.ref import (
    bitset_edge_count_per_edge_ref,
    bitset_edge_count_ref,
    bitset_pair_count_ref,
)

_P, _L = ctypes.c_void_p, ctypes.c_longlong
EDGE = CudaKernel("bitset_count", "bs_edge_count", [_P, _L, _L, _P, _L, _P],
                  "bs_error_string")
PAIR = CudaKernel("bitset_count", "bs_pair_count", [_P, _P, _L, _L, _P, _L, _P],
                  "bs_error_string")
PER_EDGE = CudaKernel("bitset_count", "bs_per_edge_count", [_P, _L, _L, _P, _L, _P],
                      "bs_error_string")


def _check(tables, edges: torch.Tensor) -> bool:
    """Validate (n_pad, W) tables of one shape and (B, 2) edges; True when
    they lie on the CPU (run the plain version), False on one card (launch
    the kernel). Raises on anything the kernel does not take."""
    shape = tables[0].shape
    if any(t.dim() != 2 or t.shape != shape for t in tables) or edges.dim() != 2 \
            or edges.shape[1] != 2:
        raise ValueError(f"expected (n_pad, W) tables of one shape and edges (B, 2), got "
                         f"{[tuple(t.shape) for t in tables]} and {tuple(edges.shape)}")
    dev = tables[0].device
    if dev.type == "cpu" and all(x.device == dev for x in (*tables, edges)):
        return True
    if dev.type != "cuda" or any(x.device != dev for x in (*tables, edges)):
        raise ValueError(f"tables and edges must share one CPU or CUDA device, got "
                         f"{[str(t.device) for t in tables]} and {edges.device}")
    if any(x.dtype != torch.int32 for x in (*tables, edges)):
        raise TypeError(f"the CUDA kernel takes int32 tables and edges, got "
                        f"{[t.dtype for t in tables]} and {edges.dtype}")
    return False


def _launch(kernel: CudaKernel, tables, edges: torch.Tensor) -> torch.Tensor:
    dev = edges.device
    tables = [t.contiguous() for t in tables]
    edges = edges.contiguous()
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    (n_pad, w), b = tables[0].shape, edges.shape[0]
    if n_pad and w and b:
        with torch.cuda.device(dev):
            kernel(*(t.data_ptr() for t in tables), n_pad, w, edges.data_ptr(), b,
                   out.data_ptr(), stream=torch.cuda.current_stream(dev).cuda_stream)
    return out[0]


def bitset_edge_count(masks: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Σ_e popcount(masks[u_e] & masks[v_e]) — the bitset ring's per-stage
    closure of one streamed edge block, and the stream ingest's ``pre`` and
    ``dd`` terms — as an int64 scalar.

    masks: (n_pad, W) int32 (uint32 bit patterns); edges: (B, 2) int32 ids,
    any B. Ids ≥ n_pad are phantom edges and count 0."""
    if _check((masks,), edges):
        return bitset_edge_count_ref(masks, edges)
    return _launch(EDGE, (masks,), edges)


def bitset_pair_count(masks_a: torch.Tensor, masks_b: torch.Tensor,
                      edges: torch.Tensor) -> torch.Tensor:
    """Σ_e popcount(masks_a[u_e] & masks_b[v_e]) — the stream ingest's
    ``mixed`` term (u rows from the pre-block adjacency, v rows from the
    block's delta, or the other way round) — as an int64 scalar.

    Same contract as :func:`bitset_edge_count`, with two tables of one
    shape: u rows are read from ``masks_a``, v rows from ``masks_b``."""
    if _check((masks_a, masks_b), edges):
        return bitset_pair_count_ref(masks_a, masks_b, edges)
    return _launch(PAIR, (masks_a, masks_b), edges)


def bitset_edge_count_per_edge(masks: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """The sum of :func:`bitset_edge_count`, Σ_e popcount(masks[u_e] &
    masks[v_e]) as an int64 scalar, by the seed kernel's shape: one CTA per
    edge strides over the edge's two full rows. The hybrid stream ingest's
    ``pre`` term, over its (2B, W) table of pre-block rows.

    Same contract as :func:`bitset_edge_count`: only u ≥ n_pad makes an
    edge a phantom; v is clamped to n_pad − 1."""
    if _check((masks,), edges):
        return bitset_edge_count_per_edge_ref(masks, edges)
    if edges.shape[0] >= 2**31:
        raise ValueError(f"one CTA per edge: at most 2**31 - 1 edges, got {edges.shape[0]}")
    return _launch(PER_EDGE, (masks,), edges)


# csrc/bitset_count.cu's launch geometry of K3 and K4: THREADS a CTA, a
# group of the power of two >= W threads (at most 32) per edge, at most
# GRID_PER_SM CTAs per SM (the CTAs then stride over the edges)
THREADS = 256
GRID_PER_SM = 16


def bitset_grid_steps(n_edges: int, *, n_words: int, sms: int | None = None) -> int:
    """CTAs :func:`bitset_edge_count` (K3; K4 alike) launches for a block of
    ``n_edges`` edges over tables of ``n_words`` 32-bit words a row, on a
    card with ``sms`` SMs (by default the current CUDA device's count, which
    the launch reads): the reference counts its Pallas grid steps,
    ceil(B / edge_tile); the kernel gives each edge a group of the power of
    two >= W threads (at most 32), so a CTA of ``THREADS`` takes 256 / group
    edges, capped at ``GRID_PER_SM`` · sms CTAs."""
    if n_edges <= 0 or n_words <= 0:
        return 0
    if sms is None:
        sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    group_log2 = 0
    while (1 << group_log2) < n_words and group_log2 < 5:
        group_log2 += 1
    per_block = THREADS >> group_log2
    return min(-(-n_edges // per_block), GRID_PER_SM * sms)
