"""Wrapper of the bitset edge-closure CUDA kernel (``csrc/bitset_count.cu``).

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a CUDA
tensor it launches the kernel or raises."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.bitset_count.ref import bitset_edge_count_ref

_P, _L = ctypes.c_void_p, ctypes.c_longlong
EDGE = CudaKernel("bitset_count", "bs_edge_count", [_P, _L, _L, _P, _L, _P],
                  "bs_error_string")


def bitset_edge_count(masks: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Σ_e popcount(masks[u_e] & masks[v_e]) — the bitset ring's per-stage
    closure of one streamed edge block — as an int64 scalar.

    masks: (n_pad, W) int32 (uint32 bit patterns); edges: (B, 2) int32 ids,
    any B. Ids ≥ n_pad are phantom edges and count 0."""
    if masks.dim() != 2 or edges.dim() != 2 or edges.shape[1] != 2:
        raise ValueError(f"expected masks (n_pad, W) and edges (B, 2), got "
                         f"{tuple(masks.shape)} and {tuple(edges.shape)}")
    if masks.device.type == "cpu":
        return bitset_edge_count_ref(masks, edges)
    dev = masks.device
    if dev.type != "cuda" or edges.device != dev:
        raise ValueError(f"masks on {dev}, edges on {edges.device}")
    if masks.dtype != torch.int32 or edges.dtype != torch.int32:
        raise TypeError(f"the CUDA kernel takes int32 masks and edges, got "
                        f"{masks.dtype} and {edges.dtype}")
    masks, edges = masks.contiguous(), edges.contiguous()
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    (n_pad, w), b = masks.shape, edges.shape[0]
    if n_pad and w and b:
        with torch.cuda.device(dev):
            EDGE(masks.data_ptr(), n_pad, w, edges.data_ptr(), b, out.data_ptr(),
                 stream=torch.cuda.current_stream(dev).cuda_stream)
    return out[0]
