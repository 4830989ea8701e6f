"""Wrapper of the EmbeddingBag CUDA kernel (``csrc/embedding_bag.cu``), K7.

On CPU tensors :func:`embedding_bag` runs the plain version
(``ref.embedding_bag_ref``); on CUDA tensors it launches the kernel or
raises."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.utils import records_grad

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
BAG = CudaKernel("embedding_bag", "eb_forward", [_P, _L, _I, _P, _L, _I, _P, _I],
                 "eb_error_string")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def embedding_bag(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Sum-mode EmbeddingBag: out[n] = Σ_l table[indices[n, l]] over the ids
    in [0, V), accumulated in float32 and cast to the table's dtype; an id
    ≥ V (the reference's sentinel) or < 0 is padding. table: (V, D) float32
    or bfloat16; indices: (N, L), int32 on the card. Returns (N, D).
    Raises ``RuntimeError`` on either device when grad mode is on and the
    table requires grad: the kernel has no backward."""
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError(f"expected table (V, D) and indices (N, L), got "
                         f"{tuple(table.shape)} and {tuple(indices.shape)}")
    if records_grad(table, indices):
        raise RuntimeError(
            "embedding_bag has no backward (neither has the reference's kernel): call it "
            "under torch.no_grad() or on a table that does not require grad, and train "
            "through the plain lookup")
    dev = table.device
    if dev.type == "cpu" and indices.device == dev:
        return embedding_bag_ref(table, indices)
    if dev.type != "cuda" or indices.device != dev:
        raise ValueError(f"table and indices must share one CPU or CUDA device, got "
                         f"{table.device} and {indices.device}")
    if table.dtype not in _DTYPE_CODE or indices.dtype != torch.int32:
        raise TypeError(f"the CUDA kernel takes a float32 or bfloat16 table and int32 "
                        f"indices, got {table.dtype} and {indices.dtype}")
    (v, d), (n, l) = table.shape, indices.shape
    if v >= 2**31:
        raise ValueError(f"int32 ids address at most 2^31 - 1 rows, the table has {v}")
    table, indices = table.contiguous(), indices.contiguous()
    out = torch.empty((n, d), dtype=table.dtype, device=dev)
    if out.numel():
        with torch.cuda.device(dev):
            BAG(table.data_ptr(), v, d, indices.data_ptr(), n, l, out.data_ptr(),
                _DTYPE_CODE[table.dtype], stream=torch.cuda.current_stream(dev).cuda_stream)
    return out
