"""Small shared utilities: the count dtype and device resolution."""
from __future__ import annotations

import torch


def count_dtype() -> torch.dtype:
    """Integer dtype of every triangle count: always int64.

    Full-size FNA.5 and FNA.9 are complete graphs with ~1.5e10 and ~6.2e9
    triangles, past 2³¹, so the port never counts in int32."""
    return torch.int64


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when a CUDA device is asked for (explicitly or by
    default) and none is present — never a quiet fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev
