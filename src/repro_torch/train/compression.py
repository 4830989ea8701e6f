"""Gradient compression with error feedback (int8, per-tensor scale), the
port of ``repro/train/compression.py``.

int8 cuts the bytes of a data-parallel gradient all-reduce 4x against f32,
and the error-feedback residual keeps SGD converging (Seide et al.;
Karimireddy et al. 2019). ``compressed_psum`` sums the quantized gradients
over a data axis of a ``("data", "model")`` mesh, which the port does not
have yet: it raises, naming ROADMAP.md queue A item 6e.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.utils import tree_map


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """g → (int8 q, float32 0-d scale): scale = max(max|g| / 127, 1e-12),
    q = clip(round(g / scale), -127, 127), rounding half to even."""
    scale = torch.clamp(g.abs().max().float() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grads: Any, residuals: Any) -> tuple[Any, Any, Any]:
    """(quantized, scales, new residuals), each a tree shaped as ``grads``:
    every leaf quantized after adding its residual, the new residual what
    the quantization lost."""

    def one(g, r):
        corrected = g.float() + r
        q, s = quantize(corrected)
        return q, s, corrected - dequantize(q, s)

    out = tree_map(one, grads, residuals)
    pick = lambda i: tree_map(lambda g, o: o[i], grads, out)  # noqa: E731
    return pick(0), pick(1), pick(2)


def init_residuals(params: Any) -> Any:
    """Float32 zeros shaped as every leaf of ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compressed_psum(grads: Any, residuals: Any, axis_name) -> tuple[Any, Any]:
    raise NotImplementedError(
        "compressed_psum sums int8 gradients over the data axis of a ('data', 'model') "
        "mesh, which is not in the port yet: ROADMAP.md queue A item 6e ports it; "
        "compress_with_feedback runs on one device")
