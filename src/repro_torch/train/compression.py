"""Gradient compression with error feedback (int8, per-tensor scale), the
port of ``repro/train/compression.py``.

int8 cuts the bytes of a data-parallel gradient all-reduce 4x against f32,
and the error-feedback residual keeps SGD converging (Seide et al.;
Karimireddy et al. 2019). ``compressed_psum`` is the reference's sum of the
quantized gradients over one axis of a mesh: the int8 payloads summed in
int32, dequantized with the mean of the per-index scales.
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


def compressed_psum(grads: list, residuals: list, axis_name: str, *, mesh) -> tuple:
    """The reference's compressed sum over ``mesh``'s axis ``axis_name`` of
    size n: ``grads`` and ``residuals`` hold one tree per index along the
    axis (index i's leaves on its own device). Each index quantizes its
    corrected gradient (:func:`compress_with_feedback`); the int8 payloads
    are summed in int32 and dequantized as the reference does, Σq · mean(s)
    / n with mean(s) the mean of the n per-index scales, which is not the
    mean of the corrected gradients where the scales differ (ROADMAP.md
    §C). Returns (one tree per index of that dequantized sum, equal on every
    index and on its leaves' devices; one tree per index of its new
    residuals). Raises ``ValueError`` unless there is one gradient and one
    residual tree per index."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"the mesh {mesh.axis_names} has no axis {axis_name!r}")
    n = mesh.shape[axis_name]
    if len(grads) != n or len(residuals) != n:
        raise ValueError(f"axis {axis_name!r} has {n} indices: got {len(grads)} gradient and "
                         f"{len(residuals)} residual trees")
    parts = [compress_with_feedback(g, r) for g, r in zip(grads, residuals)]

    def one(g, *qs_then_ss):  # one leaf: the n payloads, then the n scales
        q, sc = qs_then_ss[:n], qs_then_ss[n:]
        summed = sum(x.to(g.device, torch.int32) for x in q)  # the int32 psum
        mean_scale = sum(x.to(g.device) for x in sc) / n
        return summed.float() * mean_scale / n

    deq = tree_map(one, grads[0], *(p[0] for p in parts), *(p[1] for p in parts))
    return ([tree_map(lambda a, g: a.to(g.device), deq, g) for g in grads],
            [rs for _, _, rs in parts])
