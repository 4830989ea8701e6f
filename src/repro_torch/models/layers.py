"""Shared neural layers: RMSNorm, rotary embeddings, the LM's MLP, and
the cross-entropy losses.

Functions on tensors, as in the reference (``repro/models/layers.py``); an
MLP's weights live in an :class:`MLP` module whose parameter names are the
reference's leaf names, in the (in, out) orientation that ``x @ W`` uses.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.utils import records_grad, resolve_device


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · scale, the variance taken in float32 and
    cast to x's dtype before the product."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rotary_cos_sin(positions: torch.Tensor, dim: int,
                   theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) integers → cos/sin of shape (..., dim // 2), float32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, D); cos/sin: (S, D // 2). Rotates the two halves of the
    last dimension (split halves, not interleaved pairs)."""
    x1, x2 = x.chunk(2, dim=-1)
    shape = (1,) * (x.dim() - 2) + tuple(cos.shape)
    cos = cos.reshape(shape).to(x.dtype)
    sin = sin.reshape(shape).to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def activation(name: str):
    if name == "swiglu":
        return F.silu
    if name == "geglu":
        return _gelu
    if name == "relu2":
        return _relu2
    raise ValueError(name)


class MLP(nn.Module):
    """Gated (``w_gate``, ``w_up``, ``w_down``: swiglu/geglu) or plain
    (``w_in``, ``w_out``: relu2, Nemotron-style) MLP weights."""

    def __init__(self, d_model: int, d_ff: int, act: str, dtype=torch.float32, *,
                 device=None):
        super().__init__()
        activation(act)  # raises on an unknown activation
        dev = resolve_device(device)
        shapes = ({"w_in": (d_model, d_ff), "w_out": (d_ff, d_model)} if act == "relu2" else
                  {"w_gate": (d_model, d_ff), "w_up": (d_model, d_ff),
                   "w_down": (d_ff, d_model)})
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=dev), requires_grad=False))

    def draw_(self, generator: torch.Generator) -> None:
        """Every weight N(0, 1/fan-in), drawn from ``generator``."""
        fan_in_normal_(self, generator)


def mlp_apply(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated (swiglu/geglu) or plain (relu2, Nemotron-style) MLP."""
    fn = activation(act)
    if act == "relu2":
        return fn(x @ p.w_in) @ p.w_out
    return (fn(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype=torch.float32, *, device=None) -> MLP:
    """An :class:`MLP` with normal weights scaled by fan-in^-½, drawn from
    ``generator`` (which lies on ``device``)."""
    return fan_in_normal_(MLP(d_model, d_ff, act, dtype, device=device), generator)


def fan_in_normal_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every (in, out) weight of ``module`` in place with
    N(0, 1/in), the reference's scale for projections. Raises on a
    parameter that is not a matrix: a stacked (E, in, out) weight or a norm
    scale needs its own rule (``MoE.draw_``, ``MLA.draw_``)."""
    for name, w in module.named_parameters():
        if w.dim() != 2:
            raise ValueError(f"{name}: fan_in_normal_ draws (in, out) matrices, not a "
                             f"{tuple(w.shape)} parameter")
        normal_(w, generator, w.shape[0] ** -0.5)
    return module


@torch.no_grad()
def normal_(w: torch.Tensor, generator: torch.Generator, std: float) -> torch.Tensor:
    """Fill ``w`` in place with N(0, std²) drawn in float32 from
    ``generator`` and cast to w's dtype (as the reference draws in float32
    and casts)."""
    if w.dtype == torch.float32:
        return w.normal_(0.0, std, generator=generator)
    tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    return w.copy_(tmp.normal_(0.0, std, generator=generator))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross-entropy in float32. logits: (..., V); labels: (...,)
    integer ids in [0, V)."""
    logits = logits.float()
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)


def _ce_chunk_sum(xc: torch.Tensor, unembed: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
    """Σ over one chunk's tokens with a label ≥ 0 of logsumexp − gold, the
    (B, chunk, V) logits in float32."""
    if xc.dtype == torch.float32 and unembed.dtype == torch.float32:
        logits = xc @ unembed
    else:  # accumulate in f32, the reference's preferred_element_type
        logits = xc.float() @ unembed.float()
    gold = logits.gather(-1, lc.clamp(min=0)[..., None])[..., 0]
    per_token = torch.logsumexp(logits, dim=-1) - gold
    return torch.where(lc >= 0, per_token, torch.zeros_like(per_token)).sum()


def chunked_cross_entropy(x: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor,
                          *, chunk: int = 512) -> torch.Tensor:
    """Token-mean cross-entropy without ever holding the (B, S, V) logits.

    x: (B, S, D) final hidden states; unembed: (D, V); labels: (B, S), a
    label of -1 being padding that adds nothing to the sum (the mean still
    divides by B·S, as the reference's). The sequence goes ``chunk`` tokens
    at a time (the last chunk ragged, where the reference pads it); where
    autograd records a graph each chunk is checkpointed, so the backward
    pass recomputes its logits and at most a (B, chunk, V) block is live."""
    b, s, _ = x.shape
    labels = labels.long()
    remat = records_grad(x, unembed)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        xc, lc = x[:, i:i + chunk], labels[:, i:i + chunk]
        total = total + (checkpoint(_ce_chunk_sum, xc, unembed, lc, use_reentrant=False)
                         if remat else _ce_chunk_sum(xc, unembed, lc))
    return total / (b * s)
