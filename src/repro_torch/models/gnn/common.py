"""Shared GNN substrate: message passing over padded edge lists, the port
of ``repro/models/gnn/common.py``.

Message passing is an explicit edge-index gather (``gather_src``) and a
node scatter (``aggregate``, ``segment_sum``: ``index_add`` and
``scatter_reduce``). Edges are padded to a static length with src = dst =
n_nodes, a phantom node whose messages are dropped. ``jax.ops.segment_sum``
drops every id outside [0, num_segments), where ``index_add`` would raise
(on the card, a device-side assert): ``segment_sum`` masks such ids itself,
never clamps them, so it gives the reference's sums for any ids. The MLP
(``DenseMLP``, ``mlp_apply``) is also AutoInt's head.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import normal_
from repro_torch.utils import resolve_device


def pad_edges(edges: np.ndarray, n_edges_pad: int, n_nodes: int) -> np.ndarray:
    """(E, 2) → (n_edges_pad, 2) padded with the phantom node id n_nodes."""
    e = np.full((n_edges_pad, 2), n_nodes, dtype=np.int32)
    e[: len(edges)] = edges
    return e


def bidirect(edges: np.ndarray) -> np.ndarray:
    return np.concatenate([edges, edges[:, ::-1]], axis=0)


def _in_range(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``ids`` with every id outside [0, n) replaced by n (a row to drop)."""
    return torch.where((ids >= 0) & (ids < n), ids, n).long()


class _IndexAdd(torch.autograd.Function):
    """``data`` added into ``rows`` zero rows at ``ids``, with a backward that
    keeps only the ids: ``index_add``'s own keeps its (E, d) source alive,
    15.8 GB a GIN layer at ogb_products."""

    @staticmethod
    def forward(ctx, data, ids, rows):
        ctx.save_for_backward(ids)
        return data.new_zeros((rows,) + tuple(data.shape[1:])).index_add_(0, ids, data)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return grad.index_select(0, ids), None, None


def segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: data (E, ...) summed into ``num_segments``
    rows by ``ids`` (E,); ids outside [0, num_segments) are dropped."""
    return _IndexAdd.apply(data, _in_range(ids, num_segments), num_segments + 1)[:num_segments]


def aggregate(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int,
              aggregator: str = "sum") -> torch.Tensor:
    """messages: (E, d); dst: (E,) (phantom = n_nodes). → (n_nodes, d). An
    empty segment's max is 0, as is any other non-finite max."""
    if aggregator == "sum":
        return segment_sum(messages, dst, n_nodes)
    if aggregator == "mean":
        s = segment_sum(messages, dst, n_nodes)
        c = segment_sum(messages.new_ones((messages.shape[0], 1)), dst, n_nodes)
        return s / torch.clamp(c, min=1)
    if aggregator == "max":
        idx = _in_range(dst, n_nodes)[:, None].expand(-1, messages.shape[1])
        init = messages.new_full((n_nodes + 1, messages.shape[1]), -torch.inf)
        out = init.scatter_reduce(0, idx, messages, "amax", include_self=False)[:n_nodes]
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(aggregator)


def gather_src(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """x: (N, d); src: (E,) with phantom = N → zero rows for phantoms."""
    n = x.shape[0]
    rows = x[torch.clamp(src, max=n - 1).long()]
    return rows * (src < n)[:, None].to(x.dtype)


class GNN(nn.Module):
    """Base of the four GNN models: their parameters are float32 (the
    reference's bf16 GIN promotes through its float32 ε, so the port keeps
    one dtype) and live on one device."""

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def parameter(shape: tuple, *, device) -> nn.Parameter:
    """A float32 parameter of zeros that does not require grad (a train step
    turns that on while it differentiates)."""
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device),
                        requires_grad=False)


class DenseMLP(nn.Module):
    """Weights ``w{i}`` (dims[i], dims[i+1]) and biases ``b{i}``, the
    reference's leaf names."""

    def __init__(self, dims: list[int], dtype=torch.float32, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.n = len(dims) - 1
        for i in range(self.n):
            self.register_parameter(f"w{i}", nn.Parameter(
                torch.empty((dims[i], dims[i + 1]), dtype=dtype, device=dev),
                requires_grad=False))
            self.register_parameter(f"b{i}", nn.Parameter(
                torch.zeros(dims[i + 1], dtype=dtype, device=dev), requires_grad=False))


def mlp_init(generator: torch.Generator, dims: list[int], dtype=torch.float32, *,
             device=None) -> DenseMLP:
    """Weights N(0, 1/dims[i]) from ``generator`` (on ``device``), biases 0."""
    return mlp_normal_(DenseMLP(dims, dtype, device=device), generator)


def mlp_normal_(p: DenseMLP, generator: torch.Generator) -> DenseMLP:
    """Fill ``p``'s weights in place with N(0, 1/fan-in) and its biases with 0."""
    for i in range(p.n):
        w = getattr(p, f"w{i}")
        normal_(w, generator, w.shape[0] ** -0.5)
        getattr(p, f"b{i}").zero_()
    return p


def mlp_apply(p: DenseMLP, x: torch.Tensor, *, act=F.silu, final_act: bool = False) -> torch.Tensor:
    for i in range(p.n):
        x = x @ getattr(p, f"w{i}") + getattr(p, f"b{i}")
        if i < p.n - 1 or final_act:
            x = act(x)
    return x


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, keepdim=True, unbiased=False)
    return (x - m) * torch.rsqrt(v + 1e-6)
