"""The plain MLP of the reference's GNN substrate (``repro/models/gnn/
common.py``), which AutoInt's head uses. The message-passing functions
(``aggregate``, ``gather_src``, ``pad_edges``, ``layer_norm``) come with the
GNN slice (ROADMAP.md queue A item 6c)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import normal_
from repro_torch.utils import resolve_device


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
