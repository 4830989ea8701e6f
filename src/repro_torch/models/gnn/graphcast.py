"""GraphCast-style encode-process-decode mesh GNN [arXiv:2212.12794], the
port of ``repro/models/gnn/graphcast.py``.

Encoder embeds per-node input variables (n_vars=227) into d_hidden=512,
the processor runs 16 InteractionNetwork layers (edge MLP → scatter-sum →
node MLP, residual, LayerNorm) over the (multi-)mesh edge set, the decoder
maps back to n_vars outputs (next-state prediction, MSE loss).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn import common as C
from repro_torch.utils import resolve_device


class InteractionLayer(nn.Module):
    """``edge_mlp`` ([3d, d, d] over [h_src, h_dst, e]) and ``node_mlp``
    ([2d, d, d] over [h, agg])."""

    def __init__(self, d: int, *, device):
        super().__init__()
        self.edge_mlp = C.DenseMLP([3 * d, d, d], device=device)
        self.node_mlp = C.DenseMLP([2 * d, d, d], device=device)


class GraphCast(C.GNN):
    """``encoder``, ``edge_embed``, ``decoder`` and ``layers``, the
    reference's tree (``layers.3.edge_mlp.w0``, ...)."""

    def __init__(self, cfg: GNNConfig, d_in: int | None = None, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        d = cfg.d_hidden
        nv = d_in if d_in is not None else cfg.n_vars
        self.encoder = C.DenseMLP([nv, d, d], device=dev)
        self.edge_embed = C.DenseMLP([4, d], device=dev)  # edge features: relative pos stub
        self.decoder = C.DenseMLP([d, d, nv], device=dev)
        self.layers = nn.ModuleList(InteractionLayer(d, device=dev) for _ in range(cfg.n_layers))


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: GNNConfig, d_in: int | None = None, *,
                device=None) -> GraphCast:
    """A :class:`GraphCast` with MLP weights N(0, 1/fan-in), biases 0."""
    model = GraphCast(cfg, d_in, device=device)
    for mlp in model.modules():
        if isinstance(mlp, C.DenseMLP):
            C.mlp_normal_(mlp, generator)
    return model


def forward(model: GraphCast, cfg: GNNConfig, x: torch.Tensor, edges: torch.Tensor,
            edge_feats: torch.Tensor | None = None) -> torch.Tensor:
    """x: (N, n_vars); edges: (E, 2) src→dst padded with phantom N."""
    n = x.shape[0]
    h = C.mlp_apply(model.encoder, x)
    if edge_feats is None:
        edge_feats = h.new_zeros((edges.shape[0], 4))
    e = C.mlp_apply(model.edge_embed, edge_feats)
    for layer in model.layers:
        h_src = C.gather_src(h, edges[:, 0])
        h_dst = C.gather_src(h, edges[:, 1])
        e = e + C.mlp_apply(layer.edge_mlp, torch.cat([h_src, h_dst, e], dim=-1))
        agg = C.aggregate(e, edges[:, 1], n, cfg.aggregator)
        h = h + C.layer_norm(C.mlp_apply(layer.node_mlp, torch.cat([h, agg], dim=-1)))
    return C.mlp_apply(model.decoder, h)


def mse_loss(model: GraphCast, cfg: GNNConfig, x, edges, target) -> torch.Tensor:
    pred = forward(model, cfg, x, edges)
    return torch.mean(torch.square(pred.float() - target.float()))
