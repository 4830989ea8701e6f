"""GIN [arXiv:1810.00826]: h' = MLP((1 + ε) h + Σ_{j∈N(i)} h_j), ε learnable,
the port of ``repro/models/gnn/gin.py``.

Supports full-graph node classification, sampled minibatch blocks, and
batched small graphs (graph classification with sum readout, as on TU data).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn import common as C
from repro_torch.utils import resolve_device


class GINLayer(nn.Module):
    """``mlp`` ([d_in, d, d]) and the 0-d ``eps``."""

    def __init__(self, d_in: int, d: int, *, device):
        super().__init__()
        self.mlp = C.DenseMLP([d_in, d, d], device=device)
        self.eps = C.parameter((), device=device)


class GIN(C.GNN):
    """``layers`` (a ModuleList of :class:`GINLayer`) and ``readout``, the
    reference's tree (``layers.0.mlp.w0``, ``layers.0.eps``, ``readout.w0``)."""

    def __init__(self, cfg: GNNConfig, d_in: int, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        d = cfg.d_hidden
        self.layers = nn.ModuleList(GINLayer(d_in if i == 0 else d, d, device=dev)
                                    for i in range(cfg.n_layers))
        self.readout = C.DenseMLP([d, cfg.n_classes], device=dev)


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: GNNConfig, d_in: int, *, device=None) -> GIN:
    """A :class:`GIN` with the reference's initial scales (MLP weights
    N(0, 1/fan-in), biases and ε 0), drawn from ``generator``."""
    model = GIN(cfg, d_in, device=device)
    for layer in model.layers:
        C.mlp_normal_(layer.mlp, generator)
    C.mlp_normal_(model.readout, generator)
    return model


def _update(layer: GINLayer, self_x: torch.Tensor, agg: torch.Tensor) -> torch.Tensor:
    return C.mlp_apply(layer.mlp, (1.0 + layer.eps) * self_x + agg, act=F.relu,
                       final_act=True)


def forward_nodes(model: GIN, cfg: GNNConfig, x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """x: (N, d_in); edges: (E, 2) directed src→dst (pad with phantom N)."""
    n = x.shape[0]
    for layer in model.layers:  # a layer's (E, d) messages die with its aggregate
        agg = C.aggregate(C.gather_src(x, edges[:, 0]), edges[:, 1], n, cfg.aggregator)
        x = _update(layer, x, agg)
    return x


def logits_nodes(model: GIN, cfg: GNNConfig, x, edges) -> torch.Tensor:
    return C.mlp_apply(model.readout, forward_nodes(model, cfg, x, edges))


def logits_graphs(model: GIN, cfg: GNNConfig, x, edges, graph_ids,
                  n_graphs: int) -> torch.Tensor:
    """Batched small graphs: sum-pool node embeddings per graph (a graph id
    outside [0, n_graphs) is dropped, as the reference drops it)."""
    h = forward_nodes(model, cfg, x, edges)
    return C.mlp_apply(model.readout, C.segment_sum(h, graph_ids, n_graphs))


def forward_sampled(model: GIN, cfg: GNNConfig, feats: torch.Tensor,
                    blocks: list[dict]) -> torch.Tensor:
    """GraphSAGE-style hop stack, the reference's semantics: block i feeds
    layer i (only ``zip(layers, blocks)`` layers run), its messages gathered
    from the previous layer's rows by ``src_idx`` (phantom past the end) and
    masked, the self features the first ``n_dst`` rows.

    Each block dict: {"src_idx": (n_dst*f,), "dst_index": (n_dst*f,),
    "mask": (n_dst*f,), "n_dst": int}."""
    x = feats
    for layer, blk in zip(model.layers, blocks):
        msgs = C.gather_src(x, blk["src_idx"]) * blk["mask"][:, None].to(x.dtype)
        agg = C.segment_sum(msgs, blk["dst_index"], blk["n_dst"])
        x = _update(layer, x[: blk["n_dst"]], agg)
    return C.mlp_apply(model.readout, x)
