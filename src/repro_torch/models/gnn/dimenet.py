"""DimeNet [arXiv:2003.03123]: directional message passing with radial-basis
distances and spherical-basis (distance × angle) triplet features, the port
of ``repro/models/gnn/dimenet.py``.

Bessel-style sine RBF with smooth envelope (n_radial=6), separable SBF
(n_spherical=7 angular cosines × n_radial radial), embedding block,
n_blocks=6 interaction blocks with the bilinear triplet layer
(n_bilinear=8), per-block output MLPs summed into atom energies. The
triplet gather (k→j→i) uses precomputed padded index lists
(``build_triplets``, host numpy) and a segment sum back to edges.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn import common as C
from repro_torch.models.layers import normal_
from repro_torch.utils import resolve_device


# --------------------------------------------------------------------------
# basis functions
# --------------------------------------------------------------------------
def envelope(d: torch.Tensor, cutoff: float, p: int = 6) -> torch.Tensor:
    """Smooth polynomial cutoff (DimeNet eq. 8)."""
    x = d / cutoff
    a = -(p + 1) * (p + 2) / 2
    b = p * (p + 2)
    c = -p * (p + 1) / 2
    env = 1.0 / torch.clamp(x, min=1e-9) + a * x ** (p - 1) + b * x**p + c * x ** (p + 1)
    return torch.where(x < 1.0, env, 0.0)


def radial_basis(d: torch.Tensor, n_radial: int, cutoff: float) -> torch.Tensor:
    """(..., ) → (..., n_radial) sine Bessel basis with envelope."""
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    x = d[..., None]
    rbf = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * x / cutoff)
    return rbf * envelope(d, cutoff)[..., None]


def spherical_basis(d: torch.Tensor, angle: torch.Tensor, n_spherical: int, n_radial: int,
                    cutoff: float) -> torch.Tensor:
    """(T,) × (T,) → (T, n_spherical * n_radial) separable distance×angle basis."""
    rbf = radial_basis(d, n_radial, cutoff)  # (T, n_radial)
    ls = torch.arange(n_spherical, dtype=torch.float32, device=d.device)
    ang = torch.cos(ls[None, :] * angle[:, None])  # (T, n_spherical)
    return (ang[:, :, None] * rbf[:, None, :]).reshape(d.shape[0], n_spherical * n_radial)


# --------------------------------------------------------------------------
# triplet construction (host side, padded): the reference's, verbatim
# --------------------------------------------------------------------------
def build_triplets(edges: np.ndarray, n_nodes: int, max_per_edge: int = 8) -> np.ndarray:
    """edges: (E, 2) directed (src j → dst i). For each edge e=(j→i) collect up
    to ``max_per_edge`` incoming edges k→j with k != i. Returns (E*max, 2)
    int32 (edge_kj, edge_ji) padded with E (phantom edge)."""
    E = len(edges)
    by_dst: dict[int, list[int]] = {}
    for idx, (s, t) in enumerate(edges):
        by_dst.setdefault(int(t), []).append(idx)
    out = np.full((E * max_per_edge, 2), E, dtype=np.int32)
    w = 0
    for e_ji, (j, i) in enumerate(edges):
        cnt = 0
        for e_kj in by_dst.get(int(j), []):
            k = edges[e_kj][0]
            if k == i or cnt >= max_per_edge:
                continue
            out[w] = (e_kj, e_ji)
            w += 1
            cnt += 1
    return out


def bilinear_apply(sb: torch.Tensor, w_bil: torch.Tensor, t_msg: torch.Tensor) -> torch.Tensor:
    """Σ_b sb[..., b] · (t_msg @ w_bil[b]) — loop over the n_bilinear slots,
    never materializing the (T, d, e) contraction intermediate."""
    out = None
    for b in range(w_bil.shape[0]):
        term = sb[..., b : b + 1] * (t_msg @ w_bil[b])
        out = term if out is None else out + term
    return out


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------
class InteractionBlock(nn.Module):
    """``w_sbf``, ``w_bil``, ``mlp_src``, ``mlp_out``, ``out_rbf``, ``out_mlp``."""

    def __init__(self, cfg: GNNConfig, *, device):
        super().__init__()
        d, n_sbf = cfg.d_hidden, cfg.n_spherical * cfg.n_radial
        self.w_sbf = C.parameter((n_sbf, cfg.n_bilinear), device=device)
        self.w_bil = C.parameter((cfg.n_bilinear, d, d), device=device)
        self.mlp_src = C.DenseMLP([d, d], device=device)
        self.mlp_out = C.DenseMLP([d, d, d], device=device)
        self.out_rbf = C.DenseMLP([cfg.n_radial, d], device=device)
        self.out_mlp = C.DenseMLP([d, d, 1], device=device)


class DimeNet(C.GNN):
    """``species`` (n_species, d), ``rbf_proj``, ``embed_mlp`` and ``blocks``,
    the reference's tree (``blocks.3.w_bil``, ...)."""

    def __init__(self, cfg: GNNConfig, n_species: int = 16, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        d = cfg.d_hidden
        self.species = C.parameter((n_species, d), device=dev)
        self.rbf_proj = C.DenseMLP([cfg.n_radial, d], device=dev)
        self.embed_mlp = C.DenseMLP([3 * d, d], device=dev)
        self.blocks = nn.ModuleList(InteractionBlock(cfg, device=dev)
                                    for _ in range(cfg.n_layers))


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: GNNConfig, n_species: int = 16, *,
                device=None) -> DimeNet:
    """A :class:`DimeNet` with the reference's initial scales: species
    N(0, 0.25), ``w_sbf`` N(0, 1/n_sbf), ``w_bil`` N(0, 1/d), MLP weights
    N(0, 1/fan-in), biases 0."""
    model = DimeNet(cfg, n_species, device=device)
    normal_(model.species, generator, 0.5)
    for mlp in model.modules():
        if isinstance(mlp, C.DenseMLP):
            C.mlp_normal_(mlp, generator)
    for blk in model.blocks:
        normal_(blk.w_sbf, generator, blk.w_sbf.shape[0] ** -0.5)
        normal_(blk.w_bil, generator, cfg.d_hidden ** -0.5)
    return model


def forward_energy(model: DimeNet, cfg: GNNConfig, z: torch.Tensor, pos: torch.Tensor,
                   edges: torch.Tensor, triplets: torch.Tensor, *, cutoff: float = 5.0,
                   graph_ids: torch.Tensor | None = None, n_graphs: int = 1) -> torch.Tensor:
    """z: (N,) species ids; pos: (N, 3); edges: (E, 2) directed j→i (phantom N);
    triplets: (T, 2) (edge_kj, edge_ji) (phantom E). → per-graph energies
    (a graph id outside [0, n_graphs) is dropped)."""
    n, e = pos.shape[0], edges.shape[0]
    src, dst = edges[:, 0], edges[:, 1]
    valid_e = (src < n)[:, None].to(pos.dtype)
    p_src = pos[torch.clamp(src, max=n - 1).long()]
    p_dst = pos[torch.clamp(dst, max=n - 1).long()]
    vec = (p_dst - p_src) * valid_e
    dist = torch.linalg.vector_norm(vec + 1e-9, dim=-1)
    rbf = radial_basis(dist, cfg.n_radial, cutoff) * valid_e

    # triplet geometry: angle at j between (k→j) and (j→i)
    t_kj = torch.clamp(triplets[:, 0], max=e - 1).long()
    t_ji = torch.clamp(triplets[:, 1], max=e - 1).long()
    valid_t = (triplets[:, 0] < e)[:, None].to(pos.dtype)
    v1 = -vec[t_kj]  # j→k
    v2 = vec[t_ji]  # j→i ... vec is src→dst = j→i
    norms = torch.linalg.vector_norm(v1, dim=-1) * torch.linalg.vector_norm(v2, dim=-1)
    cosang = torch.sum(v1 * v2, -1) / torch.clamp(norms, min=1e-9)
    angle = torch.arccos(torch.clamp(cosang, -1 + 1e-6, 1 - 1e-6))
    sbf = spherical_basis(dist[t_kj], angle, cfg.n_spherical, cfg.n_radial, cutoff) * valid_t

    # embedding block
    h = model.species[torch.clamp(z, max=model.species.shape[0] - 1).long()]
    h_src = C.gather_src(h, src)
    h_dst = C.gather_src(h, dst)
    m = C.mlp_apply(model.embed_mlp,
                    torch.cat([h_src, h_dst, C.mlp_apply(model.rbf_proj, rbf)], -1))

    energy = pos.new_zeros((n,), dtype=torch.float32)
    for blk in model.blocks:
        t_msg = C.mlp_apply(blk.mlp_src, m)[t_kj] * valid_t  # (T, d)
        sb = sbf @ blk.w_sbf  # (T, n_bilinear)
        tri = bilinear_apply(sb, blk.w_bil, t_msg)
        agg = C.segment_sum(tri, t_ji, e)
        m = m + C.mlp_apply(blk.mlp_out, m + agg)
        # output block: edge → node with rbf gate
        gated = m * C.mlp_apply(blk.out_rbf, rbf)
        node = C.aggregate(gated, dst, n, "sum")
        energy = energy + C.mlp_apply(blk.out_mlp, node)[:, 0].float()

    if graph_ids is None:
        return torch.sum(energy)[None]
    # phantom nodes carry graph_id == n_graphs and are dropped
    return C.segment_sum(energy, graph_ids, n_graphs + 1)[:n_graphs]


def mse_loss(model: DimeNet, cfg: GNNConfig, z, pos, edges, triplets, target,
             **kw) -> torch.Tensor:
    pred = forward_energy(model, cfg, z, pos, edges, triplets, **kw)
    return torch.mean(torch.square(pred - target.float()))
