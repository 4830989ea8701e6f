"""MACE [arXiv:2206.07697]: higher-order E(3)-equivariant message passing,
the port of ``repro/models/gnn/mace.py``.

Real-basis irreps:
  node features  h = {l: (N, 2l+1, C)}          l ≤ l_max = 2, C = d_hidden
  edge attrs     Y_l(r̂_ij), radial Bessel R(d_ij) → per-path weights
  atomic basis   A_i^{l3} = Σ_j Σ_{l1,l2→l3} w_path(d_ij) · CG ⊙ (h_j^{l1}, Y^{l2})
  product basis  B = A ⊕ CG(A,A) ⊕ CG(CG(A,A),A)    (correlation order 3)
  update         h' = Linear(B) + Linear(h)          (per-l channel mixing)
  readout        site energies from l=0 features, summed per graph.

Every tensor contraction is a channel-wise CG product over the nonzero
entries of the real CG tables of ``cg.py``, one (N, C) term at a time.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn import common as C
from repro_torch.models.gnn.cg import real_cg, sh_l
from repro_torch.models.gnn.dimenet import radial_basis
from repro_torch.models.layers import normal_
from repro_torch.utils import resolve_device


def _paths(l_max: int):
    """All (l1, l2, l3) with nonzero CG and every l ≤ l_max."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l_max, l1 + l2) + 1):
                out.append((l1, l2, l3))
    return out


class MACELayer(nn.Module):
    """``radial`` ([n_rbf, 64, P·C]), the per-l mixings ``mix_a``, ``mix_b2``,
    ``mix_b3`` and ``res`` (each keyed by ``str(l)``, (C, C)) and
    ``readout`` ([C, 16, 1])."""

    def __init__(self, cfg: GNNConfig, *, device):
        super().__init__()
        c, ls = cfg.d_hidden, range(cfg.l_max + 1)
        self.radial = C.DenseMLP([cfg.n_rbf, 64, len(_paths(cfg.l_max)) * c], device=device)
        for name in ("mix_a", "mix_b2", "mix_b3", "res"):
            setattr(self, name, nn.ParameterDict(
                {str(l): C.parameter((c, c), device=device) for l in ls}))
        self.readout = C.DenseMLP([c, 16, 1], device=device)


class MACE(C.GNN):
    """``species`` (n_species, C) and ``layers``, the reference's tree
    (``layers.1.mix_a.2``, ``layers.0.radial.w1``, ...)."""

    def __init__(self, cfg: GNNConfig, n_species: int = 16, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.species = C.parameter((n_species, cfg.d_hidden), device=dev)
        self.layers = nn.ModuleList(MACELayer(cfg, device=dev) for _ in range(cfg.n_layers))


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: GNNConfig, n_species: int = 16, *,
                device=None) -> MACE:
    """A :class:`MACE` with the reference's initial scales: species
    N(0, 0.25), the mixings N(0, 1/C), MLP weights N(0, 1/fan-in), biases 0."""
    model = MACE(cfg, n_species, device=device)
    normal_(model.species, generator, 0.5)
    for layer in model.layers:
        C.mlp_normal_(layer.radial, generator)
        for name in ("mix_a", "mix_b2", "mix_b3", "res"):
            for w in getattr(layer, name).values():
                normal_(w, generator, cfg.d_hidden ** -0.5)
        C.mlp_normal_(layer.readout, generator)
    return model


@lru_cache(maxsize=None)
def _nonzero(l1: int, l2: int, l3: int) -> tuple:
    """The nonzero entries (i, j, k, coefficient) of ``real_cg(l1, l2, l3)``,
    in the reference's order, each coefficient a Python float."""
    cg = real_cg(l1, l2, l3)
    return tuple((int(i), int(j), int(k), float(cg[i, j, k]))
                 for i, j, k in np.argwhere(np.abs(cg) > 1e-12))


def _cg_contract(x: torch.Tensor, y: torch.Tensor, l1: int, l2: int, l3: int) -> torch.Tensor:
    """Channel-wise CG: x (N, 2l1+1, C) ⊗ y (N, 2l2+1[, C]) → (N, 2l3+1, C).

    Expanded over the (sparse) nonzero CG entries instead of an einsum, which
    would materialize an (N, 2l1+1, 2l2+1, C) intermediate; the expansion
    peaks at one (N, C) term."""
    nz = _nonzero(l1, l2, l3)
    outs = []
    for k in range(2 * l3 + 1):
        acc = None
        for i, j, kk, coef in nz:
            if kk != k:
                continue
            yj = y[..., j, :] if y.dim() == x.dim() else y[..., j][..., None]
            term = coef * x[..., i, :] * yj
            acc = term if acc is None else acc + term
        if acc is None:
            acc = x.new_zeros(x.shape[:-2] + (x.shape[-1],))
        outs.append(acc)
    return torch.stack(outs, dim=-2)


def forward_energy(model: MACE, cfg: GNNConfig, z: torch.Tensor, pos: torch.Tensor,
                   edges: torch.Tensor, *, cutoff: float = 5.0,
                   graph_ids: torch.Tensor | None = None, n_graphs: int = 1) -> torch.Tensor:
    """z: (N,) species; pos: (N, 3); edges: (E, 2) directed j→i, phantom N.
    → per-graph energies (a graph id outside [0, n_graphs) is dropped)."""
    n, c, lm = pos.shape[0], cfg.d_hidden, cfg.l_max
    paths = _paths(lm)
    src, dst = edges[:, 0], edges[:, 1]
    valid = (src < n).to(pos.dtype)
    p_src = pos[torch.clamp(src, max=n - 1).long()]
    p_dst = pos[torch.clamp(dst, max=n - 1).long()]
    vec = p_dst - p_src
    dist = torch.linalg.vector_norm(vec + 1e-9, dim=-1)
    unit = vec / torch.clamp(dist, min=1e-9)[:, None]
    sh = {l: sh_l(unit, l) * valid[:, None] for l in range(lm + 1)}  # (E, 2l+1)
    rbf = radial_basis(dist, cfg.n_rbf, cutoff) * valid[:, None]

    h0 = model.species[torch.clamp(z, max=model.species.shape[0] - 1).long()]
    h = {0: h0[:, None, :]} | {l: h0.new_zeros((n, 2 * l + 1, c)) for l in range(1, lm + 1)}

    energy = pos.new_zeros((n,), dtype=torch.float32)
    for layer in model.layers:
        w = C.mlp_apply(layer.radial, rbf).reshape(-1, len(paths), c)  # (E, P, C)
        # atomic basis A
        a = {l: h0.new_zeros((n, 2 * l + 1, c)) for l in range(lm + 1)}
        for pi, (l1, l2, l3) in enumerate(paths):
            hj = C.gather_src(h[l1].reshape(n, -1), src).reshape(-1, 2 * l1 + 1, c)
            msg = _cg_contract(hj, sh[l2], l1, l2, l3) * w[:, pi][:, None, :]
            a[l3] = a[l3] + C.aggregate(msg.reshape(-1, (2 * l3 + 1) * c), dst, n,
                                        "sum").reshape(n, 2 * l3 + 1, c)
        # product basis: correlation order up to 3 (channel-wise)
        b2 = {l: torch.zeros_like(a[l]) for l in range(lm + 1)}
        b3 = {l: torch.zeros_like(a[l]) for l in range(lm + 1)}
        for l1, l2, l3 in paths:
            b2[l3] = b2[l3] + _cg_contract(a[l1], a[l2], l1, l2, l3)
        for l1, l2, l3 in paths:
            b3[l3] = b3[l3] + _cg_contract(b2[l1], a[l2], l1, l2, l3)
        # update with per-l channel mixing + residual
        h = {l: (a[l] @ layer.mix_a[str(l)] + b2[l] @ layer.mix_b2[str(l)]
                 + b3[l] @ layer.mix_b3[str(l)] + h[l] @ layer.res[str(l)])
             for l in range(lm + 1)}
        energy = energy + C.mlp_apply(layer.readout, h[0][:, 0, :])[:, 0].float()

    if graph_ids is None:
        return torch.sum(energy)[None]
    # phantom nodes carry graph_id == n_graphs and are dropped
    return C.segment_sum(energy, graph_ids, n_graphs + 1)[:n_graphs]


def mse_loss(model: MACE, cfg: GNNConfig, z, pos, edges, target, **kw) -> torch.Tensor:
    pred = forward_energy(model, cfg, z, pos, edges, **kw)
    return torch.mean(torch.square(pred - target.float()))
