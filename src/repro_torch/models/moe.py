"""DeepSeekMoE: shared experts + routed top-k with a sort-based grouped
FFN, the port of ``repro/models/moe.py``.

Dispatch is capacity-free and exact, as in the reference: token copies are
sorted by expert id (a stable sort, as ``jnp.argsort``), each expert's FFN
runs over its contiguous rows of the sorted tokens, and the results are
unsorted and combined over the k copies. The reference's grouped matmul is
``jax.lax.ragged_dot``, an XLA op and not a Pallas kernel; here it is one
``torch.matmul`` per expert that received tokens. The group sizes are read
to the host once per call to cut the sorted rows (one device sync per MoE
layer), and empty groups launch nothing: at decode, 4 tokens × top-6 reach
at most 24 of V2-Lite's 64 experts. A device-side grouped GEMM would
remove both the sync and the per-expert launches (ROADMAP.md A0j).

Expert weights are stacked (E, ...) as in the reference, so the parameter
tree carries across leaf for leaf. The expert-parallel path
(``moe_apply_ep``) raises: it shards experts over a ``("data", "model")``
mesh, which comes with ROADMAP.md queue A item 6e.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.models.layers import MLP, activation, mlp_apply, normal_
from repro_torch.utils import records_grad, resolve_device


class MoE(nn.Module):
    """``router`` (D, E) float32, ``w_gate`` / ``w_up`` (E, D, F),
    ``w_down`` (E, F, D) and, with shared experts, ``shared`` (an
    :class:`MLP` of width n_shared·F): the reference's leaves."""

    def __init__(self, cfg: LMConfig, dtype=torch.float32, *, device=None):
        super().__init__()
        mo = cfg.moe
        d, f, e = cfg.d_model, mo.d_ff_expert, mo.n_routed
        dev = resolve_device(device)
        for name, shape, dt in (("router", (d, e), torch.float32),
                                ("w_gate", (e, d, f), dtype), ("w_up", (e, d, f), dtype),
                                ("w_down", (e, f, d), dtype)):
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dt, device=dev), requires_grad=False))
        self.shared = (MLP(d, mo.n_shared * f, cfg.act, dtype, device=dev) if mo.n_shared
                       else None)

    @torch.no_grad()
    def draw_(self, generator: torch.Generator) -> None:
        """The reference's scales: router, ``w_gate`` and ``w_up`` at
        D^-½, ``w_down`` at F^-½ (the stacked weights' fan-in, not their
        leading expert axis), the shared MLP at its fan-in."""
        d, f = self.w_gate.shape[1], self.w_gate.shape[2]
        for w, std in ((self.router, d**-0.5), (self.w_gate, d**-0.5), (self.w_up, d**-0.5),
                       (self.w_down, f**-0.5)):
            normal_(w, generator, std)
        if self.shared is not None:
            self.shared.draw_(generator)


def moe_init(generator: torch.Generator, cfg: LMConfig, dtype=torch.float32, *,
             device=None) -> MoE:
    """A :class:`MoE` drawn from ``generator`` (which lies on ``device``)."""
    m = MoE(cfg, dtype, device=device)
    m.draw_(generator)
    return m


def route(p: MoE, cfg: LMConfig, x: torch.Tensor):
    """x: (T, D) → (scores (T, E) float32, top_w (T, k) renormalised,
    top_i (T, k)): softmax of ``x.float() @ router``, its top k, and
    DeepSeek's renormalisation of the k weights."""
    scores = torch.softmax(x.float() @ p.router, dim=-1)
    top_w, top_i = torch.topk(scores, cfg.moe.top_k, dim=-1)
    return scores, top_w / top_w.sum(-1, keepdim=True), top_i


def moe_apply(p: MoE, cfg: LMConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) flattened tokens → (y (T, D) in x's dtype, aux loss: a
    float32 scalar E · Σ_e density_e · prob_e). Differentiable where grad
    mode is on and x or a weight requires grad (the densities are counts,
    constant as in the reference); otherwise each expert's output is
    written straight into its rows of the sorted output."""
    t, d = x.shape
    e, k = cfg.moe.n_routed, cfg.moe.top_k
    act = activation(cfg.act)
    grad = records_grad(x, *p.parameters())
    scores, top_w, top_i = route(p, cfg, x)

    # sort-based dispatch: slot s is token s // k's copy for its (s % k)-th expert
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    xs = x[order // k]  # (T·k, D) sorted by expert
    # group sizes by a scatter-add: torch.bincount on a CUDA tensor reads
    # its input's min and max to the host, two more syncs
    counts = torch.zeros(e, dtype=torch.long, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    y_sorted = None if grad else torch.empty_like(xs)
    parts, start = [], 0
    for i, n in enumerate(counts.tolist()):  # the one host sync of the layer
        if n:
            rows = xs[start:start + n]
            h = act(rows @ p.w_gate[i]) * (rows @ p.w_up[i])
            if grad:  # autograd refuses out=
                parts.append(torch.matmul(h.to(xs.dtype), p.w_down[i]))
            else:
                torch.matmul(h.to(xs.dtype), p.w_down[i], out=y_sorted[start:start + n])
            start += n

    # unsort, then the weighted combine over the k copies in y's dtype
    if grad:
        y_sorted = torch.cat(parts)
        y_slots = torch.empty_like(y_sorted).index_copy(0, order, y_sorted)
    else:
        y_slots = torch.empty_like(y_sorted)
        y_slots[order] = y_sorted
    y = (y_slots.reshape(t, k, d) * top_w[..., None].to(y_slots.dtype)).sum(1)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, x, cfg.act)

    # load-balance aux loss (switch-style): the fraction of tokens routed
    # to each expert times its mean probability
    density = counts.float() / t
    aux = e * torch.sum(density * scores.mean(0))
    return y.to(x.dtype), aux


def moe_apply_ep(*args, **kwargs):
    raise NotImplementedError(
        "expert-parallel MoE shards the experts over a ('data', 'model') mesh, which is not in "
        "the port yet: ROADMAP.md queue A item 6e ports it; moe_apply runs the layer on one "
        "device")
