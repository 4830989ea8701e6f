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
at most 24 of V2-Lite's 64 experts. On meta tensors (``launch.dryrun``)
there is nothing to read: all T·k rows run as one group, the same
products any routing gives. A device-side grouped GEMM would
remove both the sync and the per-expert launches (ROADMAP.md A0j).

Expert weights are stacked (E, ...) as in the reference, so the parameter
tree carries across leaf for leaf, and expert parallelism is a split of
that leading axis over the ``"model"`` axis of a ``("data", "model")``
mesh: ``moe_apply_ep``, the reference's GShard dispatch with a capacity
per expert (tokens past it drop), run one mesh coordinate after another
by the one process that holds the mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
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
    # a meta tensor (a dry run) has no counts to read: one group of all T·k rows
    sizes = [t * k] + [0] * (e - 1) if x.device.type == "meta" else counts.tolist()
    for i, n in enumerate(sizes):  # the one host sync of the layer
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


# ---------------------------------------------------------------------------
# Expert-parallel path: GShard capacity dispatch on a ("data", "model") mesh
# ---------------------------------------------------------------------------
def ep_capacity(t_loc: int, cfg: LMConfig, capacity_factor: float) -> int:
    """Slots per expert and data row: max(1, int(t_loc·k / E · factor)),
    in the reference's order of operations."""
    return max(1, int(t_loc * cfg.moe.top_k / cfg.moe.n_routed * capacity_factor))


def _slot_positions(flat_e: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Each slot's exclusive running count among the earlier slots of its
    column (slot order: token, then its k picks in ``top_k`` order)."""
    oh = F.one_hot(flat_e, n_cols)
    return (oh.cumsum(0) - oh).gather(1, flat_e[:, None])[:, 0]


def _ep_shard(p: MoE, cfg: LMConfig, x_loc: torch.Tensor, m: int, e_loc: int, cap: int):
    """Mesh coordinate (row, m) on ``x_loc``'s device: route the row, fill
    the (e_loc, cap, D) buffer of model shard m's experts, run their FFNs
    and combine back → (its part of the row's output (t_loc, D), the row's
    aux loss)."""
    t_loc, d = x_loc.shape
    e, k = cfg.moe.n_routed, cfg.moe.top_k
    dev = x_loc.device
    scores = torch.softmax(x_loc.float() @ p.router.to(dev), dim=-1)
    top_w, top_i = torch.topk(scores, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    local = top_i.reshape(-1) - m * e_loc
    in_range = (local >= 0) & (local < e_loc)
    col = torch.where(in_range, local, e_loc)  # the other shards' slots share a spare column
    pos = _slot_positions(col, e_loc + 1)
    keep = in_range & (pos < cap)
    tok = torch.arange(t_loc * k, device=dev) // k
    # a kept slot's row in the buffer; every other slot writes a spare row, dropped after
    row = torch.where(keep, col * cap + pos, e_loc * cap)
    dispatch = x_loc.new_zeros(e_loc * cap + 1, d).index_put((row,), x_loc[tok])
    dispatch = dispatch[:-1].reshape(e_loc, cap, d)
    sl = slice(m * e_loc, (m + 1) * e_loc)
    g = activation(cfg.act)(torch.bmm(dispatch, p.w_gate[sl].to(dev)))
    u = torch.bmm(dispatch, p.w_up[sl].to(dev))
    y = torch.bmm((g * u).to(x_loc.dtype), p.w_down[sl].to(dev)).reshape(e_loc * cap, d)
    y_slot = torch.cat([y, y.new_zeros(1, d)])[row]  # 0 where dropped or foreign
    out = (y_slot * top_w.reshape(-1, 1).to(x_loc.dtype)).reshape(t_loc, k, d).sum(1)
    density = F.one_hot(top_i, e).sum(1).float().mean(0)
    return out, e * torch.sum(density * scores.mean(0))


def moe_apply_ep(p: MoE, cfg: LMConfig, x: torch.Tensor, *, mesh,
                 capacity_factor: float = 1.25) -> tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel MoE on ``mesh`` (a ``launch.Mesh`` with a
    ``"model"`` axis), the reference's GShard dispatch: x (T, D) → (y (T, D)
    in x's dtype on x's device, aux loss).

    The T tokens split over the data axes into contiguous rows of t_loc;
    coordinate (r, m) routes row r on its device, fills a (E/M, cap, D)
    buffer for model shard m's experts (``w_*[m·E/M:(m+1)·E/M]``, read on
    that device), runs their FFNs and combines back; the M parts of a row
    are summed on coordinate (r, 0)'s device, the psum over ``"model"``.
    cap = :func:`ep_capacity`; a slot's position in its expert is the
    running count of the row's earlier slots there, and a slot at
    position ≥ cap drops: it adds nothing, and still counts in the
    density. With a generous ``capacity_factor`` (E/k: nothing can drop)
    this equals :func:`moe_apply`.

    ``aux`` is the reference's: its value is data row 0's load-balance
    loss, its gradient the mean of the rows' gradients (ROADMAP.md §C).
    Differentiable through the dispatch, the copies and the sums. Raises
    ``ValueError`` when E does not divide over the model axis or T over
    the data rows."""
    from repro_torch.launch.mesh import data_model_grid

    grid = data_model_grid(mesh)
    n_rows, n_model = grid.shape
    e = cfg.moe.n_routed
    t, _ = x.shape
    if e % n_model:
        raise ValueError(f"{e} experts do not split over a model axis of {n_model}")
    if t % n_rows:
        raise ValueError(f"{t} tokens do not split over {n_rows} data rows")
    e_loc, t_loc = e // n_model, t // n_rows
    cap = ep_capacity(t_loc, cfg, capacity_factor)
    rows, auxes = [], []
    for r in range(n_rows):
        x_row = x[r * t_loc:(r + 1) * t_loc]
        total = None
        for m in range(n_model):
            part, aux = _ep_shard(p, cfg, x_row.to(grid[r, m]), m, e_loc, cap)
            part = part.to(grid[r, 0])
            total = part if total is None else total + part
            if m == 0:
                auxes.append(aux.to(x.device))
        rows.append(total.to(x.device))
    out = torch.cat(rows)
    if p.shared is not None:
        out = out + mlp_apply(p.shared, x, cfg.act)
    mean = torch.stack(auxes).mean()
    return out.to(x.dtype), auxes[0].detach() + (mean - mean.detach())


def ep_dropped(p: MoE, cfg: LMConfig, x: torch.Tensor, *, mesh,
               capacity_factor: float = 1.25) -> float:
    """The share of x's T·k routed slots that :func:`moe_apply_ep` on
    ``mesh`` drops (a host float; one sync)."""
    from repro_torch.launch.mesh import data_model_grid

    n_rows = data_model_grid(mesh).shape[0]
    t, k = x.shape[0], cfg.moe.top_k
    cap = ep_capacity(t // n_rows, cfg, capacity_factor)
    with torch.no_grad():
        _, _, top_i = route(p, cfg, x)
        pos = torch.cat([_slot_positions(r.reshape(-1), cfg.moe.n_routed)
                         for r in top_i.reshape(n_rows, -1, k)])
    return float((pos >= cap).float().mean())
