"""AdamW with float32 moments (parameters may be bf16), the reference's
arithmetic (``repro/train/optimizer.py``) rather than ``torch.optim.AdamW``:
the global gradient norm clipped to ``grad_clip`` as min(1, clip /
max(norm, 1e-9)), bias corrections with the step in float32, decoupled
weight decay on every leaf, and each parameter updated in float32 and cast
back to its dtype.

Parameters are a model (its ``named_parameters()``) or a tree of tensors
(dicts, lists, tuples); gradients and moments are trees of the same
structure, the moments keyed by parameter name for a model. ``update``
works in place on the parameters and the state, one leaf at a time (the
temporaries are one leaf's size), and never reads a value to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.utils import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def params_of(params: Any) -> Any:
    """A model's parameters as the dict {name: parameter}; a tree as it is."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else params


def init_state(params: Any) -> dict:
    """``{"m": zeros, "v": zeros, "step": 0}``: float32 moments shaped as the
    parameters, on their devices, and an int32 0-d step on the first
    parameter's device."""
    params = params_of(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    first = tree_leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt(Σ over the leaves of Σ g²), each leaf in float32: a 0-d tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


@torch.no_grad()
def update(params: Any, grads: Any, state: dict, cfg: AdamWConfig) -> tuple[Any, dict]:
    """One AdamW step: the parameters and ``state`` are updated in place and
    returned. ``grads`` has the parameters' structure (a model's: a dict by
    parameter name)."""
    params = params_of(params)
    state["step"].add_(1)
    t = state["step"].float()
    norm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(norm, min=1e-9), max=1.0)
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)

    def upd(p, g, m, v):
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).add_(torch.square(g), alpha=1 - cfg.b2)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.float()
        delta.add_(p32, alpha=cfg.weight_decay)
        p.copy_(p32 - cfg.lr * delta)

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, state
