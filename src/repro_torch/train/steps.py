"""Train and serve step builders per architecture family, the port of
``repro/train/steps.py``.

Each builder closes over the static config and returns
``step(model, opt_state, batch) -> (model, opt_state, metrics)`` (train) or
the serving equivalent. A train step turns ``requires_grad`` on for the
model it trains while it takes the loss's gradient with
``torch.autograd.grad`` (a parameter the loss does not reach gets zeros,
as ``jax.grad`` gives), leaves each flag as it found it (also when the
loss raises), and applies :func:`~repro_torch.train.optimizer.update` in
place: the returned model and state are the ones passed in.
``metrics["loss"]`` stays a 0-d tensor on the model's device, so a step
never waits for the card. Batches may be numpy arrays
(``data.pipeline``'s) or tensors.

``mesh`` (a ``launch.Mesh``) runs an MoE model's layers expert-parallel
on it (``moe_apply_ep``), as the reference's mesh steps do. The
reference's ``seq_parallel`` residual constraint and ``grad_specs`` are
GSPMD layout hints that move where a value lives and never the value; in
this port a shard lies where it was put, so they are checked (the spec tree
against the parameters, its axes against the mesh, its rank against each
array) and raise ``ValueError`` where the reference refuses, and the
values are unchanged (ROADMAP.md §C).
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig
from repro_torch.convert import lm_param_shapes
from repro_torch.launch.sharding import NamedSharding, P, check_specs, dp_axes
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import dimenet, gin, graphcast, mace
from repro_torch.models.recsys import autoint
from repro_torch.train import optimizer as opt


def _train_step(loss: Callable, opt_cfg: opt.AdamWConfig) -> Callable:
    def step(model, opt_state, batch):
        params = dict(model.named_parameters())
        flags = {name: p.requires_grad for name, p in params.items()}
        try:
            for p in params.values():
                p.requires_grad_(True)
            with torch.enable_grad():
                l = loss(model, batch=batch)
                grads = torch.autograd.grad(l, list(params.values()), allow_unused=True,
                                            materialize_grads=True)
        finally:  # serving after a step (K6, K7) needs the weights as they were
            for name, p in params.items():
                p.requires_grad_(flags[name])
        opt.update(params, dict(zip(params, grads)), opt_state, opt_cfg)
        return model, opt_state, {"loss": l.detach()}

    return step


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------
def lm_loss_remat(model, cfg: LMConfig, batch, *, chunk_q: int = 1024) -> torch.Tensor:
    """``loss_fn`` with per-block rematerialisation (activation checkpointing)."""
    return tf.loss_fn(model, cfg, batch, chunk_q=chunk_q, remat=True)


def make_lm_train_step(cfg: LMConfig, opt_cfg: opt.AdamWConfig | None = None,
                       *, chunk_q: int = 1024, remat: bool = True,
                       ce_chunk: int | None = None, mesh=None,
                       seq_parallel: bool = False, grad_specs=None) -> Callable:
    """One AdamW step on ``tf.loss_fn`` (chunked attention; ``remat``
    checkpoints each block; ``ce_chunk`` the chunked cross-entropy). With
    ``mesh``: an MoE model's layers run on it expert-parallel;
    ``seq_parallel`` checks the residual stream against the reference's
    sequence-parallel spec (:func:`make_lm_constrain`); ``grad_specs`` (a
    spec tree in ``convert.lm_params_to_tree``'s layout, e.g.
    ``launch.sharding.lm_param_specs``) is checked against the parameters
    on every step. Without a mesh, ``seq_parallel`` and ``grad_specs`` are
    ignored, as in the reference."""
    constrain = make_lm_constrain(mesh) if (mesh is not None and seq_parallel) else None
    ep_mesh = mesh if (mesh is not None and cfg.moe is not None) else None
    loss = partial(tf.loss_fn, cfg=cfg, chunk_q=chunk_q, remat=remat, ce_chunk=ce_chunk,
                   constrain=constrain, ep_mesh=ep_mesh)
    if grad_specs is not None and mesh is not None:
        plain = loss

        def loss(model, batch):
            check_specs(grad_specs, lm_param_shapes(model, cfg), mesh)
            return plain(model, batch=batch)

    return _train_step(loss, opt_cfg or opt.AdamWConfig())


def make_lm_constrain(mesh) -> Callable:
    """``constrain(x, role)`` for ``tf.hidden`` / ``tf.prefill``: the
    reference's Megatron sequence-parallel spec for the residual stream,
    ``P(dp, "model", None)`` (batch over the data axes, sequence over
    ``"model"``), checked as a sharding constraint is (the mesh has the
    axes, the array the rank; a dim need not divide: the reference pads
    it); x is returned unchanged. Other roles pass through."""
    dp = dp_axes(mesh)
    specs = {"residual": NamedSharding(mesh, P(dp if len(dp) > 1 else dp[0], "model", None))}

    def constrain(x, role):
        if role in specs:
            specs[role].check(tuple(x.shape), even=False)
        return x

    return constrain


def make_lm_prefill(cfg: LMConfig, s_max: int, *, chunk_q: int = 1024, mesh=None,
                    seq_parallel: bool = False, cache_dtype=None) -> Callable:
    """``step(model, tokens) -> (last-token logits, cache)``; ``mesh`` and
    ``seq_parallel`` as :func:`make_lm_train_step`'s."""
    constrain = make_lm_constrain(mesh) if (mesh is not None and seq_parallel) else None
    ep_mesh = mesh if (mesh is not None and cfg.moe is not None) else None
    cache_dtype = cache_dtype or torch.float32

    def step(model, tokens):
        return tf.prefill(model, cfg, torch.as_tensor(tokens, device=model.device), s_max,
                          chunk_q=chunk_q, cache_dtype=cache_dtype, constrain=constrain,
                          ep_mesh=ep_mesh)

    return step


def make_lm_serve_step(cfg: LMConfig) -> Callable:
    def step(model, cache, token, cur_len):
        return tf.decode_step(model, cfg, cache, torch.as_tensor(token, device=model.device),
                              cur_len)

    return step


# ---------------------------------------------------------------------------
# GNN (dispatch by family)
# ---------------------------------------------------------------------------
def _on(device, a):
    return torch.as_tensor(a, device=device)


def gnn_loss(model, cfg: GNNConfig, batch: dict) -> torch.Tensor:
    """The reference's loss of each family on ``batch`` (tensors or numpy
    arrays): GIN's mean cross-entropy on graph (``graph_ids``), sampled
    (``blocks``) or node logits; GraphCast's MSE; DimeNet's and MACE's
    energy MSE (per graph with ``graph_ids``)."""
    fam, dev = cfg.family, model.device
    if fam == "gin":
        x = _on(dev, batch["x"])
        if "graph_ids" in batch:
            logits = gin.logits_graphs(model, cfg, x, _on(dev, batch["edges"]),
                                       _on(dev, batch["graph_ids"]), batch["n_graphs"])
        elif "blocks" in batch:
            blocks = [{**{k: _on(dev, blk[k]) for k in ("src_idx", "dst_index", "mask")},
                       "n_dst": int(blk["n_dst"])} for blk in batch["blocks"]]
            logits = gin.forward_sampled(model, cfg, x, blocks)
        else:
            logits = gin.logits_nodes(model, cfg, x, _on(dev, batch["edges"]))
        logp = torch.log_softmax(logits.float(), dim=-1)
        labels = _on(dev, batch["labels"]).long()
        return -torch.mean(torch.take_along_dim(logp, labels[:, None], dim=1))
    if fam == "graphcast":
        return graphcast.mse_loss(model, cfg, _on(dev, batch["x"]), _on(dev, batch["edges"]),
                                  _on(dev, batch["target"]))
    kw = {"n_graphs": batch.get("n_graphs", 1)}
    if batch.get("graph_ids") is not None:
        kw["graph_ids"] = _on(dev, batch["graph_ids"])
    z, pos, edges = (_on(dev, batch[k]) for k in ("z", "pos", "edges"))
    if fam == "dimenet":
        return dimenet.mse_loss(model, cfg, z, pos, edges, _on(dev, batch["triplets"]),
                                _on(dev, batch["target"]), **kw)
    if fam == "mace":
        return mace.mse_loss(model, cfg, z, pos, edges, _on(dev, batch["target"]), **kw)
    raise ValueError(fam)


def make_gnn_train_step(cfg: GNNConfig, opt_cfg: opt.AdamWConfig | None = None) -> Callable:
    """One AdamW step (no weight decay by default) on :func:`gnn_loss`."""
    return _train_step(partial(gnn_loss, cfg=cfg), opt_cfg or opt.AdamWConfig(weight_decay=0.0))


# ---------------------------------------------------------------------------
# Recsys
# ---------------------------------------------------------------------------
def make_recsys_train_step(cfg: RecsysConfig,
                           opt_cfg: opt.AdamWConfig | None = None) -> Callable:
    """One AdamW step (no weight decay by default) on ``autoint.bce_loss``."""
    return _train_step(partial(autoint.bce_loss, cfg=cfg),
                       opt_cfg or opt.AdamWConfig(weight_decay=0.0))


def make_recsys_serve_step(cfg: RecsysConfig) -> Callable:
    @torch.no_grad()
    def step(model, sparse_ids):
        ids = torch.as_tensor(sparse_ids, device=model.table.device)
        return torch.sigmoid(autoint.ctr_logits(model, cfg, ids))

    return step


def make_recsys_retrieval_step(cfg: RecsysConfig) -> Callable:
    @torch.no_grad()
    def step(model, sparse_ids, candidates):
        dev = model.table.device
        return autoint.retrieval_scores(model, cfg, torch.as_tensor(sparse_ids, device=dev),
                                        torch.as_tensor(candidates, device=dev))

    return step
