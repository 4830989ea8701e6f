"""Dry run on the production mesh, the port of ``repro/launch/dryrun.py``:
build every (architecture × input shape) cell's step on the (16, 16) mesh,
or (2, 16, 16) across two pods, and record per-device memory and a
three-term roofline (compute, memory, collective) at the H100's rates.

The reference lowers and compiles each cell for 512 forced host devices
and reads XLA's memory and cost analyses. The port compiles nothing. A
cell's step and arguments are built on its mesh's device type:

- on a mesh of meta coordinates (what :func:`run_cell` and :func:`main`
  build) every tensor is a meta tensor: nothing is allocated and no card
  is needed. :func:`count_cell` runs the step once under
  ``torch.utils.flop_counter.FlopCounterMode`` (FLOPs) and a dispatch mode
  that counts bytes accessed (each op's inputs read and its outputs
  written once; a view moves nothing, a gather reads only the rows it
  gathers, an uninitialised allocation writes nothing) and the peak of the
  live intermediate bytes;
- on a CPU or CUDA mesh the same builders draw real inputs and weights
  from the ``generator`` they are given, so a realised step can be held
  against its meta count (``chip_smoke.py`` [dryrun] on the card).

Memory per device, under the reference's ``memory_analysis`` keys:

- ``argument_bytes``: every argument leaf's shard bytes under the cell's
  specs (``launch.sharding``, the reference's spec trees; a dim that does
  not divide over its axes is padded, as XLA pads it);
- ``output_bytes``: a train step returns its parameters and AdamW state
  (under their specs) and a 0-d loss; a prefill its cache (under
  ``lm_cache_specs``) and its last-token logits, a decode step the same
  with one token, a serve or retrieval step its scores, each split over
  the batch's axes where the batch divides; the triangle ring its int64
  count;
- ``alias_bytes``: what the reference donates: a train step's parameters
  and AdamW state, a decode step's cache;
- ``temp_bytes``: an estimate, the peak of the live intermediate bytes of
  the meta run (one step of the whole batch, on one controller) over the
  coordinates that share its batch: the data-parallel group (LM, recsys
  and full-graph GNN cells), every coordinate (the triangle ring, the
  retrieval step's candidates); a cell counted on one coordinate's shapes
  (below) is that coordinate's peak. Nothing is taken as split over
  ``"model"``;
- ``peak_bytes_per_device`` = argument + output + temp − alias, as the
  reference's.

The collectives are reckoned per family from the specs and shapes, each
by the reference's per-kind rule (``launch.hlo_analysis``); the roofline
divides the step's global FLOPs and bytes by the mesh's coordinates and
charges the compute at the int8 peak for the triangle ring's uint8
operands, at the bf16 peak for every other cell.

The partitioned GNN (``gnn_cell`` at ``ogb_products``, the reference's
explicit distributed engine) and the triangle ring loop over their stages:
on the production mesh the MACE step would run millions of meta ops. Every
stage does the same work on shapes of its own n/S rows and e/S edges, so
on a meta mesh the cell is counted on one coordinate's shapes and
multiplied by the coordinates; a CPU or CUDA mesh runs the loop
(``tests/test_torch_dryrun.py`` holds the one against the other on a small
mesh: the same FLOPs).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
Records go to results/dryrun/<mesh>/<arch>__<shape>.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from functools import partial
from typing import Any, Callable

import torch
from torch.utils import checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import shapes_for
from repro_torch.convert import lm_param_shapes
from repro_torch.launch import sharding as shr
from repro_torch.launch.analytic import analytic_cell
from repro_torch.launch.hlo_analysis import (
    HBM_BW,
    collective_stats,
    dtype_bytes,
    peak_ops,
    roofline_from_counts,
)
from repro_torch.launch.mesh import RingMesh, data_model_grid, flat_ring, make_production_mesh
from repro_torch.train import optimizer as opt
from repro_torch.train import steps
from repro_torch.utils import tree_map

LM_ARCHS = ("deepseek_v2_lite_16b", "deepseek_v2_236b", "granite_8b", "nemotron_4_15b", "yi_6b")
GNN_ARCHS = ("mace", "dimenet", "graphcast", "gin_tu")


@dataclasses.dataclass
class Cell:
    """One cell's step and what the dry run reckons of it. ``step(*args)``
    runs it; the byte fields are per device; ``collectives`` are
    ``hlo_analysis.collective_stats`` entries; ``spread`` is the number of
    coordinates its intermediates are taken as split over, ``scale`` the
    number of coordinates a count of ``step`` stands for (1 unless it runs
    one coordinate's shapes), and ``ops_dtype`` its operands' dtype, which
    picks the peak its compute term is charged at
    (``hlo_analysis.peak_ops``)."""

    step: Callable
    args: tuple
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    collectives: list
    spread: int
    scale: int = 1
    ops_dtype: torch.dtype = torch.bfloat16

    def run(self):
        return self.step(*self.args)


# ===========================================================================
# helpers
# ===========================================================================
def _pad_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _dp(mesh):
    dp = shr.dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def _dp_total(mesh) -> int:
    return math.prod(mesh.shape[a] for a in shr.dp_axes(mesh))


def _tensor(shape, dtype, device, generator=None, *, high: int = 2) -> torch.Tensor:
    """A meta tensor of ``shape`` on a meta device; elsewhere a draw from
    ``generator`` on ``device``: ints in [0, high), booleans, or standard
    normals."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if dtype == torch.bool:
        return torch.rand(shape, generator=generator, device=device) < 0.5
    if dtype.is_floating_point:
        return torch.randn(shape, generator=generator, device=device).to(dtype)
    return torch.randint(0, high, shape, generator=generator, device=device, dtype=dtype)


def shard_bytes(shape, dtype: torch.dtype, spec, mesh) -> int:
    """Bytes of one coordinate's block of an array of ``shape`` under
    ``spec`` on ``mesh`` (``NamedSharding.shard_shape``; a dim that does
    not divide over its axes is padded up, as XLA pads it)."""
    sharding = shr.NamedSharding(mesh, spec)
    sharding.check(tuple(shape), even=False)
    numel = math.prod(-(-n // sharding.splits(i)) for i, n in enumerate(shape))
    return numel * dtype_bytes(dtype)


def tree_bytes(tree: Any, specs: Any, mesh) -> int:
    """Σ :func:`shard_bytes` over the tensor leaves of ``tree`` paired, path
    for path, with the :class:`~repro_torch.launch.sharding.PartitionSpec`
    leaves of ``specs``; leaves that are no tensor (a static int) count 0."""
    leaves = dict(shr.spec_leaves(tree))
    total = 0
    for path, spec in shr.spec_leaves(specs):
        leaf = leaves[path]
        if isinstance(leaf, torch.Tensor):
            total += shard_bytes(tuple(leaf.shape), leaf.dtype, spec, mesh)
    return total


def _model_only(specs: Any, mesh) -> Any:
    """``specs`` with the data-parallel axes dropped: a gradient as each
    data-parallel replica holds it before their sum."""
    dp = set(shr.dp_axes(mesh))

    def drop(_, spec):
        return shr.P(*(tuple(a for a in shr._axes(part) if a not in dp) for part in spec))

    return shr._map_with_path(drop, specs)


def _f32_like(tree: Any) -> Any:
    return tree_map(lambda t: torch.empty(tuple(t.shape), dtype=torch.float32, device="meta"),
                    tree)


def _opt_bytes(shapes: Any, pspecs: Any, mesh) -> int:
    """AdamW's state (float32 m and v under the parameters' specs, an int32
    step) per device, in the reference's layout."""
    state = {"m": _f32_like(shapes), "v": _f32_like(shapes),
             "step": torch.empty((), dtype=torch.int32, device="meta")}
    return tree_bytes(state, shr.opt_state_specs(pspecs), mesh)


def _batch_split(n: int, mesh) -> int:
    """How many blocks a leading batch dim of ``n`` splits into over dp."""
    return _dp_total(mesh) if n % _dp_total(mesh) == 0 else 1


# ===========================================================================
# per-family cell builders: return a Cell on the mesh's device type
# ===========================================================================
def lm_cell(arch: str, shape, mesh, *, dtype=torch.bfloat16, cfg=None, generator=None) -> Cell:
    """The reference's LM cell (``chunk_q`` 1,024, a 512-token chunked
    cross-entropy, the mesh steps with their layout checks): a train step,
    a prefill, or a decode step of one token against a ``seq_len`` cache.
    ``cfg`` replaces the architecture's config (a cut depth, a smoke
    config)."""
    from repro_torch.models import transformer as tf

    cfg = cfg or get_config(arch)
    b, s = shape.global_batch, shape.seq_len
    dev = mesh.flat_devices[0]
    if dev.type == "meta":
        model = tf.Transformer(cfg, dtype, device=dev)
    else:
        model = tf.init_params(generator, cfg, dtype, device=dev)
    shapes = lm_param_shapes(model, cfg)
    pspecs = shr.lm_param_specs(shapes, mesh)
    p_bytes = tree_bytes(shapes, pspecs, mesh)
    dp_total = _dp_total(mesh)
    tok = partial(_tensor, dtype=torch.int32, device=dev, generator=generator, high=cfg.vocab)
    v_split = _batch_split(b, mesh)
    logits_bytes = -(-b // v_split) * cfg.vocab * 4

    def ep_sums(passes: int) -> list:
        # the EP's sum of the model shards' (t_loc, D) parts, a MoE layer a pass
        if cfg.moe is None:
            return []
        n_moe = cfg.n_layers - cfg.moe.n_dense_layers
        t_loc = b * s // data_model_grid(mesh).shape[0]
        return [("all-reduce", t_loc * cfg.d_model * dtype_bytes(dtype), mesh.shape["model"],
                 n_moe * passes)]

    if shape.kind == "train":
        state = opt.init_state(model)
        o_bytes = _opt_bytes(shapes, pspecs, mesh)
        batch = {"tokens": tok((b, s)), "labels": tok((b, s))}
        b_bytes = tree_bytes(batch, shr.lm_batch_specs(mesh), mesh)
        step = steps.make_lm_train_step(cfg, chunk_q=1024, ce_chunk=512, mesh=mesh,
                                        seq_parallel=True, grad_specs=pspecs)
        grads = tree_bytes(shapes, _model_only(pspecs, mesh), mesh)
        # the forward's sums and the remat recomputation's
        return Cell(step, (model, state, batch), p_bytes + o_bytes + b_bytes,
                    p_bytes + o_bytes + 4, p_bytes + o_bytes,
                    [("all-reduce", grads, dp_total, 1)] + ep_sums(2), dp_total)

    if shape.kind == "prefill":
        tokens = tok((b, s))
        t_bytes = shard_bytes((b, s), torch.int32, shr.P(_dp(mesh), None), mesh)
        step = steps.make_lm_prefill(cfg, s_max=s, chunk_q=1024, mesh=mesh,
                                     seq_parallel=True, cache_dtype=dtype)
        cache = tf.cache_init(cfg, b, s, dtype, device="meta")
        c_bytes = tree_bytes(cache, shr.lm_cache_specs(cache, mesh), mesh)
        return Cell(step, (model, tokens), p_bytes + t_bytes, c_bytes + logits_bytes, 0,
                    ep_sums(1), dp_total)

    # decode: one new token against a seq_len cache; the reference's serve
    # step takes no mesh (no EP)
    cache = tf.cache_init(cfg, b, s, dtype, device=dev)
    c_bytes = tree_bytes(cache, shr.lm_cache_specs(cache, mesh), mesh)
    tok_spec = shr.P(_dp(mesh), None) if b % dp_total == 0 else shr.P(None, None)
    token = tok((b, 1))
    cur = torch.full((), s - 1, dtype=torch.int32, device=dev)
    step = steps.make_lm_serve_step(cfg)
    args_bytes = p_bytes + c_bytes + shard_bytes((b, 1), torch.int32, tok_spec, mesh) + 4
    return Cell(step, (model, cache, token, cur), args_bytes, logits_bytes + c_bytes, c_bytes,
                [], _batch_split(b, mesh))


def _gnn_model(cfg, d_in: int, device, generator=None):
    from repro_torch.models.gnn import dimenet as dn
    from repro_torch.models.gnn import gin as gin_m
    from repro_torch.models.gnn import graphcast as gc
    from repro_torch.models.gnn import mace as mc

    fam = cfg.family
    if torch.device(device).type == "meta":
        cls = {"gin": partial(gin_m.GIN, d_in=d_in), "graphcast": gc.GraphCast,
               "mace": mc.MACE, "dimenet": dn.DimeNet}[fam]
        return cls(cfg, device=device)
    init = {"gin": partial(gin_m.init_params, d_in=d_in), "graphcast": gc.init_params,
            "mace": mc.init_params, "dimenet": dn.init_params}[fam]
    return init(generator, cfg, device=device)


def _gnn_train_cell(model, batch: dict, b_bytes: int, step, mesh, *, spread: int,
                    grad_group: int, scale: int = 1, extra=()) -> Cell:
    """A GNN train step's Cell: the parameters (``gnn_param_specs``) and
    AdamW state, the batch (``b_bytes`` a device), donated parameters and
    state, the gradient's all-reduce over ``grad_group`` coordinates."""
    params = dict(model.named_parameters())
    pspecs = shr.gnn_param_specs(params, mesh)
    p_bytes = tree_bytes(params, pspecs, mesh)
    o_bytes = _opt_bytes(params, pspecs, mesh)
    grads = tree_bytes(params, _model_only(pspecs, mesh), mesh)
    return Cell(step, (model, opt.init_state(model), batch), p_bytes + o_bytes + b_bytes,
                p_bytes + o_bytes + 4, p_bytes + o_bytes,
                [("all-reduce", grads, grad_group, 1), *extra], spread, scale)


def gnn_cell(arch: str, shape, mesh, *, cfg=None, generator=None) -> Cell:
    cfg = cfg or get_config(arch)
    n_dev = mesh.size
    fam = cfg.family
    n, e_dir = shape.n_nodes, shape.n_edges
    e_pad = _pad_to(2 * e_dir, n_dev)  # bidirected + padded
    dev = mesh.flat_devices[0]
    draw = partial(_tensor, device=dev, generator=generator)

    if shape.kind == "minibatch":
        # sampled blocks: 2 hops with fanouts (15, 10)
        f0, f1 = shape.fanout
        n0 = shape.batch_nodes
        n1 = _pad_to(n0 * (1 + f0), n_dev)
        n2 = _pad_to(n1 * (1 + f1), n_dev)
        d_in = 100
        # NOTE: only GIN trains with sampled blocks; other families fall back
        # to full-graph on the sampled-subgraph sizes.
        if fam != "gin":
            return _gnn_full_cell(arch, cfg, n1, _pad_to(n0 * f0 * 4, n_dev), 100, mesh,
                                  generator=generator)
        blocks = [
            {"src_idx": draw((n2,), torch.int32, high=n2 + 1),
             "dst_index": draw((n2,), torch.int32, high=n1),
             "mask": draw((n2,), torch.bool), "n_dst": n1},
            {"src_idx": draw((n1 * 4,), torch.int32, high=n1 + 1),
             "dst_index": draw((n1 * 4,), torch.int32, high=n0),
             "mask": draw((n1 * 4,), torch.bool), "n_dst": n0},
        ]
        batch = {"x": draw((n2, d_in), torch.float32), "blocks": blocks,
                 "labels": draw((n0,), torch.int32, high=cfg.n_classes)}
        model = _gnn_model(cfg, d_in, dev, generator)
        dyn = {"x": batch["x"], "labels": batch["labels"],
               "blocks": [{k: v for k, v in blk.items() if k != "n_dst"} for blk in blocks]}
        return _gnn_train_cell(model, dyn, tree_bytes(dyn, shr.gnn_batch_specs(dyn, mesh), mesh),
                               partial(_with_statics, steps.make_gnn_train_step(cfg), batch),
                               mesh, spread=_dp_total(mesh), grad_group=_dp_total(mesh))

    if shape.kind == "batched_small":
        n_graphs = shape.batch_graphs
        n_tot = _pad_to(n * n_graphs, n_dev)
        e_tot = _pad_to(2 * e_dir * n_graphs, n_dev)
        return _gnn_full_cell(arch, cfg, n_tot, e_tot, max(shape.d_feat, 16), mesh,
                              graph_ids=True, n_graphs=n_graphs, generator=generator)

    d_feat = max(shape.d_feat, 16)
    if n >= 100_000:  # ogb_products scale: explicit distributed engine
        e_pad8 = _pad_to(2 * e_dir, n_dev * 8)  # e_loc % 8 == 0 → edge chunking active
        return _gnn_distributed_cell(arch, cfg, _pad_to(n, n_dev), e_pad8, d_feat, mesh,
                                     generator=generator)
    return _gnn_full_cell(arch, cfg, _pad_to(n, n_dev), e_pad, d_feat, mesh,
                          generator=generator)


def _with_statics(step, statics: dict, model, opt_state, dyn: dict):
    """``step`` on ``dyn`` with the batch's static ints put back (the
    sampled blocks' ``n_dst``, ``n_graphs``), as the reference closes over
    them."""
    batch = dict(dyn)
    if "blocks" in statics:
        batch["blocks"] = [dict(blk, n_dst=full["n_dst"])
                           for blk, full in zip(dyn["blocks"], statics["blocks"])]
    batch.update({k: v for k, v in statics.items() if isinstance(v, int)})
    return step(model, opt_state, batch)


def _gnn_batch(fam: str, cfg, n: int, e: int, d_feat: int, draw, *, n_graphs: int = 1,
               graph_ids: bool = False) -> dict:
    batch = {"edges": draw((e, 2), torch.int32, high=n + 1)}
    if fam in ("mace", "dimenet"):
        batch |= {"z": draw((n,), torch.int32, high=16), "pos": draw((n, 3), torch.float32),
                  "target": draw((n_graphs,), torch.float32)}
        if fam == "dimenet":
            batch["triplets"] = draw((e * 4, 2), torch.int32, high=e)  # max_per_edge=4
    elif fam == "graphcast":
        batch |= {"x": draw((n, cfg.n_vars), torch.float32),
                  "target": draw((n, cfg.n_vars), torch.float32)}
    else:  # gin
        batch |= {"x": draw((n, d_feat), torch.float32),
                  "labels": draw((n,), torch.int32, high=cfg.n_classes)}
    if graph_ids:
        batch["graph_ids"] = draw((n,), torch.int32, high=n_graphs)
        if fam == "gin":
            batch["labels"] = draw((n_graphs,), torch.int32, high=cfg.n_classes)
    return batch


def _gnn_distributed_cell(arch, cfg, n, e, d_feat, mesh, *, generator=None) -> Cell:
    """The partitioned engine (``models.gnn.distributed``) over the mesh's
    coordinates flattened into a ring, bf16 compute where the family takes
    it. On a meta mesh it runs one stage's shapes (n/S nodes, e/S edges) on
    a ring of one stage, standing for all S; elsewhere the whole ring."""
    from repro_torch.models.gnn.distributed import make_distributed_gnn_train_step

    fam = cfg.family
    ring = flat_ring(mesh)
    n_dev = ring.size
    dev = ring.devices[0]
    axes = tuple(mesh.axis_names)
    draw = partial(_tensor, device=dev, generator=generator)
    per_coordinate = dev.type == "meta"
    run_ring, n_run, e_run = ((RingMesh((dev,)), n // n_dev, e // n_dev) if per_coordinate
                              else (ring, n, e))
    batch = _gnn_batch(fam, cfg, n_run, e_run, d_feat, draw)
    if fam in ("mace", "dimenet"):
        batch["target"] = draw((1,), torch.float32)
    # the global batch's per-device bytes under the reference's specs
    specs = {"edges": shr.P(axes, None)}
    shapes = {"edges": ((e, 2), torch.int32)}
    if fam in ("mace", "dimenet"):
        specs |= {"z": shr.P(axes), "pos": shr.P(axes, None), "target": shr.P(None)}
        shapes |= {"z": ((n,), torch.int32), "pos": ((n, 3), torch.float32),
                   "target": ((1,), torch.float32)}
        if fam == "dimenet":
            specs["triplets"] = shr.P(axes, None)
            shapes["triplets"] = ((e * 4, 2), torch.int32)
    elif fam == "graphcast":
        specs |= {"x": shr.P(axes, None), "target": shr.P(axes, None)}
        shapes |= {"x": ((n, cfg.n_vars), torch.float32),
                   "target": ((n, cfg.n_vars), torch.float32)}
    else:  # gin
        specs |= {"x": shr.P(axes, None), "labels": shr.P(axes)}
        shapes |= {"x": ((n, d_feat), torch.float32), "labels": ((n,), torch.int32)}
    b_bytes = sum(shard_bytes(shp, dt, specs[k], mesh) for k, (shp, dt) in shapes.items())
    compute = torch.bfloat16
    model = _gnn_model(cfg, d_feat, dev, generator)
    step = make_distributed_gnn_train_step(cfg, run_ring, compute_dtype=compute)
    return _gnn_train_cell(model, batch, b_bytes, step, mesh, spread=1, grad_group=n_dev,
                           scale=n_dev if per_coordinate else 1,
                           extra=_replicate_rows_gathers(cfg, n, d_feat, n_dev, compute))


def _replicate_rows_gathers(cfg, n: int, d_feat: int, n_dev: int, compute) -> list:
    """The all-gathers of ``replicate_rows`` in one partitioned train step:
    one a layer (GIN, GraphCast, MACE; DimeNet gathers no node rows), and
    again in the backward pass's recomputation of each checkpointed layer;
    each a (N, width) result in the dtype the layer's h has."""
    fam = cfg.family
    if fam == "dimenet":
        return []
    row = {"gin": lambda i: (d_feat if i == 0 else cfg.d_hidden) * 4,
           "graphcast": lambda i: cfg.d_hidden * dtype_bytes(compute),
           "mace": lambda i: sum(2 * l + 1 for l in range(cfg.l_max + 1)) * cfg.d_hidden
           * dtype_bytes(compute)}[fam]
    return [("all-gather", n * row(i), n_dev, 2) for i in range(cfg.n_layers)]


def _gnn_full_cell(arch, cfg, n, e, d_feat, mesh, *, graph_ids=False, n_graphs=1,
                   generator=None) -> Cell:
    fam = cfg.family
    dev = mesh.flat_devices[0]
    draw = partial(_tensor, device=dev, generator=generator)
    dyn = _gnn_batch(fam, cfg, n, e, d_feat, draw, n_graphs=n_graphs, graph_ids=graph_ids)
    statics = {"n_graphs": n_graphs} if graph_ids else {}
    model = _gnn_model(cfg, d_feat, dev, generator)
    step = steps.make_gnn_train_step(cfg)
    if statics:
        step = partial(_with_statics, step, statics)
    return _gnn_train_cell(model, dyn, tree_bytes(dyn, shr.gnn_batch_specs(dyn, mesh), mesh),
                           step, mesh, spread=_dp_total(mesh), grad_group=_dp_total(mesh))


def recsys_cell(arch: str, shape, mesh, *, cfg=None, generator=None) -> Cell:
    from repro_torch.models.recsys import autoint as ai

    cfg = cfg or get_config(arch)
    dev = mesh.flat_devices[0]
    model = (ai.AutoInt(cfg, device=dev) if dev.type == "meta"
             else ai.init_params(generator, cfg, device=dev))
    params = dict(model.named_parameters())
    pspecs = shr.recsys_param_specs(params, mesh)
    p_bytes = tree_bytes(params, pspecs, mesh)
    draw = partial(_tensor, device=dev, generator=generator)
    vocab = cfg.vocab_per_field  # ids are per field; the lookup adds the field's offset
    dp_total = _dp_total(mesh)

    if shape.kind == "train":
        batch = {"sparse_ids": draw((shape.batch, cfg.n_sparse), torch.int32, high=vocab),
                 "labels": draw((shape.batch,), torch.float32)}
        o_bytes = _opt_bytes(params, pspecs, mesh)
        b_bytes = tree_bytes(batch, shr.recsys_batch_specs(mesh), mesh)
        grads = tree_bytes(params, _model_only(pspecs, mesh), mesh)
        return Cell(steps.make_recsys_train_step(cfg), (model, opt.init_state(model), batch),
                    p_bytes + o_bytes + b_bytes, p_bytes + o_bytes + 4, p_bytes + o_bytes,
                    [("all-reduce", grads, dp_total, 1)], dp_total)

    if shape.kind == "serve":
        ids = draw((shape.batch, cfg.n_sparse), torch.int32, high=vocab)
        i_bytes = shard_bytes(tuple(ids.shape), torch.int32, shr.P(_dp(mesh), None), mesh)
        out = -(-shape.batch // _batch_split(shape.batch, mesh)) * 4
        return Cell(steps.make_recsys_serve_step(cfg), (model, ids), p_bytes + i_bytes, out, 0,
                    [], _batch_split(shape.batch, mesh))

    # retrieval: 1 query × 1M candidates (padded to the device count)
    ids = draw((max(shape.batch, 1), cfg.n_sparse), torch.int32, high=vocab)
    n_cand = _pad_to(shape.n_candidates, mesh.size)
    cands = draw((n_cand, cfg.embed_dim), torch.float32)
    c_bytes = shard_bytes((n_cand, cfg.embed_dim), torch.float32,
                          shr.P(tuple(mesh.axis_names), None), mesh)
    args_bytes = p_bytes + ids.numel() * 4 + c_bytes
    return Cell(steps.make_recsys_retrieval_step(cfg), (model, ids, cands), args_bytes,
                max(shape.batch, 1) * n_cand // mesh.size * 4, 0, [], mesh.size)


def draw_upper(n: int, n_pad: int, density: float, generator, device, *,
               chunk_rows: int = 4096) -> torch.Tensor:
    """(n_pad, n_pad) uint8: a strictly upper triangular 0/1 matrix whose
    first n rows and columns hold each pair with probability ``density``,
    drawn from ``generator`` on ``device`` ``chunk_rows`` rows at a time
    (a one-shot float draw of n² would take 4n² bytes)."""
    u = torch.zeros((n_pad, n_pad), dtype=torch.uint8, device=device)
    cols = torch.arange(n, device=device)
    for r0 in range(0, n, chunk_rows):
        r1 = min(n, r0 + chunk_rows)
        rows = torch.arange(r0, r1, device=device)
        hit = torch.rand((r1 - r0, n), generator=generator, device=device) < density
        u[r0:r1, :n] = hit & (cols[None, :] > rows[:, None])
    return u


def _one_stage(spec, resident, stream):
    """Stage 0 of the ring alone: its block resident, every stage's block
    streamed through it in ring order (S of the ring's S² visits)."""
    state = spec.init(resident[0])
    for t in range(stream.shape[0]):
        state = spec.process(state, stream[t], t)
    return spec.finalize(state)


def triangle_cell(arch: str, shape, mesh, *, generator=None) -> Cell:
    """The dense ring (``core.triangle_pipeline.dense_ring_spec``) over the
    mesh's coordinates flattened into one ring, as the reference's
    (``int8`` there, ``uint8`` here: K2 takes unsigned 0/1 blocks): S
    stages each holding a (rows, n_pad) row block of U, resident and
    streamed, S² K2 visits, on ``DynamicPipeline``. Off a meta mesh U is
    drawn with the shape's density (:func:`draw_upper`). On a meta mesh,
    where every visit runs its ops as Python decompositions and the
    production ring has 65,536 visits, it runs one stage's S visits
    instead, standing for all S stages. Its operations are int8's: the
    roofline charges them at the int8 peak."""
    from repro_torch.core.dynamic_pipeline import DynamicPipeline
    from repro_torch.core.triangle_pipeline import dense_ring_spec

    ring = flat_ring(mesh)
    s_stages = ring.size
    n_pad = _pad_to(shape.n_nodes, s_stages * 8)
    rows = n_pad // s_stages
    dev = ring.devices[0]
    if dev.type == "meta":
        blocks = torch.empty((s_stages, rows, n_pad), dtype=torch.uint8, device=dev)
    else:
        blocks = draw_upper(shape.n_nodes, n_pad, shape.density, generator,
                            dev).reshape(s_stages, rows, n_pad)
    spec = dense_ring_spec(rows)
    per_coordinate = dev.type == "meta"
    step = (partial(_one_stage, spec) if per_coordinate
            else partial(DynamicPipeline(ring, "stage").run, spec))
    block = rows * n_pad
    return Cell(step, (blocks, blocks), 2 * block, 8, 0,
                [("collective-permute", block, s_stages, s_stages - 1)],
                1 if per_coordinate else s_stages, s_stages if per_coordinate else 1,
                ops_dtype=blocks.dtype)


def build_cell(arch: str, shape, mesh, **kw) -> Cell:
    if arch in LM_ARCHS:
        return lm_cell(arch, shape, mesh, **kw)
    if arch in GNN_ARCHS:
        return gnn_cell(arch, shape, mesh, **kw)
    if arch == "autoint":
        return recsys_cell(arch, shape, mesh, **kw)
    if arch == "triangle":
        return triangle_cell(arch, shape, mesh, **kw)
    raise ValueError(arch)


# ===========================================================================
# counting
# ===========================================================================
_aten = torch.ops.aten
# allocations that write nothing
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.new_empty.default, _aten.new_empty_strided.default,
               _aten.empty_like.default}
# gathers: the first operand is read only where gathered (its output's bytes)
_GATHERS = {_aten.index.Tensor, _aten.index_select.default, _aten.gather.default,
            _aten.embedding.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TrafficMode(TorchDispatchMode):
    """While entered, counts ``bytes`` accessed by the ops run under it
    (inputs read and outputs written once; views, and allocations that
    write nothing, count 0; a gather reads its output's bytes of its
    first operand) and the ``peak`` of the bytes of the storages the ops
    create that are still alive (the live intermediates)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: dict = {}  # id of a tracked storage -> its weakref

    def _track(self, t: torch.Tensor, seen: set) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs or key in seen:  # tracked already, or an input's
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(_, n=n, key=key):
            self.live -= n
            del self._refs[key]

        self._refs[key] = weakref.ref(st, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        outs = out if isinstance(out, (tuple, list)) else (out,)
        ins = [t for t in _pytree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if func not in _NO_TRAFFIC:
            out_bytes = sum(_nbytes(t) for t in _pytree_leaves(outs)
                            if isinstance(t, torch.Tensor))
            read = ins[1:] if func in _GATHERS else ins
            self.bytes += sum(_nbytes(t) for t in read) + out_bytes \
                + (out_bytes if func in _GATHERS and ins else 0)
        seen = {id(t.untyped_storage()) for t in ins}
        for ret, o in zip(func._schema.returns, outs):
            if ret.alias_info is None:  # a fresh tensor, not a view or an in-place result
                for t in _pytree_leaves(o):
                    if isinstance(t, torch.Tensor):
                        self._track(t, seen)
        return out


@dataclasses.dataclass
class Counts:
    flops: int
    bytes_accessed: int
    peak_live_bytes: int
    seconds: float


def count_cell(cell: Cell) -> Counts:
    """One run of ``cell``'s step under FlopCounterMode and a
    :class:`TrafficMode`: the step's FLOPs, bytes accessed and peak live
    intermediate bytes as run (one coordinate's, when ``cell.scale`` > 1).
    A checkpointed function is recomputed whole in the backward pass, as
    the reference's ``jax.checkpoint`` recomputes it (``torch.utils.
    checkpoint`` would otherwise stop at the last tensor the backward needs,
    which depends on where a stage's loop ends)."""
    t0 = time.perf_counter()
    with checkpoint.set_checkpoint_early_stop(False), FlopCounterMode(display=False) as fc, \
            TrafficMode() as tr:
        out = cell.run()
        peak = tr.peak
    del out
    return Counts(fc.get_total_flops(), tr.bytes, peak, time.perf_counter() - t0)


# ===========================================================================
# runner
# ===========================================================================
def run_cell(arch: str, shape, *, multi_pod: bool = False, out_dir: str = "results/dryrun",
             verbose: bool = True, **kw) -> dict:
    n_dev = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n_dev)
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    t0 = time.time()
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name, "n_devices": n_dev,
           "ok": False}
    try:
        cell = build_cell(arch, shape, mesh, **kw)
        t_build = time.time()
        counts = count_cell(cell)
        t_count = time.time()
        peak = peak_ops(cell.ops_dtype)
        rl = roofline_from_counts(counts.flops * cell.scale, counts.bytes_accessed * cell.scale,
                                  collective_stats(cell.collectives), n_dev, peak)
        ana = analytic_cell(arch, shape.name)
        if ana:
            rec["analytic"] = {
                "flops": ana["flops"], "bytes": ana["bytes"],
                "compute_s": ana["flops"] / (n_dev * peak),
                "memory_s": ana["bytes"] / (n_dev * HBM_BW),
            }
        temp = counts.peak_live_bytes // (1 if cell.scale > 1 else cell.spread)
        rec.update(
            ok=True,
            build_s=round(t_build - t0, 2),
            count_s=round(t_count - t_build, 2),
            memory={
                "argument_bytes": cell.argument_bytes,
                "output_bytes": cell.output_bytes,
                "temp_bytes": temp,
                "alias_bytes": cell.alias_bytes,
                "peak_bytes_per_device": cell.argument_bytes + cell.output_bytes + temp
                - cell.alias_bytes,
            },
            roofline=rl.as_dict(),
            counted={"flops": counts.flops, "bytes_accessed": counts.bytes_accessed,
                     "peak_live_bytes": counts.peak_live_bytes, "scale": cell.scale,
                     "temp_spread": cell.spread},
        )
        if verbose:
            mem_gb = rec["memory"]["peak_bytes_per_device"] / 2**30
            print(f"[OK] {arch} × {shape.name} × {mesh_name}: "
                  f"count {rec['count_s']}s, {mem_gb:.2f} GiB/device, "
                  f"dominant={rl.dominant} "
                  f"(c={rl.compute_s:.2e}s m={rl.memory_s:.2e}s coll={rl.collective_s:.2e}s)",
                  flush=True)
    except Exception as exc:  # noqa: BLE001 — record failures, keep sweeping
        rec["error"] = f"{type(exc).__name__}: {exc}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {arch} × {shape.name} × {mesh_name}: {rec['error']}", flush=True)
    rec["wall_s"] = round(time.time() - t0, 2)
    path = os.path.join(out_dir, mesh_name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, f"{arch}__{shape.name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out-dir", default="results/dryrun")
    args = ap.parse_args()

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    archs = ARCHS if args.all or args.arch is None else [args.arch]
    fails = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes_for(arch):
                if args.shape and shape.name != args.shape:
                    continue
                rec = run_cell(arch, shape, multi_pod=mp, out_dir=args.out_dir)
                fails += 0 if rec["ok"] else 1
    if fails:
        raise SystemExit(f"{fails} cells failed")
    print("all requested cells counted")


if __name__ == "__main__":
    main()
