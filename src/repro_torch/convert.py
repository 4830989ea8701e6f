"""Carry data, plans and weights across from the reference package.

The counting paths' "weights" are the graph and the plan. A reference
``Graph`` crosses as its numpy arrays (:func:`graph_from_arrays`); a
reference ``Plan`` crosses as its dict, since the port's
:class:`~repro_torch.api.planner.Plan` has the same fields
(``Plan.from_dict(ref_plan.to_dict())``, and back the same way). The
models' weights cross as the reference's parameter pytree with numpy
leaves (``jax.tree.map(np.asarray, params)``): :func:`lm_params_from_numpy`,
:func:`recsys_params_from_numpy` and :func:`gnn_params_from_numpy`, and
back by :func:`lm_params_to_numpy`, :func:`recsys_params_to_numpy` and
:func:`gnn_params_to_numpy`, which also take a model's gradients or
an optimizer's moments (a mapping of parameter names to tensors), so
gradients, moments and checkpoints compare leaf by leaf. The ``*_to_tree``
forms keep torch tensors (bf16 included) for checkpoints, and
``*_into_`` loads a tree into an existing model or moments in place."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.graphs.formats import Graph
from repro_torch.utils import tree_map


def graph_from_arrays(n_nodes: int, edges) -> Graph:
    """The port's ``Graph`` from a reference graph's arrays: ``edges`` is
    the (m, 2) canonical edge list (u < v, unique rows), copied as int32.
    Raises on a wrong shape or an id outside [0, n_nodes)."""
    e = np.array(edges, dtype=np.int64).reshape(-1, 2)
    if e.size and (e.min() < 0 or e.max() >= n_nodes):
        raise ValueError(f"edge ids must lie in [0, {n_nodes})")
    return Graph(edges=e.astype(np.int32), n_nodes=int(n_nodes))


def _put(param: torch.Tensor, leaf, where: str, layer: int | None = None) -> None:
    """Copy one leaf — a numpy array or a tensor — (or its ``layer``-th
    slice) into ``param``, keeping the parameter's dtype and device; raises
    on a missing or misshaped leaf."""
    if leaf is None:
        raise KeyError(f"the parameter tree has no leaf {where}")
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.from_numpy(np.array(leaf, dtype=np.float32))
    if layer is not None:
        leaf = leaf[layer]
    if tuple(leaf.shape) != tuple(param.shape):
        raise ValueError(f"leaf {where}: shape {tuple(leaf.shape)}, the port's parameter has "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(leaf)


def _get(tree: dict, *path):
    for key in path:
        if isinstance(tree, (list, tuple)) and isinstance(key, int) and key < len(tree):
            tree = tree[key]
        elif isinstance(tree, dict) and key in tree:
            tree = tree[key]
        else:
            return None
    return tree


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _named(params) -> dict:
    """A model's parameters by name, or a mapping of such names to tensors
    (a model's gradients, an optimizer's moments) as it is."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``; a meta tensor (a shape) stays meta."""
    if t is None:
        raise ValueError("a parameter has no tensor (a gradient never computed?)")
    if t.is_meta:
        return t.detach()
    return t.detach().to("cpu", copy=True)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bf16, which numpy lacks, widened (exactly) to f32."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _lm_place(cfg, name: str) -> tuple[tuple, int | None]:
    """A port parameter name → (its path in the reference's LM tree, its
    index on the stack's leading layer axis, or None off the stacks)."""
    from repro_torch.models.transformer import _n_dense

    parts = name.split(".")
    if parts[0] != "layers":
        return tuple(parts), None
    i, n_dense = int(parts[1]), _n_dense(cfg)
    stack, j = ("dense", i) if i < n_dense else ("moe_stack", i - n_dense)
    return (stack, *parts[2:]), j


def lm_params_into_(params, tree: dict, cfg) -> None:
    """Copy the reference's LM tree (numpy or tensor leaves, the ``dense``
    and ``moe_stack`` stacks with their leading layer axis) into ``params``
    — a :class:`~repro_torch.models.transformer.Transformer` or a mapping
    of its parameter names to tensors — in place, each tensor keeping its
    dtype and device. Raises ``KeyError`` on a missing leaf and
    ``ValueError`` on a misshaped one or a stack of the wrong depth."""
    from repro_torch.models.transformer import _n_dense

    n_dense = _n_dense(cfg)
    for stack, n in (("dense", n_dense), ("moe_stack", cfg.n_layers - n_dense)):
        if (ln := _get(tree, stack, "ln1")) is not None and len(ln) != n:
            raise ValueError(f"the {stack} stack holds {len(ln)} layers, the config {n}")
    for name, t in _named(params).items():
        path, j = _lm_place(cfg, name)
        _put(t, _get(tree, *path), ".".join(path), layer=j)


def lm_params_from_numpy(tree: dict, cfg, *, device=None):
    """The port's float32 :class:`~repro_torch.models.transformer.Transformer` from
    the reference's LM pytree (numpy leaves): the leading layer axis of the
    ``dense`` stack (the first ``n_dense_layers`` layers) and of the
    ``moe_stack`` (the rest) is unstacked into the ``ModuleList``, leaf for
    leaf (stacked expert weights keep their expert axis), weights keep their
    (in, out) orientation, norm scales and the router stay float32. Raises
    ``KeyError`` on a missing leaf and ``ValueError`` on a misshaped one."""
    from repro_torch.models.transformer import Transformer

    model = Transformer(cfg, device=device)
    lm_params_into_(model, tree, cfg)
    return model


def lm_params_to_tree(params, cfg) -> dict:
    """The inverse of :func:`lm_params_into_`: ``params`` (a
    :class:`~repro_torch.models.transformer.Transformer`, or a mapping of its
    parameter names to tensors — its gradients, an optimizer's moments) as
    the reference's LM tree of host tensors, each layer's leaves stacked on
    the ``dense`` or ``moe_stack`` layer axis, dtypes kept."""
    tree, stacks = {}, {}
    for name, t in _named(params).items():
        path, j = _lm_place(cfg, name)
        if j is None:
            _set(tree, path, _host(t))
        else:
            stacks.setdefault(path, {})[j] = t
    for path, layers in stacks.items():
        _set(tree, path, torch.stack([_host(layers[j]) for j in range(len(layers))]))
    return tree


def lm_param_shapes(params, cfg) -> dict:
    """:func:`lm_params_to_tree`'s layout with meta tensors for leaves:
    each leaf's shape and dtype, nothing copied (what the spec builders of
    ``launch.sharding`` read). ``params`` may be a model built on
    ``device="meta"``."""
    return lm_params_to_tree({name: torch.empty_like(t, device="meta")
                              for name, t in _named(params).items()}, cfg)


def lm_params_to_numpy(params, cfg) -> dict:
    """:func:`lm_params_to_tree` with numpy leaves: the reference's LM
    pytree (``jax.tree.map(np.asarray, params)``'s layout). bf16 leaves are
    widened to float32, exactly."""
    return tree_map(_numpy, lm_params_to_tree(params, cfg))


def _recsys_path(name: str) -> tuple:
    parts = name.split(".")
    return ("attn", int(parts[1]), parts[2]) if parts[0] == "attn" else tuple(parts)


def recsys_params_into_(params, tree: dict, cfg) -> None:
    """Copy the reference's AutoInt tree (``table``, the ``attn`` list,
    ``head`` and ``cand_proj``) into ``params`` (an
    :class:`~repro_torch.models.recsys.autoint.AutoInt` or a mapping of its
    parameter names to tensors), in place. Raises as :func:`lm_params_into_`."""
    if len(tree.get("attn", ())) != cfg.n_attn_layers:
        raise ValueError(f"the tree holds {len(tree.get('attn', ()))} attention layers, "
                         f"the config {cfg.n_attn_layers}")
    for name, t in _named(params).items():
        _put(t, _get(tree, *_recsys_path(name)), name)


def recsys_params_from_numpy(tree: dict, cfg, *, device=None):
    """The port's float32 :class:`~repro_torch.models.recsys.autoint.AutoInt` from
    the reference's AutoInt pytree (numpy leaves): ``table``, the ``attn``
    list, ``head`` and ``cand_proj``. Raises as :func:`lm_params_from_numpy`."""
    from repro_torch.models.recsys.autoint import AutoInt

    model = AutoInt(cfg, device=device)
    recsys_params_into_(model, tree, cfg)
    return model


def recsys_params_to_tree(params, cfg) -> dict:
    """The inverse of :func:`recsys_params_into_`: ``params`` (an AutoInt,
    or a mapping of its parameter names to tensors) as the reference's
    AutoInt tree of host tensors, ``attn`` a list of per-layer dicts."""
    tree = {"attn": [{} for _ in range(cfg.n_attn_layers)]}
    for name, t in _named(params).items():
        path = _recsys_path(name)
        if path[0] == "attn":
            tree["attn"][path[1]][path[2]] = _host(t)
        else:
            _set(tree, path, _host(t))
    return tree


def recsys_params_to_numpy(params, cfg) -> dict:
    """:func:`recsys_params_to_tree` with numpy leaves (bf16 widened to f32)."""
    return tree_map(_numpy, recsys_params_to_tree(params, cfg))


def _gnn_stack(cfg) -> str:
    """The name of the family's per-layer list: DimeNet's ``blocks``, the
    others' ``layers``."""
    return "blocks" if cfg.family == "dimenet" else "layers"


def _gnn_path(name: str) -> tuple:
    """A port parameter name → its path in the reference's GNN tree: the
    index into ``layers`` / ``blocks`` an int, every other key a string
    (MACE's mixings are keyed by ``str(l)``)."""
    parts = name.split(".")
    return (parts[0], int(parts[1]), *parts[2:]) if parts[0] in ("layers", "blocks") else \
        tuple(parts)


def gnn_params_into_(params, tree: dict, cfg) -> None:
    """Copy the reference's GNN tree of ``cfg.family`` (GIN, GraphCast,
    DimeNet or MACE; numpy or tensor leaves) into ``params`` — the model,
    or a mapping of its parameter names to tensors — in place. Raises
    ``KeyError`` on a missing leaf and ``ValueError`` on a misshaped one or
    a layer list of the wrong length."""
    stack = _gnn_stack(cfg)
    if len(tree.get(stack, ())) != cfg.n_layers:
        raise ValueError(f"the tree holds {len(tree.get(stack, ()))} {stack}, the config "
                         f"{cfg.n_layers}")
    for name, t in _named(params).items():
        _put(t, _get(tree, *_gnn_path(name)), name)


def gnn_params_from_numpy(tree: dict, cfg, *, device=None):
    """The port's GNN model of ``cfg.family`` from the reference's pytree
    (numpy leaves). The input width (GIN, GraphCast) and the species count
    (DimeNet, MACE) are read from the tree. Raises as
    :func:`gnn_params_into_`."""
    from repro_torch.models.gnn import dimenet, gin, graphcast, mace

    fam = cfg.family
    if fam == "gin":
        model = gin.GIN(cfg, _shape_of(tree, "layers", 0, "mlp", "w0")[0], device=device)
    elif fam == "graphcast":
        model = graphcast.GraphCast(cfg, _shape_of(tree, "encoder", "w0")[0], device=device)
    elif fam in ("dimenet", "mace"):
        cls = dimenet.DimeNet if fam == "dimenet" else mace.MACE
        model = cls(cfg, _shape_of(tree, "species")[0], device=device)
    else:
        raise ValueError(f"unknown GNN family {fam!r}")
    gnn_params_into_(model, tree, cfg)
    return model


def _shape_of(tree: dict, *path) -> tuple:
    leaf = _get(tree, *path)
    if leaf is None:
        raise KeyError(f"the parameter tree has no leaf {'.'.join(map(str, path))}")
    return tuple(leaf.shape)


def gnn_params_to_tree(params, cfg) -> dict:
    """The inverse of :func:`gnn_params_into_`: ``params`` (a GNN model, or a
    mapping of its parameter names to tensors: its gradients, an
    optimizer's moments) as the reference's tree of host tensors, the
    ``layers`` / ``blocks`` a list of per-layer dicts."""
    stack = _gnn_stack(cfg)
    tree = {stack: [{} for _ in range(cfg.n_layers)]}
    for name, t in _named(params).items():
        path = _gnn_path(name)
        if path[0] == stack:
            _set(tree[stack][path[1]], path[2:], _host(t))
        else:
            _set(tree, path, _host(t))
    return tree


def gnn_params_to_numpy(params, cfg) -> dict:
    """:func:`gnn_params_to_tree` with numpy leaves."""
    return tree_map(_numpy, gnn_params_to_tree(params, cfg))
