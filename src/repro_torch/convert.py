"""Carry data, plans and weights across from the reference package.

The counting paths' "weights" are the graph and the plan. A reference
``Graph`` crosses as its numpy arrays (:func:`graph_from_arrays`); a
reference ``Plan`` crosses as its dict, since the port's
:class:`~repro_torch.api.planner.Plan` has the same fields
(``Plan.from_dict(ref_plan.to_dict())``, and back the same way). The
models' weights cross as the reference's parameter pytree with numpy
leaves (``jax.tree.map(np.asarray, params)``): :func:`lm_params_from_numpy`
and :func:`recsys_params_from_numpy`."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.formats import Graph


def graph_from_arrays(n_nodes: int, edges) -> Graph:
    """The port's ``Graph`` from a reference graph's arrays: ``edges`` is
    the (m, 2) canonical edge list (u < v, unique rows), copied as int32.
    Raises on a wrong shape or an id outside [0, n_nodes)."""
    e = np.array(edges, dtype=np.int64).reshape(-1, 2)
    if e.size and (e.min() < 0 or e.max() >= n_nodes):
        raise ValueError(f"edge ids must lie in [0, {n_nodes})")
    return Graph(edges=e.astype(np.int32), n_nodes=int(n_nodes))


def _put(param: torch.Tensor, leaf, where: str, layer: int | None = None) -> None:
    """Copy one numpy leaf (or its ``layer``-th slice) into ``param``,
    keeping the parameter's dtype; raises on a missing or misshaped leaf."""
    if leaf is None:
        raise KeyError(f"the parameter tree has no leaf {where}")
    a = np.asarray(leaf)
    if layer is not None:
        a = a[layer]
    if tuple(a.shape) != tuple(param.shape):
        raise ValueError(f"leaf {where}: shape {a.shape}, the port's parameter has "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))


def _get(tree: dict, *path):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            return None
        tree = tree[key]
    return tree


def lm_params_from_numpy(tree: dict, cfg, *, device=None):
    """The port's float32 :class:`~repro_torch.models.transformer.Transformer` from
    the reference's LM pytree (numpy leaves): the leading layer axis of the
    ``dense`` stack (the first ``n_dense_layers`` layers) and of the
    ``moe_stack`` (the rest) is unstacked into the ``ModuleList``, leaf for
    leaf (stacked expert weights keep their expert axis), weights keep their
    (in, out) orientation, norm scales and the router stay float32. Raises
    ``KeyError`` on a missing leaf and ``ValueError`` on a misshaped one."""
    from repro_torch.models.transformer import Transformer, _n_dense

    model = Transformer(cfg, device=device)
    n_dense = _n_dense(cfg)
    for stack, n in (("dense", n_dense), ("moe_stack", cfg.n_layers - n_dense)):
        if (ln := _get(tree, stack, "ln1")) is not None and len(ln) != n:
            raise ValueError(f"the {stack} stack holds {len(ln)} layers, the config {n}")
    for name in ("embed", "final_norm", "unembed"):
        _put(getattr(model, name), _get(tree, name), name)
    for i, blk in enumerate(model.layers):
        stack, j = ("dense", i) if i < n_dense else ("moe_stack", i - n_dense)
        for name, param in blk.named_parameters():
            _put(param, _get(tree, stack, *name.split(".")), f"{stack}.{name}", layer=j)
    return model


def recsys_params_from_numpy(tree: dict, cfg, *, device=None):
    """The port's float32 :class:`~repro_torch.models.recsys.autoint.AutoInt` from
    the reference's AutoInt pytree (numpy leaves): ``table``, the ``attn``
    list, ``head`` and ``cand_proj``. Raises as :func:`lm_params_from_numpy`."""
    from repro_torch.models.recsys.autoint import AutoInt

    model = AutoInt(cfg, device=device)
    if len(tree.get("attn", ())) != cfg.n_attn_layers:
        raise ValueError(f"the tree holds {len(tree.get('attn', ()))} attention layers, "
                         f"the config {cfg.n_attn_layers}")
    for name, param in model.named_parameters():
        path = name.split(".")
        if path[0] == "attn":
            leaf = _get(tree["attn"][int(path[1])], path[2])
        else:
            leaf = _get(tree, *path)
        _put(param, leaf, name)
    return model
