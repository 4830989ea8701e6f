"""Sharding rules, the port of ``repro/launch/sharding.py``: a
:class:`PartitionSpec` tree per architecture family, and the placement of a
tensor's shards on a :class:`~repro_torch.launch.mesh.Mesh`.

Mesh axes: ``("pod", "data", "model")`` across pods, ``("data", "model")``
in one. ``dp`` below = every batch axis (pod and data). The LM layout is
FSDP + TP + EP, as the reference's:

- tensor parallel over ``"model"`` (attention heads, FFN columns, experts,
  vocab), FSDP over the data axes on the non-TP weight dim; AdamW's moments
  take the parameters' specs;
- activations: batch over dp; KV caches shard their sequence dim over
  ``"model"``;
- recsys tables row-shard the vocab over ``"model"``;
- GNN node and edge arrays shard over the flattened mesh.

Spec trees follow the reference's tree layouts leaf for leaf: an LM's is the
tree ``convert.lm_params_to_tree`` gives (stacked ``dense`` / ``moe_stack``
layers), built from any tree whose leaves have a ``shape`` (meta tensors
from ``convert.lm_param_shapes``, numpy arrays, host tensors).

In this single-controller port a spec is a layout, not a hint to a
compiler: :func:`place` puts each coordinate's block of a tensor on that
coordinate's device (coordinates that only replicate share one copy per
device) and :func:`gather` reassembles the global tensor. A dim that does
not divide over its axes raises ``ValueError``, where the reference's
``device_put`` refuses too. :meth:`NamedSharding.check` with ``even=False``
is the check a sharding constraint gets (``with_sharding_constraint``
accepts a dim that does not divide, and pads).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.launch.mesh import data_parallel_axes as dp_axes


class PartitionSpec:
    """One entry per leading dim of an array: ``None`` (not split), an axis
    name, or a tuple of axis names (split over their product, major first;
    a tuple of one name is that name).
    Iterates, indexes and compares like the reference's ``PartitionSpec``
    (and equals the tuple of its entries); not a tuple itself, so trees of
    specs keep each spec as one leaf."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        out = []
        for part in parts:
            if isinstance(part, (list, tuple)):
                if not all(isinstance(a, str) for a in part):
                    raise ValueError(f"a spec entry names axes by string, got {part!r}")
                # as the reference normalizes them: one name is that name, none is None
                part = tuple(part) if len(part) > 1 else part[0] if part else None
            elif part is not None and not isinstance(part, str):
                raise ValueError(f"a spec entry is None, an axis name or a tuple of them, "
                                 f"got {part!r}")
            out.append(part)
        self._parts = tuple(out)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._parts == other._parts
        return isinstance(other, tuple) and self._parts == other

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._parts!r}" if len(self._parts) != 1 else \
            f"PartitionSpec({self._parts[0]!r})"


P = PartitionSpec


def _axes(part) -> tuple:
    return () if part is None else (part,) if isinstance(part, str) else tuple(part)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` on a mesh. Raises ``ValueError`` when the
    spec names an axis the mesh lacks, or one axis twice."""

    mesh: Any
    spec: PartitionSpec

    def __post_init__(self):
        if not isinstance(self.spec, PartitionSpec):
            object.__setattr__(self, "spec", PartitionSpec(*self.spec))
        used = [a for part in self.spec for a in _axes(part)]
        missing = [a for a in used if a not in self.mesh.axis_names]
        if missing:
            raise ValueError(f"{self.spec} names axes {missing} not in the mesh "
                             f"{self.mesh.axis_names}")
        if len(set(used)) != len(used):
            raise ValueError(f"{self.spec} maps one mesh axis to more than one dim")

    def splits(self, i: int) -> int:
        """How many blocks dim ``i`` is split into (1 past the spec's end)."""
        return math.prod(self.mesh.shape[a] for a in _axes(self.spec[i])) \
            if i < len(self.spec) else 1

    def check(self, shape, *, even: bool = True) -> None:
        """Raises ``ValueError`` when the spec has more entries than
        ``shape`` has dims, or (``even``) a split dim does not divide over
        its axes."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has {len(self.spec)} entries for an array of "
                             f"shape {shape}")
        if even:
            for i, n in enumerate(shape):
                if n % self.splits(i):
                    raise ValueError(f"{self.spec} splits dim {i} of {shape} into "
                                     f"{self.splits(i)} blocks: {n} does not divide")

    def shard_shape(self, shape) -> tuple:
        self.check(shape)
        return tuple(n // self.splits(i) for i, n in enumerate(shape))

    def block(self, coord: tuple, shape) -> tuple:
        """The slices of the global array that coordinate ``coord`` (an
        index per mesh axis) holds."""
        at = dict(zip(self.mesh.axis_names, coord))
        out = []
        for i, n in enumerate(shape):
            j = 0
            for a in (_axes(self.spec[i]) if i < len(self.spec) else ()):
                j = j * self.mesh.shape[a] + at[a]
            size = n // self.splits(i)
            out.append(slice(j * size, (j + 1) * size))
        return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class Placed:
    """A global tensor laid out by ``sharding``: ``shards[c]`` is coordinate
    c's block on ``mesh.devices[c]`` (a numpy object array in mesh shape).
    Coordinates on one device that hold the same block share one tensor."""

    sharding: NamedSharding
    shape: tuple
    dtype: torch.dtype
    shards: np.ndarray


def place(tensor, sharding: NamedSharding) -> Placed:
    """``tensor`` (a tensor or an array) split per ``sharding``: each
    coordinate's block copied to its device. Raises ``ValueError`` when a
    split dim does not divide over its axes."""
    t = torch.as_tensor(tensor)
    shape = tuple(t.shape)
    sharding.check(shape)
    mesh = sharding.mesh
    devs = mesh.devices
    shards = np.empty(devs.shape, dtype=object)
    copies: dict = {}
    for coord in np.ndindex(devs.shape):
        blk = sharding.block(coord, shape)
        key = (devs[coord], tuple((s.start, s.stop) for s in blk))
        if key not in copies:
            copies[key] = t[blk].to(device=devs[coord], copy=True,
                                    memory_format=torch.contiguous_format)
        shards[coord] = copies[key]
    return Placed(sharding, shape, t.dtype, shards)


def gather(placed: Placed, device=None) -> torch.Tensor:
    """The global tensor of ``placed`` on ``device`` (default: the first
    coordinate's device), :func:`place`'s inverse."""
    first = placed.shards.flat[0]
    out = torch.empty(placed.shape, dtype=placed.dtype,
                      device=first.device if device is None else device)
    done = set()
    for coord in np.ndindex(placed.shards.shape):
        blk = placed.sharding.block(coord, placed.shape)
        key = tuple((s.start, s.stop) for s in blk)
        if key not in done:
            out[blk] = placed.shards[coord]
            done.add(key)
    return out


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------
def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; the path
    holds dict keys and sequence indices as strings, as the reference's
    ``tree_map_with_path`` keys read."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, (*path, str(i))) for i, v in enumerate(tree))
    return fn(path, tree)


def spec_leaves(tree) -> list:
    """(path, spec) of every :class:`PartitionSpec` in a spec tree (or of
    every :class:`NamedSharding` in a sharding tree), paths joined by
    ``/``, in the tree's order."""
    out = []
    _map_with_path(lambda path, leaf: out.append(("/".join(path), leaf)), tree)
    return out


def _dp(mesh):
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def _dp_total(mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def _lm_trailing_spec(name: str, ndim: int, dp) -> tuple:
    """Spec for the trailing (per-layer) dims of an LM weight by name."""
    mdl = "model"
    table = {
        "embed": (mdl, dp), "unembed": (dp, mdl),
        "final_norm": (None,), "ln1": (None,), "ln2": (None,),
        "q_norm": (None,), "kv_norm": (None,),
        "wq": (dp, mdl), "w_q": (dp, mdl), "wk": (dp, mdl), "wv": (dp, mdl),
        "wo": (mdl, dp),
        "w_dq": (dp, None), "w_uq": (None, mdl), "w_dkv": (dp, None), "w_kr": (dp, None),
        "w_uk": (None, mdl), "w_uv": (None, mdl),
        "router": (dp, None), "eps": (),
    }
    if name in table:
        return table[name]
    if name in ("w_gate", "w_up", "w_in"):
        return (mdl, dp, None) if ndim >= 3 else (dp, mdl)  # expert (E, D, F) vs dense (D, F)
    if name in ("w_down", "w_out"):
        return (mdl, None, dp) if ndim >= 3 else (mdl, dp)
    return tuple([None] * ndim)


def lm_param_specs(shapes: Any, mesh) -> Any:
    """The spec tree of an LM's parameter tree (the layout of
    ``convert.lm_params_to_tree``; ``convert.lm_param_shapes`` gives it
    for a model without copying)."""
    dp = _dp(mesh)

    def spec_of(path, leaf):
        stacked = any(k in ("dense", "moe_stack") for k in path)
        trailing_ndim = len(leaf.shape) - (1 if stacked else 0)
        trailing = _lm_trailing_spec(path[-1], trailing_ndim, dp)
        trailing = tuple(trailing[:trailing_ndim]) if trailing else ()
        return P(*(((None,) if stacked else ()) + trailing))

    return _map_with_path(spec_of, shapes)


def lm_batch_specs(mesh) -> dict:
    dp = dp_axes(mesh)
    return {"tokens": P(dp, None), "labels": P(dp, None)}


def lm_cache_specs(shapes: Any, mesh) -> Any:
    """A KV cache's specs: batch over dp where it divides, the sequence dim
    over ``"model"``. GQA leaves are (L, B, Hk, S, hd), MLA's (L, B, S, r)."""
    dp, dp_total = _dp(mesh), _dp_total(mesh)

    def spec_of(path, leaf):
        shape = tuple(leaf.shape)
        bspec = dp if shape[1] % dp_total == 0 else None
        if len(shape) == 5:
            return P(None, bspec, None, "model", None)
        if len(shape) == 4:
            return P(None, bspec, "model", None)
        return P(*([None] * len(shape)))

    return _map_with_path(spec_of, shapes)


def opt_state_specs(param_specs: Any) -> dict:
    return {"m": param_specs, "v": param_specs, "step": P()}


def gnn_batch_specs(batch_shapes: dict, mesh) -> dict:
    """Node arrays shard over dp, edge and triplet arrays over the whole
    flattened mesh; a leading dim that does not divide stays replicated."""
    all_ax = tuple(mesh.axis_names)
    dp, dp_total, all_total = _dp(mesh), _dp_total(mesh), mesh.size

    def over(axes, total, shape):
        return P(*(((axes if shape[0] % total == 0 else None),) + (None,) * (len(shape) - 1)))

    out = {}
    for k, v in batch_shapes.items():
        if k in ("edges", "triplets"):
            out[k] = P(all_ax if v.shape[0] % all_total == 0 else None, None)
        elif k in ("x", "pos", "z", "target", "labels", "graph_ids"):
            out[k] = over(dp, dp_total, tuple(v.shape))
        elif k == "blocks":
            out[k] = _map_with_path(lambda _, s: over(all_ax, all_total, tuple(s.shape)), v)
        else:
            out[k] = P()
    return out


def gnn_param_specs(shapes: Any, mesh) -> Any:
    """GNN weights stay replicated, but the widest MLPs' (both dims at
    least 256), which shard their column dim over ``"model"``."""
    def spec_of(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 2 and shape[0] >= 256 and shape[1] >= 256:
            return P(None, "model")
        return P(*([None] * len(shape)))

    return _map_with_path(spec_of, shapes)


def recsys_param_specs(shapes: Any, mesh) -> Any:
    def spec_of(path, leaf):
        if path[-1] == "table":
            return P("model", None)  # row-sharded vocab
        return P(*([None] * len(leaf.shape)))

    return _map_with_path(spec_of, shapes)


def recsys_batch_specs(mesh) -> dict:
    dp = _dp(mesh)
    return {"sparse_ids": P(dp, None), "labels": P(dp)}


def shardings_from_specs(mesh, specs: Any) -> Any:
    return _map_with_path(lambda _, s: NamedSharding(mesh, s), specs)


def check_specs(specs: Any, shapes: Any, mesh, *, even: bool = False) -> None:
    """Raises ``ValueError`` unless ``specs`` has the structure of
    ``shapes`` (the same keys and paths) and every spec fits its leaf on
    ``mesh`` (:meth:`NamedSharding.check`)."""
    want = [path for path, _ in spec_leaves(shapes)]
    got = spec_leaves(specs)
    if [path for path, _ in got] != want:
        missing = sorted(set(want) - {p for p, _ in got})
        extra = sorted({p for p, _ in got} - set(want))
        raise ValueError(f"the spec tree does not match the parameters: missing {missing[:4]}, "
                         f"extra {extra[:4]}")
    for (path, spec), (_, leaf) in zip(got, spec_leaves(shapes)):
        if not isinstance(spec, PartitionSpec):
            raise ValueError(f"{path}: {spec!r} is not a PartitionSpec")
        try:
            NamedSharding(mesh, spec).check(tuple(leaf.shape), even=even)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
