"""Fault-tolerant checkpointing, the port of ``repro/train/checkpoint.py``
with its on-disk contract, so checkpoints cross between the two packages:

- a step is a directory ``step_{step:012d}`` holding ``arrays.npz`` (leaf
  ``leaf_i``) and ``manifest.json`` (``{"step", "leaves": [{"key", "name",
  "shape", "dtype"}]}``), each leaf keyed by its tree path as the
  reference's ``_flatten_with_paths`` writes it (dict keys in sorted order,
  joined by ``/``: ``params/dense/attn/wq``, ``opt/step``);
- writes are atomic: a ``.tmp_step_N`` directory published by
  ``os.replace``, so a crash mid-save never shows as a step;
- the ``max_to_keep`` newest steps are kept;
- saving is asynchronous: the caller copies every leaf to the host (so a
  train step may update its tensors in place right after), and one writer
  thread (``utils.PropagatingThread``) serializes; ``wait()`` joins it and
  re-raises its failure.

numpy has no bfloat16 without ``ml_dtypes``, which the port does not
need: a bf16 leaf is stored as its uint16 bit pattern with ``"bfloat16"``
in the manifest, and a ``"bfloat16"`` leaf the reference wrote is read as
the same bits. ``restore(step, like, device=)`` places every leaf on
``like``'s device (or ``device``) in ``like``'s dtype.

Elastic restore: leaves are stored as global arrays, so a checkpoint
restores onto any mesh. ``save`` takes leaves placed on a mesh
(``launch.sharding.place``) and writes each gathered, as the reference
writes global arrays; ``restore(step, like, shardings=)`` places each leaf
per its ``NamedSharding`` (saved from 8 coordinates, restored onto 4), and a
placed like leaf without one is placed as it was.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.launch.sharding import Placed, gather, place
from repro_torch.utils import PropagatingThread, tree_map

_BF16 = "bfloat16"


def _flatten_with_paths(tree: Any, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """(key, leaf) of every leaf, in the reference's flattening order (dict
    keys sorted, sequences by index); the key joins the path with ``/``."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten_with_paths(tree[k], (*prefix, k))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten_with_paths(v, (*prefix, i))]
    return [("/".join(str(p) for p in prefix), tree)]


def _to_host(x: Any) -> Any:
    """A host copy of one leaf that later in-place updates cannot reach: a
    CPU tensor for a tensor or a placed tensor (gathered), a numpy array
    otherwise."""
    if isinstance(x, Placed):
        return gather(x, "cpu")
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def _encode(leaf: Any) -> tuple[np.ndarray, str]:
    """(the array stored, the manifest's dtype) of one host leaf."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), _BF16
        leaf = leaf.numpy()
    return leaf, str(leaf.dtype)


def _decode(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.array(arr)  # a writable C-ordered copy (0-d stays 0-d)
    if dtype == _BF16:  # uint16 bits, or ml_dtypes' bfloat16 where the writer had it
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)
        self._thread: PropagatingThread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Write ``tree`` (tensors on any device, numpy arrays or numbers)
        as step ``step``. The host copies are taken before this returns; the
        write runs on the writer thread unless ``blocking``."""
        host_tree = tree_map(_to_host, tree)
        self.wait()  # one outstanding async save at a time
        self._thread = PropagatingThread(target=self._write, args=(step, host_tree))
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Join the outstanding async save. A write failure surfaces here
        (``PropagatingThread`` re-raises it) instead of dying silently on
        the writer thread and leaving a stale "latest" checkpoint."""
        if self._thread is not None:
            thread, self._thread = self._thread, None
            thread.join()

    def _write(self, step: int, host_tree: Any) -> None:
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step:012d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        arrays = {}
        for i, (key, leaf) in enumerate(_flatten_with_paths(host_tree)):
            name = f"leaf_{i}"
            arrays[name], dtype = _encode(leaf)
            manifest["leaves"].append({"key": key, "name": name,
                                       "shape": list(arrays[name].shape), "dtype": dtype})
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:012d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, *, device=None, shardings: Any = None) -> Any:
        """Step ``step`` in the structure of ``like``: each leaf a tensor of
        the like leaf's dtype on ``device`` (default: the like leaf's
        device); a numpy like leaf gives a numpy array of its dtype.
        ``shardings`` (a tree shaped as ``like`` of ``NamedSharding`` or
        None) places a leaf on its mesh instead; a placed like leaf
        (``launch.sharding.Placed``) without one keeps its own sharding.
        Raises ``KeyError`` on a leaf the checkpoint lacks and
        ``ValueError`` on a shape that differs, a shardings tree of another
        structure or a split that does not divide."""
        path = os.path.join(self.dir, f"step_{step:012d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
        like_leaves = _flatten_with_paths(like)
        where = {}
        if shardings is not None:
            where = dict(_flatten_with_paths(shardings))
            if sorted(where) != sorted(key for key, _ in like_leaves):
                raise ValueError("the shardings tree does not have the structure of like")
        restored = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key, like_leaf in like_leaves:
                if key not in by_key:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                meta = by_key[key]
                arr = _decode(data[meta["name"]], meta["dtype"])
                shape = tuple(like_leaf.shape) if hasattr(like_leaf, "shape") else \
                    tuple(np.shape(like_leaf))
                if tuple(arr.shape) != shape:
                    raise ValueError(f"shape mismatch for {key}: {tuple(arr.shape)} vs {shape}")
                sharding = where.get(key) or (like_leaf.sharding if isinstance(like_leaf, Placed)
                                              else None)
                if isinstance(like_leaf, (torch.Tensor, Placed)):
                    leaf = arr.to(like_leaf.dtype)
                else:
                    host = arr.float() if arr.dtype == torch.bfloat16 else arr
                    leaf = host.numpy().astype(np.asarray(like_leaf).dtype)
                if sharding is not None:
                    leaf = place(leaf, sharding)
                elif isinstance(like_leaf, torch.Tensor):
                    leaf = leaf.to(device or like_leaf.device)
                restored[key] = leaf
        return _rebuild(like, restored)


def _rebuild(tree: Any, leaves: dict, prefix: tuple = ()) -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[its key]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, (*prefix, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, leaves, (*prefix, i)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    return leaves["/".join(str(p) for p in prefix)]
