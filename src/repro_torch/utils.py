"""Small shared utilities: the count dtype, device resolution, the
serving tier's exception-propagating thread, and a map over trees of
tensors (nested dicts, lists and tuples: the reference's pytrees)."""
from __future__ import annotations

import threading
from typing import Any, Callable

import torch


def count_dtype() -> torch.dtype:
    """Integer dtype of every triangle count: always int64.

    Full-size FNA.5 and FNA.9 are complete graphs with ~1.5e10 and ~6.2e9
    triangles, past 2³¹, so the port never counts in int32."""
    return torch.int64


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when a CUDA device is asked for (explicitly or by
    default) and none is present — never a quiet fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev


class PropagatingThread(threading.Thread):
    """``threading.Thread`` that re-raises the target's exception on
    ``join()`` instead of letting it die with the thread, so a failed
    producer in the serving tier is never a silent no-op (repro-lint R5
    requires this class for every thread under ``serve/``)."""

    def run(self):
        self._exc = None
        try:
            super().run()
        except BaseException as e:  # re-raised on join — nothing is lost
            self._exc = e

    def join(self, timeout=None):
        super().join(timeout)
        exc, self._exc = getattr(self, "_exc", None), None
        if exc is not None:
            raise exc


def records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a graph through an op on ``tensors``: grad
    mode is on and one of them requires grad. Where it does not, a function
    may work in place (autograd's version check refuses in-place writes to
    tensors a graph saved, and ``out=`` outright)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``,
    which share its structure. Dicts, lists and tuples are nodes (a dict's
    keys are taken from ``tree``); anything else — a tensor, an array, a
    number, None — is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out
