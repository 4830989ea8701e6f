"""Small shared utilities: the count dtype, device resolution and the
serving tier's exception-propagating thread."""
from __future__ import annotations

import threading

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
