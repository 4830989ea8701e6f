"""Architecture registry of the port: one module per architecture it runs.

``get_config(arch)`` returns the full published config, ``get_smoke(arch)``
the reduced same-family config of the CPU tests, as in the reference.
Shapes live in ``repro_torch.configs.shapes``. ``triangle`` is the paper's
own workload (``TriangleConfig``), last as in the reference's list; the
dry run (``launch.dryrun``) sweeps every name here. An unknown name raises
``KeyError``.
"""
from __future__ import annotations

import importlib

ARCHS = ["granite_8b", "nemotron_4_15b", "yi_6b", "deepseek_v2_lite_16b", "deepseek_v2_236b",
         "mace", "dimenet", "graphcast", "gin_tu", "autoint",
         # the paper's own workload
         "triangle"]


def _mod(arch: str):
    name = arch.replace("-", "_")
    if name not in ARCHS:
        raise KeyError(f"architecture {arch!r} is not in the port (the port has {ARCHS})")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _mod(arch).CONFIG


def get_smoke(arch: str):
    return _mod(arch).smoke_config()
