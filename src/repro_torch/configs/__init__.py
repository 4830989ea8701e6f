"""Architecture registry of the port: one module per architecture it runs.

``get_config(arch)`` returns the full published config, ``get_smoke(arch)``
the reduced same-family config of the CPU tests, as in the reference. An
architecture the port does not run yet raises ``KeyError`` naming the
ROADMAP item that ports it.
"""
from __future__ import annotations

import importlib

ARCHS = ["granite_8b", "nemotron_4_15b", "yi_6b", "deepseek_v2_lite_16b", "deepseek_v2_236b",
         "autoint"]

# the reference's other architectures -> the ROADMAP item that ports them
NOT_PORTED = {
    "mace": "queue A item 6c (GNNs)",
    "dimenet": "queue A item 6c (GNNs)",
    "graphcast": "queue A item 6c (GNNs)",
    "gin_tu": "queue A item 6c (GNNs)",
}


def _mod(arch: str):
    name = arch.replace("-", "_")
    if name not in ARCHS:
        where = NOT_PORTED.get(name)
        raise KeyError(f"architecture {arch!r} is not in the port yet"
                       + (f": ROADMAP.md {where} ports it" if where else
                          f" (the port has {ARCHS})"))
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _mod(arch).CONFIG


def get_smoke(arch: str):
    return _mod(arch).smoke_config()
