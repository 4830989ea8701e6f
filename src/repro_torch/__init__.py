"""repro_torch: the PyTorch + CUDA port of ``repro`` (dynamic-pipeline vs
MapReduce triangle counting), for one NVIDIA Hopper GPU.

Module names follow ``repro`` so each module's counterpart is easy to find.
The package imports ``torch`` and numpy only: never ``jax`` and never a
module of ``repro``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""

__version__ = "0.1.0"
