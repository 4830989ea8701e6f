"""A power-law edge stream: ``m`` Chung-Lu draws of both endpoints from
weights ``i**-alpha`` over ``n`` nodes, a frozen copy of how
``chip_smoke.yt_stream`` draws com-Youtube's analogue. The draws keep
their duplicates and self-loops: the stream is what drops them.
"""
from __future__ import annotations

import numpy as np


def generate(params: dict, seed: int) -> tuple[int, np.ndarray]:
    """(n, int32 (m, 2) records): ``m`` draws over ``n`` nodes with
    weights i^-``alpha``."""
    n, m = int(params["n"]), int(params["m"])
    rng = np.random.default_rng(seed)
    w = np.arange(1, n + 1, dtype=np.float64) ** -float(params["alpha"])
    w /= w.sum()
    e = np.stack([rng.choice(n, m, p=w), rng.choice(n, m, p=w)], 1).astype(np.int32)
    return n, e
