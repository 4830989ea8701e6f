"""Benchmark graph registry — Table 1 of the paper.

Each entry carries the paper's full-size parameters plus a ``scale`` knob so
the CPU tests can run exact, structurally identical analogues at tractable
sizes; ``chip_smoke.py`` counts the full sizes on the GPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.graphs.formats import Graph
from repro_torch.graphs import generators as gen


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    name: str
    n_vertices: int
    n_arcs: int
    density: float
    build: Callable[[float, int], Graph]  # (scale, seed) -> Graph

    def instantiate(self, scale: float = 1.0, seed: int = 0) -> Graph:
        return self.build(scale, seed)


def _dsjc(n: int, p: float):
    def build(scale: float, seed: int) -> Graph:
        ns = max(8, int(n * scale))
        return gen.gnp(ns, p, seed=seed)

    return build


def _fna(n: int, m: int):
    def build(scale: float, seed: int) -> Graph:
        ns = max(8, int(n * scale))
        ms = min(int(m * scale * scale), ns * (ns - 1) // 2)
        return gen.fixed_arcs(ns, max(ms, ns), seed=seed)

    return build


def _road(n: int):
    def build(scale: float, seed: int) -> Graph:
        side = max(4, int(np.sqrt(n * scale)))
        return gen.road_grid(side, side, seed=seed)

    return build


def _fb(n: int, m_per: int):
    def build(scale: float, seed: int) -> Graph:
        ns = max(m_per + 2, int(n * scale))
        return gen.powerlaw(ns, m_per_node=m_per, seed=seed)

    return build


# Name -> (paper's) #vertices, #arcs, density, generator.  Table 1.
TABLE1: dict[str, GraphSpec] = {
    "DSJC.1": GraphSpec("DSJC.1", 1_000, 99_258, 0.10, _dsjc(1_000, 0.10)),
    "DSJC.5": GraphSpec("DSJC.5", 1_000, 499_652, 0.50, _dsjc(1_000, 0.50)),
    "DSJC.9": GraphSpec("DSJC.9", 1_000, 898_898, 0.90, _dsjc(1_000, 0.90)),
    "FNA.1": GraphSpec("FNA.1", 10_000, 10_000_000, 0.10, _fna(10_000, 10_000_000)),
    "FNA.5": GraphSpec("FNA.5", 4_472, 10_000_000, 0.50, _fna(4_472, 10_000_000)),
    "FNA.9": GraphSpec("FNA.9", 3_333, 10_000_000, 0.90, _fna(3_333, 10_000_000)),
    "NY": GraphSpec("NY", 264_346, 733_846, 1.04e-5, _road(264_346)),
    "FB107": GraphSpec("FB107", 1_911, 53_498, 1.47e-2, _fb(1_911, 14)),
}


def load(name: str, scale: float = 1.0, seed: int = 0) -> Graph:
    return TABLE1[name].instantiate(scale=scale, seed=seed)
