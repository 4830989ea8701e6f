"""What a traffic driver records of each session, and the benchmark's own
host-clock spans around its calls into the system. Every driver fills
these, and the comparison that decides ``correct`` and the metrics' readers
read only these."""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class Session:
    """What the benchmark saw of one session."""

    t_open: float
    sid: object = None
    feeds: int = 0  # feeds made
    fed: int = 0  # edge records fed
    full: bool = False  # streamed its whole graph
    t_done: float | None = None  # its count on the host
    count: int | None = None
    stats: dict = dataclasses.field(default_factory=dict)
    error: str | None = None
    # the records its count has to cover, and a key equal for sessions
    # whose records make the same graph (the reference counts it once)
    records: np.ndarray | None = None
    key: object = None
    expected: int | None = None  # the reference's count, after the window
    simple_edges: int | None = None  # distinct edges among ``records``


class Spans:
    """(label, start, end) in ``time.perf_counter`` seconds."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    def call(self, label: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.items.append((label, t0, time.perf_counter()))
