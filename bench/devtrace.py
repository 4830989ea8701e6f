"""The device trace of a window, from ``torch.profiler`` (CUPTI), read as
``chip_smoke.py`` reads its profiles: device rows by kernel name, device
busy time, the idle share, marker kernels that must survive the
profiler's loss of a session's first records.

Only device activity is recorded (no host operators), to keep the trace of
a window of hundreds of thousands of launches small. Device timestamps are
on the wall clock (``time.time_ns``); the trace maps them onto the
benchmark's ``time.perf_counter`` by one reading of both clocks, taken
right after the markers have been synchronised.
"""
from __future__ import annotations

import dataclasses
import re
import time

import torch

MARKERS = 64  # spin kernels before the window; one at least has to survive
_COPY = re.compile(r"memcpy|memset", re.IGNORECASE)


@dataclasses.dataclass
class Trace:
    """The device rows inside one window, in host seconds."""

    rows: list  # (name, start, end), sorted by start
    t0: float
    t1: float
    markers_kept: int
    marker_gap_s: float  # sync reading minus the last marker's end

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the rows' intervals, clipped to the window."""
        out: list[list[float]] = []
        for _, s, e in self.rows:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self) -> list[tuple[float, float]]:
        """Intervals of the window in which no device row ran."""
        gaps, last = [], self.t0
        for s, e in self.busy_intervals():
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if self.t1 > last:
            gaps.append((last, self.t1))
        return gaps

    def by_name(self) -> dict[str, list]:
        """Kernel or copy name -> [device seconds, rows], over the window."""
        out: dict[str, list] = {}
        for name, s, e in self.rows:
            d = min(e, self.t1) - max(s, self.t0)
            if d > 0:
                acc = out.setdefault(name, [0.0, 0])
                acc[0] += d
                acc[1] += 1
        return out


def is_copy(name: str) -> bool:
    return bool(_COPY.search(name))


class Recorder:
    """``with Recorder() as rec:`` around a window; ``rec.trace(t0, t1)``
    afterwards."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        for _ in range(MARKERS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        self.wall0_ns = time.time_ns()
        self.perf0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def trace(self, t0: float, t1: float) -> Trace:
        from torch.autograd import DeviceType

        def host(ns: int) -> float:
            return self.perf0 + (ns - self.wall0_ns) / 1e9

        rows, kept, marker_end = [], 0, None
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            name = ev.name()
            if "spin_kernel" in name:
                kept += 1
                end = host(ev.end_ns())
                marker_end = end if marker_end is None else max(marker_end, end)
                continue
            rows.append((name, host(ev.start_ns()), host(ev.end_ns())))
        rows.sort(key=lambda r: r[1])
        gap = self.perf0 - marker_end if marker_end is not None else float("nan")
        return Trace(rows=rows, t0=t0, t1=t1, markers_kept=kept, marker_gap_s=gap)
