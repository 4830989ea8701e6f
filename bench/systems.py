"""What the closed loop drives: the program under test, or the control.

Both take the same calls, so that a traffic driver and the comparison that
decides ``correct`` are one code path for either:
``open(n) -> sid``, ``feed(sid, records)``, ``close(sid) -> result``,
``count(result) -> int`` (the count on the host) and ``stats(result)``.
``Refused`` is raised by an open that is never admitted, ``Failed`` by a
session that cannot give its count.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import count_triangles


class Refused(Exception):
    pass


class Failed(Exception):
    pass


class PortSystem:
    """The program: one ``repro_torch.serve.serve_loop.TriangleServer`` on
    ``device``, through ``open_stream`` -> ``feed`` -> ``close_stream``."""

    Refused = Refused
    Failed = Failed

    def __init__(self, device: str):
        from repro_torch.serve.serve_loop import TriangleServer

        self.server = TriangleServer(device=device)

    def open(self, n_nodes: int):
        try:
            return self.server.open_stream(n_nodes)
        except ValueError as err:  # can never be admitted on this card
            raise Refused(str(err)) from err

    def feed(self, sid, records: np.ndarray) -> None:
        self.server.feed(sid, records)

    def close(self, sid):
        try:
            return self.server.close_stream(sid)
        except RuntimeError as err:  # a hybrid session that lost edges, or backpressure
            self.server.streams.kill(sid)
            raise Failed(str(err)) from err

    def count(self, result) -> int:
        if result.stats.get("cancelled"):
            raise Failed("cancelled: the session was never admitted")
        return result.item()

    def stats(self, result) -> dict:
        keep = ("n_blocks", "block_size", "state_bytes")
        return {"layout": result.plan.state_layout,
                **{k: int(result.stats[k]) for k in keep if k in result.stats}}

    def kernel_names(self) -> list[str]:
        """The names of the program's own kernels, read from its sources:
        every ``__global__`` function of its CUDA files and every
        ``@triton.jit`` function of its Python files."""
        import re
        from pathlib import Path

        import repro_torch

        pkg = Path(repro_torch.__file__).resolve().parent
        cu = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s+)?(\w+)\s*\(")
        tj = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")
        names = set()
        for path in pkg.rglob("*.cu"):
            names.update(cu.findall(path.read_text(errors="replace")))
        for path in pkg.rglob("*.py"):
            text = path.read_text(errors="replace")
            if "triton" in text:
                names.update(tj.findall(text))
        return sorted(names)

    def free(self) -> None:
        self.server = None


class ControlSystem:
    """The control: the reference put in the program's place, with one
    guarantee that the configurations state broken. Every acknowledged
    feed must be counted at close; the control leaves out each session's
    last feed, as a close that skipped the tail flush would."""

    Refused = Refused
    Failed = Failed

    def __init__(self, device: str):
        self.device = device
        self.open_sessions: dict[int, tuple[int, list]] = {}
        self.next_sid = 0

    def open(self, n_nodes: int) -> int:
        sid = self.next_sid
        self.next_sid += 1
        self.open_sessions[sid] = (n_nodes, [])
        return sid

    def feed(self, sid: int, records: np.ndarray) -> None:
        self.open_sessions[sid][1].append(records)

    def close(self, sid: int) -> int:
        n, feeds = self.open_sessions.pop(sid)
        kept = np.concatenate(feeds[:-1]) if len(feeds) > 1 else np.zeros((0, 2), np.int32)
        return count_triangles(torch.from_numpy(kept).to(self.device), n)[0]

    def count(self, result: int) -> int:
        return result

    def stats(self, result) -> dict:
        return {}

    def kernel_names(self) -> list[str]:
        return []

    def free(self) -> None:
        self.open_sessions.clear()
