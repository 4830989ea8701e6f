"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in ``BENCHMARK.json``, and a cell is added by adding
files and entries:

- the configuration's ``file``, whose ``generator`` names
  ``bench/generators/<generator>.py``: a ``generate(params, seed)`` that
  returns ``(n_nodes, records)``;
- ``bench/traffic/<traffic>.json``, whose ``driver`` names
  ``bench/drivers/<driver>.py``: ``prepare(records, mix, seed)``, set-up's
  work; ``warm(system, n_nodes, work, mix)``; and ``drive(system, n_nodes,
  work, mix, seconds)``, the window, which returns ``(sessions, spans, t0,
  t1)`` as ``bench.session`` defines them, each counted session with the
  records its count has to cover;
- ``bench/metrics/<metric>.py``: a ``read(ctx)`` that returns a number, or
  None where it finds nothing to read, and the metric is then left out of
  the line. A metric ``<base>.<part>`` without a file of its own is read by
  ``<base>.py``: one quantity split by the end-to-end metric it moves.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from bench.reference import count_triangles
from bench.systems import PortSystem

# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(root: Path, spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """(the workload's entry, its configuration, its traffic mix)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, mix


def load(root: Path, kind: str, name: str):
    """The module ``bench/<kind>/<name>.py`` under ``root``, by its path."""
    path = root / "bench" / kind / f"{name}.py"
    modname = f"bench_{kind}_{name}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod  # dataclasses look their module up by name
    spec.loader.exec_module(mod)
    return mod


def metrics_for(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


def reader(root: Path, name: str):
    if not (root / "bench" / "metrics" / f"{name}.py").is_file():
        name = name.split(".")[0]
    return load(root, "metrics", name).read


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    workload: str
    config: dict
    mix: dict
    n_nodes: int
    sessions: list
    spans: list  # (label, start, end)
    t0: float
    t1: float
    setup_s: float
    peak_bytes: int | None  # device memory peak over the window
    trace: object | None  # devtrace.Trace of the window, in a traced run
    port_kernels: list  # names of the program's own kernels

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def span_at(self, t: float) -> str:
        for label, s, e in self.spans:
            if s <= t <= e:
                return label
        return "between calls"


def check(sessions: list, n_nodes: int, device: str) -> dict:
    """Compare every count due in the window with the reference's count of
    the records that session was fed. Returns the numbers compared, each
    with its limit and whether it is the most or the least allowed."""
    done: dict = {}
    for rec in sessions:
        if rec.count is None:
            continue
        if rec.key not in done:
            records = torch.from_numpy(rec.records).to(device)
            done[rec.key] = count_triangles(records, n_nodes)
        rec.expected, rec.simple_edges = done[rec.key]
    counted = [r for r in sessions if r.count is not None]
    return {
        "wrong_counts": {"value": sum(r.count != r.expected for r in counted),
                         "limit": 0, "rule": "at most"},
        "failed_sessions": {"value": sum(r.error is not None for r in sessions),
                            "limit": 0, "rule": "at most"},
        "whole_graphs_of_0": {"value": sum(r.full and r.expected == 0 for r in counted),
                              "limit": 0, "rule": "at most"},
        "checked_sessions": {"value": len(counted), "limit": 1, "rule": "at least"},
    }


def holds(c: dict) -> bool:
    return c["value"] <= c["limit"] if c["rule"] == "at most" else c["value"] >= c["limit"]


def breakdown(ctx: Context) -> dict:
    """The ten device rows that took most time, and the ten longest idle
    gaps, each named by the benchmark's span the host was in."""
    rows = sorted(ctx.trace.by_name().items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(ctx.trace.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[name[:160], acc[0]] for name, acc in rows],
            "idle_gaps": [[f"{ctx.span_at((s + e) / 2)} at +{s - ctx.t0:.3f} s", e - s]
                          for s, e in gaps]}


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             system_cls=None, log=print) -> dict:
    """Run one cell once; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device == "cuda"
    spec = load_spec(root)
    cell, config, mix = cell_files(root, spec, workload)
    marks = [("start", time.perf_counter())]
    generator = load(root, "generators", config["generator"])
    driver = load(root, "drivers", mix["driver"])
    n_nodes, records = generator.generate(config["params"], seed)
    marks.append(("data", time.perf_counter()))
    work = driver.prepare(records, mix, seed)
    marks.append(("orders", time.perf_counter()))
    system = (system_cls or PortSystem)(device)
    marks.append(("server", time.perf_counter()))
    driver.warm(system, n_nodes, work, mix)
    marks.append(("warm-up", time.perf_counter()))
    port_kernels = system.kernel_names()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    recorder = None
    if trace:
        from bench.devtrace import MARKERS, Recorder

        recorder = Recorder()
    with recorder or contextlib.nullcontext():
        setup_s = time.perf_counter() - t_start
        sessions, spans, t0, t1 = driver.drive(system, n_nodes, work, mix, seconds)
    log(f"setup: {setup_s:.3f} s ({marks[0][1] - t_start:.3f} s to the cell, then "
        + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:]))
        + f"), {len(records)} records over {n_nodes} nodes")
    lat = sorted((r.t_done - r.t_open) * 1e3 for r in sessions if r.full and r.count is not None)
    log(f"window: {t1 - t0:.3f} s, {len(sessions)} sessions, {len(lat)} whole; layouts "
        f"{sorted({r.stats.get('layout') for r in sessions} - {None})}, blocks "
        f"{sorted({r.stats.get('block_size') for r in sessions} - {None})}; whole ms "
        + " ".join(f"{lat[int(q * (len(lat) - 1))]:.1f}" for q in (0, .1, .5, .9, 1) if lat))
    window = None
    if recorder is not None:
        t_read = time.perf_counter()
        window = recorder.trace(t0, t1)
        recorder = None  # the profiler's records, freed before the reference runs
        log(f"trace: {len(window.rows)} device rows, {window.markers_kept} of "
            f"{MARKERS} markers kept, clocks {window.marker_gap_s * 1e3:.3f} ms apart, read "
            f"in {time.perf_counter() - t_read:.3f} s")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    system.free()
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check(sessions, n_nodes, device)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s for {len(sessions)} sessions")
    ctx = Context(workload=workload, config=config, mix=mix, n_nodes=n_nodes,
                  sessions=sessions, spans=spans.items, t0=t0, t1=t1, setup_s=setup_s,
                  peak_bytes=peak, trace=window, port_kernels=port_kernels)
    metrics = {}
    for m in metrics_for(spec, workload, trace):
        value = reader(root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = checks["failed_sessions"]["value"] + checks["wrong_counts"]["value"]
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name() if on_card else device,
           "count": int(cell["chips"]), "memory_peak_bytes": peak if peak is not None else 0}
    out = {"correct": all(holds(c) for c in checks.values()), "attempted": len(sessions),
           "failed": failed, "metrics": metrics, "device": dev}
    if window is not None:
        dev["busy_s"] = window.busy_s
        dev["window_s"] = window.window_s
        out["breakdown"] = breakdown(ctx)
    out["checks"] = checks
    return out


def check_lines(checks: dict) -> list[str]:
    return [f"{name} {c['value']} ({c['rule']} {c['limit']})" for name, c in checks.items()]
