"""CPU runs of the harness on throwaway cells: a cell added as files alone
runs, its last line has the required shape, the control comes out not
correct, and each fault a cell can have, planted under the timed path,
turns ``correct`` false. ``run.py`` itself exits without a card."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness
from bench.systems import ControlSystem

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 3


def test_a_throwaway_workload_added_as_files_alone_runs_on_the_cpu(tiny_root):
    out = harness.run_cell(tiny_root, "tiny_road.t2", SEED, 1.0, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["checks"]["checked_sessions"]["value"] >= 2
    assert {"edges_per_s", "setup_s"} <= set(out["metrics"])
    assert out["metrics"]["edges_per_s"]["value"] > 0


GNM = '''
import numpy as np


def generate(params, seed):
    n, m = int(params["n"]), int(params["m"])
    return n, np.random.default_rng(seed).integers(0, n, size=(m, 2)).astype(np.int32)
'''

ONE_FEED = '''
import time

import numpy as np

from bench.session import Session, Spans


def prepare(records, mix, seed):
    return records[np.random.default_rng(seed).permutation(len(records))]


def warm(system, n_nodes, records, mix):
    sid = system.open(n_nodes)
    system.feed(sid, records)
    system.count(system.close(sid))


def drive(system, n_nodes, records, mix, seconds):
    sessions, spans = [], Spans()
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + seconds:
        rec = Session(t_open=time.perf_counter(), records=records, key="whole", full=True)
        rec.sid = spans.call("open", system.open, n_nodes)
        spans.call("feed", system.feed, rec.sid, records)
        rec.feeds, rec.fed = 1, len(records)
        rec.count = spans.call("count", system.count, spans.call("close", system.close, rec.sid))
        rec.t_done = time.perf_counter()
        sessions.append(rec)
    return sessions, spans, t0, time.perf_counter()
'''


def test_a_throwaway_generator_and_driver_added_as_files_alone_run_on_the_cpu(tiny_root):
    bench = tiny_root / "bench"
    (bench / "generators" / "gnm.py").write_text(GNM)
    (bench / "drivers" / "one_feed.py").write_text(ONE_FEED)
    (bench / "configs" / "tiny_gnm.json").write_text(json.dumps(
        {"generator": "gnm", "params": {"n": 200, "m": 2000}, "reduced": []}))
    (bench / "traffic" / "whole.json").write_text(json.dumps({"driver": "one_feed"}))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_gnm", "source": "test", "reduced": [], "why": "test",
                            "file": "bench/configs/tiny_gnm.json"})
    spec["workloads"].append({"name": "tiny_gnm.whole", "config": "tiny_gnm",
                              "traffic": "whole", "chips": 1, "why": "test"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    lines = []
    out = harness.run_cell(tiny_root, "tiny_gnm.whole", SEED, 0.5, False, device="cpu",
                           log=lines.append)
    assert out["correct"], out["checks"]
    assert out["checks"]["checked_sessions"]["value"] >= 1
    assert "2000 records over 200 nodes" in lines[0]
    # the same files under a control that drops the last feed: every count wrong
    out = harness.run_cell(tiny_root, "tiny_gnm.whole", SEED, 0.5, False, device="cpu",
                           system_cls=ControlSystem)
    assert not out["correct"]
    assert out["checks"]["wrong_counts"]["value"] == out["checks"]["checked_sessions"]["value"]


def test_the_result_has_the_required_shape(tiny_root):
    out = json.loads(json.dumps(harness.run_cell(tiny_root, "tiny_road.t2", SEED + 1, 0.5,
                                                 False, device="cpu")))
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert isinstance(out["correct"], bool) and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit", "rule"}
    assert harness.check_lines(out["checks"])[0] == "wrong_counts 0 (at most 0)"


def test_run_exits_without_a_card_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "ny_road.streams8",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_the_control_comes_out_not_correct(tiny_root):
    out = harness.run_cell(tiny_root, "tiny_road.t2", SEED, 1.0, False, device="cpu",
                           system_cls=ControlSystem)
    assert not out["correct"] and out["checks"]["wrong_counts"]["value"] >= 1


def _hybrid_budget(monkeypatch):
    """A card of 4 MiB: the planner gives ``tiny_power``'s 8,000 nodes the
    hybrid state (their bitset would take 8 MB)."""
    from repro_torch.api import planner

    detect = planner.Resources.detect
    monkeypatch.setattr(planner.Resources, "detect", classmethod(
        lambda cls, device=None: dataclasses.replace(detect(device), memory_bytes=4 << 20)))


def _plant(monkeypatch, fault: str, layout: str) -> None:
    from repro_torch.api.counter import StreamSession
    from repro_torch.core import streaming

    name = "ingest_block_hybrid" if layout == "hybrid" else "ingest_block"
    ingest = getattr(streaming, name)
    if fault == "state_unchanged":
        monkeypatch.setattr(streaming, name, lambda state, edges, **kw: state)
    elif fault == "half_of_each_block":
        monkeypatch.setattr(streaming, name,
                            lambda state, edges, **kw: ingest(state, edges[: len(edges) // 2], **kw))
    else:  # the answer altered where it is produced
        finalize = StreamSession.finalize

        def altered(self):
            r = finalize(self)
            return dataclasses.replace(r, count=r.count + 1)

        monkeypatch.setattr(StreamSession, "finalize", altered)


@pytest.mark.parametrize("layout", ["bitset", "hybrid"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_of_each_block", "answer_altered"])
def test_a_fault_under_the_timed_path_turns_correct_false(tiny_root, monkeypatch, fault,
                                                          layout):
    cell = "tiny_road.t2" if layout == "bitset" else "tiny_power.t2"
    if layout == "hybrid":
        _hybrid_budget(monkeypatch)
    lines = []
    sound = harness.run_cell(tiny_root, cell, SEED, 1.0, False, device="cpu", log=lines.append)
    assert sound["correct"], sound["checks"]
    assert f"layouts ['{layout}']" in next(x for x in lines if x.startswith("window:"))
    _plant(monkeypatch, fault, layout)
    out = harness.run_cell(tiny_root, cell, SEED, 1.0, False, device="cpu")
    assert not out["correct"] and out["checks"]["wrong_counts"]["value"] >= 1
