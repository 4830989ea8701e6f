"""CPU tests of the benchmark's definition: the files every cell resolves by
name, the limits ``BENCHMARK.json`` keeps to, the generators and the
reference, the trace arithmetic and the import check."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import harness
from bench.devtrace import Trace
from bench.reference import count_triangles

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_workload_resolves_its_files_by_name(cell):
    entry, config, mix = harness.cell_files(ROOT, SPEC, cell)
    assert callable(harness.load(ROOT, "generators", config["generator"]).generate)
    driver = harness.load(ROOT, "drivers", mix["driver"])
    assert all(callable(getattr(driver, f)) for f in ("prepare", "warm", "drive"))
    assert {"clients", "feed_edges"} <= set(mix)
    for m in harness.metrics_for(SPEC, cell, False) + harness.metrics_for(SPEC, cell, True):
        assert callable(harness.reader(ROOT, m["name"]))
    e2e = {m["name"] for m in harness.metrics_for(SPEC, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.metrics_for(SPEC, cell, True)
    assert layer and all(m["moves"] in e2e for m in layer)


def test_benchmark_json_keeps_to_its_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"] == ["python3", "bench/run.py"]
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    configs = {c["name"] for c in SPEC["configs"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    assert configs == {w["config"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in SPEC["end_to_end"]}["setup_s"] == 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name, params", [
    ("ny_road", {"n": 2000, "m": 2900, "diagonal_share": 0.1, "shortcut_share": 0.05}),
    ("chung_lu", {"n": 5000, "m": 12000, "alpha": 0.85}),
])
def test_generators_reproduce_from_the_seed(name, params):
    generate = harness.load(ROOT, "generators", name).generate
    n, a = generate(params, 2**31 + 11)
    _, b = generate(params, 2**31 + 11)
    _, c = generate(params, 2**31 + 12)
    assert n == params["n"] and a.dtype == np.int32 and a.shape == (params["m"], 2)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < n
    if name == "ny_road":  # a simple graph with triangles
        assert len(canonical(a)) == params["m"]
        assert count_triangles(torch.from_numpy(a), n)[0] > 0
    prepare = harness.load(ROOT, "drivers", "closed_loop").prepare
    mix = {"clients": 2, "feed_edges": [100, 900]}
    t1, t2, t3 = prepare(a, mix, 5), prepare(a, mix, 5), prepare(a, mix, 6)
    assert len(t1) == 4
    for x, y, z in zip(t1, t2, t3):
        assert np.array_equal(x.records, y.records) and np.array_equal(x.cuts, y.cuts)
        assert x.cuts[-1] == len(a) and np.all(np.diff(x.cuts) > 0)
        # another seed cuts the work alike and feeds other edges
        assert np.array_equal(x.cuts, z.cuts) and not np.array_equal(x.records, z.records)
        assert np.array_equal(np.sort(x.records, axis=0), np.sort(a, axis=0))


def canonical(records: np.ndarray) -> set:
    """The simple graph's edges, by plain Python."""
    return {(min(u, v), max(u, v)) for u, v in records.tolist() if u != v}


def brute(n: int, records: np.ndarray) -> int:
    adj = np.zeros((n, n), np.int64)
    for u, v in records:
        if u != v:
            adj[u, v] = adj[v, u] = 1
    return int(np.trace(adj @ adj @ adj)) // 6


@pytest.mark.parametrize("seed", range(8))
def test_reference_equals_a_brute_force_count(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 40))
    records = rng.integers(0, n, size=(int(rng.integers(0, 300)), 2))
    got, simple = count_triangles(torch.from_numpy(records), n)
    assert got == brute(n, records)
    assert simple == len(canonical(records))


@pytest.mark.parametrize("name", ["ny_road", "chung_lu"])
def test_reference_equals_the_ports_cpu_count(name):
    from repro_torch.api import TriangleCounter
    from repro_torch.graphs.formats import canonical_edges

    params = ({"n": 3000, "m": 4400, "diagonal_share": 0.2, "shortcut_share": 0.05}
              if name == "ny_road" else {"n": 3000, "m": 9000, "alpha": 0.85})
    n, records = harness.load(ROOT, "generators", name).generate(params, 7)
    counter = TriangleCounter(device="cpu")
    want = counter.count(canonical_edges(records, n)).item()
    session = counter.open_stream(n)
    for part in np.array_split(records, 5):
        session.feed(part)
    assert count_triangles(torch.from_numpy(records), n)[0] == want == \
        session.finalize().item() > 0


def test_trace_arithmetic():
    rows = [("k1", 0.5, 1.0), ("Memcpy HtoD", 0.9, 1.2), ("k2", 2.0, 2.5), ("k1", 3.5, 5.0)]
    tr = Trace(rows=rows, t0=0.0, t1=4.0, markers_kept=1, marker_gap_s=0.0)
    assert tr.busy_intervals() == [(0.5, 1.2), (2.0, 2.5), (3.5, 4.0)]
    assert tr.busy_s == pytest.approx(1.7)
    assert tr.idle_gaps() == [(0.0, 0.5), (1.2, 2.0), (2.5, 3.5)]
    assert tr.by_name()["k1"] == [pytest.approx(1.0), 2]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", object())
    assert "repro_torch_lookalike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake_submodule", object())
    assert "repro" in harness.forbidden_modules()


def test_the_harness_imports_no_jax_and_the_reference_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "import bench.reference, bench.session, bench.peaks, bench.harness as h\n"
            "from pathlib import Path\n"
            "for kind in ('generators', 'drivers'):\n"
            "    for f in Path('bench', kind).glob('*.py'): h.load(Path('.'), kind, f.stem)\n"
            "assert not {m.split('.')[0] for m in sys.modules} & "
            "{'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}, 'reference'\n"
            "import bench.systems, bench.devtrace, bench.control\n"
            "from bench.systems import PortSystem; PortSystem('cpu')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['repro_torch']"
    # no file of the benchmark names a forbidden package in an import
    for path in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not {m.split(".")[0] for m in mods} & set(harness.FORBIDDEN), path
