"""Fixtures of the benchmark's CPU tests: a throwaway benchmark root whose
cells are added as files alone, at sizes a test run holds."""
import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

TINY_CONFIGS = {
    "tiny_road": {"generator": "ny_road",
                  "params": {"n": 900, "m": 1200, "diagonal_share": 0.3,
                             "shortcut_share": 0.05}},
    "tiny_power": {"generator": "chung_lu", "params": {"n": 8000, "m": 40000, "alpha": 0.85}},
}
TINY_MIX = {"driver": "closed_loop", "clients": 2, "feed_edges": [50, 300]}


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    """A copy of the benchmark with cells ``tiny_road.t2`` and
    ``tiny_power.t2`` added as a configuration file, a traffic file and
    entries in ``BENCHMARK.json`` (the cells, and their names in
    ``edges_per_s``'s list), nothing else."""
    bench = tmp_path / "bench"
    for sub in ("metrics", "traffic", "configs", "generators", "drivers"):
        shutil.copytree(BENCH / sub, bench / sub)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (bench / "traffic" / "t2.json").write_text(json.dumps(TINY_MIX))
    for name, cfg in TINY_CONFIGS.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "test", "reduced": [], "why": "test",
                                "file": f"bench/configs/{name}.json"})
        spec["workloads"].append({"name": f"{name}.t2", "config": name, "traffic": "t2",
                                  "chips": 1, "why": "test"})
        next(m for m in spec["end_to_end"] if m["name"] == "edges_per_s")["workloads"].append(
            f"{name}.t2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path
