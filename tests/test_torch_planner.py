"""The port's planner against the reference's: the same GraphStats and
Resources give the same Plan, field for field (``to_dict``), across the
regimes pinned in tests/test_api_planner.py. The port's ``"cuda"`` backend
maps onto the reference's ``"tpu"`` flags. The reference runs with x64 on,
because the port counts in int64 and the hybrid state's byte formula
includes the count's width."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import planner as ref_planner  # noqa: E402
from repro.core import streaming as ref_streaming  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro_torch.api import planner  # noqa: E402
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.core import streaming  # noqa: E402

STATS = [
    # DSJC.5-like: the dense regime where the pipeline wins
    (1_000, 250_000, 62_000_000, 560, 280, True),
    # replication-factor blowups: mapreduce must never be auto-picked
    (500, 50_000, ref_planner.MR_RF_FACTOR * 50_000 + 1, 300, 150, True),
    (10_000, 1_000_000, 500_000_000, 2_000, 900, True),
    # memory pressure: dense needs ~4.8 GB
    (20_000, 400_000, 1_600_000, 50, 25, True),
    # NY-like: the memory-bound sparse path
    (264_346, 733_846, 1_100_000, 8, 6, True),
    # a tiny graph and an empty one
    (40, 200, 900, 12, 9, True),
    (10, 0, 0, 0, 0, True),
    # streams: not memory-resident (bitset, sharded and hybrid layouts)
    (5_000_000, 0, 0, 0, 0, False),
    (100_000, 400_000, 0, 900, 40, False),
    (2_000, 1_800_000, 0, 1_900, 1_000, False),
    (20_000, 60_000, 0, 0, 0, False),
]
RESOURCES = [
    dict(),
    dict(memory_bytes=1 << 20),
    dict(memory_bytes=16 << 20),
    dict(memory_bytes=64 << 20, n_devices=2),
    dict(n_devices=8),
    dict(n_devices=16, max_stages=4),
    dict(memory_bytes=80 << 30, backend="BACKEND"),
]


def _both(stats_args, res_kw):
    """(port stats, port resources, reference stats, reference resources);
    the placeholder backend is "cuda" in the port and "tpu" in the reference."""
    n, m, rf, dmax, md, resident = stats_args
    st = planner.GraphStats(n, m, rf, dmax, md, edges_in_memory=resident)
    ref_st = ref_planner.GraphStats(n, m, rf, dmax, md, edges_in_memory=resident)
    kw = dict(res_kw)
    ref_kw = dict(res_kw)
    if kw.get("backend") == "BACKEND":
        kw["backend"], ref_kw["backend"] = "cuda", "tpu"
    return st, planner.Resources(**kw), ref_st, ref_planner.Resources(**ref_kw)


@pytest.mark.parametrize("stats_args", STATS)
@pytest.mark.parametrize("res_kw", RESOURCES)
def test_plan_equals_reference(stats_args, res_kw):
    st, res, ref_st, ref_res = _both(stats_args, res_kw)
    allows = [None] + [{m} for m in planner.METHODS] + [{"dense", "sparse", "mapreduce"}]
    for allow in allows:
        with jax.enable_x64(True):
            try:
                want = ref_planner.plan(ref_st, ref_res, allow=allow).to_dict()
            except ValueError as e:
                want = ("ValueError", str(e))
        try:
            got = planner.plan(st, res, allow=allow).to_dict()
        except ValueError as e:
            got = ("ValueError", str(e))
        assert got == want, allow


@pytest.mark.parametrize("window", [1, 3])
def test_windowed_stream_plans_equal_reference(window):
    st, res, ref_st, ref_res = _both((50_000, 0, 0, 0, 0, False),
                                     dict(memory_bytes=256 << 20, n_devices=4))
    with jax.enable_x64(True):
        want = ref_planner.plan(ref_st, ref_res, window_epochs=window).to_dict()
    assert planner.plan(st, res, window_epochs=window).to_dict() == want
    # a window on resident stats is refused by both
    st, res, ref_st, ref_res = _both(STATS[0], {})
    with pytest.raises(ValueError):
        ref_planner.plan(ref_st, ref_res, window_epochs=window)
    with pytest.raises(ValueError):
        planner.plan(st, res, window_epochs=window)


@pytest.mark.parametrize("stats_args", STATS)
@pytest.mark.parametrize("res_kw", RESOURCES[:5])
def test_sizing_equals_reference(stats_args, res_kw):
    st, res, ref_st, ref_res = _both(stats_args, res_kw)
    for w in (0, 2):
        assert planner.stream_sizing(st, res, window_epochs=w) == \
            ref_planner.stream_sizing(ref_st, ref_res, window_epochs=w)
    with jax.enable_x64(True):
        want = ref_planner.hybrid_sizing(ref_st, ref_res)
    got = planner.hybrid_sizing(st, res)
    assert (got is None and want is None) or \
        dataclasses.asdict(got) == dataclasses.asdict(want)


def test_hybrid_state_bytes_count_the_int64_total():
    for args in ((20_000, 64, 16), (100_000, 4096, 128), (33, 1, 1)):
        with jax.enable_x64(True):
            assert streaming.hybrid_state_nbytes(*args) == \
                ref_streaming.hybrid_state_nbytes(*args)
        # without x64 the reference's count is int32: 4 bytes narrower
        assert streaming.hybrid_state_nbytes(*args) == \
            ref_streaming.hybrid_state_nbytes(*args) + 4


@pytest.mark.parametrize("seed", range(3))
def test_graph_stats_from_graph_equal_reference(seed):
    ref_g = ref_gen.powerlaw(90 + 30 * seed, 4, seed=seed)
    g = graph_from_arrays(ref_g.n_nodes, ref_g.edges)
    assert dataclasses.asdict(planner.GraphStats.from_graph(g)) == \
        dataclasses.asdict(ref_planner.GraphStats.from_graph(ref_g))
    res = planner.Resources(n_devices=4)
    with jax.enable_x64(True):
        want = ref_planner.plan_for_graph(ref_g, ref_planner.Resources(n_devices=4))
    assert planner.plan_for_graph(g, res).to_dict() == want.to_dict()


def test_plans_round_trip_between_packages():
    with jax.enable_x64(True):
        ref_p = ref_planner.plan(ref_planner.GraphStats(100_000, 400_000, 0, 900, 40,
                                                        edges_in_memory=False),
                                 ref_planner.Resources(memory_bytes=4 << 30))
    p = planner.Plan.from_dict(ref_p.to_dict())
    assert p.to_dict() == ref_p.to_dict() and p.cache_key() == ref_p.cache_key()
    assert ref_planner.Plan.from_dict(json.loads(p.to_json())) == ref_p
    assert planner.Plan.from_json(p.to_json()) == p
    assert planner.ADMISSION_ONLY == ref_planner.ADMISSION_ONLY
    fields = {f.name for f in dataclasses.fields(planner.Plan)}
    assert fields == {f.name for f in dataclasses.fields(ref_planner.Plan)}


@pytest.mark.parametrize("backend,ref_backend", [("cuda", "tpu"), ("cpu", "cpu"),
                                                 ("tpu", "gpu")])
def test_backend_flags_map_cuda_onto_tpu(backend, ref_backend):
    assert planner.backend_exec_flags(planner.Resources(backend=backend)) == \
        ref_planner.backend_exec_flags(ref_planner.Resources(backend=ref_backend))


def test_resources_detect_needs_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        planner.Resources.detect()
    with pytest.raises(RuntimeError):
        planner.Resources.detect("cuda")
    res = planner.Resources.detect("cpu")
    assert res.backend == "cpu" and res.n_devices == 1 and res.memory_bytes > 0
    assert planner.backend_exec_flags(res) == {"use_kernel": False, "interpret": True}


def test_resources_detect_reads_the_card(monkeypatch):
    """With a card, detect() reports the "cuda" backend, the device count and
    the card's memory (faked here: the props are what torch would return)."""
    props = type("Props", (), {"total_memory": 80 * 10**9})()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: props)
    res = planner.Resources.detect()
    assert res == planner.Resources(memory_bytes=80 * 10**9, n_devices=1, backend="cuda")
    assert planner.backend_exec_flags(res) == {"use_kernel": True, "interpret": False}


def test_cost_constants_are_the_reference_constants():
    for name in ("MR_RF_FACTOR", "_MXU_DISCOUNT", "_GATHER_PENALTY", "_STREAM_PENALTY",
                 "_STREAM_BLOCK_MIN", "_STREAM_BLOCK_MAX", "_STREAM_BLOCK_MEM_FRACTION",
                 "_HYBRID_TAIL_MIN", "_HYBRID_TAIL_MAX", "_HYBRID_TAIL_DEFAULT",
                 "_HYBRID_HUB_MIN", "_HYBRID_BLOCK_MIN", "_HYBRID_BLOCK_MAX"):
        assert getattr(planner, name) == getattr(ref_planner, name), name
    assert planner.METHODS == ref_planner.METHODS
    np.testing.assert_equal(planner._pow2_at_least(1000), ref_planner._pow2_at_least(1000))
