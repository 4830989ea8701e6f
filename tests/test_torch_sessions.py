"""The port's stream sessions (``TriangleCounter.open_stream`` /
``count_stream`` / ``count_windowed`` / ``restore_stream``,
``StreamSession``, ``SessionCheckpoint``) against the reference's.

Every stream is made with numpy from a seed and fed through both packages'
counters; counts are compared as exact integers, plans and cache keys as
values, and checkpoints array for array. A checkpoint moves between the two
packages: the reference's ``.npz`` spill restores in the port and the
port's in the reference."""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import Plan as RefPlan  # noqa: E402
from repro.api import SessionCheckpoint as RefSessionCheckpoint  # noqa: E402
from repro.api import TriangleCounter as RefTriangleCounter  # noqa: E402
from repro.core.triangle_ref import count_triangles_brute  # noqa: E402
from repro.graphs import generators as gen  # noqa: E402
from repro.graphs.formats import canonical_edges  # noqa: E402
from repro_torch.api import (  # noqa: E402
    GraphStats,
    Plan,
    Resources,
    SessionCheckpoint,
    StreamSession,
    TriangleCounter,
    plan,
)
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.core import streaming  # noqa: E402


def _counter(**kw):
    return TriangleCounter(Resources(), device="cpu", **kw)


def _edges(n, m, seed):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(m, 2), dtype=np.int32)
    return e[e[:, 0] != e[:, 1]]


def _blocks(stream, block):
    return [stream[i:i + block] for i in range(0, len(stream), block)]


def _run_schedule(counter, n, ops, *, plan=None, window=None, ckpt_at=()):
    """Run a (kind, payload) op schedule through one stream session,
    checkpoint and restore at the op indices in ``ckpt_at``."""
    s = counter.open_stream(n, plan=plan, window=window)
    for i, (kind, payload) in enumerate(ops):
        if i in ckpt_at:
            s = counter.restore_stream(s.checkpoint())
        if kind == "feed":
            s.feed(payload)
        else:
            s.advance()
    return s


def _random_ops(n, m, seed, *, windowed=False):
    rng = np.random.default_rng(seed)
    e = _edges(n, m, seed)
    ops, pos = [], 0
    while pos < len(e):
        step = int(rng.integers(1, 40))
        ops.append(("feed", e[pos:pos + step]))
        pos += step
        if windowed and rng.random() < 0.25:
            ops.append(("advance", None))
    return ops


# --------------------------------------------------------------------------
# count_stream / count_windowed against the reference's counter
# --------------------------------------------------------------------------
def test_count_stream_matches_reference_counter():
    g = gen.powerlaw(120, 5, seed=17)
    blocks = _blocks(g.edges[np.random.default_rng(0).permutation(g.n_edges)], 19)
    res, ref_res = _counter().count_stream(120, blocks), RefTriangleCounter().count_stream(
        120, blocks)
    assert res.item() == ref_res.item() == count_triangles_brute(g)
    assert res.count.dtype == torch.int64 and res.plan.to_dict() == ref_res.plan.to_dict()
    assert res.stats["cache"]["key"] == ref_res.stats["cache"]["key"]
    for k in ("n_blocks", "block_size", "n_stages", "sharded", "on_mesh", "session",
              "state_bytes"):
        assert res.stats[k] == ref_res.stats[k], k


def test_count_stream_rejects_non_stream_plan():
    g = gen.gnp(20, 0.5, seed=1)
    c = _counter()
    for bad in (Plan(method="dense"), Plan(method="bitset_ring"), Plan(method="mapreduce")):
        with pytest.raises(ValueError, match="method='stream'"):
            c.count_stream(20, [g.edges], plan=bad)
    with pytest.raises(ValueError, match="method='stream'"):
        _counter(plan=Plan(method="dense")).count_stream(20, [g.edges])


def test_count_stream_applies_plan_block_size():
    g = gen.gnp(66, 0.4, seed=13)
    c = _counter(plan=Plan(method="stream", block_size=17))
    res = c.count_stream(66, [g.edges])
    assert res.item() == count_triangles_brute(g)
    assert res.stats["block_size"] == 17 and res.stats["n_blocks"] == -(-g.n_edges // 17)
    res2 = c.count_stream(66, [g.edges], block_size=2048)  # the argument overrides
    assert res2.item() == count_triangles_brute(g)
    assert res2.stats["block_size"] == 2048 and res2.stats["n_blocks"] == 1


def test_count_stream_plan_none_uses_planner_sizing():
    g = gen.gnp(58, 0.5, seed=17)
    res = _counter().count_stream(58, _blocks(g.edges, 19))
    assert res.item() == count_triangles_brute(g) and res.plan.method == "stream"
    assert res.stats["block_size"] == res.plan.block_size
    assert res.stats["n_stages"] == res.plan.n_stages
    assert res.stats["cache"]["key"][0] == res.plan.cache_key()


def test_count_stream_sharded_plan_routes_sharded_state():
    g = gen.gnp(60, 0.5, seed=19)
    p = Plan(method="stream", n_stages=4, block_size=64)
    res = _counter(plan=p).count_stream(60, [g.edges])
    ref_res = RefTriangleCounter(plan=RefPlan(method="stream", n_stages=4,
                                              block_size=64)).count_stream(60, [g.edges])
    assert res.item() == ref_res.item() == count_triangles_brute(g)
    assert res.stats["sharded"] is True and res.stats["n_stages"] == 4
    assert res.stats["on_mesh"] is False


def test_stream_plan_on_a_resident_graph_matches_reference():
    g = gen.gnp(70, 0.3, seed=21)
    stats = GraphStats.from_graph(graph_from_arrays(g.n_nodes, g.edges))
    p = plan(stats, Resources(), allow={"stream"})
    assert p.method == "stream"
    res = _counter().count(graph_from_arrays(g.n_nodes, g.edges), plan=p)
    ref_res = RefTriangleCounter().count(g, plan=RefPlan.from_dict(p.to_dict()))
    assert res.item() == ref_res.item() == count_triangles_brute(g)
    assert res.stats["block_size"] == ref_res.stats["block_size"] < p.block_size
    assert res.stats["cache"]["key"] == ref_res.stats["cache"]["key"]


@pytest.mark.parametrize("window,seed", [(3, 13), (1, 14), (5, 15)])
def test_count_windowed_matches_reference_and_carries_stats(window, seed):
    rng = np.random.default_rng(seed)
    epochs = [[rng.integers(0, 35, size=(44, 2)).astype(np.int32)] for _ in range(7)]
    res = _counter().count_windowed(35, epochs, window=window, block_size=16)
    ref_res = RefTriangleCounter().count_windowed(35, epochs, window=window, block_size=16)
    assert res.item() == ref_res.item()
    assert res.plan.to_dict() == ref_res.plan.to_dict()
    assert res.plan.method == "stream" and res.plan.window_epochs == window
    assert res.stats["window_epochs"] == window and res.stats["epochs_advanced"] == 6
    assert res.stats["cache"]["key"] == ref_res.stats["cache"]["key"]


def test_session_window_mode_feed_advance_finalize():
    rng = np.random.default_rng(17)
    epochs = [rng.integers(0, 40, size=(30, 2)).astype(np.int32) for _ in range(6)]
    s = _counter().open_stream(40, window=2, block_size=16)
    assert isinstance(s, StreamSession) and s.plan.window_epochs == 2
    for t, e in enumerate(epochs):
        if t:
            s.advance()
        s.feed(e)
    res = s.finalize()
    want = RefTriangleCounter().count_windowed(40, [[e] for e in epochs], window=2,
                                               block_size=16)
    assert res.item() == want.item()
    assert s.finalize() is res and s.closed
    for call in (lambda: s.feed(epochs[0]), s.advance, s.checkpoint,
                 lambda: s.reblock(epochs[0]), s.flush_ready, s.expire_ready,
                 lambda: s.set_block_size(8)):
        with pytest.raises(RuntimeError, match="finalized"):
            call()


def test_advance_requires_windowed_session():
    s = _counter().open_stream(20)
    for call in (s.advance, s.expire_ready):
        with pytest.raises(RuntimeError, match="windowed"):
            call()


def test_count_windowed_requires_window():
    c = _counter()
    with pytest.raises(ValueError, match="window"):
        c.count_windowed(20, [[np.array([[0, 1]], np.int32)]])
    with pytest.raises(ValueError, match="window"):
        c.count_windowed(20, [[np.array([[0, 1]], np.int32)]],
                         plan=Plan(method="stream"), window=0)
    assert c.cache_info["entries"] == 0  # validated before any session opened


def test_open_stream_window_plan_conflict_raises():
    c = _counter()
    with pytest.raises(ValueError, match="window"):
        c.open_stream(20, plan=Plan(method="stream", window_epochs=2), window=3)
    s = c.open_stream(20, plan=Plan(method="stream", window_epochs=2, block_size=8), window=2)
    assert s.plan.window_epochs == 2


def test_sharded_session_window_parity():
    rng = np.random.default_rng(19)
    epochs = [[rng.integers(0, 45, size=(35, 2)).astype(np.int32)] for _ in range(8)]
    p = Plan(method="stream", n_stages=3, block_size=16, window_epochs=3)
    res = _counter(plan=p).count_windowed(45, epochs)
    dense = _counter().count_windowed(45, epochs, window=3, block_size=16)
    assert res.item() == dense.item()
    assert res.stats["sharded"] is True and res.stats["window_epochs"] == 3


def test_async_split_surface_equals_feed():
    """reblock + ingest_ready per block, flush_ready + expire_ready at each
    boundary, and a mid-stream set_block_size give a synchronous feed's
    count (re-blocking never changes a count)."""
    rng = np.random.default_rng(23)
    epochs = [rng.integers(0, 50, size=(int(m), 2)).astype(np.int32)
              for m in rng.integers(5, 60, size=6)]
    c = _counter()
    want = c.count_windowed(50, [[e] for e in epochs], window=3, block_size=16).item()
    s = c.open_stream(50, window=3, block_size=16)
    for t, e in enumerate(epochs):
        if t:
            tail = s.flush_ready()
            if tail is not None:
                s.ingest_ready(tail)
            s.expire_ready()
        if t == 3:
            for b in s.set_block_size(8):
                s.ingest_ready(b)
        for b in s.reblock(e):
            s.ingest_ready(b)
    assert s.finalize().item() == want and s.block_size == 8


# --------------------------------------------------------------------------
# Checkpoint / restore
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["dense", "sharded", "windowed"])
def test_randomized_preempt_restore_matches_the_uninterrupted_session(mode):
    """Random feed schedules, random checkpoint/restore points: the restored
    run ends bit-identical (count and state arrays) to the uninterrupted
    one, and both equal the reference's count."""
    p = Plan(method="stream", n_stages=3, block_size=32) if mode == "sharded" else None
    window = 3 if mode == "windowed" else None
    n, c = 96, _counter()
    ref_c = RefTriangleCounter()
    for seed in range(2):
        ops = _random_ops(n, 400, 100 + seed, windowed=mode == "windowed")
        rng = np.random.default_rng(1000 + seed)
        ckpt_at = {int(i) for i in rng.integers(0, len(ops), size=max(1, len(ops) // 4))}
        plain = _run_schedule(c, n, ops, plan=p, window=window)
        got = _run_schedule(c, n, ops, plan=p, window=window, ckpt_at=ckpt_at)
        ref_s = _run_schedule(ref_c, n, ops, window=window,
                              plan=None if p is None else RefPlan.from_dict(p.to_dict()))
        a, b = plain.finalize(), got.finalize()
        assert a.count.dtype == b.count.dtype == torch.int64
        assert a.item() == b.item() == ref_s.finalize().item()
        sa, sb = streaming.snapshot_state(plain.state), streaming.snapshot_state(got.state)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])
        assert got.restored and not plain.restored


def test_restore_adds_no_ingest_key_for_seen_shapes():
    c = _counter()
    s = c.open_stream(64, block_size=32)
    s.feed(_edges(64, 200, 1))
    before = streaming.ingest_trace_count()
    s2 = c.restore_stream(s.checkpoint())
    s2.feed(_edges(64, 200, 2))
    res = s2.finalize()
    assert streaming.ingest_trace_count() - before == 0
    assert res.stats["cache"]["hit"] is True


def test_checkpoint_counts_every_edge_fed_so_far():
    g = gen.gnp(48, 0.5, seed=3)
    c = _counter()
    s = c.open_stream(48, block_size=64)
    s.feed(g.edges)  # n_edges % 64 != 0: a tail is surely buffered
    ck = s.checkpoint()
    del s
    assert c.restore_stream(ck).finalize().item() == count_triangles_brute(g)
    assert ck.finalize_result().item() == count_triangles_brute(g)


def test_checkpoint_after_finalize_raises():
    s = _counter().open_stream(32)
    s.finalize()
    with pytest.raises(RuntimeError, match="finalized"):
        s.checkpoint()


def test_spill_roundtrip_and_from_file(tmp_path):
    e = _edges(64, 300, 7)
    c = _counter()
    s = c.open_stream(64, window=2)
    s.feed(e[:150])
    s.advance()
    s.feed(e[150:200])
    ck = s.checkpoint()
    assert ck.arrays["epochs"].dtype == np.uint32 and ck.arrays["counts"].dtype == np.int64
    path = str(tmp_path / "ck.npz")
    ck.spill(path)
    assert ck.spilled and os.path.exists(path) and ck.disk_bytes == os.path.getsize(path)
    ck.spill(path)  # idempotent
    ck2 = SessionCheckpoint.from_file(path)
    assert ck2.n_epochs_advanced == 1 and not ck2.spilled and ck2.plan == ck.plan
    s2 = c.restore_stream(ck2)
    s2.feed(e[200:])
    got = s2.finalize()
    oracle = RefTriangleCounter().count_windowed(64, [[e[:150]], [e[150:]]], window=2)
    assert got.item() == oracle.item()
    c.restore_stream(ck)  # the still-spilled original loads and deletes its file
    assert not os.path.exists(path)
    spare = c.open_stream(64).checkpoint()
    spare.spill(str(tmp_path / "spare.npz"))
    spare.discard()
    assert not os.path.exists(tmp_path / "spare.npz") and spare.arrays is None


def test_checkpoint_with_lost_endpoints_is_not_finalized():
    """A hybrid checkpoint (the reference's) that dropped edge endpoints
    holds an inexact count: finalizing it from the host arrays refuses."""
    ck = _counter().open_stream(20).checkpoint()
    ck.arrays = {**ck.arrays, "lost": np.array(3, np.int32)}
    with pytest.raises(RuntimeError, match="3 dropped edge endpoint"):
        ck.finalize_result()


@pytest.mark.parametrize("windowed", [False, True])
def test_reference_spill_restores_in_the_port(tmp_path, windowed):
    """A ``.npz`` the reference spilled (int32 counts, its own plan with
    ``use_kernel=False``) loads through the port's ``from_file``, restores
    on a CPU counter, and fed on ends at the reference's count; the port's
    spill goes back into the reference the same way (under x64, where the
    reference counts in int64)."""
    e = _edges(80, 500, 31)
    kw = {"window": 2} if windowed else {}
    ref_c = RefTriangleCounter()
    rs = ref_c.open_stream(80, block_size=32, **kw)
    rs.feed(e[:230])
    if windowed:
        rs.advance()
    rs.feed(e[230:300])
    path = str(tmp_path / "ref.npz")
    rck = rs.checkpoint()
    rck.spill(path)
    rs = ref_c.restore_stream(RefSessionCheckpoint.from_file(path))
    rs.feed(e[300:])
    want = rs.finalize()

    ck = SessionCheckpoint.from_file(path)
    key = "counts" if windowed else "count"
    assert ck.arrays[key].dtype == np.int32  # the reference without x64
    assert ck.finalize_result().count.dtype == torch.int64
    s = _counter().restore_stream(ck)
    assert s.state[key].dtype == torch.int64 and s.n_blocks == rck.n_blocks
    s.feed(e[300:])
    got = s.finalize()
    assert got.item() == want.item()
    mine, theirs = streaming.snapshot_state(s.state), rs.state
    for k in mine:
        np.testing.assert_array_equal(mine[k].astype(np.int64),
                                      np.asarray(theirs[k]).astype(np.int64))
    # the reverse: the port's spill, restored and finished by the reference
    s = _counter().restore_stream(ck)
    port_path = str(tmp_path / "port.npz")
    s.checkpoint().spill(port_path)
    with jax.enable_x64(True):
        back = RefTriangleCounter().restore_stream(RefSessionCheckpoint.from_file(port_path))
        back.feed(e[300:])
        assert int(np.asarray(back.finalize().count)) == want.item()


def test_checkpoint_that_contradicts_the_device_is_refused(tmp_path):
    e = _edges(40, 100, 3)
    s = _counter().open_stream(40, block_size=32)
    s.feed(e)
    ck = s.checkpoint()
    cuda_plan = Plan.from_dict({**ck.plan.to_dict(), "use_kernel": True, "interpret": False})
    bad = SessionCheckpoint(**{**ck.__dict__, "plan": cuda_plan})
    path = str(tmp_path / "bad.npz")
    bad.spill(path)
    c = _counter()
    with pytest.raises(ValueError, match="contradicts device cpu"):
        c.restore_stream(bad)
    assert os.path.exists(path)  # refused before the spill file was read
    with pytest.raises(ValueError, match="contradicts device cpu"):
        c.open_stream(40, plan=cuda_plan)
    with pytest.raises(ValueError, match="contradicts device cpu"):
        c.count_stream(40, [e], plan=plan(
            GraphStats(n_nodes=40, n_edges=0, replication_factor=0, max_degree=0,
                       max_fwd_degree=0, edges_in_memory=False), Resources(backend="cuda")))
    assert c.cache_info["entries"] == 0


def test_hybrid_plans_count_through_every_stream_route():
    """The hybrid state is ported: each route that refused a hybrid plan
    before (``open_stream``, ``count_stream``, ``count`` with a hybrid
    plan) now counts through it, to the reference's count. The planner
    still picks hybrid only when the bitset does not fit, and a windowed
    hybrid plan is still refused."""
    c = _counter()
    hyb = Plan(method="stream", state_layout="hybrid", hub_slots=16, tail_capacity=8,
               hub_threshold=8, block_size=64)
    e = _edges(100, 200, 17)
    ref_hyb = RefPlan(**{**hyb.to_dict(), "use_kernel": False, "interpret": True})
    want = RefTriangleCounter().count_stream(100, [e], plan=ref_hyb).item()
    assert want == count_triangles_brute(canonical_edges(e, 100)) > 0
    s = c.open_stream(100, plan=hyb)
    s.feed(e[:70])
    s.feed(e[70:])
    assert s.finalize().item() == want and s.state["hub_adj"].shape == (16, 4)
    assert 0 < int((s.state["hub_slot"] >= 0).sum()) <= 16  # promotions ran
    assert c.count_stream(100, [e], plan=hyb).item() == want
    g = graph_from_arrays(30, np.array([[0, 1], [1, 2], [0, 2]], np.int32))
    assert c.count(g, plan=hyb).item() == 1
    # the planner picks hybrid only when the bitset does not fit: small budget
    stats = GraphStats(n_nodes=200_000, n_edges=0, replication_factor=0, max_degree=0,
                       max_fwd_degree=0, edges_in_memory=False)
    assert plan(stats, Resources(memory_bytes=1 << 30)).state_layout == "hybrid"
    with pytest.raises(ValueError, match="hybrid"):
        c.open_stream(100, plan=Plan(method="stream", state_layout="hybrid", window_epochs=2))


def test_feed_rejects_bad_edges_at_session_front_door():
    s = _counter().open_stream(32)
    with pytest.raises(ValueError, match="integer"):
        s.feed(np.array([[1.5, 2.0]]))
    with pytest.raises(ValueError, match=r"\(B, 2\)"):
        s.feed(np.array([1, 2, 3], dtype=np.int32))
    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        s.feed(np.array([[0, 32]], dtype=np.int32))
    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        s.reblock(np.array([[-1, 3]], dtype=np.int32))
    s.feed(np.empty((0, 2), dtype=np.int32))  # empty feed is a no-op
    s.feed([])
    assert s.finalize().item() == 0


def test_session_state_bytes_and_device():
    c = _counter()
    for kw, shape in (({}, (100, 4)), ({"window": 3}, (3, 100, 4))):
        s = c.open_stream(100, **kw)
        words = s.state["epochs" if kw else "adj"]
        assert tuple(words.shape) == shape and words.device.type == "cpu"
        assert s.state_bytes == words.nbytes == 4 * int(np.prod(shape))
    s = _counter(plan=Plan(method="stream", n_stages=3)).open_stream(100)
    assert s.state_bytes == 3 * 100 * 2 * 4  # all three emulated shards


def test_stream_entry_points_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = [np.array([[0, 1]], np.int32)]
    for call in (lambda: TriangleCounter().open_stream(10),
                 lambda: TriangleCounter().count_stream(10, e),
                 lambda: TriangleCounter().count_windowed(10, [e], window=2),
                 lambda: TriangleCounter(device="cuda").restore_stream(None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    res = TriangleCounter(device="cpu").count_stream(10, e)
    assert res.item() == 0 and res.count.device.type == "cpu"
