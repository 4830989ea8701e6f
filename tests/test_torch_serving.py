"""The port's serving tier for streams (``repro_torch.serve.sessions``:
``StreamMultiplexer``, ``CheckpointStore``; the planner's ``admit_session``;
``TriangleServer``'s stream methods) against the reference's.

The same seeded scripts of ``open`` / ``feed`` / ``advance`` / ``preempt`` /
``checkpoint`` / ``evict`` / ``adopt`` / ``close`` / ``kill`` / ``reap`` —
with priorities, deadlines on an injected clock and small budgets — go
through ``repro.serve.sessions.StreamMultiplexer`` (the reference counter,
``Resources(backend="cpu")``) and the port's (``device="cpu"``): statuses,
admission verdicts and victims, every byte ledger, ``sched_stats``, the
``BackpressureError`` points and the checkpoint store's tiers must be equal
after every step, counts equal as integers and checkpoint arrays
bit-identical. The reference runs under ``jax.enable_x64(True)`` there, so
its counts are int64 like the port's and every snapshot charges the same
bytes (without x64 a count is 4 bytes narrower, ROADMAP.md §C).

Also the reference's own cases of ``tests/test_serve_sessions.py``,
``tests/test_preemptible_serving.py`` and the stream half of
``tests/test_streaming_and_serve.py`` on the port, seeded loops in place of
``hypothesis``. Their forced-8-device mesh cases are in
``tests/test_torch_mesh.py``; the single-session checkpoint cases are in
``tests/test_torch_sessions.py``. The card's
admission reserve (``card_reserve_bytes``) is pinned here on the CPU."""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import Resources as RefResources  # noqa: E402
from repro.api import TriangleCounter as RefTriangleCounter  # noqa: E402
from repro.api import admit_session as ref_admit_session  # noqa: E402
from repro.core.triangle_ref import count_triangles_brute  # noqa: E402
from repro.data.pipeline import GraphStreamPipeline  # noqa: E402
from repro.graphs import generators as gen  # noqa: E402
from repro.serve import StreamMultiplexer as RefStreamMultiplexer  # noqa: E402
from repro.serve.serve_loop import TriangleServer as RefTriangleServer  # noqa: E402
from repro_torch.api import (  # noqa: E402
    BackpressureError,
    Plan,
    Resources,
    TriangleCounter,
    admit_session,
    card_reserve_bytes,
    count_triangles,
    default_counter,
)
from repro_torch.api import planner  # noqa: E402
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.core.streaming import hybrid_state_nbytes  # noqa: E402
from repro_torch.serve import CheckpointStore, StreamMultiplexer, TriangleServer  # noqa: E402

# Two 256-node dense sessions (8 KB bitset each) fit; a third does not.
RES2 = Resources(memory_bytes=20480)


def _counter(res=None, **kw):
    return TriangleCounter(res or Resources(), device="cpu", **kw)


def _mux(res=RES2, **kw):
    return StreamMultiplexer(_counter(res), **kw)


def _edges(n, m, seed):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(m, 2), dtype=np.int32)
    return e[e[:, 0] != e[:, 1]]


def _noisy_stream(g, *, seed=0, block=31, dups=5, self_loops=2):
    """Shuffled ragged blocks with duplicate/self-loop noise the ingest must
    ignore (the reference test's stream)."""
    rng = np.random.default_rng(seed)
    edges = g.edges[rng.permutation(g.n_edges)]
    parts = [edges]
    if dups:
        parts.append(edges[rng.integers(0, g.n_edges, size=dups)])
    if self_loops:
        loops = rng.integers(0, g.n_nodes, size=self_loops)
        parts.append(np.stack([loops, loops], axis=1).astype(np.int32))
    stream = np.concatenate(parts)
    stream = stream[rng.permutation(len(stream))]
    return [stream[i:i + block] for i in range(0, len(stream), block)]


def _int(count) -> int:
    return int(np.asarray(count))


def _status(mux, sid) -> str:
    try:
        return mux.status(sid)
    except KeyError:  # evicted: the sid left this multiplexer
        return "evicted"


# --------------------------------------------------------------------------
# The seeded-script differential against the reference's multiplexer
# --------------------------------------------------------------------------
class _Pair:
    """One script through the reference's multiplexer and the port's: every
    call goes to both, and what they return or raise, and every ledger
    after it, must agree."""

    def __init__(self, tmp_path, *, memory_bytes=20480, **kw):
        self.now = [0.0]

        def clock():
            return self.now[0]

        spill = {}
        if kw.pop("spill", False):
            spill = {"ref": {"spill_dir": str(tmp_path / "ref")},
                     "port": {"spill_dir": str(tmp_path / "port")}}
        self.ref = RefStreamMultiplexer(
            RefTriangleCounter(RefResources(memory_bytes=memory_bytes)),
            clock=clock, **kw, **spill.get("ref", {}))
        self.port = StreamMultiplexer(
            _counter(Resources(memory_bytes=memory_bytes)), clock=clock, **kw,
            **spill.get("port", {}))
        self.sids: dict[int, tuple] = {}  # sid -> (n_nodes, window)
        self.results: dict[int, tuple] = {}

    def call(self, name, *args, port_args=None, **kw):
        out = []
        for mux, a in ((self.ref, args), (self.port, port_args or args)):
            try:
                out.append(("ok", getattr(mux, name)(*a, **kw)))
            except (BackpressureError, RuntimeError, ValueError, KeyError) as e:
                out.append(("raise", type(e).__name__))
        (ka, a), (kb, b) = out
        assert ka == kb, (name, args, out)
        if ka == "raise":
            assert a == b, (name, args, out)
        self.check()
        return ka, a, b

    def check(self):
        r, p = self.ref, self.port
        assert r.bytes_in_use == p.bytes_in_use
        assert r.queue_bytes == p.queue_bytes
        assert r.store.host_bytes == p.store.host_bytes
        assert len(r.store) == len(p.store)
        assert (r.n_active, r.n_queued, r.n_preempted) == \
            (p.n_active, p.n_queued, p.n_preempted)
        rs, ps = r.sched_stats, p.sched_stats
        for k in ("preemptions", "restores", "cancellations", "expirations",
                  "spills", "evictions", "spill_raw_bytes"):
            assert rs[k] == ps[k], k
        assert (rs["spill_disk_bytes"] > 0) == (ps["spill_disk_bytes"] > 0)
        assert r.next_sid() == p.next_sid()
        for sid in self.sids:
            assert _status(r, sid) == _status(p, sid), sid
            if _status(p, sid) == "evicted":
                continue
            assert r.state_bytes_of(sid) == p.state_bytes_of(sid), sid
            if sid in r.store:
                assert sid in p.store and r.store.where(sid) == p.store.where(sid)

    def open(self, n, **kw):
        kind, a, b = self.call("open", n, **kw)
        if kind == "ok":
            assert a == b
            self.sids[a] = (n, kw.get("window"))
            if self.ref.status(a) == "active":  # the admitted plans agree
                ra = self.ref._recs[a].session.plan.to_dict()
                pa = self.port._recs[a].session.plan.to_dict()
                assert ra == pa
        return a if kind == "ok" else None

    def close(self, sid):
        kind, a, b = self.call("close", sid)
        if kind == "ok":
            assert _int(a.count) == b.item()
            for k in ("cancelled", "expired", "restored", "preempts",
                      "from_checkpoint"):
                assert a.stats.get(k) == b.stats.get(k), k
            self.results[sid] = b.item()
        return kind

    def checkpoint_equal(self, a, b):
        """Bit-identical arrays, counts int64 on both sides (x64 on)."""
        assert sorted(a.arrays) == sorted(b.arrays)
        for k in a.arrays:
            x, y = np.asarray(a.arrays[k]), np.asarray(b.arrays[k])
            assert x.shape == y.shape and np.array_equal(x, y), k
            assert x.dtype == y.dtype, k
        assert (a.nbytes, a.state_bytes, a.block_size, a.n_blocks) == \
            (b.nbytes, b.state_bytes, b.block_size, b.n_blocks)


def _run_script(pair, seed, n_ops):
    rng = np.random.default_rng(seed)
    evicted = []
    for _ in range(n_ops):
        live = [s for s in pair.sids if pair.port.status(s) != "closed"]
        r = rng.random()
        if r < 0.17 or not live:
            n = int(rng.choice([64, 256]))
            pair.open(n, priority=int(rng.integers(0, 3)),
                      window=2 if rng.random() < 0.25 else None,
                      deadline_s=10.0 if rng.random() < 0.2 else None)
            continue
        sid = int(rng.choice(live))
        n, window = pair.sids[sid]
        if r < 0.55:
            pair.call("feed", sid, _edges(n, int(rng.integers(1, 90)),
                                          int(rng.integers(1 << 30))))
        elif r < 0.62:
            pair.call("advance", sid)
        elif r < 0.68:
            pair.call("preempt", sid)
        elif r < 0.73:
            kind, a, b = pair.call("checkpoint", sid)
            if kind == "ok":
                pair.checkpoint_equal(a, b)
        elif r < 0.77:
            kind, a, b = pair.call("evict", sid)
            if kind == "ok":
                pair.checkpoint_equal(a, b)
                evicted.append((a, b, n, window))
                pair.sids.pop(sid)
        elif r < 0.81 and evicted:
            a, b, n, window = evicted.pop(0)
            kind, sa, sb = pair.call("adopt", a, port_args=(b,),
                                     priority=int(rng.integers(0, 3)))
            if kind == "ok":
                assert sa == sb
                pair.sids[sa] = (n, window)
        elif r < 0.89:
            pair.close(sid)
        elif r < 0.92:
            kind, a, b = pair.call("kill", sid)
            assert kind != "ok" or (a.stats["cancelled"] and b.stats["cancelled"]
                                    and b.item() == 0)
        else:
            pair.now[0] += float(rng.choice([1.0, 6.0, 11.0]))
            pair.call("reap")
    for sid in list(pair.sids):
        if pair.port.status(sid) != "closed":
            # a parked session's close may need budget: close the actives first
            for other in sorted(pair.sids, key=lambda s: pair.port.status(s) != "active"):
                if pair.port.status(other) != "closed":
                    pair.close(other)
    assert pair.port.bytes_in_use == pair.ref.bytes_in_use == 0
    assert pair.port.queue_bytes == 0 and pair.port.store.host_bytes == 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_scripts_match_the_reference_multiplexer(tmp_path, seed):
    """Fair policy, a spill directory, a tight queue budget and deadlines:
    every verdict, victim, ledger and count equals the reference's."""
    with jax.enable_x64(True):
        pair = _Pair(tmp_path, block_size=64, queue_budget_bytes=2500,
                     checkpoint_budget_bytes=10_000, spill=True)
        _run_script(pair, 100 + seed, 90)
        assert sum(pair.results.values()) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_fifo_scripts_match_the_reference_multiplexer(tmp_path, seed):
    """``policy="fifo"`` with the ``"largest"`` eviction order."""
    with jax.enable_x64(True):
        pair = _Pair(tmp_path, block_size=64, policy="fifo", evict="largest",
                     checkpoint_budget_bytes=10_000, spill=True)
        _run_script(pair, 200 + seed, 60)


def test_hybrid_admission_matches_the_reference():
    """Past the bitset's reach both multiplexers admit the degree-aware
    hybrid state at the same plan, charged at the exact allocation formula:
    the port's is 4 bytes above the reference's without x64 (its count is
    int64, ROADMAP.md §C). Run without x64: the reference's JAX hybrid
    ingest compiles for minutes under it."""
    n = 4096
    e = _edges(n, 1500, 3)
    res_kw = dict(memory_bytes=1600 << 10)
    ref = RefStreamMultiplexer(RefTriangleCounter(RefResources(**res_kw)), block_size=64)
    port = _mux(Resources(**res_kw), block_size=64)
    a, b = ref.open(n), port.open(n)
    rp, pp = ref._recs[a].session.plan, port._recs[b].session.plan
    assert rp.to_dict() == {**pp.to_dict(), "predicted_bytes": pp.predicted_bytes - 4,
                            "reason": rp.reason}
    assert pp.state_layout == "hybrid"
    assert port.state_bytes_of(b) == ref.state_bytes_of(a) + 4 == hybrid_state_nbytes(
        n, pp.hub_slots, pp.tail_capacity)
    for i in range(0, len(e), 113):
        ref.feed(a, e[i:i + 113])
        port.feed(b, e[i:i + 113])
    x, y = ref.checkpoint(a), port.checkpoint(b)
    assert sorted(x.arrays) == sorted(y.arrays)
    for k in x.arrays:
        assert np.array_equal(np.asarray(x.arrays[k]), y.arrays[k]), k
    assert y.nbytes == x.nbytes + 4
    got, want = port.close(b).item(), _int(ref.close(a).count)
    assert got == want == _counter().count_stream(n, [e]).item()
    assert port.bytes_in_use == ref.bytes_in_use == 0
    ref_adm = ref_admit_session(n, RefResources(**res_kw))
    port_adm = admit_session(n, Resources(**res_kw))
    assert ref_adm.action == port_adm.action == "admit-hybrid"
    assert port_adm.state_bytes == ref_adm.state_bytes + 4


# --------------------------------------------------------------------------
# Interleaved == sequential (the reference's core parity contract)
# --------------------------------------------------------------------------
def test_interleaved_sessions_bit_identical_to_sequential():
    graphs = [gen.gnp(n, 0.4, seed=n) for n in (43, 49, 57, 63, 69)]
    blocks = [_noisy_stream(g, seed=i, block=19 + 4 * i)
              for i, g in enumerate(graphs)]
    seq = [_counter().count_stream(g.n_nodes, bs) for g, bs in zip(graphs, blocks)]
    inter = TriangleServer(device="cpu").serve_streams(
        [(g.n_nodes, bs) for g, bs in zip(graphs, blocks)])
    ref = RefTriangleServer().serve_streams(
        [(g.n_nodes, bs) for g, bs in zip(graphs, blocks)])
    for g, s, r, w in zip(graphs, seq, inter, ref):
        want = count_triangles_brute(g)
        assert s.item() == r.item() == _int(w.count) == want
        assert s.count.dtype == r.count.dtype == torch.int64
        assert r.stats["session"] is True


def test_interleaved_sharded_sessions_match_sequential():
    """Ring-sharded (emulated) sessions interleave like dense ones."""
    graphs = [gen.gnp(64, 0.5, seed=s) for s in (3, 5)]
    blocks = [_noisy_stream(g, seed=s, block=17) for s, g in enumerate(graphs)]
    c = _counter(plan=Plan(method="stream", n_stages=3, block_size=17))
    sessions = [c.open_stream(64) for _ in graphs]
    for j in range(max(len(b) for b in blocks)):  # round-robin, ragged tails
        for s, bs in zip(sessions, blocks):
            if j < len(bs):
                s.feed(bs[j])
    for g, s in zip(graphs, sessions):
        res = s.finalize()
        assert res.item() == count_triangles_brute(g)
        assert res.stats["sharded"] is True and res.stats["n_stages"] == 3


def test_four_sessions_one_ingest_key_per_block_shape():
    """The reference's acceptance pin, with the port's trace telemetry (the
    first uses of an ingest key): 4 concurrent sessions over one server,
    one block shape -> one new key shared by all of them, and sequential
    reruns add none."""
    n, block = 107, 23
    graphs = [gen.gnp(n, 0.3, seed=70 + s) for s in range(4)]
    blocks = [[g.edges[i:i + block] for i in range(0, g.n_edges, block)]
              for g in graphs]
    before = streaming.ingest_trace_count()
    server = TriangleServer(device="cpu")
    inter = server.serve_streams([(n, bs) for bs in blocks], block_size=block)
    assert streaming.ingest_trace_count() - before == 1
    for g, r, bs in zip(graphs, inter, blocks):
        assert r.item() == _counter().count_stream(n, bs, block_size=block).item() \
            == count_triangles_brute(g)
    before = streaming.ingest_trace_count()
    for bs in blocks:
        server.serve_stream(n, bs, block_size=block)
    assert streaming.ingest_trace_count() - before == 0
    skeys = [k for k in server.counter._seen if k[1][:2] == ("stream", n)]
    assert len(skeys) == 1 and server.counter._seen[skeys[0]] == 8


def test_session_finalize_idempotent_and_feed_after_close_raises():
    g = gen.gnp(38, 0.5, seed=2)
    s = _counter().open_stream(38, block_size=16)
    s.feed(g.edges)
    r1 = s.finalize()
    assert r1.item() == count_triangles_brute(g)
    assert s.finalize() is r1
    with pytest.raises(RuntimeError, match="finalized"):
        s.feed(g.edges[:4])


def test_session_ragged_feeds_reblock_to_fixed_shape():
    g = gen.gnp(71, 0.4, seed=9)
    s = _counter().open_stream(71, block_size=64)
    rng = np.random.default_rng(0)
    i = 0
    while i < g.n_edges:
        step = int(rng.integers(1, 150))
        s.feed(g.edges[i:i + step])
        i += step
    res = s.finalize()
    assert res.item() == count_triangles_brute(g)
    assert res.stats["n_blocks"] == -(-g.n_edges // 64)


def test_serve_stream_wrapper_rides_sessions():
    server = TriangleServer(device="cpu")
    g = gen.gnp(59, 0.4, seed=21)
    res = server.serve_stream(59, [g.edges[i:i + 25] for i in range(0, g.n_edges, 25)])
    assert res.item() == count_triangles_brute(g)
    assert res.plan.method == "stream" and res.stats["session"] is True
    assert server.streams.n_active == 0 and server.streams.bytes_in_use == 0


def test_server_stream_methods_follow_the_reference():
    """``open_stream`` / ``feed`` / ``advance_stream`` / ``preempt_stream``
    / ``stream_status`` / ``close_stream`` on both servers."""
    e = _edges(64, 300, 5)
    out = []
    for server in (RefTriangleServer(RefResources(memory_bytes=20480)),
                   TriangleServer(RES2, device="cpu")):
        a = server.open_stream(64, window=2, block_size=32)
        b = server.open_stream(256, priority=1)
        server.feed(a, e[:120])
        server.advance_stream(a)
        server.feed(a, e[120:])
        server.preempt_stream(a)
        st = [server.stream_status(s) for s in (a, b)]
        server.feed(b, _edges(256, 100, 6))
        out.append((st, _int(server.close_stream(a).count),
                    _int(server.close_stream(b).count), server.stream_status(a)))
    assert out[0] == out[1]
    assert out[1][0] == ["preempted", "active"] and out[1][3] == "closed"


# --------------------------------------------------------------------------
# Planner admission
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,res_kw", [
    (1000, {}),
    (100_000, dict(n_devices=8, memory_bytes=256 << 20)),
    (100_000, dict(n_devices=2, memory_bytes=64 << 20)),
    (100_000, dict(n_devices=2, memory_bytes=4 << 20)),
])
@pytest.mark.parametrize("window,prefetch", [(0, 0), (2, 0), (0, 2)])
def test_admission_regimes_equal_the_reference(n, res_kw, window, prefetch):
    with jax.enable_x64(True):
        ref = ref_admit_session(n, RefResources(**res_kw), window_epochs=window,
                                prefetch_depth=prefetch)
    port = admit_session(n, Resources(**res_kw), window_epochs=window,
                         prefetch_depth=prefetch)
    assert (ref.action, ref.state_bytes, ref.reason, ref.victims) == \
        (port.action, port.state_bytes, port.reason, port.victims)
    if ref.plan is None:
        assert port.plan is None
    else:
        assert ref.plan.to_dict() == port.plan.to_dict()


def test_admission_dense_sharded_queue_regimes():
    a = admit_session(1000, Resources())
    assert a.action == "admit-dense" and a.admitted
    assert a.plan.method == "stream" and a.plan.n_stages == 1
    assert a.state_bytes == 4 * 1000 * (-(-1000 // 32))
    a = admit_session(100_000, Resources(n_devices=8, memory_bytes=256 << 20))
    assert a.action == "admit-sharded"
    assert a.plan.n_stages > 1 and a.state_bytes <= 256 << 20
    a = admit_session(100_000, Resources(n_devices=2, memory_bytes=64 << 20))
    assert a.action == "admit-hybrid" and a.admitted
    assert a.plan.state_layout == "hybrid" and a.plan.n_stages == 1
    assert "hybrid" in a.reason and a.state_bytes <= 64 << 20
    a = admit_session(100_000, Resources(n_devices=2, memory_bytes=4 << 20))
    assert a.action == "queue" and not a.admitted and a.plan is None
    assert "hybrid" in a.reason


def test_admission_accounts_bytes_in_use():
    res = Resources(memory_bytes=20480)
    state = admit_session(256, res).state_bytes
    assert state == 8192
    assert admit_session(256, res, bytes_in_use=state).admitted
    assert admit_session(256, res, bytes_in_use=2 * state).action == "queue"


def test_preempt_verdict_names_the_reference_victims():
    actives = [(8192, 0), (8192, 2), (4096, 0), (8192, 1)]
    with jax.enable_x64(True):
        ref = ref_admit_session(256, RefResources(memory_bytes=20480),
                                bytes_in_use=20480, priority=2, actives=actives)
    port = admit_session(256, Resources(memory_bytes=20480), bytes_in_use=20480,
                         priority=2, actives=actives)
    assert port.action == ref.action == "preempt"
    assert port.victims == ref.victims == (0,)


# --------------------------------------------------------------------------
# Multiplexer admission: over-budget queues, FIFO replay
# --------------------------------------------------------------------------
def test_over_budget_session_queues_then_replays_exactly():
    mux = _mux(block_size=64)
    graphs = [gen.gnp(256, 0.05, seed=s) for s in range(3)]
    sids = [mux.open(256) for _ in graphs]
    assert [mux.status(s) for s in sids] == ["active", "active", "queued"]
    assert mux.bytes_in_use == 2 * 8192
    for start in range(0, max(g.n_edges for g in graphs), 64):
        for sid, g in zip(sids, graphs):
            if start < g.n_edges:
                mux.feed(sid, g.edges[start:start + 64])
    assert mux.status(sids[2]) == "queued"
    r0 = mux.close(sids[0])
    assert mux.status(sids[2]) == "active"
    r1, r2 = mux.close(sids[1]), mux.close(sids[2])
    for g, r in zip(graphs, (r0, r1, r2)):
        assert r.item() == count_triangles_brute(g)
    assert mux.bytes_in_use == 0
    assert mux.close(sids[2]) is r2
    with pytest.raises(RuntimeError, match="closed"):
        mux.feed(sids[2], graphs[2].edges[:4])


def test_emulated_sharding_does_not_discount_admission():
    """Without a mesh (``mesh_matches`` is False) the emulated shards all
    sit on one device, so the multiplexer re-takes the decision at ring
    width 1: the hybrid state, charged in full."""
    res = Resources(n_devices=8, memory_bytes=256 << 20)
    assert admit_session(100_000, res).action == "admit-sharded"
    counter = _counter(res)
    assert not counter.mesh_matches(8) and not counter.mesh_matches(1)
    mux = StreamMultiplexer(counter)
    sid = mux.open(100_000)
    rec = mux._recs[sid]
    p = rec.session.plan
    assert p.state_layout == "hybrid" and p.n_stages == 1
    want = hybrid_state_nbytes(100_000, p.hub_slots, p.tail_capacity)
    assert mux.bytes_in_use == want == rec.session.state_bytes
    assert want <= 256 << 20 < 4 * 100_000 * (-(-100_000 // 32))
    mux.close(sid)
    assert mux.bytes_in_use == 0


def test_never_fitting_stream_rejected_at_open_not_queued_forever():
    mux = _mux(block_size=64)
    with pytest.raises(ValueError, match="never be admitted"):
        mux.open(4096)
    a, b = mux.open(256), mux.open(256)
    waiting = mux.open(256)
    assert mux.status(waiting) == "queued"
    mux.close(a)
    assert mux.status(waiting) == "active"
    mux.close(b), mux.close(waiting)


def test_close_unknown_session_raises_with_message():
    mux = StreamMultiplexer(device="cpu")
    with pytest.raises(KeyError, match="unknown session"):
        mux.close(999)


def test_later_open_does_not_jump_queue():
    mux = _mux(block_size=64)
    big0, big1 = mux.open(256), mux.open(256)
    waiting = mux.open(256)
    tiny = mux.open(16)
    assert mux.status(waiting) == "queued" and mux.status(tiny) == "queued"
    mux.close(big0)
    assert mux.status(waiting) == "active"
    assert mux.status(tiny) == "active"
    for sid in (big1, waiting, tiny):
        mux.close(sid)


# --------------------------------------------------------------------------
# Front door, fair share and preemption (tests/test_preemptible_serving.py)
# --------------------------------------------------------------------------
def test_mux_feed_validates_waiting_sessions_too():
    mux = _mux()
    a, b = mux.open(256), mux.open(256)
    waiting = mux.open(256)
    with pytest.raises(ValueError, match=r"\[0, 256\)"):
        mux.feed(waiting, np.array([[0, 400]], dtype=np.int32))
    with pytest.raises(ValueError, match="integer"):
        mux.feed(waiting, np.array([[0.5, 1.0]]))
    for sid in (a, b, waiting):
        mux.close(sid)


def test_mux_open_validates_arguments():
    mux = _mux()
    with pytest.raises(ValueError, match="n_nodes"):
        mux.open(0)
    with pytest.raises(ValueError, match="n_nodes"):
        mux.open(-5)
    with pytest.raises(ValueError, match="window"):
        mux.open(64, window=0)
    with pytest.raises(ValueError, match="priority"):
        mux.open(64, priority=1.5)
    with pytest.raises(ValueError, match="deadline_s"):
        mux.open(64, deadline_s=0)
    with pytest.raises(ValueError, match="policy"):
        _mux(policy="lifo")
    with pytest.raises(ValueError, match="prefetch_depth"):
        _mux(prefetch_depth=0)


def test_priority_open_preempts_lowest_priority_active():
    g = [gen.gnp(256, 0.02, seed=s) for s in range(3)]
    counter = _counter(RES2)
    mux = StreamMultiplexer(counter, block_size=64)
    lo = mux.open(256, priority=0)
    mid = mux.open(256, priority=1)
    mux.feed(lo, g[0].edges)
    mux.feed(mid, g[1].edges)
    hi = mux.open(256, priority=5)
    assert mux.status(hi) == "active"
    assert mux.status(lo) == "preempted" and mux.status(mid) == "active"
    assert len(mux.store) == 1 and mux.sched_stats["preemptions"] == 1
    assert mux.bytes_in_use == 2 * 8192
    mux.feed(lo, g[0].edges[:32])
    mux.feed(hi, g[2].edges)
    r_hi = mux.close(hi)
    assert mux.status(lo) == "active" and mux.sched_stats["restores"] == 1
    r_lo, r_mid = mux.close(lo), mux.close(mid)
    assert r_hi.item() == count_triangles_brute(g[2])
    assert r_mid.item() == count_triangles_brute(g[1])
    oracle = counter.count_stream(256, [g[0].edges, g[0].edges[:32]], block_size=64)
    assert r_lo.item() == oracle.item()
    assert r_lo.stats["restored"] and r_lo.stats["preempts"] == 1


def test_equal_priority_never_preempts():
    mux = _mux()
    a, b = mux.open(256, priority=3), mux.open(256, priority=3)
    c = mux.open(256, priority=3)
    assert mux.status(c) == "queued"
    assert mux.sched_stats["preemptions"] == 0 and len(mux.store) == 0
    for sid in (a, b, c):
        mux.close(sid)


def test_fifo_policy_ignores_priority():
    mux = _mux(policy="fifo")
    a, b = mux.open(256), mux.open(256)
    hi = mux.open(256, priority=99)
    assert mux.status(hi) == "queued"
    assert mux.sched_stats["preemptions"] == 0
    mux.close(a)
    assert mux.status(hi) == "active"
    mux.close(b), mux.close(hi)


def test_explicit_preempt_and_errors():
    mux = _mux()
    a = mux.open(256)
    e = _edges(256, 100, 4)
    mux.feed(a, e)
    mux.preempt(a)
    assert mux.status(a) == "preempted" and mux.bytes_in_use == 0
    with pytest.raises(RuntimeError, match="preempted"):
        mux.preempt(a)
    mux.feed(a, e[:10])
    b = mux.open(256)
    assert mux.status(a) == "active" and mux.status(b) == "active"
    q = mux.open(256)
    assert mux.status(q) == "queued"
    with pytest.raises(RuntimeError, match="queued"):
        mux.preempt(q)
    with pytest.raises(KeyError, match="unknown"):
        mux.preempt(999)
    r = mux.close(a)
    assert r.item() == _counter().count_stream(256, [e, e[:10]]).item()
    mux.close(b), mux.close(q)
    with pytest.raises(RuntimeError, match="closed"):
        mux.preempt(a)


def test_close_preempted_finalizes_from_snapshot_without_device():
    g = gen.gnp(256, 0.03, seed=5)
    mux = _mux(block_size=64)
    a = mux.open(256, priority=1)
    b = mux.open(256, priority=1)
    mux.feed(a, g.edges)
    hi = mux.open(256, priority=5)
    assert mux.status(a) == "preempted"
    r = mux.close(a)
    assert r.item() == count_triangles_brute(g)
    assert r.stats["from_checkpoint"] and not r.stats["restored"]
    assert mux.bytes_in_use == 2 * 8192
    mux.close(b), mux.close(hi)


def test_close_preempted_with_pending_feeds_restores_or_backpressures():
    g = gen.gnp(256, 0.03, seed=6)
    mux = _mux(block_size=64)
    a = mux.open(256, priority=1)
    b = mux.open(256, priority=1)
    mux.feed(a, g.edges[:100])
    hi = mux.open(256, priority=5)
    assert mux.status(a) == "preempted"
    mux.feed(a, g.edges[100:])
    with pytest.raises(BackpressureError, match="restore"):
        mux.close(a)
    assert mux.status(a) == "preempted"
    mux.close(hi)
    assert mux.status(a) == "active"
    r = mux.close(a)
    assert r.item() == count_triangles_brute(g)
    assert r.stats["restored"]
    mux.close(b)


def test_next_sid_fair_share_ordering():
    res = Resources(memory_bytes=65536)
    mux = _mux(res)
    s0, s1 = mux.open(128), mux.open(128)
    s2 = mux.open(128, priority=2)
    assert mux.next_sid() == s2
    e = _edges(128, 8, 6)
    mux.feed(s0, e)
    assert mux.next_sid(candidates={s0, s1}) == s1
    mux.feed(s1, e)
    assert mux.next_sid(candidates={s0, s1}) == s0
    fifo = _mux(res, policy="fifo")
    f0, f1 = fifo.open(128), fifo.open(128, priority=9)
    assert fifo.next_sid() == f0
    for m, sids in ((mux, (s0, s1, s2)), (fifo, (f0, f1))):
        for sid in sids:
            m.close(sid)
    assert mux.next_sid() is None


def test_queued_close_cancels_gracefully_and_stays_idempotent():
    mux = _mux()
    a, b = mux.open(256), mux.open(256)
    q = mux.open(256)
    mux.feed(q, _edges(256, 50, 8))
    assert mux.queue_bytes > 0
    r = mux.close(q)
    assert r.stats["cancelled"] and r.item() == 0 and r.plan is None
    assert r.count.dtype == torch.int64 and r.count.device == mux.counter.device
    assert mux.status(q) == "closed" and mux.queue_bytes == 0
    assert mux.close(q) is r
    assert mux.sched_stats["cancellations"] == 1
    with pytest.raises(RuntimeError, match="closed"):
        mux.feed(q, _edges(256, 4, 9))
    with pytest.raises(RuntimeError, match="closed"):
        mux.advance(q)
    mux.close(a), mux.close(b)


def test_lifecycle_error_paths():
    mux = _mux()
    a = mux.open(256)
    with pytest.raises(RuntimeError, match="windowed"):
        mux.advance(a)
    b, q = mux.open(256), mux.open(256)
    with pytest.raises(RuntimeError, match="windowed"):
        mux.advance(q)
    with pytest.raises(KeyError, match="unknown"):
        mux.feed(999, _edges(256, 2, 1))
    for op in (mux.advance, mux.close, mux.status):
        with pytest.raises(KeyError, match="unknown"):
            op(999)
    for sid in (a, b, q):
        mux.close(sid)


# --------------------------------------------------------------------------
# Bounded backpressure (queue budget, checkpoint store, spill)
# --------------------------------------------------------------------------
def test_waiting_feed_budget_backpressure():
    mux = _mux(queue_budget_bytes=256)
    a, b = mux.open(256), mux.open(256)
    q = mux.open(256)
    mux.feed(q, _edges(256, 20, 11))
    with pytest.raises(BackpressureError, match="budget"):
        mux.feed(q, _edges(256, 20, 12))
    mux.feed(q, _edges(256, 5, 13))
    r_a = mux.close(a)
    assert mux.status(q) == "active" and mux.queue_bytes == 0
    mux.feed(q, _edges(256, 500, 14))
    for sid in (b, q):
        mux.close(sid)
    assert r_a.item() == 0


def test_checkpoint_store_budget_backpressure():
    mux = _mux(checkpoint_budget_bytes=64)
    a = mux.open(256)
    with pytest.raises(BackpressureError, match="checkpoint store"):
        mux.preempt(a)
    assert mux.status(a) == "active" and mux.bytes_in_use == 8192
    assert len(mux.store) == 0 and mux.sched_stats["preemptions"] == 0
    mux.close(a)


def test_priority_open_queues_when_store_cannot_hold_victims():
    mux = _mux(checkpoint_budget_bytes=64)
    a, b = mux.open(256), mux.open(256)
    hi = mux.open(256, priority=5)
    assert mux.status(hi) == "queued"
    assert mux.status(a) == "active" and mux.status(b) == "active"
    assert len(mux.store) == 0
    for sid in (a, b, hi):
        mux.close(sid)


def test_checkpoint_store_spills_to_disk(tmp_path):
    g0, g1 = (gen.gnp(256, 0.03, seed=s) for s in (20, 21))
    store_dir = str(tmp_path / "spill")
    mux = _mux(block_size=64, checkpoint_budget_bytes=10_000, spill_dir=store_dir)
    a, b = mux.open(256), mux.open(256)
    mux.feed(a, g0.edges)
    mux.feed(b, g1.edges)
    mux.preempt(a)
    mux.preempt(b)
    assert mux.store.n_spills == 1 and mux.store.spill_bytes > 0
    assert len(os.listdir(store_dir)) == 1
    r_a = mux.close(a)
    r_b = mux.close(b)
    assert r_a.item() == count_triangles_brute(g0)
    assert r_b.item() == count_triangles_brute(g1)
    assert os.listdir(store_dir) == []
    assert mux.store.host_bytes == 0 and mux.store.spill_bytes == 0
    mux2 = _mux(checkpoint_budget_bytes=10_000)
    c, d = mux2.open(256), mux2.open(256)
    mux2.preempt(c)
    with pytest.raises(BackpressureError, match="spill"):
        mux2.preempt(d)
    mux2.close(c), mux2.close(d)


# --------------------------------------------------------------------------
# Deadlines: abandoned sessions decay active -> parked -> cancelled
# --------------------------------------------------------------------------
def test_deadline_reaps_idle_sessions_in_two_steps():
    now = [0.0]
    g = gen.gnp(256, 0.03, seed=30)
    mux = _mux(block_size=64, clock=lambda: now[0])
    a = mux.open(256, deadline_s=10)
    keep = mux.open(256)
    mux.feed(a, g.edges)
    now[0] = 5.0
    mux.reap()
    assert mux.status(a) == "active"
    now[0] = 16.0
    mux.reap()
    assert mux.status(a) == "preempted" and mux.bytes_in_use == 8192
    assert mux.close(a).item() == count_triangles_brute(g)
    b = mux.open(256, deadline_s=10)
    now[0] = 30.0
    mux.reap()
    assert mux.status(b) == "preempted"
    now[0] = 45.0
    mux.reap()
    r = mux.close(b)
    assert r.stats["cancelled"] and r.stats["expired"]
    assert mux.sched_stats["expirations"] == 1 and len(mux.store) == 0
    assert mux.status(keep) == "active"
    mux.close(keep)


def test_deadline_expiry_frees_budget_for_waiters():
    now = [0.0]
    mux = _mux(clock=lambda: now[0])
    a = mux.open(256, deadline_s=5)
    b = mux.open(256)
    q = mux.open(256)
    assert mux.status(q) == "queued"
    now[0] = 6.0
    mux.reap()
    assert mux.status(a) == "preempted" and mux.status(q) == "active"
    for sid in (a, b, q):
        mux.close(sid)


# --------------------------------------------------------------------------
# CheckpointStore unit behavior
# --------------------------------------------------------------------------
def _fresh_ckpts(counter, k, *, n=64, m=50, seed0=0):
    out = []
    for seed in range(seed0, seed0 + k):
        s = counter.open_stream(n)
        s.feed(_edges(n, m, seed))
        out.append(s.checkpoint())
    return out


def test_checkpoint_store_put_all_is_transactional():
    cks = _fresh_ckpts(_counter(), 3)
    one = cks[0].nbytes
    store = CheckpointStore(host_budget_bytes=2 * one)
    with pytest.raises(BackpressureError):
        store.put_all(list(enumerate(cks)))
    assert len(store) == 0 and store.host_bytes == 0
    store.put_all(list(enumerate(cks[:2])))
    assert len(store) == 2 and store.host_bytes == 2 * one
    assert 0 in store and 2 not in store
    back = store.take(0)
    assert back is cks[0] and store.host_bytes == one
    store.drop(1)
    assert len(store) == 0 and store.host_bytes == 0


def test_checkpoint_store_evicts_lru_to_disk_before_raising(tmp_path):
    counter = _counter()
    cks = _fresh_ckpts(counter, 3)
    one = cks[0].nbytes
    store = CheckpointStore(2 * one, spill_dir=str(tmp_path / "sp"))
    store.put(0, cks[0])
    store.put(1, cks[1])
    assert store.where(0) == "host" and store.where(1) == "host"
    store.put(2, cks[2])
    assert store.where(0) == "disk"
    assert store.where(1) == "host" and store.where(2) == "host"
    assert store.n_evictions == 1 and store.n_spills == 1
    assert cks[0].spilled and os.path.exists(cks[0].path)
    assert store.host_bytes == 2 * one
    assert store.spill_bytes == os.path.getsize(cks[0].path)
    back = store.take(0)
    assert back.load_arrays()["count"].dtype == np.int64
    assert store.spill_bytes == 0 and len(os.listdir(tmp_path / "sp")) == 0
    more = _fresh_ckpts(counter, 2, seed0=10)
    tight = CheckpointStore(one, spill_dir=str(tmp_path / "sp2"), spill_budget_bytes=1)
    tight.put(0, more[0])
    with pytest.raises(BackpressureError, match="checkpoint store full"):
        tight.put(1, more[1])
    assert tight.where(0) == "host" and not more[0].spilled
    assert len(tight) == 1 and tight.spill_bytes == 0
    assert os.listdir(tmp_path / "sp2") == []


def test_checkpoint_store_eviction_policy_knob(tmp_path):
    counter = _counter()
    for policy, expect_disk in (("lru", 0), ("largest", 1)):
        (small,) = _fresh_ckpts(counter, 1, n=64, m=50, seed0=60)
        (big,) = _fresh_ckpts(counter, 1, n=256, m=300, seed0=61)
        (new,) = _fresh_ckpts(counter, 1, n=64, m=50, seed0=62)
        assert big.nbytes > small.nbytes == new.nbytes
        store = CheckpointStore(big.nbytes + small.nbytes,
                                spill_dir=str(tmp_path / f"sp-{policy}"), evict=policy)
        store.put(0, small)
        store.put(1, big)
        store.put(2, new)
        assert store.where(expect_disk) == "disk"
        assert [s for s in (0, 1) if s != expect_disk] \
            == [s for s in (0, 1) if store.where(s) == "host"]
        assert store.where(2) == "host"
        held = {s: store._held[s] for s in (0, 1, 2)}
        assert store.host_bytes == sum(h[2] for h in held.values() if h[1] == "host")
        assert store.spill_bytes == sum(h[2] for h in held.values() if h[1] == "disk")
        assert store.spill_bytes == sum(
            os.path.getsize(os.path.join(str(tmp_path / f"sp-{policy}"), f))
            for f in os.listdir(tmp_path / f"sp-{policy}"))
        for sid in (0, 1, 2):
            store.take(sid).load_arrays()
        assert store.host_bytes == 0 and store.spill_bytes == 0
        assert store.spill_raw_bytes == 0 and len(store) == 0
    with pytest.raises(ValueError, match="evict"):
        CheckpointStore(1024, evict="random")
    with pytest.raises(ValueError, match="evict"):
        _mux(evict="mru")


def test_spill_compression_charges_disk_bytes(tmp_path):
    g0, g1 = (gen.gnp(256, 0.03, seed=s) for s in (40, 41))
    mux = _mux(block_size=64, checkpoint_budget_bytes=10_000,
               spill_dir=str(tmp_path / "sp"))
    a, b = mux.open(256), mux.open(256)
    mux.feed(a, g0.edges)
    mux.feed(b, g1.edges)
    mux.preempt(a)
    mux.preempt(b)
    (fname,) = os.listdir(tmp_path / "sp")
    on_disk = os.path.getsize(tmp_path / "sp" / fname)
    (sid_disk,) = [s for s in (a, b) if mux.store.where(s) == "disk"]
    raw = mux.store._held[sid_disk][0].nbytes
    assert mux.store.spill_bytes == on_disk
    assert on_disk < mux.store.spill_raw_bytes == raw
    st = mux.sched_stats
    assert st["spills"] == 1
    assert st["spill_disk_bytes"] == on_disk
    assert st["spill_raw_bytes"] == raw
    assert st["spill_compression"] > 2.0
    assert mux.close(a).item() == count_triangles_brute(g0)
    assert mux.close(b).item() == count_triangles_brute(g1)
    assert mux.sched_stats["spill_compression"] == 1.0


def test_reference_checkpoint_is_adopted_by_the_port(tmp_path):
    """Migration between the packages: a session evicted from the
    reference's multiplexer is adopted by the port's and finishes to the
    same count (its int32 count widened on restore)."""
    g = gen.gnp(256, 0.05, seed=50)
    ref = RefStreamMultiplexer(RefTriangleCounter(RefResources(memory_bytes=20480)),
                               block_size=64)
    a = ref.open(256, window=2)
    ref.feed(a, g.edges[:400])
    ref.advance(a)
    ck = ref.evict(a)
    path = str(tmp_path / "ref.npz")
    ck.spill(path)
    from repro_torch.api import SessionCheckpoint

    mux = _mux(block_size=64)
    sid = mux.adopt(SessionCheckpoint.from_file(path), priority=1)
    assert mux.status(sid) == "active" and mux.state_bytes_of(sid) == 2 * 8192
    mux.feed(sid, g.edges[400:])
    got = mux.close(sid).item()
    want = _counter().count_windowed(256, [[g.edges[:400]], [g.edges[400:]]], window=2)
    assert got == want.item()
    path = _evict_and_spill(tmp_path, ref, g)
    full = _mux()
    full.open(256), full.open(256)
    with pytest.raises(BackpressureError, match="adopt"):
        full.adopt(SessionCheckpoint.from_file(path))


def _evict_and_spill(tmp_path, ref, g):
    b = ref.open(256, window=2)
    ref.feed(b, g.edges[:100])
    ck = ref.evict(b)
    path = str(tmp_path / "ref2.npz")
    ck.spill(path)
    return path


# --------------------------------------------------------------------------
# The card's admission reserve (a deliberate difference, ROADMAP.md §C)
# --------------------------------------------------------------------------
def test_card_reserve_is_the_ingest_scratch_of_the_largest_session():
    """``card_reserve_bytes``: the fixed share, the largest one ingest's
    scratch and every session's in-flight blocks — at NY's size the (n, W)
    delta table dominates it."""
    n_ny = 264_196
    w = -(-n_ny // 32)
    ny = Plan(method="stream", block_size=32768)
    scratch = planner.ingest_scratch_bytes(n_ny, ny)
    assert scratch == 4 * n_ny * w + planner._CARD_ROW_BYTES * 32768
    assert 4 * n_ny * w == 8_725_865_488  # NY's 8.73 GB delta table
    small = Plan(method="stream", block_size=1000, prefetch_depth=2)
    assert planner.prefetch_inflight_bytes(small) == 3 * 1024 * 8
    got = card_reserve_bytes([(n_ny, ny), (500, small)])
    assert got == (planner._CARD_FIXED_BYTES + scratch
                   + planner.prefetch_inflight_bytes(ny)
                   + planner.prefetch_inflight_bytes(small))
    assert card_reserve_bytes([]) == planner._CARD_FIXED_BYTES
    # windowed: every stage's E age-cumulative tables; hybrid: its tables
    win = Plan(method="stream", block_size=64, window_epochs=3, n_stages=2)
    ws = -(-(-(-100 // 32)) // 2)
    assert planner.ingest_scratch_bytes(100, win) == \
        4 * 100 * ws * (1 + 3 * 2) + planner._CARD_ROW_BYTES * 64
    hyb = Plan(method="stream", block_size=8192, state_layout="hybrid",
               hub_slots=64, tail_capacity=64, hub_threshold=64)
    assert planner.ingest_scratch_bytes(1_134_890, hyb) > 4 * 2 * 8192 * (-(-1_134_890 // 32))


def test_card_admission_charges_the_ingest_reserve_cpu_does_not(monkeypatch):
    """On a ``cuda`` counter the multiplexer never admits a set whose
    states plus one ingest's scratch exceed the budget; on the CPU its
    verdicts are the reference's (no reserve). Run here by marking a CPU
    multiplexer as on the card, with the fixed share set to 0."""
    monkeypatch.setattr(planner, "_CARD_FIXED_BYTES", 0)
    n, bs = 2048, 64
    state = 4 * n * (n // 32)              # 512 KB bitset
    budget = 3 * state + state // 2        # 3 states by state bytes alone
    plain = _mux(Resources(memory_bytes=budget), block_size=bs)
    card = _mux(Resources(memory_bytes=budget), block_size=bs)
    card._on_card = True
    got = {}
    for name, mux in (("plain", plain), ("card", card)):
        sids = []
        while True:
            sids.append(mux.open(n))
            if mux.status(sids[-1]) == "queued":
                break
        got[name] = [mux._recs[s].session.plan.state_layout
                     for s in sids if mux.status(s) == "active"]
        active = [mux._recs[s] for s in sids if mux.status(s) == "active"]
        pinned = sum(r.state_bytes for r in active)
        scratch = max(planner.ingest_scratch_bytes(n, r.plan) for r in active)
        if name == "card":
            assert pinned + scratch + sum(planner.prefetch_inflight_bytes(r.plan)
                                          for r in active) <= budget
            assert mux.reserve_bytes == card_reserve_bytes(
                [(n, r.plan) for r in active])
        else:
            assert mux.reserve_bytes == 0
            assert pinned + scratch > budget  # what the reserve prevents
    with jax.enable_x64(True):
        ref = RefStreamMultiplexer(RefTriangleCounter(RefResources(memory_bytes=budget)),
                                   block_size=bs)
        ref_layouts = []
        while True:
            s = ref.open(n)
            if ref.status(s) == "queued":
                break
            ref_layouts.append(ref._recs[s].session.plan.state_layout)
    assert got["plain"] == ref_layouts == ["bitset"] * 3
    assert got["card"] == ["bitset", "bitset"]


def test_a_card_multiplexer_turns_expandable_segments_on(monkeypatch):
    """The first session a multiplexer on the card activates turns the
    caching allocator's expandable segments on, so the memory that closed
    sessions free serves any later state; a CPU multiplexer leaves the
    allocator alone, the cudaMallocAsync backend is left as it is, and a
    process that turned the segments off is refused."""
    from repro_torch.serve import sessions

    calls = []
    monkeypatch.setattr(sessions, "expandable_segments", lambda: calls.append("on"))
    mux = _mux()
    mux.close(mux.open(256))
    mux.adopt(_counter(RES2).open_stream(256).checkpoint())
    assert calls == []
    monkeypatch.undo()
    settings = []
    monkeypatch.setattr(torch.cuda, "get_allocator_backend", lambda: "native")
    monkeypatch.setattr(torch._C, "_accelerator_setAllocatorSettings", settings.append,
                        raising=False)
    for var in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"):
        monkeypatch.setenv(var, "max_split_size_mb:64")
    sessions.expandable_segments()
    assert settings == ["expandable_segments:True"]
    monkeypatch.setattr(torch.cuda, "get_allocator_backend", lambda: "cudaMallocAsync")
    sessions.expandable_segments()
    assert settings == ["expandable_segments:True"]
    for var in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"):
        monkeypatch.setenv(var, "max_split_size_mb:64, expandable_segments:False")
        with pytest.raises(RuntimeError, match="turns expandable segments off"):
            sessions.expandable_segments()
        monkeypatch.setenv(var, "")
    assert settings == ["expandable_segments:True"]


# --------------------------------------------------------------------------
# The count_triangles shim, default_counter, utilities
# --------------------------------------------------------------------------
def test_count_triangles_shares_the_default_counter_and_refuses_other_kwargs():
    """The shim keeps one counter per device and takes plan fields. The
    reference's legacy ring kwargs (``sequential=``, ``mesh=``) fall through
    to the ring entry points, as in the reference, without touching the
    default counter; for any other method, and for any other keyword, the
    shim raises ``TypeError``."""
    g = graph_from_arrays(60, gen.gnp(60, 0.4, seed=4).edges)
    want = count_triangles_brute(gen.gnp(60, 0.4, seed=4))
    c = default_counter("cpu")
    assert default_counter(torch.device("cpu")) is c
    uses = sum(c._seen.values())
    assert count_triangles(g, device="cpu") == want
    assert count_triangles(g, method="dense", device="cpu") == want
    assert count_triangles(g, method="ring", n_stages=2, device="cpu") == want
    assert sum(c._seen.values()) == uses + 3
    for method in ("ring", "bitset"):
        assert count_triangles(g, method=method, sequential=True, device="cpu") == want
        assert count_triangles(g, method=method, n_stages=3, mesh=None,
                               device="cpu") == want
    assert sum(c._seen.values()) == uses + 3
    for method, kw in (("sparse", {"sequential": True}), ("dense", {"mesh": None}),
                       ("ring", {"dtype": "uint8"})):
        with pytest.raises(TypeError, match=next(iter(kw))):
            count_triangles(g, method=method, device="cpu", **kw)


def test_mesh_kwarg_raises_until_the_multi_device_rings():
    """``mesh=`` routes to the ring (ROADMAP.md, queue A item 5): through
    the shim to the ring entry points, and through the counter, whose
    ``mesh_matches`` answers from its mesh — a mesh of more than one stage,
    of the plan's width."""
    from repro_torch.core import dynamic_pipeline
    from repro_torch.launch import make_ring_mesh

    g = graph_from_arrays(30, gen.gnp(30, 0.4, seed=1).edges)
    want = count_triangles_brute(gen.gnp(30, 0.4, seed=1))
    mesh = make_ring_mesh(4, devices=["cpu"] * 4)
    runs = []
    plain_run = dynamic_pipeline.DynamicPipeline.run

    def counted(self, spec, resident, stream):
        runs.append(self.mesh)
        return plain_run(self, spec, resident, stream)

    dynamic_pipeline.DynamicPipeline.run = counted
    try:
        for method in ("ring", "bitset"):
            assert count_triangles(g, method=method, mesh=mesh) == want
        assert runs == [mesh, mesh]
        c = _counter(Resources(n_devices=4), mesh=mesh)
        assert c.count(g, plan=Plan(method="ring", n_stages=4)).item() == want
        assert len(runs) == 3
    finally:
        dynamic_pipeline.DynamicPipeline.run = plain_run
    with pytest.raises(TypeError, match="mesh"):
        count_triangles(g, method="dense", mesh=mesh, device="cpu")
    assert not _counter().mesh_matches(4)
    assert c.mesh_matches(4) and not c.mesh_matches(2) and not c.mesh_matches(1)
    assert not _counter(mesh=make_ring_mesh(1, devices=["cpu"])).mesh_matches(1)


def test_adaptive_block_sizer_equals_the_reference():
    from repro.core.streaming import AdaptiveBlockSizer as RefSizer

    rng = np.random.default_rng(7)
    for plan_block in (100, 4096, 65536, 1 << 20):
        ref, port = RefSizer(plan_block), streaming.AdaptiveBlockSizer(plan_block)
        assert (ref.hi, ref.lo, ref.size) == (port.hi, port.lo, port.size)
        for _ in range(300):
            walls = float(rng.choice([1e-3, 10e-3, 50e-3]))
            rows = int(rng.integers(0, 5000))
            assert ref.observe(rows, walls) == port.observe(rows, walls)
            assert ref.size == port.size


def test_propagating_thread_reraises_on_join():
    from repro_torch.utils import PropagatingThread

    def boom():
        raise ValueError("from the thread")

    t = PropagatingThread(target=boom)
    t.start()
    with pytest.raises(ValueError, match="from the thread"):
        t.join(10)
    t.join(0)  # the exception is raised once


# --------------------------------------------------------------------------
# The stream half of tests/test_streaming_and_serve.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_streaming_count_exact_any_blocking(seed):
    """Seeded draws in place of the reference's property test: the stream
    count is exact for any block size and edge order, duplicates included,
    and a ragged stream pads to one fixed shape (at most one new key)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 49))
    g = gen.gnp(n, float(rng.uniform(0.05, 0.9)), seed=int(rng.integers(10_000)))
    block = int(rng.integers(1, 65))
    edges = g.edges[rng.permutation(g.n_edges)]
    if g.n_edges:
        edges = np.concatenate([edges, edges[rng.integers(0, g.n_edges,
                                                          size=min(5, g.n_edges))]])
    blocks = [edges[i:i + block] for i in range(0, len(edges), block)]
    before = streaming.ingest_trace_count()
    assert streaming.count_stream(n, blocks, device="cpu") == count_triangles_brute(g)
    assert streaming.ingest_trace_count() - before <= 1


def test_streaming_from_pipeline():
    pipe = GraphStreamPipeline(n_nodes=200, density=0.2, seed=3)
    want = count_triangles_brute(gen.gnp(200, 0.2, seed=3))
    got = streaming.count_stream(200, pipe.edge_stream(block_size=1000), device="cpu")
    assert got == want
    res = _counter().count_stream(200, pipe.edge_stream(block_size=1000))
    assert res.item() == want and res.plan.method == "stream"


def test_admission_records_the_prefetch_depth_outside_the_cache_key():
    a = admit_session(1000, Resources(), prefetch_depth=3)
    b = admit_session(1000, Resources())
    assert a.plan.prefetch_depth == 3 and b.plan.prefetch_depth == 0
    assert a.plan.cache_key() == dataclasses.replace(b.plan, block_size=a.plan.block_size).cache_key()
