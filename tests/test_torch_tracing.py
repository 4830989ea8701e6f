"""The port's tracer (``repro_torch.tracing``) on the stream-serving path,
on the CPU: spans nest under ``TriangleServer``'s calls with the parent
ids and session ids of the work they time, nothing is recorded while the
tracer is off, the counters equal what the host knows from shapes and
lengths, and tracing changes no count and reads no tensor."""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.api import Plan, Resources, TriangleCounter
from repro_torch.core import streaming
from repro_torch.core.triangle_ref import count_triangles_brute
from repro_torch.graphs import generators as gen
from repro_torch.serve import StreamMultiplexer, TriangleServer

N, BLOCK, FEED = 100, 64, 37
NAME, START, END, ID, PARENT, SID, THREAD = range(7)


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _serve(server, g, *, block=BLOCK, feed=FEED):
    """One session through the server: open, ragged feeds, close, count."""
    sid = server.open_stream(g.n_nodes, block_size=block)
    for i in range(0, g.n_edges, feed):
        server.feed(sid, g.edges[i:i + feed])
    result = server.close_stream(sid)
    return sid, result, result.item()


def _traced(fn):
    """``fn()`` with the tracer on: (its value, spans, counters)."""
    tracing.enable()
    try:
        out = fn()
    finally:
        tracing.disable()
    spans, counters = tracing.drain()
    return out, spans, counters


def _parents(spans):
    by_id = {s[ID]: s for s in spans}
    return lambda s: by_id[s[PARENT]][NAME] if s[PARENT] else None


def _seconds(s) -> float:
    return (s[END] - s[START]) / 1e9


def test_spans_nest_under_the_server_calls_with_their_session_ids():
    server = TriangleServer(device="cpu")
    g = gen.gnp(N, 0.3, seed=1)
    (sid, result, _), spans, _ = _traced(lambda: _serve(server, g))
    parent = _parents(spans)
    by_id = {s[ID]: s for s in spans}
    for s in spans:  # a child lies inside its parent, on the parent's thread
        if s[PARENT]:
            p = by_id[s[PARENT]]
            assert p[START] <= s[START] <= s[END] <= p[END] and p[THREAD] == s[THREAD]
    named = {}
    for s in spans:
        named.setdefault(s[NAME], []).append(s)
    assert [s[PARENT] for s in named["mux.open"]] == [0]
    for name in ("mux.admission", "session.alloc", "mux.replay"):
        assert [parent(s) for s in named[name]] == ["mux.open"]
    n_feeds = -(-g.n_edges // FEED)
    assert len(named["mux.feed"]) == n_feeds
    assert {parent(s) for s in named["ingest.validate"]} == {"mux.feed"}
    assert {parent(s) for s in named["ingest.reblock"]} == {"mux.feed", "ingest.tail"}
    assert [parent(s) for s in named["ingest.tail"]] == ["mux.close"]
    assert {parent(s) for s in named["ingest.block"]} == {"mux.feed", "ingest.tail"}
    assert len(named["ingest.block"]) == result.stats["n_blocks"] == -(-g.n_edges // BLOCK)
    assert "mux.close" in {parent(s) for s in named["mux.admit_pending"]}
    assert [s[PARENT] for s in named["count.wait"]] == [0]
    # the session's id, given or inherited, on all of its work; the sweep
    # for waiters works for other sessions and carries none
    for s in spans:
        if s[NAME] in ("count.wait", "mux.admit_pending"):
            assert s[SID] is None
        else:
            assert s[SID] == sid, s


def test_a_queued_session_is_timed_from_open_to_admission():
    """Two 256-node bitset sessions fit the budget, a third waits: its
    ``mux.queued`` span runs from its open to the close that admitted it,
    and its allocation and replay run under that close."""
    server = TriangleServer(Resources(memory_bytes=20480), device="cpu")
    n = 256
    g = gen.gnp(n, 0.03, seed=2)  # its edges fit the waiting-feed budget

    def run():
        sids = [server.open_stream(n, block_size=BLOCK) for _ in range(3)]
        for sid in sids:
            server.feed(sid, g.edges)
        assert server.stream_status(sids[2]) == "queued"
        return sids, [server.close_stream(sid).item() for sid in sids]

    (sids, counts), spans, _ = _traced(run)
    assert counts == [count_triangles_brute(g)] * 3
    parent = _parents(spans)
    queued = [s for s in spans if s[NAME] == "mux.queued"]
    assert [(s[SID], parent(s)) for s in queued] == [(sids[2], "mux.admit_pending")]
    opened = next(s for s in spans if s[NAME] == "mux.open" and s[SID] == sids[2])
    closed = next(s for s in spans if s[NAME] == "mux.close" and s[SID] == sids[0])
    assert opened[START] <= queued[0][START] <= opened[END]
    assert closed[START] <= queued[0][END] <= closed[END]
    allocs = [(s[SID], parent(s)) for s in spans if s[NAME] == "session.alloc"]
    assert allocs == [(sids[0], "mux.open"), (sids[1], "mux.open"),
                      (sids[2], "mux.admit_pending")]
    replayed = [s for s in spans if s[NAME] == "ingest.block" and parent(s) == "mux.replay"]
    assert replayed and {s[SID] for s in replayed} == {sids[2]}


def test_each_preempted_session_carries_its_own_sid(tmp_path):
    """A session that needs two victims' bytes preempts both: each victim's
    ``mux.preempt``, ``ckpt.snapshot`` and ``ckpt.spill`` carry that victim's
    sid, not the opener's; the close's sweep restores both, each restore
    under its own sid, and the sweep itself carries none."""
    mux = StreamMultiplexer(TriangleCounter(Resources(memory_bytes=20480), device="cpu"),
                            block_size=BLOCK, checkpoint_budget_bytes=0,
                            spill_dir=str(tmp_path), spill_budget_bytes=1 << 20)
    g = [gen.gnp(256, 0.03, seed=20 + k) for k in range(2)]
    big = gen.gnp(362, 0.02, seed=22)  # 17,376 B of bitset: both 8,192 B victims must go

    def run():
        lo = [mux.open(256, priority=1) for _ in range(2)]
        for sid, gk in zip(lo, g):
            mux.feed(sid, gk.edges)
        hi = mux.open(362, priority=5)
        assert [mux.status(s) for s in lo] == ["preempted"] * 2
        assert mux.status(hi) == "active" and mux.store.n_spills == 2
        mux.feed(hi, big.edges)
        counts = {hi: mux.close(hi).item()}
        assert [mux.status(s) for s in lo] == ["active"] * 2
        counts.update((s, mux.close(s).item()) for s in lo)
        return lo, hi, counts

    (lo, hi, counts), spans, _ = _traced(run)
    assert counts == {hi: count_triangles_brute(big), lo[0]: count_triangles_brute(g[0]),
                      lo[1]: count_triangles_brute(g[1])}
    parent = _parents(spans)

    def sids(name):
        return sorted(s[SID] for s in spans if s[NAME] == name)

    assert sids("mux.preempt") == sids("ckpt.snapshot") == sids("ckpt.spill") == lo
    assert {parent(s) for s in spans if s[NAME] == "ckpt.snapshot"} == {"mux.preempt"}
    assert sids("mux.restore") == sids("ckpt.load") == lo
    assert {parent(s) for s in spans if s[NAME] == "mux.restore"} == {"mux.admit_pending"}
    assert {s[SID] for s in spans if s[NAME] == "mux.admit_pending"} == {None}


@pytest.mark.parametrize("prefetch_depth", [None, 2])
def test_the_tracer_off_records_nothing(prefetch_depth):
    server = TriangleServer(device="cpu", prefetch_depth=prefetch_depth)
    g = gen.gnp(N, 0.3, seed=3)
    _serve(server, g)
    assert tracing.drain() == ([], {})


def test_counters_equal_what_the_host_knows():
    server = TriangleServer(device="cpu")
    g = gen.gnp(N, 0.3, seed=4)
    (_, result, _), _, counters = _traced(lambda: _serve(server, g))
    n_blocks = result.stats["n_blocks"]
    assert counters["ingest.blocks"] == {BLOCK: n_blocks}
    assert counters["ingest.rows_real"] == g.n_edges
    assert counters["ingest.rows_padded"] == n_blocks * BLOCK - g.n_edges
    assert counters["ingest.zero_fill_bytes"] == n_blocks * N * -(-N // 32) * 4
    assert "hybrid.hubs_used" not in counters


def _hybrid_plan():
    return Plan(method="stream", block_size=BLOCK, state_layout="hybrid", hub_slots=N,
                tail_capacity=8, hub_threshold=8, reason="forced hybrid")


def test_a_hybrid_close_counts_hubs_used_only_while_tracing():
    g = gen.gnp(N, 0.3, seed=5)
    session = TriangleCounter(Resources(), device="cpu").open_stream(N, plan=_hybrid_plan())
    session.feed(g.edges)
    result, _, counters = _traced(session.finalize)
    assert result.item() == count_triangles_brute(g) and "hubs_used" not in result.stats
    assert counters["hybrid.hubs_used"] == int((session.state["hub_ids"] < N).sum()) > 0
    wl = -(-min(2 * BLOCK, N + 1) // 32)  # the block-local delta table's words
    assert counters["ingest.zero_fill_bytes"] == 2 * BLOCK * wl * 4  # the tail block


@pytest.mark.parametrize("prefetch_depth", [None, 2])
def test_counts_are_bit_identical_with_the_tracer_on_and_off(prefetch_depth):
    graphs = [gen.gnp(N, 0.2 + 0.05 * k, seed=10 + k) for k in range(3)]
    requests = [(N, [g.edges[i:i + FEED] for i in range(0, g.n_edges, FEED)]) for g in graphs]

    def counts():
        server = TriangleServer(device="cpu", prefetch_depth=prefetch_depth)
        return [r.item() for r in server.serve_streams(requests, block_size=BLOCK)]

    off = counts()
    on, spans, _ = _traced(counts)
    assert off == on == [count_triangles_brute(g) for g in graphs]
    assert spans


_READS = ("item", "tolist", "cpu", "numpy", "__int__", "__bool__", "__float__", "__index__")


@pytest.mark.parametrize("layout", ["bitset", "hybrid"])
def test_the_tracer_adds_no_tensor_read(monkeypatch, layout):
    """Calls that bring a tensor's value to the host, over one session,
    are as many with the tracer on as off (a hybrid close reads its lost
    count and the hubs used in one read either way)."""
    reads = [0]
    for name in _READS:
        original = getattr(torch.Tensor, name)

        def counted(self, *args, _original=original, **kw):
            reads[0] += 1
            return _original(self, *args, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    g = gen.gnp(N, 0.3, seed=6)
    plan = _hybrid_plan() if layout == "hybrid" else None

    def session_reads() -> int:
        counter = TriangleCounter(Resources(), device="cpu")
        before = reads[0]
        s = counter.open_stream(N, plan=plan, block_size=BLOCK)
        for i in range(0, g.n_edges, FEED):
            s.feed(g.edges[i:i + FEED])
        s.finalize().item()
        return reads[0] - before

    off = session_reads()
    on, spans, _ = _traced(session_reads)
    assert spans and on == off


def test_wall_s_is_summed_from_the_sessions_ingest_spans():
    server = TriangleServer(device="cpu")
    g = gen.gnp(N, 0.3, seed=7)
    (_, result, _), spans, _ = _traced(lambda: _serve(server, g))
    parent = _parents(spans)
    timed = [s for s in spans if s[NAME] in ("ingest.reblock", "ingest.block", "ingest.tail")
             and parent(s) in ("mux.feed", "mux.close")]
    assert result.wall_s == pytest.approx(sum(map(_seconds, timed)), rel=1e-9)


def test_the_adaptive_sizer_reads_the_ingest_block_span(monkeypatch):
    """Under prefetch the drive thread's ``ingest.block`` spans carry the
    session id, and the adaptive sizer observes exactly their durations."""
    seen = []

    class Recorder:
        def __init__(self, plan_block_size, **kw):
            pass

        def observe(self, n_edges, wall_s):
            seen.append(wall_s)

    monkeypatch.setattr(streaming, "AdaptiveBlockSizer", Recorder)
    server = TriangleServer(device="cpu", prefetch_depth=2, adaptive_block=True)
    g = gen.gnp(N, 0.3, seed=8)
    (sid, _, count), spans, _ = _traced(lambda: _serve(server, g))
    assert count == count_triangles_brute(g)
    parent = _parents(spans)
    blocks = [s for s in spans if s[NAME] == "ingest.block"]
    assert {s[SID] for s in blocks} == {sid}
    assert seen == [_seconds(s) for s in blocks if parent(s) != "ingest.tail"]
    assert len(seen) >= 2


def test_spans_and_counters_lose_no_update_across_threads():
    """More threads than cores, switching often: every span and every
    counted unit arrives, each span with its own id and its thread's sid."""
    n_threads, per_thread = 2 * (os.cpu_count() or 1), 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tracing.enable()
    try:
        def work(k):
            for _ in range(per_thread):
                with tracing.span("outer", k), tracing.span("inner"):
                    tracing.count("units")
                    tracing.count("bins", 2, key=k % 3)

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        tracing.disable()
    spans, counters = tracing.drain()
    total = n_threads * per_thread
    assert counters["units"] == total and sum(counters["bins"].values()) == 2 * total
    assert len(spans) == 2 * total and len({s[ID] for s in spans}) == 2 * total
    by_id = {s[ID]: s for s in spans}
    for s in spans:
        if s[NAME] == "inner":
            outer = by_id[s[PARENT]]
            assert outer[NAME] == "outer" and (outer[SID], outer[THREAD]) == (s[SID], s[THREAD])
        else:
            assert s[PARENT] == 0
    assert np.unique([s[SID] for s in spans], return_counts=True)[1].tolist() \
        == [2 * per_thread] * n_threads
