"""The port's async prefetch driver (``repro_torch.serve.sessions.
_PrefetchDriver``) against its synchronous multiplexer and the reference's.

A ``StreamMultiplexer`` with ``prefetch_depth=K`` (background host
re-blocking overlapping the ingest) must be observably identical to the
synchronous one — bit-identical counts AND checkpoints — across dense,
hybrid and windowed layouts, through mid-stream checkpoint / preempt /
restore, and under seeded thread-timing jitter; the port's async runs are
also held against the reference's synchronous multiplexer on the same
seeded schedules. These are the cases of the reference's
``tests/test_async_serving.py`` on the port. The reference's "one ingest
trace per block shape" is the port's ``ingest_trace_count`` (first uses of
a key).

DEADLOCK WATCHDOG: an autouse fixture shrinks the driver's ``_JOIN_TIMEOUT``
as the reference's tests do, and every test runs under its own time limit
(``SIGALRM``), so no thread can hang the suite.
"""
import random
import signal
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.api import Resources as RefResources  # noqa: E402
from repro.api import TriangleCounter as RefTriangleCounter  # noqa: E402
from repro.core.triangle_ref import count_triangles_brute  # noqa: E402
from repro.graphs import generators as gen  # noqa: E402
from repro.serve.sessions import StreamMultiplexer as RefStreamMultiplexer  # noqa: E402
from repro_torch.api import Resources, TriangleCounter  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.serve import TriangleServer  # noqa: E402
from repro_torch.serve.sessions import StreamMultiplexer, _PrefetchDriver  # noqa: E402
from repro_torch.utils import PropagatingThread  # noqa: E402

SEED = 0
TIME_LIMIT_S = 60


@pytest.fixture(autouse=True)
def _watchdog(monkeypatch):
    """Every blocking wait in the driver fails loudly within 20 s, and the
    test itself within ``TIME_LIMIT_S``, instead of hanging the suite."""
    monkeypatch.setattr(_PrefetchDriver, "_JOIN_TIMEOUT", 20.0)

    def expired(signum, frame):
        raise TimeoutError(f"test exceeded its {TIME_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _mux(res=None, **kw):
    return StreamMultiplexer(TriangleCounter(res or Resources(), device="cpu"), **kw)


def _jitter(seed, scale=1.5e-3):
    """Seeded producer-thread timing perturbation: sleeps a random slice of
    ``scale`` before each command."""
    rng = random.Random(seed)

    def f():
        time.sleep(rng.random() * scale)
    return f


def _chunks(edges, rng, lo=5, hi=60):
    """Split an edge list at seeded ragged boundaries."""
    out, i = [], 0
    while i < len(edges):
        step = int(rng.integers(lo, hi))
        out.append(edges[i:i + step])
        i += step
    return out


def _ckpt_equal(a, b):
    assert set(a.arrays) == set(b.arrays)
    for k in a.arrays:
        assert np.array_equal(np.asarray(a.arrays[k]), np.asarray(b.arrays[k])), \
            f"checkpoint {k}"


# ------------------------------------------------------------ differentials
def test_async_matches_sync_dense():
    """N dense sessions, seeded ragged feeds + mid-stream checkpoints:
    async counts AND checkpoints are bit-identical to the sync mux, and
    the counts to the reference's."""
    rng = np.random.default_rng([SEED, 1])
    n = 64
    graphs = [gen.gnp(n, 0.35, seed=SEED * 10 + s) for s in range(4)]
    feeds = [_chunks(g.edges, rng) for g in graphs]
    sync = _mux(block_size=32)
    asyn = _mux(block_size=32, prefetch_depth=2, prefetch_jitter=_jitter(SEED + 1))
    ref = RefStreamMultiplexer(RefTriangleCounter(), block_size=32)
    s_ids = [sync.open(n) for _ in graphs]
    a_ids = [asyn.open(n) for _ in graphs]
    r_ids = [ref.open(n) for _ in graphs]
    live = [list(f) for f in feeds]
    rounds = 0
    while any(live):
        for i in range(len(graphs)):
            if live[i]:
                chunk = live[i].pop(0)
                sync.feed(s_ids[i], chunk)
                asyn.feed(a_ids[i], chunk)
                ref.feed(r_ids[i], chunk)
        rounds += 1
        if rounds == 3:  # mid-stream: snapshots must already agree
            for i in range(len(graphs)):
                _ckpt_equal(sync.checkpoint(s_ids[i]), asyn.checkpoint(a_ids[i]))
                _ckpt_equal(ref.checkpoint(r_ids[i]), asyn.checkpoint(a_ids[i]))
    for i, g in enumerate(graphs):
        want = count_triangles_brute(g)
        assert sync.close(s_ids[i]).item() == want
        assert asyn.close(a_ids[i]).item() == want
        assert int(np.asarray(ref.close(r_ids[i]).count)) == want


def test_async_matches_sync_windowed():
    """Windowed sessions with seeded advances: epoch attribution survives
    the async pipeline bit-identically."""
    rng = np.random.default_rng([SEED, 2])
    n = 64
    g = gen.gnp(n, 0.35, seed=SEED + 3)
    chunks = _chunks(g.edges, rng, lo=10, hi=40)
    advance_after = set(rng.choice(len(chunks), size=len(chunks) // 3,
                                   replace=False).tolist())
    sync = _mux(block_size=16)
    asyn = _mux(block_size=16, prefetch_depth=3, prefetch_jitter=_jitter(SEED + 2))
    ref = RefStreamMultiplexer(RefTriangleCounter(), block_size=16)
    s, a, r = sync.open(n, window=3), asyn.open(n, window=3), ref.open(n, window=3)
    for j, chunk in enumerate(chunks):
        for mux, sid in ((sync, s), (asyn, a), (ref, r)):
            mux.feed(sid, chunk)
            if j in advance_after:
                mux.advance(sid)
    _ckpt_equal(sync.checkpoint(s), asyn.checkpoint(a))
    _ckpt_equal(ref.checkpoint(r), asyn.checkpoint(a))
    assert sync.close(s).item() == asyn.close(a).item() == int(np.asarray(ref.close(r).count))


def test_async_matches_sync_hybrid():
    """Hybrid-layout sessions (admitted by a budget the dense bitset
    overflows) run the same prefetch pipeline bit-identically."""
    rng = np.random.default_rng([SEED, 3])
    n, mem = 4096, 1600 << 10  # dense needs 2 MiB -> admit-hybrid
    edges = rng.integers(0, n, size=(1500, 2), dtype=np.int32)
    edges = edges[edges[:, 0] != edges[:, 1]]
    chunks = _chunks(edges, rng, lo=40, hi=120)
    sync = _mux(Resources(memory_bytes=mem), block_size=64)
    asyn = _mux(Resources(memory_bytes=mem), block_size=64, prefetch_depth=2,
                prefetch_jitter=_jitter(SEED + 3))
    ref = RefStreamMultiplexer(RefTriangleCounter(RefResources(memory_bytes=mem)),
                               block_size=64)
    s, a, r = sync.open(n), asyn.open(n), ref.open(n)
    assert sync.state_bytes_of(s) < n * n // 8
    assert asyn.state_bytes_of(a) == ref.state_bytes_of(r) + 4  # int64 count
    for chunk in chunks:
        sync.feed(s, chunk)
        asyn.feed(a, chunk)
        ref.feed(r, chunk)
    _ckpt_equal(sync.checkpoint(s), asyn.checkpoint(a))
    _ckpt_equal(ref.checkpoint(r), asyn.checkpoint(a))
    assert sync.close(s).item() == asyn.close(a).item() == int(np.asarray(ref.close(r).count))


def test_async_preempt_restore_differential():
    """Mid-stream preempt (driver drained into the snapshot), feeds
    buffered while parked, restore-on-close: bit-identical to sync."""
    rng = np.random.default_rng([SEED, 4])
    n = 64
    g = gen.gnp(n, 0.35, seed=SEED + 5)
    chunks = _chunks(g.edges, rng)
    cut = len(chunks) // 2
    sync = _mux(block_size=32)
    asyn = _mux(block_size=32, prefetch_depth=2, prefetch_jitter=_jitter(SEED + 4))
    s, a = sync.open(n), asyn.open(n)
    for chunk in chunks[:cut]:
        sync.feed(s, chunk)
        asyn.feed(a, chunk)
    sync.preempt(s)
    asyn.preempt(a)
    assert sync.status(s) == asyn.status(a) == "preempted"
    _ckpt_equal(sync.store._held[s][0], asyn.store._held[a][0])
    for chunk in chunks[cut:]:
        sync.feed(s, chunk)
        asyn.feed(a, chunk)
    want = count_triangles_brute(g)
    assert sync.close(s).item() == want
    assert asyn.close(a).item() == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_async_randomized_mixed_schedule(seed):
    """A seeded random op schedule (ragged feeds, advances, checkpoints,
    preempts) over a mixed dense + windowed population, applied verbatim to
    the port's sync and async multiplexers and the reference's: every count
    and every snapshot agrees."""
    rng = np.random.default_rng([seed, 5])
    n = 64
    graphs = [gen.gnp(n, 0.3, seed=seed * 7 + s) for s in range(5)]
    windows = [None, 3, None, 4, None]
    muxes = [_mux(block_size=32),
             _mux(block_size=32, prefetch_depth=2, prefetch_jitter=_jitter(seed + 5)),
             RefStreamMultiplexer(RefTriangleCounter(), block_size=32)]
    ids = [[m.open(n, window=w) for w in windows] for m in muxes]
    feeds = [_chunks(g.edges, rng) for g in graphs]
    preempted = set()
    while any(feeds):
        i = int(rng.integers(0, len(graphs)))
        if not feeds[i]:
            continue
        op = rng.random()
        if op < 0.70:
            chunk = feeds[i].pop(0)
            for m, sids in zip(muxes, ids):
                m.feed(sids[i], chunk)
        elif op < 0.80 and windows[i] and i not in preempted:
            for m, sids in zip(muxes, ids):
                m.advance(sids[i])
        elif op < 0.90 and i not in preempted:
            cks = [m.checkpoint(sids[i]) for m, sids in zip(muxes, ids)]
            _ckpt_equal(cks[0], cks[1])
            _ckpt_equal(cks[2], cks[1])
        elif i not in preempted:
            for m, sids in zip(muxes, ids):
                m.preempt(sids[i])
            preempted.add(i)
    for i, g in enumerate(graphs):
        got = [int(np.asarray(m.close(sids[i]).count)) for m, sids in zip(muxes, ids)]
        assert got[0] == got[1] == got[2]
        if windows[i] is None:
            assert got[0] == count_triangles_brute(g)


def test_server_prefetch_streams_equal_the_synchronous_server():
    """``TriangleServer(prefetch_depth=2)``'s interleaved streams equal the
    synchronous server's, with no new ingest key for the seen shapes."""
    graphs = [gen.gnp(n, 0.3, seed=n) for n in (50, 61, 77)]
    reqs = [(g.n_nodes, [g.edges[i:i + 37] for i in range(0, g.n_edges, 37)])
            for g in graphs]
    sync = [r.item() for r in TriangleServer(device="cpu").serve_streams(reqs, block_size=32)]
    before = streaming.ingest_trace_count()
    asyn = TriangleServer(device="cpu", prefetch_depth=2)
    got = [r.item() for r in asyn.serve_streams(reqs, block_size=32)]
    assert streaming.ingest_trace_count() == before
    assert got == sync == [count_triangles_brute(g) for g in graphs]
    assert asyn.streams.n_active == 0 and asyn.streams.bytes_in_use == 0


# ------------------------------------------------------- lifecycle hazards
def test_abrupt_kill_leaves_mux_consistent():
    """kill() with blocks still in flight drops them, frees the budget and
    leaves every other session — and the shared counter — usable."""
    n = 64
    g = gen.gnp(n, 0.35, seed=SEED + 8)
    mux = _mux(block_size=32, prefetch_depth=2,
               prefetch_jitter=_jitter(SEED + 8, scale=3e-3))
    victim, survivor = mux.open(n), mux.open(n)
    for i in range(0, len(g.edges), 17):
        mux.feed(victim, g.edges[i:i + 17])
        mux.feed(survivor, g.edges[i:i + 17])
    res = mux.kill(victim)
    assert res.stats["cancelled"] and res.item() == 0
    assert mux.status(victim) == "closed"
    assert mux.close(survivor).item() == count_triangles_brute(g)
    assert mux.bytes_in_use == 0
    sid = mux.open(n)
    mux.feed(sid, g.edges)
    assert mux.close(sid).item() == count_triangles_brute(g)


def test_producer_exception_propagates_to_drive_thread():
    """A crash on the producer thread surfaces as a raise on the drive
    thread (the PropagatingThread contract), not a silent stall."""
    n = 64
    g = gen.gnp(n, 0.3, seed=SEED + 9)
    boom = [False]

    def exploding_jitter():
        if boom[0]:
            raise RuntimeError("injected producer crash")

    mux = _mux(block_size=32, prefetch_depth=2, prefetch_jitter=exploding_jitter)
    sid = mux.open(n)
    mux.feed(sid, g.edges[:100])
    mux.checkpoint(sid)
    boom[0] = True
    with pytest.raises(RuntimeError, match="injected producer crash"):
        for _ in range(50):
            mux.feed(sid, g.edges[:40])
            time.sleep(0.01)
    mux.kill(sid)


def test_watchdog_raises_instead_of_hanging(monkeypatch):
    """A wedged producer turns into a RuntimeError from the barrier within
    the watchdog bound."""
    monkeypatch.setattr(_PrefetchDriver, "_JOIN_TIMEOUT", 0.5)
    n = 64
    g = gen.gnp(n, 0.3, seed=SEED + 10)
    gate = threading.Event()

    def wedge():
        gate.wait(30)

    mux = _mux(block_size=32, prefetch_depth=2, prefetch_jitter=wedge)
    sid = mux.open(n)
    mux.feed(sid, g.edges[:64])
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="watchdog"):
        mux.checkpoint(sid)
    assert time.monotonic() - t0 < 5.0, "watchdog fired far too late"
    gate.set()
    mux.kill(sid)


def test_blockbuffer_concurrent_mutation_raises():
    """A second thread mutating the BlockBuffer while a push is in flight
    gets an immediate RuntimeError, not silent tail corruption."""
    buf = streaming.BlockBuffer(64, block_size=8, device="cpu")
    entered, release = threading.Event(), threading.Event()

    class _SlowEdges:
        """Stalls inside push's np.asarray — inside the SPSC guard."""

        def __array__(self, dtype=None, copy=None):
            entered.set()
            release.wait(10)
            return np.zeros((4, 2), np.int32)

    t = PropagatingThread(target=buf.push, args=(_SlowEdges(),))
    t.start()
    assert entered.wait(10), "producer never reached the buffer"
    try:
        with pytest.raises(RuntimeError, match="single-producer"):
            buf.flush()
        with pytest.raises(RuntimeError, match="single-producer"):
            buf.push(np.zeros((2, 2), np.int32))
    finally:
        release.set()
        t.join(10)
    assert not t.is_alive()
    assert buf.flush() is not None


def test_prefetch_depth_is_validated():
    for bad in (0, -1, 1.5, True):
        with pytest.raises(ValueError, match="prefetch_depth"):
            _mux(prefetch_depth=bad)
    with pytest.raises(ValueError, match="prefetch depth"):
        _PrefetchDriver(object(), 0)


# -------------------------------------------------- adaptive re-blocking
def test_adaptive_resize_mid_stream_keeps_counts_exact(monkeypatch):
    """Drive the driver's resize path deterministically (a stub sizer that
    demands power-of-two shrinks/grows at fixed points): counts stay exact,
    and the session's final block size is the last one applied."""

    class _Schedule:
        """Stands in for AdaptiveBlockSizer: resize on a fixed schedule."""

        def __init__(self, plan_block_size, **kw):
            self.sizes = [16, 8, 32]
            self.seen = 0

        def observe(self, n_edges, wall_s):
            self.seen += 1
            if self.seen % 4 == 0 and self.sizes:
                return self.sizes.pop(0)
            return None

    monkeypatch.setattr(streaming, "AdaptiveBlockSizer", _Schedule)
    n = 64
    g = gen.gnp(n, 0.35, seed=SEED + 11)
    mux = _mux(block_size=32, prefetch_depth=2, adaptive_block=True,
               prefetch_jitter=_jitter(SEED + 11))
    sid = mux.open(n)
    for i in range(0, len(g.edges), 21):
        mux.feed(sid, g.edges[i:i + 21])
    r = mux.close(sid)
    assert r.item() == count_triangles_brute(g)
    assert r.stats["block_size"] in (16, 8, 32)


def test_adaptive_block_sizer_policy():
    """The real sizer: grows ×2 after ``patience`` consecutive fast blocks,
    shrinks ÷2 after ``patience`` slow ones, clamps to the [lo, hi]
    power-of-two bucket, and mixed signals reset the streak."""
    s = streaming.AdaptiveBlockSizer(100, lo=32, low_s=2e-3, high_s=20e-3, patience=2)
    assert s.hi == 128 and s.size == 128
    assert s.observe(128, 50e-3) is None
    assert s.observe(128, 50e-3) == 64
    assert s.observe(64, 1e-3) is None
    assert s.observe(64, 50e-3) is None
    assert s.observe(64, 1e-3) is None
    assert s.observe(64, 1e-3) == 128
    assert s.observe(128, 1e-3) is None
    assert s.observe(128, 1e-3) is None
    for _ in range(10):
        assert s.observe(128, 50e-3) in (None, 64, 32)
    assert s.size >= 32
