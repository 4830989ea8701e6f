"""The bitset ingests' delta pool (``core.streaming.DeltaPool``) on the CPU.

With a pool, a block takes a delta table that is clean already and returns
the words it set to zero, so no block zero-fills one. Counts and states
stay bit-identical to the ingests without a pool and to the oracles: the
per-edge fold for unbounded streams, a recount of the live window for
windowed ones. The table is all zero after every block, is grown for a
larger session and lent as a prefix to a smaller one, is dropped when a
block raises, and is trimmed where the multiplexer admits a session."""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.api import Plan, Resources, TriangleCounter
from repro_torch.core import streaming
from repro_torch.core.triangle_ref import count_triangles_brute
from repro_torch.graphs import generators as gen
from repro_torch.serve import StreamMultiplexer

CPU = torch.device("cpu")
N, BLOCK = 100, 32  # W = 4 words a row; nodes 31, 63 and 95 sit on bit 31


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _noisy_blocks(n: int, seed: int, m: int = 260) -> list:
    """(BLOCK, 2) blocks of a random stream with every case the ingest must
    ignore or place exactly: duplicates in both orientations (within a
    block and of edges already in A), self-loops, phantom rows (id >= n),
    words carrying bit 31, and word 0 written by a live edge (row 0's
    first word; a dead edge's bit also lands at index 0, as a 0)."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(m, 2))
    special = np.array([[0, 5], [0, 1], [31, 7], [63, 31], [95, 62], [n - 1, 31],
                        [4, 4], [9, 9], [n, 2], [3, n + 7]])
    stream = np.concatenate([e, special, e[:40, ::-1], e[40:60]])
    stream = stream[rng.permutation(len(stream))]
    return [stream[i:i + BLOCK].astype(np.int32) for i in range(0, len(stream), BLOCK)]


def _window_oracle(n: int, epochs: list, window: int) -> int:
    """The live window recounted: each edge keeps its first arrival while
    it lives; triangles among the edges of the last ``window`` epochs."""
    arrival: dict = {}
    for t, blocks in enumerate(epochs):
        for u, v in np.concatenate(blocks).tolist():
            if u == v or u >= n or v >= n:
                continue
            e = (min(u, v), max(u, v))
            if e not in arrival or arrival[e] <= t - window:
                arrival[e] = t
    live = [e for e, t in arrival.items() if t > len(epochs) - 1 - window]
    nbrs: dict = {i: set() for i in range(n)}
    for u, v in live:
        nbrs[u].add(v)
        nbrs[v].add(u)
    return sum(len(nbrs[u] & nbrs[v]) for u, v in live) // 3


def _held(pool):
    """The pool's table on the CPU, or None."""
    held = pool._held.get(CPU)
    return None if held is None else held.table


def _clean_after_each(pool):
    def check(_):
        table = _held(pool)
        assert table is not None and not pool._held[CPU].busy
        assert not table.any(), "a block left bits in the pooled delta table"
    return check


def _run(kind: str, epochs: list, pool=None, after=lambda state: None) -> dict:
    """Every block of ``epochs`` through the ``kind`` ingest (windowed:
    the window slides between epochs), ``after(state)`` after each."""
    if kind == "blocked":
        state, step = streaming.init_state(N, device=CPU), streaming.ingest_block
    elif kind == "sharded":
        state = streaming.init_sharded_state(N, 3, device=CPU)
        step = streaming.ingest_block_sharded
    else:
        state = streaming.init_windowed_state(N, 2, device=CPU)
        step = streaming.ingest_block_windowed
    for t, blocks in enumerate(epochs):
        if t and kind == "windowed":
            streaming.expire_epoch(state)
        for b in blocks:
            if pool is None:
                step(state, b)
            else:
                step(state, b, pool=pool)
            after(state)
    return state


def _oracle(kind: str, epochs: list):
    """(count, adjacency (N, W) as int32 words or None) of the oracle."""
    if kind == "windowed":
        return _window_oracle(N, epochs, 2), None
    state = streaming.init_state(N, device=CPU)
    for blocks in epochs:
        for b in blocks:
            streaming.ingest_block_per_edge(state, b)
    return int(state["count"]), state["adj"]


@pytest.mark.parametrize("kind", ["blocked", "sharded", "windowed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_a_pooled_ingest_equals_the_ingest_without_one_and_the_oracle(kind, seed):
    blocks = _noisy_blocks(N, seed)
    epochs = [blocks[i:i + 3] for i in range(0, len(blocks), 3)]
    pool = streaming.DeltaPool()
    pooled = _run(kind, epochs, pool, after=_clean_after_each(pool))
    plain = _run(kind, epochs)
    for key in plain:
        assert torch.equal(pooled[key], plain[key]), key
    want, adj = _oracle(kind, epochs)
    got = pooled["counts"].sum() if kind == "windowed" else pooled["count"]
    assert int(got) == want > 0
    if kind == "sharded":  # the S column shards side by side, less the pad words
        assert torch.equal(torch.cat(list(pooled["adj"]), dim=1)[:, :adj.shape[1]], adj)
    elif adj is not None:
        assert torch.equal(pooled["adj"], adj)


def test_count_stream_holds_its_own_pool_and_counts_exactly():
    blocks = _noisy_blocks(N, 2)
    tracing.enable()
    try:
        got = streaming.count_stream(N, blocks, block_size=BLOCK, device=CPU)
    finally:
        tracing.disable()
    _, counters = tracing.drain()
    assert got == _oracle("blocked", [blocks])[0]
    assert counters["ingest.delta_reuse"] == {"filled": 1, "clean": len(blocks) - 1}


def test_sessions_of_two_sizes_share_the_counters_table_grown_then_lent_as_a_prefix():
    counter = TriangleCounter(device="cpu")
    small, big = gen.gnp(60, 0.3, seed=3), gen.gnp(N, 0.3, seed=4)
    s_small = counter.open_stream(small.n_nodes, block_size=BLOCK)
    s_big = counter.open_stream(big.n_nodes, block_size=BLOCK)
    tracing.enable()
    try:
        for i in range(0, max(small.n_edges, big.n_edges), BLOCK):
            for session, g in ((s_small, small), (s_big, big)):
                session.feed(g.edges[i:i + BLOCK])
                assert not _held(counter.delta_pool).any()
        counts = (s_small.finalize().item(), s_big.finalize().item())
    finally:
        tracing.disable()
    _, counters = tracing.drain()
    assert counts == (count_triangles_brute(small), count_triangles_brute(big))
    # the small session's first block allocates, the big one's grows the
    # table, and every later block of either takes it clean
    blocks = s_small.n_blocks + s_big.n_blocks
    assert counters["ingest.delta_reuse"] == {"filled": 2, "clean": blocks - 2}
    assert _held(counter.delta_pool).numel() == streaming.delta_words(N)


def test_a_block_that_raises_drops_the_table_and_the_next_block_counts_exactly(monkeypatch):
    blocks = _noisy_blocks(N, 5)
    pool = streaming.DeltaPool()
    state = streaming.init_state(N, device=CPU)
    streaming.ingest_block(state, blocks[0], pool=pool)
    real = streaming.bitset_pair_count
    calls = []

    def fails_once(*args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected")
        return real(*args)

    monkeypatch.setattr(streaming, "bitset_pair_count", fails_once)
    with pytest.raises(RuntimeError, match="injected"):
        streaming.ingest_block(state, blocks[1], pool=pool)
    assert _held(pool) is None  # the failed block's bits went with it
    for b in blocks[1:]:
        streaming.ingest_block(state, b, pool=pool)
        assert not _held(pool).any()
    want, adj = _oracle("blocked", [blocks])
    assert int(state["count"]) == want and torch.equal(state["adj"], adj)


def test_admission_trims_the_pool_to_the_largest_table_the_active_sessions_take():
    mux = StreamMultiplexer(TriangleCounter(device="cpu"), block_size=BLOCK)
    pool = mux.counter.delta_pool
    big, small = gen.gnp(N, 0.3, seed=6), gen.gnp(60, 0.3, seed=7)
    a = mux.open(N)
    mux.feed(a, big.edges)
    b = mux.open(60)  # beside the big session: its table stays
    assert _held(pool).numel() == streaming.delta_words(N)
    mux.feed(b, small.edges)
    assert mux.close(a).item() == count_triangles_brute(big)
    c = mux.open(60)  # only small sessions left: the big table goes
    assert _held(pool) is None
    mux.feed(c, small.edges)
    assert _held(pool).numel() == streaming.delta_words(60)
    assert mux.close(b).item() == mux.close(c).item() == count_triangles_brute(small)


def test_a_hybrid_session_ingests_with_the_counters_table_dropped():
    """A hybrid ingest allocates its own tables, which the card's reserve
    charges in place of the delta's, so the pool holds none meanwhile."""
    counter = TriangleCounter(Resources(), device="cpu")
    g = gen.gnp(N, 0.3, seed=8)
    bitset = counter.open_stream(N, block_size=BLOCK)
    hybrid = counter.open_stream(N, plan=Plan(
        method="stream", block_size=BLOCK, state_layout="hybrid", hub_slots=N,
        tail_capacity=8, hub_threshold=8, reason="forced hybrid"))
    full = g.n_edges // BLOCK * BLOCK
    for i in range(0, full, BLOCK):  # a block each feed
        bitset.feed(g.edges[i:i + BLOCK])
        assert not _held(counter.delta_pool).any()
        hybrid.feed(g.edges[i:i + BLOCK])
        assert _held(counter.delta_pool) is None
    bitset.feed(g.edges[full:])
    hybrid.feed(g.edges[full:])
    want = count_triangles_brute(g)
    assert bitset.finalize().item() == hybrid.finalize().item() == want
