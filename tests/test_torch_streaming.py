"""The port's streaming core (``repro_torch.core.streaming``) against the
reference's (``repro.core.streaming``): the two-phase blocked ingest, its
emulated column-sharded twin, the per-edge oracle, the sliding window, the
re-blocking buffer and the state snapshots.

Every stream is made with numpy from a seed and fed to both packages; every
count is compared as an exact integer, and every snapshot array bit for
bit. The reference runs both of its routes: its plain jnp sweeps
(``use_kernel=False``) and, at tiny sizes, its Pallas kernels in interpret
mode (``use_kernel=True, interpret=True``). Counts stay under 2³¹, where the
reference's int32 counts are exact."""
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import streaming as ref  # noqa: E402
from repro.core.triangle_ref import count_triangles_brute  # noqa: E402
from repro.graphs import generators as gen  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402

CPU = "cpu"


def _stream_of(g, *, seed=0, dups=0, self_loops=0, reversed_dups=0):
    """A shuffled edge stream with duplicate/reversed/self-loop noise (all
    of which the ingest must ignore)."""
    rng = np.random.default_rng(seed)
    edges = g.edges[rng.permutation(g.n_edges)] if g.n_edges else g.edges
    parts = [edges]
    if g.n_edges and dups:
        parts.append(edges[rng.integers(0, g.n_edges, size=dups)])
    if g.n_edges and reversed_dups:
        parts.append(edges[rng.integers(0, g.n_edges, size=reversed_dups)][:, ::-1])
    if self_loops:
        loops = rng.integers(0, g.n_nodes, size=self_loops)
        parts.append(np.stack([loops, loops], axis=1).astype(np.int32))
    stream = np.concatenate(parts)
    return stream[rng.permutation(len(stream))]


def _blocks(stream, block):
    return [stream[i:i + block] for i in range(0, len(stream), block)]


def windowed_oracle(n_nodes: int, epoch_edges: list, window: int) -> int:
    """From-scratch recount of the live window: replay the stream keeping
    each live edge's first arrival epoch, then count the triangles among
    the edges whose epoch is within the final ``window`` epochs."""
    arrival: dict = {}
    n_epochs = len(epoch_edges)
    for t, edges in enumerate(epoch_edges):
        for u, v in np.asarray(edges, dtype=np.int64).reshape(-1, 2):
            u, v = int(u), int(v)
            if u == v:
                continue
            e = (min(u, v), max(u, v))
            if e in arrival and arrival[e] > t - window:
                continue  # duplicate of a still-live edge: first arrival wins
            arrival[e] = t
    live = {e for e, a in arrival.items() if a > n_epochs - 1 - window}
    adj: dict = {i: set() for i in range(n_nodes)}
    for u, v in live:
        adj[u].add(v)
        adj[v].add(u)
    return sum(len(adj[u] & adj[v]) for u, v in live) // 3


def _noisy_epochs(n, n_epochs, m, *, seed=0, dups=4, self_loops=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_epochs):
        e = rng.integers(0, n, size=(m, 2)).astype(np.int32)
        if self_loops:
            loops = rng.integers(0, n, size=self_loops)
            e = np.concatenate([e, np.stack([loops, loops], axis=1).astype(np.int32)])
        if dups:
            e = np.concatenate([e, e[rng.integers(0, len(e), size=dups)]])
        out.append(e[rng.permutation(len(e))])
    return out


def _snap_equal(port_state, ref_state):
    """The port's snapshot equals the reference's, array for array: the
    bitsets bit for bit as uint32, the counts as integers."""
    a, b = streaming.snapshot_state(port_state), ref.snapshot_state(ref_state)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        if k in ("adj", "epochs"):
            assert a[k].dtype == b[k].dtype == np.uint32
            np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k].astype(np.int64), b[k].astype(np.int64))
    assert a["count" if "count" in a else "counts"].dtype == np.int64


# --------------------------------------------------------------------------
# Unbounded ingest: port vs reference (both routes) vs the per-edge oracles
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,p,seed,block", [
    (21, 0.4, 0, 5),     # ragged blocks
    (45, 0.7, 1, 11),    # dense-ish, ragged
    (30, 0.3, 2, 1000),  # single block covering the whole stream
    (17, 0.9, 3, 1),     # one edge per block
])
def test_blocked_ingest_matches_reference_and_oracles(n, p, seed, block):
    g = gen.gnp(n, p, seed=seed)
    stream = _stream_of(g, seed=seed, dups=6, reversed_dups=4, self_loops=3)
    blocks = _blocks(stream, block)
    want = count_triangles_brute(g)
    assert ref.count_stream(n, blocks) == want
    assert streaming.count_stream(n, blocks, device=CPU) == want
    assert streaming.count_stream_per_edge(n, blocks, device=CPU) == want
    assert ref.count_stream_per_edge(n, blocks) == want


@pytest.mark.parametrize("n,p,seed,block", [(21, 0.4, 0, 11), (30, 0.3, 2, 1000),
                                            (40, 0.6, 4, 64)])
def test_blocked_ingest_matches_reference_kernel_route(n, p, seed, block):
    """The reference with its Pallas kernels in interpret mode (tiny sizes:
    n ≤ 64, B ≤ 256 after padding)."""
    g = gen.gnp(n, p, seed=seed)
    blocks = _blocks(_stream_of(g, seed=seed, dups=3, self_loops=2), block)
    got = streaming.count_stream(n, blocks, device=CPU)
    assert got == ref.count_stream(n, blocks, use_kernel=True, interpret=True) \
        == count_triangles_brute(g)


@pytest.mark.parametrize("n_stages", [2, 3, 5])
def test_sharded_ingest_matches_reference_and_oracle(n_stages):
    g = gen.gnp(52, 0.5, seed=7)
    blocks = _blocks(_stream_of(g, seed=7, dups=5, self_loops=2), 13)
    want = streaming.count_stream_per_edge(52, blocks, device=CPU)
    assert want == count_triangles_brute(g)
    assert streaming.count_stream(52, blocks, n_stages=n_stages, device=CPU) == want
    assert ref.count_stream(52, blocks, n_stages=n_stages) == want


def test_sharded_state_is_column_sharded():
    state = streaming.init_sharded_state(1000, 4, device=CPU)
    w = -(-1000 // 32)
    assert state["adj"].shape == (4, 1000, -(-w // 4)) == \
        ref.init_sharded_state(1000, 4)["adj"].shape
    assert state["adj"].dtype == torch.int32 and state["count"].dtype == torch.int64
    full = streaming.init_state(1000, device=CPU)["adj"]
    assert 4 * state["adj"][0].numel() >= full.numel()


def test_empty_and_degenerate_streams():
    for kw in ({}, {"n_stages": 2}):
        assert streaming.count_stream(10, [], device=CPU, **kw) == 0
        assert streaming.count_stream(10, [np.zeros((0, 2), np.int32)], device=CPU, **kw) == 0
        assert streaming.count_stream(10, [np.array([[3, 3], [4, 4]])], device=CPU, **kw) == 0
        # duplicate-only stream: one edge, restated forever -> no triangles
        assert streaming.count_stream(10, [np.array([[1, 2]] * 50)], device=CPU, **kw) == 0


def test_triangle_split_across_blocks_and_within_block():
    """Every correction term: 0-1-2 completes with its last two edges in one
    block (mixed), 3-4-5 lies in one block (dd), 6-7-8 one edge per block
    (pre only)."""
    blocks = [np.array([[0, 1], [3, 4], [6, 7]]),
              np.array([[3, 5], [4, 5], [7, 8]]),
              np.array([[0, 2], [1, 2], [6, 8]])]
    assert streaming.count_stream(9, blocks, device=CPU) == 3
    assert streaming.count_stream(9, blocks, n_stages=3, device=CPU) == 3
    assert streaming.count_stream_per_edge(9, blocks, device=CPU) == 3
    # the terms themselves, against the reference's, block by block
    state, rstate = streaming.init_state(9, device=CPU), ref.init_state(9)
    for b in blocks:
        streaming.ingest_block(state, b)
        rstate = ref.ingest_block(rstate, b)
        assert int(state["count"]) == int(rstate["count"])


@pytest.mark.parametrize("n", [32, 64, 100])
def test_words_carrying_bit_31_scatter_and_close_exactly(n):
    """Edges to vertex 31 mod 32 set bit 31 of their word (negative as
    int32): the add-scatter of the delta and of the state must give the
    reference's uint32 bits, and the closures its counts."""
    rng = np.random.default_rng(n)
    hubs = [v for v in range(n) if v % 32 == 31]
    edges = [(int(u), h) for h in hubs for u in rng.permutation(n)[: n // 2] if u != h]
    edges += [tuple(e) for e in rng.integers(0, n, size=(3 * n, 2))]
    stream = np.array(edges, np.int32)[rng.permutation(len(edges))]
    state, rstate = streaming.init_state(n, device=CPU), ref.init_state(n)
    for b in _blocks(stream, 37):
        streaming.ingest_block(state, b)
        rstate = ref.ingest_block(rstate, b)
    _snap_equal(state, rstate)
    assert (streaming.snapshot_state(state)["adj"] & np.uint32(1 << 31)).any()
    simple = np.unique(np.sort(stream[stream[:, 0] != stream[:, 1]], axis=1), axis=0)
    want = count_triangles_brute(gen.Graph(edges=simple, n_nodes=n))
    assert int(state["count"]) == want


def test_delta_table_adds_distinct_bits_like_or():
    lo = torch.tensor([0, 0, 1, 5], dtype=torch.int64)
    hi = torch.tensor([31, 30, 31, 63], dtype=torch.int64)
    live = torch.tensor([True, True, True, False])
    idx, bits = streaming._delta_bits(64, 2, lo, hi, live, 0)
    delta = streaming._delta_table(64, 2, idx, bits).numpy().view(np.uint32)
    assert delta[0, 0] == (1 << 31) | (1 << 30) and delta[1, 0] == 1 << 31
    assert delta[31, 0] == 0b11 and delta[30, 0] == 1
    assert delta[5].sum() == 0 and delta[63].sum() == 0  # the dead edge set nothing


# --------------------------------------------------------------------------
# State equality and cross-restore against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_stages", [1, 3])
def test_snapshot_equals_reference_snapshot(n_stages):
    g = gen.powerlaw(90, 4, seed=5)
    blocks = _blocks(_stream_of(g, seed=5, dups=4, self_loops=2), 29)
    if n_stages > 1:
        state = streaming.init_sharded_state(90, n_stages, device=CPU)
        rstate = ref.init_sharded_state(90, n_stages)
        step, rstep = streaming.ingest_block_sharded, ref.ingest_block_sharded
    else:
        state, rstate = streaming.init_state(90, device=CPU), ref.init_state(90)
        step, rstep = streaming.ingest_block, ref.ingest_block
    for b in blocks:
        assert step(state, b) is state  # in place
        rstate = rstep(rstate, b)
        _snap_equal(state, rstate)
    assert int(state["count"]) == count_triangles_brute(g)


@pytest.mark.parametrize("n_stages", [1, 2])
def test_windowed_snapshot_equals_reference_snapshot(n_stages):
    epochs = _noisy_epochs(70, 6, 50, seed=8)
    if n_stages > 1:
        state = streaming.init_windowed_sharded_state(70, 3, n_stages, device=CPU)
        rstate = ref.init_windowed_sharded_state(70, 3, n_stages)
        step, rstep = (streaming.ingest_block_windowed_sharded,
                       ref.ingest_block_windowed_sharded)
    else:
        state, rstate = streaming.init_windowed_state(70, 3, device=CPU), \
            ref.init_windowed_state(70, 3)
        step, rstep = streaming.ingest_block_windowed, ref.ingest_block_windowed
    for t, e in enumerate(epochs):
        if t:
            streaming.expire_epoch(state)
            rstate = ref.expire_epoch(rstate)
        for b in _blocks(e, 16):
            step(state, b)
            rstate = rstep(rstate, b)
        _snap_equal(state, rstate)
    assert int(streaming.window_count(state)) == windowed_oracle(70, epochs, 3)


@pytest.mark.parametrize("windowed", [False, True])
def test_reference_snapshot_restores_and_continues_in_the_port(windowed):
    """A reference state (int32 count without x64) snapshotted halfway,
    restored in the port and fed on, ends at the reference's count and
    bits; the port's snapshot restores in the reference (under x64, where
    its counts are int64) and ends there too."""
    epochs = _noisy_epochs(64, 6, 60, seed=11)
    half = 3
    if windowed:
        init, rinit = (lambda: streaming.init_windowed_state(64, 2, device=CPU),
                       lambda: ref.init_windowed_state(64, 2))
        step, rstep = streaming.ingest_block_windowed, ref.ingest_block_windowed
    else:
        init, rinit = lambda: streaming.init_state(64, device=CPU), lambda: ref.init_state(64)
        step, rstep = streaming.ingest_block, ref.ingest_block

    def run(st, stp, expire, eps):
        for t, e in enumerate(eps):
            if t and windowed:
                st = expire(st)
            for b in _blocks(e, 32):
                st = stp(st, b)
        return st

    rstate = run(rinit(), rstep, ref.expire_epoch, epochs[:half])
    snap = ref.snapshot_state(rstate)
    assert snap["count" if not windowed else "counts"].dtype == np.int32
    state = streaming.restore_state(snap, device=CPU)
    assert state["adj" if not windowed else "epochs"].dtype == torch.int32
    if windowed:
        streaming.expire_epoch(state)
        rstate = ref.expire_epoch(rstate)
    state = run(state, step, streaming.expire_epoch, epochs[half:])
    rstate = run(rstate, rstep, ref.expire_epoch, epochs[half:])
    _snap_equal(state, rstate)
    # and the reverse: the port's snapshot continues in the reference
    with jax.enable_x64(True):
        back = ref.restore_state(streaming.snapshot_state(state))
        back = run(back, rstep, ref.expire_epoch, epochs[:1])
        mine = run(state, step, streaming.expire_epoch, epochs[:1])
        _snap_equal(mine, back)


def test_state_nbytes_and_restore_dtypes():
    state = streaming.init_windowed_state(100, 3, device=CPU)
    snap = streaming.snapshot_state(state)
    assert snap["epochs"].dtype == np.uint32 and snap["head"].dtype == np.int32
    assert snap["counts"].dtype == np.int64
    assert streaming.state_nbytes(snap) == streaming.state_nbytes(state) == \
        3 * 100 * 4 * 4 + 3 * 8 + 4
    back = streaming.restore_state(snap, device=CPU)
    assert {k: v.dtype for k, v in back.items()} == \
        {"epochs": torch.int32, "counts": torch.int64, "head": torch.int32}
    assert back["head"].shape == () and back["counts"].shape == (3,)


# --------------------------------------------------------------------------
# Ingest keys (the reference's one-trace-per-fixed-shape pins, as keys)
# --------------------------------------------------------------------------
def test_blocked_ingest_one_key_per_fixed_shape_stream():
    g = gen.gnp(197, 0.1, seed=23)  # node count unique to this test
    blocks = _blocks(g.edges, 23)
    assert len(blocks[-1]) < 23  # genuinely ragged tail
    before = streaming.ingest_trace_count()
    assert streaming.count_stream(197, blocks, device=CPU) == count_triangles_brute(g)
    assert streaming.ingest_trace_count() - before == 1
    before = streaming.ingest_trace_count()
    assert streaming.count_stream(197, blocks, device=CPU) == count_triangles_brute(g)
    assert streaming.ingest_trace_count() - before == 0
    before = streaming.ingest_trace_count()
    streaming.count_stream(197, blocks, n_stages=3, device=CPU)
    assert streaming.ingest_trace_count() - before == 1  # its own family


def test_small_stream_under_huge_block_size_pads_pow2_not_block_size():
    g = gen.gnp(41, 0.4, seed=31)
    got = list(streaming.padded_blocks([g.edges], 41, block_size=1 << 20, device=CPU))
    want = list(ref.padded_blocks([g.edges], 41, block_size=1 << 20))
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].shape[0] < 2 * max(g.n_edges, 8)
    assert streaming.count_stream(41, [g.edges], block_size=1 << 20, device=CPU) == \
        count_triangles_brute(g)


# --------------------------------------------------------------------------
# Sliding window: port vs reference vs the recount oracle
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,window,n_epochs,m,seed", [
    (30, 3, 8, 40, 0),    # window slides well past its width
    (25, 2, 10, 60, 1),   # dense-ish, short window
    (40, 5, 12, 30, 2),   # long window, sparse epochs
    (20, 1, 6, 50, 3),    # width-1 window: only the current epoch lives
])
def test_windowed_matches_reference_and_recount_oracle(n, window, n_epochs, m, seed):
    epochs = _noisy_epochs(n, n_epochs, m, seed=seed)
    want = windowed_oracle(n, epochs, window)
    wrapped = [[e] for e in epochs]
    assert streaming.count_windowed_stream(n, wrapped, window, block_size=16,
                                           device=CPU) == want
    assert ref.count_windowed_stream(n, wrapped, window, block_size=16) == want


def test_windowed_matches_reference_kernel_route():
    epochs = _noisy_epochs(24, 5, 30, seed=4)
    wrapped = [[e] for e in epochs]
    got = streaming.count_windowed_stream(24, wrapped, 2, block_size=64, device=CPU)
    assert got == ref.count_windowed_stream(24, wrapped, 2, block_size=64, use_kernel=True,
                                            interpret=True) == windowed_oracle(24, epochs, 2)


@pytest.mark.parametrize("n_stages", [2, 3, 5])
def test_sharded_window_matches_dense_window(n_stages):
    epochs = _noisy_epochs(52, 9, 45, seed=7)
    wrapped = [[e] for e in epochs]
    want = windowed_oracle(52, epochs, 3)
    dense = streaming.count_windowed_stream(52, wrapped, 3, block_size=16, device=CPU)
    sharded = streaming.count_windowed_stream(52, wrapped, 3, block_size=16,
                                              n_stages=n_stages, device=CPU)
    assert dense == sharded == want == \
        ref.count_windowed_stream(52, wrapped, 3, block_size=16, n_stages=n_stages)


def test_window_covering_whole_stream_equals_unbounded():
    g = gen.gnp(48, 0.4, seed=11)
    blocks = _blocks(g.edges, 16)
    want = streaming.count_stream(48, blocks, block_size=16, device=CPU)
    assert want == count_triangles_brute(g)
    assert streaming.count_windowed_stream(48, [[b] for b in blocks], len(blocks),
                                           block_size=16, device=CPU) == want


def test_window_shorter_than_one_block():
    tri = np.array([[0, 1], [1, 2], [0, 2]], np.int32)
    other = np.array([[3, 4], [4, 5], [3, 5]], np.int32)
    assert streaming.count_windowed_stream(6, [[tri], [other]], 1, device=CPU) == 1
    assert streaming.count_windowed_stream(6, [[np.concatenate([tri, other])]], 1,
                                           device=CPU) == 2


def test_edge_reinserted_after_expiry():
    e01, e12, e02 = (np.array([p], np.int32) for p in ([0, 1], [1, 2], [0, 2]))
    for epochs, window, want in (([e01, e12, e02, e01], 2, 0),
                                 ([e01, e12, e02], 3, 1),
                                 ([e01, e12, e02, e01, e12, e02], 3, 1)):
        wrapped = [[e] for e in epochs]
        assert windowed_oracle(3, epochs, window) == want
        assert streaming.count_windowed_stream(3, wrapped, window, device=CPU) == want
        assert ref.count_windowed_stream(3, wrapped, window) == want


def test_duplicate_straddling_epoch_boundary_keeps_first_arrival():
    e01, e12, e02 = (np.array([p], np.int32) for p in ([0, 1], [1, 2], [0, 2]))
    for dup in (e01, e01[:, ::-1]):  # either orientation is the same edge
        epochs = [e01, np.concatenate([e12, dup]), e02]
        assert streaming.count_windowed_stream(3, [[e] for e in epochs], 2, device=CPU) == 0
        assert streaming.count_windowed_stream(3, [[e] for e in epochs], 3, device=CPU) == 1


def test_empty_epochs_slide_the_window():
    g = gen.gnp(30, 0.5, seed=5)
    silence = [[np.zeros((0, 2), np.int32)] for _ in range(3)]
    assert streaming.count_windowed_stream(30, [[g.edges]] + silence, 3, device=CPU) == 0
    got = streaming.count_windowed_stream(30, [[g.edges]] + silence[:2], 3, device=CPU)
    assert got == count_triangles_brute(g) > 0
    assert got == ref.count_windowed_stream(30, [[g.edges]] + silence[:2], 3)


def test_degenerate_windowed_streams():
    assert streaming.count_windowed_stream(10, [], 3, device=CPU) == 0
    assert streaming.count_windowed_stream(10, [[]], 3, device=CPU) == 0
    assert streaming.count_windowed_stream(
        10, [[np.array([[3, 3], [4, 4]], np.int32)]], 2, device=CPU) == 0
    with pytest.raises(ValueError, match="window_epochs"):
        streaming.init_windowed_state(10, 0, device=CPU)
    with pytest.raises(ValueError, match="window_epochs"):
        streaming.init_windowed_sharded_state(10, 0, 2, device=CPU)


def test_windowed_state_shapes_and_bytes():
    st = streaming.init_windowed_state(1000, 4, device=CPU)
    w = -(-1000 // 32)
    assert st["epochs"].shape == (4, 1000, w) == ref.init_windowed_state(1000, 4)["epochs"].shape
    assert st["epochs"].nbytes == 4 * streaming.init_state(1000, device=CPU)["adj"].nbytes
    sh = streaming.init_windowed_sharded_state(1000, 4, 8, device=CPU)
    assert sh["epochs"].shape == (8, 4, 1000, -(-w // 8))
    assert sh["counts"].shape == (4,) and sh["head"].dtype == torch.int32


def test_expire_epoch_clears_one_slot_in_place():
    state = streaming.init_windowed_state(64, 3, device=CPU)
    rng = np.random.default_rng(2)
    epochs_before = state["epochs"]
    for t in range(5):
        if t:
            assert streaming.expire_epoch(state) is state
            slot = int(state["head"])
            assert slot == t % 3
            assert not state["epochs"][slot].any() and int(state["counts"][slot]) == 0
        streaming.ingest_block_windowed(state, rng.integers(0, 64, (40, 2)).astype(np.int32))
    assert state["epochs"] is epochs_before  # the ring was never reallocated
    sh = streaming.init_windowed_sharded_state(64, 3, 2, device=CPU)
    sh["epochs"].fill_(7)
    streaming.expire_epoch(sh)
    assert not sh["epochs"][:, 1].any() and sh["epochs"][:, 0].eq(7).all()


def test_windowed_one_key_across_epochs_and_sticky_tails():
    rng = np.random.default_rng(41)
    epochs = [[rng.integers(0, 211, size=(29, 2)).astype(np.int32)] for _ in range(9)]
    before = streaming.ingest_trace_count()
    got = streaming.count_windowed_stream(211, epochs, 4, block_size=29, device=CPU)
    assert streaming.ingest_trace_count() - before == 1
    assert got == windowed_oracle(211, [e[0] for e in epochs], 4)
    # epochs smaller than one block: the pow2 tail shape is sticky (8, then 32)
    sizes = [5, 20, 9, 14, 6]
    epochs = [[rng.integers(0, 209, size=(m, 2)).astype(np.int32)] for m in sizes]
    before = streaming.ingest_trace_count()
    got = streaming.count_windowed_stream(209, epochs, 3, block_size=4096, device=CPU)
    assert got == windowed_oracle(209, [e[0] for e in epochs], 3)
    assert streaming.ingest_trace_count() - before == 2


# --------------------------------------------------------------------------
# Re-blocking
# --------------------------------------------------------------------------
def test_block_buffer_emits_the_references_blocks():
    g = gen.gnp(33, 0.6, seed=4)
    chunks = [g.edges[i:i + 7] for i in range(0, g.n_edges, 7)]
    buf, rbuf = streaming.BlockBuffer(33, block_size=20, device=CPU), \
        ref.BlockBuffer(33, block_size=20)
    got, want = [], []
    for c in chunks:
        got += buf.push(c)
        want += rbuf.push(c)
    got.append(buf.flush())
    want.append(rbuf.flush())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert buf.flush() is None
    # never filled: the pow2 floor, not the block size
    small = streaming.BlockBuffer(50, block_size=1 << 20, device=CPU)
    assert small.push(np.array([[1, 2], [2, 3], [1, 3]])) == []
    assert small.flush().shape == (8, 2)


def test_block_buffer_resize_and_shape_state_follow_the_reference():
    rng = np.random.default_rng(3)
    e = rng.integers(0, 40, (300, 2)).astype(np.int32)
    buf, rbuf = streaming.BlockBuffer(40, device=CPU), ref.BlockBuffer(40)
    for b in (e[:50], e[50:61]):
        assert [x.shape for x in buf.push(b)] == [x.shape for x in rbuf.push(b)]
    assert [x.shape for x in buf.set_block_size(16)] == \
        [x.shape for x in rbuf.set_block_size(16)]
    assert buf.export_shape_state() == rbuf.export_shape_state()
    assert buf.flush().shape == rbuf.flush().shape
    with pytest.raises(ValueError):
        buf.set_block_size(0)
    fresh = streaming.BlockBuffer(40, device=CPU)
    fresh.import_shape_state(buf.export_shape_state())
    assert fresh.export_shape_state() == buf.export_shape_state()


def test_block_buffer_concurrent_mutation_raises():
    buf = streaming.BlockBuffer(64, block_size=8, device=CPU)
    entered, release = threading.Event(), threading.Event()

    class _SlowEdges:
        def __array__(self, dtype=None, copy=None):
            entered.set()
            release.wait(10)
            return np.zeros((4, 2), np.int32)

    t = threading.Thread(target=buf.push, args=(_SlowEdges(),))
    t.start()
    assert entered.wait(10)
    try:
        with pytest.raises(RuntimeError, match="single-producer"):
            buf.flush()
        with pytest.raises(RuntimeError, match="single-producer"):
            buf.push(np.zeros((2, 2), np.int32))
    finally:
        release.set()
        t.join(10)
    assert buf.flush() is not None


# --------------------------------------------------------------------------
# Front door, devices, launches
# --------------------------------------------------------------------------
def test_validate_edges_matches_reference():
    for good in (np.array([[0, 1], [2, 3]]), [[1, 2]], np.zeros((0, 2)), []):
        np.testing.assert_array_equal(streaming.validate_edges(good, 4),
                                      ref.validate_edges(good, 4))
        assert streaming.validate_edges(good, 4).dtype == np.int32
    for bad, msg in ((np.array([[1.5, 2.0]]), "integer"),
                     (np.array([1, 2, 3]), r"\(B, 2\)"),
                     (np.array([[0, 4]]), r"\[0, 4\)"), (np.array([[-1, 2]]), r"\[0, 4\)")):
        for fn in (streaming.validate_edges, ref.validate_edges):
            with pytest.raises(ValueError, match=msg):
                fn(bad, 4)


def test_cpu_states_run_the_plain_versions_and_launch_nothing():
    before = launch_counts()
    g = gen.gnp(40, 0.5, seed=2)
    assert streaming.count_stream(40, [g.edges], device=CPU) == count_triangles_brute(g)
    streaming.count_windowed_stream(40, [[g.edges], [g.edges[:10]]], 2, device=CPU)
    assert launch_counts() == before


def test_core_entry_points_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: streaming.init_state(8), lambda: streaming.init_sharded_state(8, 2),
                 lambda: streaming.init_windowed_state(8, 2),
                 lambda: streaming.init_windowed_sharded_state(8, 2, 2),
                 lambda: streaming.BlockBuffer(8), lambda: streaming.count_stream(8, []),
                 lambda: streaming.count_windowed_stream(8, [], 2),
                 lambda: streaming.restore_state({"count": np.zeros((), np.int64)})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
