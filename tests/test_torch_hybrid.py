"""The port's degree-aware hybrid stream state (``core.streaming``'s
``init_hybrid_state`` / ``ingest_block_hybrid`` / ``count_stream_hybrid``
and the counter's ``state_layout="hybrid"`` sessions) against the
reference's, and the per-edge bitset closure (K5) against the reference's
Pallas kernel in interpret mode.

Every stream is made with numpy from a seed and goes, block for block,
through ``repro.core.streaming.ingest_block_hybrid`` and the port's twin on
the CPU (where the port runs K5, K4 and K3's plain versions). After EVERY
block each state array must be identical: ``hub_adj`` as uint32,
``hub_ids``, ``hub_slot``, ``tail_nbr``, ``deg``, ``lost``, and ``count``
as an integer (the streams keep counts under 2**31, where the reference
counts in int32). One block shape for the module, as the reference's own
hybrid tests use, so JAX traces one ingest per (n, H, C, T)."""
from functools import partial

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import Plan as RefPlan  # noqa: E402
from repro.api import TriangleCounter as RefTriangleCounter  # noqa: E402
from repro.core import streaming as ref_streaming  # noqa: E402
from repro.core.triangle_pipeline import build_bitset_ring_operands  # noqa: E402
from repro.graphs import generators as gen  # noqa: E402
from repro.kernels.bitset_count.bitset_count import (  # noqa: E402
    bitset_edge_count_per_edge_kernel,
)
from repro_torch.api import (  # noqa: E402
    GraphStats,
    Plan,
    Resources,
    SessionCheckpoint,
    TriangleCounter,
    plan,
)
from repro_torch.core import streaming  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.bitset_count.ops import bitset_edge_count_per_edge  # noqa: E402

_BLOCK = 128  # one block shape for the whole module
_H, _C, _T = 256, 32, 16  # the reference tests' pressured but lossless config


# ---------------------------------------------------------------------------
# seeded topologies: the reference's hybrid harness, copied
# ---------------------------------------------------------------------------
def _gnp_edges(rng, n, p):
    iu = np.triu_indices(n, 1)
    keep = rng.random(len(iu[0])) < p
    return np.stack([iu[0][keep], iu[1][keep]], 1).astype(np.int32)


def _powerlaw_edges(rng, n, m, alpha=0.85):
    w = np.arange(1, n + 1, dtype=np.float64) ** -alpha
    w /= w.sum()
    return np.stack([rng.choice(n, m, p=w), rng.choice(n, m, p=w)], 1).astype(np.int32)


def _star_edges(rng, n):
    spokes = np.stack([np.zeros(n - 1, np.int32), np.arange(1, n, dtype=np.int32)], 1)
    return np.concatenate([spokes, _gnp_edges(rng, n, 8.0 / n)])


_TOPOLOGIES = [
    ("powerlaw", 300, lambda rng: _powerlaw_edges(rng, 300, 1800)),
    ("gnp_sparse", 256, lambda rng: _gnp_edges(rng, 256, 0.04)),
    ("gnp_dense", 96, lambda rng: _gnp_edges(rng, 96, 0.5)),
    ("star_hub", 200, lambda rng: _star_edges(rng, 200)),
]


def _mangle(rng, edges, n):
    """Duplicates, self-loops, reversed orientation, shuffled."""
    dups = edges[rng.integers(0, len(edges), size=len(edges) // 4)]
    loops = np.stack([rng.integers(0, n, 7, dtype=np.int32)] * 2, 1)
    e = np.concatenate([edges, dups, loops])
    flip = rng.random(len(e)) < 0.5
    e[flip] = e[flip][:, ::-1]
    rng.shuffle(e)
    return e


def _ragged_blocks(rng, edges):
    cuts = np.sort(rng.integers(0, len(edges), size=rng.integers(3, 9)))
    return [b for b in np.split(edges, cuts) if len(b)]


def _case(seed):
    rng = np.random.default_rng(seed)
    name, n, make = _TOPOLOGIES[seed % len(_TOPOLOGIES)]
    edges = _mangle(rng, make(rng), n)
    return name, n, edges, _ragged_blocks(rng, edges)


def _assert_same_state(port_state, ref_state, where):
    mine = streaming.snapshot_state(port_state)
    theirs = {k: np.asarray(v) for k, v in ref_state.items()}
    assert sorted(mine) == sorted(theirs), where
    for k, want in theirs.items():
        got = mine[k]
        if k == "count":
            assert int(got) == int(want), f"{where}: count {int(got)} != {int(want)}"
            assert got.dtype == np.int64
        else:
            assert got.dtype == want.dtype, f"{where}: {k} dtype {got.dtype} != {want.dtype}"
            assert np.array_equal(got, want), f"{where}: {k} differs"


def _differential(n, blocks, h, c, t):
    """Feed the same fixed-shape blocks to both packages; assert identical
    states after every block. Returns the port's final state."""
    ref_state = ref_streaming.init_hybrid_state(n, h, c)
    step = partial(ref_streaming.ingest_block_hybrid, hub_threshold=t)
    state = streaming.init_hybrid_state(n, h, c, device="cpu")
    for i, block in enumerate(streaming.padded_blocks(blocks, n, _BLOCK, device="cpu")):
        ref_state = step(ref_state, jnp.asarray(block.numpy()))
        assert streaming.ingest_block_hybrid(state, block, hub_threshold=t) is state
        _assert_same_state(state, ref_state, f"block {i}")
    return state


# ---------------------------------------------------------------------------
# the differential core: every state array equal after every block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(12))
def test_hybrid_state_equals_reference_after_every_block(seed):
    name, n, _, blocks = _case(seed)
    before = launch_counts()
    state = _differential(n, blocks, _H, _C, _T)
    assert launch_counts() == before  # CPU tensors run the plain versions
    want = streaming.count_stream(n, blocks, block_size=_BLOCK, device="cpu")
    assert int(state["count"]) == want, name
    assert streaming.hybrid_lost(state) == 0
    assert streaming.count_stream_hybrid(n, blocks, hub_slots=_H, tail_capacity=_C,
                                         hub_threshold=_T, block_size=_BLOCK,
                                         device="cpu") == want


def test_tail_overflow_promotes_instead_of_dropping():
    """Vertex 0's degree blows past a 4-slot buffer: it is promoted (a
    mandatory promotion), the count stays exact and nothing is lost."""
    rng = np.random.default_rng(99)
    n = 200
    spokes = np.stack([np.zeros(n - 1, np.int32), np.arange(1, n, dtype=np.int32)], 1)
    edges = np.concatenate([spokes, _gnp_edges(rng, n, 2.0 / n)])
    state = _differential(n, [edges], 64, 4, 64)
    assert int(state["count"]) == streaming.count_stream(n, [edges], block_size=_BLOCK,
                                                         device="cpu")
    assert streaming.hybrid_lost(state) == 0
    assert int(state["hub_slot"][0]) >= 0


def test_slot_exhaustion_counts_lost_endpoints_as_the_reference_does():
    """Two hub slots for a dense graph: the slots run out, buffers
    overflow, and ``lost`` grows exactly as the reference's (every array
    still equal after every block); the whole-stream twin raises."""
    rng = np.random.default_rng(7)
    edges = _gnp_edges(rng, 96, 0.5)
    state = _differential(96, [edges], 2, 4, 4)
    assert streaming.hybrid_lost(state) > 0
    assert int((state["hub_ids"] < 96).sum()) == 2  # every slot taken
    with pytest.raises(RuntimeError, match="dropped .* endpoint"):
        streaming.count_stream_hybrid(96, [edges], hub_slots=2, tail_capacity=4,
                                      hub_threshold=4, block_size=_BLOCK, device="cpu")


@pytest.mark.parametrize("n,h,cap", [(97, 8, 4), (256, 64, 32), (1025, 128, 16)])
def test_hybrid_state_nbytes_equals_the_allocation(n, h, cap):
    state = streaming.init_hybrid_state(n, h, cap, device="cpu")
    assert streaming.state_nbytes(state) == streaming.hybrid_state_nbytes(n, h, cap)
    ref = ref_streaming.init_hybrid_state(n, h, cap)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}


def test_planner_state_bytes_equal_the_session_allocation():
    """A planner-chosen hybrid stream pins exactly ``predicted_bytes``."""
    stats = GraphStats(n_nodes=200_000, n_edges=0, replication_factor=0, max_degree=0,
                       max_fwd_degree=0, edges_in_memory=False)
    p = plan(stats, Resources(memory_bytes=1 << 30))
    assert p.state_layout == "hybrid"
    s = TriangleCounter(Resources(memory_bytes=1 << 30), device="cpu").open_stream(
        200_000)
    assert s.plan == p
    assert s.state_bytes == p.predicted_bytes == streaming.hybrid_state_nbytes(
        200_000, p.hub_slots, p.tail_capacity)
    s.feed(np.array([[0, 1], [1, 2], [0, 2]], np.int32))
    res = s.finalize()
    assert res.item() == 1 and res.stats["state_bytes"] == p.predicted_bytes


def test_ingest_counts_one_hybrid_key_per_block_shape():
    _, n, _, blocks = _case(1)
    state = streaming.init_hybrid_state(n, _H, _C, device="cpu")
    for block in streaming.padded_blocks(blocks, n, _BLOCK, device="cpu"):
        streaming.ingest_block_hybrid(state, block, hub_threshold=_T)
    k0 = streaming.ingest_trace_count()
    state = streaming.init_hybrid_state(n, _H, _C, device="cpu")
    for block in streaming.padded_blocks(blocks, n, _BLOCK, device="cpu"):
        streaming.ingest_block_hybrid(state, block, hub_threshold=_T)
    assert streaming.ingest_trace_count() == k0


# ---------------------------------------------------------------------------
# the counter's sessions
# ---------------------------------------------------------------------------
def _hybrid_plan(h=_H, c=_C, t=_T, **kw):
    return Plan(method="stream", block_size=_BLOCK, state_layout="hybrid",
                hub_slots=h, tail_capacity=c, hub_threshold=t, reason="forced hybrid", **kw)


def _counter():
    return TriangleCounter(Resources(), device="cpu")


def test_checkpoint_restore_finalize_bit_identical(tmp_path):
    """Halfway checkpoint, spilled and restored on a fresh counter: every
    state array equals that of a session that took the same checkpoint and
    went on (the checkpoint's tail flush moves block boundaries, and with
    them promotion order, so the arrays of an unbroken feed may differ),
    and the count equals an uninterrupted session's."""
    _, n, edges, _ = _case(1)
    want = streaming.count_stream(n, [edges], block_size=_BLOCK, device="cpu")
    half = len(edges) // 2
    whole = _counter().open_stream(n, plan=_hybrid_plan())
    whole.feed(edges)
    kept = _counter().open_stream(n, plan=_hybrid_plan())
    kept.feed(edges[:half])
    ck = kept.checkpoint()
    kept.feed(edges[half:])
    assert ck.nbytes == ck.state_bytes == streaming.hybrid_state_nbytes(n, _H, _C)
    assert ck.arrays["hub_adj"].dtype == np.uint32
    ck.spill(str(tmp_path / "hybrid.npz"))
    s2 = _counter().restore_stream(SessionCheckpoint.from_file(str(tmp_path / "hybrid.npz")))
    s2.feed(edges[half:])
    assert s2.finalize().item() == kept.finalize().item() == whole.finalize().item() == want
    a, b = streaming.snapshot_state(kept.state), streaming.snapshot_state(s2.state)
    assert sorted(a) == sorted(b)
    assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
    s3 = _counter().open_stream(n, plan=_hybrid_plan())
    s3.feed(edges)
    assert s3.checkpoint().finalize_result().item() == want


def test_lossy_session_refuses_checkpoint_and_finalize():
    edges = _gnp_edges(np.random.default_rng(13), 96, 0.5)
    s = _counter().open_stream(96, plan=_hybrid_plan(2, 4, 4))
    s.feed(edges)
    with pytest.raises(RuntimeError, match="refusing to checkpoint .* dropped"):
        s.checkpoint()
    with pytest.raises(RuntimeError, match="dropped .* endpoint"):
        s.finalize()
    assert not s.closed


def test_reference_hybrid_spill_restores_in_the_port(tmp_path):
    """The reference's hybrid ``.npz`` (int32 count) restores in the port,
    which feeds on to the reference's count and state."""
    _, n, edges, _ = _case(2)
    half = len(edges) // 2
    ref_plan = RefPlan(method="stream", n_stages=1, block_size=_BLOCK,
                       state_layout="hybrid", hub_slots=_H, tail_capacity=_C,
                       hub_threshold=_T, reason="forced hybrid")
    rs = RefTriangleCounter().open_stream(n, plan=ref_plan)
    rs.feed(edges[:half])
    path = str(tmp_path / "ref.npz")
    rs.checkpoint().spill(path)
    rs.feed(edges[half:])
    want = rs.finalize().item()

    ck = SessionCheckpoint.from_file(path)
    assert ck.arrays["count"].dtype == np.int32 and ck.plan.state_layout == "hybrid"
    s = _counter().restore_stream(ck)
    assert s.state["count"].dtype == torch.int64 and s.state["hub_adj"].dtype == torch.int32
    s.feed(edges[half:])
    assert s.finalize().item() == want
    _assert_same_state(s.state, rs.state, "after restore")


def test_open_stream_rejects_hybrid_windowed_or_sharded_plans():
    c = _counter()
    for bad in (_hybrid_plan(8, 8, 8, window_epochs=2), _hybrid_plan(8, 8, 8, n_stages=2)):
        with pytest.raises(ValueError, match="hybrid"):
            c.open_stream(64, plan=bad)
    assert c.cache_info["entries"] == 0


# ---------------------------------------------------------------------------
# K5: the per-edge closure against the reference's seed kernel
# ---------------------------------------------------------------------------
def test_per_edge_closure_equals_reference_seed_kernel():
    """The port's ``bitset_edge_count_per_edge`` (its plain version on the
    CPU) against ``bitset_edge_count_per_edge_kernel(interpret=True)`` on the
    bitset ring's operands of G(100, 0.4), then with phantom edges, a real u
    beside a phantom v, and a ragged edge count."""
    g = gen.gnp(100, 0.4, seed=8)
    _, masks, edge_blocks = build_bitset_ring_operands(g, 2)
    for s in range(2):
        for t in range(2):
            want = bitset_edge_count_per_edge_kernel(
                jnp.asarray(masks[s]), jnp.asarray(edge_blocks[t]), interpret=True)
            got = bitset_edge_count_per_edge(torch.from_numpy(masks[s].view(np.int32)),
                                             torch.from_numpy(edge_blocks[t]))
            assert got.dtype == torch.int64 and int(got) == int(want)
    m = masks[0]
    n_pad = m.shape[0]
    rng = np.random.default_rng(3)
    e = rng.integers(0, n_pad, (37, 2)).astype(np.int32)  # ragged B
    e[::5, 0] = n_pad + 2        # phantom u: counts 0
    e[1::7, 1] = n_pad           # real u, phantom v: v clamps to n_pad - 1
    e[2] = (n_pad - 1, n_pad)
    want = bitset_edge_count_per_edge_kernel(jnp.asarray(m), jnp.asarray(e), interpret=True)
    got = bitset_edge_count_per_edge(torch.from_numpy(m.view(np.int32)), torch.from_numpy(e))
    assert int(got) == int(want) > 0
    # the real-u-phantom-v edge alone: popcount(m[u] & m[n_pad - 1])
    one = np.array([[5, n_pad]], np.int32)
    want = int(np.unpackbits((m[5] & m[n_pad - 1]).view(np.uint8)).sum())
    assert int(bitset_edge_count_per_edge(torch.from_numpy(m.view(np.int32)),
                                          torch.from_numpy(one))) == want
    assert int(bitset_edge_count_per_edge_kernel(jnp.asarray(m), jnp.asarray(one),
                                                 interpret=True)) == want


def test_per_edge_closure_checks_its_operands():
    m = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(B, 2\)"):
        bitset_edge_count_per_edge(m, torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="n_pad, W"):
        bitset_edge_count_per_edge(m[0], torch.zeros((4, 2), dtype=torch.int32))
