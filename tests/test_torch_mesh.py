"""The port's ring mesh (``repro_torch.launch.mesh``), its mesh runtimes
(``core.dynamic_pipeline``: ``ring_stream``, ``DynamicPipeline``,
``ShardedStateStream``), the mesh ingests of ``core.streaming`` and the
mesh paths of the counter, the server and admission, against the
reference's.

The meshes here are rings of ``cpu`` stages at small sizes: the same code
that runs each stage on its own CUDA stream runs them in order on the host.
Inputs are made with numpy from seeds; counts are compared as integers and
state arrays exactly, after every block, against the reference's emulated
sharded state (the same (S, ...) layout a mesh snapshot has). One
module-scoped subprocess runs the reference on 8 forced host devices, as
its own mesh tests do, for its mesh ring counts, a mesh session's
checkpoint and a multiplexer's verdicts on the mesh. Admission on a mesh is
arithmetic, so it is tested with meshes of ``cuda`` device descriptors,
which need no card to construct."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import Plan as RefPlan  # noqa: E402
from repro.api import Resources as RefResources  # noqa: E402
from repro.api import TriangleCounter as RefTriangleCounter  # noqa: E402
from repro.core import streaming as ref_streaming  # noqa: E402
from repro.core import triangle_pipeline as ref_tp  # noqa: E402
from repro.core.dynamic_pipeline import FilterSpec as RefFilterSpec  # noqa: E402
from repro.core.dynamic_pipeline import run_sequential as ref_run_sequential  # noqa: E402
from repro.core.triangle_ref import count_triangles_brute  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs.formats import canonical_edges  # noqa: E402
from repro_torch.api import (  # noqa: E402
    Plan,
    Resources,
    SessionCheckpoint,
    TriangleCounter,
    admit_session,
    count_triangles,
    device_state_bytes,
    mesh_admission,
    planner,
)
from repro_torch.convert import graph_from_arrays  # noqa: E402
from repro_torch.core import dynamic_pipeline as dp  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.core import triangle_pipeline as tp  # noqa: E402
from repro_torch.launch import RingMesh, make_ring_mesh  # noqa: E402
from repro_torch.serve import StreamMultiplexer, TriangleServer  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _cpu_mesh(n_stages):
    return make_ring_mesh(n_stages, devices=["cpu"] * n_stages)


def _cuda_mesh(indices):
    """A mesh of CUDA device descriptors: constructible without a card."""
    return RingMesh(tuple(torch.device("cuda", i) for i in indices))


def _graph(n, m, seed):
    """(reference graph, port graph) of ``m`` seeded edge draws on ``n``
    nodes (self-loops and duplicates dropped)."""
    raw = np.random.default_rng(seed).integers(0, n, size=(m, 2))
    ref_g = canonical_edges(raw[raw[:, 0] != raw[:, 1]], n_nodes=n)
    return ref_g, graph_from_arrays(n, ref_g.edges)


def _stream(n, m, seed):
    """``m`` seeded int32 edge draws, self-loops and duplicates kept (the
    ingest ignores them)."""
    return np.random.default_rng(seed).integers(0, n, size=(m, 2)).astype(np.int32)


def _ragged(e, seed, typical):
    rng = np.random.default_rng(seed)
    cuts = np.cumsum(rng.integers(1, 2 * typical, size=len(e) // typical + 2))
    return np.split(e, cuts[cuts < len(e)])


def _arrays_equal(port_arrays, ref_arrays):
    """Snapshot arrays equal key for key: bitsets bit for bit as uint32,
    counts and heads as integers."""
    assert sorted(port_arrays) == sorted(ref_arrays)
    for k in port_arrays:
        a, b = np.asarray(port_arrays[k]), np.asarray(ref_arrays[k])
        assert a.shape == b.shape, k
        if k in ("adj", "epochs"):
            assert a.dtype == b.dtype == np.uint32, k
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


# --------------------------------------------------------------------------
# The mesh itself
# --------------------------------------------------------------------------
def test_make_ring_mesh_never_wraps_onto_fewer_devices():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for n in (have + 1, have + 4):
        with pytest.raises(ValueError, match="CUDA devices"):
            make_ring_mesh(n)
    if have == 0:
        with pytest.raises(ValueError, match="CUDA devices"):
            make_ring_mesh()
    with pytest.raises(ValueError, match="n_stages=3"):
        make_ring_mesh(3, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="device type"):
        RingMesh((torch.device("cpu"), torch.device("cuda", 0)))


def test_ring_mesh_shape_sharing_and_hashing():
    one_card = make_ring_mesh(4, devices=[torch.device("cuda", 0)] * 4)
    assert one_card.axis_names == ("stage",) and one_card.shape == {"stage": 4}
    assert one_card.size == 4 and one_card.device_type == "cuda"
    assert one_card.physical_devices() == (torch.device("cuda", 0),)
    assert one_card.stages_per_device() == 4
    # "cuda" is cuda:0, so the two meshes are one key
    assert make_ring_mesh(devices=["cuda"] * 4) == one_card
    assert hash(make_ring_mesh(devices=["cuda"] * 4)) == hash(one_card)
    eight = _cuda_mesh(range(8))
    assert eight.stages_per_device() == 1 and len(eight.physical_devices()) == 8
    assert _cuda_mesh([0, 0, 1, 1]).stages_per_device() == 2
    assert _cpu_mesh(8).stages_per_device() == 8
    assert streaming.make_mesh_ingest(_cpu_mesh(4)) is streaming.make_mesh_ingest(_cpu_mesh(4))
    # one runtime per mesh: the ring and the sharded state on the same streams
    rt = dp.mesh_runtime(_cpu_mesh(4), "stage")
    assert rt is dp.mesh_runtime(_cpu_mesh(4), "stage") is not dp.mesh_runtime(_cpu_mesh(2), "stage")
    assert dp.ShardedStateStream.shared(_cpu_mesh(4)) is rt.sharded
    assert rt.pipeline.streams is rt.sharded.streams and rt.pipeline.n_stages == 4


# --------------------------------------------------------------------------
# ring_stream and DynamicPipeline against the reference's chain
# --------------------------------------------------------------------------
def test_ring_stream_visits_every_block_once_with_its_source_tag():
    """tests/test_dynamic_pipeline.py's conservation invariant on a
    four-stage mesh: each stage folds each streamed block exactly once,
    tagged with the stage it came from, and the pipeline's total equals the
    reference's chain on the same numpy inputs."""
    n_stages, b = 4, 3
    mesh = _cpu_mesh(n_stages)
    resident = np.arange(n_stages, dtype=np.float32).reshape(n_stages, 1)
    stream = np.arange(n_stages * b, dtype=np.float32).reshape(n_stages, b)
    visits = []

    def process(carry, block, src):
        visits.append((int(carry[0][0]), src, float(block.sum())))
        return carry[0], carry[1] + carry[0][0] * block.sum()

    carries = [(torch.from_numpy(resident[s]), torch.zeros(())) for s in range(n_stages)]
    blocks = [torch.from_numpy(stream[s]) for s in range(n_stages)]
    out = dp.ring_stream(process, carries, blocks, mesh=mesh,
                         streams=dp.StageStreams(mesh))
    assert sorted(visits) == sorted((s, t, float(stream[t].sum()))
                                    for s in range(n_stages) for t in range(n_stages))
    want = sum(float(r) for r in range(n_stages)) * float(stream.sum())
    assert float(sum(c[1] for c in out)) == want

    spec = dp.FilterSpec(init=lambda r: (r, torch.zeros(())),
                         process=lambda st, blk, src: (st[0], st[1] + st[0][0] * blk.sum()),
                         finalize=lambda st: st[1])
    ref_spec = RefFilterSpec(init=lambda r: (r, jax.numpy.zeros(())),
                             process=lambda st, blk, src: (st[0],
                                                           st[1] + st[0][0] * blk.sum()),
                             finalize=lambda st: st[1])
    got = dp.DynamicPipeline(mesh).run(spec, torch.from_numpy(resident),
                                       torch.from_numpy(stream))
    ref = ref_run_sequential(ref_spec, jax.numpy.asarray(resident),
                             jax.numpy.asarray(stream), n_stages)
    assert float(got) == float(ref) == want


def test_pipeline_memo_is_per_spec_and_bounded():
    pipe = dp.DynamicPipeline(_cpu_mesh(2))
    assert tp.dense_ring_spec(16) is tp.dense_ring_spec(16)
    assert tp.bitset_ring_spec() is tp.bitset_ring_spec()
    fn = pipe.jit(tp.dense_ring_spec(16))
    assert pipe.jit(tp.dense_ring_spec(16)) is fn
    for r in range(dp._SPEC_MEMO + 8):
        pipe.jit(dp.FilterSpec(init=None, process=None, finalize=lambda st, r=r: r))
    assert len(pipe._memo) == dp._SPEC_MEMO
    with pytest.raises(ValueError, match="no axis"):
        dp.DynamicPipeline(_cpu_mesh(2), "data")


@pytest.mark.parametrize("n_stages", [2, 4, 8])
@pytest.mark.parametrize("n,m,seed", [(96, 1800, 5), (150, 700, 6)])
def test_rings_on_a_mesh_equal_the_reference_chain(n_stages, n, m, seed):
    ref_g, g = _graph(n, m, seed)
    want = count_triangles_brute(ref_g)
    mesh = _cpu_mesh(n_stages)
    ref_dense = ref_tp.count_triangles_ring(ref_g, n_stages=n_stages, sequential=True)
    ref_bitset = ref_tp.count_triangles_bitset_ring(ref_g, n_stages=n_stages,
                                                    sequential=True)
    assert tp.count_triangles_ring(g, mesh=mesh) == ref_dense == want
    assert tp.count_triangles_bitset_ring(g, mesh=mesh) == ref_bitset == want
    # the sequential flag keeps the chain on the mesh's first device
    assert tp.count_triangles_ring(g, mesh=mesh, sequential=True) == want
    # through the counter: same counts, the reference's cache keys
    res = Resources(n_devices=n_stages)
    c = TriangleCounter(res, mesh=mesh)
    ref_c = RefTriangleCounter(RefResources(n_devices=n_stages))
    assert c.device == torch.device("cpu") and c.mesh_matches(n_stages)
    for method in ("ring", "bitset_ring"):
        p = Plan(method=method, n_stages=n_stages)
        r = c.count(g, plan=p)
        ref_r = ref_c.count(ref_g, plan=RefPlan(method=method, n_stages=n_stages))
        assert r.item() == int(ref_r.count) == want
        assert r.stats["cache"]["key"] == ref_r.stats["cache"]["key"]
        assert r.stats["stage_costs"] == ref_r.stats["stage_costs"]


def test_a_ring_plan_of_another_width_runs_the_chain():
    ref_g, g = _graph(80, 900, 7)
    c = TriangleCounter(Resources(n_devices=4), mesh=_cpu_mesh(4))
    calls = []
    pipe_run = dp.DynamicPipeline.run

    def counting_run(self, spec, resident, stream):
        calls.append(self.n_stages)
        return pipe_run(self, spec, resident, stream)

    dp.DynamicPipeline.run = counting_run
    try:
        assert c.count(g, plan=Plan(method="ring", n_stages=2)).item() \
            == count_triangles_brute(ref_g)
        assert calls == []
        assert c.count(g, plan=Plan(method="ring", n_stages=4)).item() \
            == count_triangles_brute(ref_g)
        assert calls == [4]
    finally:
        dp.DynamicPipeline.run = pipe_run
    assert not c.mesh_matches(2) and not c.mesh_matches(1) and c.mesh_matches(4)
    assert not TriangleCounter(device="cpu", mesh=_cpu_mesh(1)).mesh_matches(1)


def test_counter_refuses_a_mesh_of_another_device_type():
    with pytest.raises(ValueError, match="mesh of 'cuda' stages"):
        TriangleCounter(Resources(), device="cpu", mesh=_cuda_mesh(range(2)))
    with pytest.raises(ValueError, match="not of the mesh's type"):
        tp.count_triangles_ring(_graph(20, 60, 1)[1], mesh=_cuda_mesh(range(2)),
                                device="cpu")


def test_count_triangles_falls_through_to_the_mesh_rings():
    ref_g, g = _graph(90, 1200, 8)
    want = count_triangles_brute(ref_g)
    mesh = _cpu_mesh(4)
    assert count_triangles(g, method="ring", mesh=mesh) == want
    assert count_triangles(g, method="bitset", mesh=mesh) == want
    assert count_triangles(g, method="ring", mesh=mesh, sequential=True) == want
    assert count_triangles(g, method="bitset", n_stages=3, sequential=True,
                           device="cpu") == want
    assert ref_tp.count_triangles(ref_g, method="ring", n_stages=4, sequential=True) \
        == count_triangles(g, method="ring", n_stages=4, sequential=True, device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        count_triangles(g, method="dense", mesh=mesh)


# --------------------------------------------------------------------------
# Mesh streams: every state array against the reference's emulated sharding
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_stages", [2, 4, 8])
def test_interleaved_mesh_sessions_equal_the_reference_after_every_block(n_stages):
    """tests/test_serve_sessions.py's interleaved mesh-sharded sessions on
    a mesh of ``n_stages`` cpu stages: after every feed each session's
    state equals the reference's emulated sharded state fed the same
    blocks, and the counts equal the brute count."""
    n = 200
    p = Plan(method="stream", n_stages=n_stages, block_size=300)
    c = TriangleCounter(plan=p, mesh=_cpu_mesh(n_stages))
    ref_c = RefTriangleCounter(plan=RefPlan(method="stream", n_stages=n_stages,
                                            block_size=300))
    graphs = [ref_gen.gnp(n, 0.2, seed=s) for s in (11, 13)]
    feeds = [_ragged(g.edges[np.random.default_rng(g.n_edges).permutation(g.n_edges)],
                     g.n_edges, 250) for g in graphs]
    with jax.enable_x64(True):
        sessions = [c.open_stream(n) for _ in graphs]
        ref_sessions = [ref_c.open_stream(n) for _ in graphs]
        for j in range(max(len(f) for f in feeds)):
            for s, rs, f in zip(sessions, ref_sessions, feeds):
                if j < len(f):
                    s.feed(f[j])
                    rs.feed(f[j])
                    assert isinstance(s.state["adj"], list)
                    _arrays_equal(streaming.snapshot_state(s.state),
                                  ref_streaming.snapshot_state(rs.state))
        results = [s.finalize() for s in sessions]
        for s, rs, g, r in zip(sessions, ref_sessions, graphs, results):
            ref_r = rs.finalize()
            assert r.item() == ref_r.item() == count_triangles_brute(g)
            _arrays_equal(streaming.snapshot_state(s.state),
                          ref_streaming.snapshot_state(rs.state))
            assert r.stats["on_mesh"] and r.stats["sharded"] and not ref_r.stats["on_mesh"]
            assert r.stats["cache"]["key"][1] == ("stream", n, 300, True)


@pytest.mark.parametrize("n_stages", [2, 4, 8])
def test_mesh_window_equals_the_reference_after_every_block(n_stages):
    """tests/test_windowed_stream.py's mesh window: a windowed session on
    the mesh equals the reference's emulated sharded window after every
    feed and every slide, and the core-level ``count_windowed_stream(mesh=)``
    equals the reference's."""
    n, window = 200, 3
    epochs = [_stream(n, 250, 31 + t) for t in range(7)]
    mesh = _cpu_mesh(n_stages)
    p = Plan(method="stream", n_stages=n_stages, block_size=128, window_epochs=window)
    s = TriangleCounter(plan=p, mesh=mesh).open_stream(n)
    with jax.enable_x64(True):
        rs = RefTriangleCounter(plan=RefPlan(method="stream", n_stages=n_stages,
                                             block_size=128,
                                             window_epochs=window)).open_stream(n)
        for t, ep in enumerate(epochs):
            if t:
                s.advance()
                rs.advance()
                _arrays_equal(streaming.snapshot_state(s.state),
                              ref_streaming.snapshot_state(rs.state))
            for part in _ragged(ep, t, 60):
                s.feed(part)
                rs.feed(part)
                _arrays_equal(streaming.snapshot_state(s.state),
                              ref_streaming.snapshot_state(rs.state))
        r, ref_r = s.finalize(), rs.finalize()
        assert r.item() == ref_r.item()
        assert r.stats["on_mesh"] and r.stats["window_epochs"] == window
    got = streaming.count_windowed_stream(n, [[e] for e in epochs], window, block_size=128,
                                          n_stages=n_stages, mesh=mesh)
    emu = streaming.count_windowed_stream(n, [[e] for e in epochs], window, block_size=128,
                                          n_stages=n_stages, device="cpu")
    ref = ref_streaming.count_windowed_stream(n, [[e] for e in epochs], window,
                                              block_size=128, n_stages=n_stages)
    assert got == emu == ref == r.item()


@pytest.mark.parametrize("n_stages", [2, 4])
def test_count_stream_on_a_mesh_equals_the_reference(n_stages):
    n = 150
    e = _stream(n, 1500, 40)
    blocks = _ragged(e, 41, 90)
    mesh = _cpu_mesh(n_stages)
    got = streaming.count_stream(n, blocks, block_size=128, n_stages=n_stages, mesh=mesh)
    ref = ref_streaming.count_stream(n, blocks, block_size=128, n_stages=n_stages)
    assert got == ref
    # a mesh of another width emulates, as the reference does
    assert streaming.count_stream(n, blocks, block_size=128, n_stages=3, mesh=mesh,
                                  device="cpu") == ref
    r = TriangleCounter(plan=Plan(method="stream", n_stages=n_stages, block_size=128),
                        mesh=mesh).count_stream(n, blocks)
    assert r.item() == ref and r.stats["on_mesh"]


def test_mesh_state_layout_bytes_and_expiry():
    n, S, E = 100, 4, 3
    mesh = _cpu_mesh(S)
    st = streaming.init_sharded_state(n, S, mesh=mesh)
    ws = -(-(-(-n // 32)) // S)
    assert [tuple(a.shape) for a in st["adj"]] == [(n, ws)] * S
    assert streaming.state_nbytes(st) == S * n * ws * 4 + 8
    snap = streaming.snapshot_state(st)
    assert snap["adj"].shape == (S, n, ws) and snap["adj"].dtype == np.uint32
    back = streaming.restore_state(snap, mesh=mesh)
    assert isinstance(back["adj"], list) and len(back["adj"]) == S
    flat = streaming.restore_state(snap, device="cpu")
    assert tuple(flat["adj"].shape) == (S, n, ws)
    wst = streaming.init_windowed_sharded_state(n, E, S, mesh=mesh)
    for shard in wst["epochs"]:
        shard.fill_(-1)
    wst["counts"].fill_(5)
    streaming.expire_epoch(wst)
    assert int(wst["head"]) == 1 and wst["counts"].tolist() == [5, 0, 5]
    for shard in wst["epochs"]:
        assert bool((shard[1] == 0).all()) and bool((shard[[0, 2]] == -1).all())
    with pytest.raises(ValueError, match="stages on a mesh"):
        streaming.init_sharded_state(n, 2, mesh=mesh)


# --------------------------------------------------------------------------
# Checkpoints across mesh and emulated counters
# --------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 3])
def test_checkpoint_moves_between_mesh_and_emulated_counters(window):
    """tests/test_preemptible_serving.py's mesh checkpoint and restore,
    both ways between a mesh counter and an emulated one. After every op
    each state equals the reference's emulated session that took the same
    checkpoint (the checkpoint ingests the buffered tail, so blocks after it
    differ from an unbroken feed's); the finished state equals the
    reference's uninterrupted session; a restore onto the mesh that took
    the checkpoint adds no ingest key."""
    n, S = 200, 4
    mesh = _cpu_mesh(S)
    p = Plan(method="stream", n_stages=S, block_size=300, window_epochs=window or 0)
    ref_p = RefPlan(method="stream", n_stages=S, block_size=300,
                    window_epochs=window or 0)
    e = _stream(n, 2600, 17)
    ops = [("feed", b) for b in _ragged(e, 18, 200)]
    if window:
        ops = [op for i, f in enumerate(ops)
               for op in ([("advance", None)] if i and i % 3 == 0 else []) + [f]]
    cut = len(ops) // 2

    def run(session, todo):
        for kind, b in todo:
            session.feed(b) if kind == "feed" else session.advance()
        return session

    with jax.enable_x64(True):
        ref_s = run(RefTriangleCounter(plan=ref_p).open_stream(n), ops)
        ref_r = ref_s.finalize()
        want = ref_streaming.snapshot_state(ref_s.state)
        twin = RefTriangleCounter(plan=ref_p).open_stream(n)
        steps = []
        for i, op in enumerate(ops):
            if i == cut:
                twin.checkpoint()
            steps.append(ref_streaming.snapshot_state(run(twin, [op]).state))
    mesh_c, emu_c = TriangleCounter(plan=p, mesh=mesh), TriangleCounter(plan=p, device="cpu")
    for first, second in ((mesh_c, emu_c), (emu_c, mesh_c), (mesh_c, mesh_c)):
        s = first.open_stream(n)
        for i, op in enumerate(ops[:cut]):
            _arrays_equal(streaming.snapshot_state(run(s, [op]).state), steps[i])
        ck = s.checkpoint()
        assert ck.arrays["epochs" if window else "adj"].shape[0] == S
        keys = streaming.ingest_trace_count()
        rest = second.restore_stream(ck)
        for i, op in enumerate(ops[cut:], cut):
            _arrays_equal(streaming.snapshot_state(run(rest, [op]).state), steps[i])
        if second is mesh_c:
            assert isinstance(rest.state["epochs" if window else "adj"], list)
        if first is second:
            assert streaming.ingest_trace_count() == keys
        r = rest.finalize()
        assert r.item() == ref_r.item()
        assert r.stats["on_mesh"] == (second is mesh_c)
        _arrays_equal(streaming.snapshot_state(rest.state), want)


def test_reference_emulated_checkpoint_restores_onto_a_port_mesh(tmp_path):
    n, S = 200, 4
    e = _stream(n, 2400, 19)
    with jax.enable_x64(True):
        ref_c = RefTriangleCounter(plan=RefPlan(method="stream", n_stages=S, block_size=256))
        rs = ref_c.open_stream(n)
        rs.feed(e[:1100])
        ck = rs.checkpoint()
        ck.spill(str(tmp_path / "ref.npz"))
        rs.feed(e[1100:])
        ref_r = rs.finalize()
        want = ref_streaming.snapshot_state(rs.state)
    c = TriangleCounter(plan=Plan(method="stream", n_stages=S, block_size=256),
                        mesh=_cpu_mesh(S))
    s = c.restore_stream(SessionCheckpoint.from_file(str(tmp_path / "ref.npz")))
    s.feed(e[1100:])
    assert s.finalize().item() == ref_r.item()
    _arrays_equal(streaming.snapshot_state(s.state), want)


# --------------------------------------------------------------------------
# The reference on 8 forced host devices: one subprocess for the module
# --------------------------------------------------------------------------
REF_MESH_SNIPPET = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    from repro.api import Plan, Resources, TriangleCounter
    from repro.core import streaming
    from repro.core.triangle_pipeline import (count_triangles_bitset_ring,
                                              count_triangles_ring)
    from repro.graphs.formats import canonical_edges
    from repro.launch.mesh import make_ring_mesh
    from repro.serve import StreamMultiplexer

    out_dir = sys.argv[1]
    inp = np.load(os.path.join(out_dir, "inputs.npz"))
    mesh = make_ring_mesh(8)
    assert mesh.devices.size == 8
    out = {}
    g = canonical_edges(inp["graph"], n_nodes=int(inp["graph_n"]))
    out["ring"] = int(count_triangles_ring(g, mesh=mesh))
    out["bitset"] = int(count_triangles_bitset_ring(g, mesh=mesh))
    p = Plan(method="stream", n_stages=8, block_size=300)
    s = TriangleCounter(plan=p, mesh=mesh).open_stream(200)
    e, cut = inp["stream"], int(inp["cut"])
    s.feed(e[:cut])
    s.checkpoint().spill(os.path.join(out_dir, "mesh_ckpt.npz"))
    s.feed(e[cut:])
    r = s.finalize()
    out["session"] = r.item()
    out["on_mesh"] = bool(r.stats["on_mesh"])
    np.savez(os.path.join(out_dir, "final.npz"), **streaming.snapshot_state(s.state))
    out["window"] = streaming.count_windowed_stream(
        200, [[ep] for ep in inp["epochs"]], 3, block_size=128, n_stages=8, mesh=mesh)
    mux = StreamMultiplexer(TriangleCounter(
        Resources(n_devices=8, memory_bytes=int(inp["budget"])), mesh=mesh))
    verdicts = []
    for n in inp["opens"].tolist():
        sid = mux.open(n)
        active = mux.status(sid) == "active"
        rec = mux._recs[sid]
        verdicts.append([mux.status(sid),
                         rec.session.plan.n_stages if active else None,
                         rec.session.plan.state_layout if active else None,
                         mux.state_bytes_of(sid) if active else None,
                         mux.bytes_in_use])
    out["verdicts"] = verdicts
    print("REF_MESH " + json.dumps(out))
    """
)
# n = 4096 needs all 8 stages of the 280,000 B budget (262,144 B a shard),
# n = 1,024 all 8 of what is left; n = 64 is admitted dense, and the last
# two queue
REF_BUDGET = 280_000
REF_OPENS = (4096, 1024, 64, 300, 4096)


@pytest.fixture(scope="module")
def ref_mesh(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("ref_mesh")
    ref_g, _ = _graph(96, 1800, 5)
    np.savez(out_dir / "inputs.npz", graph=ref_g.edges, graph_n=ref_g.n_nodes,
             stream=_stream(200, 4000, 0), cut=1700,
             epochs=np.stack([_stream(200, 250, 31 + t) for t in range(7)]),
             budget=REF_BUDGET, opens=np.array(REF_OPENS))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_MESH_SNIPPET, str(out_dir)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    line = next(x for x in r.stdout.splitlines() if x.startswith("REF_MESH "))
    return out_dir, json.loads(line[len("REF_MESH "):])


def test_port_mesh_rings_equal_the_reference_on_eight_devices(ref_mesh):
    _, ref = ref_mesh
    ref_g, g = _graph(96, 1800, 5)
    mesh = _cpu_mesh(8)
    assert tp.count_triangles_ring(g, mesh=mesh) == ref["ring"] == count_triangles_brute(ref_g)
    assert tp.count_triangles_bitset_ring(g, mesh=mesh) == ref["bitset"]
    epochs = [_stream(200, 250, 31 + t) for t in range(7)]
    assert streaming.count_windowed_stream(200, [[ep] for ep in epochs], 3, block_size=128,
                                           n_stages=8, mesh=mesh) == ref["window"]


def test_reference_mesh_checkpoint_restores_onto_an_eight_stage_port_mesh(ref_mesh):
    out_dir, ref = ref_mesh
    assert ref["on_mesh"]
    ck = SessionCheckpoint.from_file(str(out_dir / "mesh_ckpt.npz"))
    assert ck.plan.n_stages == 8 and ck.arrays["adj"].shape[0] == 8
    c = TriangleCounter(plan=Plan(method="stream", n_stages=8, block_size=300),
                        mesh=_cpu_mesh(8))
    s = c.restore_stream(ck)
    assert isinstance(s.state["adj"], list) and len(s.state["adj"]) == 8
    e = _stream(200, 4000, 0)
    s.feed(e[1700:])
    r = s.finalize()
    assert r.item() == ref["session"] and r.stats["on_mesh"]
    with np.load(out_dir / "final.npz") as z:
        _arrays_equal(streaming.snapshot_state(s.state), {k: z[k] for k in z.files})


# --------------------------------------------------------------------------
# Admission on a mesh
# --------------------------------------------------------------------------
def _port_verdicts(mesh, opens=REF_OPENS, budget=REF_BUDGET):
    """The multiplexer's verdict for each open in turn (what ``open`` takes
    from ``_admission``) and its ledger, without allocating: a mesh of
    descriptors has no memory to allocate on."""
    c = TriangleCounter(Resources(n_devices=8, memory_bytes=budget), device="cpu")
    c.mesh = mesh  # admission reads only the mesh's layout
    mux = StreamMultiplexer(c)
    used, out, queued = 0, [], False
    for n in opens:
        adm, _ = mux._admission(n, used, None, preempt=True)
        if adm.admitted and not queued:
            used += adm.state_bytes
            out.append(["active", adm.plan.n_stages, adm.plan.state_layout,
                        adm.state_bytes, used])
        else:
            queued = True
            out.append(["queued", None, None, None, used])
    return out


def test_mesh_admission_on_distinct_devices_equals_the_reference(ref_mesh):
    _, ref = ref_mesh
    assert ref["verdicts"][0][:2] == ["active", 8]  # the per-stage discount applies
    assert _port_verdicts(_cuda_mesh(range(8))) == ref["verdicts"]
    res = Resources(n_devices=8, memory_bytes=REF_BUDGET)
    direct = mesh_admission(4096, res, _cuda_mesh(range(8)))
    assert direct == admit_session(4096, res)
    assert direct.action == "admit-sharded" and direct.state_bytes == 262_144


def test_stages_sharing_a_device_are_charged_their_sum():
    """The deliberate difference: the reference charges n²/8/S per stage
    on any matching mesh; where stages share a device the port charges what
    lands on it. Eight stages on one card give a session no memory, so the
    planner's sharded verdict is re-taken at ring width 1, verdict for
    verdict as without a mesh; a caller's eight-stage plan is charged all
    eight shards, padding included."""
    res = Resources(n_devices=8, memory_bytes=REF_BUDGET)
    one_card = _cuda_mesh([0] * 8)
    shared = mesh_admission(4096, res, one_card)
    assert shared == mesh_admission(4096, res, None)
    assert not shared.admitted and "ring width 1" in shared.reason
    assert mesh_admission(4096, res, _cuda_mesh(range(8))).action == "admit-sharded"
    opens = (1024, 1024, 300, 1024)
    got, plain = _port_verdicts(one_card, opens), _port_verdicts(None, opens)
    assert got == plain
    assert [v[:2] for v in plain] == [["active", 1]] * 3 + [["queued", None]]
    # 300 nodes: 10 words a row, 2 a shard, so eight shards pin 19,200 B
    # where the whole bitset pins 12,000 B
    p = Plan(method="stream", n_stages=8, block_size=256)
    assert planner.plan_state_bytes(300, p, one_card) == 8 * 4 * 300 * 2
    assert planner.plan_state_bytes(300, p, _cuda_mesh(range(8))) == 4 * 300 * 2
    assert planner.plan_state_bytes(300, p) == 8 * 4 * 300 * 2
    assert planner.plan_state_bytes(300, dataclasses.replace(p, n_stages=1)) == 12_000
    shard = 4 * 4096 * 16
    assert device_state_bytes(shard, 8, one_card) == 8 * shard
    assert device_state_bytes(shard, 8, _cuda_mesh([0, 1] * 4)) == 4 * shard
    assert device_state_bytes(shard, 8, _cuda_mesh(range(8))) == shard
    assert device_state_bytes(shard, 8, None) == 8 * shard
    assert device_state_bytes(shard, 4, _cuda_mesh(range(8))) == 4 * shard


def test_plan_admission_charges_what_the_plan_pins():
    """A caller's plan is admitted as it is: admitted where its charge fits,
    else preempting strictly-lower-priority actives (lowest priority, then
    largest state) until it fits, else queued; the prefetch blocks shrink
    the remainder first."""
    n, one_card = 1024, _cuda_mesh([0] * 4)
    p = Plan(method="stream", n_stages=4, block_size=256)
    whole = 4 * n * 32
    res = Resources(memory_bytes=3 * whole)
    a = planner.plan_admission(n, p, res, one_card)
    assert (a.action, a.plan, a.state_bytes) == ("admit-sharded", p, whole)
    assert planner.plan_admission(n, p, res, _cuda_mesh(range(4))).state_bytes == whole // 4
    assert planner.plan_admission(n, dataclasses.replace(p, n_stages=1), res).action \
        == "admit-dense"
    full = planner.plan_admission(n, p, res, one_card, bytes_in_use=2 * whole + 1)
    assert full.action == "queue" and full.plan is None
    actives = [(whole // 2, 0), (whole, 1), (whole // 2, 0)]
    pre = planner.plan_admission(n, p, res, one_card, bytes_in_use=3 * whole,
                                 priority=2, actives=actives)
    assert pre.action == "preempt" and pre.victims == (0, 2) and pre.plan == p
    pre = planner.plan_admission(n, p, res, one_card, bytes_in_use=3 * whole,
                                 priority=1, actives=[(whole // 2, 0), (whole, 0)])
    assert pre.action == "preempt" and pre.victims == (1,)
    assert planner.plan_admission(n, p, res, one_card, bytes_in_use=3 * whole,
                                  priority=0, actives=actives).action == "queue"
    depth = planner.plan_admission(n, p, res, one_card, bytes_in_use=2 * whole,
                                   prefetch_depth=2)
    assert depth.action == "queue" and "remain" in depth.reason
    depth = planner.plan_admission(n, p, Resources(memory_bytes=4 * whole), one_card,
                                   bytes_in_use=2 * whole, prefetch_depth=2)
    assert depth.action == "admit-sharded" and depth.plan.prefetch_depth == 2


def test_a_same_device_mesh_session_pins_its_whole_state():
    """On a real multiplexer over a mesh of eight cpu stages (one device):
    an adopted eight-stage mesh checkpoint and an open under an eight-stage
    plan are charged all eight shards, as their sessions pin them, and an
    open without a plan is planned at ring width 1, as without a mesh."""
    n, S = 4096, 8
    mesh = _cpu_mesh(S)
    res = Resources(n_devices=S, memory_bytes=8 << 20)
    p = Plan(method="stream", n_stages=S, block_size=256)
    s = TriangleCounter(plan=p, mesh=mesh).open_stream(n)
    s.feed(_stream(n, 3000, 3))
    ck = s.checkpoint()
    full = S * 4 * n * 16
    assert s.state_bytes == ck.state_bytes == full == streaming.state_nbytes(
        {"adj": s.state["adj"]})
    mux = StreamMultiplexer(TriangleCounter(res, mesh=mesh))
    sid = mux.adopt(ck)
    assert mux.bytes_in_use == full == mux.state_bytes_of(sid)
    r = mux.close(sid)
    assert r.stats["on_mesh"] and r.item() == s.finalize().item()
    assert mux.bytes_in_use == 0
    plain = StreamMultiplexer(TriangleCounter(res, device="cpu"))
    a, b = plain.open(n, plan=p), mux.open(n, plan=p)
    assert mux.bytes_in_use == plain.bytes_in_use == full
    assert plain._recs[a].plan.n_stages == mux._recs[b].plan.n_stages == S
    c = mux.open(n)
    assert mux._recs[c].plan.n_stages == 1 and mux.state_bytes_of(c) == 4 * n * 128
    mux.close(c)
    for m, sid in ((mux, b), (plain, a)):
        m.feed(sid, _stream(n, 3000, 3))
    r, r_plain = mux.close(b), plain.close(a)
    assert r.stats["on_mesh"] and not r_plain.stats["on_mesh"]
    assert r.item() == r_plain.item() == s.finalize().item()


def test_open_with_a_plan_queues_and_admits_under_that_plan():
    """``open(plan=)`` and ``TriangleServer.serve_streams(plan=)`` run
    sessions under the caller's plan: four-stage sessions on a mesh of one
    cpu device, charged their four shards; a waiter is admitted later under
    the plan it asked for, and every count equals the unsharded count."""
    n, S = 1024, 4
    whole = 4 * n * 32
    p = Plan(method="stream", n_stages=S, block_size=256)
    server = TriangleServer(Resources(memory_bytes=2 * whole), mesh=_cpu_mesh(S))
    mux = server.streams
    feeds = [_stream(n, 2500, seed) for seed in range(3)]
    want = [TriangleCounter(device="cpu").count_stream(
        n, [f], plan=dataclasses.replace(p, n_stages=1)).item() for f in feeds]
    sids = [server.open_stream(n, plan=p) for _ in feeds]
    assert [mux.status(s) for s in sids] == ["active", "active", "queued"]
    assert mux.bytes_in_use == 2 * whole
    for sid, f in zip(sids, feeds):
        server.feed(sid, f)
    got = [server.close_stream(sid) for sid in sids]
    assert [r.item() for r in got] == want
    assert all(r.plan.n_stages == S and r.stats["on_mesh"] for r in got)
    served = server.serve_streams([(n, [f], p) for f in feeds])
    assert [r.item() for r in served] == want and mux.bytes_in_use == 0
    assert all(r.plan.n_stages == S and r.stats["on_mesh"] for r in served)
    with pytest.raises(ValueError, match="'stream' plan"):
        mux.open(n, plan=dataclasses.replace(p, method="ring"))
    with pytest.raises(ValueError, match="conflicts"):
        mux.open(n, plan=p, window=2)
    with pytest.raises(ValueError, match="contradicts"):
        mux.open(n, plan=dataclasses.replace(p, use_kernel=True))
    with pytest.raises(ValueError, match="never be admitted"):
        mux.open(4 * n, plan=p)


def test_card_reserve_charges_every_delta_table_a_card_holds_at_once():
    """A mesh ingest's stages run at once on their streams, each with an
    (n, ceil(W/S)) delta table, so on one card the reserve charges S of
    them — at least one (n, W) table, more where W/S rounds up. Emulated
    stages take turns and reuse one."""
    n = 264_346  # NY
    w = -(-n // 32)
    p = Plan(method="stream", n_stages=4, block_size=8192)
    one_card = _cuda_mesh([0] * 4)
    ws = -(-w // 4)
    rows = planner._CARD_ROW_BYTES * 8192
    assert planner.ingest_scratch_bytes(n, p, one_card) == 4 * 4 * n * ws + rows
    assert 4 * 4 * n * ws >= 4 * n * w
    assert planner.ingest_scratch_bytes(n, p, _cuda_mesh(range(4))) == 4 * n * ws + rows
    assert planner.ingest_scratch_bytes(n, p) == 4 * n * ws + rows
    assert planner.card_reserve_bytes([(n, p)], one_card) \
        == planner.card_reserve_bytes([(n, p)]) + 3 * 4 * n * ws


def test_triangle_server_hands_its_mesh_to_the_counter():
    mesh = _cpu_mesh(4)
    server = TriangleServer(Resources(n_devices=4), mesh=mesh)
    assert server.counter.mesh is mesh and server.streams.counter is server.counter
    graphs = [ref_gen.gnp(120, 0.3, seed=s) for s in (1, 2)]
    reqs = [(g.n_nodes, _ragged(g.edges, 3, 100)) for g in graphs]
    server.streams.close(server.streams.open(64))  # an idle multiplexer again
    res = server.serve_streams(reqs)
    for g, r in zip(graphs, res):
        assert r.item() == count_triangles_brute(g)
    got = [server.counter.count(graph_from_arrays(g.n_nodes, g.edges),
                                plan=Plan(method="ring", n_stages=4)).item() for g in graphs]
    assert got == [count_triangles_brute(g) for g in graphs]
