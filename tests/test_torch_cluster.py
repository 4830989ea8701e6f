"""The port's cluster tier (``repro_torch.serve.cluster``, ``ClusterServer``,
the planner's placement) held against the reference's.

- Frames: the port's protocol writes and reads the reference's frames byte
  for byte, both ways, over ``socket.socketpair``, and keeps every edge case
  of the reference's own protocol tests; ``jsonable`` turns torch tensors
  into numbers.
- Verdicts: ``worker_admission`` / ``place_session`` equal the reference's
  on a seeded grid of ``WorkerLoad``s (the reference under x64, so hybrid
  states charge the same bytes). On a ``cuda`` worker the port's verdict is
  the multiplexer's own under the card's reserve, which the reference does
  not charge (ROADMAP.md §C): pinned on a CPU multiplexer forced
  ``_on_card``.
- A subprocess cluster of ``--device cpu`` workers: the 16 mixed sessions,
  migration, the ledger, failover, a displaced session, ``ClusterServer``
  and a checkpoint the reference spilled — every count equal, as an
  integer, to the reference's in-process ``StreamMultiplexer`` (or the
  port's ``TriangleServer``), and int64.

The deliberate difference of the mesh worker: the reference's forces 8
host devices, so its mesh hosts the "whale" ring-sharded at 25,600 B a
stage in a 28,000 B budget. The port's CPU mesh worker puts its 8 stages
on one device, where shards add up, so it advertises ``mesh_devices = 0``
and the whale lands whole (1280²/8 = 204,800 B): the worker is given
``MESH_BUDGET`` = 210,000 B, which holds it and no 256-node session beside.
"""
import dataclasses
import json
import os
import socket
import struct

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import Resources as RefResources  # noqa: E402
from repro.api import TriangleCounter as RefTriangleCounter  # noqa: E402
from repro.api import WorkerLoad as RefWorkerLoad  # noqa: E402
from repro.api import place_session as ref_place_session  # noqa: E402
from repro.api import worker_admission as ref_worker_admission  # noqa: E402
from repro.serve.cluster import protocol as ref_protocol  # noqa: E402
from repro.serve.sessions import StreamMultiplexer as RefStreamMultiplexer  # noqa: E402
from repro_torch.api import (  # noqa: E402
    BackpressureError,
    Placement,
    Resources,
    TriangleCounter,
    WorkerLoad,
    place_session,
    planner,
    worker_admission,
)
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.launch import RingMesh  # noqa: E402
from repro_torch.serve import StreamMultiplexer, TriangleServer  # noqa: E402
from repro_torch.serve.cluster import ClusterRouter, WorkerClient, protocol  # noqa: E402
from repro_torch.serve.cluster import worker as worker_mod  # noqa: E402
from repro_torch.serve.cluster.protocol import WorkerDied  # noqa: E402
from repro_torch.serve.serve_loop import ClusterServer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 64  # every feed an exact multiple: no ragged-tail ingest on restore
MESH_BUDGET = 210_000  # the whale whole (204,800 B) and no 256-node session beside


def _blocks(n, p, seed):
    """Shuffled gnp edges cut into exact BS-row blocks (tail dropped)."""
    g = gen.gnp(n, p, seed=seed)
    rng = np.random.default_rng(seed)
    e = g.edges[rng.permutation(g.n_edges)]
    m = (len(e) // BS) * BS
    return [e[i:i + BS] for i in range(0, m, BS)]


def _ref_oracle():
    """The reference's in-process multiplexer, the counts' oracle."""
    return RefStreamMultiplexer(
        RefTriangleCounter(RefResources(memory_bytes=1 << 30)), block_size=BS)


def _spawn(**kw):
    return WorkerClient.spawn(device="cpu", **kw)


def _worker_traces(w: WorkerClient) -> int:
    reply, _ = w.rpc({"op": "stats"})
    return reply["ingest_traces"]


def _same_count(r, lr):
    """The cluster's count equals the oracle's as an integer, and is int64."""
    assert r.item() == lr.item()
    assert r.count.dtype == torch.int64


# --------------------------------------------------------------------------
# Frames: interchangeable with the reference's, and the reference's edge cases
# --------------------------------------------------------------------------
_ARRAYS = {"edges": np.array([[0, 1], [2, 3], [5, 4]], dtype=np.int32),
           "count": np.array(7, dtype=np.int64),
           "w": np.arange(6, dtype=np.float32).reshape(2, 3),
           "mask": np.array([True, False]),
           "empty": np.zeros((0, 2), dtype=np.int32)}
_HEADER = {"op": "feed", "sid": np.int64(3), "f": 0.5, "ok": np.bool_(True),
           "nested": {"a": [1, np.int32(2)], "b": None, "s": "x"}}


@pytest.mark.parametrize("writer,reader", [(protocol, ref_protocol),
                                           (ref_protocol, protocol)],
                         ids=["port_to_reference", "reference_to_port"])
def test_frames_decode_under_the_other_package(writer, reader):
    """A frame written by either package decodes under the other: same
    header, same array dtypes, shapes and bits (a 0-d array travels as one
    element, ``np.ascontiguousarray``'s at-least-1-d, in both packages)."""
    a, b = socket.socketpair()
    writer.send_msg(a, _HEADER, _ARRAYS)
    header, arrays = reader.recv_msg(b)
    assert header == {"op": "feed", "sid": 3, "f": 0.5, "ok": True,
                      "nested": {"a": [1, 2], "b": None, "s": "x"}}
    assert arrays.keys() == _ARRAYS.keys()
    for k, want in _ARRAYS.items():
        assert arrays[k].dtype == want.dtype
        assert arrays[k].shape == np.ascontiguousarray(want).shape
        assert np.array_equal(arrays[k].reshape(want.shape), want)
    a.close(), b.close()


def test_frames_are_the_reference_bytes():
    """Byte for byte: the port's frame of a header and arrays is the
    reference's."""
    got, want = [], []
    for mod, out in ((protocol, got), (ref_protocol, want)):
        a, b = socket.socketpair()
        mod.send_msg(a, _HEADER, _ARRAYS)
        a.close()
        while chunk := b.recv(1 << 16):
            out.append(chunk)
        b.close()
    assert b"".join(got) == b"".join(want)


def test_protocol_roundtrip_headers_and_arrays():
    """One frame carries a JSON header plus raw array buffers; dtype,
    shape, and bits survive the trip (numpy values in headers included)."""
    a, b = socket.socketpair()
    edges = np.array([[0, 1], [2, 3]], dtype=np.int32)
    count = np.array(7, dtype=np.int64)
    protocol.send_msg(a, {"op": "feed", "sid": np.int64(3), "f": 0.5},
                      {"edges": edges, "count": count})
    header, arrays = protocol.recv_msg(b)
    assert header == {"op": "feed", "sid": 3, "f": 0.5}
    assert arrays["edges"].dtype == np.int32
    assert np.array_equal(arrays["edges"], edges)
    assert arrays["count"].dtype == np.int64 and arrays["count"] == 7
    arrays["edges"][0, 0] = 9  # rebuilt buffers are writable copies
    a.close(), b.close()


def test_jsonable_turns_tensors_into_numbers():
    """A torch tensor in a stats reply becomes its numbers, never its repr
    (the reference's fallback would ship "tensor(5)")."""
    stats = {"count": torch.tensor(5, dtype=torch.int64),
             "wall": torch.tensor(0.25),
             "flag": torch.tensor(True),
             "per_stage": torch.arange(3, dtype=torch.int32),
             "nested": [torch.tensor([[1, 2]]), {"n": np.int64(4)}]}
    got = protocol.jsonable(stats)
    assert got == {"count": 5, "wall": 0.25, "flag": True, "per_stage": [0, 1, 2],
                   "nested": [[[1, 2]], {"n": 4}]}
    assert type(got["count"]) is int and type(got["wall"]) is float
    json.dumps(got)
    assert "tensor" in str(ref_protocol.jsonable(stats)["count"])  # the reference's repr


def test_protocol_eof_raises_worker_died():
    """A peer that vanishes mid-message surfaces as WorkerDied — the
    router's failure detector."""
    a, b = socket.socketpair()
    a.sendall(b"\x00\x00\x00\xff")  # length prefix, then silence
    a.close()
    with pytest.raises(WorkerDied):
        protocol.recv_msg(b)
    b.close()


def test_protocol_remote_errors_keep_their_type():
    """Worker-side failures re-raise as the original exception type, so
    budget refusals stay catchable as the port's BackpressureError."""
    with pytest.raises(BackpressureError, match="full"):
        protocol.raise_remote({"ok": False, "etype": "BackpressureError",
                               "error": "store full"})
    for etype, exc in (("KeyError", KeyError), ("ValueError", ValueError),
                       ("TypeError", TypeError), ("RuntimeError", RuntimeError)):
        with pytest.raises(exc):
            protocol.raise_remote({"ok": False, "etype": etype, "error": "e"})
    with pytest.raises(RuntimeError, match="SomethingOdd"):
        protocol.raise_remote({"ok": False, "etype": "SomethingOdd",
                               "error": "?"})


def test_protocol_oversized_frame_rejected_before_alloc():
    """A length prefix past MAX_FRAME_BYTES is a typed ProtocolError raised
    BEFORE any payload read."""
    assert protocol.MAX_FRAME_BYTES == ref_protocol.MAX_FRAME_BYTES
    a, b = socket.socketpair()
    a.sendall(struct.pack(">I", protocol.MAX_FRAME_BYTES + 1))
    with pytest.raises(protocol.ProtocolError, match="corrupt length"):
        protocol.recv_msg(b)
    a.close(), b.close()


def test_protocol_torn_frame_header_overrun():
    """A frame whose inner header length runs past the frame itself is a
    typed ProtocolError, not a json blow-up on garbage bytes."""
    a, b = socket.socketpair()
    payload = struct.pack(">I", 500) + b"x" * 8
    a.sendall(struct.pack(">I", len(payload)) + payload)
    with pytest.raises(protocol.ProtocolError, match="overruns"):
        protocol.recv_msg(b)
    a.close(), b.close()


def test_protocol_truncated_payload_is_worker_died_not_hang():
    """A peer that dies after the prefix but mid-payload surfaces as
    WorkerDied the moment the socket closes."""
    a, b = socket.socketpair()
    a.sendall(struct.pack(">I", 100) + b"x" * 10)  # 90 B never arrive
    a.close()
    with pytest.raises(WorkerDied, match="mid-message"):
        protocol.recv_msg(b)
    b.close()


def test_protocol_malformed_arrays_manifest_rejected():
    """An ``__arrays__`` manifest promising more buffer bytes than the
    frame carries is a typed ProtocolError."""
    a, b = socket.socketpair()
    head = json.dumps({"op": "feed", "sid": 0,
                       "__arrays__": [["edges", "<i4", [1 << 20, 2]]]}
                      ).encode()
    payload = struct.pack(">I", len(head)) + head
    a.sendall(struct.pack(">I", len(payload)) + payload)
    with pytest.raises(protocol.ProtocolError, match="overruns the frame"):
        protocol.recv_msg(b)
    a.close(), b.close()


# --------------------------------------------------------------------------
# Op parity of the port's own client, router and worker
# --------------------------------------------------------------------------
def _lint_module(rel):
    import sys

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tools.repro_lint.engine import Module

    path = os.path.join(REPO, "src", rel)
    with open(path) as f:
        return Module(path, rel, f.read())


def test_every_op_the_port_sends_its_worker_handles():
    """repro-lint R3 diffs the FIRST cluster worker it finds, the
    reference's: its own tables, applied to the port's client, router and
    worker, and to the port's worker-reachable raises against the port's
    ``raise_remote`` registry."""
    from tools.repro_lint.rules import protocol_parity as r3

    worker = _lint_module("repro_torch/serve/cluster/worker.py")
    handled = r3._handled_ops(worker)
    sent = {op for rel in ("repro_torch/serve/cluster/client.py",
                           "repro_torch/serve/cluster/router.py")
            for op, _ in r3._sent_ops(_lint_module(rel))}
    assert {"hello", "open", "feed", "advance", "checkpoint", "evict", "restore",
            "close", "status", "stats", "shutdown"} <= sent
    assert sent <= handled, sent - handled
    registry, _ = r3._registry(_lint_module("repro_torch/serve/cluster/protocol.py"))
    raised = {name for rel in r3._WORKER_REACHABLE
              for name, _ in r3._raised(_lint_module("repro_torch/" + rel))}
    assert raised - registry - r3._TRANSPORT == set()


# --------------------------------------------------------------------------
# Placement verdicts against the reference's
# --------------------------------------------------------------------------
def _verdict(adm):
    return (adm.action, adm.state_bytes,
            adm.plan.to_dict() if adm.plan is not None else None, adm.reason)


def _load_pair(rng, busy=0.0):
    """A (port, reference) pair of equal ``WorkerLoad``s; with probability
    ``busy`` the worker is nearly full."""
    width = int(rng.choice([1, 2, 4, 8]))
    mem = int(rng.integers(3_000, 4_000_000))
    mesh = int(rng.choice([0, width, 8 if width != 8 else 4]))
    charged = int(rng.integers(0, mem)) if rng.random() < 0.6 else 0
    if rng.random() < busy:
        charged = mem - int(rng.integers(0, 2_000))
    kw = dict(memory_bytes=mem, n_devices=width, max_stages=width)
    return (WorkerLoad(Resources(**kw), charged_bytes=charged, mesh_devices=mesh),
            RefWorkerLoad(RefResources(**kw), charged_bytes=charged, mesh_devices=mesh))


@pytest.mark.parametrize("seed", range(4))
def test_worker_admission_equals_reference_on_cpu_workers(seed):
    """Verdict for verdict (action, bytes, plan, reason) on a seeded grid of
    CPU ``WorkerLoad``s, dense, sharded, windowed and hybrid."""
    rng = np.random.default_rng(seed)
    actions = set()
    with jax.enable_x64(True):
        for _ in range(60):
            load, ref_load = _load_pair(rng)
            n = int(rng.choice([64, 256, 1000, 1280, 4096, 20_000]))
            window = int(rng.choice([0, 0, 2, 4]))
            got = worker_admission(n, load, window_epochs=window)
            want = ref_worker_admission(n, ref_load, window_epochs=window)
            assert _verdict(got) == _verdict(want)
            actions.add(got.action)
    assert {"admit-dense", "queue"} <= actions


@pytest.mark.parametrize("seed", range(3))
def test_place_session_equals_reference_on_cpu_workers(seed):
    """``place_session`` over seeded lists of up to four workers: the same
    action, worker, bytes and reason as the reference's."""
    rng = np.random.default_rng(100 + seed)
    actions = set()
    with jax.enable_x64(True):
        for _ in range(40):
            pairs = [_load_pair(rng, busy=0.7) for _ in range(int(rng.integers(0, 5)))]
            n = int(rng.choice([64, 256, 1280, 4096, 20_000]))
            window = int(rng.choice([0, 0, 2]))
            got = place_session(n, [p for p, _ in pairs], window_epochs=window)
            want = ref_place_session(n, [r for _, r in pairs], window_epochs=window)
            assert isinstance(got, Placement) and got.placed == want.placed
            assert (got.action, got.worker, got.state_bytes, got.reason) == \
                (want.action, want.worker, want.state_bytes, want.reason)
            if got.admission is not None:
                assert _verdict(got.admission) == _verdict(want.admission)
            actions.add(got.action)
    assert actions == {"place", "queue", "reject"}


def test_worker_admission_takes_the_discount_only_on_a_matching_mesh():
    """On a mesh of 8 distinct devices the whale is admit-sharded at 25,600
    B a stage, as in the reference; without that mesh it is re-taken at
    width 1 and does not fit."""
    res, ref_res = (R(memory_bytes=30_000, n_devices=8, max_stages=8)
                    for R in (Resources, RefResources))
    on_mesh = worker_admission(1280, WorkerLoad(res, mesh_devices=8))
    assert on_mesh.action == "admit-sharded" and on_mesh.plan.n_stages == 8
    assert on_mesh.state_bytes == 25_600
    assert _verdict(on_mesh) == _verdict(
        ref_worker_admission(1280, RefWorkerLoad(ref_res, mesh_devices=8)))
    off_mesh = worker_admission(1280, WorkerLoad(res, mesh_devices=0))
    assert not off_mesh.admitted


@pytest.mark.parametrize("window", [0, 2])
def test_advertised_mesh_width_gives_the_workers_own_verdict(window):
    """What ``hello`` advertises for a mesh makes ``worker_admission`` equal
    the worker multiplexer's ``mesh_admission``: the width for distinct
    devices, 0 where the stages share one (every ring plan re-taken at
    width 1)."""
    meshes = {"distinct": RingMesh(tuple(torch.device("cuda", i) for i in range(4))),
              "one card": RingMesh((torch.device("cuda", 0),) * 4),
              "cpu": RingMesh(("cpu",) * 4)}
    assert {k: worker_mod.advertised_mesh_devices(m) for k, m in meshes.items()} == \
        {"distinct": 4, "one card": 0, "cpu": 0}
    assert worker_mod.advertised_mesh_devices(None) == 0
    rng = np.random.default_rng(7 + window)
    sharded = 0
    for mesh in meshes.values():
        for _ in range(30):
            res = Resources(memory_bytes=int(rng.integers(5_000, 1_500_000)),
                            n_devices=4, max_stages=4)
            used = int(rng.integers(0, res.memory_bytes // 2))
            n = int(rng.choice([256, 1000, 1280, 2048]))
            got = worker_admission(n, WorkerLoad(
                res, charged_bytes=used,
                mesh_devices=worker_mod.advertised_mesh_devices(mesh)),
                window_epochs=window)
            want = planner.mesh_admission(n, res, mesh, bytes_in_use=used,
                                          window_epochs=window)
            assert _verdict(got) == _verdict(want)
            sharded += got.action == "admit-sharded"
    assert sharded > 0


def test_a_cuda_worker_verdict_is_its_multiplexers_under_the_card_reserve(monkeypatch):
    """The deliberate difference: on a ``cuda`` worker ``worker_admission``
    charges the card's reserve of the sessions placed there and the
    candidate, and equals the multiplexer's own verdict (here a CPU one
    forced ``_on_card``, the reserve shrunk to test sizes) at every open;
    the reference's rule would place sessions this worker queues. With no
    sessions on a CPU worker it is the reference's function."""
    monkeypatch.setattr(planner, "_CARD_FIXED_BYTES", 20_000)
    monkeypatch.setattr(planner, "_CARD_ROW_BYTES", 16)
    mem, n, bs = 200_000, 512, 128
    mux = StreamMultiplexer(TriangleCounter(Resources(memory_bytes=mem), device="cpu"),
                            block_size=bs)
    mux._on_card = True
    card = Resources(memory_bytes=mem, backend="cuda")
    placed, over_admitted = [], 0
    for _ in range(8):
        load = WorkerLoad(card, charged_bytes=mux.bytes_in_use, sessions=tuple(placed),
                          block_size=bs)
        adm = worker_admission(n, load)
        over_admitted += ref_worker_admission(
            n, RefWorkerLoad(RefResources(memory_bytes=mem),
                             charged_bytes=mux.bytes_in_use)).admitted and not adm.admitted
        sid = mux.open(n)
        assert mux.status(sid) == ("active" if adm.admitted else "queued")
        if not adm.admitted:
            break
        assert mux.state_bytes_of(sid) == adm.state_bytes
        placed.append((n, dataclasses.replace(adm.plan, block_size=bs)))
    assert 2 <= len(placed) < 8 and over_admitted == 1
    assert mux.bytes_in_use + mux.reserve_bytes <= mem
    # a CPU worker ignores sessions: the reference's verdict
    cpu = worker_admission(n, WorkerLoad(Resources(memory_bytes=mem),
                                         sessions=tuple(placed)))
    assert _verdict(cpu) == _verdict(ref_worker_admission(
        n, RefWorkerLoad(RefResources(memory_bytes=mem))))


def test_place_session_idle_check_drops_the_placed_sessions(monkeypatch):
    """A full ``cuda`` worker queues (it would fit idle, without its
    sessions' reserve); a session too large even then is rejected."""
    monkeypatch.setattr(planner, "_CARD_FIXED_BYTES", 20_000)
    monkeypatch.setattr(planner, "_CARD_ROW_BYTES", 1)
    card = Resources(memory_bytes=150_000, backend="cuda")
    first = worker_admission(512, WorkerLoad(card))
    assert first.admitted
    full = WorkerLoad(card, charged_bytes=first.state_bytes,
                      sessions=((512, first.plan),))
    assert place_session(512, [full]).action == "queue"
    assert ref_worker_admission(512, RefWorkerLoad(
        RefResources(memory_bytes=150_000), charged_bytes=first.state_bytes)).admitted
    assert place_session(4096, [full]).action == "reject"


# --------------------------------------------------------------------------
# The cluster itself: one CPU mesh worker + one plain worker, module-shared
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cluster():
    """Worker 0: 8 ring stages on the CPU, MESH_BUDGET — the whale whole,
    no 256-node session beside it. Worker 1: plain, 120,000 B."""
    wa = _spawn(memory_bytes=MESH_BUDGET, devices=8)
    wb = _spawn(memory_bytes=120_000)
    router = ClusterRouter([wa, wb], checkpoint_every_bytes=None)
    yield router
    router.shutdown()


def test_hello_advertises_a_shared_device_mesh_as_width_zero(cluster):
    wa, wb = cluster.workers
    assert (wa.resources.n_devices, wa.resources.max_stages, wa.mesh_devices) == (8, 8, 0)
    assert wa.resources.backend == wb.resources.backend == "cpu"
    assert (wb.resources.n_devices, wb.mesh_devices) == (1, 0)


def test_cluster_sixteen_mixed_sessions_equal_the_reference(cluster):
    """16 mixed sessions across 2 workers — the whale (on the mesh worker),
    10 dense, 5 windowed — every count equal to the reference's
    single-process multiplexer serving the same feeds."""
    router = cluster
    local = _ref_oracle()
    whale_blocks = _blocks(1280, 0.004, seed=2)
    dense_blocks = [_blocks(256, 0.05, seed=10 + i) for i in range(10)]
    win_blocks = [_blocks(128, 0.2, seed=30 + i) for i in range(5)]

    gw, lw = router.open(1280, block_size=BS), local.open(1280, block_size=BS)
    assert router.worker_of(gw) == 0
    gd = [router.open(256, block_size=BS) for _ in range(10)]
    ld = [local.open(256, block_size=BS) for _ in range(10)]
    gv = [router.open(128, block_size=BS, window=2) for _ in range(5)]
    lv = [local.open(128, block_size=BS, window=2) for _ in range(5)]
    assert all(router.worker_of(g) == 1 for g in gd + gv)
    assert all(router.status(g) == "active" for g in [gw] + gd + gv)
    assert router.stats()["sessions"] == 16

    for j in range(max(len(whale_blocks),
                       *(len(b) for b in dense_blocks + win_blocks))):
        if j < len(whale_blocks):
            router.feed(gw, whale_blocks[j])
            local.feed(lw, whale_blocks[j])
        for i, bl in enumerate(dense_blocks):
            if j < len(bl):
                router.feed(gd[i], bl[j])
                local.feed(ld[i], bl[j])
        for i, bl in enumerate(win_blocks):
            if j < len(bl):
                router.feed(gv[i], bl[j])
                local.feed(lv[i], bl[j])
                if j % 8 == 7:
                    router.advance(gv[i])
                    local.advance(lv[i])

    pairs = [(gw, lw)] + list(zip(gd, ld)) + list(zip(gv, lv))
    results = [router.close(g) for g, _ in pairs]
    for r, (_, l) in zip(results, pairs):
        _same_count(r, local.close(l))
    # the whale ran whole on the mesh worker (its stages share the CPU)
    assert results[0].plan.n_stages == 1 and results[0].stats["worker"] == 0
    assert results[0].stats["state_bytes"] == 1280 * 1280 // 8
    assert router.charged_bytes() == [0, 0]


def test_forced_migration_exact_and_no_new_ingest_keys(cluster):
    """Mid-stream migration: evict on the source, restore on the target —
    exact count, and no new ingest key on a target that already served the
    session's block shape."""
    router = cluster
    local = _ref_oracle()
    b1, b2 = _blocks(256, 0.05, seed=50), _blocks(256, 0.05, seed=51)
    s1, l1 = router.open(256, block_size=BS), local.open(256, block_size=BS)
    s2, l2 = router.open(256, block_size=BS), local.open(256, block_size=BS)
    assert router.worker_of(s1) == 0 and router.worker_of(s2) == 1
    half = len(b2) // 2
    for b in b1:
        router.feed(s1, b)
        local.feed(l1, b)
    for b in b2[:half]:
        router.feed(s2, b)
        local.feed(l2, b)
    before = _worker_traces(router.workers[0])
    assert router.migrate(s2, to=0) == 0
    assert router.worker_of(s2) == 0 and router.status(s2) == "active"
    for b in b2[half:]:
        router.feed(s2, b)
        local.feed(l2, b)
    assert _worker_traces(router.workers[0]) - before == 0
    for g, l in ((s1, l1), (s2, l2)):
        _same_count(router.close(g), local.close(l))
    assert router.stats()["migrations"] >= 1
    assert router.charged_bytes() == [0, 0]


def test_router_ledger_matches_planner_predictions(cluster):
    """At every step each worker's charged bytes equals the SUM of its
    sessions' independently recomputed predictions, through open, migrate
    and close, and each worker's own ``bytes_in_use`` agrees."""
    router = cluster
    sim = {0: 0, 1: 0}
    placed = {}

    def predict(n, wi, window):
        w = router.workers[wi]
        adm = worker_admission(
            n, WorkerLoad(w.resources, charged_bytes=sim[wi],
                          mesh_devices=w.mesh_devices),
            window_epochs=window or 0)
        assert adm.admitted
        return adm.state_bytes

    def check():
        assert router.charged_bytes() == [sim[0], sim[1]]
        st = router.stats()["workers"]
        assert [s["bytes_in_use"] for s in st] == [sim[0], sim[1]]

    def checked_open(n, window=None):
        gid = router.open(n, block_size=BS, window=window)
        wi = router.worker_of(gid)
        bytes_ = predict(n, wi, window)
        sim[wi] += bytes_
        placed[gid] = (wi, bytes_)
        check()
        return gid

    whale = checked_open(1280)
    gids = [checked_open(256) for _ in range(3)]
    gids += [checked_open(128, window=2) for _ in range(2)]

    wi, bytes_ = placed.pop(whale)
    router.close(whale)
    sim[wi] -= bytes_
    check()
    victim = gids[0]
    src, old_bytes = placed[victim]
    sim[src] -= old_bytes
    target = router.migrate(victim)
    bytes_ = predict(256, target, None)
    sim[target] += bytes_
    placed[victim] = (target, bytes_)
    check()

    for gid in gids:
        wi, bytes_ = placed[gid]
        router.close(gid)
        sim[wi] -= bytes_
        check()
    assert router.charged_bytes() == [0, 0]


def test_open_rejects_never_fits_and_queues_a_full_cluster(cluster):
    """Never-fits → ValueError; fits-but-not-now → BackpressureError, and
    no worker ever queues a session the router placed."""
    router = cluster
    with pytest.raises(ValueError, match="NEVER"):
        router.open(4096, block_size=BS)  # 2 MiB state: no worker, even idle
    fit = MESH_BUDGET // 8192 + 120_000 // 8192
    gids = [router.open(256, block_size=BS) for _ in range(fit)]
    with pytest.raises(BackpressureError, match="retry"):
        router.open(256, block_size=BS)
    st = router.stats()["workers"]
    assert [s["n_queued"] for s in st] == [0, 0]
    assert [s["n_active"] for s in st] == [MESH_BUDGET // 8192, 120_000 // 8192]
    for w in router.workers:  # past the router, each worker queues one more itself
        reply, _ = w.rpc({"op": "open", "n_nodes": 256, "block_size": BS})
        assert reply["status"] == "queued"
        reply, arrays = w.rpc({"op": "close", "sid": reply["sid"]})  # cancels it
        assert reply["plan"] is None and reply["stats"]["cancelled"]
        assert arrays["count"].dtype == np.int64 and int(arrays["count"][0]) == 0
    for gid in gids:
        router.close(gid)
    assert router.charged_bytes() == [0, 0]


def test_worker_unknown_op_is_typed_error_and_worker_survives(cluster):
    """An unknown op crosses back as the worker's ValueError, an unknown sid
    as its KeyError — and the worker keeps serving."""
    w = cluster.workers[1]
    with pytest.raises(ValueError, match="unknown op"):
        w.rpc({"op": "frobnicate"})
    reply, _ = w.rpc({"op": "ping"})
    assert reply["ok"] is True and w.alive
    with pytest.raises(KeyError, match="unknown session"):
        w.rpc({"op": "status", "sid": 12345})
    assert w.alive


def test_worker_garbage_frame_is_worker_died_never_hang(tmp_path):
    """Raw garbage on the worker socket (a frame recv_msg rejects) ends
    that connection: the client sees WorkerDied promptly instead of
    waiting forever on a reply that will never come."""
    w = _spawn(memory_bytes=1 << 26, log_dir=str(tmp_path))
    try:
        head = json.dumps({"op": "ping",
                           "__arrays__": [["edges", "<i4", [1 << 20, 2]]]}
                          ).encode()
        payload = struct.pack(">I", len(head)) + head
        w.sock.sendall(struct.pack(">I", len(payload)) + payload)
        with pytest.raises(WorkerDied):
            w.rpc({"op": "ping"})
        assert not w.alive
    finally:
        w.kill()


def test_a_reference_spill_restores_through_the_port_workers_restore_op(cluster, tmp_path):
    """A checkpoint the reference's multiplexer spilled mid-stream restores
    in a port worker (``restore``), finishes there over the wire, and
    counts what the reference counts uninterrupted."""
    w = cluster.workers[1]
    blocks = _blocks(256, 0.05, seed=90)
    half = len(blocks) // 2
    ref = _ref_oracle()
    sid, whole = ref.open(256, block_size=BS), ref.open(256, block_size=BS)
    for b in blocks[:half]:
        ref.feed(sid, b)
    path = str(tmp_path / "ref.npz")
    ckpt = ref.checkpoint(sid)
    ckpt.spill(path)
    reply, _ = w.rpc({"op": "restore", "path": path, "seq": 0})
    wsid = reply["sid"]
    assert reply["state_bytes"] == 256 * 256 // 8
    for seq, b in enumerate(blocks[half:], start=1):
        w.rpc({"op": "feed", "sid": wsid, "seq": seq}, {"edges": b})
    w.rpc({"op": "feed", "sid": wsid, "seq": 1}, {"edges": blocks[half]})  # deduped
    reply, arrays = w.rpc({"op": "close", "sid": wsid})
    for b in blocks:
        ref.feed(whole, b)
    assert arrays["count"].dtype == np.int64
    assert int(arrays["count"][0]) == ref.close(whole).item()


def test_router_ledger_covers_hybrid_sessions(tmp_path):
    """Workers whose budgets reject the n²/8 bitset (4096 nodes, 2 MiB)
    admit the hybrid state; the router charges exactly the predicted hybrid
    bytes (the port's, 4 B above the reference's int32 count without x64),
    migration moves them, closes drain to zero, and the counts equal the
    reference's."""
    wa = _spawn(memory_bytes=1_500_000, log_dir=str(tmp_path))
    wb = _spawn(memory_bytes=1_500_000, log_dir=str(tmp_path))
    n = 4096
    rng = np.random.default_rng(3)
    w = np.arange(1, n + 1, dtype=np.float64) ** -0.9
    w /= w.sum()
    m = 1536
    streams = [np.stack([rng.choice(n, m, p=w), rng.choice(n, m, p=w)],
                        1).astype(np.int32) for _ in range(2)]
    blocks = [[e[i:i + BS] for i in range(0, m, BS)] for e in streams]
    with ClusterRouter([wa, wb], checkpoint_dir=str(tmp_path),
                       checkpoint_every_bytes=None) as router:
        adm = worker_admission(n, WorkerLoad(router.workers[0].resources))
        assert adm.action == "admit-hybrid"
        want = adm.state_bytes
        with jax.enable_x64(True):
            assert ref_worker_admission(n, RefWorkerLoad(
                RefResources(memory_bytes=1_500_000))).state_bytes == want
        local = _ref_oracle()
        g1, l1 = router.open(n, block_size=BS), local.open(n, block_size=BS)
        g2, l2 = router.open(n, block_size=BS), local.open(n, block_size=BS)
        assert router.charged_bytes() == [want, want]
        half = len(blocks[0]) // 2
        for (g, l), bl in zip(((g1, l1), (g2, l2)), blocks):
            for b in bl[:half]:
                router.feed(g, b)
                local.feed(l, b)
        _same_count(router.close(g1), local.close(l1))
        assert router.charged_bytes() == [0, want]
        router.migrate(g2, to=0)
        assert router.worker_of(g2) == 0 and router.charged_bytes() == [want, 0]
        for b in blocks[1][half:]:
            router.feed(g2, b)
            local.feed(l2, b)
        r2 = router.close(g2)
        _same_count(r2, local.close(l2))
        assert r2.plan.state_layout == "hybrid"
        assert router.charged_bytes() == [0, 0]


# --------------------------------------------------------------------------
# Failover: SIGKILL a worker, sessions resurrect on the survivor
# --------------------------------------------------------------------------
def test_killed_worker_recovery_exact_counts_no_new_ingest_keys(tmp_path):
    """Kill a worker mid-stream: its checkpointed session resurrects from
    the spill + journal replay, its never-checkpointed one from a fresh
    open + FULL replay; exact counts, and the warm survivor records no new
    ingest key."""
    w0 = _spawn(memory_bytes=120_000, log_dir=str(tmp_path))
    w1 = _spawn(memory_bytes=120_000, log_dir=str(tmp_path))
    with ClusterRouter([w0, w1], checkpoint_dir=str(tmp_path),
                       checkpoint_every_bytes=None) as router:
        local = _ref_oracle()
        b_a, b_b, b_c = (_blocks(256, 0.05, seed=s) for s in (60, 61, 62))
        a = router.open(256, block_size=BS)
        b = router.open(256, block_size=BS)
        c = router.open(256, block_size=BS)
        assert [router.worker_of(s) for s in (a, b, c)] == [0, 1, 0]
        la, lb, lc = (local.open(256, block_size=BS) for _ in range(3))
        half = len(b_a) // 2
        for blocks, g, l in ((b_a, a, la), (b_b, b, lb), (b_c, c, lc)):
            for blk in blocks[:half]:
                router.feed(g, blk)
                local.feed(l, blk)
        assert router.checkpoint(a) is not None
        assert os.path.exists(router._ckpt_path(a))

        traces_before = _worker_traces(w1)
        w0.proc.kill()
        for blocks, g, l in ((b_a, a, la), (b_b, b, lb), (b_c, c, lc)):
            for blk in blocks[half:]:
                router.feed(g, blk)
                local.feed(l, blk)
        assert router.worker_of(a) == 1 and router.worker_of(c) == 1
        assert _worker_traces(w1) - traces_before == 0
        st = router.stats()
        assert st["worker_deaths"] == 1 and st["resurrections"] == 2
        assert st["workers"][0] == {"alive": False}
        for g, l in ((a, la), (b, lb), (c, lc)):
            _same_count(router.close(g), local.close(l))
        assert router.charged_bytes() == [0, 0]


def test_displaced_session_lands_when_capacity_frees(tmp_path):
    """A dead worker's session that fits NO survivor degrades to
    'displaced' (feeds journal, nothing lost) and lands on the next op
    after capacity frees."""
    w0 = _spawn(memory_bytes=9_000, log_dir=str(tmp_path))
    w1 = _spawn(memory_bytes=9_000, log_dir=str(tmp_path))
    with ClusterRouter([w0, w1], checkpoint_dir=str(tmp_path),
                       checkpoint_every_bytes=None) as router:
        local = _ref_oracle()
        blocks_a, blocks_b = _blocks(256, 0.05, 70), _blocks(256, 0.05, 71)
        a, b = (router.open(256, block_size=BS) for _ in range(2))
        la, lb = (local.open(256, block_size=BS) for _ in range(2))
        for blk in blocks_a:
            router.feed(a, blk)
            local.feed(la, blk)
        for blk in blocks_b[:2]:
            router.feed(b, blk)
            local.feed(lb, blk)
        router.checkpoint(b)
        router.workers[router.worker_of(b)].proc.kill()
        router.feed(b, blocks_b[2])
        local.feed(lb, blocks_b[2])
        assert router.status(b) == "displaced"
        assert router.stats()["displaced"] == 1
        _same_count(router.close(a), local.close(la))
        for blk in blocks_b[3:]:
            router.feed(b, blk)
            local.feed(lb, blk)
        assert router.status(b) == "active"
        _same_count(router.close(b), local.close(lb))


# --------------------------------------------------------------------------
# ClusterServer front door, and a worker with no card
# --------------------------------------------------------------------------
def test_cluster_server_serve_streams_equals_the_triangle_server(tmp_path):
    """``ClusterServer.serve_streams`` over spawn-spec CPU workers returns
    the port's ``TriangleServer.serve_streams`` counts, spread over both
    workers."""
    reqs = [(256, _blocks(256, 0.05, seed=80 + i)) for i in range(4)]
    spec = {"memory_bytes": 40_000, "device": "cpu"}
    with ClusterServer([spec, spec], checkpoint_dir=str(tmp_path)) as srv:
        got = srv.serve_streams(reqs, block_size=BS)
        st = srv.stats()
    want = TriangleServer(Resources(memory_bytes=1 << 30), device="cpu").serve_streams(
        reqs, block_size=BS)
    assert [r.item() for r in got] == [r.item() for r in want]
    assert all(r.count.dtype == torch.int64 for r in got)
    assert {r.stats["worker"] for r in got} == {0, 1}
    assert st["sessions"] == 0 and st["worker_deaths"] == 0
    assert [f for f in os.listdir(tmp_path) if f.endswith(".log")] == []


def test_a_worker_without_a_card_raises_and_leaves_its_traceback(tmp_path):
    """``--device`` defaults to ``cuda``: with no card the worker raises
    before READY (no CPU fallback), and its stderr log — quoted in the
    error — holds the traceback."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default worker would start")
    with pytest.raises(WorkerDied, match="no CUDA device") as err:
        WorkerClient.spawn(memory_bytes=1 << 20, log_dir=str(tmp_path))
    assert "before READY" in str(err.value)
    logs = [f for f in os.listdir(tmp_path) if f.endswith(".log")]
    assert len(logs) == 1
    with open(tmp_path / logs[0]) as f:
        assert "Traceback" in f.read()
