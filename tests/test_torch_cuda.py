"""Tests of the port that need an NVIDIA GPU: each CUDA kernel against its
plain PyTorch version on the card, and the counter's methods and streams on
the card against the CPU port.

Every test carries the ``cuda`` marker and takes the ``cuda`` fixture,
which skips without a card, so on a CPU-only host the whole file skips. This file imports neither JAX nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.api import (  # noqa: E402
    GraphStats,
    Plan,
    Resources,
    SessionCheckpoint,
    TriangleCounter,
    count_triangles,
    plan,
)
from repro_torch.core.triangle_ref import count_triangles_brute  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.kernels import _build, launch_counts  # noqa: E402
from repro_torch.kernels.bitset_count import ops as bs_ops  # noqa: E402
from repro_torch.kernels.bitset_count.ops import (  # noqa: E402
    bitset_edge_count,
    bitset_pair_count,
)
from repro_torch.kernels.bitset_count.ref import (  # noqa: E402
    bitset_edge_count_ref,
    bitset_pair_count_ref,
)
from repro_torch.kernels.triangle_count.ops import (  # noqa: E402
    masked_matmul_sum,
    triangle_count,
)
from repro_torch.kernels.triangle_count.ref import (  # noqa: E402
    masked_matmul_sum_ref,
    triangle_count_ref,
)
from repro_torch.serve import TriangleServer  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _rand01(rng, shape, p, device):
    return torch.from_numpy((rng.random(shape) < p).astype(np.uint8)).to(device)


@pytest.mark.parametrize("n", [1, 17, 64, 100, 257, 1000])
def test_triangle_count_kernel_equals_plain(cuda, n):
    u = _rand01(np.random.default_rng(n), (n, n), 0.3, cuda).triu(1)
    before = launch_counts()
    want = int(triangle_count_ref(u))  # exact integers on both sides
    assert int(triangle_count(u)) == want
    assert int(triangle_count(u, live_grid=False)) == want
    after = launch_counts()
    assert after["triangle_count_live"] == before["triangle_count_live"] + 1
    assert after["masked_matmul_sum"] == before["masked_matmul_sum"] + 1


def test_triangle_count_kernel_batch_equals_plain(cuda):
    u = _rand01(np.random.default_rng(0), (7, 300, 300), 0.5, cuda).triu(1)
    assert triangle_count(u).tolist() == triangle_count_ref(u).tolist()


@pytest.mark.parametrize("shape", [(64, 64, 64), (100, 70, 130), (33, 1, 17), (300, 513, 129)])
@pytest.mark.parametrize("upper", [False, True])
def test_masked_matmul_sum_kernel_equals_plain(cuda, shape, upper):
    R, K, N = shape
    rng = np.random.default_rng(R * K + N)
    a, b = _rand01(rng, (R, K), 0.4, cuda), _rand01(rng, (K, N), 0.4, cuda)
    m = _rand01(rng, (R, N), 0.5, cuda)
    assert int(masked_matmul_sum(a, b, m, upper_triangular=upper)) == \
        int(masked_matmul_sum_ref(a, b, m, upper_triangular=upper))


def test_masked_matmul_sum_kernel_reads_strided_columns(cuda):
    rng = np.random.default_rng(1)
    big, b = _rand01(rng, (200, 1000), 0.5, cuda), _rand01(rng, (200, 1000), 0.5, cuda)
    cols = big[:, 203:403]  # unaligned base and a row stride of 1000
    assert int(masked_matmul_sum(cols, b, big)) == int(masked_matmul_sum_ref(cols, b, big))


@pytest.mark.parametrize("n_pad,w,b", [(64, 2, 32), (96, 1, 16), (1000, 100, 5000),
                                       (4096, 33, 100_001)])
def test_bitset_edge_count_kernel_equals_plain(cuda, n_pad, w, b):
    rng = np.random.default_rng(w)
    masks = rng.integers(0, 2**32, (n_pad, w), dtype=np.uint64).astype(np.uint32)
    edges = rng.integers(0, n_pad, (b, 2)).astype(np.int32)
    edges[rng.random(b) < 0.2, 0] = n_pad + 1  # phantom edges
    edges[rng.random(b) < 0.1, 1] = n_pad      # clamped v
    m = torch.from_numpy(masks.view(np.int32)).to(cuda)
    e = torch.from_numpy(edges).to(cuda)
    assert int(bitset_edge_count(m, e)) == int(bitset_edge_count_ref(m, e))


@pytest.mark.parametrize("n_pad,w,b", [(64, 1, 31), (96, 2, 57), (500, 33, 1001),
                                       (4472, 140, 100_003)])
def test_bitset_pair_count_kernel_equals_plain(cuda, n_pad, w, b):
    rng = np.random.default_rng(n_pad + w)
    a, bt = (rng.integers(0, 2**32, (n_pad, w), dtype=np.uint64).astype(np.uint32)
             for _ in range(2))
    a[:, 0] |= np.uint32(0x80000000)  # bit 31 set in every row
    edges = rng.integers(0, n_pad, (b, 2)).astype(np.int32)
    edges[rng.random(b) < 0.2, 0] = n_pad + 1  # phantom edges
    edges[rng.random(b) < 0.1, 1] = n_pad      # clamped v
    ta, tb = (torch.from_numpy(x.view(np.int32)).to(cuda) for x in (a, bt))
    e = torch.from_numpy(edges).to(cuda)
    before = launch_counts()["bitset_pair_count"]
    assert int(bitset_pair_count(ta, tb, e)) == int(bitset_pair_count_ref(ta, tb, e))
    assert int(bitset_pair_count(tb, ta, e)) == int(bitset_pair_count_ref(tb, ta, e))
    assert launch_counts()["bitset_pair_count"] == before + 2


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        triangle_count(torch.zeros(8, 8, dtype=torch.float32, device=cuda))
    with pytest.raises(TypeError):
        bitset_edge_count(torch.zeros(8, 1, dtype=torch.int64, device=cuda),
                          torch.zeros(2, 2, dtype=torch.int32, device=cuda))
    m = torch.zeros(8, 1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        bitset_pair_count(m, m, torch.zeros(2, 2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        bitset_pair_count(m, torch.zeros(8, 2, dtype=torch.int32, device=cuda),
                          torch.zeros(2, 2, dtype=torch.int32, device=cuda))
    # past CUDA's 65,535 on gridDim.y / gridDim.z
    with pytest.raises(ValueError, match="batch of 65536"):
        triangle_count(torch.zeros(65536, 1, 1, dtype=torch.uint8, device=cuda))
    tall = torch.zeros(64 * 65535 + 1, 1, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="rows exceed"):
        masked_matmul_sum(tall, tall[:1], tall)


@pytest.mark.parametrize("method", ["dense", "ring", "bitset_ring", "sparse", "mapreduce"])
def test_counter_methods_on_the_card(cuda, method):
    g = gen.powerlaw(300, 5, seed=3)
    p = plan(GraphStats.from_graph(g), Resources(max_stages=4, backend="cuda"),
             allow={method})
    res = TriangleCounter(Resources(max_stages=4, backend="cuda"), device=cuda).count(g, plan=p)
    assert res.count.device.type == "cuda"
    assert res.item() == count_triangles_brute(g)


def test_plan_that_contradicts_the_card_is_refused(cuda):
    # Resources() says backend "cpu": its plans ask for the plain versions
    g = gen.gnp(40, 0.4, seed=1)
    c = TriangleCounter(Resources(), device=cuda)
    before = launch_counts()
    with pytest.raises(ValueError, match="contradicts device cuda"):
        c.count(g)
    with pytest.raises(ValueError, match="contradicts device cuda"):
        c.count_batch([g, g])
    ok = TriangleCounter(Resources(backend="cuda"), device=cuda)
    with pytest.raises(ValueError, match="contradicts device cuda"):
        count_triangles(g, method="dense", use_kernel=False, counter=ok)
    with pytest.raises(ValueError, match="contradicts device cuda"):
        count_triangles(g, method="dense", interpret=True, counter=ok)
    assert launch_counts() == before
    assert count_triangles(g, method="dense", counter=ok) == count_triangles_brute(g)


def test_server_on_the_card(cuda):
    graphs = [gen.gnp(n, 0.4, seed=n) for n in (30, 80, 200, 600)] + [gen.road_grid(40, 40)]
    results = TriangleServer(device=cuda).serve(graphs)
    assert [r.item() for r in results] == [count_triangles_brute(g) for g in graphs]


def _shuffled(g, seed):
    return g.edges[np.random.default_rng(seed).permutation(g.n_edges)]


@pytest.mark.parametrize("n_stages", [1, 3])
def test_count_stream_on_the_card_equals_the_cpu_port(cuda, n_stages):
    g = gen.powerlaw(3000, 8, seed=5)
    e = _shuffled(g, 5)
    blocks = [e[i:i + 1777] for i in range(0, len(e), 1777)]
    p = Plan(method="stream", n_stages=n_stages, block_size=2048)
    before = launch_counts()
    res = TriangleCounter(Resources(backend="cuda"), device=cuda).count_stream(
        g.n_nodes, blocks, plan=dataclasses.replace(p, use_kernel=True, interpret=False))
    after = launch_counts()
    cpu = TriangleCounter(Resources(), device="cpu").count_stream(g.n_nodes, blocks, plan=p)
    assert res.count.device.type == "cuda"
    assert res.item() == cpu.item() == count_triangles_brute(g)
    launches = 2 * n_stages * res.stats["n_blocks"]
    assert after["bitset_edge_count"] - before["bitset_edge_count"] == launches
    assert after["bitset_pair_count"] - before["bitset_pair_count"] == launches


@pytest.mark.parametrize("n_stages", [1, 2])
def test_count_windowed_on_the_card_equals_the_cpu_port(cuda, n_stages):
    rng = np.random.default_rng(7)
    epochs = [[rng.integers(0, 700, size=(3000, 2)).astype(np.int32)] for _ in range(7)]
    p = Plan(method="stream", n_stages=n_stages, block_size=1024, window_epochs=3)
    res = TriangleCounter(Resources(backend="cuda"), device=cuda).count_windowed(
        700, epochs, plan=dataclasses.replace(p, use_kernel=True, interpret=False))
    cpu = TriangleCounter(Resources(), device="cpu").count_windowed(700, epochs, plan=p)
    assert res.item() == cpu.item() > 0


def test_session_checkpoint_on_the_card_restores_bit_identically(cuda, tmp_path):
    g = gen.powerlaw(2000, 6, seed=9)
    e = _shuffled(g, 9)
    c = TriangleCounter(device=cuda)
    whole = c.open_stream(g.n_nodes, block_size=4096)
    whole.feed(e)
    s = c.open_stream(g.n_nodes, block_size=4096)
    s.feed(e[: len(e) // 2])
    ck = s.checkpoint()
    ck.spill(str(tmp_path / "ck.npz"))
    s2 = TriangleCounter(device=cuda).restore_stream(SessionCheckpoint.from_file(ck.path))
    assert s2.state["adj"].device.type == "cuda"
    s2.feed(e[len(e) // 2:])
    assert s2.finalize().item() == whole.finalize().item() == count_triangles_brute(g)
    # a checkpoint whose plan asks for the plain versions is refused on the card
    cpu_s = TriangleCounter(Resources(), device="cpu").open_stream(g.n_nodes)
    with pytest.raises(ValueError, match="contradicts device cuda"):
        c.restore_stream(cpu_s.checkpoint())


def test_stream_ingest_raises_when_the_pair_kernel_cannot_load(cuda, monkeypatch):
    def no_library(name):
        raise RuntimeError(f"cannot load {name}")

    monkeypatch.setattr(bs_ops.PAIR, "_fn", None)
    monkeypatch.setattr(_build, "load", no_library)
    g = gen.gnp(200, 0.2, seed=1)
    before = launch_counts()["bitset_pair_count"]
    with pytest.raises(RuntimeError, match="cannot load bitset_count"):
        TriangleCounter(device=cuda).count_stream(g.n_nodes, [g.edges]).item()
    assert launch_counts()["bitset_pair_count"] == before


def test_stream_ingest_never_waits_for_the_card(cuda):
    """Device-ready blocks ingest with no host sync: no ``.item()``, no
    ``nonzero``, no blocking copy (CUDA's sync debug mode raises on each)."""
    from repro_torch.core import streaming

    rng = np.random.default_rng(4)
    edges = rng.integers(0, 5000, size=(40_000, 2)).astype(np.int32)
    blocks = list(streaming.padded_blocks([edges], 5000, 8192, device=cuda))
    unbounded = streaming.init_state(5000, device=cuda)
    windowed = streaming.init_windowed_state(5000, 3, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in blocks:
            streaming.ingest_block(unbounded, b)
            streaming.ingest_block_windowed(windowed, b)
            streaming.expire_epoch(windowed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu = streaming.count_stream(5000, [edges], block_size=8192, device="cpu")
    assert int(unbounded["count"]) == cpu
