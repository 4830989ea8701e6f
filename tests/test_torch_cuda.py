"""Tests of the port that need an NVIDIA GPU: each CUDA kernel against its
plain PyTorch version on the card, and the counter's methods and streams on
the card against the CPU port.

Every test carries the ``cuda`` marker and takes the ``cuda`` fixture,
which skips without a card, so on a CPU-only host the whole file skips. This file imports neither JAX nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import dataclasses
import math

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
    bitset_edge_count_per_edge,
    bitset_pair_count,
)
from repro_torch.kernels.bitset_count.ref import (  # noqa: E402
    bitset_edge_count_per_edge_ref,
    bitset_edge_count_ref,
    bitset_pair_count_ref,
)
from repro_torch.kernels.embedding_bag.ops import embedding_bag  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    _tma_strides,
    flash_attention,
    kernel_route,
)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.triangle_count.ops import (  # noqa: E402
    masked_matmul_sum,
    tma_batch_strides,
    triangle_count,
)
from repro_torch.kernels.triangle_count.ref import (  # noqa: E402
    masked_matmul_sum_ref,
    triangle_count_ref,
)
from repro_torch.serve import StreamMultiplexer, TriangleServer  # noqa: E402

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


def _k1_launches():
    return launch_counts()["triangle_count_live"]


def test_triangle_count_kernel_reads_views_of_a_padded_buffer(cuda):
    """K1 over the n x n corner of a bucket-sized buffer, read in place (the
    tensor map's dims are n, so nothing past n is counted): one launch a
    call, equal to the plain version as integers."""
    buf = _rand01(np.random.default_rng(3), (512, 512), 0.4, cuda).triu(1)
    for n in (1, 17, 100, 128, 129, 300, 512):
        view = buf[:n, :n]
        assert tma_batch_strides(view[None]) is not None
        before = _k1_launches()
        got = triangle_count(view)
        assert _k1_launches() == before + 1
        assert got.shape == () and int(got) == int(triangle_count_ref(view))


def test_triangle_count_kernel_counts_a_batch_of_views_in_one_launch(cuda):
    rng = np.random.default_rng(4)
    buf = torch.zeros(6, 1024, 1024, dtype=torch.uint8, device=cuda)
    for b, n in enumerate((700, 1, 350, 699, 64, 500)):
        buf[b, :n, :n] = _rand01(rng, (n, n), 0.2 + 0.1 * b, cuda).triu(1)
    for n in (700, 129):
        view = buf[:, :n, :n]
        assert tma_batch_strides(view) == (1024, 1024 * 1024)
        before = _k1_launches()
        got = triangle_count(view)
        assert _k1_launches() == before + 1
        assert got.tolist() == triangle_count_ref(view).tolist()


def test_triangle_count_kernel_copies_what_tma_cannot_read(cuda):
    """n that breaks TMA's 16-byte row rule, and an unaligned base, take the
    wrapper's copy; the count is the same, one launch a call."""
    rng = np.random.default_rng(5)
    big = _rand01(rng, (4, 400, 400), 0.3, cuda).triu(1)
    for u in (big[:, :300, :300].contiguous(), big[0, :394, :394].contiguous(),
              big[1, 5:205, 5:205]):
        assert tma_batch_strides(u if u.dim() == 3 else u[None]) is None
        before = _k1_launches()
        got = triangle_count(u)
        assert _k1_launches() == before + 1
        assert got.tolist() == triangle_count_ref(u).tolist()


def test_triangle_count_kernel_is_exact_past_2_31(cuda):
    """The complete graph on 2,400 nodes: C(2400, 3) = 2.3e9 triangles, past
    2³¹, in a batch of two with an empty graph."""
    n = 2400
    u = torch.ones(n, n, dtype=torch.uint8, device=cuda).triu(1)
    batch = torch.stack([u, torch.zeros_like(u)])
    assert triangle_count(batch).tolist() == [math.comb(n, 3), 0]
    assert math.comb(n, 3) > 2**31


def test_triangle_count_kernel_takes_the_largest_batch_of_its_grid(cuda):
    """65,535 one-row matrices (gridDim.y's limit) launch once; 65,536 are
    refused (test_wrappers_refuse_what_the_kernels_do_not_take)."""
    u = torch.zeros(65535, 1, 1, dtype=torch.uint8, device=cuda)
    before = _k1_launches()
    got = triangle_count(u)
    assert _k1_launches() == before + 1
    assert got.shape == (65535,) and int(got.abs().sum()) == 0
    u = torch.zeros(65535, 3, 3, dtype=torch.uint8, device=cuda)
    u[:, 0, 1] = u[:, 0, 2] = u[:, 1, 2] = 1
    u[-1, 1, 2] = 0
    got = triangle_count(u)
    assert got[:-1].eq(1).all() and int(got[-1]) == 0


@pytest.mark.parametrize("shape", [(64, 64, 64), (100, 70, 130), (33, 1, 17), (300, 513, 129),
                                   (129, 8200, 130), (1000, 2048, 4096), (200, 300, 9000)])
@pytest.mark.parametrize("upper", [False, True])
def test_masked_matmul_sum_kernel_equals_plain(cuda, shape, upper):
    """K2 (int8 wgmma) against its plain version as exact integers: ragged
    tiles, several output tiles and contraction slices, one launch a call."""
    R, K, N = shape
    rng = np.random.default_rng(R * K + N)
    a, b = _rand01(rng, (R, K), 0.4, cuda), _rand01(rng, (K, N), 0.4, cuda)
    m = _rand01(rng, (R, N), 0.5, cuda)
    before = launch_counts()["masked_matmul_sum"]
    got = masked_matmul_sum(a, b, m, upper_triangular=upper)
    assert launch_counts()["masked_matmul_sum"] == before + 1
    assert got.dtype == torch.int64 and got.device.type == "cuda"
    assert int(got) == int(masked_matmul_sum_ref(a, b, m, upper_triangular=upper))


def test_masked_matmul_sum_kernel_is_exact_past_2_31(cuda):
    """All ones at FNA.5's ring shape: the count R·K·N = 3.4e10 is past
    2³¹. Each CTA's s32 tile holds at most its slice's bytes of N; the sums
    past it are int64."""
    R, K, N = 2048, 2048, 8192
    a, b, m = (torch.ones(shape, dtype=torch.uint8, device=cuda)
               for shape in ((R, K), (K, N), (R, N)))
    assert int(masked_matmul_sum(a, b, m)) == R * K * N


def test_masked_matmul_sum_kernel_reads_strided_columns(cuda):
    rng = np.random.default_rng(1)
    big, b = _rand01(rng, (200, 1000), 0.5, cuda), _rand01(rng, (200, 1000), 0.5, cuda)
    cols = big[:, 203:403]  # unaligned base and a row stride of 1000
    assert int(masked_matmul_sum(cols, b, big)) == int(masked_matmul_sum_ref(cols, b, big))


def test_masked_matmul_sum_kernel_copies_what_tma_cannot_read(cuda):
    """B and M whose base or row stride breaks TMA's 16-byte rule are copied
    (into rows rounded up to 16), not refused; one launch a call."""
    rng = np.random.default_rng(2)
    big = _rand01(rng, (700, 1000), 0.5, cuda)
    a = _rand01(rng, (150, 300), 0.5, cuda)
    wide = _rand01(rng, (150, 1024), 0.5, cuda)
    for b, m in ((big[:300, 3:403], big[300:450, 7:407]),           # unaligned bases
                 (_rand01(rng, (300, 24), 0.5, cuda), big[:150, :24]),  # row stride 24
                 (_rand01(rng, (300, 320), 0.5, cuda), wide[:, 16:336])):  # read in place
        before = launch_counts()["masked_matmul_sum"]
        got = masked_matmul_sum(a, b, m)
        assert launch_counts()["masked_matmul_sum"] == before + 1
        assert int(got) == int(masked_matmul_sum_ref(a, b, m))


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


@pytest.mark.parametrize("n_pad,w,b", [(64, 2, 31), (96, 1, 16), (1000, 100, 5000),
                                       (8192, 64, 100_003), (16384, 35466, 64)])
def test_bitset_edge_count_per_edge_kernel_equals_plain(cuda, n_pad, w, b):
    """K5 against its plain version as exact integers: ragged B, phantom
    u, a real u with a phantom v (v clamps to n_pad - 1), up to the hybrid
    stream's (2B, W) table at n = 1,134,890 (W = 35,466)."""
    g = torch.Generator(device=cuda).manual_seed(n_pad + w)
    masks = torch.randint(-2**31, 2**31 - 1, (n_pad, w), generator=g, dtype=torch.int32,
                          device=cuda)
    rng = np.random.default_rng(w)
    edges = rng.integers(0, n_pad, (b, 2)).astype(np.int32)
    edges[rng.random(b) < 0.2, 0] = n_pad + 1  # phantom edges
    edges[rng.random(b) < 0.1, 1] = n_pad      # real u, phantom v
    e = torch.from_numpy(edges).to(cuda)
    before = launch_counts()["bitset_edge_count_per_edge"]
    got = bitset_edge_count_per_edge(masks, e)
    assert launch_counts()["bitset_edge_count_per_edge"] == before + 1
    assert got.dtype == torch.int64 and int(got) == int(bitset_edge_count_per_edge_ref(masks, e))
    assert int(got) == int(bitset_edge_count(masks, e))
    one = torch.tensor([[1, n_pad]], dtype=torch.int32, device=cuda)
    assert int(bitset_edge_count_per_edge(masks, one)) == \
        int(bitset_edge_count_per_edge_ref(masks, one)) > 0
    with pytest.raises(TypeError):
        bitset_edge_count_per_edge(masks, e.to(torch.int64))


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
    # past TMA's 32-bit coordinates (a stride-0 view: no memory)
    tall = torch.zeros(1, 1, dtype=torch.uint8, device=cuda).expand(2**31, 1)
    with pytest.raises(ValueError, match="rows.*exceed"):
        masked_matmul_sum(tall, tall[:1], tall)
    h = torch.zeros(1, 2, 3, 8, dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(h, h, h)
    wide = torch.zeros(1, 2, 3, 264, device=cuda)
    with pytest.raises(ValueError, match="head dims up to 256"):
        flash_attention(wide, wide, wide)
    with pytest.raises(TypeError):
        embedding_bag(torch.zeros(4, 2, device=cuda), torch.zeros(2, 2, dtype=torch.int64,
                                                                   device=cuda))
    with pytest.raises(TypeError):
        embedding_bag(torch.zeros(4, 2, dtype=torch.float16, device=cuda),
                      torch.zeros(2, 2, dtype=torch.int32, device=cuda))


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


def _hybrid_plan(**kw):
    return Plan(method="stream", block_size=2048, state_layout="hybrid", hub_slots=1024,
                tail_capacity=32, hub_threshold=24, **kw)


def test_hybrid_count_stream_on_the_card_equals_the_cpu_port(cuda):
    """The hybrid state on the card: the count, and every state array, equal
    the CPU port's; one K5, two K4 and one K3 launch per block."""
    from repro_torch.core import streaming

    g = gen.powerlaw(3000, 8, seed=5)
    e = _shuffled(g, 5)
    blocks = [e[i:i + 1777] for i in range(0, len(e), 1777)]
    card = TriangleCounter(Resources(backend="cuda"), device=cuda).open_stream(
        g.n_nodes, plan=_hybrid_plan(use_kernel=True, interpret=False))
    before = launch_counts()
    for b in blocks:
        card.feed(b)
    res = card.finalize()
    after = launch_counts()
    cpu = TriangleCounter(Resources(), device="cpu").open_stream(g.n_nodes, plan=_hybrid_plan())
    for b in blocks:
        cpu.feed(b)
    assert res.count.device.type == "cuda"
    assert res.item() == cpu.finalize().item() == count_triangles_brute(g)
    assert res.stats["state_bytes"] == streaming.hybrid_state_nbytes(g.n_nodes, 1024, 32)
    nb = res.stats["n_blocks"]
    for name, per in (("bitset_edge_count_per_edge", 1), ("bitset_pair_count", 2),
                      ("bitset_edge_count", 1)):
        assert after[name] - before[name] == per * nb, name
    a, c = streaming.snapshot_state(card.state), streaming.snapshot_state(cpu.state)
    assert int((card.state["hub_slot"] >= 0).sum()) > 0  # promotions ran
    assert all(np.array_equal(a[k], c[k]) and a[k].dtype == c[k].dtype for k in a)


def test_lossy_hybrid_session_raises_on_the_card(cuda):
    rng = np.random.default_rng(13)
    e = rng.integers(0, 96, size=(3000, 2)).astype(np.int32)
    p = Plan(method="stream", block_size=128, state_layout="hybrid", hub_slots=2,
             tail_capacity=4, hub_threshold=4, use_kernel=True, interpret=False)
    s = TriangleCounter(device=cuda).open_stream(96, plan=p)
    s.feed(e)
    with pytest.raises(RuntimeError, match="dropped .* endpoint"):
        s.finalize()


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


def test_hybrid_ingest_never_waits_for_the_card(cuda):
    """The hybrid ingest needs no host sync either: ``lost`` stays on the
    card until checkpoint or finalize reads it."""
    from repro_torch.core import streaming

    rng = np.random.default_rng(4)
    edges = rng.integers(0, 5000, size=(40_000, 2)).astype(np.int32)
    blocks = list(streaming.padded_blocks([edges], 5000, 8192, device=cuda))
    state = streaming.init_hybrid_state(5000, 512, 32, device=cuda)
    streaming.ingest_block_hybrid(state, blocks[0], hub_threshold=32)  # first-use copies
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in blocks[1:]:
            streaming.ingest_block_hybrid(state, b, hub_threshold=32)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert streaming.hybrid_lost(state) == 0
    cpu = streaming.count_stream(5000, [edges], block_size=8192, device="cpu")
    assert int(state["count"]) == cpu


# --------------------------------------------------------------------------
# The serving tier's streams on the card (StreamMultiplexer)
# --------------------------------------------------------------------------
def _stream_requests(seed, block):
    out = []
    for i, (n, d) in enumerate(((3000, 8), (2000, 6), (1200, 10))):
        g = gen.powerlaw(n, d, seed=seed + i)
        e = _shuffled(g, seed + i)
        out.append((g, [e[j:j + block] for j in range(0, len(e), block)]))
    return out


def test_multiplexer_streams_on_the_card_equal_the_cpu_port(cuda):
    """Interleaved sessions on the card, synchronous and with
    ``prefetch_depth=2`` (the producer thread's pinned copies on the default
    stream), count what the CPU port counts, K3 and K4 twice a block."""
    reqs = _stream_requests(11, 1777)
    cpu = [r.item() for r in TriangleServer(device="cpu").serve_streams(
        [(g.n_nodes, bs) for g, bs in reqs], block_size=2048)]
    for depth in (None, 2):
        before = launch_counts()
        server = TriangleServer(device=cuda, prefetch_depth=depth)
        res = server.serve_streams([(g.n_nodes, bs) for g, bs in reqs], block_size=2048)
        after = launch_counts()
        assert [r.item() for r in res] == cpu
        assert all(r.count.device.type == "cuda" for r in res)
        blocks = sum(r.stats["n_blocks"] for r in res)
        for name in ("bitset_edge_count", "bitset_pair_count"):
            assert after[name] - before[name] == 2 * blocks, (name, depth)
        assert server.streams.bytes_in_use == 0


def test_preempted_session_restores_bit_identically_on_the_card(cuda):
    """A priority-1 open preempts a priority-0 session on the card; parked
    on the host and readmitted when the priority-1 session closes, its
    state arrays equal (on the card) those of a session fed the same edges
    without a break, sync and async alike."""
    from repro_torch.api import card_reserve_bytes

    g = gen.powerlaw(3000, 8, seed=21)
    e = _shuffled(g, 21)
    half = len(e) // 2
    n, w = g.n_nodes, -(-g.n_nodes // 32)
    run = Plan(method="stream", block_size=2048)
    want = TriangleCounter(Resources(), device="cpu").count(g).item()
    for depth in (None, 2):
        reserve = card_reserve_bytes(
            [(n, dataclasses.replace(run, prefetch_depth=depth or 0))] * 3)
        # room for two states beside the reserve, and the planner's own
        # charge for a depth-K pipeline at its smallest block
        charge = 2 * (depth or 0) * 4096 * 2 * 4
        budget = Resources(memory_bytes=reserve + 2 * 4 * n * w + charge + 4096,
                           backend="cuda")
        mux = StreamMultiplexer(TriangleCounter(budget, device=cuda), block_size=2048,
                                prefetch_depth=depth)
        victim, kept = mux.open(n), mux.open(n)
        for sid in (victim, kept):
            mux.feed(sid, e[:half])
        hi = mux.open(n, priority=1)
        assert [mux.status(s) for s in (victim, kept, hi)] == ["preempted", "active", "active"]
        assert mux.store.where(victim) == "host"
        for sid in (victim, kept):
            mux.feed(sid, e[half:])  # the victim's feed waits on the host
        mux.feed(hi, e)
        assert mux.close(hi).item() == want
        assert mux.status(victim) == "active"
        for sid in (victim, kept):
            mux.checkpoint(sid)  # drains a prefetch pipeline
        a, b = mux._recs[victim].session.state, mux._recs[kept].session.state
        assert a["adj"].device.type == "cuda"
        assert all(torch.equal(a[k], b[k]) for k in a) and sorted(a) == sorted(b)
        r = mux.close(victim)
        assert r.item() == mux.close(kept).item() == want
        assert r.stats["restored"] and r.stats["preempts"] == 1


def test_card_reserve_keeps_a_card_budget_from_over_admitting(cuda):
    """With room for 3.5 states by state bytes alone (where the reference's
    admission takes three bitset sessions and then hybrid ones), the card's
    reserve admits 2; feeding them never allocates more than the reserve's
    scratch above the states."""
    from repro_torch.api import admit_session, card_reserve_bytes
    from repro_torch.api import planner

    n, block = 20_000, 4096
    state = 4 * n * (-(-n // 32))
    budget = Resources(memory_bytes=planner._CARD_FIXED_BYTES + int(3.5 * state),
                       backend="cuda")
    plain = Resources(memory_bytes=int(3.5 * state), backend="cuda")
    assert admit_session(n, plain, bytes_in_use=2 * state).action == "admit-dense"
    mux = StreamMultiplexer(TriangleCounter(budget, device=cuda), block_size=block)
    sids = []
    while not sids or mux.status(sids[-1]) == "active":
        sids.append(mux.open(n))
    active = [s for s in sids if mux.status(s) == "active"]
    assert len(active) == 2
    plans = [(n, mux._recs[s].plan) for s in active]
    assert mux.bytes_in_use + mux.reserve_bytes == 2 * state + card_reserve_bytes(plans) \
        <= budget.memory_bytes
    rng = np.random.default_rng(3)
    edges = rng.integers(0, n, size=(60_000, 2)).astype(np.int32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for sid in active:
        for i in range(0, len(edges), block):  # a block a feed, as the reserve counts
            mux.feed(sid, edges[i:i + block])
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - base
    assert 0 < transient <= max(planner.ingest_scratch_bytes(n, p) for _, p in plans) \
        + sum(planner.prefetch_inflight_bytes(p) for _, p in plans)
    counts = [mux.close(s).item() for s in sids]
    assert counts[0] == counts[1] > 0


def test_the_delta_pool_changes_no_count_and_no_peak_of_a_server(cuda):
    """Three bitset sessions at n = 20,000, fed in turns through one
    server: with the counter's delta pool the counts equal a server's
    whose ingests zero-fill a fresh delta table each block, and the peak
    allocated above the server's start is no higher."""
    from repro_torch.core import streaming

    class FreshTables(streaming.DeltaPool):
        """The ingest without a pool: a zero-filled table each block."""

        def take(self, n_words, device):
            return torch.zeros(n_words, dtype=torch.int32, device=device)

        def give(self, table, idx):
            pass

    n, block, feed = 20_000, 4096, 5000
    edges = [_shuffled(gen.powerlaw(n, 8, seed=31 + k), 31 + k) for k in range(3)]
    got = {}
    for label in ("fresh", "pooled"):
        server = TriangleServer(device=cuda)
        if label == "fresh":
            server.counter.delta_pool = FreshTables()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sids = [server.open_stream(n, block_size=block) for _ in edges]
        for i in range(0, max(len(e) for e in edges), feed):
            for sid, e in zip(sids, edges):
                server.feed(sid, e[i:i + feed])
        counts = [server.close_stream(sid).item() for sid in sids]
        torch.cuda.synchronize()
        got[label] = counts, torch.cuda.max_memory_allocated() - base
        del server
    assert got["pooled"][0] == got["fresh"][0] and min(got["fresh"][0]) > 0
    assert got["pooled"][1] <= got["fresh"][1]


# --------------------------------------------------------------------------
# The ring mesh on one card: every stage on a CUDA stream of its own
# --------------------------------------------------------------------------
def _one_card_mesh(n_stages=4):
    from repro_torch.launch import make_ring_mesh

    return make_ring_mesh(n_stages, devices=[torch.device("cuda", 0)] * n_stages)


@pytest.mark.parametrize("method", ["ring", "bitset_ring"])
def test_mesh_rings_on_one_card_equal_the_brute_count(cuda, method):
    """Counts through ``DynamicPipeline`` on four streams of the card, ten
    of them and ten queued pipeline runs back to back with no host sync,
    all equal to the brute count; S² kernel launches a count."""
    from repro_torch.core.dynamic_pipeline import DynamicPipeline
    from repro_torch.core.triangle_pipeline import (
        bitset_ring_spec,
        build_bitset_ring_operands,
        build_dense_ring_operands,
        dense_ring_spec,
    )

    g = gen.gnp(300, 0.3, seed=8)
    want = count_triangles_brute(g)
    mesh = _one_card_mesh()
    c = TriangleCounter(Resources(n_devices=4, backend="cuda"), mesh=mesh)
    assert c.device == torch.device("cuda", 0) and c.mesh_matches(4)
    kernel = {"ring": "masked_matmul_sum", "bitset_ring": "bitset_edge_count"}[method]
    before = launch_counts()[kernel]
    outs = [c.count(g, plan=Plan(method=method, n_stages=4, use_kernel=True,
                                 interpret=False)) for _ in range(10)]
    assert [o.item() for o in outs] == [want] * 10
    assert launch_counts()[kernel] - before == 10 * 16
    if method == "ring":
        part, blocks = build_dense_ring_operands(g, 4, device=cuda)
        spec, resident, stream = dense_ring_spec(part.rows_per_stage), blocks, blocks
    else:
        _, resident, stream = build_bitset_ring_operands(g, 4, device=cuda)
        spec = bitset_ring_spec()
    pipe = DynamicPipeline(mesh)
    totals = [pipe.run(spec, resident, stream) for _ in range(10)]
    assert [int(t) for t in totals] == [want] * 10


@pytest.mark.parametrize("window", [0, 3])
def test_mesh_stream_on_one_card_equals_the_cpu_emulated_state(cuda, window):
    """A four-stage mesh session on the card (shards on four streams)
    equals the CPU port's emulated sharded session array for array; K3 and
    K4 launch twice a shard a block (once per epoch age and shard in a
    window: E + 1 and 2E)."""
    from repro_torch.core import streaming

    n, S, block = 3000, 4, 4096
    rng = np.random.default_rng(6)
    edges = rng.integers(0, n, size=(30_000, 2)).astype(np.int32)
    chunks = np.array_split(edges, 9)
    plans = [Plan(method="stream", n_stages=S, block_size=block, window_epochs=window,
                  **flags) for flags in ({"use_kernel": True, "interpret": False}, {})]
    card = TriangleCounter(Resources(backend="cuda"), plan=plans[0], mesh=_one_card_mesh(S))
    cpu = TriangleCounter(Resources(), plan=plans[1], device="cpu")
    before = launch_counts()
    sessions = [card.open_stream(n), cpu.open_stream(n)]
    for i, chunk in enumerate(chunks):
        for s in sessions:
            if window and i % 3 == 2:
                s.advance()
            s.feed(chunk)
    a, b = (s.finalize() for s in sessions)
    after = launch_counts()
    assert a.item() == b.item() and a.stats["on_mesh"] and not b.stats["on_mesh"]
    sa, sb = (streaming.snapshot_state(s.state) for s in sessions)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])
    per_k3, per_k4 = (window + 1, 2 * window) if window else (2, 2)
    for name, per in (("bitset_edge_count", per_k3), ("bitset_pair_count", per_k4)):
        assert after[name] - before[name] == per * S * a.stats["n_blocks"]


def test_mesh_ingest_never_waits_for_the_card(cuda):
    """The mesh ingests add no host sync to the bitset ingest's: events
    and stream waits only (CUDA's sync debug mode raises on a sync)."""
    from repro_torch.core import streaming

    mesh = _one_card_mesh()
    rng = np.random.default_rng(4)
    edges = rng.integers(0, 5000, size=(40_000, 2)).astype(np.int32)
    blocks = list(streaming.padded_blocks([edges], 5000, 8192, device=cuda))
    unbounded = streaming.init_sharded_state(5000, 4, mesh=mesh)
    windowed = streaming.init_windowed_sharded_state(5000, 3, 4, mesh=mesh)
    ingest = streaming.make_mesh_ingest(mesh)
    ingest_windowed = streaming.make_mesh_ingest_windowed(mesh)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in blocks:
            ingest(unbounded, b)
            ingest_windowed(windowed, b)
            streaming.expire_epoch(windowed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu = streaming.count_stream(5000, [edges], block_size=8192, device="cpu")
    assert int(unbounded["count"]) == cpu


def test_same_card_mesh_admission_charges_every_shard(cuda):
    """The deliberate difference, on the card: a multiplexer over four
    stages of one card charges a four-stage session all four shards — the
    reference would charge one, n²/8/S, on a matching mesh, and over-admit
    the card — and plans a session without a plan at ring width 1. Its
    first session turns the allocator's expandable segments on."""
    from repro_torch.api import planner

    n, S, block = 20_000, 4, 4096
    shard = 4 * n * (-(-(-(-n // 32)) // S))
    res = Resources(memory_bytes=planner._CARD_FIXED_BYTES + 16 * S * shard,
                    backend="cuda")
    mux = StreamMultiplexer(TriangleCounter(res, device=cuda, mesh=_one_card_mesh(S)),
                            block_size=block)
    planned = mux.open(n)
    assert mux._recs[planned].plan.n_stages == 1
    assert mux.state_bytes_of(planned) == 4 * n * -(-n // 32)
    ring = dataclasses.replace(mux._recs[planned].plan, n_stages=S)
    mux.close(planned)
    assert any(seg["is_expandable"] for seg in torch.cuda.memory_snapshot())
    sid = mux.open(n, plan=ring)
    rec = mux._recs[sid]
    assert rec.plan.n_stages == S and rec.plan.state_layout == "bitset"
    assert mux.bytes_in_use == S * shard == rec.session.state_bytes \
        == sum(x.nbytes for x in rec.session.state["adj"])
    rng = np.random.default_rng(5)
    edges = rng.integers(0, n, size=(20_000, 2)).astype(np.int32)
    for i in range(0, len(edges), block):
        mux.feed(sid, edges[i:i + block])
    r = mux.close(sid)
    assert r.stats["on_mesh"] and mux.bytes_in_use == 0
    assert r.item() == TriangleCounter(Resources(), device="cpu").count_stream(
        n, [edges], plan=Plan(method="stream", block_size=block)).item()


# --------------------------------------------------------------------------
# K6 and K7, and the LM and recsys paths on the card
# --------------------------------------------------------------------------
_K6 = {"wgmma": "flash_attention_wgmma", "fma": "flash_attention",
       "tf32x3": "flash_attention_tf32x3"}


def _assert_one_launch(before: dict, route: str, n: int = 1) -> None:
    """Exactly ``n`` launches of K6's ``route`` since ``before``, none of the
    other routes."""
    now = launch_counts()
    for r, name in _K6.items():
        assert now[name] - before[name] == (n if r == route else 0), (name, route)


# The tensor-core routes' cases: (Hq, Hkv, D, Dv, S) at D = Dv = 64 and 128
# across ragged and whole tiles, and at MLA's (192, 128)
_TC_CASES = [(hq, hkv, d, d, s) for hq, hkv in ((4, 4), (8, 2), (32, 4)) for d in (64, 128)
             for s in (1, 63, 127, 128, 129, 200, 1000, 4097)]
_TC_CASES += [(hq, hkv, 192, 128, s) for hq, hkv in ((4, 4), (16, 16), (8, 2))
              for s in (127, 200, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 16), (8, 2, 64), (32, 4, 128), (4, 1, 200)])
@pytest.mark.parametrize("s", [1, 127, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_equals_plain(cuda, dtype, hq, hkv, d, s, causal):
    """Tolerances of the reference's kernel test: 2e-5 (f32), 3e-2 (bf16).
    At D = 64 and 128 bf16 takes the wgmma kernel and f32 the three-pass
    TF32 kernel, every other case the FMA kernel: one launch of that route
    and none of the others."""
    g = torch.Generator(device=cuda).manual_seed(hq * s + d)
    q = torch.randn(2, hq, s, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, hkv, s, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, hkv, s, d, generator=g, device=cuda).to(dtype)
    before = launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    _assert_one_launch(before, kernel_route(dtype, d))
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q, k, v, causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("hq,hkv,d,dv,s", _TC_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_wgmma_equals_plain(cuda, hq, hkv, d, dv, s, causal):
    """The bf16 tensor-core kernel (TMA ring, wgmma) against the plain
    version at rtol = atol = 3e-2, the reference kernel test's bf16
    tolerance, across ragged and whole 128-key tiles, at (D, Dv) = (64,
    64), (128, 128) and MLA's (192, 128) with v unpadded. At S = 4097 also the
    Yi-width limit of chip_smoke.py, elementwise: 1e-4 + 2^-7 |want| +
    2^-8 attention_ref(q, k, |v|) — the second term one bf16 rounding of the
    output, the third the first-order bound of storing each unnormalised
    probability in bf16 before P·V (relative 2^-9 each, twice for l)."""
    g = torch.Generator(device=cuda).manual_seed(hq * s + d + causal)
    b = 2 if s < 4097 else 1
    q = torch.randn(b, hq, s, d, generator=g, device=cuda).bfloat16()
    k = torch.randn(b, hkv, s, d, generator=g, device=cuda).bfloat16()
    v = torch.randn(b, hkv, s, dv, generator=g, device=cuda).bfloat16()
    before = launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    _assert_one_launch(before, "wgmma")
    assert got.dtype == torch.bfloat16 and got.shape == (b, hq, s, dv)
    want = attention_ref(q, k, v, causal=causal).float()
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)
    if s == 4097:
        limit = 1e-4 + 2.0**-7 * want.abs() + 2.0**-8 * attention_ref(
            q, k, v.abs(), causal=causal).float()
        assert bool(((got.float() - want).abs() <= limit).all())


def test_flash_attention_wgmma_reads_head_views_in_place(cuda):
    """The transposed head views of attention._split_heads keep TMA's
    16-byte rule: they are read in place, so the output keeps q's layout."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, 300, 8 * 128, generator=g, device=cuda).bfloat16()
    y = torch.randn(2, 300, 2 * 128, generator=g, device=cuda).bfloat16()
    q = x.reshape(2, 300, 8, 128).transpose(1, 2)
    kv = y.reshape(2, 300, 2, 128).transpose(1, 2)
    before = launch_counts()
    got = flash_attention(q, kv, kv)
    _assert_one_launch(before, "wgmma")
    assert got.stride() == q.stride()
    torch.testing.assert_close(got.float(), attention_ref(q, kv, kv).float(), rtol=3e-2,
                               atol=3e-2)


def test_flash_attention_wgmma_copies_what_tma_cannot_read(cuda):
    """A base 2 bytes off 16-byte alignment and rows of 65 elements (130
    bytes) break TMA's rule: the wrapper copies them, never refuses them."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 4, 130, 65, generator=g, device=cuda).bfloat16()
    q = x[..., 1:]                       # base +2 bytes, row stride 65
    kv = torch.randn(2, 2, 130, 72, generator=g, device=cuda).bfloat16()[..., 8:]
    assert q.data_ptr() % 16 and q.stride(2) == 65
    before = launch_counts()
    got = flash_attention(q, kv, kv, causal=False)
    _assert_one_launch(before, "wgmma")
    torch.testing.assert_close(got.float(), attention_ref(q, kv, kv, causal=False).float(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("hq,hkv,d,dv,s", _TC_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_tf32x3_equals_plain(cuda, hq, hkv, d, dv, s, causal):
    """The f32 tensor-core kernel (three TF32 passes, TMA rings, wgmma)
    against the plain version across ragged and whole 32-key tiles, at
    (D, Dv) = (64, 64), (128, 128) and MLA's (192, 128) with v unpadded
    (one V stage there): the
    reference kernel test's 2e-5 up to S = 1000, and chip_smoke.py's
    F32_LONG_TOL (1e-4) at S = 4097, where the online softmax has run over
    129 key tiles."""
    g = torch.Generator(device=cuda).manual_seed(hq * s + d + causal)
    b = 2 if s < 4097 else 1
    q = torch.randn(b, hq, s, d, generator=g, device=cuda)
    k = torch.randn(b, hkv, s, d, generator=g, device=cuda)
    v = torch.randn(b, hkv, s, dv, generator=g, device=cuda)
    before = launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    _assert_one_launch(before, "tf32x3")
    assert got.dtype == torch.float32 and got.shape == (b, hq, s, dv)
    tol = 2e-5 if s <= 1024 else 1e-4
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=causal), rtol=tol, atol=tol)


def test_flash_attention_tf32x3_reads_head_views_in_place(cuda):
    """f32 head views of attention._split_heads keep TMA's 16-byte rule:
    q and k are read in place (v by the prep kernel through its strides), so
    the output keeps q's layout."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, 300, 8 * 128, generator=g, device=cuda)
    y = torch.randn(2, 300, 2 * 2 * 128, generator=g, device=cuda)
    q = x.reshape(2, 300, 8, 128).transpose(1, 2)
    k = y[..., :256].reshape(2, 300, 2, 128).transpose(1, 2)
    v = y[..., 256:].reshape(2, 300, 2, 128).transpose(1, 2)
    before = launch_counts()
    got = flash_attention(q, k, v)
    _assert_one_launch(before, "tf32x3")
    assert got.stride() == q.stride()
    torch.testing.assert_close(got, attention_ref(q, k, v), rtol=2e-5, atol=2e-5)


def test_flash_attention_tf32x3_copies_what_tma_cannot_read(cuda):
    """A base 4 bytes off 16-byte alignment, rows of 65 elements (260
    bytes), and a contiguous tensor whose base is 4 bytes off: the wrapper
    copies them, never refuses them."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(2, 4, 130, 65, generator=g, device=cuda)[..., 1:]  # base +4, stride 65
    flat = torch.randn(1 + 2 * 2 * 130 * 64, generator=g, device=cuda)
    k = flat[1:].view(2, 2, 130, 64)                                    # contiguous, base +4
    v = torch.randn(2, 2, 130, 72, generator=g, device=cuda)[..., 8:]
    assert q.data_ptr() % 16 and q.stride(2) == 65
    assert k.is_contiguous() and k.data_ptr() % 16
    before = launch_counts()
    got = flash_attention(q, k, v, causal=False)
    _assert_one_launch(before, "tf32x3")
    torch.testing.assert_close(got, attention_ref(q, k, v, causal=False), rtol=2e-5, atol=2e-5)


def _mla_views(cuda, dtype, b=2, s=300, h=16, seed=8):
    """q, k and v as ``attention.mla_full`` hands them to K6: q and k
    concatenated (contiguous, D 192), v the transposed head view of the
    (B, S, H·128) up-projection."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k = (torch.randn(b, h, s, 192, generator=g, device=cuda).to(dtype) for _ in range(2))
    v = torch.randn(b, s, h * 128, generator=g, device=cuda).to(dtype)
    return q, k, v.reshape(b, s, h, 128).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_reads_mla_v_view_in_place(cuda, dtype):
    """mla_full's transposed v view (Dv 128 beside D 192) keeps TMA's
    16-byte rule, so the wgmma route reads it in place (and the tf32x3
    route's prep through its strides): one launch of the route, no copy."""
    q, k, v = _mla_views(cuda, dtype)
    assert _tma_strides(v) == v.stride()[:3] and not v.is_contiguous()
    route = kernel_route(dtype, 192, 128)
    before = launch_counts()
    got = flash_attention(q, k, v)
    _assert_one_launch(before, route)
    assert got.shape == (2, 16, 300, 128)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), attention_ref(q, k, v).float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_copies_an_mla_v_that_tma_cannot_read(cuda, dtype):
    """A v of Dv 128 whose base is one element off 16-byte alignment, and q
    and k likewise: the wrapper copies what TMA cannot read, at each one's
    own head dim, and never refuses it."""
    q, k, v = _mla_views(cuda, dtype, s=130, h=4)
    flat = torch.zeros(1 + v.numel(), dtype=dtype, device=cuda)
    v_off = flat[1:].view(v.shape).copy_(v)
    q_off = torch.zeros(1 + q.numel(), dtype=dtype, device=cuda)[1:].view(q.shape).copy_(q)
    assert _tma_strides(v_off) is None and _tma_strides(q_off) is None
    before = launch_counts()
    got = flash_attention(q_off, k, v_off, causal=False)
    _assert_one_launch(before, kernel_route(dtype, 192, 128))
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, causal=False).float(),
                               rtol=tol, atol=tol)


def test_flash_attention_kernel_reads_head_views_in_place(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 300, 8 * 64, generator=g, device=cuda)
    y = torch.randn(2, 300, 2 * 64, generator=g, device=cuda)
    q = x.reshape(2, 300, 8, 64).transpose(1, 2)   # (B, H, S, hd) views
    kv = y.reshape(2, 300, 2, 64).transpose(1, 2)
    got = flash_attention(q, kv, kv)
    assert got.stride() == q.stride()  # out has q's layout
    torch.testing.assert_close(got, attention_ref(q, kv, kv), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,d,n,l", [(64, 16, 8, 4), (256, 128, 4, 10), (1000, 32, 16, 3),
                                     (100, 13, 7, 5), (5000, 16, 20_000, 8), (50, 16, 3, 0)])
def test_embedding_bag_kernel_equals_plain(cuda, dtype, v, d, n, l):
    g = torch.Generator().manual_seed(v + n)
    table = torch.randn(v, d, generator=g).to(dtype).to(cuda)
    ids = torch.randint(0, v, (n, l), generator=g, dtype=torch.int32)
    ids[torch.rand(n, l, generator=g) < 0.3] = v
    if l:
        ids[0] = v                       # an all-padding bag
        ids[1, 0], ids[2, -1] = v - 1, -3  # the last row; a negative id pads
    ids = ids.to(cuda)
    before = launch_counts()["embedding_bag"]
    got = embedding_bag(table, ids)
    assert launch_counts()["embedding_bag"] == before + 1
    assert got.dtype == dtype and got.shape == (n, d)
    tol = 1e-6 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), embedding_bag_ref(table, ids).float(),
                               rtol=tol, atol=tol)
    if l:
        assert not got[0].any()


@pytest.mark.parametrize("arch", ["yi_6b", "nemotron_4_15b"])
def test_lm_flash_prefill_launches_k6_per_layer_and_matches_the_cpu_port(cuda, arch):
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tf

    cfg = get_smoke(arch)
    model = tf.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    host = tf.Transformer(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 37)))
    before = launch_counts()["flash_attention"]
    got, cache = tf.prefill(model, cfg, toks.to(cuda), 40, use_flash=True)
    assert launch_counts()["flash_attention"] == before + cfg.n_layers
    want, host_cache = tf.prefill(host, cfg, toks, 40, use_flash=True)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(cache["dense"]["k"].cpu(), host_cache["dense"]["k"],
                               rtol=2e-4, atol=2e-4)
    chunked, _ = tf.prefill(model, cfg, toks.to(cuda), 40, chunk_q=16)
    torch.testing.assert_close(got, chunked, rtol=2e-4, atol=2e-4)
    nxt = got.argmax(-1, keepdim=True)
    step, _ = tf.decode_step(model, cfg, cache, nxt, 37)
    host_step, _ = tf.decode_step(host, cfg, host_cache, nxt.cpu(), 37)
    torch.testing.assert_close(step.cpu(), host_step, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("head_dim", [None, 128], ids=["smoke", "hd128"])
def test_lm_bf16_flash_prefill_matches_the_cpu_port(cuda, head_dim):
    """The Yi-6B smoke config in bf16 with a bf16 cache, on the card against
    the CPU port on the same weights, within 2e-2 of the largest logit (as
    chip_smoke.py holds the bf16 flash prefill to the chunked one). Its head
    dim 16 takes the FMA route; widened to 128 it takes the wgmma route, one
    launch per layer either way."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_smoke("yi_6b"), head_dim=head_dim)
    model = tf.init_params(torch.Generator(device=cuda).manual_seed(4), cfg, torch.bfloat16,
                           device=cuda)
    host = tf.Transformer(cfg, torch.bfloat16, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 150)))
    before = launch_counts()
    got, cache = tf.prefill(model, cfg, toks.to(cuda), 160, use_flash=True,
                            cache_dtype=torch.bfloat16)
    _assert_one_launch(before, kernel_route(torch.bfloat16, cfg.hd), cfg.n_layers)
    want, _ = tf.prefill(host, cfg, toks, 160, use_flash=True, cache_dtype=torch.bfloat16)
    assert cache["dense"]["k"].dtype == torch.bfloat16
    assert float((got.cpu() - want).abs().max()) <= 2e-2 * float(want.abs().max())


def test_lm_f32_flash_prefill_at_head_dim_128_matches_the_cpu_port(cuda):
    """The Yi-6B smoke config widened to head dim 128 in f32: its flash
    prefill takes the three-pass TF32 route, one launch per layer and none
    of the other routes, and agrees with the CPU port on the same weights
    within 2e-4, as the head-dim-16 (FMA) prefill does."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_smoke("yi_6b"), head_dim=128)
    assert kernel_route(torch.float32, cfg.hd) == "tf32x3"
    model = tf.init_params(torch.Generator(device=cuda).manual_seed(7), cfg, device=cuda)
    host = tf.Transformer(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (2, 150)))
    before = launch_counts()
    got, cache = tf.prefill(model, cfg, toks.to(cuda), 160, use_flash=True)
    _assert_one_launch(before, "tf32x3", cfg.n_layers)
    want, host_cache = tf.prefill(host, cfg, toks, 160, use_flash=True)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(cache["dense"]["k"].cpu(), host_cache["dense"]["k"],
                               rtol=2e-4, atol=2e-4)


def test_lm_server_on_the_card(cuda):
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tf
    from repro_torch.serve import LMServer, ServeConfig

    cfg = get_smoke("granite_8b")
    model = tf.init_params(torch.Generator(device=cuda).manual_seed(1), cfg, device=cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in (5, 9, 7)]
    out = LMServer(model, cfg, ServeConfig(max_batch=2, max_new_tokens=4)).generate(prompts)
    assert [o.shape for o in out] == [(4,)] * 3
    assert all(o.dtype == np.int32 and ((o >= 0) & (o < cfg.vocab)).all() for o in out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,d", [(4, 16, 1024, 192), (2, 16, 127, 192), (2, 4, 37, 24)])
def test_flash_attention_fma_at_mla_head_dims_equals_plain(cuda, dtype, b, h, s, d):
    """K6's FMA route at MLA's head dims with V padded to them, as the
    reference's mla_full pads it: DeepSeek-V2-Lite's nope + rope = 192 at
    its prefill shape (B = 4, 16 heads, 1,024 tokens) and ragged, and the
    smoke configs' 24, with V zero past its 128 (resp. 16) columns; causal,
    within the reference kernel test's 2e-5 (f32) and 3e-2 (bf16), one FMA
    launch each."""
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q, k = (torch.randn(b, h, s, d, generator=g, device=cuda).to(dtype) for _ in range(2))
    v = torch.zeros_like(k)
    v[..., :d * 2 // 3] = torch.randn(b, h, s, d * 2 // 3, generator=g, device=cuda).to(dtype)
    assert kernel_route(dtype, d) == "fma"
    before = launch_counts()
    got = flash_attention(q, k, v, causal=True)
    _assert_one_launch(before, "fma")
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), attention_ref(q, k, v).float(), rtol=tol, atol=tol)
    assert not got[..., d * 2 // 3:].any()


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "deepseek_v2_236b"])
def test_moe_layer_on_the_card_matches_the_cpu_port(cuda, arch):
    """One MoE layer of the smoke config on the card against the CPU port
    on the same weights and tokens (56 tokens, and 3: fewer copies than
    experts): routing equal as integers, y and aux within 2e-4."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import moe

    cfg = get_smoke(arch)
    layer = moe.moe_init(torch.Generator(device=cuda).manual_seed(5), cfg, device=cuda)
    host = moe.MoE(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
    for t in (56, 3):
        x = torch.from_numpy(np.random.default_rng(t).standard_normal(
            (t, cfg.d_model)).astype(np.float32))
        assert torch.equal(moe.route(layer, cfg, x.to(cuda))[2].cpu(), moe.route(host, cfg, x)[2])
        y, aux = moe.moe_apply(layer, cfg, x.to(cuda))
        want, want_aux = moe.moe_apply(host, cfg, x)
        torch.testing.assert_close(y.cpu(), want, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(aux.cpu(), want_aux, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "deepseek_v2_236b"])
@pytest.mark.parametrize("full_head_dims", [False, True], ids=["smoke", "mla192"])
def test_deepseek_flash_prefill_launches_k6_per_layer_and_matches_the_cpu_port(
        cuda, arch, full_head_dims):
    """The DeepSeek smoke configs (MoE; MLA at head dims (24, 16), or at the
    full configs' (nope 128 + rope 64, v 128)) on the card: the flash
    prefill launches K6's route for those head dims once per layer — the
    FMA kernel at (24, 16), the tf32x3 kernel at (192, 128) — and agrees
    with the CPU port, and with the chunked prefill, within 2e-4, as does a
    decode step."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tf

    cfg = get_smoke(arch)
    if full_head_dims:
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, nope_head_dim=128, rope_head_dim=64, v_head_dim=128))
    m = cfg.mla
    route = kernel_route(torch.float32, m.nope_head_dim + m.rope_head_dim, m.v_head_dim)
    assert route == ("tf32x3" if full_head_dims else "fma")
    model = tf.init_params(torch.Generator(device=cuda).manual_seed(6), cfg, device=cuda)
    host = tf.Transformer(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (2, 37)))
    before = launch_counts()
    got, cache = tf.prefill(model, cfg, toks.to(cuda), 40, use_flash=True)
    _assert_one_launch(before, route, cfg.n_layers)
    want, host_cache = tf.prefill(host, cfg, toks, 40, use_flash=True)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(cache["moe_stack"]["c"].cpu(), host_cache["moe_stack"]["c"],
                               rtol=2e-4, atol=2e-4)
    chunked, _ = tf.prefill(model, cfg, toks.to(cuda), 40, chunk_q=16)
    torch.testing.assert_close(got, chunked, rtol=2e-4, atol=2e-4)
    nxt = got.argmax(-1, keepdim=True)
    step, _ = tf.decode_step(model, cfg, cache, nxt, 37)
    host_step, _ = tf.decode_step(host, cfg, host_cache, nxt.cpu(), 37)
    torch.testing.assert_close(step.cpu(), host_step, rtol=2e-4, atol=2e-4)


def test_recsys_on_the_card_launches_k7_and_matches_the_cpu_port(cuda):
    from repro_torch.configs import get_smoke
    from repro_torch.models.recsys import autoint, embedding

    cfg = get_smoke("autoint")
    model = autoint.init_params(torch.Generator(device=cuda).manual_seed(2), cfg, device=cuda)
    host = autoint.AutoInt(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(2)
    bags = torch.from_numpy(rng.integers(0, cfg.vocab_per_field + 20, (6, cfg.n_sparse, 5)))
    before = launch_counts()["embedding_bag"]
    got = embedding.lookup_multihot(model.table, cfg, bags.to(cuda), use_kernel=True)
    assert launch_counts()["embedding_bag"] == before + 1
    torch.testing.assert_close(got.cpu(), embedding.lookup_multihot(host.table, cfg, bags),
                               rtol=1e-6, atol=1e-6)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_per_field, (6, cfg.n_sparse)))
    torch.testing.assert_close(autoint.ctr_logits(model, cfg, ids.to(cuda)).cpu(),
                               autoint.ctr_logits(host, cfg, ids), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# The cluster tier on the card: worker processes sharing it
# --------------------------------------------------------------------------
def test_a_card_worker_counts_as_the_cpu_port_and_closes_to_int64(cuda, tmp_path):
    """A ``--device cuda`` worker's open / feed / close over the wire equals
    the CPU port's count; the count is copied off the card and arrives as
    int64, and the worker's own launch counters show K3 and K4 ran in it."""
    from repro_torch.api import planner
    from repro_torch.serve.cluster import WorkerClient

    n, block = 20_000, 4096
    edges = np.random.default_rng(11).integers(0, n, size=(30_000, 2)).astype(np.int32)
    w = WorkerClient.spawn(memory_bytes=planner._CARD_FIXED_BYTES + (1 << 30),
                           log_dir=str(tmp_path))
    try:
        assert (w.resources.backend, w.mesh_devices) == ("cuda", 0)
        reply, _ = w.rpc({"op": "open", "n_nodes": n, "block_size": block})
        sid = reply["sid"]
        assert reply["status"] == "active"
        for seq, i in enumerate(range(0, len(edges), block)):
            w.rpc({"op": "feed", "sid": sid, "seq": seq}, {"edges": edges[i:i + block]})
        reply, arrays = w.rpc({"op": "close", "sid": sid})
        stats, _ = w.rpc({"op": "stats"})
    finally:
        w.shutdown()
    assert arrays["count"].dtype == np.int64 and arrays["count"].size == 1
    want = TriangleCounter(Resources(), device="cpu").count_stream(
        n, [edges], plan=Plan(method="stream", block_size=block)).item()
    assert int(arrays["count"][0]) == want
    assert reply["stats"]["n_blocks"] == -(-len(edges) // block)
    assert stats["launches"]["bitset_edge_count"] > 0
    assert stats["launches"]["bitset_pair_count"] > 0


def test_the_routers_verdicts_are_card_workers_own_under_the_reserve(cuda, tmp_path):
    """Two card workers — one plain, one of four stages on this one card —
    filled through the router until it refuses: no worker ever queues a
    session the router placed, each worker pins what the router charged,
    the four-stage worker advertises width 0 and runs width-1 plans, and a
    further open sent past the router queues on either worker. The
    reference's rule, with no reserve, would have placed more."""
    from repro_torch.api import BackpressureError, WorkerLoad, planner, worker_admission
    from repro_torch.serve.cluster import ClusterRouter

    n, block = 20_000, 4096
    state = 4 * n * (-(-n // 32))
    share = planner._CARD_FIXED_BYTES + int(3.5 * state)
    specs = [{"memory_bytes": share}, {"memory_bytes": share, "devices": 4,
                                       "device": "cuda:0"}]
    with ClusterRouter(specs, checkpoint_dir=str(tmp_path),
                       checkpoint_every_bytes=None) as router:
        plain, meshed = router.workers
        assert (meshed.resources.n_devices, meshed.mesh_devices) == (4, 0)
        gids = []
        with pytest.raises(BackpressureError):
            while True:
                gids.append(router.open(n, block_size=block))
        assert len(gids) >= 4
        assert all(router.status(g) == "active" for g in gids)
        st = router.stats()["workers"]
        assert [s["bytes_in_use"] for s in st] == router.charged_bytes()
        assert [s["n_queued"] for s in st] == [0, 0]
        for i, w in enumerate(router.workers):
            no_reserve = worker_admission(n, WorkerLoad(
                dataclasses.replace(w.resources, backend="cpu"),
                charged_bytes=router.charged_bytes()[i]))
            assert no_reserve.admitted
            reply, _ = w.rpc({"op": "open", "n_nodes": n, "block_size": block})
            assert reply["status"] == "queued"
            w.rpc({"op": "close", "sid": reply["sid"]})
        results = [router.close(g) for g in gids]
        assert all(r.plan.n_stages == 1 for r in results)
        assert {r.stats["worker"] for r in results} == {0, 1}
        assert router.charged_bytes() == [0, 0]


# --------------------------------------------------------------------------
# Training and ring attention on the card
# --------------------------------------------------------------------------
def test_k6_and_k7_refuse_inputs_that_require_grad_on_the_card(cuda):
    """The kernels have no backward: on the card they raise rather than hand
    back an output with no graph."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((1, 4, 128, 128), generator=gen, device=cuda) for _ in range(3))
    before = launch_counts()
    for x in (q, k, v):
        x.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention(q, k, v)
        x.requires_grad_(False)
    table = torch.randn((100, 16), device=cuda, requires_grad=True)
    ids = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        embedding_bag(table, ids)
    assert launch_counts() == before  # nothing launched
    with torch.no_grad():
        q.requires_grad_(True)
        assert flash_attention(q, k, v).shape == q.shape
        assert embedding_bag(table, ids).shape == (8, 16)


def _leaf_rel(got: dict, want: dict) -> float:
    return max(float(torch.linalg.vector_norm(got[n].detach().cpu() - w.detach())
                     / torch.linalg.vector_norm(w.detach())) for n, w in want.items())


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_v2_lite_16b", "autoint"])
def test_train_steps_on_the_card_match_the_cpu_port(cuda, arch):
    """Three steps from the same weights: losses and every parameter leaf
    within 1e-4 relative (a leaf by its norm)."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import LMTokenPipeline, RecsysPipeline
    from repro_torch.models import transformer as tf
    from repro_torch.models.recsys import autoint
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps

    cfg = get_smoke(arch)
    gen = torch.Generator(device=cuda).manual_seed(3)
    if arch == "autoint":
        m_dev = autoint.init_params(gen, cfg, device=cuda)
        m_cpu = autoint.AutoInt(cfg, device="cpu")
        step = steps.make_recsys_train_step(cfg)
        pipe = RecsysPipeline(cfg, 64, seed=1)
    else:
        m_dev = tf.init_params(gen, cfg, device=cuda)
        m_cpu = tf.Transformer(cfg, device="cpu")
        step = steps.make_lm_train_step(cfg, chunk_q=8, remat=True, ce_chunk=8)
        pipe = LMTokenPipeline(cfg, 2, 21, seed=1)
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_dev.state_dict().items()})
    s_dev, s_cpu = opt.init_state(m_dev), opt.init_state(m_cpu)
    assert s_dev["step"].device.type == "cuda"
    for i in range(3):
        m_dev, s_dev, a = step(m_dev, s_dev, pipe.batch_at(i))
        m_cpu, s_cpu, b = step(m_cpu, s_cpu, pipe.batch_at(i))
        assert a["loss"].device.type == "cuda"
        assert abs(a["loss"].item() - b["loss"].item()) <= 1e-4 * abs(b["loss"].item())
    assert _leaf_rel(dict(m_dev.named_parameters()), dict(m_cpu.named_parameters())) <= 1e-4


def test_train_lm_resumes_on_the_card_and_its_checkpoint_restores_on_the_cpu(cuda, tmp_path):
    from repro_torch.launch.train import train_lm, train_state_tree
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.utils import tree_leaves

    kw = dict(steps=6, batch=2, seq=16, log_every=100, device="cuda")
    full = train_lm("yi_6b", **kw)
    train_lm("yi_6b", **{**kw, "steps": 3}, ckpt_dir=str(tmp_path), ckpt_every=3)
    resumed = train_lm("yi_6b", **kw, ckpt_dir=str(tmp_path), ckpt_every=3)
    np.testing.assert_allclose(resumed["losses"], full["losses"][3:], rtol=1e-4)
    like = train_state_tree(resumed["model"], resumed["opt_state"], resumed["model"].cfg)
    got = CheckpointManager(str(tmp_path)).restore(6, like, device="cpu")
    for a, b in zip(tree_leaves(got), tree_leaves(like)):
        assert a.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a, b)


def _gnn_smoke_batch(arch, rng):
    """(init keywords, a loss batch) of ``arch``'s smoke config: 30 nodes,
    phantom-padded edges; DimeNet and MACE two molecules with graph ids."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.gnn.common import bidirect, pad_edges
    from repro_torch.models.gnn.dimenet import build_triplets

    cfg, n = get_smoke(arch), 30
    u = rng.integers(0, n, 50)
    edges = bidirect(np.stack([u, (u + rng.integers(1, n, 50)) % n], 1).astype(np.int32))
    if arch == "gin_tu":
        return {"d_in": 8}, {"x": rng.standard_normal((n, 8)).astype(np.float32),
                             "edges": pad_edges(edges, len(edges) + 5, n),
                             "labels": rng.integers(0, cfg.n_classes, n)}
    if arch == "graphcast":
        return {}, {"x": rng.standard_normal((n, cfg.n_vars)).astype(np.float32),
                    "edges": pad_edges(edges, len(edges) + 5, n),
                    "target": rng.standard_normal((n, cfg.n_vars)).astype(np.float32)}
    pos = (rng.standard_normal((n, 3)) * 1.5).astype(np.float32)
    gids = (np.arange(n) >= n // 2).astype(np.int32)
    keep = gids[edges[:, 0]] == gids[edges[:, 1]]
    batch = {"z": rng.integers(0, 4, n), "pos": pos, "graph_ids": gids, "n_graphs": 2,
             "edges": pad_edges(edges[keep], int(keep.sum()) + 5, n),
             "target": rng.standard_normal(2).astype(np.float32)}
    if arch == "dimenet":
        batch["triplets"] = build_triplets(edges[keep], n)
    return {}, batch


@pytest.mark.parametrize("arch", ["gin_tu", "graphcast", "dimenet", "mace"])
def test_gnn_smoke_configs_on_the_card_match_the_cpu_port(cuda, arch):
    """From the same weights (the card's, through ``convert``): the loss and
    every gradient leaf, then the parameters after one
    ``make_gnn_train_step`` step, within 1e-4 relative (a leaf by its norm);
    the card's path launches no hand-written kernel."""
    from repro_torch.configs import get_smoke
    from repro_torch.convert import gnn_params_from_numpy, gnn_params_to_numpy
    from repro_torch.models.gnn import dimenet, gin, graphcast, mace
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps

    cfg = get_smoke(arch)
    kw, batch = _gnn_smoke_batch(arch, np.random.default_rng(5))
    init = {"gin_tu": gin, "graphcast": graphcast, "dimenet": dimenet, "mace": mace}[arch]
    m_dev = init.init_params(torch.Generator(device=cuda).manual_seed(5), cfg, **kw, device=cuda)
    m_cpu = gnn_params_from_numpy(gnn_params_to_numpy(m_dev, cfg), cfg, device="cpu")
    assert m_dev.device.type == cuda.type
    before = launch_counts()
    out = []
    for m in (m_dev, m_cpu):
        named = dict(m.named_parameters())
        m.requires_grad_(True)
        loss = steps.gnn_loss(m, cfg, batch)
        grads = torch.autograd.grad(loss, list(named.values()), materialize_grads=True,
                                    allow_unused=True)
        m.requires_grad_(False)
        out.append((loss.item(), dict(zip(named, grads))))
    (l_dev, g_dev), (l_cpu, g_cpu) = out
    assert abs(l_dev - l_cpu) <= 1e-4 * abs(l_cpu)
    assert _leaf_rel(g_dev, g_cpu) <= 1e-4
    step = steps.make_gnn_train_step(cfg)
    step(m_dev, opt.init_state(m_dev), batch)
    step(m_cpu, opt.init_state(m_cpu), batch)
    assert _leaf_rel(dict(m_dev.named_parameters()), dict(m_cpu.named_parameters())) <= 1e-4
    assert not any(p.requires_grad for p in m_dev.parameters())
    assert launch_counts() == before  # segment sums and matmuls: no K1-K7


@pytest.mark.parametrize("arch", ["gin_tu", "graphcast", "mace"])
def test_partitioned_gnn_on_a_one_card_mesh_matches_the_single_device_model(cuda, arch):
    """``models/gnn/distributed``'s loss and gradients on four stages of the
    card against the single-device model on the card, the same weights,
    within 1e-4 relative (a leaf by its norm); a distributed train step
    leaves the weights float32 and not requiring grad; no K1-K7 launch."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import make_ring_mesh
    from repro_torch.models.gnn import distributed as D
    from repro_torch.models.gnn import gin, graphcast, mace
    from repro_torch.models.gnn.common import bidirect, pad_edges
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps

    cfg, n, rng = get_smoke(arch), 32, np.random.default_rng(7)
    u = rng.integers(0, n, 60)
    edges = bidirect(np.stack([u, (u + rng.integers(1, n, 60)) % n], 1).astype(np.int32))
    kw = {"d_in": 8} if arch == "gin_tu" else {}
    batch = {"gin_tu": lambda: {"x": rng.standard_normal((n, 8)).astype(np.float32),
                                "labels": rng.integers(0, cfg.n_classes, n)},
             "graphcast": lambda: {
                 "x": rng.standard_normal((n, cfg.n_vars)).astype(np.float32),
                 "target": rng.standard_normal((n, cfg.n_vars)).astype(np.float32)},
             "mace": lambda: {"z": rng.integers(0, 4, n),
                              "pos": (rng.standard_normal((n, 3)) * 1.5).astype(np.float32),
                              "target": np.array([0.5], np.float32)}}[arch]()
    init = {"gin_tu": gin, "graphcast": graphcast, "mace": mace}[arch]
    model = init.init_params(torch.Generator(device=cuda).manual_seed(7), cfg, **kw, device=cuda)
    mesh = make_ring_mesh(4, devices=[cuda] * 4)
    part = D.partition_edges_by_dst(edges, n, 4)[0]
    before = launch_counts()
    out = []
    for fn, b in ((D._BUILDERS[cfg.family](model, cfg, mesh), {**batch, "edges": part}),
                  (lambda m, bb: steps.gnn_loss(m, cfg, bb),
                   {**batch, "edges": pad_edges(edges, len(edges) + 3, n)})):
        named = dict(model.named_parameters())
        model.requires_grad_(True)
        loss = fn(model, b)
        grads = torch.autograd.grad(loss, list(named.values()), materialize_grads=True,
                                    allow_unused=True)
        model.requires_grad_(False)
        out.append((loss.item(), dict(zip(named, grads))))
    (l_mesh, g_mesh), (l_one, g_one) = out
    assert abs(l_mesh - l_one) <= 1e-4 * abs(l_one)
    assert _leaf_rel(g_mesh, {k: g.cpu() for k, g in g_one.items()}) <= 1e-4
    dtype = torch.bfloat16 if arch != "gin_tu" else None
    step = D.make_distributed_gnn_train_step(cfg, mesh, compute_dtype=dtype)
    _, _, m = step(model, opt.init_state(model), {**batch, "edges": part})
    assert np.isfinite(m["loss"].item())
    assert all(p.dtype == torch.float32 and not p.requires_grad for p in model.parameters())
    assert launch_counts() == before  # gathers, segment sums and matmuls: no K1-K7


def test_segment_ids_outside_the_range_are_dropped_on_the_card(cuda):
    """``index_add`` would assert on the card; the port masks such ids as the
    reference drops them."""
    from repro_torch.models.gnn.common import aggregate, segment_sum

    data = torch.arange(12.0, device=cuda).reshape(6, 2)
    ids = torch.tensor([0, 3, -1, 9, 2, 3], device=cuda)
    got = segment_sum(data, ids, 4)
    want = torch.zeros(4, 2).index_add(0, torch.tensor([0, 3, 2, 3]),
                                       data.cpu()[[0, 1, 4, 5]])
    assert torch.equal(got.cpu(), want)
    mx = aggregate(data, ids, 4, "max").cpu()
    assert torch.equal(mx[1], torch.zeros(2)) and torch.equal(mx[3], data.cpu()[5])


@pytest.mark.parametrize("n_stages", [2, 4, 8])
def test_ring_attention_on_a_one_card_mesh_matches_chunked_attention(cuda, n_stages):
    from repro_torch.launch import make_ring_mesh
    from repro_torch.models.chunked_attention import chunked_attention
    from repro_torch.models.ring_attention import ring_attention

    gen = torch.Generator(device=cuda).manual_seed(n_stages)
    q, k, v = (torch.randn((2, 4, 512, 64), generator=gen, device=cuda) for _ in range(3))
    mesh = make_ring_mesh(n_stages, devices=[cuda] * n_stages)
    with torch.no_grad():
        want = chunked_attention(q, k, v, causal=True, chunk_q=128)
        for m in (None, mesh):
            for _ in range(3):  # back to back, no synchronisation between the runs
                got = ring_attention(q, k, v, n_stages=n_stages, mesh=m)
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def _data_model_mesh(data, model, device):
    from repro_torch.launch import make_local_mesh

    return make_local_mesh(data=data, model=model, devices=[device] * (data * model))


@pytest.mark.parametrize("cf", [8.0, 1.25, 1.0])
def test_expert_parallel_moe_on_a_one_card_mesh_matches_the_cpu_port(cuda, cf):
    """moe_apply_ep of the deepseek_v2_lite_16b smoke layer on a one-card
    (2, 4) mesh against the CPU port's on a CPU (2, 4) mesh, same weights and
    tokens: routing equal as integers, y and aux within 2e-4, the router's
    gradient of y.sum() within 1e-4 (by its norm), the dropped share equal
    (none at 8.0, some at 1.0)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import moe

    cfg = get_smoke("deepseek_v2_lite_16b")
    layer = moe.moe_init(torch.Generator(device=cuda).manual_seed(7), cfg, device=cuda)
    host = moe.MoE(cfg, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (64, cfg.d_model)).astype(np.float32))
    assert torch.equal(moe.route(layer, cfg, x.to(cuda))[2].cpu(), moe.route(host, cfg, x)[2])
    got, want = {}, {}
    for out, p, xx, mesh in ((got, layer, x.to(cuda), _data_model_mesh(2, 4, cuda)),
                             (want, host, x, _data_model_mesh(2, 4, "cpu"))):
        p.router.requires_grad_(True)
        try:
            y, aux = moe.moe_apply_ep(p, cfg, xx, mesh=mesh, capacity_factor=cf)
            (g,) = torch.autograd.grad(y.sum(), [p.router])
        finally:
            p.router.requires_grad_(False)
        out.update(y=y.detach().cpu(), aux=aux.detach().cpu(), g=g.cpu(),
                   dropped=moe.ep_dropped(p, cfg, xx, mesh=mesh, capacity_factor=cf))
    torch.testing.assert_close(got["y"], want["y"], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got["aux"], want["aux"], rtol=2e-4, atol=2e-4)
    assert _leaf_rel({"g": got["g"]}, {"g": want["g"]}) <= 1e-4
    assert got["dropped"] == want["dropped"]
    assert want["dropped"] == 0 if cf == 8.0 else want["dropped"] > 0 if cf == 1.0 else True


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_v2_lite_16b"])
def test_mesh_train_step_on_a_one_card_mesh_matches_the_cpu_port(cuda, arch):
    """make_lm_train_step(mesh=(2, 4), seq_parallel=True, grad_specs=) on the
    card against the CPU port's on a CPU mesh, two steps from the same
    weights: losses within 2e-5, every parameter leaf within 1e-4 (by its
    norm)."""
    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_param_shapes
    from repro_torch.data.pipeline import LMTokenPipeline
    from repro_torch.launch import lm_param_specs
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps

    cfg = get_smoke(arch)
    m_dev = tf.init_params(torch.Generator(device=cuda).manual_seed(9), cfg, device=cuda)
    m_cpu = tf.Transformer(cfg, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_dev.state_dict().items()})
    pipe = LMTokenPipeline(cfg, 4, 16, seed=2)
    runs = []
    for m, dev in ((m_dev, cuda), (m_cpu, "cpu")):
        mesh = _data_model_mesh(2, 4, dev)
        step = steps.make_lm_train_step(cfg, chunk_q=8, mesh=mesh, seq_parallel=True,
                                        grad_specs=lm_param_specs(lm_param_shapes(m, cfg), mesh))
        state = opt.init_state(m)
        losses = [step(m, state, pipe.batch_at(i))[2]["loss"].item() for i in range(2)]
        runs.append(losses)
    for a, b in zip(*runs):
        assert abs(a - b) <= 2e-5 * abs(b), runs
    assert _leaf_rel(dict(m_dev.named_parameters()), dict(m_cpu.named_parameters())) <= 1e-4


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_v2_lite_16b"])
def test_mesh_prefill_on_a_one_card_mesh_matches_the_cpu_port(cuda, arch):
    """make_lm_prefill(mesh=(2, 4), seq_parallel=True): last-token logits
    within 1e-5 of the largest, and no hand-written kernel launched."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tf
    from repro_torch.train import steps

    cfg = get_smoke(arch)
    m_dev = tf.init_params(torch.Generator(device=cuda).manual_seed(10), cfg, device=cuda)
    m_cpu = tf.Transformer(cfg, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_dev.state_dict().items()})
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, (4, 24)).astype(np.int32)
    before = launch_counts()
    a, _ = steps.make_lm_prefill(cfg, 28, chunk_q=8, mesh=_data_model_mesh(2, 4, cuda),
                                 seq_parallel=True)(m_dev, tokens)
    assert launch_counts() == before
    b, _ = steps.make_lm_prefill(cfg, 28, chunk_q=8, mesh=_data_model_mesh(2, 4, "cpu"),
                                 seq_parallel=True)(m_cpu, tokens)
    assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(b.abs().max())


# --------------------------------------------------------------------------
# the dry run (launch.dryrun): K2 as a custom op, cells on the card
# --------------------------------------------------------------------------
@pytest.mark.parametrize("upper", [False, True])
def test_masked_matmul_sum_custom_op_launches_on_the_card(cuda, upper):
    """The op ``repro_torch::masked_matmul_sum`` on CUDA tensors launches K2
    (the count +1), never its fake, and equals the plain version."""
    rng = np.random.default_rng(29)
    a, b, m = (_rand01(rng, s, 0.4, cuda) for s in ((300, 513), (513, 700), (300, 700)))
    before = launch_counts()["masked_matmul_sum"]
    got = torch.ops.repro_torch.masked_matmul_sum(a, b, m, upper)
    assert launch_counts()["masked_matmul_sum"] == before + 1
    assert (got.device.type, got.dtype, got.shape) == ("cuda", torch.int64, ())
    assert int(got) == int(masked_matmul_sum_ref(a, b, m, upper_triangular=upper))


def test_masked_matmul_sum_takes_the_custom_op_only_under_a_dispatch_mode(cuda):
    """Outside a dispatch mode ``masked_matmul_sum`` launches K2 itself,
    without the dispatcher's hop; under ``FlopCounterMode`` it goes through
    the custom op, launches all the same and is counted by its flop
    formula."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.triangle_count.ops import masked_matmul_sum_ops

    rng = np.random.default_rng(30)
    a, b, m = (_rand01(rng, s, 0.4, cuda) for s in ((300, 513), (513, 700), (300, 700)))
    before = launch_counts()["masked_matmul_sum"]
    direct = masked_matmul_sum(a, b, m)
    with FlopCounterMode(display=False) as fc:
        seen = masked_matmul_sum(a, b, m)
    assert launch_counts()["masked_matmul_sum"] == before + 2
    assert int(direct) == int(seen) == int(masked_matmul_sum_ref(a, b, m))
    assert fc.get_total_flops() == masked_matmul_sum_ops(300, 513, 700) > 0


def _dry_cells(device, data, model, **kw):
    from repro_torch.configs import get_smoke
    from repro_torch.configs.shapes import LMShape
    from repro_torch.launch import dryrun, make_local_mesh

    mesh = make_local_mesh(data=data, model=model, devices=[device] * (data * model))
    return [dryrun.lm_cell(arch, LMShape(kind, 32, 8, kind), mesh, cfg=get_smoke(arch), **kw)
            for arch, kind in (("yi_6b", "train"), ("deepseek_v2_lite_16b", "prefill"),
                               ("deepseek_v2_lite_16b", "train"))]


def test_dryrun_smoke_lm_cells_on_the_card_count_the_meta_flops(cuda):
    """Smoke LM cells built by ``lm_cell`` on a one-card (2, 4) mesh count,
    on the card, the FLOPs their meta cells count; nothing launches."""
    from repro_torch.launch import dryrun

    gen = torch.Generator(device=cuda).manual_seed(0)
    before = launch_counts()
    for card, meta in zip(_dry_cells(cuda, 2, 4, generator=gen), _dry_cells("meta", 2, 4)):
        assert card.argument_bytes == meta.argument_bytes
        assert dryrun.count_cell(card).flops == dryrun.count_cell(meta).flops > 0
    assert launch_counts() == before


def test_dryrun_argument_bytes_on_a_one_card_mesh_are_the_cards(cuda):
    """On a (1, 1) mesh of the card a train cell's parameters, AdamW state
    and batch on the card are the dry run's argument bytes, exactly."""
    from repro_torch.utils import bytes_of

    gen = torch.Generator(device=cuda).manual_seed(0)
    for cell in _dry_cells(cuda, 1, 1, generator=gen)[::2]:
        model, state, batch = cell.args
        on_card = bytes_of(dict(model.named_parameters())) + bytes_of(state) + bytes_of(batch)
        assert all(t.device.type == "cuda" for t in (*model.parameters(), state["step"],
                                                     *batch.values()))
        assert on_card == cell.argument_bytes
