"""Tests of the port that need an NVIDIA GPU: each CUDA kernel against its
plain PyTorch version on the card, and the counter's methods on the card.

Every test carries the ``cuda`` marker and takes the ``cuda`` fixture,
which skips without a card, so on a CPU-only host the whole file skips. This file imports neither JAX nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.api import (  # noqa: E402
    GraphStats,
    Resources,
    TriangleCounter,
    count_triangles,
    plan,
)
from repro_torch.core.triangle_ref import count_triangles_brute  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.bitset_count.ops import bitset_edge_count  # noqa: E402
from repro_torch.kernels.bitset_count.ref import bitset_edge_count_ref  # noqa: E402
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


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        triangle_count(torch.zeros(8, 8, dtype=torch.float32, device=cuda))
    with pytest.raises(TypeError):
        bitset_edge_count(torch.zeros(8, 1, dtype=torch.int64, device=cuda),
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
