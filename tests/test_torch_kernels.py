"""The port's kernel modules against the reference's Pallas kernels (run in
interpret mode on the CPU, as the reference's own kernel tests run them).

On the CPU each wrapper runs its kernel's plain PyTorch version; these tests
hold those plain versions — and the wrappers' shape handling — against the
JAX wrappers on the same numpy inputs. Every count is compared as an exact
integer. The CUDA kernels themselves are held against the same plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import ctypes

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.triangle_ref import count_triangles_brute  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs.formats import forward_adjacency_dense  # noqa: E402
from repro.kernels.bitset_count.ops import bitset_edge_count as ref_bitset  # noqa: E402
from repro.kernels.triangle_count.ops import masked_matmul_sum as ref_mms  # noqa: E402
from repro.kernels.triangle_count.ops import triangle_count as ref_tc  # noqa: E402
from repro_torch.kernels import _build, launch_counts  # noqa: E402
from repro_torch.kernels.bitset_count.ops import bitset_edge_count  # noqa: E402
from repro_torch.kernels.bitset_count.ref import popcount32  # noqa: E402
from repro_torch.kernels.triangle_count.ops import (  # noqa: E402
    live_grid_size,
    masked_matmul_sum,
    triangle_count,
)
from repro_torch.kernels.triangle_count.ref import TILE  # noqa: E402


def _u(n, p, seed):
    return forward_adjacency_dense(ref_gen.gnp(n, p, seed=seed), dtype=np.uint8)


# --------------------------------------------------------------------------
# K1: live-grid triangle count
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n,p", [(96, 0.3), (200, 0.6), (130, 0.9)])
@pytest.mark.parametrize("block", [32, 64])
def test_triangle_count_matches_reference_kernel(n, p, block):
    u = _u(n, p, n)
    want = int(ref_tc(jnp.asarray(u, jnp.float32), block=block, interpret=True))
    ut = torch.from_numpy(u)
    got = triangle_count(ut)
    assert got.dtype == torch.int64 and got.shape == ()
    assert int(got) == want == count_triangles_brute(ref_gen.gnp(n, p, seed=n))
    assert int(triangle_count(ut, live_grid=False)) == want


def test_triangle_count_batch_matches_reference_per_graph():
    us = np.stack([np.pad(_u(n, 0.5, n), ((0, 120 - n), (0, 120 - n)))
                   for n in (40, 77, 120, 9)])
    got = triangle_count(torch.from_numpy(us))
    assert got.shape == (4,) and got.dtype == torch.int64
    want = [int(ref_tc(jnp.asarray(u, jnp.float32), block=32, interpret=True)) for u in us]
    assert got.tolist() == want


def test_triangle_count_exact_beyond_f32_mantissa():
    """C(600, 3) = 35,820,200 > 2²⁴: the int64 reduction stays exact."""
    u = np.triu(np.ones((600, 600), np.uint8), 1)
    assert int(triangle_count(torch.from_numpy(u))) == 600 * 599 * 598 // 6


def test_live_grid_size_is_closed_form():
    for nb in range(1, 9):
        assert live_grid_size(nb) == sum(j - i + 1 for i in range(nb) for j in range(i, nb))


# --------------------------------------------------------------------------
# K2: masked matmul-sum
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 128, 384), (64, 64, 64),
                                   (100, 70, 130)])
@pytest.mark.parametrize("upper", [False, True])
def test_masked_matmul_sum_matches_reference_kernel(shape, upper):
    R, N, K = shape
    rng = np.random.default_rng(R + N + K)
    a = (rng.random((R, K)) < 0.3).astype(np.uint8)
    b = (rng.random((K, N)) < 0.3).astype(np.uint8)
    m = (rng.random((R, N)) < 0.5).astype(np.uint8)
    # the reference's block grid must be the port's tile for the skip to agree
    want = int(ref_mms(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m), block_m=TILE,
                       block_n=TILE, block_k=TILE, upper_triangular=upper,
                       interpret=True))
    got = masked_matmul_sum(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(m),
                            upper_triangular=upper)
    assert got.dtype == torch.int64 and int(got) == want


def test_masked_matmul_sum_on_ring_column_slices():
    """The dense ring passes a column slice of the resident block (row stride
    n_pad, not R): the wrapper must read it in place and count the same."""
    u = torch.from_numpy(_u(96, 0.5, 3))
    cols = u[:32, 32:64]
    assert cols.stride() == (96, 1)
    want = int(ref_mms(jnp.asarray(cols.numpy()), jnp.asarray(u[32:64].numpy()),
                       jnp.asarray(u[:32].numpy()), block_m=32, block_n=32, block_k=32,
                       interpret=True))
    assert int(masked_matmul_sum(cols, u[32:64], u[:32])) == want


def test_masked_matmul_sum_rejects_bad_shapes():
    x = torch.zeros(4, 5, dtype=torch.uint8)
    with pytest.raises(ValueError):
        masked_matmul_sum(x, x, x)
    with pytest.raises(ValueError):
        triangle_count(x)


# --------------------------------------------------------------------------
# K3: bitset edge count
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_pad,w,b,seed", [(64, 2, 32, 0), (128, 4, 57, 1), (96, 1, 16, 2),
                                            (200, 37, 300, 3)])
def test_bitset_edge_count_matches_reference_kernel(n_pad, w, b, seed):
    rng = np.random.default_rng(seed)
    masks = rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint64).astype(np.uint32)
    edges = rng.integers(0, n_pad, size=(b, 2)).astype(np.int32)
    edges[rng.random(b) < 0.2, 0] = n_pad       # phantom edges count 0
    edges[rng.random(b) < 0.1, 0] = n_pad + 7   # any id >= n_pad is phantom
    edges[rng.random(b) < 0.1, 1] = n_pad       # v past the table is clamped
    want = int(ref_bitset(jnp.asarray(masks), jnp.asarray(edges), interpret=True))
    got = bitset_edge_count(torch.from_numpy(masks.view(np.int32)), torch.from_numpy(edges))
    assert got.dtype == torch.int64 and int(got) == want


def test_popcount32_survives_the_sign_bit():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xDEADBEEF], np.uint32)
    rng = np.random.default_rng(5)
    words = np.concatenate([words, rng.integers(0, 2**32, 500, dtype=np.uint64)
                            .astype(np.uint32)])
    want = np.array([bin(int(x)).count("1") for x in words])
    got = popcount32(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_bitset_edge_count_rejects_bad_shapes():
    with pytest.raises(ValueError):
        bitset_edge_count(torch.zeros(4, 2, dtype=torch.int32),
                          torch.zeros(3, 3, dtype=torch.int32))


# --------------------------------------------------------------------------
# Wrappers on the CPU, and the build/bind layer
# --------------------------------------------------------------------------
def test_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    before = launch_counts()
    u = torch.from_numpy(_u(50, 0.5, 1))
    triangle_count(u)
    masked_matmul_sum(u, u, u)
    bitset_edge_count(torch.zeros(8, 1, dtype=torch.int32), torch.zeros(4, 2, dtype=torch.int32))
    assert launch_counts() == before


def test_kernel_sources_are_found():
    assert set(_build.sources()) == {"triangle_count", "bitset_count"}
    for name in _build.sources():
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(name + "-")


def _fake_nvcc(tmp_path, body):
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\n" + body + "\n")
    script.chmod(0o755)
    return str(script)


def test_build_all_builds_once_and_raises_on_failure(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    # a compiler that writes its -o target: every library builds once
    ok = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done; echo built > "$2"')
    monkeypatch.setattr(_build, "_nvcc", lambda: ok)
    _build.build_all()
    for name in _build.sources():
        assert _build.library_path(name).read_text() == "built\n"
    assert _build.build_all() == {name: "" for name in _build.sources()}
    # a compiler that fails: the build raises with its log, nothing falls back
    for name in _build.sources():
        _build.library_path(name).unlink()
    bad = _fake_nvcc(tmp_path, "echo 'kernel.cu(1): error: boom'; exit 2")
    monkeypatch.setattr(_build, "_nvcc", lambda: bad)
    with pytest.raises(RuntimeError, match="boom"):
        _build.build_all()
    assert not any((tmp_path / "build").glob("*.so"))


def test_cuda_kernel_raises_on_launch_error_and_counts_successes():
    k = _build.CudaKernel("triangle_count", "tc_live", [ctypes.c_void_p], "tc_error_string")
    k._fn = lambda *args: 700
    k._err = lambda rc: b"an illegal memory access was encountered"
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        k(0, stream=0)
    assert k.launches == 0
    k._fn = lambda *args: 0
    k(0, stream=0)
    assert k.launches == 1


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    u = torch.zeros(4, 4, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        triangle_count(u)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        masked_matmul_sum(u, u, u)
    with pytest.raises(ValueError):
        bitset_edge_count(torch.zeros(4, 1, dtype=torch.int32, device="meta"),
                          torch.zeros(2, 2, dtype=torch.int32, device="meta"))
