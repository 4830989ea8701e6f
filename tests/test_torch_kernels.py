"""The port's kernel modules against the reference's Pallas kernels (run in
interpret mode on the CPU, as the reference's own kernel tests run them).

On the CPU each wrapper runs its kernel's plain PyTorch version; these tests
hold those plain versions — and the wrappers' shape handling — against the
JAX wrappers on the same numpy inputs. Every count is compared as an exact
integer. The CUDA kernels themselves are held against the same plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import ctypes
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.triangle_ref import count_triangles_brute  # noqa: E402
from repro.graphs import generators as ref_gen  # noqa: E402
from repro.graphs.formats import forward_adjacency_dense  # noqa: E402
from repro.kernels.bitset_count.ops import bitset_edge_count as ref_bitset  # noqa: E402
from repro.kernels.bitset_count.ops import bitset_pair_count as ref_pair  # noqa: E402
from repro.kernels.bitset_count.ref import bitset_pair_count_ref as ref_pair_oracle  # noqa: E402
from repro.kernels.embedding_bag.ops import embedding_bag as ref_bag  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref as ref_bag_oracle  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as ref_attention  # noqa: E402
from repro.kernels.triangle_count.ops import masked_matmul_sum as ref_mms  # noqa: E402
from repro.kernels.triangle_count.ops import triangle_count as ref_tc  # noqa: E402
from repro_torch.api import bucket  # noqa: E402
from repro_torch.kernels import _build, launch_counts  # noqa: E402
from repro_torch.kernels.bitset_count.ops import (  # noqa: E402
    bitset_edge_count,
    bitset_pair_count,
)
from repro_torch.kernels.bitset_count.ref import (  # noqa: E402
    bitset_edge_count_ref,
    bitset_pair_count_ref,
    popcount32,
)
from repro_torch.kernels.embedding_bag.ops import embedding_bag  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    _tma_ready,
    _tma_strides,
    flash_attention,
    kernel_route,
    pv_key_order,
    tf32_split,
    vt_operand,
)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.triangle_count import ops as tc_ops  # noqa: E402
from repro_torch.kernels.triangle_count.ops import (  # noqa: E402
    MIN_SLICE,
    SPLIT_WAVES,
    _tma_operand,
    live_grid_size,
    masked_matmul_sum,
    split_plan,
    tma_batch_strides,
    tma_row_stride,
    triangle_count,
    work_item,
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


@functools.lru_cache(maxsize=None)
def _k1_batch(n):
    """Three graphs of at most n nodes, each in the corner of one matrix of a
    bucket-sized (3, n_b, n_b) buffer — as the counter builds them — and the
    reference kernel's count of each n x n view (interpret mode, block 128)."""
    n_b = bucket(n)
    buf = np.zeros((3, n_b, n_b), np.uint8)
    for b, (k, p) in enumerate(((n, 0.3), (max(1, n // 2), 0.6), (max(1, n - 5), 0.9))):
        buf[b, :k, :k] = _u(k, p, n + b)
    want = [int(ref_tc(jnp.asarray(buf[b, :n, :n], jnp.float32), interpret=True))
            for b in range(3)]
    return buf, want


@pytest.mark.parametrize("n", [1, 63, 129, 300, 1000])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_live_work_decomposition_counts_a_batch_of_views(n, sms, monkeypatch):
    """K1's arithmetic in numpy: per work item of split_plan(n, n, n, True,
    sms), decoded by work_item as the kernel decodes blockIdx.x, and per
    matrix (blockIdx.y), the s32 tile U[rb]·U[kb]ᵀ over the item's chunks,
    masked with U[rb, kb] and summed. U is the n x n view of a bucket-sized
    buffer that the kernel's tensor map reads (zeros past n). Each matrix's
    sum equals the reference kernel's count, exactly, at the default
    MIN_SLICE and with slices of a single chunk up."""
    buf, want = _k1_batch(n)
    view = buf[:, :n, :n].astype(np.int64)
    for min_slice in (MIN_SLICE, 1):
        monkeypatch.setattr(tc_ops, "MIN_SLICE", min_slice)
        slice_, items = split_plan(n, n, n, True, sms)
        total = np.zeros(len(view), np.int64)
        for i in range(items):
            rb, kb, c0, c1 = work_item(i, n, n, n, True, slice_)
            rows, inner = slice(rb * TILE, (rb + 1) * TILE), slice(kb * TILE, (kb + 1) * TILE)
            cols = slice(c0 * TILE, c1 * TILE)
            acc = view[:, rows, cols] @ view[:, inner, cols].transpose(0, 2, 1)
            assert acc.max(initial=0) <= (c1 - c0) * TILE  # s32 is exact
            total += (acc * view[:, rows, inner]).sum(axis=(1, 2))
        assert total.tolist() == want
    got = triangle_count(torch.from_numpy(buf)[:, :n, :n])
    assert got.dtype == torch.int64 and got.tolist() == want


def test_tma_batch_strides_take_bucket_views_and_refuse_what_tma_cannot_read():
    """K1 reads a (B, n, n) batch in place when each matrix keeps TMA's row
    rule and the matrix stride is a multiple of 16 covering a matrix: a view
    u[:, :n, :n] of an aligned bucket, at any n. Anything else is copied
    into zeros whose rows are rounded up to 16."""
    buf = torch.zeros(3, 128, 128, dtype=torch.uint8)
    assert tma_batch_strides(buf) == (128, 128 * 128)
    for n in (63, 100, 128):
        assert tma_batch_strides(buf[:, :n, :n]) == (128, 128 * 128)
    assert tma_batch_strides(buf[:, :1, :1]) == (16, 128 * 128)  # a single row: never stepped
    assert tma_batch_strides(buf[1:, :63, :63]) == (128, 128 * 128)
    assert tma_batch_strides(buf[:1, :100, :100]) == (128, 100 * 128)  # one matrix
    assert tma_batch_strides(buf[:, 0, :5][:, None]) == (16, 128 * 128)  # one row each
    assert tma_batch_strides(torch.zeros(3, 100, 100, dtype=torch.uint8)) is None  # row stride
    assert tma_batch_strides(buf[:, 3:67, 3:67]) is None        # base 3 bytes off
    assert tma_batch_strides(buf.transpose(1, 2)) is None        # column stride 128
    flat = torch.zeros(3 * 264, dtype=torch.uint8)
    assert tma_batch_strides(flat.as_strided((3, 16, 16), (264, 16, 1))) is None  # 264 % 16
    assert tma_batch_strides(flat.as_strided((3, 16, 16), (128, 16, 1))) is None  # overlap
    assert tma_batch_strides(buf[:1].expand(3, 128, 128)) is None  # matrix stride 0
    assert tma_batch_strides(torch.zeros(5, 1, 1, dtype=torch.uint8)) is None
    for x, strides in ((torch.ones(3, 100, 100, dtype=torch.uint8), (112, 100 * 112)),
                       (torch.ones(5, 1, 1, dtype=torch.uint8), (16, 16)),
                       (buf[:, 3:67, 3:67] + 1, (64, 64 * 64)),   # contiguous, aligned
                       (buf.transpose(1, 2) + 1, (128, 128 * 128))):
        op = _tma_operand(x)
        assert tma_batch_strides(op) == strides
        assert torch.equal(op[..., :x.shape[-1]], x)


def test_live_grid_size_is_closed_form():
    for nb in range(1, 9):
        assert live_grid_size(nb) == sum(j - i + 1 for i in range(nb) for j in range(i, nb))


# --------------------------------------------------------------------------
# K2: masked matmul-sum
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 128, 384), (64, 64, 64),
                                   (100, 70, 130), (300, 513, 260), (384, 256, 640)])
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


def _live_pairs(R, K, N, upper):
    """Every (output tile, chunk) pair the kernel must visit once."""
    nr, nk, nc = (-(-x // TILE) for x in (R, K, N))
    return {(rb, kb, c) for rb in range(nr) for kb in range(nk) for c in range(nc)
            if not upper or rb <= kb <= c}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("upper", [False, True])
def test_split_plan_work_items_cover_each_live_pair_once(seed, upper):
    """K2's grid: the items of split_plan, decoded by work_item as the kernel
    decodes blockIdx.x, visit every live (output tile, chunk) pair exactly
    once, each item a non-empty run of at most `slice` chunks."""
    rng = np.random.default_rng(seed)
    for _ in range(8):
        R, K, N = (int(x) for x in rng.integers(1, 3000, 3))
        sms = int(rng.choice([1, 7, 132]))
        slice_, items = split_plan(R, K, N, upper, sms)
        seen = []
        for i in range(items):
            rb, kb, c0, c1 = work_item(i, R, K, N, upper, slice_)
            assert 0 < c1 - c0 <= slice_
            seen += [(rb, kb, c) for c in range(c0, c1)]
        assert len(seen) == len(set(seen))
        assert set(seen) == _live_pairs(R, K, N, upper)


def test_split_plan_fills_the_card_at_the_ring_shapes():
    """FNA.5's ring visit (256 output tiles) is split along N until the grid
    fills 132 SMs SPLIT_WAVES times; FB107x9's (4,096 tiles) is not split;
    no slice is shorter than MIN_SLICE chunks unless N is."""
    assert split_plan(2048, 2048, 8192, False, 132) == (13, 1280)
    assert 1280 >= SPLIT_WAVES * 132
    assert split_plan(8192, 8192, 32768, False, 132) == (256, 4096)
    assert split_plan(128, 128, 128 * 1000, False, 132) == (MIN_SLICE, 125)
    assert split_plan(100, 70, 130, True, 132) == (2, 1)
    assert split_plan(300, 100, 1000, True, 132) == (8, 1)  # one live tile, (0, 0)
    assert split_plan(8192, 8192, 8192, True, 132) == (64, 64 * 65 // 2)


@pytest.mark.parametrize("shape", [(300, 513, 260), (129, 1000, 130), (200, 300, 2000),
                                   (1, 1, 1), (33, 1, 17)])
@pytest.mark.parametrize("upper", [False, True])
def test_work_decomposition_computes_the_masked_sum(shape, upper):
    """The kernel's arithmetic in numpy: per work item the s32 tile
    M[rb]·B[kb]ᵀ over its chunks, masked with A[rb, kb] and summed — the
    reassociation Σ (A·B) ⊙ M = Σ A ⊙ (M·Bᵀ) — equals the plain version."""
    R, K, N = shape
    rng = np.random.default_rng(R + K + N)
    a = (rng.random((R, K)) < 0.4).astype(np.int64)
    b = (rng.random((K, N)) < 0.4).astype(np.int64)
    m = (rng.random((R, N)) < 0.5).astype(np.int64)
    slice_, items = split_plan(R, K, N, upper, 4)
    total = 0
    for i in range(items):
        rb, kb, c0, c1 = work_item(i, R, K, N, upper, slice_)
        rows, inner = slice(rb * TILE, (rb + 1) * TILE), slice(kb * TILE, (kb + 1) * TILE)
        cols = slice(c0 * TILE, c1 * TILE)
        acc = m[rows, cols] @ b[inner, cols].T
        assert acc.max(initial=0) <= (c1 - c0) * TILE  # s32 is exact
        total += int((acc * a[rows, inner]).sum())
    want = masked_matmul_sum(*(torch.from_numpy(x.astype(np.uint8)) for x in (a, b, m)),
                             upper_triangular=upper)
    assert total == int(want)


def test_tma_row_stride_takes_aligned_rows_and_refuses_what_tma_cannot_read():
    """K2's B and M go to TMA as they lie only with a 16-byte aligned base
    and a row stride that is a multiple of 16 covering the row; the wrapper
    copies anything else into rows rounded up to 16."""
    big = torch.zeros(40, 1024, dtype=torch.uint8)
    assert tma_row_stride(big) == 1024
    assert tma_row_stride(big[3:9, 16:200]) == 1024       # aligned offset and stride
    assert tma_row_stride(big[:, 5:100]) is None           # base 5 bytes off
    assert tma_row_stride(torch.zeros(8, 24, dtype=torch.uint8)) is None  # stride 24
    assert tma_row_stride(torch.zeros(1, 17, dtype=torch.uint8)) == 32    # one row
    assert tma_row_stride(torch.zeros(8, 32, dtype=torch.uint8).t()) is None  # column stride 8
    assert tma_row_stride(torch.zeros(1, 32, dtype=torch.uint8).expand(5, 32)) is None
    assert tma_row_stride(torch.zeros(4, 32, dtype=torch.uint8)[:, :16]) == 32


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
# K4: bitset pair count (two tables)
# --------------------------------------------------------------------------
def _words(rng, shape):
    """Random 32-bit words with the top bit set in about half of them."""
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n_pad,w,b,seed", [(64, 1, 31, 0), (64, 2, 57, 1), (96, 3, 41, 2),
                                            (70, 33, 129, 3), (40, 140, 77, 4)])
def test_bitset_pair_count_matches_reference_kernel(n_pad, w, b, seed):
    rng = np.random.default_rng(seed)
    a, bt = _words(rng, (n_pad, w)), _words(rng, (n_pad, w))
    a[:, -1] |= np.uint32(0x80000000)  # bit 31 in every row of one word
    edges = rng.integers(0, n_pad, size=(b, 2)).astype(np.int32)
    edges[rng.random(b) < 0.2, 0] = n_pad       # phantom edges count 0
    edges[rng.random(b) < 0.1, 0] = n_pad + 5   # any id >= n_pad is phantom
    edges[rng.random(b) < 0.1, 1] = n_pad       # v past the tables is clamped
    ta, tb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(bt.view(np.int32))
    te = torch.from_numpy(edges)
    for x, y, tx, ty in ((a, bt, ta, tb), (bt, a, tb, ta)):  # a != b: both orders
        want = int(ref_pair(jnp.asarray(x), jnp.asarray(y), jnp.asarray(edges),
                            interpret=True))
        assert want == int(ref_pair_oracle(jnp.asarray(x), jnp.asarray(y), jnp.asarray(edges)))
        got = bitset_pair_count(tx, ty, te)
        assert got.dtype == torch.int64 and got.shape == () and int(got) == want
        assert int(bitset_pair_count_ref(tx, ty, te)) == want
    assert int(bitset_pair_count(ta, tb, te)) != int(bitset_pair_count(tb, ta, te))


def test_bitset_edge_count_is_the_one_table_pair_count():
    rng = np.random.default_rng(9)
    m = torch.from_numpy(_words(rng, (50, 5)).view(np.int32))
    e = torch.from_numpy(rng.integers(0, 60, size=(200, 2)).astype(np.int32))
    assert int(bitset_edge_count_ref(m, e)) == int(bitset_pair_count_ref(m, m, e)) == \
        int(bitset_pair_count(m, m, e))


def test_bitset_pair_count_rejects_bad_shapes():
    t = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        bitset_pair_count(t, torch.zeros(4, 3, dtype=torch.int32),
                          torch.zeros(3, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        bitset_pair_count(t, torch.zeros(5, 2, dtype=torch.int32),
                          torch.zeros(3, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        bitset_pair_count(t, t, torch.zeros(3, 3, dtype=torch.int32))


# --------------------------------------------------------------------------
# K6: causal GQA flash attention (float tolerances of the reference's own
# kernel test, tests/test_kernel_flash_attention.py)
# --------------------------------------------------------------------------
def _qkv(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("s", [128, 256, 200])
def test_flash_attention_matches_reference_kernel_f32(hq, hkv, s):
    q, k, v = _qkv(2, hq, hkv, s, 64, hq * s)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                     block_k=128, interpret=True)
    _close(got, want, 2e-5)
    _close(attention_ref(*(torch.from_numpy(x) for x in (q, k, v))),
           ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)), 2e-5)


def test_flash_attention_matches_reference_kernel_bf16():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(1, 4, 2, 256, 64, 3))
    got = flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v))
    want = ref_flash(jq, jk, jv, interpret=True)
    _close(got.float(), want.astype(jnp.float32), 3e-2)


@pytest.mark.parametrize("s", [1, 77, 200])
def test_flash_attention_takes_full_attention_at_a_ragged_length(s):
    """Deliberate difference: the reference wrapper refuses causal=False
    when S needs padding; the port pads nothing and takes it at any S."""
    q, k, v = _qkv(2, 4, 2, s, 32, s)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    if s % 128:
        with pytest.raises(ValueError, match="non-causal padding"):
            ref_flash(jq, jk, jv, causal=False, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=False)
    _close(got, ref_attention(jq, jk, jv, causal=False), 2e-5)


def test_flash_attention_reads_head_views_and_rejects_bad_shapes():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 9, 4 * 16)).astype(
        np.float32))
    q = x.reshape(2, 9, 4, 16).transpose(1, 2)  # the layout _split_heads gives
    kv = x[..., :32].reshape(2, 9, 2, 16).transpose(1, 2)
    _close(flash_attention(q, kv, kv), attention_ref(q.contiguous(), kv.contiguous(),
                                                     kv.contiguous()), 1e-6)
    z = torch.zeros(1, 3, 4, 8)
    for bad in ((z, torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8)),  # 3 % 2
                (z, torch.zeros(1, 3, 5, 8), torch.zeros(1, 3, 5, 8)),  # S differs
                (z, z, torch.zeros(1, 3, 4, 9)),                        # v differs
                (z[0], z[0], z[0])):                                    # not 4-D
        with pytest.raises(ValueError):
            flash_attention(*bad)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "tf32x3"), (torch.float32, 128, "tf32x3"),
    (torch.bfloat16, 16, "fma"), (torch.bfloat16, 200, "fma"),
    (torch.float32, 16, "fma"), (torch.float32, 200, "fma")])
def test_flash_attention_route_is_chosen_by_dtype_and_head_dim(dtype, d, route):
    """On the card, at D in {64, 128}, bf16 launches the bf16 wgmma kernel
    and f32 the three-pass TF32 one; every other head dim the FMA kernel.
    Nothing but (dtype, D) decides."""
    assert kernel_route(dtype, d) == route


@pytest.mark.parametrize("dtype,d,dv,route", [
    (torch.bfloat16, 192, 128, "wgmma"), (torch.float32, 192, 128, "tf32x3"),
    (torch.bfloat16, 192, 192, "fma"), (torch.float32, 192, 192, "fma"),
    (torch.bfloat16, 24, 16, "fma"), (torch.float32, 24, 16, "fma"),
    (torch.bfloat16, 200, 200, "fma"), (torch.float32, 200, 200, "fma"),
    (torch.bfloat16, 128, 64, "fma"), (torch.float32, 64, 64, "tf32x3")])
def test_flash_attention_route_at_mla_head_dims(dtype, d, dv, route):
    """MLA's (D, Dv) = (nope + rope, v) = (192, 128) takes the tensor-core
    routes; MLA's v padded to 192 and the smoke configs' (24, 16) the FMA
    kernel. Nothing but (dtype, D, Dv) decides."""
    assert kernel_route(dtype, d, dv) == route


def _mla_qkv(b, h, s, d, dv, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, w)).astype(np.float32) for w in (d, d, dv))


def _ref_flash_padded(q, k, v, *, causal=True):
    """The reference's kernel as its ``mla_full`` calls it: v zero-padded to
    D, the output sliced back to Dv (Pallas in interpret mode)."""
    d, dv = q.shape[-1], v.shape[-1]
    v_pad = np.pad(v, ((0, 0), (0, 0), (0, 0), (0, d - dv)))
    return np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v_pad),
                                causal=causal, interpret=True))[..., :dv]


@pytest.mark.parametrize("hq,hkv,s", [(2, 2, 128), (4, 1, 256)])
def test_flash_attention_takes_v_narrower_than_q_and_k(hq, hkv, s):
    """Dk 192, Dv 128 (DeepSeek-V2's MLA) unpadded: equal to the reference's
    padded Pallas call, sliced to Dv, within its kernel test's 2e-5."""
    q, k, v = _mla_qkv(1, hq, s, 192, 128, s + hq)
    k, v = k[:, :hkv], v[:, :hkv]
    got = flash_attention(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v)))
    assert got.shape == (1, hq, s, 128) and got.dtype == torch.float32
    _close(got, _ref_flash_padded(q, k, v), 2e-5)


@pytest.mark.parametrize("bad", ["dv>d", "s", "b", "h"])
def test_flash_attention_rejects_a_v_it_cannot_take(bad):
    """v wider than q and k, or of another length, batch or head count,
    raises ValueError: only its head dim may differ, and only downwards."""
    q = k = torch.zeros(2, 4, 8, 24)
    v = {"dv>d": torch.zeros(2, 4, 8, 32), "s": torch.zeros(2, 4, 9, 16),
         "b": torch.zeros(1, 4, 8, 16), "h": torch.zeros(2, 2, 8, 16)}[bad]
    with pytest.raises(ValueError):
        flash_attention(q, k, v)


# The three-pass TF32 kernel's arithmetic, emulated from the pure functions
# it shares with ops.py: every product a tensor-core product of TF32
# operands (exact in f32: 11 x 11 significant bits), summed in f32.
def _tf32(x):
    return tf32_split(x)[0]


def _tf32x3_emulation(q, k, v, *, causal=True, passes=3):
    """The kernel on the CPU: S = Q·K + Q·K_lo + Q_lo·K (the wgmma reads
    each f32 word as TF32), P·V = P·Vᵀ + P_lo·Vᵀ + P·Vᵀ_lo with P's columns
    and V's keys both in pv_key_order (Vᵀ from vt_operand, padded to S8).
    ``passes=1`` keeps only the first product of each: one TF32 pass."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    q_hi, q_lo = tf32_split(q)
    k_hi, k_lo = tf32_split(k)
    sc = q_hi @ k_hi.mT
    if passes == 3:
        sc = sc + q_hi @ _tf32(k_lo).mT + _tf32(q_lo) @ k_hi.mT
    sc = sc * d**-0.5
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), float("-inf"))
    p = (sc - sc.amax(-1, keepdim=True)).exp()
    den = p.sum(-1, keepdim=True)
    vt = vt_operand(v)
    s8 = vt.shape[-1]
    keys = torch.arange(s8).view(-1, 8)[:, list(pv_key_order())].reshape(-1)
    p_hi, p_lo = tf32_split(torch.nn.functional.pad(p, (0, s8 - s))[..., keys])
    vt_hi, vt_lo = tf32_split(vt)
    o = p_hi @ vt_hi.mT
    if passes == 3:
        o = o + _tf32(p_lo) @ vt_hi.mT + p_hi @ _tf32(vt_lo).mT
    return o / den


def test_tf32_split_reconstructs_x_and_bounds_what_the_tensor_cores_drop():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.uniform(-20, 20, 100_000)).astype(np.float32))
    hi, lo = tf32_split(x)
    assert torch.equal(hi + lo, x)                                  # lo is exact
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros_like(x, dtype=torch.int32))
    assert bool((hi.abs() <= x.abs()).all())                       # truncated toward zero
    assert bool((lo.abs() < 2.0**-10 * x.abs()).all())
    # the tensor cores read lo truncated in turn: hi + tf32(lo) is within
    # 2^-21 |x| of x, where one pass keeps only 2^-10
    assert bool(((x - (hi + _tf32(lo))).abs() <= 2.0**-21 * x.abs()).all())
    assert float(((x - hi).abs() / x.abs()).max()) > 2.0**-11


def test_pv_key_order_hands_the_accumulator_to_the_tf32_a_fragment():
    """Thread t of a quad holds accumulator columns 2t and 2t + 1 of each
    8-key group (registers e = 0, 1) and passes them as TF32 A-fragment
    registers a0 and a2, which wgmma reads as columns t and t + 4
    (PTX ISA, wgmma .tf32 register fragments): position p of the
    contraction holds key pv_key_order()[p]."""
    key_at = {}
    for t in range(4):
        key_at[t] = 2 * t          # a0 <- accumulator register 0
        key_at[t + 4] = 2 * t + 1  # a2 <- accumulator register 1
    assert pv_key_order() == tuple(key_at[p] for p in range(8)) == (0, 2, 4, 6, 1, 3, 5, 7)
    assert sorted(pv_key_order()) == list(range(8))


@pytest.mark.parametrize("s", [1, 13, 16])
def test_vt_operand_is_v_transposed_padded_and_in_key_order(s):
    v = torch.from_numpy(np.random.default_rng(s).standard_normal((2, 3, s, 4)).astype(
        np.float32))
    vt = vt_operand(v)
    s8 = -(-s // 8) * 8
    assert vt.shape == (2, 3, 4, s8) and vt.is_contiguous()
    order = pv_key_order()
    for pos in range(s8):
        key = 8 * (pos // 8) + order[pos % 8]
        want = v[:, :, key] if key < s else torch.zeros(2, 3, 4)
        assert torch.equal(vt[..., pos], want)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("s", [128, 256, 200])
def test_tf32x3_emulation_matches_reference_kernel(hq, hkv, s):
    """Three TF32 passes, emulated, against the reference's Pallas kernel at
    its own f32 tolerance, at that test's shapes."""
    q, k, v = _qkv(2, hq, hkv, s, 64, hq * s)
    got = _tf32x3_emulation(*(torch.from_numpy(x) for x in (q, k, v)))
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                     block_k=128, interpret=True)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("s", [1, 77, 200])
def test_tf32x3_emulation_takes_full_attention_at_a_ragged_length(s):
    q, k, v = _qkv(2, 4, 2, s, 128, s + 1)
    got = _tf32x3_emulation(*(torch.from_numpy(x) for x in (q, k, v)), causal=False)
    _close(got, ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False),
           2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_tf32x3_emulation_at_mla_head_dims_matches_reference_kernel(causal):
    """The three-pass kernel's arithmetic at Dk 192, Dv 128 (Vᵀ at Dv from
    vt_operand) against the reference's padded Pallas call sliced to Dv."""
    q, k, v = _mla_qkv(1, 2, 128, 192, 128, 11 + causal)
    got = _tf32x3_emulation(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    assert got.shape == (1, 2, 128, 128)
    _close(got, _ref_flash_padded(q, k, v, causal=causal), 2e-5)


@pytest.mark.parametrize("s", [5, 128])
def test_vt_operand_at_mla_v_head_dim(s):
    """Vᵀ at Dv = 128 beside Dk = 192: (B, Hkv, Dv, S8), the keys of each
    8-key group in pv_key_order, zero past S."""
    v = torch.from_numpy(np.random.default_rng(s).standard_normal((1, 2, s, 128)).astype(
        np.float32))
    vt = vt_operand(v)
    s8 = -(-s // 8) * 8
    assert vt.shape == (1, 2, 128, s8) and vt.is_contiguous()
    keys = [8 * (p // 8) + pv_key_order()[p % 8] for p in range(s8)]
    for pos, key in enumerate(keys):
        assert torch.equal(vt[..., pos], v[:, :, key] if key < s else torch.zeros(1, 2, 128))


@pytest.mark.parametrize("s", [128, 200])
def test_one_tf32_pass_misses_the_reference_tolerance(s):
    """Why three passes: one TF32 product of each operand pair (11
    significant bits) lands far outside the reference kernel test's 2e-5."""
    q, k, v = _qkv(2, 4, 2, s, 64, 7 * s)
    got = _tf32x3_emulation(*(torch.from_numpy(x) for x in (q, k, v)), passes=1)
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                                block_k=128, interpret=True))
    err = np.abs(got.numpy() - want)
    assert not bool((err <= 2e-5 + 2e-5 * np.abs(want)).all())
    assert float(err.max()) > 10 * 2e-5


def test_tma_strides_take_head_views_and_refuse_what_tma_cannot_read():
    """The wgmma route reads q, k, v in place when their bases and strides
    keep TMA's 16-byte rule, and copies them contiguous otherwise."""
    x = torch.zeros(2, 300, 8 * 64, dtype=torch.bfloat16)
    q = x.reshape(2, 300, 8, 64).transpose(1, 2)          # _split_heads' layout
    assert _tma_strides(q) == q.stride()[:3] == (300 * 512, 64, 512)
    # a dimension of size 1 is never stepped over: its stride may be anything
    one = torch.zeros(1, 4, 5, 64, dtype=torch.bfloat16).as_strided((1, 4, 5, 64),
                                                                   (3, 320, 64, 1))
    assert _tma_strides(one) == (1280, 320, 64)
    wide = torch.zeros(2, 3, 5, 72, dtype=torch.bfloat16)
    assert _tma_strides(wide[..., :64]) == (1080, 360, 72)  # 144-byte rows
    assert _tma_strides(torch.zeros(2, 3, 5, 68, dtype=torch.bfloat16)[..., :64]) is None
    assert _tma_strides(wide[..., 1:65]) is None           # base 2 bytes off
    assert _tma_strides(wide[..., :64].transpose(-1, -2)) is None  # last dim strided
    assert _tma_strides(torch.zeros(1, 2, 5, 64, dtype=torch.bfloat16).expand(
        3, 2, 5, 64)) is None                               # a zero stride


def test_tma_strides_in_f32_reckon_in_four_byte_elements():
    """The tf32x3 route reads f32 q and k in place when every stride is a
    multiple of 4 elements (16 bytes) and the base is 16-byte aligned."""
    x = torch.zeros(2, 300, 8 * 128)
    q = x.reshape(2, 300, 8, 128).transpose(1, 2)         # _split_heads' layout
    assert _tma_strides(q) == q.stride()[:3] == (300 * 1024, 128, 1024)
    assert _tma_strides(torch.zeros(2, 3, 5, 68)[..., :64]) == (1020, 340, 68)  # 272 bytes
    assert _tma_strides(torch.zeros(2, 3, 5, 66)[..., :64]) is None  # 264-byte rows
    assert _tma_strides(torch.zeros(2, 3, 5, 72)[..., 2:66]) is None  # base 8 bytes off
    assert _tma_strides(torch.zeros(2, 3, 5, 72)[..., 4:68]) == (1080, 360, 72)


def test_tma_ready_copies_a_contiguous_tensor_whose_base_tma_cannot_read():
    """A contiguous view 4 bytes past an aligned base keeps its strides but
    not TMA's rule: it is copied into a fresh (aligned) tensor, not passed on
    as it is, which ``contiguous()`` would do."""
    x = torch.arange(1 + 2 * 4 * 8 * 64, dtype=torch.float32)[1:].view(2, 4, 8, 64)
    assert x.is_contiguous() and _tma_strides(x) is None
    y = _tma_ready(x)
    assert y.data_ptr() != x.data_ptr() and _tma_strides(y) and torch.equal(y, x)
    z = torch.zeros(2, 4, 8, 64)
    assert _tma_ready(z) is z


# --------------------------------------------------------------------------
# K7: sum-mode EmbeddingBag (tolerances of tests/test_kernel_embedding_bag.py)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("v,d,b,l", [(64, 16, 8, 4), (256, 128, 4, 10), (1000, 32, 16, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_matches_reference_kernel(v, d, b, l, dtype):
    rng = np.random.default_rng(v + b)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, l)).astype(np.int32)
    idx[rng.random((b, l)) < 0.3] = v          # sentinel padding
    idx[0, 0], idx[-1, -1] = v - 1, v + 9      # the last row; any id >= V pads
    jt = jnp.asarray(table).astype(getattr(jnp, dtype))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    got = embedding_bag(tt, torch.from_numpy(idx))
    assert got.dtype == tt.dtype and got.shape == (b, d)
    want = ref_bag(jt, jnp.asarray(idx), interpret=True)
    tol = 1e-6 if dtype == "float32" else 3e-2
    _close(got.float(), want.astype(jnp.float32), tol)
    _close(embedding_bag_ref(tt, torch.from_numpy(idx)).float(),
           ref_bag_oracle(jt, jnp.asarray(idx)).astype(jnp.float32), tol)


def test_embedding_bag_all_padding_is_zero():
    idx = np.full((4, 5), 16, np.int32)
    got = embedding_bag(torch.ones(16, 8), torch.from_numpy(idx))
    want = ref_bag(jnp.ones((16, 8), jnp.float32), jnp.asarray(idx), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.any()


def test_embedding_bag_counts_negative_ids_as_padding():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    got = embedding_bag(table, torch.tensor([[0, -1, 2], [-4, 5, 3]], dtype=torch.int32))
    assert got.tolist() == [[6.0, 8.0, 10.0], [9.0, 10.0, 11.0]]


def test_embedding_bag_rejects_bad_shapes():
    with pytest.raises(ValueError):
        embedding_bag(torch.zeros(4), torch.zeros(2, 2, dtype=torch.int32))
    with pytest.raises(ValueError):
        embedding_bag(torch.zeros(4, 2), torch.zeros(2, dtype=torch.int32))


# --------------------------------------------------------------------------
# Wrappers on the CPU, and the build/bind layer
# --------------------------------------------------------------------------
def test_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    before = launch_counts()
    u = torch.from_numpy(_u(50, 0.5, 1))
    triangle_count(u)
    masked_matmul_sum(u, u, u)
    bitset_edge_count(torch.zeros(8, 1, dtype=torch.int32), torch.zeros(4, 2, dtype=torch.int32))
    bitset_pair_count(torch.zeros(8, 1, dtype=torch.int32), torch.zeros(8, 1, dtype=torch.int32),
                      torch.zeros(4, 2, dtype=torch.int32))
    flash_attention(torch.zeros(1, 2, 3, 4), torch.zeros(1, 1, 3, 4), torch.zeros(1, 1, 3, 4))
    embedding_bag(torch.zeros(5, 2), torch.zeros(3, 2, dtype=torch.int32))
    assert launch_counts() == before


def test_kernel_sources_are_found():
    assert set(_build.sources()) == {"triangle_count_sm90", "bitset_count",
                                     "flash_attention", "flash_attention_sm90",
                                     "flash_attention_tf32x3_sm90", "embedding_bag"}
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
    k = _build.CudaKernel("triangle_count_sm90", "tc_live_wgmma", [ctypes.c_void_p],
                          "tc_wgmma_error_string")
    k._fn = lambda *args: 700
    k._err = lambda rc: b"an illegal memory access was encountered"
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        k(0, stream=0)
    assert k.launches == 0
    k._fn = lambda *args: 0
    k(0, stream=0)
    assert k.launches == 1


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    """Every wrapper refuses another device type, but K2, the custom op
    ``repro_torch::masked_matmul_sum``, which takes meta tensors for a dry
    run's shapes (its fake: an int64 scalar, nothing launched) and refuses
    operands on two devices."""
    u = torch.zeros(4, 4, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        triangle_count(u)
    before = launch_counts()
    got = masked_matmul_sum(u, u, u)
    assert (got.device.type, got.dtype, got.shape) == ("meta", torch.int64, ())
    assert launch_counts() == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        masked_matmul_sum(torch.zeros(4, 4, dtype=torch.uint8), u, u)
    with pytest.raises(ValueError):
        bitset_edge_count(torch.zeros(4, 1, dtype=torch.int32, device="meta"),
                          torch.zeros(2, 2, dtype=torch.int32, device="meta"))
    m = torch.zeros(4, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        bitset_pair_count(m, m, torch.zeros(2, 2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):  # tables and edges on different devices
        bitset_pair_count(torch.zeros(4, 1, dtype=torch.int32), m,
                          torch.zeros(2, 2, dtype=torch.int32))
    q = torch.zeros(1, 2, 3, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CPU or CUDA"):  # q on the CPU, k and v not
        flash_attention(torch.zeros(1, 2, 3, 4), q, q)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        embedding_bag(torch.zeros(4, 2, device="meta"),
                      torch.zeros(2, 2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        embedding_bag(torch.zeros(4, 2), torch.zeros(2, 2, dtype=torch.int32, device="meta"))
