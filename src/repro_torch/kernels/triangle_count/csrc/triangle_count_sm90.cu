// Masked matmul-sum and live-grid triangle count on Hopper's int8 tensor
// cores (sm_90a), exact in integers, both on one kernel body:
//   K2: out += Σ (A·B) ⊙ M  for 0/1 uint8 A (R x K), B (K x N), M (R x N),
//       optionally restricted to the live block triples of the
//       upper-triangular skip;
//   K1: out[b] += Σ U_b ⊙ (U_b·U_b)  for a batch of strictly upper
//       triangular 0/1 uint8 U_b (n x n), one launch for the whole batch.
//
// Replaces the Pallas kernels of src/repro/kernels/triangle_count/
// triangle_count.py: `masked_matmul_sum_kernel` (line 79, its `pallas_call`
// at line 99: one dense-ring visit Σ (U_s[:, kR:(k+1)R]·U_k) ⊙ U_s, and the
// full-grid count U·U ⊙ U under the structural skip), and
// `triangle_count_live_kernel` (line 162, its `pallas_call` at line 191: the
// count over the live block triples i <= k <= j).
//
// Reassociation. For .u8/.s8 operands `wgmma.mma_async` reads shared memory
// only K-major (the transpose immediates exist for 16-bit types alone), and
// B (K x N, N contiguous) is MN-major. So the product runs the other way
// round, by the integer identity
//   Σ_ij M_ij Σ_k A_ik B_kj = Σ_ik A_ik (M·Bᵀ)_ik :
// C' = M·Bᵀ (R x K) contracts over N, which is the contiguous dimension of
// both M and B, so TMA loads both as they lie in memory and nothing is
// transposed. A becomes the epilogue's mask, read in place through its row
// stride (in the ring a strided column slice). The operations are the same,
// 2·R·K·N. K1 is K2 with A = B = M = U under the skip:
//   Σ_{i<k} U_ik Σ_j U_ij U_kj,
// one tensor map over U serving as both M and B, and U's own tile the mask.
//
// What bounds it on this card: operations. A ring visit at FNA.5's shape
// (R = K = 2,048, N = 8,192) is 6.9e10 int8 operations on 32 MB, 34.7 µs
// at the 1,979 TOPS of the int8 tensor cores against 10 µs of device-memory
// bytes; K1 at FNA.5's n = 4,472 is 2·C(n, 3) = 3.0e10 operations on 20 MB.
// But a 128 x 128 output tile reads 32 KB from L2 for each 128-byte
// contraction chunk, one byte for every 128 operations: ~0.54 GB at the ring
// shape, which at the several TB/s that L2 delivers takes about as long as
// the tensor-core bound. The design keeps the tensor cores fed from a deep
// TMA ring and leaves the L2 feed as the known limit; halving it (a 2-CTA
// cluster multicasting the shared operand, or a 128 x 256 tile) is later
// work (ROADMAP.md).
//
// Design.
// - A CTA of three warpgroups (384 threads) owns one 128 x 128 output tile
//   of C' (rows rb of M, rows kb of B) of one matrix (blockIdx.y) over one
//   slice of the contraction. Warpgroup 0 is the producer: it gives up its
//   registers (setmaxnreg 24) and one thread issues the TMA loads.
//   Warpgroups 1 and 2 are the consumers, 64 rows of M each:
//   `wgmma.mma_async m64n128k32.s32.u8.u8`, both descriptors K-major with
//   the 128-byte swizzle.
// - A contraction chunk is 128 bytes of N, one swizzled row, so each operand
//   tile is one 128 x 128 B panel (16 KB): 32-byte k steps, 8-row groups
//   1,024 bytes apart. The tensor maps are 3-D UINT8 over (N, rows,
//   matrices) with the row and matrix strides in bytes and 128 x 128 x 1
//   boxes (K2 is a batch of one); TMA fills rows and columns past the edges
//   with zeros, so ragged R, K and N need no padding, and K1 reads an n x n
//   view of a larger buffer in place.
// - Ring: 4 stages x (16 + 16) KB with a full and an empty `mbarrier` each;
//   one `wgmma` group stays in flight while the next chunk is issued.
// - Split contraction. The output is one scalar per matrix and the mask is
//   linear, so each CTA masks its own s32 partial tile (every entry is at
//   most the slice length, so s32 is exact) with A, sums it in int64 and
//   adds one int64 to its matrix's output with a single atomicAdd (skipped
//   when 0). No partial tile is ever written. The host chooses the slice
//   length (ops.py `split_plan`) so that few output tiles still fill the
//   card several times over; the grid's x walks the (live output tile,
//   slice) items, decoded by `work_item` below exactly as ops.py's
//   `work_item` decodes them, and its y the matrices. Output tiles go in
//   groups of 8 row tiles so that CTAs in flight share M and B rows in L2.
// - `upper`: output tile (rb, kb) is live when kb >= rb, and its chunks run
//   over cb >= kb: the live triples rb <= kb <= cb of the reference's block
//   grid at its default block of 128. The items run kb-major, so the
//   longest (kb = 0) are issued first.
// Inline PTX only: no CUTLASS, no cuBLAS.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;                    // output tile edge; chunk bytes
constexpr int TILE_BYTES = TILE * TILE;      // one operand tile, 16 KB
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // M tile + B tile
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr int GROUP = 8;  // row tiles per raster group
// tiles, then a full and an empty mbarrier per stage; 1 KB of slack to align
// the base to the 128-byte swizzle's 1,024-byte period
constexpr int SMEM = STAGES * STAGE_BYTES + 16 * STAGES + 1024;
// error codes of this file, past CUDA's own
constexpr int ERR_NO_ENCODER = 10001;
constexpr int ERR_ENCODE = 10002;

struct Params {
  const uint8_t* a;
  long long lda, a_batch;  // row and matrix strides of A, in bytes
  long long R, K;
  long long nr, nk, nc;  // row tiles of M, row tiles of B, chunks of N
  long long slice;       // chunks per slice
  int upper;
  unsigned long long* out;  // one int64 per matrix
};

struct Item {
  long long rb, kb, c0, c1;
};

// Pairs rb <= kb < x with rb < nr: the live output tiles of `upper` whose
// row tile of B is below x.
__device__ __forceinline__ long long upper_pairs(long long x, long long nr) {
  if (x <= 0) return 0;
  if (x <= nr) return x * (x + 1) / 2;
  return nr * (nr + 1) / 2 + (x - nr) * nr;
}

// Work item i -> output tile (rb, kb) and its chunks [c0, c1). Mirrors
// `work_item` of ops.py line for line.
__device__ Item work_item(long long i, const Params& p) {
  Item w;
  long long j;
  if (!p.upper) {
    // slices outermost; within a slice, groups of GROUP row tiles, each
    // group walked column by column
    const long long tiles = p.nr * p.nk;
    j = i / tiles;
    long long t = i % tiles;
    const long long per_group = GROUP * p.nk;
    const long long rb0 = (t / per_group) * GROUP;
    const long long gm = min((long long)GROUP, p.nr - rb0);
    t %= per_group;
    w.rb = rb0 + t % gm;
    w.kb = t / gm;
    w.c0 = j * p.slice;
  } else {
    // slice j of tile (rb, kb) starts at chunk kb + j·slice; slice j has
    // upper_pairs(min(nk, nc - j·slice)) live tiles, kb-major
    long long x;
    for (j = 0;; ++j) {
      x = min(p.nk, p.nc - j * p.slice);
      const long long cnt = upper_pairs(x, p.nr);
      if (i < cnt) break;
      i -= cnt;
    }
    const long long y = min(x, p.nr);
    const long long tri = y * (y + 1) / 2;
    if (i < tri) {
      long long kb = (long long)((sqrt(8.0 * (double)i + 1.0) - 1.0) / 2.0);
      while ((kb + 1) * (kb + 2) / 2 <= i) ++kb;
      while (kb * (kb + 1) / 2 > i) --kb;
      w.kb = kb;
      w.rb = i - kb * (kb + 1) / 2;
    } else {
      i -= tri;
      w.kb = p.nr + i / p.nr;
      w.rb = i % p.nr;
    }
    w.c0 = w.kb + j * p.slice;
  }
  w.c1 = min(w.c0 + p.slice, p.nc);
  return w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA box (128 bytes of N x 128 rows of matrix `mat`) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int mat) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(mat)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ACC8(d, i)                                                                      \
  "+r"(d[(i) + 0]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3]), "+r"(d[(i) + 4]), \
      "+r"(d[(i) + 5]), "+r"(d[(i) + 6]), "+r"(d[(i) + 7])

// d (64 x 128, s32) += A (64 x 32 bytes) · B (32 bytes x 128), u8 operands,
// both K-major in shared memory.
__device__ __forceinline__ void wgmma_u8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40),
        ACC8(d, 48), ACC8(d, 56)
      : "l"(da), "l"(db), "r"(1));
}

#undef ACC8

__global__ void __launch_bounds__(THREADS, 1)
tc_wgmma_kernel(const __grid_constant__ CUtensorMap tm, const __grid_constant__ CUtensorMap tb,
                const Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ long long warp_sums[8];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // stage s at + s·STAGE_BYTES
  const uint32_t full = base + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;

  const Item w = work_item(blockIdx.x, p);
  const int n = static_cast<int>(w.c1 - w.c0);  // >= 1 for every item
  const int mat = static_cast<int>(blockIdx.y);  // the matrix of the batch

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int m_row = static_cast<int>(w.rb * TILE), b_row = static_cast<int>(w.kb * TILE);
      for (int it = 0; it < n; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
        const uint32_t st = base + s * STAGE_BYTES;
        const int col = static_cast<int>((w.c0 + it) * TILE);
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        tma_load(st, &tm, full + 8 * s, col, m_row, mat);
        tma_load(st + TILE_BYTES, &tb, full + 8 * s, col, b_row, mat);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;  // rows 64·cw .. 64·cw + 63 of the tile
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;

    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;

    for (int it = 0; it < n; ++it) {
      const int s = it % STAGES;
      const uint32_t st = base + s * STAGE_BYTES;
      // this warpgroup's 64 rows of M: 64 rows x 128 bytes into the tile
      const uint64_t m_desc = smem_desc(st + 64 * cw * TILE, 16, 1024);
      const uint64_t b_desc = smem_desc(st + TILE_BYTES, 16, 1024);
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 32; ++kk)  // k32 steps, 32 bytes apart
        wgmma_u8_n128(acc, m_desc + ((kk * 32) >> 4), b_desc + ((kk * 32) >> 4));
      wgmma_commit();
      // one group in flight: the previous chunk's products are done, so its
      // stage goes back to the producer
      wgmma_wait<1>();
      if (it > 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: mask with A and sum. acc[4j + e] is row
    // 16·warp + lane/4 (+8 for e >= 2), column 8j + 2·(lane%4) + (e & 1)
    const long long row = w.rb * TILE + 64 * cw + 16 * warp + lane / 4;
    const long long col = w.kb * TILE + 2 * (lane % 4);
    long long sum = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long r = row + 8 * half;
      if (r < p.R) {
        const uint8_t* ar = p.a + mat * p.a_batch + r * p.lda;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long long c = col + 8 * j + e;
            if (c < p.K) sum += (long long)acc[4 * j + 2 * half + e] * __ldg(ar + c);
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (lane == 0) warp_sums[4 * cw + warp] = sum;
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the two consumer warpgroups
    if (threadIdx.x == 128) {
      long long total = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) total += warp_sums[i];
      if (total != 0) atomicAdd(p.out + mat, (unsigned long long)total);
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime, so the
// library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A 3-D map over (cols, rows, matrices) of uint8 with row stride `ld` and
// matrix stride `mat_stride` bytes, boxes of 128 x 128 x 1 with the 128-byte
// swizzle; elements past the edges read as 0.
int make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, long long cols, long long rows,
             long long ld, long long mats, long long mat_stride) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)ld, (cuuint64_t)mat_stride};
  const cuuint32_t box[3] = {TILE, TILE, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// `items` x `mats` CTAs of tc_wgmma_kernel on `stream`.
int launch(const CUtensorMap& tm, const CUtensorMap& tb, const Params& p, long long items,
           long long mats, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(tc_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)items, (unsigned)mats);
  tc_wgmma_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(tm, tb, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[0] += Σ (A·B) ⊙ M over `items` work items of `slice` chunks each
// (ops.py `split_plan`). A: R x K, row stride lda, unit column stride, any
// alignment. B: K x N and M: R x N, row strides ldb, ldm: 16-byte aligned
// bases and strides (TMA's rule). R, K, N >= 1 and < 2^31; out is int64.
int tc_masked_wgmma(const void* a, long long lda, const void* b, long long ldb, const void* m,
                    long long ldm, long long R, long long K, long long N, int upper,
                    long long slice, long long items, void* out, void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || slice <= 0 || items <= 0 || items > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  // a batch of one: the matrix stride is never stepped over
  CUtensorMap tm, tb;
  int rc = make_map(enc, &tm, m, N, R, ldm, 1, R * ldm);
  if (rc == 0) rc = make_map(enc, &tb, b, N, K, ldb, 1, K * ldb);
  if (rc != 0) return rc;
  const Params p{(const uint8_t*)a, lda, 0, R, K, cdiv(R, TILE), cdiv(K, TILE), cdiv(N, TILE),
                 slice, upper != 0, (unsigned long long*)out};
  return launch(tm, tb, p, items, 1, stream);
}

// out[b] += Σ U_b ⊙ (U_b·U_b) for the `mats` strictly upper triangular
// n x n matrices U_b = u + b·mat_stride (row stride ld, unit column stride),
// over the `items` work items of split_plan(n, n, n, upper, sms), the same
// for every matrix. u, ld and mat_stride keep TMA's 16-byte rule; n >= 1 and
// < 2^31; 1 <= mats <= 65,535 (gridDim.y); out is int64 x mats.
int tc_live_wgmma(const void* u, long long n, long long ld, long long mat_stride,
                  long long mats, long long slice, long long items, void* out, void* stream) {
  if (n <= 0 || mats <= 0 || mats > 65535 || slice <= 0 || items <= 0 ||
      items > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  CUtensorMap tm;
  const int rc = make_map(enc, &tm, u, n, n, ld, mats, mat_stride);
  if (rc != 0) return rc;
  const long long nb = cdiv(n, TILE);
  const Params p{(const uint8_t*)u, ld, mat_stride, n, n, nb, nb, nb, slice, 1,
                 (unsigned long long*)out};
  return launch(tm, tm, p, items, mats, stream);
}

const char* tc_wgmma_error_string(int err) {
  if (err == ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (err == ERR_ENCODE)
    return "cuTensorMapEncodeTiled refused the tensor map (alignment or strides)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
