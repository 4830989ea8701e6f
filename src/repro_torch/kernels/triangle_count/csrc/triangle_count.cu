// Masked matmul-reduce on 0/1 uint8 operands for Hopper (sm_90a):
//   sum((A @ B) ⊙ M), accumulated exactly in integers.
//
// Replaces the Pallas kernels of src/repro/kernels/triangle_count/
// triangle_count.py: `triangle_count_live_kernel` (tc_live below) and
// `masked_matmul_sum_kernel` (tc_masked below).
//
// What bounds it on this card: the live count at n = 8192 is ~9.4e10
// multiply-adds on 64 MB of operands, so it is bound by operations, not
// bytes. This first version runs the products on the integer cores with
// __dp4a (four 8-bit products per instruction) from 64x64 tiles staged in
// shared memory; the tensor cores (mma / wgmma s8) are later work.
//
// Design against the TPU kernel: the Pallas grid walks (i, j, k) in order on
// one core and carries an f32 VMEM accumulator between steps. Here one CTA
// owns one 64x64 output tile (i, j) and loops k inside the block, so no
// state crosses CTAs; each tile's masked sum goes to one int64 output with a
// single atomicAdd. The live grid {i <= k <= j} needs no table: the CTA
// decodes (i, j) from blockIdx.x and bounds its own k loop. Integer
// arithmetic (dp4a into int32, tile sums in int64) keeps every step exact.
// Ragged edges are zero-filled in shared memory, so any shape is taken.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;           // output tile edge and k-chunk
constexpr int THREADS = 256;       // 16 x 16 threads, 4 x 4 outputs each
constexpr int KWORDS = TILE / 4;   // packed 4-byte words per tile row
constexpr int LDW = KWORDS + 1;    // padded smem row: conflict-free reads

// Load the 16 bytes x[row][col .. col+15] of a rows x cols row-major matrix
// (row stride ld), zero outside it. `vec` says 16-byte loads are aligned.
__device__ __forceinline__ void load16(const uint8_t* x, long long ld,
                                       long long rows, long long cols,
                                       long long row, long long col,
                                       bool vec, uint8_t out[16]) {
  if (row < rows && vec && col + 16 <= cols) {
    uint4 v = *reinterpret_cast<const uint4*>(x + row * ld + col);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
    for (int e = 0; e < 16; ++e) out[e] = b[e];
    return;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    long long c = col + e;
    out[e] = (row < rows && c < cols) ? x[row * ld + c] : 0;
  }
}

// Σ over k-chunks [kt_lo, kt_hi] of (A(i,k) @ B(k,j)) ⊙ M(i,j) for one
// 64x64 output tile, added to *out. A is R x K, B is K x N, M is R x N.
__device__ void tile_masked_sum(const uint8_t* a, long long lda,
                                const uint8_t* b, long long ldb,
                                const uint8_t* m, long long ldm,
                                long long R, long long K, long long N,
                                long long ti, long long tj, long long kt_lo,
                                long long kt_hi, bool vec,
                                unsigned long long* out) {
  // as_[r][w] packs A[r][4w .. 4w+3]; bs_[c][w] packs B[4w .. 4w+3][c]
  // (B is transposed while it is staged), so one dp4a is 4 products of k.
  __shared__ uint32_t as_[TILE][LDW];
  __shared__ uint32_t bs_[TILE][LDW];
  __shared__ long long warp_sums[THREADS / 32];

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const long long row0 = ti * TILE, col0 = tj * TILE;
  // staging: each thread moves 16 bytes of each tile
  const int srow = t / 4, sseg = (t % 4) * 16;

  int acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[q][p] = 0;

  for (long long kt = kt_lo; kt <= kt_hi; ++kt) {
    const long long k0 = kt * TILE;
    uint8_t v[16];
    // A(i, k): row srow, bytes sseg .. sseg+15 of the k-chunk
    load16(a, lda, R, K, row0 + srow, k0 + sseg, vec, v);
#pragma unroll
    for (int w = 0; w < 4; ++w)
      as_[srow][sseg / 4 + w] = (uint32_t)v[4 * w] |
                                ((uint32_t)v[4 * w + 1] << 8) |
                                ((uint32_t)v[4 * w + 2] << 16) |
                                ((uint32_t)v[4 * w + 3] << 24);
    // B(k, j): k-row srow, columns sseg .. sseg+15, stored transposed
    load16(b, ldb, K, N, k0 + srow, col0 + sseg, vec, v);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      reinterpret_cast<uint8_t*>(&bs_[sseg + e][srow / 4])[srow % 4] = v[e];
    __syncthreads();

#pragma unroll 4
    for (int w = 0; w < KWORDS; ++w) {
      uint32_t av[4], bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) av[q] = as_[ty + 16 * q][w];
#pragma unroll
      for (int p = 0; p < 4; ++p) bv[p] = bs_[tx + 16 * p][w];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p)
          acc[q][p] = (int)__dp4a(av[q], bv[p], (unsigned int)acc[q][p]);
    }
    __syncthreads();
  }

  // epilogue: mask with M(i, j) and reduce the tile to one int64
  long long sum = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long r = row0 + ty + 16 * q;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const long long c = col0 + tx + 16 * p;
      if (r < R && c < N) sum += (long long)acc[q][p] * m[r * ldm + c];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (t % 32 == 0) warp_sums[t / 32] = sum;
  __syncthreads();
  if (t == 0) {
    long long total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
    if (total != 0) atomicAdd(out, (unsigned long long)total);
  }
}

// One CTA per live output tile (i <= j) of each n x n matrix in the batch.
// blockIdx.x enumerates the pairs j-major: x = j(j+1)/2 + i, 0 <= i <= j.
// U strictly upper triangular makes the k-chunks outside [i, j] all zero.
__global__ void __launch_bounds__(THREADS)
live_kernel(const uint8_t* u, long long n, bool vec, unsigned long long* out) {
  const long long x = blockIdx.x;
  long long j = (long long)((sqrt(8.0 * (double)x + 1.0) - 1.0) / 2.0);
  while ((j + 1) * (j + 2) / 2 <= x) ++j;
  while (j * (j + 1) / 2 > x) --j;
  const long long i = x - j * (j + 1) / 2;
  const uint8_t* ub = u + (long long)blockIdx.z * n * n;
  tile_masked_sum(ub, n, ub, n, ub, n, n, n, n, i, j, i, j, vec,
                  out + blockIdx.z);
}

// Full (R/64) x (N/64) output grid, k over all of K — or over [i, j] with
// tiles j < i skipped under `upper` (the structural skip for U·U⊙U).
__global__ void __launch_bounds__(THREADS)
masked_kernel(const uint8_t* a, long long lda, const uint8_t* b,
              long long ldb, const uint8_t* m, long long ldm, long long R,
              long long K, long long N, bool upper, bool vec,
              unsigned long long* out) {
  const long long tj = blockIdx.x, ti = blockIdx.y;
  const long long nkt = (K + TILE - 1) / TILE;
  long long lo = 0, hi = nkt - 1;
  if (upper) {
    if (tj < ti) return;
    lo = ti;
    hi = tj < hi ? tj : hi;
  }
  tile_masked_sum(a, lda, b, ldb, m, ldm, R, K, N, ti, tj, lo, hi, vec, out);
}

bool aligned16(const void* p) { return ((uintptr_t)p % 16) == 0; }

}  // namespace

extern "C" {

// out[b] += Σ U_b ⊙ (U_b @ U_b) over the live tiles, for b < batch; u is
// batch x n x n contiguous uint8, out is batch int64 (zeroed by the caller).
int tc_live(const void* u, long long n, long long batch, void* out,
            void* stream) {
  const long long nb = (n + TILE - 1) / TILE;
  const bool vec = aligned16(u) && n % 16 == 0;
  dim3 grid((unsigned)(nb * (nb + 1) / 2), 1, (unsigned)batch);
  live_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)u, n, vec, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

// out[0] += Σ (A @ B) ⊙ M; row strides lda/ldb/ldm, unit column stride.
int tc_masked(const void* a, long long lda, const void* b, long long ldb,
              const void* m, long long ldm, long long R, long long K,
              long long N, int upper, void* out, void* stream) {
  const bool vec = aligned16(a) && aligned16(b) && lda % 16 == 0 &&
                   ldb % 16 == 0;
  dim3 grid((unsigned)((N + TILE - 1) / TILE), (unsigned)((R + TILE - 1) / TILE));
  masked_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, lda, (const uint8_t*)b, ldb, (const uint8_t*)m, ldm,
      R, K, N, upper != 0, vec, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

const char* tc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
