// Bitset edge closures for Hopper (sm_90a), over a (B, 2) edge block:
//   bs_edge_count      Σ_e popcount(masks[u_e] & masks[v_e])   (one table)
//   bs_pair_count      Σ_e popcount(a[u_e] & b[v_e])           (two tables)
//   bs_per_edge_count  the one-table sum, one CTA per edge
//
// Replace the Pallas kernels `bitset_edge_count_kernel`,
// `bitset_pair_count_kernel` and `bitset_edge_count_per_edge_kernel` of
// src/repro/kernels/bitset_count/bitset_count.py.
// The one-table closure closes the bitset ring's edge blocks and the stream
// ingest's `pre` and `dd` terms; the two-table closure is the ingest's
// `mixed` term, u rows from the pre-block adjacency and v rows from the
// block's delta (or the other way round).
//
// What bounds them on this card: bytes. Every edge gathers two W-word rows
// (2·W·4 bytes) for W AND + popcount operations, far below the card's ratio
// of operations to bytes. The rows are read at random, so what helps is
// that a table small enough stays resident in the 50 MB L2 across edges.
//
// Design against the TPU kernels: the Pallas kernels hold the whole table
// (or both tables) in VMEM and walk 128-edge tiles in order, with the
// endpoints in SMEM. Here the tables stay in device memory (and L2), and a
// group of G lanes closes one edge, G = the power of two >= W capped at 32,
// so short rows do not idle most of a warp. Blocks stride over the edges,
// every lane keeps an int64 partial, the block reduces its lanes and adds
// once to the output. Both entry points run the one kernel below: the
// one-table closure passes its table twice. Ids >= n_pad are phantom edges
// and count 0; the v gather index is clamped to n_pad - 1 as the reference
// does, so any B is taken unpadded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;

__global__ void __launch_bounds__(THREADS)
pair_count_kernel(const uint32_t* ta, const uint32_t* tb, long long n_pad, long long w,
                  const int32_t* edges, long long n_edges, int group_log2,
                  unsigned long long* out) {
  __shared__ unsigned long long warp_sums[THREADS / 32];
  const int group = 1 << group_log2;
  const int sub = threadIdx.x & (group - 1);
  const long long per_block = THREADS >> group_log2;
  const long long stride = (long long)gridDim.x * per_block;
  unsigned long long acc = 0;
  for (long long e = (long long)blockIdx.x * per_block +
                     (threadIdx.x >> group_log2);
       e < n_edges; e += stride) {
    const long long u = edges[2 * e], v = edges[2 * e + 1];
    if (u >= n_pad) continue;  // phantom edge: contributes 0
    // clamp both gathers into the table, as the plain version does
    const long long uc = u < 0 ? 0 : u;
    const long long vc = v < 0 ? 0 : (v < n_pad ? v : n_pad - 1);
    const uint32_t* ru = ta + uc * w;
    const uint32_t* rv = tb + vc * w;
    for (long long k = sub; k < w; k += group) acc += __popc(ru[k] & rv[k]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) total += warp_sums[i];
    if (total != 0) atomicAdd(out, total);
  }
}

// The seed kernel's shape: one CTA per edge, as the Pallas kernel runs one
// grid step (two (1, W) row copies) per edge. The CTA's threads stride over
// the W words of the edge's two rows, so a row of tens of thousands of
// words (the hybrid stream's full-width pre-block rows) is read by the
// whole CTA, not by one lane group of at most a warp as above. Bytes bound
// it as they bound the kernel above: 2·W·4 bytes per real edge.
__global__ void per_edge_kernel(const uint32_t* masks, long long n_pad, long long w,
                                const int32_t* edges, unsigned long long* out) {
  __shared__ unsigned long long warp_sums[THREADS / 32];
  const long long e = blockIdx.x;
  const long long u = edges[2 * e], v = edges[2 * e + 1];
  if (u >= n_pad) return;  // phantom edge (the whole CTA): contributes 0
  const long long uc = u < 0 ? 0 : u;
  const long long vc = v < 0 ? 0 : (v < n_pad ? v : n_pad - 1);
  const uint32_t* ru = masks + uc * w;
  const uint32_t* rv = masks + vc * w;
  unsigned long long acc = 0;
  for (long long k = threadIdx.x; k < w; k += blockDim.x) acc += __popc(ru[k] & rv[k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += warp_sums[i];
    if (total != 0) atomicAdd(out, total);
  }
}

int launch(const void* ta, const void* tb, long long n_pad, long long w,
           const void* edges, long long n_edges, void* out, void* stream) {
  int group_log2 = 0;
  while ((1LL << group_log2) < w && group_log2 < 5) ++group_log2;
  const long long per_block = THREADS >> group_log2;
  // the SM count of each device, read on its first launch (a ring count
  // launches S² times, a stream four times a block, so no attribute query
  // per launch)
  static int sms_of[MAX_DEVICES] = {0};
  int device = 0;
  cudaGetDevice(&device);
  int sms = device < MAX_DEVICES ? sms_of[device] : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (sms <= 0) sms = 132;
    if (device < MAX_DEVICES) sms_of[device] = sms;
  }
  long long blocks = (n_edges + per_block - 1) / per_block;
  const long long cap = 16LL * sms;
  if (blocks > cap) blocks = cap;
  pair_count_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)ta, (const uint32_t*)tb, n_pad, w, (const int32_t*)edges,
      n_edges, group_log2, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[0] += Σ_e popcount(masks[u_e] & masks[v_e]); masks is n_pad x w
// 32-bit words, edges is n_edges x 2 int32, both contiguous; out is one
// int64 zeroed by the caller.
int bs_edge_count(const void* masks, long long n_pad, long long w,
                  const void* edges, long long n_edges, void* out,
                  void* stream) {
  return launch(masks, masks, n_pad, w, edges, n_edges, out, stream);
}

// out[0] += Σ_e popcount(a[u_e] & b[v_e]); a and b are both n_pad x w
// 32-bit words, otherwise as bs_edge_count.
int bs_pair_count(const void* a, const void* b, long long n_pad, long long w,
                  const void* edges, long long n_edges, void* out,
                  void* stream) {
  return launch(a, b, n_pad, w, edges, n_edges, out, stream);
}

// out[0] += Σ_e popcount(masks[u_e] & masks[v_e]), as bs_edge_count, with
// one CTA per edge: n_edges CTAs of 32 to 256 threads (the power of two
// >= w, so short rows do not idle most of a CTA).
int bs_per_edge_count(const void* masks, long long n_pad, long long w,
                      const void* edges, long long n_edges, void* out,
                      void* stream) {
  int threads = 32;
  while (threads < w && threads < THREADS) threads <<= 1;
  per_edge_kernel<<<(unsigned)n_edges, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)masks, n_pad, w, (const int32_t*)edges,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}

const char* bs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
