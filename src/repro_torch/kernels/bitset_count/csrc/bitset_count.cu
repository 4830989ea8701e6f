// Bitset edge closure for Hopper (sm_90a):
//   Σ_e popcount(masks[u_e] & masks[v_e]) over a (B, 2) edge block.
//
// Replaces the Pallas kernel `bitset_edge_count_kernel` of
// src/repro/kernels/bitset_count/bitset_count.py.
//
// What bounds it on this card: bytes. Every edge gathers two W-word rows of
// the mask table (2·W·4 bytes) for W AND + popcount operations, far below
// the card's ratio of operations to bytes. The table is read at random rows,
// so what helps is that it stays resident in the 50 MB L2 across edges.
//
// Design against the TPU kernel: the Pallas kernel holds the whole table in
// VMEM and walks 128-edge tiles in order, with the endpoints in SMEM. Here
// the table stays in device memory (and L2), and a group of G lanes closes
// one edge, G = the power of two >= W capped at 32, so short rows do not
// idle most of a warp. Blocks stride over the edges, every lane keeps an
// int64 partial, the block reduces its lanes and adds once to the output.
// Ids >= n_pad are phantom edges and count 0; the v gather index is
// clamped to n_pad - 1 as the reference does, so any B is taken unpadded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;

__global__ void __launch_bounds__(THREADS)
edge_count_kernel(const uint32_t* masks, long long n_pad, long long w,
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
    const uint32_t* ru = masks + uc * w;
    const uint32_t* rv = masks + vc * w;
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

}  // namespace

extern "C" {

// out[0] += Σ_e popcount(masks[u_e] & masks[v_e]); masks is n_pad x w
// 32-bit words, edges is n_edges x 2 int32, both contiguous; out is one
// int64 zeroed by the caller.
int bs_edge_count(const void* masks, long long n_pad, long long w,
                  const void* edges, long long n_edges, void* out,
                  void* stream) {
  int group_log2 = 0;
  while ((1LL << group_log2) < w && group_log2 < 5) ++group_log2;
  const long long per_block = THREADS >> group_log2;
  // the SM count of each device, read on its first launch (a ring count
  // launches S² times, so no attribute query per launch)
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
  edge_count_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)masks, n_pad, w, (const int32_t*)edges, n_edges,
      group_log2, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

const char* bs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
