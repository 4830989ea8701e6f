// Sum-mode EmbeddingBag for Hopper (sm_90a):
//   out[n, :] = Σ_l table[ids[n, l], :]   over the ids in [0, V)
// with the sum in f32 and the result cast to the table's dtype. An id >= V
// (the reference's padding sentinel) or < 0 contributes nothing.
//
// Replaces the Pallas kernel `embedding_bag_kernel` of
// src/repro/kernels/embedding_bag/embedding_bag.py: the multi-hot lookup of
// the recsys embedding layer (`lookup_multihot(use_kernel=True)`).
//
// What bounds it on this card: bytes. Each real id gathers one D-wide row
// (64 bytes at AutoInt's D = 16 in f32) for D adds; the rows lie at random
// in a table far larger than L2 (250 MB at AutoInt's 3.9M rows), so the
// gathers run at the memory's rate for short, scattered reads.
//
// Design against the TPU kernel: the Pallas grid walks (bag, id) in order
// and DMAs one scalar-prefetched row per step into VMEM, accumulating into
// the bag's output block. Here a group of G lanes owns one bag: each lane
// owns 16-byte chunks of the row (4 f32 or 8 bf16 values; 1 value when D
// does not divide into chunks) and walks the bag's L ids, adding its chunk
// of every real row in f32 registers. G = the power of two >= the chunks
// of a row, capped at 32, so at D = 16 a warp sums 8 bags at once and no
// lane idles. No atomics: every output element has one owner, which casts
// and stores it once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC elements of T per chunk: 16 bytes (one uint4) when VEC * sizeof(T) == 16.
template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Chunk {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Chunk<T, VEC> load_chunk(const T* p) {
  Chunk<T, VEC> c;
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(c.v) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) c.v[i] = p[i];
  }
  return c;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
bag_kernel(const T* __restrict__ table, long long vocab, int d,
           const int32_t* __restrict__ ids, long long n_bags, int n_ids,
           T* __restrict__ out, int lanes_log2) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long bag = t >> lanes_log2;
  const int lane = (int)(t & ((1 << lanes_log2) - 1));
  if (bag >= n_bags) return;
  const int32_t* bag_ids = ids + bag * n_ids;
  const int chunks = d / VEC;
  for (int ch = lane; ch < chunks; ch += 1 << lanes_log2) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int j = 0; j < n_ids; ++j) {
      const long long id = bag_ids[j];
      if (id < 0 || id >= vocab) continue;  // padding
      const Chunk<T, VEC> c = load_chunk<T, VEC>(table + id * d + ch * VEC);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += to_f32(c.v[i]);
    }
    Chunk<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(acc[i]);
    T* dst = out + bag * d + ch * VEC;
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o.v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[i] = o.v[i];
    }
  }
}

template <typename T, int VEC>
int launch_vec(const void* table, long long vocab, int d, const void* ids,
               long long n_bags, int n_ids, void* out, cudaStream_t stream) {
  const int chunks = d / VEC;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < chunks && lanes_log2 < 5) ++lanes_log2;
  const long long threads = n_bags << lanes_log2;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bag_kernel<T, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const T*)table, vocab, d, (const int32_t*)ids, n_bags, n_ids, (T*)out, lanes_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void* table, long long vocab, int d, const void* ids,
                 long long n_bags, int n_ids, void* out, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  // 16-byte chunks need every row and the bases on a 16-byte boundary
  const bool aligned = d % VEC == 0 && ((uintptr_t)table | (uintptr_t)out) % 16 == 0;
  if (aligned) return launch_vec<T, VEC>(table, vocab, d, ids, n_bags, n_ids, out, stream);
  return launch_vec<T, 1>(table, vocab, d, ids, n_bags, n_ids, out, stream);
}

}  // namespace

extern "C" {

// out (n_bags, d) = sum-mode EmbeddingBag of table (vocab, d) over ids
// (n_bags, n_ids) int32, all contiguous. dtype 0 = float32, 1 = bfloat16
// (table and out).
int eb_forward(const void* table, long long vocab, int d, const void* ids,
               long long n_bags, int n_ids, void* out, int dtype, void* stream) {
  if (vocab < 0 || d <= 0 || n_bags < 0 || n_ids < 0) return (int)cudaErrorInvalidValue;
  if (n_bags == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_dtype<float>(table, vocab, d, ids, n_bags, n_ids, out, st);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(table, vocab, d, ids, n_bags, n_ids, out, st);
  return (int)cudaErrorInvalidValue;
}

const char* eb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
