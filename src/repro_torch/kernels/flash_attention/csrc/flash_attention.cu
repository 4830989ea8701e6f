// Causal (or full) GQA flash attention for Hopper (sm_90a), forward only:
//   out[b, h, i] = Σ_j softmax_j(q[b,h,i]·k[b,h/g,j] · D^-½ | j ≤ i) v[b,h/g,j]
//
// Replaces the Pallas kernel `flash_attention_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py: the decoder LM's
// prefill/forward attention when `use_flash=True`, for f32 inputs and for
// bf16 inputs at head dims other than 64 and 128. bf16 at D = 64 or 128
// goes to the tensor-core kernel of flash_attention_sm90.cu (`wgmma` fed by
// TMA); the wrapper (ops.py) picks the route from (dtype, D) alone.
//
// What bounds it on this card: operations. A causal pass does
// 4·B·Hq·D·S(S+1)/2 FLOPs against (|q| + |k| + |v| + |o|) bytes, hundreds
// of operations per byte at S in the thousands. It runs on the f32 FMA
// pipes (67 TFLOP/s at most), for f32 and bf16 inputs alike: bf16 is
// widened to f32 on load, so both dtypes compute the plain version's f32
// arithmetic.
//
// Design against the TPU kernel: the Pallas grid walks (b, h, q block, kv
// block) in order and keeps the running (m, l, acc) in VMEM scratch across
// the kv axis. Here one CTA owns (b, h, a tile of 64 query rows) and loops
// over the kv tiles itself, keeping (m, l, acc) in registers. 256 threads:
// a half-warp of 16 lanes shares 4 query rows, each lane holding 4 score
// columns of a 64-key tile and D/16 output columns, so row max and row sum
// are half-warp shuffles. Q, the K tile (then the V tile, in the same
// buffer) and the probability tile live in shared memory as f32 with rows
// padded by one word against bank conflicts: (64 + 64)(D + 1)·4 + 64·65·4
// bytes, 82,688 at D = 128 (two CTAs per SM), 148,224 at D = 256 — past the
// 48 KB default, so each launch raises the kernel's dynamic shared memory
// limit. GQA is the index map: query head h reads kv head h / (Hq / Hkv),
// so K and V are never repeated in memory. Causal tiles wholly above the
// diagonal are never loaded; the last, longest query tiles are scheduled
// first. Columns ≥ S and (causal) columns > row are masked with -1e30, so a
// ragged S needs no padding and non-causal attention is taken at any S.
// q, k, v and out are read through (b, h, s) strides with a contiguous last
// dimension, so transposed head views are read in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 256;
constexpr int TX = 16;        // lanes sharing a query row
constexpr int RPT = BQ / (THREADS / TX);  // query rows per lane: 4
constexpr int CPT = BK / TX;  // score columns per lane: 4
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q; const void* k; const void* v; void* out;
  int hq, group, s_len, d, causal;
  float scale;
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__host__ __device__ constexpr int smem_floats(int d) {
  return (BQ + BK) * (d + 1) + BQ * (BK + 1);
}

// Load `rows` rows of a (., d) tile starting at sequence row `row0` into
// shared memory as f32 (row stride d + 1); rows past s_len load as 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long stride,
                                          int row0, int rows, int s_len, int d) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  for (int r = ty; r < rows; r += THREADS / TX) {
    const int row = row0 + r;
    for (int c = tx; c < d; c += TX)
      dst[r * (d + 1) + c] = row < s_len ? to_f32(src[row * stride + c]) : 0.f;
  }
}

template <typename T, int DPT>  // DPT: output columns per lane, ceil(d / 16)
__global__ void __launch_bounds__(THREADS)
flash_kernel(Args a) {
  extern __shared__ float smem[];
  const int d = a.d, ld = d + 1;
  float* qs = smem;                 // BQ x ld
  float* kvs = qs + BQ * ld;        // BK x ld: the K tile, then the V tile
  float* ps = kvs + BK * ld;        // BQ x (BK + 1) probabilities
  const int n_q = (a.s_len + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * BQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.group;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const T* qp = (const T*)a.q + b * a.qb + h * a.qh;
  const T* kp = (const T*)a.k + b * a.kb + kvh * a.kh;
  const T* vp = (const T*)a.v + b * a.vb + kvh * a.vh;

  load_tile(qs, qp, a.qs, q0, BQ, a.s_len, d);

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }
  const int kv_end = a.causal ? min(a.s_len, q0 + BQ) : a.s_len;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the last tile's V reads are done (and Q is stored)
    load_tile(kvs, kp, a.ks, k0, BK, a.s_len, d);
    __syncthreads();
    float sc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty * RPT + i) * ld + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = kvs[(tx + TX * j) * ld + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
    // online softmax over this tile; a row's 16 lanes are one half-warp
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + TX * j;
        float x = sc[i][j] * a.scale;
        if (col >= a.s_len || (a.causal && col > row)) x = NEG_INF;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(ty * RPT + i) * (BK + 1) + tx + TX * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // K reads done, probabilities stored
    load_tile(kvs, vp, a.vs, k0, BK, a.s_len, d);
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty * RPT + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int col = tx + TX * j;
        const float vv = col < d ? kvs[c * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  T* op = (T*)a.out + b * a.ob + h * a.oh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= a.s_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int col = tx + TX * j;
      if (col < d) op[row * a.os + col] = from_f32<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int DPT>
int launch_one(const Args& a, int batch, cudaStream_t stream) {
  const int bytes = smem_floats(a.d) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.s_len + BQ - 1) / BQ, a.hq, batch);
  flash_kernel<T, DPT><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const Args& a, int batch, cudaStream_t stream) {
  const int dpt = (a.d + TX - 1) / TX;
  if (dpt <= 1) return launch_one<T, 1>(a, batch, stream);
  if (dpt <= 2) return launch_one<T, 2>(a, batch, stream);
  if (dpt <= 4) return launch_one<T, 4>(a, batch, stream);
  if (dpt <= 8) return launch_one<T, 8>(a, batch, stream);
  if (dpt <= 12) return launch_one<T, 12>(a, batch, stream);
  if (dpt <= 16) return launch_one<T, 16>(a, batch, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out = attention(q, k, v); q, out: (B, Hq, S, D), k, v: (B, Hkv, S, D),
// each addressed through element strides over (b, h, s) with a contiguous
// last dimension. dtype 0 = float32, 1 = bfloat16 (all four tensors).
// D <= 256, Hq % Hkv == 0, S >= 1.
int fa_forward(const void* q, const void* k, const void* v, void* out,
               int batch, int hq, int hkv, int s_len, int d,
               long long qb, long long qh, long long qs,
               long long kb, long long kh, long long ks,
               long long vb, long long vh, long long vs,
               long long ob, long long oh, long long os,
               int causal, float scale, int dtype, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || s_len <= 0 || d <= 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, hq, hq / hkv, s_len, d, causal, scale,
               qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_dtype<float>(a, batch, st);
  if (dtype == 1) return launch_dtype<__nv_bfloat16>(a, batch, st);
  return (int)cudaErrorInvalidValue;
}

const char* fa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
