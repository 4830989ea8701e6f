// Causal (or full) GQA flash attention in f32 on Hopper's TF32 tensor cores
// (sm_90a), forward only, as three-pass TF32:
//   out[b, h, i] = Σ_j softmax_j(q[b,h,i]·k[b,h/g,j] · D^-½ | j ≤ i) v[b,h/g,j]
// f32 q, k, v and out, f32 logits and softmax state, at (D, Dv) — the head
// dims of q and k, and of v and out — in {(64, 64), (128, 128), (192, 128)}.
// (192, 128) is MLA's (DeepSeek-V2: nope 128 + rope 64, v 128); its scale
// D^-½ is MLA's (nope + rope)^-½.
//
// Replaces the Pallas kernel `flash_attention_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py (line 62, its
// `pallas_call` at line 82) for f32 inputs at those head dims; bf16 there
// goes to flash_attention_sm90.cu, every other head dim to the FMA kernel of
// flash_attention.cu. The reference pads MLA's v to D; this kernel takes Dv
// apart, so P·V does no work on zero columns.
//
// What bounds it on this card: operations. A causal pass does
// 2·B·Hq·(D + Dv)·S(S+1)/2 FLOPs against (|q| + |k| + |v| + |o|) bytes: at Yi-6B's
// width (Hq 32, Hkv 4, D 128, S 8,192) 5.5e11 FLOPs over 0.34 GB. On the
// f32 FMA pipes (66.9 TFLOP/s) that is 8.2 ms at best. One TF32 product
// keeps 11 significant bits of each operand and misses the reference kernel
// test's 2e-5; three keep about 21: x = hi + lo, where hi is x with its 13
// low mantissa bits dropped (what a TF32 `wgmma` reads from an f32 word: it
// ignores them, so a raw f32 tile is its own hi, truncated toward zero) and
// lo = x - hi exactly, and a·b ≈ hi_a·hi_b + hi_a·lo_b + lo_a·hi_b. The
// dropped lo_a·lo_b is below 2^-20 |a·b|, and lo's own truncation leaves at
// most 2^-21 |x|. Three passes at the TF32 rate (494.7 TFLOP/s) bound it at
// 3.33 ms there, 2.5x below what the FMA pipes could ever reach.
//
// Design. Two kernels, launched together by fa_forward_tf32x3:
// - prep: writes K_lo (B, Hkv, S, D), and Vᵀ and Vᵀ_lo (B, Hkv, Dv, S8),
//   S8 = S rounded up to 8, keys ≥ S zero. A TF32 `wgmma` reads shared
//   memory only K-major, so P·V needs V with keys contiguous. Each 8-key
//   group of Vᵀ is written in key_order (ops.pv_key_order): the
//   Q·Kᵀ accumulator gives a thread keys {2t, 2t+1} of each group of 8, the
//   TF32 register A fragment wants positions {t, t+4}, so position p holds
//   key key_order(p) and the softmax's registers are handed over unchanged.
// - attention: one CTA of three warpgroups (384 threads) owns 128 query
//   rows of one (b, q head); grid (ceil(S/128), Hq, B), the last (longest
//   causal) tiles first. Warpgroup 0 is the producer (setmaxnreg 24; one
//   thread issues every TMA load): Q (128 x D) once, and per 32-key tile
//   K and K_lo through a ring of K_STAGES stages and Vᵀ and Vᵀ_lo through
//   a ring of V_STAGES, each stage with a full and an empty `mbarrier`: a
//   K stage is handed back once Q·Kᵀ has read it, before the tile's
//   softmax and P·V, so the next K tiles load under them. Every tile is
//   stored as
//   128-byte panels of 32 f32 columns with the 128-byte swizzle that the
//   `wgmma` descriptors name. The tensor maps are 4-D over (D, S, H, B)
//   built from the wrapper's element strides, so q's and k's head views
//   are read in place; TMA fills rows past S with zeros. GQA is the index
//   map: kv head = h / (Hq / Hkv). Causal tiles above the diagonal are
//   never loaded.
// - Warpgroups 1 and 2 are the consumers, 64 query rows each (setmaxnreg
//   240). Each keeps its Q_lo fragment in registers (read once from device
//   memory). Per tile: S = Q·Kᵀ as D/8 steps of three `wgmma` m64n32k8
//   (Q·K and Q·K_lo from shared memory, Q_lo·K with Q_lo the register A
//   operand); the online softmax on the f32 accumulator (row max over the
//   quad, columns ≥ S and causal columns > row set to -1e30, exp2 with the
//   scale folded in); P split into hi and lo in registers; O += P·V as 4
//   steps of three `wgmma` m64n{Dv}k8 (P·Vᵀ, P_lo·Vᵀ, P·Vᵀ_lo). O stays in
//   f32 registers, rescaled by α each tile; each consumer thread arrives
//   on a stage's empty barrier once the products that read it have
//   completed.
// - Epilogue: O / max(l, 1e-30) stored as f32 through the output's
//   strides; rows ≥ S are not stored.
// Budget (227 KB = 232,448 bytes of shared memory a CTA, 240 registers a
// consumer thread):
// - (128, 128): Q 64 KB + 2 K stages x (K 16 + K_lo 16 KB) + 2 V stages x
//   (Vᵀ 16 + Vᵀ_lo 16 KB) = 192 KB; a consumer thread holds O (64
//   registers), S (16), Q_lo (64) and P's hi and lo fragments (32).
// - (64, 64): four stages of each ring fit (160 KB).
// - (192, 128): Q 96 KB; a K stage is 48 KB and a V stage 32 KB, so two of
//   each (96 + 160 = 256 KB) do not fit. Two K stages and one V stage do:
//   96 + 96 + 32 = 224 KB (229,376 bytes, + 56 of barriers + 1,024 of
//   alignment = 230,456). The one V stage still overlaps: Vᵀ of tile t
//   loads while Q·Kᵀ and the softmax of tile t run, K of tile t + 1 while
//   all of tile t runs. A consumer thread holds Q_lo (96), O (64), S (16)
//   and P (32): 208 registers. The rejected layouts: 64 query rows a CTA
//   with one consumer warpgroup (48 + 2 x 80 = 208 KB) leaves no second
//   warpgroup to fill the tensor cores while one runs its softmax; one stage
//   of both rings at 128 rows (176 KB) overlaps no load with a product.
// `-Xptxas -v` (nvcc 12.9, sm_90a): 168 registers and no spills at each of
// the three (D, Dv); the prep kernel 36.
// The consumers do not ping-pong and softmax does not overlap the next
// product: later work, as for bf16 (ROADMAP.md).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // query rows per CTA
constexpr int BN = 32;           // keys per K/V tile: one 128-byte panel of Vᵀ
constexpr int PANEL = 32;        // f32 columns of one 128-byte swizzled panel
constexpr int THREADS = 384;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t TF32_MASK = 0xFFFFE000u;  // the bits a TF32 `wgmma` reads
// error codes of this file, past CUDA's own
constexpr int ERR_NO_ENCODER = 10001;
constexpr int ERR_ENCODE = 10002;

struct Params {
  const float* q;
  float* out;
  int s_len, n_q_tiles, group, causal;
  float scale_log2;  // D^-½ · log2(e)
  long long qb, qh, qs, ob, oh, os;
};

// Position p of each 8-key group of P·V's contraction holds this key: the
// TF32 A fragment's register p / 4 of thread p % 4 (ops.pv_key_order)
__device__ __forceinline__ int key_order(int p) { return 2 * (p % 4) + p / 4; }

__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & TF32_MASK);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// One TMA box of a 4-D map into shared memory; completion is counted in
// bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ACC8(d, i)                                                                      \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (64 x 32, f32) (+)= A (64 x 8) · B (8 x 32), TF32: A and B from shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32, f32) += A (64 x 8, TF32 registers) · B (8 x 32), B K-major.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 8, TF32 registers) · B (8 x 128), B K-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40),
        ACC8(d, 48), ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 8, TF32 registers) · B (8 x 64), B K-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8

template <int D, int DV>
struct Layout {
  static constexpr int K_STAGES = D == 64 ? 4 : 2;                // K, K_lo
  static constexpr int V_STAGES = D == 64 ? 4 : D == 128 ? 2 : 1;  // Vᵀ, Vᵀ_lo
  static constexpr uint32_t Q_PANEL = BM * 128;  // bytes of a Q panel (128 rows)
  static constexpr uint32_t K_PANEL = BN * 128;  // bytes of a K panel (32 keys)
  static constexpr uint32_t Q_BYTES = BM * D * 4;
  static constexpr uint32_t KT = BN * D * 4;     // K or K_lo tile: D/32 panels
  static constexpr uint32_t VT = DV * BN * 4;    // Vᵀ or Vᵀ_lo tile: one Dv-row panel
  static constexpr uint32_t K_RING = K_STAGES * 2 * KT, V_RING = V_STAGES * 2 * VT;
  static constexpr int BARS = 1 + 2 * K_STAGES + 2 * V_STAGES;  // Q; full, empty a stage
  // Q, the K ring, the V ring, the mbarriers; 1 KB of slack to align the
  // base to the 128-byte swizzle's 1,024-byte period
  static constexpr int SMEM = Q_BYTES + K_RING + V_RING + 8 * BARS + 1024;
  static_assert(SMEM <= 232448, "past the 227 KB a CTA may have");
};

// K_lo = K - tf32(K); Vᵀ and Vᵀ_lo as (B, Hkv, Dv, S8), each 8-key group in
// key_order, keys ≥ S zero. Block (key group, b·Hkv + h), a thread a column
// of K (D >= Dv threads; those below Dv also take a column of V).
__global__ void fa_tf32x3_prep(const float* __restrict__ k, const float* __restrict__ v,
                               float* __restrict__ k_lo, float* __restrict__ vt,
                               float* __restrict__ vt_lo, int s_len, int s8, int d, int dv,
                               int hkv, long long kb, long long kh, long long ks, long long vb,
                               long long vh, long long vs) {
  const int g = blockIdx.x, bh = blockIdx.y, c = threadIdx.x;
  const int b = bh / hkv, h = bh % hkv;
  const float* kp = k + b * kb + h * kh + c;
  const float* vp = v + b * vb + h * vh + c;
  float* klo = k_lo + static_cast<long long>(bh) * s_len * d + c;
  const bool in_v = c < dv;
  float hi[8], lo[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int key = 8 * g + key_order(p);
    const float x = in_v && key < s_len ? vp[key * vs] : 0.f;
    hi[p] = tf32_hi(x);
    lo[p] = x - hi[p];
    const int row = 8 * g + p;
    if (row < s_len) {
      const float y = kp[row * ks];
      klo[static_cast<long long>(row) * d] = y - tf32_hi(y);
    }
  }
  if (!in_v) return;
  const long long at = (static_cast<long long>(bh) * dv + c) * s8 + 8 * g;
  float4* th = reinterpret_cast<float4*>(vt + at);
  float4* tl = reinterpret_cast<float4*>(vt_lo + at);
  th[0] = make_float4(hi[0], hi[1], hi[2], hi[3]);
  th[1] = make_float4(hi[4], hi[5], hi[6], hi[7]);
  tl[0] = make_float4(lo[0], lo[1], lo[2], lo[3]);
  tl[1] = make_float4(lo[4], lo[5], lo[6], lo[7]);
}

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
fa_tf32x3_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tklo,
                 const __grid_constant__ CUtensorMap tvt,
                 const __grid_constant__ CUtensorMap tvtlo, const Params p) {
  using L = Layout<D, DV>;
  constexpr int KS = L::K_STAGES, VS = L::V_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // K stage s: K, K_lo from k_ring + 2s·KT; V stage s: Vᵀ, Vᵀ_lo from
  // v_ring + 2s·VT
  const uint32_t q_s = base, k_ring = base + L::Q_BYTES, v_ring = k_ring + L::K_RING;
  const uint32_t bars = v_ring + L::V_RING;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8, k_empty = k_full + 8 * KS;
  const uint32_t v_full = k_empty + 8 * KS, v_empty = v_full + 8 * VS;

  const int q_tile = p.n_q_tiles - 1 - static_cast<int>(blockIdx.x);  // longest rows first
  const int q0 = q_tile * BM;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.group;
  const int n_kv_all = (p.s_len + BN - 1) / BN;
  const int n_kv = p.causal ? min(n_kv_all, (q0 + BM) / BN) : n_kv_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < KS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2 * 128);  // every consumer thread
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / PANEL; ++c)
        tma_load(q_s + c * L::Q_PANEL, &tq, q_full, c * PANEL, q0, h, b);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % KS;
        if (t >= KS) mbar_wait(k_empty + 8 * s, ((t / KS) - 1) & 1);
        const uint32_t ks = k_ring + s * 2 * L::KT;
        mbar_expect_tx(k_full + 8 * s, 2 * L::KT);
#pragma unroll
        for (int c = 0; c < D / PANEL; ++c) {
          tma_load(ks + c * L::K_PANEL, &tk, k_full + 8 * s, c * PANEL, t * BN, kvh, b);
          tma_load(ks + L::KT + c * L::K_PANEL, &tklo, k_full + 8 * s, c * PANEL, t * BN, kvh,
                   b);
        }
        const int u = t % VS;
        if (t >= VS) mbar_wait(v_empty + 8 * u, ((t / VS) - 1) & 1);
        const uint32_t vs = v_ring + u * 2 * L::VT;
        mbar_expect_tx(v_full + 8 * u, 2 * L::VT);
        tma_load(vs, &tvt, v_full + 8 * u, t * BN, 0, kvh, b);
        tma_load(vs + L::VT, &tvtlo, v_full + 8 * u, t * BN, 0, kvh, b);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;  // rows 64·cw .. 64·cw + 63 of the tile
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row_a = q0 + 64 * cw + 16 * warp + lane / 4, row_b = row_a + 8;
    const int col_off = 2 * (lane % 4);
    // Q's 64 rows of this warpgroup: 64 rows x 128 bytes into each panel
    const uint64_t q_desc = smem_desc(q_s + 64 * cw * 128, 16, 1024);

    // Q_lo as this thread's TF32 A fragments, step kk: (row a, column
    // 8kk + t), (b, 8kk + t), (a, 8kk + t + 4), (b, 8kk + t + 4)
    uint32_t qlo[D / 8][4];
    {
      const float* qp = p.q + b * p.qb + h * p.qh;
      const bool in_a = row_a < p.s_len, in_b = row_b < p.s_len;
      const float* qa = qp + static_cast<long long>(in_a ? row_a : 0) * p.qs + lane % 4;
      const float* qb = qp + static_cast<long long>(in_b ? row_b : 0) * p.qs + lane % 4;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const float x[4] = {in_a ? qa[8 * kk] : 0.f, in_b ? qb[8 * kk] : 0.f,
                            in_a ? qa[8 * kk + 4] : 0.f, in_b ? qb[8 * kk + 4] : 0.f};
#pragma unroll
        for (int r = 0; r < 4; ++r) qlo[kk][r] = __float_as_uint(x[r] - tf32_hi(x[r]));
      }
    }

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;  // l: this lane's share

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_kv; ++t) {
      const int s = t % KS, u = t % VS;
      const uint32_t ks = k_ring + s * 2 * L::KT, vs = v_ring + u * 2 * L::VT;
      const uint64_t k_desc = smem_desc(ks, 16, 1024), klo_desc = smem_desc(ks + L::KT, 16, 1024);
      const uint64_t vt_desc = smem_desc(vs, 16, 1024), vtlo_desc = smem_desc(vs + L::VT, 16, 1024);

      // S = Q·Kᵀ + Q·K_loᵀ + Q_lo·Kᵀ: D/8 steps of 8 columns, 32 bytes apart
      // in a panel row
      float sc[16];
      mbar_wait(k_full + 8 * s, (t / KS) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint32_t qo = ((kk / 4) * L::Q_PANEL + (kk % 4) * 32) >> 4;
        const uint32_t ko = ((kk / 4) * L::K_PANEL + (kk % 4) * 32) >> 4;
        wgmma_ss_n32(sc, q_desc + qo, k_desc + ko, kk > 0);
        wgmma_ss_n32(sc, q_desc + qo, klo_desc + ko, 1);
        wgmma_rs_n32(sc, qlo[kk], k_desc + ko);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      mbar_arrive(k_empty + 8 * s);  // Q·Kᵀ has read this K stage

      // scale into log2 units; mask columns ≥ S and (causal) columns > row.
      // sc[4j + e]: row (e < 2 ? row_a : row_b), column 8j + col_off + (e & 1)
      const int k0 = t * BN;
      const bool mask = k0 + BN > p.s_len || (p.causal && k0 + BN - 1 > q0 + 64 * cw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * p.scale_log2;
          if (mask) {
            const int col = k0 + 8 * j + col_off + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            if (col >= p.s_len || (p.causal && col > row)) x = NEG_INF;
          }
          sc[4 * j + e] = x;
        }
      }
      // online softmax: a row's 32 columns lie in the 4 lanes of a quad
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float alpha_a = exp2f(m_a - mx_a), alpha_b = exp2f(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      // P's hi and lo as TF32 A fragments, one per 8-key step j: registers
      // (row a, key 2t), (b, 2t), (a, 2t + 1), (b, 2t + 1) sit at positions
      // t, t (row b), t + 4, t + 4 (row b): Vᵀ's keys are in that order
      uint32_t ph[4][4], pl[4][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) pr[e] = exp2f(sc[4 * j + e] - (e < 2 ? m_a : m_b));
        sum_a += pr[0] + pr[1];
        sum_b += pr[2] + pr[3];
        const float x[4] = {pr[0], pr[2], pr[1], pr[3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float hi = tf32_hi(x[r]);
          ph[j][r] = __float_as_uint(hi);
          pl[j][r] = __float_as_uint(x[r] - hi);
        }
      }
      l_a = alpha_a * l_a + sum_a;
      l_b = alpha_b * l_b + sum_b;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        o[4 * j] *= alpha_a;
        o[4 * j + 1] *= alpha_a;
        o[4 * j + 2] *= alpha_b;
        o[4 * j + 3] *= alpha_b;
      }

      // O += P·Vᵀ + P_lo·Vᵀ + P·Vᵀ_lo: 4 steps of 8 keys, 32 bytes apart in
      // each Dv-row of the panel
      mbar_wait(v_full + 8 * u, (t / VS) & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t vo = (j * 32) >> 4;
        if constexpr (DV == 128) {
          wgmma_rs_n128(o, ph[j], vt_desc + vo);
          wgmma_rs_n128(o, pl[j], vt_desc + vo);
          wgmma_rs_n128(o, ph[j], vtlo_desc + vo);
        } else {
          wgmma_rs_n64(o, ph[j], vt_desc + vo);
          wgmma_rs_n64(o, pl[j], vt_desc + vo);
          wgmma_rs_n64(o, ph[j], vtlo_desc + vo);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(v_empty + 8 * u);
    }

    // epilogue: the quad's shares of l, then O / l as f32 pairs
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    float* op = p.out + b * p.ob + h * p.oh;
    if (row_a < p.s_len) {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<float2*>(op + row_a * p.os + 8 * j + col_off) =
            make_float2(o[4 * j] / den_a, o[4 * j + 1] / den_a);
    }
    if (row_b < p.s_len) {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<float2*>(op + row_b * p.os + 8 * j + col_off) =
            make_float2(o[4 * j + 2] / den_b, o[4 * j + 3] / den_b);
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

// A 4-D map of f32 over (inner, rows, heads, batch) with element strides
// (rs, hs, bs) of the last three, boxes of 32 columns (128 bytes) x
// `box_rows` rows of one head, 128-byte swizzle; elements past the dims
// read as zeros.
int make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int inner, int rows,
             int heads, int batch, long long rs, long long hs, long long bs, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)rs * 4, (cuuint64_t)hs * 4, (cuuint64_t)bs * 4};
  const cuuint32_t box[4] = {PANEL, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <int D, int DV>
int launch(const CUtensorMap (&maps)[5], const Params& p, int hq, int batch,
           cudaStream_t stream) {
  const int bytes = Layout<D, DV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(fa_tf32x3_kernel<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.n_q_tiles, hq, batch);
  fa_tf32x3_kernel<D, DV><<<grid, THREADS, bytes, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                        maps[4], p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = attention(q, k, v) in f32; q: (B, Hq, S, D), k: (B, Hkv, S, D), v:
// (B, Hkv, S, Dv), out: (B, Hq, S, Dv), each addressed through element
// strides over (b, h, s) with a contiguous last dimension. q and k need
// 16-byte aligned bases and strides that are multiples of 4 elements (TMA's
// rule); v is read by the prep kernel through any strides. Scratch, written
// here: k_lo (B, Hkv, S, D) contiguous, and vt, vt_lo (B, Hkv, Dv, S8)
// contiguous, S8 = S rounded up to 8. (D, Dv) ∈ {(64, 64), (128, 128),
// (192, 128)}, Hq % Hkv == 0, S >= 1.
int fa_forward_tf32x3(const void* q, const void* k, const void* v, void* out, void* k_lo,
                      void* vt, void* vt_lo, int batch, int hq, int hkv, int s_len, int d,
                      int dv, long long qb, long long qh, long long qs, long long kb, long long kh,
                      long long ks, long long vb, long long vh, long long vs, long long ob,
                      long long oh, long long os, int causal, float scale, void* stream) {
  const bool dims = (d == 64 && dv == 64) || (d == 128 && dv == 128) || (d == 192 && dv == 128);
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || s_len <= 0 || !dims)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  const int s8 = (s_len + 7) & ~7;
  const long long kl = (long long)s_len * d, vl = (long long)dv * s8;
  CUtensorMap maps[5];
  int rc = make_map(enc, &maps[0], q, d, s_len, hq, batch, qs, qh, qb, BM);
  if (rc == 0) rc = make_map(enc, &maps[1], k, d, s_len, hkv, batch, ks, kh, kb, BN);
  if (rc == 0) rc = make_map(enc, &maps[2], k_lo, d, s_len, hkv, batch, d, kl, hkv * kl, BN);
  if (rc == 0) rc = make_map(enc, &maps[3], vt, s8, dv, hkv, batch, s8, vl, hkv * vl, dv);
  if (rc == 0) rc = make_map(enc, &maps[4], vt_lo, s8, dv, hkv, batch, s8, vl, hkv * vl, dv);
  if (rc != 0) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  fa_tf32x3_prep<<<dim3(s8 / 8, batch * hkv), d, 0, st>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(k_lo),
      static_cast<float*>(vt), static_cast<float*>(vt_lo), s_len, s8, d, dv, hkv, kb, kh, ks,
      vb, vh, vs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Params p{static_cast<const float*>(q), static_cast<float*>(out), s_len,
                 (s_len + BM - 1) / BM, hq / hkv, causal, scale * LOG2E, qb, qh, qs, ob, oh,
                 os};
  if (d == 192) return launch<192, 128>(maps, p, hq, batch, st);
  return d == 128 ? launch<128, 128>(maps, p, hq, batch, st)
                  : launch<64, 64>(maps, p, hq, batch, st);
}

const char* fa_tf32x3_error_string(int err) {
  if (err == ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (err == ERR_ENCODE)
    return "cuTensorMapEncodeTiled refused the tensor map (alignment or strides)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
