// Causal (or full) GQA flash attention in bf16 on Hopper's tensor cores
// (sm_90a), forward only:
//   out[b, h, i] = Σ_j softmax_j(q[b,h,i]·k[b,h/g,j] · D^-½ | j ≤ i) v[b,h/g,j]
// bf16 q, k, v and out, f32 logits and softmax state, at (D, Dv) — the head
// dims of q and k, and of v and out — in {(64, 64), (128, 128), (192, 128)}.
// (192, 128) is MLA's (DeepSeek-V2: nope 128 + rope 64, v 128); its scale
// D^-½ is MLA's (nope + rope)^-½.
//
// Replaces the Pallas kernel `flash_attention_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py (line 62, its
// `pallas_call` at line 82) for bf16 inputs at those head dims; the FMA
// kernel in flash_attention.cu keeps f32 and other head dims. The reference
// pads MLA's v to D; this kernel takes Dv apart, so P·V does no work on
// zero columns.
//
// What bounds it on this card: operations. A causal pass does
// 2·B·Hq·(D + Dv)·S(S+1)/2 FLOPs against (|q| + |k| + |v| + |o|) bytes: at Yi-6B's
// width (Hq 32, Hkv 4, D 128, S 8,192) that is 2.2e12 FLOPs over 0.17 GB,
// ~13,000 operations per byte, far past the ~295 at which the 989.4 TFLOP/s
// of the bf16 tensor cores and not the 3.35 TB/s of memory are the limit.
// So both products run as `wgmma` on bf16 tiles, the only way to the
// tensor cores' full rate, and the loads are TMA copies that cost the
// computing warps no instructions.
//
// Design. One CTA of three warpgroups (384 threads) owns 128 query rows of
// one (b, q head); grid (ceil(S/128), Hq, B), the last (longest causal) tiles
// scheduled first.
// - Warpgroup 0 is the producer: it gives up its registers (setmaxnreg 24)
//   and one thread issues every TMA load. Q (128 x D) is loaded once; K
//   tiles of 128 keys x D and V tiles of 128 keys x Dv go through a 2-stage
//   ring, each stage with its own K-full, V-full and empty `mbarrier`, so
//   Q·Kᵀ of a tile can start before its V lands. Shared memory: Q + 2 x (K +
//   V) = 32 + 2 x 64 = 160 KB at (128, 128), 48 + 2 x (48 + 32) = 208 KB at
//   (192, 128) (one CTA per SM either way), 80 KB at (64, 64).
// - Every tile is stored as D/64 (V: Dv/64) panels of 128 rows x 64 columns
//   (128 bytes a row) with the 128-byte swizzle; the `wgmma` descriptors
//   name the same swizzle. The tensor maps are 4-D over (D or Dv, S, H, B)
//   built from the
//   element strides the wrapper passes, so transposed head views are read in
//   place, and TMA fills rows past S with zeros: a ragged S needs no
//   padding. GQA is the index map: kv head = h / (Hq / Hkv).
// - Warpgroups 1 and 2 are the consumers, 64 query rows each (setmaxnreg
//   240). Per tile: S = Q·Kᵀ as D/16 `wgmma` m64n128k16 with both operands
//   K-major in shared memory; the online softmax on the f32 accumulator
//   fragment (each row's max reduced over its quad of lanes, columns ≥ S and
//   causal columns > row set to -1e30, exp2 with the scale folded in); P
//   rounded to bf16 pairs in registers, which the m64nNk16 accumulator
//   layout hands over as the register A fragment of O += P·V, 8 `wgmma`
//   m64n{Dv}k16 with V the MN-major (transposed) shared-memory operand. O
//   stays in f32 registers, rescaled by α each tile; each consumer thread
//   arrives on the stage's empty barrier once its products have completed.
//   A consumer thread holds S (64 registers), O (Dv/2: 64 at Dv = 128) and
//   P (32) under setmaxnreg 240. `-Xptxas -v` (nvcc 12.9, sm_90a): 168
//   registers and no spills at each of the three (D, Dv).
// - Epilogue: O / max(l, 1e-30) rounded to bf16 and stored through the
//   output's strides; rows ≥ S are not stored.
// The two consumers do not ping-pong and softmax does not overlap the next
// product: both are later work (ROADMAP.md).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;         // query rows per CTA
constexpr int BN = 128;         // keys per K/V tile
constexpr int PANEL = 64;       // bf16 columns of one 128-byte swizzled panel
constexpr int PANEL_BYTES = BN * 128;
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
// error codes of this file, past CUDA's own
constexpr int ERR_NO_ENCODER = 10001;
constexpr int ERR_ENCODE = 10002;

struct Params {
  void* out;
  int s_len, n_q_tiles, group, causal;
  float scale_log2;  // D^-½ · log2(e)
  long long ob, oh, os;
};

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

// One TMA box (64 columns x 128 rows of one head) into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head),
      "r"(batch)
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

// d (64 x 128, f32) (+)= A (64 x 16) · B (16 x 128): A and B from shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40),
        ACC8(d, 48), ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) · B (16 x 128): B from
// shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32), ACC8(d, 40),
        ACC8(d, 48), ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) · B (16 x 64), B MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D, int DV>
struct Layout {
  static constexpr int PANELS = D / PANEL, V_PANELS = DV / PANEL;
  static constexpr uint32_t TILE = BN * D * 2;     // bytes of a Q or K tile (BM == BN)
  static constexpr uint32_t V_TILE = BN * DV * 2;  // bytes of a V tile
  static constexpr uint32_t STAGE = TILE + V_TILE;
  // Q, then per stage K and V, then 7 mbarriers; 1 KB of slack to align
  // the base to the 128-byte swizzle's 1,024-byte period
  static constexpr int SMEM = TILE + STAGES * STAGE + 8 * (1 + 3 * STAGES) + 1024;
  static_assert(SMEM <= 232448, "past the 227 KB a CTA may have");
};

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<D, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;  // stage s: K at base + TILE + s·STAGE, V one TILE later
  const uint32_t bars = base + L::TILE + STAGES * L::STAGE;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8, v_full = k_full + 8 * STAGES, empty = v_full + 8 * STAGES;

  const int q_tile = p.n_q_tiles - 1 - static_cast<int>(blockIdx.x);  // longest rows first
  const int q0 = q_tile * BM;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.group;
  const int n_kv_all = (p.s_len + BN - 1) / BN;
  const int n_kv = p.causal ? min(n_kv_all, q_tile + 1) : n_kv_all;  // BM == BN

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::TILE);
#pragma unroll
      for (int c = 0; c < L::PANELS; ++c)
        tma_load(q_s + c * PANEL_BYTES, &tq, q_full, c * PANEL, q0, h, b);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty + 8 * s, ((t / STAGES) - 1) & 1);
        const uint32_t ks = base + L::TILE + s * L::STAGE, vs = ks + L::TILE;
        mbar_expect_tx(k_full + 8 * s, L::TILE);
#pragma unroll
        for (int c = 0; c < L::PANELS; ++c)
          tma_load(ks + c * PANEL_BYTES, &tk, k_full + 8 * s, c * PANEL, t * BN, kvh, b);
        mbar_expect_tx(v_full + 8 * s, L::V_TILE);
#pragma unroll
        for (int c = 0; c < L::V_PANELS; ++c)
          tma_load(vs + c * PANEL_BYTES, &tv, v_full + 8 * s, c * PANEL, t * BN, kvh, b);
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

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;  // l: this lane's share

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_kv; ++t) {
      const int s = t % STAGES;
      const uint32_t parity = (t / STAGES) & 1;
      const uint32_t ks = base + L::TILE + s * L::STAGE, vs = ks + L::TILE;
      const uint64_t k_desc = smem_desc(ks, 16, 1024);
      // V as the MN-major B operand: 8-key groups 1,024 bytes apart (SBO),
      // 64-column panels PANEL_BYTES apart (LBO)
      const uint64_t v_desc = smem_desc(vs, PANEL_BYTES, 1024);

      // S = Q·Kᵀ: D/16 steps of 16 columns, 32 bytes apart in a panel row
      float sc[64];
      mbar_wait(k_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk / 4) * PANEL_BYTES + (kk % 4) * 32) >> 4;
        wgmma_ss_n128(sc, q_desc + off, k_desc + off, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale into log2 units; mask columns ≥ S and (causal) columns > row.
      // sc[4j + e]: row (e < 2 ? row_a : row_b), column 8j + col_off + (e & 1)
      const int k0 = t * BN;
      const bool mask = k0 + BN > p.s_len || (p.causal && k0 + BN - 1 > q0 + 64 * cw);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
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
      // online softmax: a row's 128 columns lie in the 4 lanes of a quad
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
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
      // P as bf16 pairs: 16 keys of the accumulator are the register A
      // fragment of one m64nNk16 step (rows a, b; columns +0/+1, +8/+9)
      uint32_t pa[8][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float pr[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) pr[e] = exp2f(sc[8 * kk + e] - ((e & 2) ? m_b : m_a));
        sum_a += pr[0] + pr[1] + pr[4] + pr[5];
        sum_b += pr[2] + pr[3] + pr[6] + pr[7];
        pa[kk][0] = pack_bf16(pr[0], pr[1]);
        pa[kk][1] = pack_bf16(pr[2], pr[3]);
        pa[kk][2] = pack_bf16(pr[4], pr[5]);
        pa[kk][3] = pack_bf16(pr[6], pr[7]);
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

      // O += P·V: 8 steps of 16 keys, 16 rows x 128 bytes = 2,048 bytes apart
      mbar_wait(v_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if constexpr (DV == 128)
          wgmma_rs_n128(o, pa[kk], v_desc + ((kk * 2048) >> 4));
        else
          wgmma_rs_n64(o, pa[kk], v_desc + ((kk * 2048) >> 4));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(empty + 8 * s);
    }

    // epilogue: the quad's shares of l, then O / l as bf16 pairs
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.out) + b * p.ob + h * p.oh;
    if (row_a < p.s_len) {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<uint32_t*>(op + row_a * p.os + 8 * j + col_off) =
            pack_bf16(o[4 * j] / den_a, o[4 * j + 1] / den_a);
    }
    if (row_b < p.s_len) {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<uint32_t*>(op + row_b * p.os + 8 * j + col_off) =
            pack_bf16(o[4 * j + 2] / den_b, o[4 * j + 3] / den_b);
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

// A 4-D map over (D, S, H, B) of bf16, boxes of 64 columns x 128 rows of
// one head, 128-byte swizzle; rows past S read as zeros.
int make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int d, int s_len, int heads,
             int batch, long long sb, long long sh, long long ss) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s_len, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {PANEL, BN, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <int D, int DV>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Params& p, int hq, int batch, cudaStream_t stream) {
  const int bytes = Layout<D, DV>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(fa_wgmma_kernel<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.n_q_tiles, hq, batch);
  fa_wgmma_kernel<D, DV><<<grid, THREADS, bytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out = attention(q, k, v) in bf16; q: (B, Hq, S, D), k: (B, Hkv, S, D),
// v: (B, Hkv, S, Dv), out: (B, Hq, S, Dv), each addressed through element
// strides over (b, h, s) with a contiguous last dimension. q, k and v need
// 16-byte aligned bases and strides that are multiples of 8 elements (TMA's
// rule); (D, Dv) ∈ {(64, 64), (128, 128), (192, 128)}, Hq % Hkv == 0, S >= 1.
int fa_forward_wgmma(const void* q, const void* k, const void* v, void* out, int batch, int hq,
                     int hkv, int s_len, int d, int dv, long long qb, long long qh, long long qs,
                     long long kb, long long kh, long long ks, long long vb, long long vh,
                     long long vs, long long ob, long long oh, long long os, int causal,
                     float scale, void* stream) {
  const bool dims = (d == 64 && dv == 64) || (d == 128 && dv == 128) || (d == 192 && dv == 128);
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || s_len <= 0 || !dims)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  CUtensorMap tq, tk, tv;
  int rc = make_map(enc, &tq, q, d, s_len, hq, batch, qb, qh, qs);
  if (rc == 0) rc = make_map(enc, &tk, k, d, s_len, hkv, batch, kb, kh, ks);
  if (rc == 0) rc = make_map(enc, &tv, v, dv, s_len, hkv, batch, vb, vh, vs);
  if (rc != 0) return rc;
  const Params p{out, s_len, (s_len + BM - 1) / BM, hq / hkv, causal, scale * LOG2E,
                 ob, oh, os};
  const cudaStream_t st = (cudaStream_t)stream;
  if (d == 192) return launch<192, 128>(tq, tk, tv, p, hq, batch, st);
  return d == 128 ? launch<128, 128>(tq, tk, tv, p, hq, batch, st)
                  : launch<64, 64>(tq, tk, tv, p, hq, batch, st);
}

const char* fa_wgmma_error_string(int err) {
  if (err == ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (err == ERR_ENCODE)
    return "cuTensorMapEncodeTiled refused the tensor map (alignment or strides)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
