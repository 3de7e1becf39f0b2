// K8: flash-attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
// (kernel.py:88; body `_kernel`, pallas_call at kernel.py:114).
//
// What it computes (the Pallas kernel's math, not its grid): for query row
// i of head h and key j of kv head h / G (GQA by indexing: K/V are never
// repeated),
//   s[i, j] = (q[i] in f32 * scale) . k[j]            (f32)
//   s       = tanh(s / softcap) * softcap               (softcap > 0)
//   s       = -1e30 where masked: j >= Sk, causal j > p, window
//             p - j >= W, and without causality also j - p >= W, where
//             p = i + q_offset is the row's position in the key sequence
//             (0 unless the rows are one rank's slice of a longer
//             sequence: sequence-parallel attention)
//   online softmax over key tiles with m, l, acc in f32; p is rounded to
//   the value type before it multiplies V (p.astype(v.dtype) in Pallas);
//   out[i]  = acc / max(l, 1e-30), rounded once to the output type.
// The mask value is the finite -1e30, as in Pallas: a row whose first
// visited tile is fully masked accumulates junk (p = 1) that the first
// real key wipes through corr = exp(-1e30 - m) = 0. Tensors are in the
// model's (B, S, H, D) layout, contiguous.
//
// What bounds it on the H100: operations. 4·D flops per unmasked (q, k)
// pair against (2·Sq·H + 2·Sk·K)·D·2 bytes; at the serving prefill (B 8,
// S 2048, H 4, K 1, D 256, causal) 68.7 GFLOP, 0.0695 ms at 989 TFLOP/s.
//
// bf16 route (the serving and training paths), `flash_wgmma_kernel`:
//  1. Both products on `wgmma` (the only path to Hopper's full tensor-core
//     rate; the first design used Ampere's `mma.sync`). S = Q.K^T is
//     m64n64k16 with Q and K K-major in shared memory; O += P.V is
//     m64nDk16 with P from registers (the S accumulator repacked as the
//     A fragment) and V key-major in shared memory, read through the
//     transpose flag. Every head dim of ops.HEAD_DIMS (16-256 in steps of
//     16) takes it: rows of D < 64 use the 32- or 64-byte swizzle, D >= 64
//     the 128-byte one in D / 64 column blocks. A head dim that is not a
//     power of two (hubert's 80) runs the instantiation of the next one
//     (`kernel_dim`: 80 -> 128) over tensor maps whose inner dim is the
//     real D: TMA fills the columns past D with zeros, which add nothing
//     to Q.K^T and give zero output columns that the TMA store clips. The
//     scale stays 1/sqrt(D); the padding costs D_kernel / D of the MMA
//     work (1.6x at D 80) and no extra bytes of device memory.
//  2. Copies overlap the math: one producer thread issues TMA loads (4-D
//     tensor maps over (B, S, heads, D), one box a (b, head) slab of rows
//     x one swizzle row; rows past S are zero-filled) into a ring of two
//     K/V stages with `mbarrier`s (full: transaction bytes; empty: one
//     arrival per consumer warp, K and V apart: K(i) is free once S(i) is
//     done), while the consumer warpgroups compute.
//  3. A CTA is BQ = 64·NWG query rows: NWG consumer warpgroups of 64 rows
//     plus one producer warpgroup (`choose_block_q` picks NWG per shape).
//     With NWG = 2, `setmaxnreg` gives the producer
//     24 registers and each consumer 240, enough for the 64 x 256 f32
//     output accumulator (128 a thread), the 64 x 64 scores (32) and P
//     (16); one warpgroup's softmax runs while the other's products hold
//     the tensor cores. At D = 256: Q 64 KB + K/V ring 128 KB of shared
//     memory.
//  4. The per-element mask runs only on the key tiles that need it (the
//     diagonal, the window's edges, the ragged tail: `tile_masked`, taken
//     for each consumer warpgroup's own 64 rows, which also skip the
//     CTA's tiles that they never see); the interior tiles skip it, and a
//     masked tile tests each key against two bounds a row. The softcap is
//     a template flag, log2(e) is folded into the scale, and 2^x is one
//     `ex2.approx` (`fast_exp2`). Within a warpgroup, S(i) is issued
//     before P.V(i - 1), so the softmax of S(i) runs while P.V(i - 1) is
//     on the tensor cores. The output is staged in the warpgroup's rows of
//     the Q tile and leaves by TMA stores (whole 128-byte rows, not the
//     accumulator's scattered 4-byte pairs).
//  5. Longest tiles first: grid (B·H, q tiles); blockIdx.y is a rank, and
//     the CTA of rank r takes the q tile that is r-th in order of
//     non-increasing visited key tiles (ties: the later tile first), so
//     the causal diagonal's long tiles do not start last.
// The tile arithmetic (`key_range`, `tile_masked`, the rank order) is
// ops.tile_plan's, which the CPU tests hold against the mask. Key tiles
// that the mask leaves out entirely are skipped, as kernel.py:43-49 does.
// No atomics anywhere: the result does not depend on scheduling.
//
// f32 route (tests and the f32 model reference; off the main path),
// `flash_kernel`: f32 FMAs on the CUDA cores (tensor cores would round to
// TF32), at the same padded instantiation: columns past the real D load
// as zeros and are not stored. 256 threads; the pre-scaled q tile, a 32-key K and V tile and the
// 64x32 probability tile in shared memory as f32 (141 KB at D = 256);
// thread t owns row t / 4, key columns t % 4 + 4j and value columns in
// float4 groups 4(t % 4 + 4jj) .. +3. The row max and sum combine across
// the threads of a row with xor shuffles.
#include <atomic>
#include <cstdint>
#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * (BK + 1)) * 4;
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int H, int KH, int dr, float scale, float softcap, int causal,
             int window, int qoff) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int QS = D + 4;           // padded row stride of Qs and Ks
  constexpr int PS = BK + 1;          // padded row stride of Ps
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [BQ][QS]
  float* Ks = Qs + BQ * QS;           // [BK][QS]
  float* Vs = Ks + BK * QS;           // [BK][D]
  float* Ps = Vs + BK * D;            // [BQ][PS]

  const int tid = threadIdx.x, r = tid >> 2, c4 = tid & 3;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / (H / KH);
  const int qpos = q0 + r;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int rr = idx / D, dd = idx % D, qp = q0 + rr;
    float val = 0.f;
    if (qp < Sq && dd < dr)
      val = to_f32(q[(((int64_t)b * Sq + qp) * H + h) * dr + dd]) * scale;
    Qs[rr * QS + dd] = val;
  }

  // key tiles that some row of this q tile may see
  const int nk = (Sk + BK - 1) / BK;
  const int p0 = q0 + qoff;            // the tile's first position
  int kt_end = nk;
  if (causal) {
    kt_end = min(kt_end, (p0 + BQ - 1) / BK + 1);
  } else if (window > 0) {
    kt_end = min(kt_end, (p0 + BQ - 1 + window - 1) / BK + 1);
  }
  int kt_begin = 0;
  if (window > 0 && p0 - window + 1 > 0) kt_begin = (p0 - window + 1) / BK;

  float m = NEG_INF, l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // Qs written / the previous tile's reads finished
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int cc = idx / D, dd = idx % D, kp = k0 + cc;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk && dd < dr) {
        const int64_t off = (((int64_t)b * Sk + kp) * KH + kh) * dr + dd;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[cc * QS + dd] = kv;
      Vs[cc * D + dd] = vv;
    }
    __syncthreads();

    float s[BK / 4];
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) s[j] = 0.f;
    const float4* qrow = reinterpret_cast<const float4*>(Qs + r * QS);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 qv = qrow[d4];
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const float4 kv =
            reinterpret_cast<const float4*>(Ks + (c4 + 4 * j) * QS)[d4];
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    float rmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int kp = k0 + c4 + 4 * j;
      float x = s[j];
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      const int ap = qpos + qoff;
      bool ok = qpos < Sq && kp < Sk;
      if (causal) ok = ok && ap >= kp;
      if (window > 0) {
        ok = ok && ap - kp < window;
        if (!causal) ok = ok && kp - ap < window;
      }
      s[j] = ok ? x : NEG_INF;
      rmax = fmaxf(rmax, s[j]);
    }
    rmax = fmaxf(rmax, __shfl_xor_sync(FULL, rmax, 1));
    rmax = fmaxf(rmax, __shfl_xor_sync(FULL, rmax, 2));
    const float m_new = fmaxf(m, rmax);
    const float corr = expf(m - m_new);
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const float p = expf(s[j] - m_new);
      rsum += p;
      Ps[r * PS + c4 + 4 * j] = to_f32(from_f32<T>(p));
    }
    rsum += __shfl_xor_sync(FULL, rsum, 1);
    rsum += __shfl_xor_sync(FULL, rsum, 2);
    l = l * corr + rsum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] *= corr;
    __syncthreads();   // Ps complete

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r * PS + c];
      const float4* vrow = reinterpret_cast<const float4*>(Vs + c * D);
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        const float4 vv = vrow[c4 + 4 * jj];
        acc[4 * jj + 0] = fmaf(p, vv.x, acc[4 * jj + 0]);
        acc[4 * jj + 1] = fmaf(p, vv.y, acc[4 * jj + 1]);
        acc[4 * jj + 2] = fmaf(p, vv.z, acc[4 * jj + 2]);
        acc[4 * jj + 3] = fmaf(p, vv.w, acc[4 * jj + 3]);
      }
    }
  }

  if (qpos < Sq) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = out + (((int64_t)b * Sq + qpos) * H + h) * dr;
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * (c4 + 4 * jj) + e;
        if (col < dr) orow[col] = from_f32<T>(acc[4 * jj + e] / den);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA (warp-specialised)
// ---------------------------------------------------------------------------

constexpr int WG_BK = 64;      // keys a tile
constexpr int STAGES = 2;      // K/V ring
constexpr float LOG2E = 1.4426950408889634f;

// shared-memory geometry of a head dim: each row of a tile is D / AW
// swizzle rows of RB bytes, stored as NA column blocks of `rows` x RB
template <int D>
struct Geom {
  static constexpr int AW = D < 64 ? D : 64;     // elements a swizzle row
  static constexpr int RB = AW * 2;              // bytes a swizzle row
  static constexpr int NA = D / AW;              // column blocks
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr int TILE = WG_BK * D * 2;     // bytes of a K or V tile
};

// 1024 for the alignment of the swizzled tiles, Q, the K and V rings,
// 4·STAGES + 1 mbarriers and the CTA's q tile
template <int D, int NWG>
constexpr int wg_smem_bytes() {
  return 1024 + 64 * NWG * D * 2 + 2 * STAGES * Geom<D>::TILE +
         8 * (4 * STAGES + 1) + 8;
}

// The tile arithmetic of ops.tile_plan: the key tiles [kb, ke) that some
// real row of q tile qt may see (ke <= kb: none), and whether key tile k0
// needs the per-element mask for the rows at positions [q0, q_last]. A
// row's position is its index plus qoff.
__device__ __forceinline__ void key_range(int qt, int bq, int Sq, int Sk,
                                          int causal, int window, int qoff,
                                          int& kb, int& ke) {
  const int q0 = qt * bq + qoff, q_last = min(qt * bq + bq, Sq) - 1 + qoff;
  ke = (Sk + WG_BK - 1) / WG_BK;
  if (causal)
    ke = min(ke, q_last / WG_BK + 1);
  else if (window > 0)
    ke = min(ke, (q_last + window - 1) / WG_BK + 1);
  kb = 0;
  if (window > 0 && q0 - window + 1 > 0) kb = (q0 - window + 1) / WG_BK;
}

__device__ __forceinline__ bool tile_masked(int q0, int q_last, int k0,
                                            int Sk, int causal, int window) {
  if (k0 + WG_BK > Sk) return true;
  if (causal && k0 + WG_BK - 1 > q0) return true;
  if (window > 0) {
    if (q_last - k0 >= window) return true;
    if (!causal && k0 + WG_BK - 1 - q0 >= window) return true;
  }
  return false;
}

__device__ __forceinline__ int tile_work(int qt, int bq, int Sq, int Sk,
                                         int causal, int window, int qoff) {
  int kb, ke;
  key_range(qt, bq, Sq, Sk, causal, window, qoff, kb, ke);
  return max(ke - kb, 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA box of a 4-D map (coordinates innermost first) into shared
// memory at dst, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start, leading and stride byte
// offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B, 3: 32 B)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x on the MUFU unit alone (exp2f adds a range fix-up around it): a
// relative error of 2^-22, results under 2^-126 flushed to 0, far below
// what the bf16 rounding of p keeps
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a TMA store of one box from shared memory at src (coordinates innermost
// first); the issuing thread waits for its reads before it reuses src
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 64, f32) {=, +=} A (smem, K-major) . B (smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d (64 x 16, f32) += A (registers, bf16 fragments) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 32, f32) += A (registers, bf16 fragments) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 64, f32) += A (registers, bf16 fragments) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 128, f32) += A (registers, bf16 fragments) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 256, f32) += A (registers, bf16 fragments) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// The keys [lo, hi] that query row qp may see (the mask of ops._mask and
// the Pallas kernel, as two bounds a row)
struct RowKeys {
  int lo, hi;
};

__device__ __forceinline__ RowKeys row_keys(int qp, int Sk, int causal,
                                            int window) {
  RowKeys r{0, Sk - 1};
  if (causal) r.hi = min(r.hi, qp);
  if (window > 0) {
    r.lo = max(r.lo, qp - window + 1);
    if (!causal) r.hi = min(r.hi, qp + window - 1);
  }
  return r;
}

// One key tile's online softmax for a consumer thread. In: the scores sc
// (the m64n64 accumulator: sc[4j + e] is row g + 8(e / 2), key
// 8j + c2 + e % 2 of the tile at k0). Out: sc holds the probabilities in
// f32, m the running max and l the partial sums of rows g and g + 8 (in
// log2 units: mul folds in log2 e), corr the factor that rescales the
// output. MASK applies the rows' key bounds rk (tiles that need it).
template <bool MASK, bool CAP>
__device__ __forceinline__ void softmax_tile(float (&sc)[WG_BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float mul, float cap_out,
                                             const RowKeys (&rk)[2], int k0,
                                             int c2) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < WG_BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e];
      x = CAP ? tanhf(x * mul) * cap_out : x * mul;
      if (MASK) {
        const int kp = k0 + 8 * j + c2 + (e & 1);
        const RowKeys& r = rk[e >> 1];
        x = kp >= r.lo && kp <= r.hi ? x : NEG_INF;
      }
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = fast_exp2(m[i] - m_new);
    m[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < WG_BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // x - m, not fma(score, mul, -m): at a masked -1e30 the fma's
      // residual would be ~1e21, and exp2 of it inf
      const float pv = fast_exp2(sc[4 * j + e] - m[e >> 1]);
      l[e >> 1] += pv;
      sc[4 * j + e] = pv;
    }
  }
}

// the probabilities rounded to bf16 as the A fragments of P.V
// (p[kk]: keys 16kk .. 16kk + 15; the accumulator and the A fragment
// share a thread layout)
__device__ __forceinline__ void pack_p(const float (&sc)[WG_BK / 2],
                                       uint32_t (&p)[WG_BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < WG_BK / 16; ++kk) {
    p[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// grid (B·H, q tiles), 128·(NWG + 1) threads: warpgroup 0 is the producer
// (one thread issues every TMA load), warpgroups 1..NWG compute 64 query
// rows each. mul is scale·log2(e) (scale / softcap with CAP, and then
// cap_out = softcap·log2(e)).
template <int D, int NWG, bool CAP>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o, int Sq, int Sk,
                   int H, int KH, float mul, float cap_out, int causal,
                   int window, int qoff) {
  using G = Geom<D>;
  constexpr int BQ = 64 * NWG;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sK = sQ + BQ * D * 2;
  const uint32_t sV = sK + STAGES * G::TILE;
  const uint32_t bars = sV + STAGES * G::TILE;
  // bars: q_full, then k_full, v_full, k_empty and v_empty for each stage
  const uint32_t bar_q = bars;
  auto bar = [&](int kind, int i) {
    return bars + 8 * (1 + kind * STAGES + i % STAGES);
  };
  enum { K_FULL, V_FULL, K_EMPTY, V_EMPTY };
  int* s_qt = reinterpret_cast<int*>(smem_raw + (bars - raw) +
                                     8 * (4 * STAGES + 1));

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int nq = (Sq + BQ - 1) / BQ;

  // the q tile of rank blockIdx.y: rank(c) counts the tiles before c in
  // order of non-increasing work, the later tile first among equals
  for (int c = threadIdx.x; c < nq; c += blockDim.x) {
    const int wc = tile_work(c, BQ, Sq, Sk, causal, window, qoff);
    int rank = 0;
    for (int u = 0; u < nq; ++u) {
      const int wu = tile_work(u, BQ, Sq, Sk, causal, window, qoff);
      rank += (wu > wc) || (wu == wc && u > c);
    }
    if (rank == (int)blockIdx.y) *s_qt = c;
  }
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(K_FULL, s), 1);
      mbar_init(bar(V_FULL, s), 1);
      mbar_init(bar(K_EMPTY, s), 4 * NWG);   // one arrival a consumer warp
      mbar_init(bar(V_EMPTY, s), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int qt = *s_qt;
  const int q0 = qt * BQ, q_last = min(q0 + BQ, Sq) - 1;
  int kb, ke;
  key_range(qt, BQ, Sq, Sk, causal, window, qoff, kb, ke);

  if (threadIdx.x < 128) {
    // ---- producer ----
    if (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, BQ * D * 2);
#pragma unroll
      for (int a = 0; a < G::NA; ++a)
        tma_load(sQ + a * BQ * G::RB, &tm_q, bar_q, a * G::AW, h, q0, b);
      // K(i) and V(i) are released apart (K once S(i) is done, V once
      // P.V(i) is), so K(i + 2) is in flight while V(i) is still read
      for (int kt = kb, i = 0; kt < ke; ++kt, ++i) {
        const int s = i % STAGES;
        const uint32_t empty_phase = ((i / STAGES) & 1) ^ 1;
        const uint32_t bk = bar(K_FULL, i), bv = bar(V_FULL, i);
        if (i >= STAGES) mbar_wait(bar(K_EMPTY, i), empty_phase);
        mbar_expect_tx(bk, G::TILE);
#pragma unroll
        for (int a = 0; a < G::NA; ++a)
          tma_load(sK + s * G::TILE + a * WG_BK * G::RB, &tm_k, bk,
                   a * G::AW, kh, kt * WG_BK, b);
        if (i >= STAGES) mbar_wait(bar(V_EMPTY, i), empty_phase);
        mbar_expect_tx(bv, G::TILE);
#pragma unroll
        for (int a = 0; a < G::NA; ++a)
          tma_load(sV + s * G::TILE + a * WG_BK * G::RB, &tm_v, bv,
                   a * G::AW, kh, kt * WG_BK, b);
      }
    }
    return;
  }

  // ---- consumers ----
  if (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  // the warpgroup index through a shuffle: ptxas then knows it is uniform
  // across the warp, and does not serialize the wgmmas under branches on it
  const int cw = __shfl_sync(FULL, threadIdx.x / 128, 0) - 1;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int c2 = 2 * (lane & 3);
  const int row0 = q0 + cw * 64 + warp * 16 + (lane >> 2);   // and + 8
  const uint32_t qa = sQ + cw * 64 * G::RB;
  const RowKeys rk[2] = {row_keys(row0 + qoff, Sk, causal, window),
                         row_keys(row0 + 8 + qoff, Sk, causal, window)};
  // this warpgroup's rows are a 64-row q tile of their own: it computes
  // the CTA's tiles [i0, i1) that tile_plan(.., 64, ..) gives them, with
  // its own mask flags, and only releases the others
  const int wq0 = q0 + cw * 64, wq_last = min(wq0 + 64, Sq) - 1;
  const int n = max(ke - kb, 0);
  int i0 = n, i1 = n;
  if (wq0 < Sq) {
    int wkb, wke;
    key_range(qt * NWG + cw, 64, Sq, Sk, causal, window, qoff, wkb, wke);
    i0 = min(max(wkb - kb, 0), n);
    i1 = min(max(wke - kb, i0), n);
  }
  auto phase = [&](int i) { return (uint32_t)((i / STAGES) & 1); };
  auto release = [&](int kind, int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(kind, i));
  };
  auto skip = [&](int i) {   // a tile this warpgroup's rows never see
    mbar_wait(bar(K_FULL, i), phase(i));
    mbar_wait(bar(V_FULL, i), phase(i));
    release(K_EMPTY, i);
    release(V_EMPTY, i);
  };
  auto issue_s = [&](float (&sc)[WG_BK / 2], int i) {
    const uint32_t ka = sK + (i % STAGES) * G::TILE;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int a = ks / (G::AW / 16), w = ks % (G::AW / 16);
      wgmma_ss(sc,
                   wg_desc(qa + a * BQ * G::RB + w * 32, 16, 8 * G::RB,
                           G::LAYOUT),
                   wg_desc(ka + a * WG_BK * G::RB + w * 32, 16, 8 * G::RB,
                           G::LAYOUT),
                   ks > 0);
    }
    wg_commit();
  };
  auto issue_pv = [&](float (&o)[D / 2], const uint32_t (&p)[WG_BK / 16][4],
                      int i) {
    const uint32_t va = sV + (i % STAGES) * G::TILE;
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      wgmma_rs(o, p[kk],
               wg_desc(va + kk * 16 * G::RB, WG_BK * G::RB, 8 * G::RB,
                       G::LAYOUT));
    wg_commit();
  };
  auto softmax = [&](float (&sc)[WG_BK / 2], float (&m)[2], float (&l)[2],
                     float (&corr)[2], int i) {
    const int k0 = (kb + i) * WG_BK;
    if (tile_masked(wq0 + qoff, wq_last + qoff, k0, Sk, causal, window))
      softmax_tile<true, CAP>(sc, m, l, corr, mul, cap_out, rk, k0, c2);
    else
      softmax_tile<false, CAP>(sc, m, l, corr, mul, cap_out, rk, k0, c2);
  };
  // o *= corr, skipped where no row of the warp changed its max (then
  // corr is exactly 1 and the product would leave o as it is)
  auto rescale = [&](float (&o)[D / 2], const float (&corr)[2]) {
    if (__any_sync(FULL, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
    }
  };
  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int i = 0; i < i0; ++i) skip(i);
  if (i0 < i1) {
    // S(i) goes out before P.V(i - 1); the softmax of S(i) runs while
    // P.V(i - 1) (and the other warpgroup's products) are on the tensor
    // cores
    float sc[WG_BK / 2], corr[2];
    uint32_t p[WG_BK / 16][4];
    mbar_wait(bar_q, 0);
    mbar_wait(bar(K_FULL, i0), phase(i0));
    wg_fence();
    issue_s(sc, i0);
    wg_wait0();
    reg_fence(sc);
    release(K_EMPTY, i0);
    softmax(sc, m, l, corr, i0);
    pack_p(sc, p);
    for (int i = i0 + 1; i < i1; ++i) {
      mbar_wait(bar(K_FULL, i), phase(i));
      wg_fence();
      issue_s(sc, i);
      rescale(o, corr);
      mbar_wait(bar(V_FULL, i - 1), phase(i - 1));
      wg_fence();
      issue_pv(o, p, i - 1);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      reg_fence(sc);
      release(K_EMPTY, i);
      softmax(sc, m, l, corr, i);
      wg_wait0();
      reg_fence(o);
      release(V_EMPTY, i - 1);
      pack_p(sc, p);
    }
    mbar_wait(bar(V_FULL, i1 - 1), phase(i1 - 1));
    rescale(o, corr);
    wg_fence();
    issue_pv(o, p, i1 - 1);
    wg_wait0();
    reg_fence(o);
    release(V_EMPTY, i1 - 1);
  }
  for (int i = i1; i < n; ++i) skip(i);

  // Epilogue: out = o / max(l, 1e-30) in bf16, staged in this warpgroup's
  // rows of Q's tile (every S that reads them is done) in the same
  // swizzled layout, then one TMA store a column block (rows past Sq are
  // not written). The other warpgroup reads only its own rows.
  mbar_wait(bar_q, 0);   // a warpgroup with no tiles: Q has landed
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i] + __shfl_xor_sync(FULL, l[i], 1);
    li += __shfl_xor_sync(FULL, li, 2);
    inv[i] = 1.f / fmaxf(li, 1e-30f);
  }
  const int r = warp * 16 + (lane >> 2);   // and r + 8, in the 64 rows
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int a = 8 * j / G::AW;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t off = (r + 8 * i) * G::RB + (8 * j % G::AW + c2) * 2;
      const uint32_t swz = off ^ (((off >> 7) & (G::RB / 16 - 1)) << 4);
      const uint32_t v = pack_bf16(o[4 * j + 2 * i] * inv[i],
                                   o[4 * j + 2 * i + 1] * inv[i]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(qa + a * BQ * G::RB +
                                                      swz),
                   "r"(v)
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  if (t == 0 && wq0 < Sq) {
#pragma unroll
    for (int a = 0; a < G::NA; ++a)
      tma_store(&tm_o, qa + a * BQ * G::RB, a * G::AW, h, wq0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// cudaFuncSetAttribute once per kernel and device, not on every launch
// (`done`: one bit a device, static in each launcher's instantiation)
template <typename Kernel>
int raise_smem_limit(Kernel kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? (uint64_t{1} << dev) : 0;
  if (bit && (done.load() & bit)) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  done.fetch_or(bit);
  return 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver library, which the build does
// not link: fetch it through the runtime once
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the 4-D map of a contiguous (B, S, heads, dr) bf16 tensor with boxes of
// `rows` positions x one swizzle row of one (b, head), in the geometry of
// the instantiation D >= dr (columns past dr read as zeros, and a store
// leaves them out)
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
             int dr, int rows) {
  using G = Geom<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)dr, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dr * 2,
                                 (cuuint64_t)heads * dr * 2,
                                 (cuuint64_t)S * heads * dr * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::AW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      G::RB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : G::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, int NWG, bool CAP>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Sk, int H, int KH, int dr, float scale,
                 float softcap, int causal, int window, int qoff,
                 cudaStream_t stream) {
  constexpr int BQ = 64 * NWG;
  constexpr int bytes = wg_smem_bytes<D, NWG>();
  static_assert(bytes <= 232448, "shared memory over the H100's 227 KB");
  static std::atomic<uint64_t> done{0};
  int err = raise_smem_limit(flash_wgmma_kernel<D, NWG, CAP>, bytes, done);
  if (err) return err;
  CUtensorMap mq, mk, mv, mo;
  if ((err = make_map<D>(&mq, q, B, Sq, H, dr, BQ))) return err;
  if ((err = make_map<D>(&mk, k, B, Sk, KH, dr, WG_BK))) return err;
  if ((err = make_map<D>(&mv, v, B, Sk, KH, dr, WG_BK))) return err;
  if ((err = make_map<D>(&mo, out, B, Sq, H, dr, 64))) return err;
  const float mul = CAP ? scale / softcap : scale * LOG2E;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  flash_wgmma_kernel<D, NWG, CAP><<<grid, 128 * (NWG + 1), bytes, stream>>>(
      mq, mk, mv, mo, Sq, Sk, H, KH, mul, softcap * LOG2E, causal, window,
      qoff);
  return (int)cudaGetLastError();
}

// The launcher's block_q, per shape as measured on the H100 (PERF.md,
// PR 14; chip_smoke.py's K8 row, `ms_by_block_q`): 128, two consumer
// warpgroups, except for a launch without a window whose 128-row grid is
// under one wave of the card's SMs (the training step's causal layers:
// B 4 x H 4 x 8 tiles = 128 CTAs on 132 SMs), where 64 was faster.
int choose_block_q(int B, int H, int Sq, int window) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long ctas = (long long)B * H * ((Sq + 127) / 128);
  return window == 0 && ctas < sms ? 64 : 128;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int H, int KH, int dr, float scale,
                float softcap, int causal, int window, int qoff, int block_q,
                cudaStream_t s) {
  if (block_q == 0) block_q = choose_block_q(B, H, Sq, window);
  const bool cap = softcap > 0.f;
  if (block_q == 128)
    return cap ? launch_wgmma<D, 2, true>(q, k, v, out, B, Sq, Sk, H, KH, dr,
                                          scale, softcap, causal, window,
                                          qoff, s)
               : launch_wgmma<D, 2, false>(q, k, v, out, B, Sq, Sk, H, KH,
                                           dr, scale, softcap, causal,
                                           window, qoff, s);
  if (block_q == 64)
    return cap ? launch_wgmma<D, 1, true>(q, k, v, out, B, Sq, Sk, H, KH, dr,
                                          scale, softcap, causal, window,
                                          qoff, s)
               : launch_wgmma<D, 1, false>(q, k, v, out, B, Sq, Sk, H, KH,
                                           dr, scale, softcap, causal,
                                           window, qoff, s);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int H, int KH, int dr, float scale,
               float softcap, int causal, int window, int qoff,
               cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static std::atomic<uint64_t> done{0};
  const int err = raise_smem_limit(flash_kernel<D, float>, bytes, done);
  if (err) return err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * H));
  flash_kernel<D, float><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, KH,
      dr, scale, softcap, causal, window, qoff);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KH, int dr, float scale, float softcap,
           int causal, int window, int qoff, int bf16, int block_q,
           cudaStream_t s) {
  if (bf16)
    return launch_bf16<D>(q, k, v, out, B, Sq, Sk, H, KH, dr, scale, softcap,
                          causal, window, qoff, block_q, s);
  return launch_f32<D>(q, k, v, out, B, Sq, Sk, H, KH, dr, scale, softcap,
                       causal, window, qoff, s);
}

// the instantiation a head dim runs (ops.kernel_dim): the next of 16, 32,
// 64, 128, 256; 0 for a head dim the kernel does not take
int kernel_dim(int D) {
  if (D < 16 || D > 256 || D % 16) return 0;
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

}  // namespace

// q, out: contiguous (B, Sq, H, D); k, v: contiguous (B, Sk, KH, D), all of
// the type `bf16` names (1: bf16, 0: f32), 16-byte aligned. D in 16..256,
// a multiple of 16 (the Pallas kernel's domain), H % KH == 0. window 0 means no window; softcap 0 means
// none. q_offset >= 0: query row i sits at position i + q_offset of the
// key sequence (the causal and window masks compare positions). block_q (bf16 only): 64 or 128 query rows a CTA, 0 for the
// launcher's choice per shape (`choose_block_q`). Returns the first CUDA
// error of the set-up or the launch (0 on success).
extern "C" int rt_flash_attention_bq(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int H, int KH, int D,
                                     float scale, float softcap, int causal,
                                     int window, int q_offset, int bf16,
                                     int block_q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (q_offset < 0) return (int)cudaErrorInvalidValue;
  switch (kernel_dim(D)) {
    case 16: return launch<16>(q, k, v, out, B, Sq, Sk, H, KH, D, scale,
                               softcap, causal, window, q_offset, bf16, block_q, s);
    case 32: return launch<32>(q, k, v, out, B, Sq, Sk, H, KH, D, scale,
                               softcap, causal, window, q_offset, bf16, block_q, s);
    case 64: return launch<64>(q, k, v, out, B, Sq, Sk, H, KH, D, scale,
                               softcap, causal, window, q_offset, bf16, block_q, s);
    case 128: return launch<128>(q, k, v, out, B, Sq, Sk, H, KH, D, scale,
                                 softcap, causal, window, q_offset, bf16, block_q, s);
    case 256: return launch<256>(q, k, v, out, B, Sq, Sk, H, KH, D, scale,
                                 softcap, causal, window, q_offset, bf16, block_q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the same with the launcher's choice of block_q
extern "C" int rt_flash_attention(const void* q, const void* k,
                                  const void* v, void* out, int B, int Sq,
                                  int Sk, int H, int KH, int D, float scale,
                                  float softcap, int causal, int window,
                                  int q_offset, int bf16, void* stream) {
  return rt_flash_attention_bq(q, k, v, out, B, Sq, Sk, H, KH, D, scale,
                               softcap, causal, window, q_offset, bf16, 0,
                               stream);
}
