// K8: flash-attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd (body
// `_kernel`, pallas_call at kernel.py:114).
//
// What it computes (the Pallas kernel's math, not its grid): for query row
// i of head h and key j of kv head h / G (GQA by indexing: K/V are never
// repeated),
//   s[i, j] = (q[i] in f32 * scale) . k[j]            (f32)
//   s       = tanh(s / softcap) * softcap               (softcap > 0)
//   s       = -1e30 where masked: i >= Sq, j >= Sk, causal j > i,
//             window i - j >= W, and without causality also j - i >= W
//   online softmax over key tiles with m, l, acc in f32; p is rounded to
//   the value type before it multiplies V (p.astype(v.dtype) in Pallas);
//   out[i]  = acc / max(l, 1e-30), rounded once to the output type.
// Tensors are in the model's (B, S, H, D) layout, contiguous.
//
// What bounds it on the H100: operations. 4·D flops per unmasked (q, k)
// pair against (Sq·H + 2·Sk·K + Sq·H)·D·itemsize bytes; at the serving
// path's prefill (S = 2048, D = 256) that is hundreds of flops per byte.
//
// Design. Two kernels, both one CTA per (64-row q tile, b, h), both with
// key tiles that causality or the window mask entirely left out of the loop
// (kernel.py:43-49 skips them the same way), neither with atomics: the
// result does not depend on scheduling.
//  - bf16 (the serving path): tensor cores through `mma.sync` m16n8k16
//    (bf16 in, f32 accumulate), 4 warps of 16 query rows each, 64-key
//    tiles. Q, K and V tiles sit in shared memory as bf16 with rows padded
//    by 16 bytes, so `ldmatrix` reads them without bank conflicts (101 KB at
//    D = 256, above the 48 KB default: the launch raises the limit). The
//    score accumulator of a warp (16 x 64, f32) is scaled, capped, masked
//    and exponentiated in registers; its probabilities, rounded to bf16,
//    are repacked in place as the A operand of the P.V product (the
//    m16n8 accumulator and the m16k16 operand share a thread layout), and
//    the output accumulator (16 x D, f32) stays in registers. q.k is taken
//    on the bf16 inputs and multiplied by `scale` in f32 afterwards; at the
//    path's D = 256 the scale is 1/16 and the two orders agree exactly.
//  - f32: f32 FMAs on the CUDA cores (tensor cores would round to TF32).
//    256 threads; the pre-scaled q tile, a 32-key K and V tile and the
//    64x32 probability tile in shared memory as f32 (141 KB at D = 256);
//    thread t owns row t / 4, key columns t % 4 + 4j and value columns in
//    float4 groups 4(t % 4 + 4jj) .. +3.
// The row max and sum combine across the threads of a row with xor
// shuffles, so every thread of a row holds the same m and l.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * (BK + 1)) * 4;
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int H, int KH, float scale, float softcap, int causal,
             int window) {
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
    if (qp < Sq)
      val = to_f32(q[(((int64_t)b * Sq + qp) * H + h) * D + dd]) * scale;
    Qs[rr * QS + dd] = val;
  }

  // key tiles that some row of this q tile may see
  const int nk = (Sk + BK - 1) / BK;
  int kt_end = nk;
  if (causal) {
    kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  } else if (window > 0) {
    kt_end = min(kt_end, (q0 + BQ - 1 + window - 1) / BK + 1);
  }
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

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
      if (kp < Sk) {
        const int64_t off = (((int64_t)b * Sk + kp) * KH + kh) * D + dd;
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
      bool ok = qpos < Sq && kp < Sk;
      if (causal) ok = ok && qpos >= kp;
      if (window > 0) {
        ok = ok && qpos - kp < window;
        if (!causal) ok = ok && kp - qpos < window;
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
    T* orow = out + (((int64_t)b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[4 * (c4 + 4 * jj) + e] = from_f32<T>(acc[4 * jj + e] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int MMA_BK = 64;
constexpr int MMA_THREADS = 128;

template <int D>
constexpr int mma_smem_bytes() {
  return 3 * BQ * (D + 8) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + 64) of a (S, heads, D) bf16 tensor at head h into a padded
// shared tile, zero past S (16-byte loads: D is a multiple of 16)
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int b,
                                          int S, int heads, int h, int r0) {
  constexpr int LD = D + 8, C8 = D / 8;
  for (int idx = threadIdx.x; idx < BQ * C8; idx += MMA_THREADS) {
    const int r = idx / C8, c = (idx % C8) * 8, pos = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (pos < S)
      val = *reinterpret_cast<const uint4*>(
          src + (((int64_t)b * S + pos) * heads + h) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                 int KH, float scale, float softcap, int causal, int window) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = D + 8;           // padded row stride (elements)
  constexpr int NT = MMA_BK / 8;      // score n-tiles per warp
  constexpr int DT = D / 8;           // output n-tiles per warp
  extern __shared__ __align__(16) __nv_bfloat16 tiles[];
  __nv_bfloat16* Qs = tiles;
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + MMA_BK * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / (H / KH);
  const int row0 = q0 + warp * 16 + (lane >> 2);   // and row0 + 8
  const int quad = 2 * (lane & 3);

  load_tile<D>(Qs, q, b, Sq, H, h, q0);

  const int nk = (Sk + MMA_BK - 1) / MMA_BK;
  int kt_end = nk;
  if (causal) {
    kt_end = min(kt_end, (q0 + BQ - 1) / MMA_BK + 1);
  } else if (window > 0) {
    kt_end = min(kt_end, (q0 + BQ - 1 + window - 1) / MMA_BK + 1);
  }
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / MMA_BK;

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // ldmatrix row addresses: A (Q) and trans-B (V) walk rows lane % 16,
  // B (K) walks keys lane % 8 + 8 (lane / 16)
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * MMA_BK;
    __syncthreads();   // Qs written / the previous tile's reads finished
    load_tile<D>(Ks, k, b, Sk, KH, kh, k0);
    load_tile<D>(Vs, v, b, Sk, KH, kh, k0);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Qs + a_row * LD + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, Ks + (np * 16 + k_row) * LD + kk * 16 + k_col);
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    float rmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = row0 + (e >> 1) * 8, kp = k0 + n * 8 + quad + (e & 1);
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = qp < Sq && kp < Sk;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) {
          ok = ok && qp - kp < window;
          if (!causal) ok = ok && kp - qp < window;
        }
        s[n][e] = ok ? x : NEG_INF;
        rmax[e >> 1] = fmaxf(rmax[e >> 1], s[n][e]);
      }
    }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(FULL, rmax[i], 1));
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(FULL, rmax[i], 2));
      const float m_new = fmaxf(m[i], rmax[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        rsum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(FULL, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(FULL, rsum[i], 2);
      l[i] = l[i] * corr[i] + rsum[i];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

#pragma unroll
    for (int j = 0; j < MMA_BK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, Vs + (j * 16 + v_row) * LD + dp * 16 + v_col);
        mma_bf16(o[2 * dp], a, bb[0], bb[1]);
        mma_bf16(o[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row0 + i * 8;
    if (qp >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = out + (((int64_t)b * Sq + qp) * H + h) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + quad) =
          __floats2bfloat162_rn(o[n][2 * i] / den, o[n][2 * i + 1] / den);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int H, int KH, float scale, float softcap,
               int causal, int window, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * H));
  flash_mma_kernel<D><<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Sk, H, KH, scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KH, float scale, float softcap,
           int causal, int window, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return launch_mma<D>(q, k, v, out, B, Sq, Sk, H, KH, scale, softcap,
                         causal, window, stream);
  } else {
    constexpr int bytes = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * H));
    flash_kernel<D, T><<<grid, THREADS, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KH, scale,
        softcap, causal, window);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int H, int KH, int D, float scale, float softcap,
             int causal, int window, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, T>(q, k, v, out, B, Sq, Sk, H, KH, scale,
                                  softcap, causal, window, s);
    case 32: return launch<32, T>(q, k, v, out, B, Sq, Sk, H, KH, scale,
                                  softcap, causal, window, s);
    case 64: return launch<64, T>(q, k, v, out, B, Sq, Sk, H, KH, scale,
                                  softcap, causal, window, s);
    case 128: return launch<128, T>(q, k, v, out, B, Sq, Sk, H, KH, scale,
                                    softcap, causal, window, s);
    case 256: return launch<256, T>(q, k, v, out, B, Sq, Sk, H, KH, scale,
                                    softcap, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: contiguous (B, Sq, H, D); k, v: contiguous (B, Sk, KH, D), all of
// the type `bf16` names (1: bf16, 0: f32). D in {16, 32, 64, 128, 256},
// H % KH == 0. window 0 means no window; softcap 0 means none. Returns the
// first CUDA error of the attribute call or the launch (0 on success).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int B, int Sq, int Sk, int H,
                                  int KH, int D, float scale, float softcap,
                                  int causal, int window, int bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KH, D, scale,
                                   softcap, causal, window, s);
  return dispatch<float>(q, k, v, out, B, Sq, Sk, H, KH, D, scale, softcap,
                         causal, window, s);
}
