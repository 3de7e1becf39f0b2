// K7: fused RMSNorm over rows, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rmsnorm/kernel.py::rmsnorm_rows (body `_kernel` at
// kernel.py:16, pallas_call at kernel.py:32).
//
// What it computes (the gemma convention of models/layers.py::rmsnorm):
// for every row x of an (N, D) matrix, in float32,
//   y = x * rsqrt(mean(x * x) + eps) * (1 + scale)
// rounded once to the output type (bf16 or f32, the input's type). `scale`
// is a (D,) vector in bf16 or f32, widened to f32 exactly.
//
// What bounds it on the H100: memory. Each input byte is read once and each
// output byte written once ((2·N·D + D)·itemsize bytes); the work per
// element is three float operations. At 3.35 TB/s and ~0.8 us of latency an
// SM needs ~20 KB in flight to keep its share of the bandwidth busy.
//
// Three routes; the wrapper (kernels/rmsnorm/ops.py::launch_plan) picks one
// and passes its launch plan (rows a stage or a warp, stages, warps, grid,
// shared memory). Measured on an H100 (PERF.md §6), the warp route is the
// fastest for rows of 2 KB and more (the block norms at D 1,152) and for
// up to 4,096 rows (decode, the training step's k norm); the stream route
// for many shorter rows (the prefill's q and k norms at D 256).
//
//  1. stream (D·itemsize a multiple of 16 B, 16-byte aligned pointers). A
//     persistent grid of one or two CTAs an SM walks blocks of R
//     contiguous rows (block b, b + grid, ...). One producer thread fills
//     a ring of 2-8 stages in dynamic shared memory, each stage one 1-D bulk
//     copy (`cp.async.bulk`, L2 evict_first: every byte is read once)
//     completing on the stage's `full` mbarrier. Each consumer warp owns R /
//     warps contiguous rows of a stage: it reads them with 16-byte
//     `ld.shared`, writes y back in place, and sends its rows out with one
//     bulk store (`cp.async.bulk.global.shared::cta`). It releases the
//     stage (an arrive on its `empty` mbarrier) once that store has read
//     it, one stage later (`cp.async.bulk.wait_group.read 1`), so the store
//     overlaps the next stage's work. The consumers widen the scale to f32,
//     as 1 + scale, once per CTA into shared memory while the first loads
//     are in flight. No barrier of the whole block after the mbarriers'
//     initialisation, no atomics.
//  2. warp (the same conditions). One warp a row, on a grid of one-warp
//     CTAs (one row each); 16-byte `__ldg` of the row and its scale
//     straight into registers (a row of up to 160 vectors, 2.5 KB, stays
//     there, loaded in one round trip; a longer one is read again for the
//     output), no shared memory, no barrier.
//  3. scalar (any D and alignment: D·itemsize not a multiple of 16 B, or a
//     view at an odd offset). One warp a row, one element a lane at a time.
//
// Reduction order, the same in routes 1 and 2 so that a row's output is bit
// for bit the same whichever of them (and whatever row count) computes it:
// the row is a sequence of 16-byte vectors (8 bf16 or 4 f32); lane l sums
// the squares of vectors l, l + 32, l + 64, ... in ascending order, the
// elements of a vector in ascending order, one fmaf each, from 0; the 32
// lane sums are then combined by a fixed __shfl_xor butterfly (16, 8, 4, 2,
// 1), after which every lane holds the same total. Route 3 does the same
// with single elements in place of vectors (lane l: elements l, l + 32,
// ...). Then r = rsqrtf(total / D + eps) and y = (x * r) * (1 + scale), each
// product rounded to f32, then once to the output type.
#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_STAGES = 8;        // 2·MAX_STAGES mbarriers fit in 128 B
constexpr int MAX_WARPS = 8;         // consumer warps of a stream CTA
constexpr int BAR_BYTES = 128;
// 16-byte vectors a lane holds (route 2): a D 1,152 bf16 row needs 5; more
// registers cost resident warps (8 held: 98 registers, 8% slower there)
constexpr int HELD = 5;
constexpr int SMEM_LIMIT = 232448;   // a CTA's dynamic shared memory, sm_90

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

// elements of T in one 16-byte vector
template <typename T> struct Vec {
  static constexpr int N = 16 / (int)sizeof(T);
};

// a 16-byte vector of T → N floats, element 0 first (exact)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u,
                                       float (&f)[Vec<T>::N]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

// N floats → a 16-byte vector of T, each rounded to nearest even
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[Vec<T>::N]) {
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(f[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int N>
__device__ __forceinline__ void add_squares(const float (&f)[N], float& ss) {
#pragma unroll
  for (int i = 0; i < N; ++i) ss = fmaf(f[i], f[i], ss);
}

// the fixed butterfly: every lane ends with the same total
__device__ __forceinline__ float warp_total(float ss) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL, ss, o);
  return ss;
}

__device__ __forceinline__ float inv_rms(float total, int d, float eps) {
  return rsqrtf(total / (float)d + eps);
}

__device__ __forceinline__ float norm_out(float x, float r, float w) {
  return __fmul_rn(__fmul_rn(x, r), w);
}

// the scale's bytes for the N elements of x's vector `v` (N·sizeof(S)
// bytes at a 16-byte aligned pointer: one or two 16-byte loads, or one of
// 8 bytes)
template <typename T, typename S>
struct ScaleVec {
  static constexpr int BYTES = Vec<T>::N * (int)sizeof(S);
  uint32_t raw[BYTES / 4];
};

template <typename T, typename S>
__device__ __forceinline__ void load_scale(const S* __restrict__ scale,
                                           int v, ScaleVec<T, S>& sv) {
  constexpr int SB = ScaleVec<T, S>::BYTES;
  const char* p = reinterpret_cast<const char*>(scale) + (size_t)v * SB;
  if constexpr (SB >= 16) {
#pragma unroll
    for (int c = 0; c < SB / 16; ++c) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + c);
      sv.raw[4 * c] = u.x;
      sv.raw[4 * c + 1] = u.y;
      sv.raw[4 * c + 2] = u.z;
      sv.raw[4 * c + 3] = u.w;
    }
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    sv.raw[0] = u.x;
    sv.raw[1] = u.y;
  }
}

// 1 + scale, in f32, for the N elements of a vector
template <typename T, typename S>
__device__ __forceinline__ void widen_scale(const ScaleVec<T, S>& sv,
                                            float (&w)[Vec<T>::N]) {
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) {
    float s;
    if constexpr (sizeof(S) == 4) {
      s = __uint_as_float(sv.raw[i]);
    } else {
      s = __uint_as_float(i & 1 ? sv.raw[i / 2] & 0xFFFF0000u
                                : sv.raw[i / 2] << 16);
    }
    w[i] = __fadd_rn(1.0f, s);
  }
}

// ---------------------------------------------------------------------------
// PTX helpers: mbarriers and 1-D bulk copies
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// `bytes` (a multiple of 16) from global src to shared dst, completing on
// bar's transaction count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// all but the newest bulk group of this thread have read their source
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// every bulk group of this thread has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// route 1: stream
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int64_t align128(int64_t n) {
  return (n + 127) & ~int64_t{127};
}

// shared memory of a stream CTA: the mbarriers, 1 + scale in f32, the ring
inline int64_t stream_smem(int64_t d, int64_t row_bytes, int rows,
                           int stages) {
  return BAR_BYTES + align128(4 * d) + stages * align128(rows * row_bytes);
}

// y of one row held in shared memory, written back in place
template <typename T>
__device__ __forceinline__ void norm_row_shared(uint4* row, const float* w,
                                                int nvec, int d, float eps,
                                                int lane) {
  constexpr int N = Vec<T>::N;
  float ss = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    float f[N];
    unpack<T>(row[v], f);
    add_squares(f, ss);
  }
  const float r = inv_rms(warp_total(ss), d, eps);
  for (int v = lane; v < nvec; v += 32) {
    float f[N], wv[N];
    unpack<T>(row[v], f);
    const float4* wp = reinterpret_cast<const float4*>(w + v * N);
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 q = wp[c];
      wv[4 * c] = q.x;
      wv[4 * c + 1] = q.y;
      wv[4 * c + 2] = q.z;
      wv[4 * c + 3] = q.w;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = norm_out(f[i], r, wv[i]);
    row[v] = pack<T>(f);
  }
}

// blockDim.x = (warps + 1)·32: warps 0..warps-1 consume, warp `warps`
// produces. `rows` (R) is a multiple of `warps`.
template <typename T, typename S>
__global__ void __launch_bounds__((MAX_WARPS + 1) * 32)
rms_stream_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                  T* __restrict__ out, int64_t n_rows, int d, float eps,
                  int rows, int stages, int warps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row_bytes = (int64_t)d * sizeof(T);
  const int64_t stage_bytes = align128(rows * row_bytes);
  const uint32_t bars = smem_u32(smem);
  float* w = reinterpret_cast<float*>(smem + BAR_BYTES);
  unsigned char* ring = smem + BAR_BYTES + align128(4 * (int64_t)d);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MAX_STAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), warps);       // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int64_t n_blocks = (n_rows + rows - 1) / rows;
  if (warp == warps) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      const uint64_t pol = evict_first_policy();
      int i = 0;
      for (int64_t b = blockIdx.x; b < n_blocks; b += gridDim.x, ++i) {
        const int s = i % stages, use = i / stages;
        if (use > 0) mbar_wait(empty(s), (use - 1) & 1);
        const int64_t row0 = b * rows;
        const int64_t nb = n_rows - row0 < rows ? n_rows - row0 : rows;
        const uint32_t bytes = (uint32_t)(nb * row_bytes);
        mbar_expect_tx(full(s), bytes);
        bulk_load(smem_u32(ring + s * stage_bytes), x + row0 * d, bytes,
                  full(s), pol);
      }
    }
    return;
  }

  // ---- consumers: warp `warp` owns rows [first, first + k) of a stage ----
  // 1 + scale while the first loads are in flight (named barrier 1: the
  // consumer warps alone)
  for (int i = threadIdx.x; i < d; i += warps * 32)
    w[i] = __fadd_rn(1.0f, to_f32(scale[i]));
  asm volatile("bar.sync 1, %0;\n" ::"r"(warps * 32) : "memory");
  const int k = rows / warps, first = warp * k;
  const int nvec = (int)(row_bytes / 16);
  int i = 0;
  for (int64_t b = blockIdx.x; b < n_blocks; b += gridDim.x, ++i) {
    const int s = i % stages;
    mbar_wait(full(s), (i / stages) & 1);
    const int64_t row0 = b * rows;
    const int64_t nb = n_rows - row0 < rows ? n_rows - row0 : rows;
    const int cnt = (int)(nb - first < 0 ? 0 : (nb - first < k ? nb - first
                                                               : k));
    unsigned char* mine = ring + s * stage_bytes + first * row_bytes;
    for (int j = 0; j < cnt; ++j)
      norm_row_shared<T>(reinterpret_cast<uint4*>(mine + j * row_bytes), w,
                         nvec, d, eps, lane);
    // the rows written through the generic proxy, read by the bulk store
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      if (cnt > 0)
        bulk_store(out + (row0 + first) * d, smem_u32(mine),
                   (uint32_t)(cnt * row_bytes));
      bulk_commit();
      // the previous stage's store has read it: its slot may be refilled
      if (i > 0) {
        bulk_wait_read_all_but_one();
        mbar_arrive(empty((i - 1) % stages));
      }
    }
    __syncwarp();
  }
  if (lane == 0) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// route 2: warp (16-byte loads into registers)
// ---------------------------------------------------------------------------

// one warp a row; warps of a CTA: blockDim.x / 32; the grid walks the rows
// (row = global warp index, + all warps of the grid, ...)
template <typename T, typename S>
__global__ void __launch_bounds__(MAX_WARPS * 32)
rms_warp_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                T* __restrict__ out, int64_t n_rows, int d, float eps) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x & 31;
  const int wpc = blockDim.x >> 5;
  const int64_t step = (int64_t)gridDim.x * wpc;
  const int nvec = d / N;
  const bool held = nvec <= 32 * HELD;
  for (int64_t row = (int64_t)blockIdx.x * wpc + (threadIdx.x >> 5);
       row < n_rows; row += step) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
    uint4* orow = reinterpret_cast<uint4*>(out + row * d);
    uint4 v[HELD];
    ScaleVec<T, S> sv[HELD];
    float ss = 0.f;
    auto load = [&](int base) {
#pragma unroll
      for (int j = 0; j < HELD; ++j) {
        const int idx = base + lane + 32 * j;
        if (idx < nvec) v[j] = __ldg(xr + idx);
      }
    };
    auto load_w = [&](int base) {
#pragma unroll
      for (int j = 0; j < HELD; ++j) {
        const int idx = base + lane + 32 * j;
        if (idx < nvec) load_scale<T, S>(scale, idx, sv[j]);
      }
    };
    // a row held in registers: its scale is loaded with it, so that the
    // loads are one round trip
    if (held) load_w(0);
    for (int base = 0; base < nvec; base += 32 * HELD) {
      load(base);
#pragma unroll
      for (int j = 0; j < HELD; ++j) {
        if (base + lane + 32 * j < nvec) {
          float f[N];
          unpack<T>(v[j], f);
          add_squares(f, ss);
        }
      }
    }
    const float r = inv_rms(warp_total(ss), d, eps);
    for (int base = 0; base < nvec; base += 32 * HELD) {
      if (!held) {
        load(base);
        load_w(base);
      }
#pragma unroll
      for (int j = 0; j < HELD; ++j) {
        const int idx = base + lane + 32 * j;
        if (idx >= nvec) continue;
        float wv[N], f[N];
        widen_scale<T, S>(sv[j], wv);
        unpack<T>(v[j], f);
#pragma unroll
        for (int e = 0; e < N; ++e) f[e] = norm_out(f[e], r, wv[e]);
        orow[idx] = pack<T>(f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// route 3: scalar (any D, any alignment)
// ---------------------------------------------------------------------------

template <typename T, typename S>
__global__ void __launch_bounds__(MAX_WARPS * 32)
rms_scalar_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                  T* __restrict__ out, int64_t n_rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int wpc = blockDim.x >> 5;
  const int64_t step = (int64_t)gridDim.x * wpc;
  for (int64_t row = (int64_t)blockIdx.x * wpc + (threadIdx.x >> 5);
       row < n_rows; row += step) {
    const T* xr = x + row * d;
    float ss = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float f = to_f32(xr[i]);
      ss = fmaf(f, f, ss);
    }
    const float r = inv_rms(warp_total(ss), d, eps);
    T* orow = out + row * d;
    for (int i = lane; i < d; i += 32)
      orow[i] = from_f32<T>(norm_out(to_f32(xr[i]), r,
                                     __fadd_rn(1.0f, to_f32(scale[i]))));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// cudaFuncSetAttribute once per kernel and device, to the sm_90 limit
// (`done`: one bit a device, static in each instantiation)
template <typename Kernel>
int raise_smem_limit(Kernel kernel, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? (uint64_t{1} << dev) : 0;
  if (bit && (done.load() & bit)) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  done.fetch_or(bit);
  return 0;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, typename S>
int launch(const void* xp, const void* sp, void* op, int64_t n_rows, int d,
           float eps, int route, int rows, int stages, int warps, int grid,
           int smem, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  const S* scale = static_cast<const S*>(sp);
  T* out = static_cast<T*>(op);
  const int64_t row_bytes = (int64_t)d * sizeof(T);
  if (grid < 1 || warps < 1 || warps > MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  // routes 1 and 2 read 16-byte vectors of x, out and scale
  if (route != 3 && (row_bytes % 16 || !aligned16(x) || !aligned16(out) ||
                     !aligned16(scale)))
    return (int)cudaErrorMisalignedAddress;
  if (route == 1) {
    if (stages < 2 || stages > MAX_STAGES || rows < warps || rows % warps ||
        rows * row_bytes >= (1 << 20) ||
        smem != stream_smem(d, row_bytes, rows, stages) ||
        smem > SMEM_LIMIT)
      return (int)cudaErrorInvalidValue;
    static std::atomic<uint64_t> done{0};
    const int err = raise_smem_limit(rms_stream_kernel<T, S>, done);
    if (err) return err;
    rms_stream_kernel<T, S><<<grid, (warps + 1) * 32, smem, stream>>>(
        x, scale, out, n_rows, d, eps, rows, stages, warps);
  } else if (route == 2) {
    rms_warp_kernel<T, S><<<grid, warps * 32, 0, stream>>>(
        x, scale, out, n_rows, d, eps);
  } else if (route == 3) {
    rms_scalar_kernel<T, S><<<grid, warps * 32, 0, stream>>>(
        x, scale, out, n_rows, d, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: device pointers to contiguous (n_rows, d) matrices of the type
// `x_bf16` names (1: bf16, 0: f32); scale: (d,) of the type `scale_bf16`
// names. route 1 stream, 2 warp, 3 scalar; rows: rows a stage (route 1;
// the other routes take one row a warp); stages: the ring's stages
// (route 1); warps: consumer warps a CTA (route 1; a producer warp is
// added) or warps a CTA; grid: CTAs; smem: dynamic shared memory bytes a
// CTA (route 1, as stream_smem gives it). Returns cudaGetLastError() after
// the launch, or a cudaError of its own for a plan it refuses.
extern "C" int rt_rmsnorm(const void* x, const void* scale, void* out,
                          int64_t n_rows, int64_t d, float eps, int x_bf16,
                          int scale_bf16, int route, int rows, int stages,
                          int warps, int grid, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > (int64_t{1} << 30)) return (int)cudaErrorInvalidValue;
  const int di = (int)d;
  if (x_bf16) {
    return scale_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, n_rows, di, eps,
                                               route, rows, stages, warps,
                                               grid, smem, s)
        : launch<__nv_bfloat16, float>(x, scale, out, n_rows, di, eps, route,
                                       rows, stages, warps, grid, smem, s);
  }
  return scale_bf16
      ? launch<float, __nv_bfloat16>(x, scale, out, n_rows, di, eps, route,
                                     rows, stages, warps, grid, smem, s)
      : launch<float, float>(x, scale, out, n_rows, di, eps, route, rows,
                             stages, warps, grid, smem, s);
}
