// K7: fused RMSNorm over rows, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rmsnorm/kernel.py::rmsnorm_rows (body `_kernel`,
// pallas_call at kernel.py:35).
//
// What it computes (the gemma convention of models/layers.py::rmsnorm):
// for every row x of an (N, D) matrix, in float32,
//   y = x * rsqrt(mean(x * x) + eps) * (1 + scale)
// rounded once to the output type (bf16 or f32, the input's type). `scale`
// is a (D,) vector in bf16 or f32, widened to f32 exactly.
//
// What bounds it on the H100: memory. Each input byte is read once and each
// output byte written once ((2·N·D + D)·itemsize bytes); the work per
// element is three FMAs.
//
// Design: one CUDA block of 128 threads per row (a grid-stride loop over
// rows). Each thread sums the squares of the elements d = tid, tid + 128,
// ... in f32; the 32 lanes of a warp combine with shuffles (a fixed tree)
// and the four warp sums are added in a fixed order from shared memory, so
// the result does not depend on scheduling: no atomics. The row is then
// read again (from L1/L2: at D <= 8192 it is at most 32 KB) to write the
// output. The path's widths are D = 1152 (block norms) and D = 256 (q/k
// norms).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
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

template <typename T, typename S>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int64_t n_rows, int64_t d, float eps) {
  __shared__ float warp_sum[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int64_t row = blockIdx.x; row < n_rows; row += gridDim.x) {
    const T* xr = x + row * d;
    float ss = 0.f;
    for (int64_t i = tid; i < d; i += THREADS) {
      const float v = to_f32(xr[i]);
      ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL, ss, o);
    if (lane == 0) warp_sum[warp] = ss;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sum[w];
    const float r = rsqrtf(total / (float)d + eps);
    T* orow = out + row * d;
    for (int64_t i = tid; i < d; i += THREADS) {
      const float y = to_f32(xr[i]) * r;
      orow[i] = from_f32<T>(y * (1.0f + to_f32(scale[i])));
    }
    __syncthreads();   // warp_sum is reused by the next row
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, int64_t n_rows,
           int64_t d, float eps, cudaStream_t stream) {
  int64_t blocks = n_rows < 1 ? 1 : n_rows;
  if (blocks > 132 * 64) blocks = 132 * 64;
  rmsnorm_kernel<T, S><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), n_rows, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: device pointers to contiguous (n_rows, d) matrices of the type
// `x_bf16` names (1: bf16, 0: f32); scale: (d,) of the type `scale_bf16`
// names. Returns cudaGetLastError() after the launch.
extern "C" int rt_rmsnorm(const void* x, const void* scale, void* out,
                          int64_t n_rows, int64_t d, float eps, int x_bf16,
                          int scale_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return scale_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, n_rows, d, eps, s)
        : launch<__nv_bfloat16, float>(x, scale, out, n_rows, d, eps, s);
  }
  return scale_bf16
      ? launch<float, __nv_bfloat16>(x, scale, out, n_rows, d, eps, s)
      : launch<float, float>(x, scale, out, n_rows, d, eps, s);
}
