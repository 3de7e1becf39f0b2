// K5 and K6: the int8 checkpoint codec's block quantizer and dequantizer,
// hand-written for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels
// src/repro/kernels/ckpt_codec/kernel.py::quantize_blocks_2d (`_q_kernel`,
// pallas_call at kernel.py:42) and ::dequantize_blocks_2d (`_dq_kernel`,
// pallas_call at kernel.py:73), with the padding glue of
// src/repro/kernels/ckpt_codec/ops.py (quantize_blocks, dequantize_blocks).
//
// What they compute, bit-exact with the numpy oracle
// repro_torch.core.codec.quantize_int8 / decode (and the port's plain
// versions in repro_torch.kernels.ckpt_codec.int8_codec):
//   K5: the input (bf16 or f32, n elements, zero-padded to a multiple of
//       256) in blocks of 256: scale = amax / 127 in f32 (1.0 for an
//       all-zero block), q = clip(round_half_even(x / scale), -127, 127)
//       as int8; outputs q (n rounded up to 256 bytes) and the f32 scales.
//   K6: x = float(q) * scale in f32, then the output dtype: f32 as it is,
//       bf16 rounded to nearest even. Writes the first n elements.
// Bit-exactness rests on IEEE division (__fdiv_rn: x / scale, never
// x * (1 / scale)), rintf (half to even, as np.round), and no fast-math
// flags: this file is compiled without --use_fast_math, so denormals are
// kept as numpy keeps them. Inputs are finite (NaN and inf blocks are
// outside the oracle's contract too).
//
// What bounds them on the H100: memory. K5 reads itemsize bytes and writes
// 1 byte per element plus 4 bytes per block; K6 the reverse.
//
// Design: one warp per 256-element block. Lane l handles elements
// l + 32 j (j < 8), so every load and store instruction of the warp touches
// 32 consecutive elements (coalesced, no alignment needs); the block's amax
// is a 5-step shuffle reduction, so the scale is known to every lane
// without shared memory. Eight warps (eight blocks) per CTA.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int PER_LANE = BLOCK / 32;
constexpr int WARPS = 8;

__device__ __forceinline__ float load_x(const void* x, int64_t i, int bf16) {
  if (bf16) {
    const uint32_t b = reinterpret_cast<const uint16_t*>(x)[i];
    return __uint_as_float(b << 16);
  }
  return reinterpret_cast<const float*>(x)[i];
}

__global__ void __launch_bounds__(WARPS * 32)
quantize_kernel(const void* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, int64_t n, int64_t nb, int bf16) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= nb) return;
  const int64_t base = b * BLOCK;
  float v[PER_LANE];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int64_t i = base + lane + 32 * j;
    v[j] = i < n ? load_x(x, i, bf16) : 0.0f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    float r = rintf(__fdiv_rn(v[j], scale));
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    q[base + lane + 32 * j] = (int8_t)r;
  }
  if (lane == 0) scales[b] = scale;
}

__global__ void __launch_bounds__(WARPS * 32)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, void* __restrict__ out,
                  int64_t n, int64_t nb, int bf16) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= nb) return;
  const int64_t base = b * BLOCK;
  const float s = scales[b];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int64_t i = base + lane + 32 * j;
    if (i >= n) break;
    const float y = __fmul_rn((float)q[i], s);
    if (bf16)
      reinterpret_cast<uint16_t*>(out)[i] =
          __bfloat16_as_ushort(__float2bfloat16_rn(y));
    else
      reinterpret_cast<float*>(out)[i] = y;
  }
}

int grid(int64_t nb) { return (int)((nb + WARPS - 1) / WARPS); }

}  // namespace

// x: n elements (bf16 if `bf16`, else f32); q: ceil(n/256)*256 int8;
// scales: ceil(n/256) f32. Returns cudaGetLastError().
extern "C" int rt_quantize_blocks(const void* x, void* q, void* scales,
                                  int64_t n, int bf16, void* stream) {
  const int64_t nb = (n + BLOCK - 1) / BLOCK;
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  quantize_kernel<<<grid(nb), WARPS * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<int8_t*>(q), static_cast<float*>(scales), n, nb, bf16);
  return (int)cudaGetLastError();
}

// q: ceil(n/256)*256 int8; scales: ceil(n/256) f32; out: n elements (bf16
// if `bf16`, else f32). Returns cudaGetLastError().
extern "C" int rt_dequantize_blocks(const void* q, const void* scales,
                                    void* out, int64_t n, int bf16,
                                    void* stream) {
  const int64_t nb = (n + BLOCK - 1) / BLOCK;
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  dequantize_kernel<<<grid(nb), WARPS * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales), out,
      n, nb, bf16);
  return (int)cudaGetLastError();
}
