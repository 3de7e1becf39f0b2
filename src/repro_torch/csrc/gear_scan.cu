// K1: gear-hash CDC candidate scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/core/cdc_scan.py::_pallas_scan_expr
// (the inner `kernel`, pallas_call at cdc_scan.py:328).
//
// What it computes (byte-identical to the Pallas kernel and to the port's
// plain version, repro_torch.core.cdc_scan.gear_scan_plain): for every
// position i of the padded stream `in` (n bytes, n a multiple of
// PALLAS_BLOCK), the 64-byte window sum w[i] = sum GEAR[in[q]], q = i-63..i,
// mod 2^32, and the mask byte ((w & ms & ml) == 0) + ((w & ms) == 0), i.e.
// 0, 1 (loose) or 2 (strict). Positions below the first window read the
// tail of the first PALLAS_BLOCK as their halo, exactly as the Pallas
// kernel's program 0 reads its own block; extraction discards them.
//
// What bounds it on the H100: memory. It reads each byte once and writes
// one mask byte per position (2n bytes); the arithmetic is three 1 KB-table
// lookups and a few integer ops per byte.
//
// Design: the 1 KB gear table sits in shared memory. Each thread owns a
// strip of 64 consecutive positions: it loads the strip and the 64 bytes in
// front of it with four 16-byte loads each (the bytes in front are the
// neighbouring thread's strip, so they come from L1), sums the window that
// ends just before its strip, then slides w += G[enter] - G[leave] through
// the strip in registers; uint32 wraps natively, which is the modulus. The
// 64 mask bytes leave as four 16-byte stores. Offsets are 64-bit: payloads
// reach 1.2 GB, close to 2^31.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WINDOW = 64;
constexpr int64_t PALLAS_BLOCK = 64 << 10;
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t byte_at(const uint32_t (&w)[16], int i) {
  return (w[i >> 2] >> ((i & 3) * 8)) & 0xFFu;
}

__device__ __forceinline__ void load64(const uint8_t* p, uint32_t (&w)[16]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint4 v = q[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
}

__global__ void __launch_bounds__(THREADS)
gear_scan_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 const uint32_t* __restrict__ gear, int64_t n_strips,
                 uint32_t ms, uint32_t ml) {
  __shared__ uint32_t g[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) g[i] = gear[i];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       s < n_strips; s += stride) {
    const int64_t p0 = s * WINDOW;
    const int64_t lead = (s == 0) ? (PALLAS_BLOCK - WINDOW) : (p0 - WINDOW);
    uint32_t prev[16], cur[16], o[16];
    load64(in + lead, prev);
    load64(in + p0, cur);
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < WINDOW; ++i) w += g[byte_at(prev, i)];
#pragma unroll
    for (int k = 0; k < 16; ++k) o[k] = 0;
#pragma unroll
    for (int i = 0; i < WINDOW; ++i) {
      w += g[byte_at(cur, i)] - g[byte_at(prev, i)];
      const uint32_t h = w & ms;
      const uint32_t m = ((h & ml) == 0u) + (h == 0u);
      o[i >> 2] |= m << ((i & 3) * 8);
    }
    uint4* q = reinterpret_cast<uint4*>(out + p0);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      q[k] = make_uint4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
  }
}

}  // namespace

// in/out: device pointers, 16-byte aligned, n bytes each (n a positive
// multiple of PALLAS_BLOCK); gear: 256 uint32 on the device.
extern "C" int rt_gear_scan(const void* in, void* out, const void* gear,
                            int64_t n, uint32_t ms, uint32_t ml,
                            void* stream) {
  const int64_t n_strips = n / WINDOW;
  int64_t blocks = (n_strips + THREADS - 1) / THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;
  gear_scan_kernel<<<(unsigned)blocks, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint32_t*>(gear), n_strips, ms, ml);
  return (int)cudaGetLastError();
}
