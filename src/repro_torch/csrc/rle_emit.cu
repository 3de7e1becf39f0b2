// K3: plane RLE emission pass, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ckpt_codec/entropy.py::_rle_emission_pallas (body
// `_rle_kernel`, pallas_call at entropy.py:92).
//
// What it computes (byte-identical to the Pallas kernel and to the port's
// plain version repro_torch.kernels.ckpt_codec.entropy.rle_emission_plain):
// for every 4096-byte plane block b of the zero-padded block matrix x[nb, B]
// and every position i, with seg_start = the last position <= i where a run
// starts (a byte differs from its left neighbour, or i == 0) and
// pos = i - seg_start:
//   emit[b, i] = run ends at i (i == B-1, x[i+1] != x[i], or
//                i == n-1-b*B, the end of a partial last block)
//                or pos % 255 == 254 (runs are capped at 255);
//   run[b, i]  = pos % 255 + 1.
// Runs never cross a block, so blocks are independent: no halo.
//
// What bounds it on the H100: memory. It reads each byte once and writes
// two bytes per position (3n bytes); the work per byte is a compare and a
// max.
//
// Design: one CUDA block of 256 threads per plane block; each thread owns
// 16 consecutive positions, loaded with one 16-byte load into shared memory.
// seg_start is a running max of run-start positions, computed as a
// block-wide max-scan: each thread reduces its 16 positions, a warp-shuffle
// inclusive scan combines lanes, shared memory combines the 8 warps, and a
// second pass over the 16 positions emits. A per-position backward walk
// would be quadratic on constant blocks, and the state has many of those.
// emit and run leave as one 16-byte store each.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int B = 4096;
constexpr int THREADS = 256;
constexpr int PER = B / THREADS;   // 16 positions per thread
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(THREADS)
rle_emit_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ emit,
                uint8_t* __restrict__ run, int64_t nb, int64_t n) {
  __shared__ __align__(16) uint8_t row[B + 16];
  __shared__ int warp_max[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = tid * PER;
  for (int64_t b = blockIdx.x; b < nb; b += gridDim.x) {
    const int64_t off = b * B;
    reinterpret_cast<uint4*>(row)[tid] =
        reinterpret_cast<const uint4*>(x + off)[tid];
    __syncthreads();
    // this thread's last run start (0 if none: position 0 always starts)
    int local = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int p = base + i;
      if (p == 0 || row[p] != row[p - 1]) local = p;
    }
    int incl = local;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl = max(incl, y);
    }
    int excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 0;
    if (lane == 31) warp_max[warp] = incl;
    __syncthreads();
    int seg = excl;
    for (int w = 0; w < warp; ++w) seg = max(seg, warp_max[w]);
    const int64_t last = n - 1 - off;    // end of a partial last block
    uint32_t e[PER / 4] = {0, 0, 0, 0}, r[PER / 4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int p = base + i;
      if (p == 0 || row[p] != row[p - 1]) seg = p;
      const int pos = p - seg;
      const bool end = (p == B - 1) || (row[p + 1] != row[p]) ||
                       ((int64_t)p == last);
      const uint32_t em = (end || pos % 255 == 254) ? 1u : 0u;
      const uint32_t rl = (uint32_t)(pos % 255 + 1) & 0xFFu;
      e[i >> 2] |= em << ((i & 3) * 8);
      r[i >> 2] |= rl << ((i & 3) * 8);
    }
    reinterpret_cast<uint4*>(emit + off)[tid] = make_uint4(e[0], e[1], e[2], e[3]);
    reinterpret_cast<uint4*>(run + off)[tid] = make_uint4(r[0], r[1], r[2], r[3]);
    __syncthreads();   // row and warp_max are reused by the next block
  }
}

}  // namespace

// x: device pointer to the [nb, 4096] zero-padded block matrix (16-byte
// aligned); emit/run: [nb, 4096] outputs (emit is 0/1 bytes); n: the
// stream's real length (the last block ends at n - 1 - (nb-1)*4096).
extern "C" int rt_rle_emit(const void* x, void* emit, void* run, int64_t nb,
                           int64_t n, void* stream) {
  int64_t blocks = nb < 1 ? 1 : nb;
  if (blocks > 132 * 512) blocks = 132 * 512;
  rle_emit_kernel<<<(unsigned)blocks, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(emit),
      static_cast<uint8_t*>(run), nb, n);
  return (int)cudaGetLastError();
}
