// K4: byteplane inverse transform, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ckpt_codec/byteplane.py::inverse_planes_2d (`_inv_kernel`,
// pallas_call at byteplane.py:132) together with the XLA glue of
// inverse_pallas (the transpose back to element order and the ragged tail).
//
// What it computes (byte-identical to the numpy oracle
// repro_torch.core.codec.byteplane_inverse and to the port's plain version
// repro_torch.kernels.ckpt_codec.byteplane.inverse_plain): the n-byte stream
// holds K delta planes of ne = n / K bytes (plane p at p*ne); element e,
// byte p of the output is the sum of plane p's bytes 0..e mod 256, stored in
// element order at e*K + p; the n - ne*K tail bytes are copied unchanged.
//
// What bounds it on the H100: memory. The function reads n bytes and writes
// n bytes (bound 2n over 3.35 TB/s); this design reads the input twice (3n).
//
// Design: the Pallas kernel runs one program per plane and carries the sum
// down the plane sequentially; with K = 2 that would be two CTAs for a
// 604 MB leaf. Addition mod 256 is associative, so the plane scan is split
// over tiles of TILE elements, in three launches:
//   1. tile_sums: one CTA per (tile, plane) sums its TILE bytes (each thread
//      16 consecutive bytes, one 16-byte load, a block reduction) into a
//      small scratch array;
//   2. tile_scan: one CTA per plane turns the tile sums into exclusive
//      prefixes in place (each thread walks a contiguous run of tiles, a
//      block scan joins the runs);
//   3. tile_inverse: one CTA per tile owns its TILE elements across all K
//      planes; each thread owns 16 consecutive elements. For each plane the
//      thread loads its 16 bytes (one 16-byte load), scans them, and a block
//      scan adds the other threads' totals and the tile's prefix; the bytes
//      are packed in registers at e*K + p, so after the last plane the
//      thread holds its 16*K contiguous output bytes and writes them with K
//      16-byte stores (the transpose costs no shared memory and no strided
//      byte store). Block 0 also copies the ragged tail.
// Byte loads and stores take over where 16-byte alignment does not hold
// (a plane length that is not a multiple of 16, the last tile). 64-bit
// offsets throughout; K in 1..8, a template parameter.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr int TILE = THREADS * PER_THREAD;   // elements per tile
constexpr int MAX_K = 8;
constexpr int SCAN_THREADS = 1024;

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Exclusive scan of one value per thread over a block of NT threads (sums
// in 32 bits; callers keep the low byte). `ws` holds NT/32 + 1 words; the
// block total is returned in *total. Every thread of the block must call.
template <int NT>
__device__ __forceinline__ uint32_t block_excl_scan(uint32_t v, uint32_t* ws,
                                                    uint32_t* total) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t incl = warp_incl_scan(v);
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < NW ? ws[lane] : 0u;
    const uint32_t wi = warp_incl_scan(w);
    if (lane < NW) ws[lane] = wi - w;
    if (lane == NW - 1) ws[NW] = wi;
  }
  __syncthreads();
  const uint32_t excl = ws[warp] + incl - v;
  *total = ws[NW];
  __syncthreads();            // ws is reused by the caller's next scan
  return excl;
}

__device__ __forceinline__ uint32_t byte_sum(uint32_t w) {
  return __vsadu4(w, 0u);
}

// the 16 bytes at p (16-byte aligned when `vec`), as four words; bytes at
// or past `cnt` read as 0
__device__ __forceinline__ void load16(const uint8_t* p, int cnt, bool vec,
                                       uint32_t w[4]) {
  if (vec && cnt == PER_THREAD) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = 0u;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i)
    if (i < cnt) w[i >> 2] |= (uint32_t)p[i] << (8 * (i & 3));
}

// elements of thread `t`'s run of 16 in tile `tile` that lie below ne
__device__ __forceinline__ int run_count(int64_t tile, int64_t ne) {
  const int64_t left = ne - (tile * TILE + (int64_t)threadIdx.x * PER_THREAD);
  return left >= PER_THREAD ? PER_THREAD : (left > 0 ? (int)left : 0);
}

// 1. sums[p * ntiles + t] = sum of plane p's bytes in tile t (mod 256)
__global__ void __launch_bounds__(THREADS)
tile_sums(const uint8_t* __restrict__ d, uint8_t* __restrict__ sums,
          int64_t ne, int64_t ntiles, bool vec) {
  __shared__ uint32_t ws[THREADS / 32 + 1];
  const int64_t tile = blockIdx.x;
  const int p = blockIdx.y;
  const int cnt = run_count(tile, ne);
  uint32_t w[4];
  load16(d + (int64_t)p * ne + tile * TILE +
             (int64_t)threadIdx.x * PER_THREAD, cnt, vec, w);
  const uint32_t acc = byte_sum(w[0]) + byte_sum(w[1]) + byte_sum(w[2]) +
                       byte_sum(w[3]);
  uint32_t total;
  block_excl_scan<THREADS>(acc, ws, &total);
  if (threadIdx.x == 0) sums[(int64_t)p * ntiles + tile] = (uint8_t)total;
}

// 2. per plane: tile sums → exclusive tile prefixes, in place
__global__ void __launch_bounds__(SCAN_THREADS)
tile_scan(uint8_t* __restrict__ sums, int64_t ntiles) {
  __shared__ uint32_t ws[SCAN_THREADS / 32 + 1];
  uint8_t* s = sums + (int64_t)blockIdx.x * ntiles;
  const int64_t per = (ntiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const int64_t lo = (int64_t)threadIdx.x * per;
  const int64_t hi = lo + per < ntiles ? lo + per : ntiles;
  uint32_t acc = 0;
  for (int64_t i = lo; i < hi; ++i) acc += s[i];
  uint32_t total;
  uint32_t run = block_excl_scan<SCAN_THREADS>(acc, ws, &total);
  for (int64_t i = lo; i < hi; ++i) {
    const uint8_t x = s[i];
    s[i] = (uint8_t)run;
    run += x;
  }
}

// 3. one CTA per tile: inclusive scan of every plane with its carry, the
//    transpose in registers, 16-byte stores
template <int K>
__global__ void __launch_bounds__(THREADS)
tile_inverse(const uint8_t* __restrict__ d, uint8_t* __restrict__ out,
             const uint8_t* __restrict__ prefix, int64_t ne, int64_t n,
             int64_t ntiles, bool vec_in, bool vec_out) {
  __shared__ uint32_t ws[THREADS / 32 + 1];
  const int64_t tile = blockIdx.x;
  const int64_t e0 = tile * TILE + (int64_t)threadIdx.x * PER_THREAD;
  const int cnt = run_count(tile, ne);
  if (ne > 0) {                   // block-uniform
    uint32_t ow[4 * K];
#pragma unroll
    for (int j = 0; j < 4 * K; ++j) ow[j] = 0u;
#pragma unroll
    for (int p = 0; p < K; ++p) {
      uint32_t w[4];
      load16(d + (int64_t)p * ne + e0, cnt, vec_in, w);
      uint32_t c[PER_THREAD];
      uint32_t run = 0;
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        run += (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
        c[i] = run;
      }
      uint32_t total;
      const uint32_t excl = block_excl_scan<THREADS>(run, ws, &total);
      const uint32_t carry = excl + prefix[(int64_t)p * ntiles + tile];
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        const int b = i * K + p;
        ow[b >> 2] |= ((carry + c[i]) & 0xFFu) << (8 * (b & 3));
      }
    }
    uint8_t* dst = out + e0 * K;
    if (vec_out && cnt == PER_THREAD) {
#pragma unroll
      for (int j = 0; j < K; ++j)
        reinterpret_cast<uint4*>(dst)[j] =
            make_uint4(ow[4 * j], ow[4 * j + 1], ow[4 * j + 2], ow[4 * j + 3]);
    } else {
#pragma unroll
      for (int b = 0; b < PER_THREAD * K; ++b)
        if (b < cnt * K) dst[b] = (uint8_t)(ow[b >> 2] >> (8 * (b & 3)));
    }
  }
  const int64_t tail = n - ne * K;
  if (tile == 0 && threadIdx.x < tail)
    out[ne * K + threadIdx.x] = d[ne * K + threadIdx.x];
}

template <int K>
void launch_inverse(const uint8_t* d, uint8_t* o, const uint8_t* sums,
                    int64_t ne, int64_t n, int64_t ntiles, bool vec_in,
                    bool vec_out, cudaStream_t s) {
  const int64_t blocks = ntiles > 0 ? ntiles : 1;
  tile_inverse<K><<<(unsigned)blocks, THREADS, 0, s>>>(
      d, o, sums, ne, n, ntiles, vec_in, vec_out);
}

}  // namespace

// in/out: device pointers, n bytes each; scratch:
// a device buffer of at least itemsize * ceil((n / itemsize) / 4096) bytes;
// itemsize in 1..8. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for another itemsize or a short scratch buffer.
extern "C" int rt_byteplane_inv(const void* in, void* out, void* scratch,
                                int64_t n, int64_t itemsize,
                                int64_t scratch_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = (int)itemsize;
  if (itemsize < 1 || itemsize > MAX_K || n < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t ne = n / k;
  const int64_t ntiles = (ne + TILE - 1) / TILE;
  if (scratch_bytes < ntiles * k) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const uint8_t* d = static_cast<const uint8_t*>(in);
  uint8_t* o = static_cast<uint8_t*>(out);
  uint8_t* sums = static_cast<uint8_t*>(scratch);
  // 16-byte loads need every plane 16-byte aligned; 16-byte stores need
  // the output aligned (each thread's run starts at a multiple of 16 * K)
  const bool vec_in = reinterpret_cast<uintptr_t>(d) % 16 == 0 && ne % 16 == 0;
  const bool vec_out = reinterpret_cast<uintptr_t>(o) % 16 == 0;
  if (ntiles > 0) {
    tile_sums<<<dim3((unsigned)ntiles, (unsigned)k), THREADS, 0, s>>>(
        d, sums, ne, ntiles, vec_in);
    tile_scan<<<(unsigned)k, SCAN_THREADS, 0, s>>>(sums, ntiles);
  }
  switch (k) {
    case 1: launch_inverse<1>(d, o, sums, ne, n, ntiles, vec_in, vec_out, s);
      break;
    case 2: launch_inverse<2>(d, o, sums, ne, n, ntiles, vec_in, vec_out, s);
      break;
    case 3: launch_inverse<3>(d, o, sums, ne, n, ntiles, vec_in, vec_out, s);
      break;
    case 4: launch_inverse<4>(d, o, sums, ne, n, ntiles, vec_in, vec_out, s);
      break;
    case 5: launch_inverse<5>(d, o, sums, ne, n, ntiles, vec_in, vec_out, s);
      break;
    case 6: launch_inverse<6>(d, o, sums, ne, n, ntiles, vec_in, vec_out, s);
      break;
    case 7: launch_inverse<7>(d, o, sums, ne, n, ntiles, vec_in, vec_out, s);
      break;
    default: launch_inverse<8>(d, o, sums, ne, n, ntiles, vec_in, vec_out, s);
  }
  return (int)cudaGetLastError();
}
