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
// n bytes (bound 2n over 3.35 TB/s), and this design moves just those: it
// reads its input once.
//
// Design: the Pallas kernel runs one program per plane and carries the sum
// down the plane sequentially; with K = 2 that would be two CTAs for a
// 604 MB leaf. Addition mod 256 is associative and exact, so the plane scan
// is split over tiles and joined by a single-pass prefix scan with
// decoupled look-back (Merrill and Garland, 2016), in one launch after one
// memset of the scratch (status words and a tile counter):
//   - a CTA takes its tile from an atomic counter, not from blockIdx, so a
//     tile only ever waits on tiles whose CTAs have already started and
//     publish their aggregates without waiting on anything: the look-back
//     cannot wait on a CTA the hardware has not scheduled, and cannot
//     deadlock however many tiles there are;
//   - a tile is TILE_BYTES of input: TILE_ELEMS[K] elements of each of the
//     K planes. One thread copies the K plane slices into shared memory
//     with 1-D bulk copies (TMA, one mbarrier), so a CTA holds 32 KB
//     without registers. A tile cannot finish before every tile back to
//     the nearest P has its aggregate, so under the streaming load it waits
//     on the slowest loads in flight (~10 us of a CTA's ~16 us, traced at
//     603,979,776 bytes), and five CTAs an SM keep ~20 MB in flight over
//     the card through those waits (a tile held in registers gave a CTA
//     16 KB, and the kernel ran at half the copy rate);
//   - the tile is walked in rows of ROW elements, each thread 16 consecutive
//     elements of a row (conflict-free 16-byte reads of shared memory).
//     Each thread sums its 16 bytes of each plane, four planes packed to a
//     word (per-byte SIMD adds wrap mod 256 with no carry between lanes),
//     and one block scan of those words gives every thread its carry within
//     the tile and the tile's aggregate;
//   - one warp per group of four planes publishes the aggregate (flag A),
//     looks back over its predecessors' status words, adding their
//     aggregates until it meets an inclusive prefix (flag P), and publishes
//     its own inclusive prefix (flag P); tile 0 publishes P at once. Flag
//     and the four bytes lie in one 64-bit word, written and read whole
//     (strong relaxed accesses at gpu scope, single-copy atomic), so a flag
//     is never seen without its bytes; the word is all a reader needs, so
//     no release/acquire order is asked for;
//   - every thread scans its 16 bytes of each plane with its carry, the
//     bytes are interleaved in registers (byte permutes) at e*K + p, and
//     the thread writes its 16*K contiguous output bytes with 16-byte
//     streaming stores (st.global.cs: nothing reads them back here). The
//     CTA of tile 0 also copies the ragged tail.
// The result does not depend on the order in which tiles finish. Where the
// planes are not 16-byte aligned (a plane length that is not a multiple of
// 16, a misaligned view), the threads load the tile with byte loads; where
// the output is not, they store bytes. 64-bit offsets throughout; K in 1..8,
// a template parameter.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROW = THREADS * 16;           // elements of a row of a tile
constexpr int TILE_BYTES = 32768;           // input bytes of a tile, at most
// elements of each plane in a tile, by K: TILE_BYTES over K rounded up to a
// power of two (a whole number of rows)
constexpr int TILE_ELEMS[9] = {0, 32768, 16384, 8192, 8192, 4096, 4096,
                               4096, 4096};
constexpr int MAX_K = 8;
// scratch: one status word per (tile, group of four planes), then the counter
constexpr int STATUS_BYTES = 8;
constexpr int COUNTER_BYTES = 4;

constexpr int NW = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long FLAG_A = 1ull << 32;   // aggregate of the tile
constexpr unsigned long long FLAG_P = 2ull << 32;   // inclusive prefix
static_assert(NW <= 32, "the warp totals are scanned by one warp");

constexpr bool tiles_fit() {
  for (int k = 1; k <= MAX_K; ++k)
    if (TILE_ELEMS[k] * k > TILE_BYTES || TILE_ELEMS[k] % ROW) return false;
  return true;
}
static_assert(tiles_fit(), "a tile is whole rows within TILE_BYTES");

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

// `bytes` (a multiple of 16) from global src to shared dst, completing on
// bar's transaction count; L2 evict_first: every byte is read once
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// inclusive scan over the warp of four packed byte sums (mod 256 each)
__device__ __forceinline__ uint32_t warp_scan4(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v = __vadd4(v, n);
  }
  return v;
}

__device__ __forceinline__ uint32_t warp_sum4(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __vadd4(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// byte i of the result: bytes 0..i of x summed mod 256
__device__ __forceinline__ uint32_t word_scan(uint32_t x) {
  x = __vadd4(x, x << 8);
  return __vadd4(x, x << 16);
}

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int i) {
  return (w >> (8 * i)) & 0xFFu;
}

// The exclusive prefix of tile `tile` for one group of planes (`st`: the
// group's status word of tile 0; words of consecutive tiles are `stride`
// apart). Called by a whole warp; every tile before `tile` has started.
// Each step, lane i reads the word of the i-th nearest predecessor not yet
// read, so one round trip to L2 covers 32 tiles, and the warp waits only
// for the words nearer than the nearest P: a far word still unpublished
// does not hold the tile back.
__device__ __forceinline__ uint32_t look_back(const unsigned long long* st,
                                              int stride, int64_t tile) {
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0;
  for (int64_t i = tile - 1 - lane;; i -= 32) {
    unsigned long long s = i >= 0 ? peek(st + i * stride) : FLAG_P;
    int lp;                      // the lane of the nearest P
    for (;;) {
      const unsigned pl = __ballot_sync(FULL, (s & FLAG_P) != 0);
      lp = pl ? __ffs(pl) - 1 : 32;
      if (!__any_sync(FULL, lane < lp && (s >> 32) == 0)) break;
      if ((s >> 32) == 0) s = peek(st + i * stride);
    }
    // the lanes up to the P's add their words
    prefix = __vadd4(prefix, warp_sum4(lane <= lp ? (uint32_t)s : 0u));
    if (lp < 32) return prefix;
  }
}

// o[b / 4] byte b % 4 = element b / K, plane b % K of w
template <int K>
__device__ __forceinline__ void interleave(const uint32_t (&w)[K][4],
                                           uint32_t (&o)[K * 4]) {
  if constexpr (K == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = w[0][j];
  } else if constexpr (K == 2) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[2 * j] = __byte_perm(w[0][j], w[1][j], 0x5140);
      o[2 * j + 1] = __byte_perm(w[0][j], w[1][j], 0x7362);
    }
  } else if constexpr (K == 4 || K == 8) {
    // a 4 x 4 byte transpose per word of each group of four planes
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t a = w[4 * q][j], b = w[4 * q + 1][j];
        const uint32_t c = w[4 * q + 2][j], d = w[4 * q + 3][j];
        const uint32_t ab0 = __byte_perm(a, b, 0x5140);
        const uint32_t ab1 = __byte_perm(a, b, 0x7362);
        const uint32_t cd0 = __byte_perm(c, d, 0x5140);
        const uint32_t cd1 = __byte_perm(c, d, 0x7362);
        const uint32_t e[4] = {__byte_perm(ab0, cd0, 0x5410),
                               __byte_perm(ab0, cd0, 0x7632),
                               __byte_perm(ab1, cd1, 0x5410),
                               __byte_perm(ab1, cd1, 0x7632)};
#pragma unroll
        for (int r = 0; r < 4; ++r) o[(4 * j + r) * (K / 4) + q] = e[r];
      }
  } else {
#pragma unroll
    for (int j = 0; j < K * 4; ++j) o[j] = 0u;
#pragma unroll
    for (int b = 0; b < K * 16; ++b)
      o[b >> 2] |= byte_of(w[b % K][(b / K) >> 2], (b / K) & 3)
                   << (8 * (b & 3));
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
inverse_tiles(const uint8_t* __restrict__ d, uint8_t* __restrict__ out,
              unsigned long long* __restrict__ status,
              unsigned* __restrict__ counter, int64_t ne, int64_t n,
              bool vec_in, bool vec_out) {
  constexpr int TE = TILE_ELEMS[K];
  constexpr int V = TE / ROW;      // rows of a tile
  constexpr int G = (K + 3) / 4;   // status words (groups of planes) a tile
  extern __shared__ __align__(128) uint8_t tile_data[];   // K planes of TE
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ int64_t s_tile;
  __shared__ uint32_t s_warp[V][G][NW];
  __shared__ uint32_t s_prefix[G];
  const int64_t tail = n - ne * K;
  if (ne == 0) {                   // no plane element: the tail alone
    if (threadIdx.x < tail) out[threadIdx.x] = d[threadIdx.x];
    return;
  }
  const uint32_t bar = smem_u32(&s_bar);
  if (threadIdx.x == 0) {
    const int64_t t = atomicAdd(counter, 1u);
    s_tile = t;
    if (vec_in) {
      const int64_t left = ne - t * TE;
      const uint32_t bytes = (uint32_t)(left < TE ? left : TE);
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      mbar_expect_tx(bar, bytes * K);
#pragma unroll
      for (int p = 0; p < K; ++p)
        bulk_load(smem_u32(tile_data + p * TE), d + (int64_t)p * ne + t * TE,
                  bytes, bar);
    }
  }
  __syncthreads();
  const int64_t tile = s_tile;
  if (vec_in) {
    mbar_wait(bar, 0);             // past a short last tile: stale bytes,
  } else {                         // which reach no stored output
    for (int i = threadIdx.x; i < K * TE; i += THREADS) {
      const int p = i / TE;
      const int64_t e = tile * TE + (i - p * TE);
      tile_data[i] = e < ne ? d[(int64_t)p * ne + e] : 0;
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint4* sv = reinterpret_cast<const uint4*>(tile_data);

  // the thread's byte sums of each row and plane, packed four planes to a
  // word; then, in place, its carry within the tile
  uint32_t carry[V][G];
#pragma unroll
  for (int r = 0; r < V; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) carry[r][g] = 0u;
#pragma unroll
  for (int r = 0; r < V; ++r)
#pragma unroll
    for (int p = 0; p < K; ++p) {
      const uint4 x = sv[(p * TE + r * ROW) / 16 + threadIdx.x];
      const uint32_t sum = __vsadu4(x.x, 0u) + __vsadu4(x.y, 0u) +
                           __vsadu4(x.z, 0u) + __vsadu4(x.w, 0u);
      carry[r][p >> 2] |= (sum & 0xFFu) << (8 * (p & 3));
    }
#pragma unroll
  for (int r = 0; r < V; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint32_t incl = warp_scan4(carry[r][g]);
      if (lane == 31) s_warp[r][g][warp] = incl;
      carry[r][g] = __vsub4(incl, carry[r][g]);
    }
  __syncthreads();
  uint32_t agg[G];                 // rows before r, then the whole tile
#pragma unroll
  for (int g = 0; g < G; ++g) agg[g] = 0u;
#pragma unroll
  for (int r = 0; r < V; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      uint32_t before = 0u, total = 0u;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint32_t x = s_warp[r][g][w];
        if (w < warp) before = __vadd4(before, x);
        total = __vadd4(total, x);
      }
      carry[r][g] = __vadd4(carry[r][g], __vadd4(before, agg[g]));
      agg[g] = __vadd4(agg[g], total);
    }
  if (warp < G) {
    const int g = warp;
    const uint32_t a = G > 1 && g == 1 ? agg[G - 1] : agg[0];
    unsigned long long* mine = status + tile * G + g;
    uint32_t prefix = 0u;
    if (tile == 0) {
      if (lane == 0) publish(mine, FLAG_P | a);
    } else {
      if (lane == 0) publish(mine, FLAG_A | a);
      prefix = look_back(status + g, G, tile);
      if (lane == 0) publish(mine, FLAG_P | __vadd4(prefix, a));
    }
    if (lane == 0) s_prefix[g] = prefix;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < V; ++r) {
    const int64_t e0 = tile * TE + r * ROW + threadIdx.x * 16;
    const int64_t left = ne - e0;
    if (left <= 0) break;
    const int cnt = left >= 16 ? 16 : (int)left;
    uint32_t w[K][4];
#pragma unroll
    for (int p = 0; p < K; ++p) {
      const uint4 x = sv[(p * TE + r * ROW) / 16 + threadIdx.x];
      const uint32_t c = byte_of(
          __vadd4(carry[r][p >> 2], s_prefix[p >> 2]), p & 3) * 0x01010101u;
      w[p][0] = __vadd4(word_scan(x.x), c);
      w[p][1] = __vadd4(word_scan(x.y), __byte_perm(w[p][0], 0, 0x3333));
      w[p][2] = __vadd4(word_scan(x.z), __byte_perm(w[p][1], 0, 0x3333));
      w[p][3] = __vadd4(word_scan(x.w), __byte_perm(w[p][2], 0, 0x3333));
    }
    uint8_t* dst = out + e0 * K;
    if (vec_out && cnt == 16) {
      uint32_t o[K * 4];
      interleave<K>(w, o);
#pragma unroll
      for (int j = 0; j < K; ++j)
        __stcs(reinterpret_cast<uint4*>(dst) + j,
               make_uint4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]));
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (i < cnt) {
#pragma unroll
          for (int p = 0; p < K; ++p)
            dst[i * K + p] = (uint8_t)byte_of(w[p][i >> 2], i & 3);
        }
    }
  }
  if (tile == 0 && threadIdx.x < tail)
    out[ne * K + threadIdx.x] = d[ne * K + threadIdx.x];
}

template <int K>
int launch(const uint8_t* d, uint8_t* o, unsigned long long* status,
           unsigned* counter, int64_t ne, int64_t n, int64_t ntiles,
           bool vec_in, bool vec_out, cudaStream_t s) {
  const int64_t blocks = ntiles > 0 ? ntiles : 1;
  inverse_tiles<K><<<(unsigned)blocks, THREADS, TILE_ELEMS[K] * K, s>>>(
      d, o, status, counter, ne, n, vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// in/out: device pointers, n bytes each; scratch: a device buffer, 8-byte
// aligned, of at least
//   STATUS_BYTES * ceil((n / itemsize) / TILE_ELEMS[itemsize])
//   * ceil(itemsize / 4) + COUNTER_BYTES
// bytes (zeroed here on `stream` before the launch); itemsize in 1..8.
// Returns the first CUDA error of the memset or the launch, or
// cudaErrorInvalidValue for another itemsize or a short or misaligned
// scratch buffer.
extern "C" int rt_byteplane_inv(const void* in, void* out, void* scratch,
                                int64_t n, int64_t itemsize,
                                int64_t scratch_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (itemsize < 1 || itemsize > MAX_K || n < 0)
    return (int)cudaErrorInvalidValue;
  const int k = (int)itemsize;
  const int64_t ne = n / k;
  const int64_t ntiles = (ne + TILE_ELEMS[k] - 1) / TILE_ELEMS[k];
  const int64_t words = ntiles * ((k + 3) / 4);
  const int64_t need = STATUS_BYTES * words + COUNTER_BYTES;
  if (scratch_bytes < need || reinterpret_cast<uintptr_t>(scratch) % 8)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const uint8_t* d = static_cast<const uint8_t*>(in);
  uint8_t* o = static_cast<uint8_t*>(out);
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* counter = reinterpret_cast<unsigned*>(status + words);
  const cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)need, s);
  if (err != cudaSuccess) return (int)err;
  // bulk copies need every plane slice 16-byte aligned; 16-byte stores
  // need the output aligned (each thread's run starts at a multiple of
  // 16 * K)
  const bool vec_in = reinterpret_cast<uintptr_t>(d) % 16 == 0 && ne % 16 == 0;
  const bool vec_out = reinterpret_cast<uintptr_t>(o) % 16 == 0;
  switch (k) {
    case 1: return launch<1>(d, o, status, counter, ne, n, ntiles, vec_in,
                             vec_out, s);
    case 2: return launch<2>(d, o, status, counter, ne, n, ntiles, vec_in,
                             vec_out, s);
    case 3: return launch<3>(d, o, status, counter, ne, n, ntiles, vec_in,
                             vec_out, s);
    case 4: return launch<4>(d, o, status, counter, ne, n, ntiles, vec_in,
                             vec_out, s);
    case 5: return launch<5>(d, o, status, counter, ne, n, ntiles, vec_in,
                             vec_out, s);
    case 6: return launch<6>(d, o, status, counter, ne, n, ntiles, vec_in,
                             vec_out, s);
    case 7: return launch<7>(d, o, status, counter, ne, n, ntiles, vec_in,
                             vec_out, s);
    default: return launch<8>(d, o, status, counter, ne, n, ntiles, vec_in,
                              vec_out, s);
  }
}
