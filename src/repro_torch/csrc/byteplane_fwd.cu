// K2: byteplane forward transform, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ckpt_codec/byteplane.py::forward_planes_2d (`_fwd_kernel`,
// pallas_call at byteplane.py:111) together with the XLA glue of
// forward_pallas_expr (the one-element shift and the ragged tail).
//
// What it computes (byte-identical to the numpy oracle
// repro_torch.core.codec.byteplane_forward and to the port's plain version
// repro_torch.kernels.ckpt_codec.byteplane.forward_plain): the n-byte stream
// holds ne = n / K elements of K bytes; output plane p, element j is
// x[j][p] - x[j-1][p] mod 256 (x[-1] = 0), stored plane-major at p*ne + j;
// the n - ne*K tail bytes are copied unchanged after the planes.
//
// What bounds it on the H100: memory. Each byte is read once (the previous
// element's read hits L1/L2) and written once: 2n bytes, no arithmetic to
// speak of.
//
// Design: one thread per element j (grid-stride). It loads element j and
// j-1 as one K-byte word each (K in {1,2,4,8}: one aligned load), and
// writes its K delta bytes into the K planes; neighbouring threads write
// neighbouring bytes of each plane, so the stores coalesce. The Pallas
// kernel's explicit transpose tile is not needed: the plane-major store
// pattern is the transpose. 64-bit offsets throughout.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
byteplane_fwd_kernel(const uint8_t* __restrict__ in,
                     uint8_t* __restrict__ out, int64_t ne, int64_t n) {
  const T* x = reinterpret_cast<const T*>(in);
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = first; j < ne; j += stride) {
    const T cur = x[j];
    const T prv = j ? x[j - 1] : T(0);
#pragma unroll
    for (int p = 0; p < K; ++p) {
      const uint8_t a = (uint8_t)(cur >> (8 * p));
      const uint8_t b = (uint8_t)(prv >> (8 * p));
      out[p * ne + j] = (uint8_t)(a - b);
    }
  }
  const int64_t tail = n - ne * K;
  if (first < tail) out[ne * K + first] = in[ne * K + first];
}

template <typename T, int K>
int launch(const void* in, void* out, int64_t n, cudaStream_t stream) {
  const int64_t ne = n / K;
  int64_t blocks = (ne + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 64) blocks = 132 * 64;
  byteplane_fwd_kernel<T, K><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), ne, n);
  return (int)cudaGetLastError();
}

}  // namespace

// in/out: device pointers, n bytes each, `in` aligned to `itemsize`;
// itemsize in {1, 2, 4, 8}. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another itemsize.
extern "C" int rt_byteplane_fwd(const void* in, void* out, int64_t n,
                                int64_t itemsize, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 1: return launch<uint8_t, 1>(in, out, n, s);
    case 2: return launch<uint16_t, 2>(in, out, n, s);
    case 4: return launch<uint32_t, 4>(in, out, n, s);
    case 8: return launch<uint64_t, 8>(in, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
