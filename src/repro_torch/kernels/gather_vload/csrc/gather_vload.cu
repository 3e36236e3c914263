// Standalone gather replacement of the Intelligent-Unroll engine (paper
// section 6, Fig. 6) for Hopper (sm_90a).
//
//   gather_vload  replaces the JAX package's
//       kernels/gather_vload/kernel.py::gather_vload (+ _body): for block b
//       and lane j, out[b, j] = concat(view[win[b, 0..ls)])[slot[b, j] * N +
//       off[b, j]], a whole row of D elements when the view is (W, N, D);
//       stream launches copy window 0 (out[b, j] = view[win[b, 0], j]).
//
// The TPU loads a block's ls whole N-row windows (its DMAs are tile
// granular) and selects with a one-hot matmul; here each output element
// reads its one word, view[win[b, slot[b, j]] * N + off[b, j]], so a block
// never moves the ls windows.  The copy is dtype-agnostic: 1, 2, 4 and
// 8-byte elements move as unsigned words of that size.
//
// Bound on this card: bytes.  The function must read, per lane, its slot,
// off (4 B each; neither for stream launches) and its row of the view, the
// window ids its lanes select, and write its row.  One thread per output
// element, columns fastest then lanes, so neighbouring threads read and
// write neighbouring addresses of a row and share one lane's metadata words
// (read once per warp through the L1); a grid-stride loop keeps the grid at
// a few waves of the card.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void gather_vload_kernel(const W* view, const int32_t* win,
                                    long long win_ld, int stream,
                                    const int32_t* slot, const int32_t* off,
                                    W* out, long long total, int n,
                                    long long d) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const long long li = i / d;           // lane b * N + j
    const long long c = i - li * d;
    const long long b = li / n;
    const long long j = li - b * n;
    const int32_t* wrow = win + b * win_ld;
    const long long row = stream ? (long long)wrow[0] * n + j
                                 : (long long)wrow[slot[li]] * n + off[li];
    out[i] = view[row * d + c];
  }
}

template <typename W>
int launch_typed(const void* view, const int32_t* win, long long win_ld,
                 int stream_form, const int32_t* slot, const int32_t* off,
                 void* out, long long total, int n, long long d,
                 cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = (long long)(sms > 0 ? sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  gather_vload_kernel<W><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const W*>(view), win, win_ld, stream_form, slot, off,
      static_cast<W*>(out), total, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// elem_bytes: 1, 2, 4 or 8.  view (W, N, D), win (B, >= ls) with row stride
// win_ld, slot/off (B, N) (unused for stream launches), out (B, N, D).
extern "C" int gather_vload(int elem_bytes, const void* view, const void* win,
                            long long win_ld, int stream_form,
                            const void* slot, const void* off, void* out,
                            int b, int n, long long d, void* stream) {
  if (b < 0 || n < 1 || d < 1 || !view || !win ||
      (!stream_form && (!slot || !off)))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)b * n * d;
  if (total == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* w = static_cast<const int32_t*>(win);
  const int32_t* sl = static_cast<const int32_t*>(slot);
  const int32_t* of = static_cast<const int32_t*>(off);
  switch (elem_bytes) {
    case 1: return launch_typed<uint8_t>(view, w, win_ld, stream_form, sl, of, out, total, n, d, s);
    case 2: return launch_typed<uint16_t>(view, w, win_ld, stream_form, sl, of, out, total, n, d, s);
    case 4: return launch_typed<uint32_t>(view, w, win_ld, stream_form, sl, of, out, total, n, d, s);
    case 8: return launch_typed<uint64_t>(view, w, win_ld, stream_form, sl, of, out, total, n, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
