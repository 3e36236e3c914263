// Row gather of the MoE token dispatch for Hopper (sm_90a).
//
//   row_gather  replaces the JAX package's
//       kernels/moe_dispatch/kernel.py::row_gather (+ _body):
//       out[i, :] = src[row_ids[i], :] for src (T, D), row_ids (R,) int32.
//
// The TPU runs a grid of (R, D / d_tile) steps whose scalar-prefetched row
// id drives one row-tile DMA each.  Here one CTA copies one (row, d_tile)
// tile: it reads its row id once and moves the tile's bytes with the widest
// accesses the tile's byte count and the pointers' alignment allow (16, 8,
// 4, 2 or 1 bytes per thread).  The copy is dtype-agnostic (bf16, float32
// and any element size).
//
// Bound on this card: bytes.  The function must read the R row ids and R
// rows of D elements and write R rows; it does no arithmetic.  Neighbouring
// threads move neighbouring 16-byte words of one row, so every warp access
// is a full, aligned line.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void row_gather_kernel(const V* src, const int32_t* row_ids,
                                  V* out, long long row_words,
                                  int tile_words) {
  const long long i = blockIdx.x;
  const long long r = row_ids[i];
  const long long base = (long long)blockIdx.y * tile_words;
  const V* from = src + r * row_words + base;
  V* to = out + i * row_words + base;
  for (int k = threadIdx.x; k < tile_words; k += blockDim.x) to[k] = from[k];
}

template <typename V>
int launch_typed(const void* src, const int32_t* row_ids, void* out, int r,
                 long long row_bytes, long long tile_bytes,
                 cudaStream_t stream) {
  const long long tile_words = tile_bytes / (long long)sizeof(V);
  const long long row_words = row_bytes / (long long)sizeof(V);
  if (tile_words > (1LL << 30)) return (int)cudaErrorInvalidValue;
  int threads = (int)(tile_words < 1024 ? tile_words : 1024);
  threads = (threads + 31) / 32 * 32;
  const dim3 grid((unsigned)r, (unsigned)(row_bytes / tile_bytes));
  row_gather_kernel<V><<<grid, threads, 0, stream>>>(
      static_cast<const V*>(src), row_ids, static_cast<V*>(out), row_words,
      (int)tile_words);
  return (int)cudaGetLastError();
}

}  // namespace

// src (T, row_bytes) and out (R, row_bytes) as raw bytes; row_ids (R,).
// tile_bytes divides row_bytes; row_bytes / tile_bytes <= 65535.
extern "C" int row_gather(const void* src, const void* row_ids, void* out,
                          int r, long long row_bytes, long long tile_bytes,
                          void* stream) {
  if (r < 0 || row_bytes < 1 || tile_bytes < 1 ||
      row_bytes % tile_bytes != 0 || row_bytes / tile_bytes > 65535 || !src ||
      !row_ids || !out)
    return (int)cudaErrorInvalidValue;
  if (r == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ids = static_cast<const int32_t*>(row_ids);
  const uintptr_t align = (uintptr_t)src | (uintptr_t)out;
  if (tile_bytes % 16 == 0 && align % 16 == 0)
    return launch_typed<uint4>(src, ids, out, r, row_bytes, tile_bytes, s);
  if (tile_bytes % 8 == 0 && align % 8 == 0)
    return launch_typed<uint2>(src, ids, out, r, row_bytes, tile_bytes, s);
  if (tile_bytes % 4 == 0 && align % 4 == 0)
    return launch_typed<uint32_t>(src, ids, out, r, row_bytes, tile_bytes, s);
  if (tile_bytes % 2 == 0 && align % 2 == 0)
    return launch_typed<uint16_t>(src, ids, out, r, row_bytes, tile_bytes, s);
  return launch_typed<uint8_t>(src, ids, out, r, row_bytes, tile_bytes, s);
}
