// Row gather of the MoE token dispatch for Hopper (sm_90a).
//
//   row_gather  replaces the JAX package's
//       kernels/moe_dispatch/kernel.py::row_gather (+ _body):
//       out[i, :] = src[row_ids[i], :] for src (T, D), row_ids (R,) int32.
//
// The TPU runs a grid of (R, D / d_tile) steps whose scalar-prefetched row
// id drives one row-tile DMA each.  Here the CUDA grid does not depend on
// d_tile: the copy is the row copy of ../../csrc/row_copy.cuh, in which a
// warp moves a 2 KB strip of one row (a row of D = 4,096 bf16 is 8 KB, four
// strips), 4 16-byte words per thread, strips the slow axis of the grid.
// The copy is dtype-agnostic (bf16, float32 and any element size).
//
// Bound on this card: bytes.  The function must read the R row ids, each
// distinct source row once and write R rows; it does no arithmetic.  A tile
// per CTA (the parent design: 64-thread CTAs moving one 16-byte word per
// thread at the qwen3-moe dispatch, 262,144 of them) was paced by CTA
// scheduling and the id -> load -> store chain.  Here each thread keeps 4
// independent 16-byte loads in flight before its stores; the warps in
// flight read one strip of the source (4,097 tokens x 2 KB), which stays in
// L2 while each token is read top-k times, where a whole f32 source (67 MB)
// would not; the stores are streaming (__stcs).
//
// Measured share of the bound, and the parent kernel's: PERF.md, section 6
// (NVIDIA H100 80GB HBM3, 700.00 W).
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include "row_copy.cuh"

// src (T, row_bytes) and out (R, row_bytes) as raw bytes; row_ids (R,).
// width and log_tpl are the row copy's shape (row_copy.cuh).
extern "C" int row_gather(const void* src, const void* row_ids, void* out,
                          int r, long long row_bytes, int width, int log_tpl,
                          void* stream) {
  if (r < 0 || !row_ids) return (int)cudaErrorInvalidValue;
  return row_copy::launch(
      row_copy::IdRows{static_cast<const int32_t*>(row_ids), 1, r, 0}, src,
      out, row_bytes, width, log_tpl, static_cast<cudaStream_t>(stream));
}
