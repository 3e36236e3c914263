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
// granular) and selects with a one-hot matmul; here lane j of block b reads
// its one row of the view, win[b, slot[b, j]] * N + off[b, j], so a block
// never moves the ls windows.  The copy is dtype-agnostic: rows move as
// words of 1 to 16 bytes.
//
// Bound on this card: bytes.  The function must read, per lane, its slot
// and off (4 B each; neither for stream launches) and its row of the view,
// the window ids its lanes select, and write its row.  The design is the
// row copy of ../../csrc/row_copy.cuh: a warp takes the lanes of one block
// (all 128 of a 128-lane block at D = 1; 32 at D = 16 in float32), reads
// the block's window ids once, coalesced, and hands each lane its id with a
// shuffle, so a lane's chain is slot/off -> shuffle -> view row; every
// thread issues its 4 view loads before its stores, each lane's row moves
// in the widest words its byte count and the pointers allow, and no index
// is divided per element.  A stream launch is a copy of whole windows: row
// b of the output is view row win[b, 0], N * D elements long.
//
// Measured share of the bound, and the parent kernel's: PERF.md, section 6
// (NVIDIA H100 80GB HBM3, 700.00 W).
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include "row_copy.cuh"

// view (W, N, D) with rows of row_bytes = D * element bytes (stream
// launches: rows of N * D elements, one per window), win (B, >= ls) with row
// stride win_ld, slot/off (B, N) (unused for stream launches), out (B, N,
// D).  width and log_tpl are the row copy's shape (row_copy.cuh).
extern "C" int gather_vload(const void* view, const void* win,
                            long long win_ld, int ls, int stream_form,
                            const void* slot, const void* off, void* out,
                            int b, int n, long long row_bytes, int width,
                            int log_tpl, void* stream) {
  if (b < 0 || n < 1 || ls < 1 || !win || (!stream_form && (!slot || !off)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* w = static_cast<const int32_t*>(win);
  if (stream_form)
    return row_copy::launch(row_copy::IdRows{w, win_ld, b, 0}, view, out,
                            row_bytes, width, log_tpl, s);
  return row_copy::launch(
      row_copy::WindowLanes{w, win_ld, ls, static_cast<const int32_t*>(slot),
                            static_cast<const int32_t*>(off), b, n, 0, 0},
      view, out, row_bytes, width, log_tpl, s);
}
