// Standalone segmented reduction of the Intelligent-Unroll engine (paper
// section 5, Fig. 5) for Hopper (sm_90a).
//
//   segment_reduce  replaces the JAX package's
//       kernels/segment_reduce/kernel.py::segment_reduce (+ _body): the
//       segmented ladder of op_flag masked shift-combine steps over lane
//       blocks x (B, N, D), seg (B, N) int32 broadcast over D, or the
//       FULL_REDUCE total in lane 0 (the other lanes keep their value).
//
// The kernel is the stage-A body of ../../csrc/ladder.cuh with lane j of
// block b reading row b * N + j of x (no second operand, no elementwise
// operand, no per-block flags), so both give the same bits in the same
// order: a CTA holds `rows` blocks (the realized rows_per_step, the largest
// divisor of B), each row's ladder runs in one warp's registers, and at
// D > 1 the rows pass through a padded shared-memory transpose in tiles of
// up to all D columns.  Templated over float, double and int32_t and over
// the reduce (add, mul, max, min).
//
// Bound on this card: bytes.  The function must read x and seg once and
// write x's shape once; the ladder's op_flag steps (at most ceil(log2 N) = 7
// at N = 128) are a few operations per byte moved, far below the card's
// ratio.  The design reads and writes x with neighbouring threads on
// neighbouring words (16-byte vectors where D and the pointers allow),
// reads each seg word once per row and column tile, and holds the ladder
// in registers: no barrier between its steps.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include "ladder.cuh"

namespace {

// lane j of block b reads row b * N + j of x
struct RowsIndex {
  __device__ long long operator()(long long, int, long long li) const {
    return li;
  }
};

}  // namespace

// dtype: 0 float32, 1 int32, 2 float64.  reduce: 0 add, 1 mul, 2 max, 3 min.
// op: ladder depth >= 0, or -1 for FULL_REDUCE.
extern "C" int segment_reduce(int dtype, int reduce, const void* x,
                              const void* seg, void* out, int b, int n,
                              long long d, int op, int rows, void* stream) {
  ladder::Operands o = {};
  o.g0 = x;
  o.seg = static_cast<const int32_t*>(seg);
  o.out = out;
  const RowsIndex ix = {};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ladder::launch<float>(reduce, ix, o, b, n, d, op, rows, s);
  if (dtype == 1)
    return ladder::launch<int32_t>(reduce, ix, o, b, n, d, op, rows, s);
  if (dtype == 2)
    return ladder::launch<double>(reduce, ix, o, b, n, d, op, rows, s);
  return (int)cudaErrorInvalidValue;
}
