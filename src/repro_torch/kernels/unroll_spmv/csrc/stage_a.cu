// Stage A of the Intelligent-Unroll SpMV program for Hopper (sm_90a).
//
// Two kernels share one body, templated over the value type (float,
// double, int32_t) and the reduce (add, mul, max, min):
//
//   unroll_window_stage_a       replaces the JAX package's
//       kernels/unroll_spmv/kernel.py::class_stage_a (TPU window form) and
//       ::gpu_stage_a (its Triton form).  Lane j of exec block b reads its
//       one word (or value row) directly, view[win[b, slot[b, j]], off[b, j]]
//       (stream launches: view[win[b, 0], j]).  The TPU fetches the ls whole
//       N-word windows because its DMAs are tile-granular and then selects
//       with a one-hot matmul; on Hopper a lane's indexed read is the same
//       word and avoids reading up to 32x N words per block.
//   unroll_dense_slice_stage_a  replaces ::coalesced_stage_a.  Lane j of
//       block b reads flat[starts[b] + (local_off ? local_off[b, j] : j)]:
//       one coalesced N-word slice per block (strided runs permuted by the
//       index).  The TPU keeps the whole flat view resident in VMEM; here it
//       stays in global memory.
//
// The two differ only in the index policy below; the body is the register
// ladder of ../../csrc/ladder.cuh.  Per lane and column: the seed's combine
// of up to two gathered operands and then one elementwise operand, as the
// reference's _combine_lanes evaluates it in its kernels, in one of two
// forms chosen per launch: "mul_all", their product (SpMV, SpMM,
// PageRank), or "add_all", their sum plus an optional scalar addend (BFS
// level + 1, SSSP dist + weight, CC's label alone); then the segmented
// ladder.  A FULL_REDUCE block (op == -1, or full[b] != 0 in a fused mixed
// section, over every column of the block) runs the halving tree instead.
//
// Trailing lane axes (SpMM): a gathered operand is (data_len, D), row
// contiguous, and the output (Bc, N, D); the elementwise operand and the lane
// metadata stay (Bc, N) and broadcast over D.  Column d runs exactly the
// arithmetic of the D = 1 launch on column d.
//
// Bound on this card: bytes.  Per exec block of N lanes the window kernel
// must read the window ids its lanes select (4 B each; window 0's alone for
// stream launches), slot, off and seg per lane (3 x N x 4 B; seg alone for
// stream launches) and the value per lane, and write N x D words; the
// dense-slice kernel reads starts (4 B), seg and value per lane, plus
// local_off for strided runs, and writes N x D words.  On top, each launch
// must read every distinct gathered row its lanes use once: neighbouring
// blocks share most of x (on a banded matrix each row serves ~50 lanes), and
// x fits the 50 MB L2 at D = 1.  The design reads each metadata word once
// per row (at D > 1 the threads of one lane read it in one broadcast
// instruction), x's rows with neighbouring threads on neighbouring words,
// leaves x's reuse to L2, and runs each row's ladder in one warp's
// registers: no barrier between ladder steps, two per pass of rows at D > 1
// around the shared-memory transposes, none at D = 1.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include "ladder.cuh"

namespace {

// window form: lane j of block b reads row win[b, slot[b, j]] * n + off[b, j]
struct WindowIndex {
  const int32_t* win;        // (Bc, >= ls) window ids, row stride win_ld
  long long win_ld;
  int stream;                // 1: lane j reads row j of window 0
  const int32_t* slot;       // (Bc, N)
  const int32_t* off;        // (Bc, N)
  int n;
  __device__ long long operator()(long long b, int lane, long long li) const {
    const int32_t* wrow = win + b * win_ld;
    return stream ? (long long)wrow[0] * n + lane
                  : (long long)wrow[slot[li]] * n + off[li];
  }
};

// dense-slice form: lane j of block b reads row starts[b] + local_off[b, j]
struct DenseIndex {
  const int32_t* starts;     // (Bc,)
  const int32_t* local_off;  // (Bc, N) or null for identity runs
  __device__ long long operator()(long long b, int lane, long long li) const {
    return (long long)starts[b] + (local_off ? local_off[li] : lane);
  }
};

template <class Index>
int launch(int dtype, int reduce, const Index& ix, const ladder::Operands& o,
           int bc, int n, long long d, int op, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ladder::launch<float>(reduce, ix, o, bc, n, d, op, rows, s);
  if (dtype == 1)
    return ladder::launch<int32_t>(reduce, ix, o, bc, n, d, op, rows, s);
  if (dtype == 2)
    return ladder::launch<double>(reduce, ix, o, bc, n, d, op, rows, s);
  return (int)cudaErrorInvalidValue;
}

ladder::Operands operands(int combine, double addend, const void* g0,
                          const void* g1, const void* e0, const void* seg,
                          const void* full, void* out) {
  ladder::Operands o = {};
  o.g0 = g0;
  o.g1 = g1;
  o.e0 = e0;
  o.seg = static_cast<const int32_t*>(seg);
  o.full = static_cast<const int32_t*>(full);
  o.out = out;
  o.combine = combine;
  o.addend = addend;
  return o;
}

}  // namespace

// dtype: 0 float32, 1 int32, 2 float64.  reduce: 0 add, 1 mul, 2 max, 3 min.
// combine: 0 "mul_all", 1 "add_all", 2 "add_all" plus `addend`.
extern "C" int unroll_window_stage_a(
    int dtype, int reduce, int combine, double addend, const void* win,
    long long win_ld, int stream_form, const void* slot, const void* off,
    const void* g0, const void* g1, const void* e0, const void* seg,
    const void* full, void* out, int bc, int n, long long d, int op, int rows,
    void* stream) {
  WindowIndex ix = {};
  ix.win = static_cast<const int32_t*>(win);
  ix.win_ld = win_ld;
  ix.stream = stream_form;
  ix.slot = static_cast<const int32_t*>(slot);
  ix.off = static_cast<const int32_t*>(off);
  ix.n = n;
  if (!win || (!stream_form && (!slot || !off)))
    return (int)cudaErrorInvalidValue;
  return launch(dtype, reduce, ix,
                operands(combine, addend, g0, g1, e0, seg, full, out), bc, n,
                d, op, rows, stream);
}

extern "C" int unroll_dense_slice_stage_a(
    int dtype, int reduce, int combine, double addend, const void* starts,
    const void* local_off, const void* g0, const void* g1, const void* e0,
    const void* seg, const void* full, void* out, int bc, int n, long long d,
    int op, int rows, void* stream) {
  DenseIndex ix = {};
  ix.starts = static_cast<const int32_t*>(starts);
  ix.local_off = static_cast<const int32_t*>(local_off);
  if (!starts) return (int)cudaErrorInvalidValue;
  return launch(dtype, reduce, ix,
                operands(combine, addend, g0, g1, e0, seg, full, out), bc, n,
                d, op, rows, stream);
}
