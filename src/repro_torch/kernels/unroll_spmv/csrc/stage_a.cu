// Stage A of the Intelligent-Unroll SpMV program for Hopper (sm_90a).
//
// Two kernels share one body, templated over the value type (float,
// int32_t) and the reduce (add, mul, max, min):
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
// Trailing lane axes (SpMM): a gathered operand is (data_len, D), row
// contiguous, and the output (Bc, N, D); the elementwise operand and the lane
// metadata stay (Bc, N) and broadcast over D.  A CTA runs dt columns of every
// lane of its rows (../../csrc/ladder.cuh), and a second grid axis walks the
// ceil(D / dt) column tiles, so N * dt stays within 1024 threads.  Column d
// runs exactly the arithmetic of the D = 1 launch on column d.
//
// Per lane and column: the "mul_all" combine (product of up to two gathered
// operands, then one elementwise operand), then the segmented ladder of
// ladder.cuh; a FULL_REDUCE block (op == -1, or full[b] != 0 in a fused mixed
// section, over every column of the block) runs the halving tree instead.
//
// Bound on this card: bytes.  Per exec block of N lanes the window kernel
// must read the window ids its lanes select (4 B each; window 0's alone for
// stream launches), slot, off and seg per lane (3 x N x 4 B; seg alone for
// stream launches) and the value per lane, and write N x D words; the
// dense-slice kernel reads starts (4 B), seg and value per lane, plus
// local_off for strided runs, and writes N x D words.  On top, each launch
// must read every distinct gathered row its lanes use once: neighbouring
// blocks share most of x (on a banded matrix each row serves ~50 lanes), and
// x fits the 50 MB L2 at D = 1.  The design reads each metadata word once per
// column tile, with neighbouring threads on neighbouring addresses, leaves
// x's reuse to L2, and keeps the ladder in shared memory.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include "ladder.cuh"

namespace {

using ladder::Ops;
using ladder::Tile;

struct Args {
  // window form
  const int32_t* win;        // (Bc, >= ls) window ids, row stride win_ld
  long long win_ld;
  int stream;                // 1: lane j reads row j of window 0
  const int32_t* slot;       // (Bc, N)
  const int32_t* off;        // (Bc, N)
  // dense-slice form
  const int32_t* starts;     // (Bc,)
  const int32_t* local_off;  // (Bc, N) or null for identity runs
  // both
  const void* g0;            // gathered operands, (data_len, D)
  const void* g1;            // or null
  const void* e0;            // elementwise operand (Bc, N), or null
  const int32_t* seg;        // (Bc, N)
  const int32_t* full;       // (Bc,) native-reduce flags, or null
  void* out;                 // (Bc, N, D)
  long long d;               // trailing width D (1 without trailing axes)
  int rows;                  // exec blocks per CTA
  Tile tile;
};

// kCols: compiled for D > 1.  The D = 1 instantiation has dt = 1, col = 0
// and D = 1 as constants.
template <typename T, int R, bool kDense, bool kCols>
__global__ void stage_a_kernel(Args a) {
  extern __shared__ __align__(8) unsigned char smem[];
  const Tile t = a.tile;
  const int n = t.n;
  const int dt = kCols ? t.dt : 1;
  const long long dd = kCols ? a.d : 1;
  const ladder::TileThread<kCols> th;
  const int col = th.col, lane = th.lane, y = th.y;
  const long long d = kCols ? (long long)blockIdx.y * dt + col : 0;
  T* tb = reinterpret_cast<T*>(smem) + (size_t)y * n * dt;
  int* sb = reinterpret_cast<int*>(smem + sizeof(T) * t.ny * n * dt) + y * n;
  const T* g0 = static_cast<const T*>(a.g0);
  const T* g1 = static_cast<const T*>(a.g1);
  const T* e0 = static_cast<const T*>(a.e0);
  T* out = static_cast<T*>(a.out);

  // every thread runs the same number of iterations (the ladder holds
  // barriers); rows past a.rows and columns past D only take part in them
  for (int r0 = 0; r0 < a.rows; r0 += t.ny) {
    const int r = r0 + y;
    const bool active = r < a.rows && (!kCols || d < dd);
    const long long b = (long long)blockIdx.x * a.rows + r;
    const long long li = b * n + lane;
    T term = Ops<T, R>::identity();
    int sg = ladder::kSegPad;
    bool full_row = t.op == ladder::kFullReduce;
    if (active) {
      long long idx;
      if (kDense) {
        idx = (long long)a.starts[b] + (a.local_off ? a.local_off[li] : lane);
      } else {
        const int32_t* wrow = a.win + b * a.win_ld;
        idx = a.stream ? (long long)wrow[0] * n + lane
                       : (long long)wrow[a.slot[li]] * n + a.off[li];
      }
      term = g0[idx * dd + d];
      if (g1) term = Ops<T, R>::mul(term, g1[idx * dd + d]);
      if (e0) term = Ops<T, R>::mul(term, e0[li]);
      sg = a.seg[li];
      if (a.full && a.full[b]) full_row = true;
    }
    term = ladder::segmented_ladder<T, R>(term, sg, full_row, tb, sb, lane,
                                          col, dt, t);
    if (active) out[li * dd + d] = term;
  }
}

template <typename T, int R, bool kDense>
void launch_reduce(const Args& a, dim3 grid, size_t shmem,
                   cudaStream_t stream) {
  const bool cols = a.d > 1;
  const dim3 block = ladder::tile_block(a.tile, cols);
  if (cols)
    stage_a_kernel<T, R, kDense, true><<<grid, block, shmem, stream>>>(a);
  else
    stage_a_kernel<T, R, kDense, false><<<grid, block, shmem, stream>>>(a);
}

template <typename T, bool kDense>
int launch_typed(int reduce, const Args& a, int bc, cudaStream_t stream) {
  const Tile& t = a.tile;
  const dim3 grid(bc / a.rows, (unsigned)((a.d + t.dt - 1) / t.dt));
  const size_t shmem = ladder::tile_shmem(t, sizeof(T));
  switch (reduce) {
    case ladder::kAdd: launch_reduce<T, ladder::kAdd, kDense>(a, grid, shmem, stream); break;
    case ladder::kMul: launch_reduce<T, ladder::kMul, kDense>(a, grid, shmem, stream); break;
    case ladder::kMax: launch_reduce<T, ladder::kMax, kDense>(a, grid, shmem, stream); break;
    case ladder::kMin: launch_reduce<T, ladder::kMin, kDense>(a, grid, shmem, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool kDense>
int launch(int dtype, int reduce, Args a, int bc, int n, int op, int mixed,
           void* stream) {
  if (n < 1 || n > ladder::kMaxThreads || a.rows < 1 || bc % a.rows != 0 ||
      !a.g0 || a.d < 1)
    return (int)cudaErrorInvalidValue;
  if (bc == 0) return (int)cudaSuccess;
  a.tile = ladder::make_tile(n, a.d, a.rows, op, mixed != 0);
  if ((a.d + a.tile.dt - 1) / a.tile.dt > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float, kDense>(reduce, a, bc, s);
  if (dtype == 1) return launch_typed<int32_t, kDense>(reduce, a, bc, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 int32.  reduce: 0 add, 1 mul, 2 max, 3 min.
extern "C" int unroll_window_stage_a(
    int dtype, int reduce, const void* win, long long win_ld, int stream_form,
    const void* slot, const void* off, const void* g0, const void* g1,
    const void* e0, const void* seg, const void* full, void* out, int bc,
    int n, long long d, int op, int rows, void* stream) {
  Args a = {};
  a.win = static_cast<const int32_t*>(win);
  a.win_ld = win_ld;
  a.stream = stream_form;
  a.slot = static_cast<const int32_t*>(slot);
  a.off = static_cast<const int32_t*>(off);
  a.g0 = g0;
  a.g1 = g1;
  a.e0 = e0;
  a.seg = static_cast<const int32_t*>(seg);
  a.full = static_cast<const int32_t*>(full);
  a.out = out;
  a.d = d;
  a.rows = rows;
  return launch<false>(dtype, reduce, a, bc, n, op, full != nullptr, stream);
}

extern "C" int unroll_dense_slice_stage_a(
    int dtype, int reduce, const void* starts, const void* local_off,
    const void* g0, const void* g1, const void* e0, const void* seg,
    const void* full, void* out, int bc, int n, long long d, int op, int rows,
    void* stream) {
  Args a = {};
  a.starts = static_cast<const int32_t*>(starts);
  a.local_off = static_cast<const int32_t*>(local_off);
  a.g0 = g0;
  a.g1 = g1;
  a.e0 = e0;
  a.seg = static_cast<const int32_t*>(seg);
  a.full = static_cast<const int32_t*>(full);
  a.out = out;
  a.d = d;
  a.rows = rows;
  return launch<true>(dtype, reduce, a, bc, n, op, full != nullptr, stream);
}
