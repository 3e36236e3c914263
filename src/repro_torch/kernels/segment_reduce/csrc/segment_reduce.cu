// Standalone segmented reduction of the Intelligent-Unroll engine (paper
// section 5, Fig. 5) for Hopper (sm_90a).
//
//   segment_reduce  replaces the JAX package's
//       kernels/segment_reduce/kernel.py::segment_reduce (+ _body): the
//       segmented ladder of op_flag masked shift-combine steps over lane
//       blocks x (B, N, D), seg (B, N) int32 broadcast over D, or the
//       FULL_REDUCE total in lane 0 (the other lanes keep their value).
//
// The ladder is ../../csrc/ladder.cuh, the code the stage-A kernels run, so
// both give the same bits in the same order: a CTA holds `rows` blocks (the
// realized rows_per_step, the largest divisor of B), one thread per (row,
// lane, column) up to 1024 threads, and a second grid axis walks the column
// tiles of D.  Templated over float, double and int32_t and over the reduce
// (add, mul, max, min).
//
// Bound on this card: bytes.  The function must read x and seg once and
// write x's shape once; the ladder's op_flag steps (at most ceil(log2 N) = 7
// at N = 128) are a few operations per byte moved, far below the card's
// ratio.  The design reads and writes with neighbouring threads on
// neighbouring addresses (columns fastest, then lanes), reads each seg word
// once per column tile, and keeps the ladder in shared memory.
//
// The entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include "ladder.cuh"

namespace {

using ladder::Ops;
using ladder::Tile;

// kCols: compiled for D > 1.  The D = 1 instantiation has dt = 1, col = 0
// and D = 1 as constants.
template <typename T, int R, bool kCols>
__global__ void segment_reduce_kernel(const T* x, const int32_t* seg, T* out,
                                      long long d_arg, int rows, Tile t) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int n = t.n;
  const int dt = kCols ? t.dt : 1;
  const long long d = kCols ? d_arg : 1;
  const ladder::TileThread<kCols> th;
  const int col = th.col, lane = th.lane, y = th.y;
  const long long c = kCols ? (long long)blockIdx.y * dt + col : 0;
  T* tb = reinterpret_cast<T*>(smem) + (size_t)y * n * dt;
  int* sb = reinterpret_cast<int*>(smem + sizeof(T) * t.ny * n * dt) + y * n;
  const bool full = t.op == ladder::kFullReduce;
  // every thread runs the same number of iterations (the ladder holds
  // barriers); rows past `rows` and columns past D only take part in them
  for (int r0 = 0; r0 < rows; r0 += t.ny) {
    const int r = r0 + y;
    const bool active = r < rows && (!kCols || c < d);
    const long long li = ((long long)blockIdx.x * rows + r) * n + lane;
    T term = Ops<T, R>::identity();
    int sg = ladder::kSegPad;
    if (active) {
      term = x[li * d + c];
      sg = seg[li];
    }
    term = ladder::segmented_ladder<T, R>(term, sg, full, tb, sb, lane, col,
                                          dt, t);
    if (active) out[li * d + c] = term;
  }
}

template <typename T, int R>
void launch_reduce(const T* x, const int32_t* seg, T* out, long long d,
                   int rows, const Tile& t, dim3 grid, size_t shmem,
                   cudaStream_t stream) {
  const dim3 block = ladder::tile_block(t, d > 1);
  if (d > 1)
    segment_reduce_kernel<T, R, true><<<grid, block, shmem, stream>>>(
        x, seg, out, d, rows, t);
  else
    segment_reduce_kernel<T, R, false><<<grid, block, shmem, stream>>>(
        x, seg, out, d, rows, t);
}

template <typename T>
int launch_typed(int reduce, const T* x, const int32_t* seg, T* out, int b,
                 long long d, int rows, const Tile& t, cudaStream_t stream) {
  const dim3 grid(b / rows, (unsigned)((d + t.dt - 1) / t.dt));
  const size_t shmem = ladder::tile_shmem(t, sizeof(T));
  switch (reduce) {
    case ladder::kAdd: launch_reduce<T, ladder::kAdd>(x, seg, out, d, rows, t, grid, shmem, stream); break;
    case ladder::kMul: launch_reduce<T, ladder::kMul>(x, seg, out, d, rows, t, grid, shmem, stream); break;
    case ladder::kMax: launch_reduce<T, ladder::kMax>(x, seg, out, d, rows, t, grid, shmem, stream); break;
    case ladder::kMin: launch_reduce<T, ladder::kMin>(x, seg, out, d, rows, t, grid, shmem, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 int32, 2 float64.  reduce: 0 add, 1 mul, 2 max, 3 min.
// op: ladder depth >= 0, or -1 for FULL_REDUCE.
extern "C" int segment_reduce(int dtype, int reduce, const void* x,
                              const void* seg, void* out, int b, int n,
                              long long d, int op, int rows, void* stream) {
  if (n < 1 || n > ladder::kMaxThreads || rows < 1 || b < 0 ||
      (b > 0 && b % rows != 0) || d < 1 || op < ladder::kFullReduce)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  const Tile t = ladder::make_tile(n, d, rows, op, false);
  if ((d + t.dt - 1) / t.dt > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sg = static_cast<const int32_t*>(seg);
  if (dtype == 0)
    return launch_typed<float>(reduce, static_cast<const float*>(x), sg,
                               static_cast<float*>(out), b, d, rows, t, s);
  if (dtype == 1)
    return launch_typed<int32_t>(reduce, static_cast<const int32_t*>(x), sg,
                                 static_cast<int32_t*>(out), b, d, rows, t, s);
  if (dtype == 2)
    return launch_typed<double>(reduce, static_cast<const double*>(x), sg,
                                static_cast<double*>(out), b, d, rows, t, s);
  return (int)cudaErrorInvalidValue;
}
