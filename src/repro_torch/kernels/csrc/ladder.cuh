// The segmented ladder of the Intelligent-Unroll kernels, for Hopper.
//
// Shared by the stage-A kernels (unroll_spmv/csrc/stage_a.cu) and the
// standalone segmented reduction (segment_reduce/csrc/segment_reduce.cu), so
// both run one copy of the code that fixes their bitwise order.
//
// A CTA holds `ny` rows (exec blocks) of `n` lanes by `dt` columns of the
// trailing lane axis, one thread per (row, lane, column): a (dt, n, ny)
// block, so threadIdx is (column, lane, row), the column fastest.  A kernel
// compiled for D = 1 takes an (n, ny) block instead, threadIdx (lane, row),
// the shape of a launch without trailing axes (tile_block, TileThread).
// Each column runs exactly the arithmetic of a launch without trailing axes,
// in the same order, so column d of a (B, N, D) launch is bitwise equal to
// the (B, N) launch on column d.
//
// The ladder: step k sets t[j] = op(t[j], t[j + 2^k]) where seg[j] ==
// seg[j + 2^k]; lanes past N read the identity and kSegPad.  A FULL_REDUCE
// row instead runs ceil(log2 N) unmasked steps and keeps the result in lane
// 0 only: lane 0 of an unmasked shift ladder with offsets 1, 2, 4, ... builds
// exactly the pairs of the pairwise halving tree (kernels/common.py
// halving_tree), which pads an odd level with the identity, for every N.
//
// Exactness: float and double products and sums use the _rn intrinsics,
// which nvcc never contracts into an FMA (a contracted value*x + t differs
// from the separate torch ops by up to 1 ulp); int32 add/mul wrap through
// unsigned arithmetic, as torch's int32 ops do; max/min propagate NaN, as
// torch.maximum / torch.minimum do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ladder {

constexpr int kSegPad = -(1 << 30);
constexpr int kFullReduce = -1;
constexpr int kMaxThreads = 1024;
constexpr int kMaxBlockZ = 64;     // the limit of blockDim.z

enum Reduce { kAdd = 0, kMul = 1, kMax = 2, kMin = 3 };

template <typename T, int R> struct Ops;

template <int R> struct Ops<float, R> {
  __device__ static float identity() {
    if (R == kAdd) return 0.0f;
    if (R == kMul) return 1.0f;
    if (R == kMax) return -__int_as_float(0x7f800000);
    return __int_as_float(0x7f800000);
  }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float op(float a, float b) {
    if (R == kAdd) return __fadd_rn(a, b);
    if (R == kMul) return __fmul_rn(a, b);
    if (R == kMax) return (a != a || a > b) ? a : b;
    return (a != a || a < b) ? a : b;
  }
};

template <int R> struct Ops<double, R> {
  __device__ static double identity() {
    if (R == kAdd) return 0.0;
    if (R == kMul) return 1.0;
    if (R == kMax) return -__longlong_as_double(0x7ff0000000000000LL);
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double op(double a, double b) {
    if (R == kAdd) return __dadd_rn(a, b);
    if (R == kMul) return __dmul_rn(a, b);
    if (R == kMax) return (a != a || a > b) ? a : b;
    return (a != a || a < b) ? a : b;
  }
};

template <int R> struct Ops<int32_t, R> {
  __device__ static int32_t identity() {
    if (R == kAdd) return 0;
    if (R == kMul) return 1;
    if (R == kMax) return INT32_MIN;
    return INT32_MAX;
  }
  __device__ static int32_t mul(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a * (uint32_t)b);
  }
  __device__ static int32_t op(int32_t a, int32_t b) {
    if (R == kAdd) return (int32_t)((uint32_t)a + (uint32_t)b);
    if (R == kMul) return (int32_t)((uint32_t)a * (uint32_t)b);
    if (R == kMax) return a > b ? a : b;
    return a < b ? a : b;
  }
};

inline int ceil_log2(int n) {
  int s = 0;
  while ((1 << s) < n) ++s;
  return s;
}

// The shape of one CTA and of the ladder it runs, fixed per launch.
struct Tile {
  int n;           // lanes per row
  int dt;          // trailing columns per CTA
  int ny;          // rows per pass of the CTA's row loop
  int op;          // ladder depth, or kFullReduce
  int steps_full;  // ceil(log2 n)
  int steps;       // steps every row of the launch runs
};

// Columns per CTA and rows per pass for n lanes, a trailing width d and
// `rows` exec blocks per CTA: every column of a lane in one CTA up to the
// thread limit, then as many rows as fit (at most kMaxBlockZ).
inline Tile make_tile(int n, long long d, int rows, int op, bool mixed) {
  Tile t;
  t.n = n;
  const int cols = kMaxThreads / n;
  t.dt = d < cols ? (int)d : cols;
  int fit = kMaxThreads / (n * t.dt);
  if (fit > kMaxBlockZ) fit = kMaxBlockZ;
  t.ny = rows < fit ? rows : fit;
  t.op = op;
  t.steps_full = ceil_log2(n);
  if (op == kFullReduce) {
    t.steps = t.steps_full;
  } else {
    t.steps = op;
    if (mixed && t.steps_full > t.steps) t.steps = t.steps_full;
  }
  return t;
}

inline size_t tile_shmem(const Tile& t, size_t elem_bytes) {
  return (size_t)t.ny * t.n * (t.dt * elem_bytes + sizeof(int));
}

inline dim3 tile_block(const Tile& t, bool cols) {
  return cols ? dim3(t.dt, t.n, t.ny) : dim3(t.n, t.ny);
}

// The thread's column, lane and row in a tile_block(t, kCols) CTA.
template <bool kCols> struct TileThread {
  int col, lane, y;
  __device__ TileThread()
      : col(kCols ? (int)threadIdx.x : 0),
        lane(kCols ? (int)threadIdx.y : (int)threadIdx.x),
        y(kCols ? (int)threadIdx.z : (int)threadIdx.y) {}
};

// One row's ladder.  Every thread of the CTA calls it the same number of
// times (it holds barriers); a thread past the row count or the trailing
// width passes the identity and kSegPad and discards the result.  `tb` is the
// row's (n, dt) value buffer and `sb` its (n,) segment buffer in shared
// memory; `dt` is t.dt, or the constant 1 in a kernel compiled for D = 1, so
// that instantiation carries no per-column index arithmetic.  Returns the
// lane's post-ladder value (a FULL_REDUCE row keeps the lane's own value
// everywhere but lane 0).
template <typename T, int R>
__device__ __forceinline__ T segmented_ladder(T term, int sg, bool full_row,
                                              T* tb, int* sb, int lane,
                                              int col, int dt,
                                              const Tile& t) {
  const T ident = Ops<T, R>::identity();
  const T orig = term;
  tb[lane * dt + col] = term;
  if (col == 0) sb[lane] = sg;
  __syncthreads();
  for (int k = 0; k < t.steps; ++k) {
    const int d = 1 << k;
    const bool inside = lane + d < t.n;
    const T partner = inside ? tb[(lane + d) * dt + col] : ident;
    const bool apply = full_row ? k < t.steps_full
                                : (k < t.op && inside && sb[lane + d] == sg);
    __syncthreads();
    if (apply) {
      term = Ops<T, R>::op(term, partner);
      tb[lane * dt + col] = term;
    }
    __syncthreads();
  }
  // every read of tb / sb precedes the last barrier, so the next row may
  // overwrite both right away
  return (full_row && lane != 0) ? orig : term;
}

}  // namespace ladder
