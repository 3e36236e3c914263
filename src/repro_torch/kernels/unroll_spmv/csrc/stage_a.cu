// Stage A of the Intelligent-Unroll SpMV program for Hopper (sm_90a).
//
// Two kernels share one body, templated over the value type (float,
// int32_t) and the reduce (add, mul, max, min):
//
//   unroll_window_stage_a       replaces the JAX package's
//       kernels/unroll_spmv/kernel.py::class_stage_a (TPU window form) and
//       ::gpu_stage_a (its Triton form).  Lane j of exec block b reads its
//       one word directly, view[win[b, slot[b, j]], off[b, j]] (stream
//       launches: view[win[b, 0], j]).  The TPU fetches the ls whole N-word
//       windows because its DMAs are tile-granular and then selects with a
//       one-hot matmul; on Hopper a lane's indexed read is the same word and
//       avoids reading up to 32x N words per block.
//   unroll_dense_slice_stage_a  replaces ::coalesced_stage_a.  Lane j of
//       block b reads flat[starts[b] + (local_off ? local_off[b, j] : j)]:
//       one coalesced N-word slice per block (strided runs permuted by the
//       index).  The TPU keeps the whole flat view resident in VMEM; here it
//       stays in global memory.
//
// Per lane: the "mul_all" combine (product of up to two gathered operands,
// then one elementwise operand), then the segmented ladder in shared
// memory: step k sets t[j] = op(t[j], t[j + 2^k]) where seg[j] ==
// seg[j + 2^k]; lanes past N read the identity and SEG_PAD.  A FULL_REDUCE
// block (op == -1, or full[b] != 0 in a fused mixed section) instead runs
// ceil(log2 N) unmasked steps and keeps the result in lane 0 only: lane 0 of
// an unmasked shift ladder with offsets 1, 2, 4, ... builds exactly the
// pairs of the pairwise halving tree (engine._halving_tree), so the result
// is bitwise equal to the plain torch version for every N.
//
// Exactness: float products and sums use __fmul_rn / __fadd_rn, which nvcc
// never contracts into an FMA (a contracted value*x + t differs from the
// separate torch ops by up to 1 ulp).  int32 add/mul wrap through unsigned
// arithmetic, as torch's int32 ops do.
//
// Bound on this card: bytes.  Per exec block of N lanes the window kernel
// must read the window ids its lanes select (4 B each; window 0's alone for
// stream launches), slot, off, seg and value per lane (4 x N x 4 B; seg and
// value only for stream launches) and write N x 4 B; the dense-slice kernel
// reads starts (4 B), seg and value per lane, plus local_off for strided
// runs, and writes N x 4 B.  On top, each launch must read every distinct
// gathered word its lanes use once: neighbouring blocks share most of x (on
// a banded matrix each word serves ~50 lanes), and x fits the 50 MB L2.
// The design reads each metadata word once, with neighbouring threads on
// neighbouring addresses (one thread per lane, rows_per_step blocks per
// CTA), leaves x's reuse to L2, and keeps the ladder in shared memory.
//
// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSegPad = -(1 << 30);
constexpr int kFullReduce = -1;
constexpr int kMaxThreads = 1024;

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
    // NaN propagates, as torch.maximum / torch.minimum do
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

struct Args {
  // window form
  const int32_t* win;        // (Bc, >= ls) window ids, row stride win_ld
  long long win_ld;
  int stream;                // 1: lane j reads word j of window 0
  const int32_t* slot;       // (Bc, N)
  const int32_t* off;        // (Bc, N)
  // dense-slice form
  const int32_t* starts;     // (Bc,)
  const int32_t* local_off;  // (Bc, N) or null for identity runs
  // both
  const void* g0;            // gathered operands, flat (data_len,)
  const void* g1;            // or null
  const void* e0;            // elementwise operand (Bc, N), or null
  const int32_t* seg;        // (Bc, N)
  const int32_t* full;       // (Bc,) native-reduce flags, or null
  void* out;                 // (Bc, N)
  int n;                     // lanes per block
  int op;                    // ladder depth, or kFullReduce
  int steps_full;            // ceil(log2 n)
  int steps;                 // steps the CTA runs
  int rows;                  // exec blocks per CTA
};

template <typename T, int R, bool kDense>
__global__ void stage_a_kernel(Args a) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int n = a.n;
  const int lane = threadIdx.x;
  const int ny = blockDim.y;
  T* tb = reinterpret_cast<T*>(smem) + threadIdx.y * n;
  int* sb = reinterpret_cast<int*>(smem + sizeof(T) * ny * n) + threadIdx.y * n;
  const T* g0 = static_cast<const T*>(a.g0);
  const T* g1 = static_cast<const T*>(a.g1);
  const T* e0 = static_cast<const T*>(a.e0);
  T* out = static_cast<T*>(a.out);
  const T ident = Ops<T, R>::identity();

  // every thread runs the same number of iterations (the barriers below);
  // rows past a.rows only take part in them
  for (int r0 = 0; r0 < a.rows; r0 += ny) {
    const int r = r0 + threadIdx.y;
    const bool active = r < a.rows;
    const long long b = (long long)blockIdx.x * a.rows + r;
    const long long li = b * n + lane;
    T term = ident;
    int sg = kSegPad;
    bool full_row = a.op == kFullReduce;
    if (active) {
      long long idx;
      if (kDense) {
        idx = (long long)a.starts[b] + (a.local_off ? a.local_off[li] : lane);
      } else {
        const int32_t* wrow = a.win + b * a.win_ld;
        idx = a.stream ? (long long)wrow[0] * n + lane
                       : (long long)wrow[a.slot[li]] * n + a.off[li];
      }
      term = g0[idx];
      if (g1) term = Ops<T, R>::mul(term, g1[idx]);
      if (e0) term = Ops<T, R>::mul(term, e0[li]);
      sg = a.seg[li];
      if (a.full && a.full[b]) full_row = true;
    }
    const T orig = term;
    tb[lane] = term;
    sb[lane] = sg;
    __syncthreads();
    for (int k = 0; k < a.steps; ++k) {
      const int d = 1 << k;
      const bool inside = lane + d < n;
      const T partner = inside ? tb[lane + d] : ident;
      const bool apply = full_row ? k < a.steps_full
                                  : (k < a.op && inside && sb[lane + d] == sg);
      __syncthreads();
      if (apply) {
        term = Ops<T, R>::op(term, partner);
        tb[lane] = term;
      }
      __syncthreads();
    }
    if (active) out[li] = (full_row && lane != 0) ? orig : term;
  }
}

int ceil_log2(int n) {
  int s = 0;
  while ((1 << s) < n) ++s;
  return s;
}

template <typename T, bool kDense>
int launch_typed(int reduce, Args a, int bc, cudaStream_t stream) {
  const int ny = a.rows < kMaxThreads / a.n ? a.rows : kMaxThreads / a.n;
  const dim3 block(a.n, ny);
  const dim3 grid(bc / a.rows);
  const size_t shmem = (size_t)ny * a.n * (sizeof(T) + sizeof(int));
  switch (reduce) {
    case kAdd: stage_a_kernel<T, kAdd, kDense><<<grid, block, shmem, stream>>>(a); break;
    case kMul: stage_a_kernel<T, kMul, kDense><<<grid, block, shmem, stream>>>(a); break;
    case kMax: stage_a_kernel<T, kMax, kDense><<<grid, block, shmem, stream>>>(a); break;
    case kMin: stage_a_kernel<T, kMin, kDense><<<grid, block, shmem, stream>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool kDense>
int launch(int dtype, int reduce, Args a, int bc, int mixed, void* stream) {
  if (a.n < 1 || a.n > kMaxThreads || a.rows < 1 || bc % a.rows != 0 || !a.g0)
    return (int)cudaErrorInvalidValue;
  if (bc == 0) return (int)cudaSuccess;
  a.steps_full = ceil_log2(a.n);
  if (a.op == kFullReduce) {
    a.steps = a.steps_full;
  } else {
    a.steps = a.op;
    if (mixed && a.steps_full > a.steps) a.steps = a.steps_full;
  }
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
    int n, int op, int rows, void* stream) {
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
  a.n = n;
  a.op = op;
  a.rows = rows;
  return launch<false>(dtype, reduce, a, bc, full != nullptr, stream);
}

extern "C" int unroll_dense_slice_stage_a(
    int dtype, int reduce, const void* starts, const void* local_off,
    const void* g0, const void* g1, const void* e0, const void* seg,
    const void* full, void* out, int bc, int n, int op, int rows,
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
  a.n = n;
  a.op = op;
  a.rows = rows;
  return launch<true>(dtype, reduce, a, bc, full != nullptr, stream);
}
