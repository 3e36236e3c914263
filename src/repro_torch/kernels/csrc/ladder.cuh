// The segmented ladder of the Intelligent-Unroll kernels, for Hopper.
//
// Shared by the stage-A kernels (unroll_spmv/csrc/stage_a.cu) and the
// standalone segmented reduction (segment_reduce/csrc/segment_reduce.cu):
// both are an index policy (which row of the gathered operand lane j of
// block b reads) over the two kernel bodies below, so they run one copy of
// the code that fixes their bitwise order.
//
// The ladder: step k sets t[j] = op(t[j], t[j + 2^k]) where seg[j] ==
// seg[j + 2^k]; lanes past N read the identity and kSegPad.  A FULL_REDUCE
// row instead runs ceil(log2 N) unmasked steps and keeps the result in lane
// 0 only: lane 0 of an unmasked shift ladder with offsets 1, 2, 4, ... builds
// exactly the pairs of the pairwise halving tree (kernels/common.py
// halving_tree), which pads an odd level with the identity, for every N.
//
// Design: one warp runs one (row, column) ladder in registers, with no
// barrier between its steps.  Thread t holds the L = 2^ceil(log2(N / 32))
// lanes i*32 + t (i < L) of the row, the identity and kSegPad past N.  A
// step of distance d < 32 is one __shfl_sync per held lane from thread
// (t + d) mod 32; where t + d passes 31 the partner is that thread's next
// register.  A step of distance d >= 32 is a register move (register
// i + d/32).  Every partner value is taken before any lane is updated, so a
// step reads the values of the step before, as a shared-memory ladder with
// a barrier per step did: the pairs and their order are the same, and so
// are the bits.  Which lanes apply step k (seg[j] == seg[j + d], j + d < N,
// k below the row's depth) is computed once per row, by the same exchange
// on the segment ids, into one bitmask per step (bit i for lane i*32 + t).
//
//   D = 1 (rows_kernel): a CTA holds `rows` exec blocks, one warp per row
//       in turn; a thread loads, combines, ladders and stores its L lanes
//       directly, neighbouring threads on neighbouring lanes.  No shared
//       memory, no barrier, no per-column arithmetic.
//   D > 1 (cols_kernel): a CTA takes dt columns of its rows (all of D
//       where two rows of them fit 48 KB of shared memory, else the fewest
//       equal column tiles, walked by grid axis y) and loops over passes
//       of ny rows.  Per pass: (1) one warp per row builds its step masks
//       into shared memory; (2) the threads load the gathered rows of x,
//       neighbouring threads on neighbouring words (16-byte vectors where
//       D and the pointers allow), combine, and transpose into a (row,
//       column, lane) buffer whose lane stride is padded against bank
//       conflicts; barrier; (3) each warp runs a run of kColsPerWarp
//       (row, column) ladders in registers, two columns of a row at once
//       where L <= 8 so that their shuffles overlap, reading a column's
//       lanes with consecutive threads on consecutive words; barrier; (4)
//       the threads write the buffer out as coalesced (Bc, N, D) rows.
//       Two barriers per pass; a CTA with more than one pass alternates two
//       buffers, so the next pass's loads never wait for this pass's
//       stores.
//
// What bounds it: bytes at D = 1 (each thread's L gathers are independent
// loads, issued before the step masks so that the masks' shuffles overlap
// them).  At D > 1, per lane and column, ~5 shuffles, their wrap selects
// and up to ceil(log2 N) ops against 4-8 bytes moved: the SM shuffles one
// warp-wide register per clock, so the shuffles and the latency of each
// step's dependent chain come close to the bytes.  Fewer warps per CTA,
// each with more independent ladders in flight, measured faster on the
// H100 than more warps with fewer (PERF.md, section 6), except in a launch
// of fewer CTAs than SMs, which takes one CTA's latency: there each warp
// takes two columns.
//
// The combine (stage A only) is one of two forms, fixed per launch:
// "mul_all" g0 * g1 * e0 and "add_all" g0 + g1 + e0 (+ c), each over the
// operands present, in that order, where c is a scalar addend of the
// launch (BFS's level + 1).  The form is a run-time argument, tested once
// per row (D = 1) or per pass of rows (D > 1) around a loop compiled for
// each form, so neither form's loop carries the other's branch and the
// kernel count stays that of one form.  At D = 1 every operand is loaded
// before that test and before the step masks' shuffles, which overlap the
// loads' latency.  Lanes past N hold the reduce identity and are
// never combined: for int32 min that identity is INT32_MAX, which + 1
// would wrap.
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
constexpr int kMaxLanes = 1024;
constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;           // warps per CTA
constexpr int kColsPerWarp = 8;        // (row, column) ladders per warp, D > 1
constexpr int kMaxPassRows = 16;       // rows per pass, D > 1
constexpr size_t kShmemBudget = 48 * 1024;   // no opt-in attribute needed
constexpr unsigned kAllLanes = 0xffffffffu;

enum Reduce { kAdd = 0, kMul = 1, kMax = 2, kMin = 3 };
// the combine forms; kAddAllConst is "add_all" with the launch's addend
enum Combine { kMulAll = 0, kAddAll = 1, kAddAllConst = 2 };

template <typename T, int R> struct Ops;

template <int R> struct Ops<float, R> {
  __device__ static float identity() {
    if (R == kAdd) return 0.0f;
    if (R == kMul) return 1.0f;
    if (R == kMax) return -__int_as_float(0x7f800000);
    return __int_as_float(0x7f800000);
  }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
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
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
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
  __device__ static int32_t add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
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

// Columns of one row a warp ladders at once (their shuffles overlap), as
// far as the registers allow.
template <int L>
constexpr int kLadderCols = L <= 8 ? 2 : 1;

// Ladder steps a thread holding L lanes can take: log2(32 L).
template <int L>
constexpr int kSteps = L >= 32 ? 10 : L >= 16 ? 9 : L >= 8 ? 8 : L >= 4 ? 7
                     : L >= 2 ? 6 : 5;

// The operands of a launch; the index policy says which row of g0 / g1
// lane j of block b reads.  e0, seg and full are per lane / per block.
struct Operands {
  const void* g0;            // gathered operands, (rows, D)
  const void* g1;            // or null
  const void* e0;            // elementwise operand (Bc, N), or null
  const int32_t* seg;        // (Bc, N) segment ids
  const int32_t* full;       // (Bc,) native-reduce flags, or null
  void* out;                 // (Bc, N, D)
  int combine;               // a Combine form
  double addend;             // c of kAddAllConst, exact in the value type
};

// The shape of a launch, fixed on the host.
struct Plan {
  int n;           // lanes per row
  int op;          // ladder depth, or kFullReduce
  int steps_full;  // ceil(log2 n)
  int lanes;       // L: lanes per thread, a power of two >= n / 32
  long long d;     // trailing width D
  int rows;        // exec blocks per CTA
  int warps;       // warps per CTA
  // D > 1 only
  int dt;          // columns per CTA, a multiple of vec
  int vec;         // elements per global access: 1, or 16 bytes' worth
  int ny;          // rows per pass
  int nbuf;        // value buffers: 2 when the CTA runs more than one pass
  int pitch;       // lane stride of a column in the shared buffer (>= n)
  size_t shmem;    // dynamic shared memory per CTA
};

// The least pitch >= n over which a warp's transposing accesses spread
// best across the 32 banks: thread q takes (lane q / groups, column group
// q % groups) and touches word (group * vec * pitch + lane) * es / 4.
inline int pick_pitch(int n, int groups, int vec, size_t es) {
  int best = n, best_cost = 1 << 30;
  for (int pitch = n; pitch < n + kWarp; ++pitch) {
    int hits[kWarp] = {0};
    int cost = 0;
    for (int q = 0; q < kWarp; ++q) {
      const int lane = q / groups, g = q % groups;
      if (lane >= n) break;
      const long long word = ((long long)g * vec * pitch + lane) * (long long)(es / 4);
      const int h = ++hits[word % kWarp];
      if (h > cost) cost = h;
    }
    if (cost < best_cost) {
      best_cost = cost;
      best = pitch;
    }
  }
  return best;
}

// `aligned`: every pointer that a D > 1 launch moves in vectors (g0, g1,
// out) is 16-byte aligned; `ctas_x` CTAs along grid axis x, on a card of
// `sms` SMs.
inline Plan make_plan(int n, long long d, int rows, int op, size_t es,
                      bool aligned, long long ctas_x, int sms) {
  Plan p = {};
  p.n = n;
  p.op = op;
  p.steps_full = ceil_log2(n);
  p.lanes = 1;
  while (p.lanes * kWarp < n) p.lanes *= 2;
  p.d = d;
  p.rows = rows;
  if (d == 1) {
    p.warps = rows < kMaxWarps ? rows : kMaxWarps;
    return p;
  }
  const int vw = (int)(16 / es);
  p.vec = aligned && d % vw == 0 ? vw : 1;
  // a row's step masks (one word per step and thread) and flags word
  const size_t row_meta = (size_t)ceil_log2(kWarp * p.lanes) * kWarp * 4 + 4;
  // columns per CTA: all of D where two rows of them fit, else the fewest
  // equal tiles of whole vectors that do (sized at the widest pitch)
  const long long col_bytes = (long long)(n + kWarp - 1) * (long long)es;
  long long cap = (long long)(kShmemBudget - row_meta) / (2 * col_bytes) / p.vec;
  if (cap < 1) cap = 1;
  const long long dv = d / p.vec;
  const long long tiles = (dv + cap - 1) / cap;
  p.dt = (int)((dv + tiles - 1) / tiles) * p.vec;
  const int groups = p.dt / p.vec;
  p.pitch = pick_pitch(n, groups, p.vec, es);
  // rows per pass: every row of the CTA where they fit, else as many as
  // fit twice (two buffers)
  for (p.ny = rows < kMaxPassRows ? rows : kMaxPassRows;; --p.ny) {
    p.nbuf = p.ny < rows ? 2 : 1;
    p.shmem = (size_t)p.nbuf * p.ny * p.dt * p.pitch * es +
              (size_t)p.ny * row_meta;
    if (p.shmem <= kShmemBudget || p.ny == 1) break;
  }
  // kColsPerWarp ladders per warp.  A launch of fewer CTAs than the card
  // has SMs takes as long as one CTA, so there each warp takes only two
  // columns.  Either way every column group gets a thread (groups <= dt <=
  // 189 columns, under 8 warps' 256).
  const bool few = ctas_x * ((d + p.dt - 1) / p.dt) < sms;
  const int per_warp = few ? 2 : kColsPerWarp;
  const int warps = (p.ny * p.dt + per_warp - 1) / per_warp;
  p.warps = warps < kMaxWarps ? warps : kMaxWarps;
  return p;
}

// part[i] = the value of lane i*32 + t + 2^k, where x[i] holds lane
// i*32 + t; `pad` past the thread's last register.  k is a constant of the
// caller's unrolled loop, so every register index is static.
template <typename V, int L>
__device__ __forceinline__ void partners(const V (&x)[L], V (&part)[L],
                                         int k, V pad, int t) {
  const int dist = 1 << k;
  if (dist < kWarp) {
    V s[L];
#pragma unroll
    for (int i = 0; i < L; ++i)
      s[i] = __shfl_sync(kAllLanes, x[i], (t + dist) & (kWarp - 1));
    const bool wrap = t + dist >= kWarp;
#pragma unroll
    for (int i = 0; i < L; ++i)
      part[i] = wrap ? (i + 1 < L ? s[i + 1] : pad) : s[i];
  } else {
    const int m = dist / kWarp;
#pragma unroll
    for (int i = 0; i < L; ++i) part[i] = i + m < L ? x[i + m] : pad;
  }
}

// The row's step masks: bit i of m[k] says lane i*32 + t applies step k.
// A FULL_REDUCE row applies every step below `steps` on every real lane;
// any other row where the partner is a real lane of the same segment.
// Warp-uniform: the whole warp holds the row.
template <int L>
__device__ __forceinline__ void step_masks(const int (&sg)[L], int n,
                                           int steps, bool full, int t,
                                           uint32_t (&m)[kSteps<L>]) {
#pragma unroll
  for (int k = 0; k < kSteps<L>; ++k) {
    m[k] = 0;
    if (k >= steps) continue;
    if (full) {
#pragma unroll
      for (int i = 0; i < L; ++i)
        if (i * kWarp + t < n) m[k] |= 1u << i;
      continue;
    }
    int part[L];
    partners<int, L>(sg, part, k, kSegPad, t);
#pragma unroll
    for (int i = 0; i < L; ++i)
      if (i * kWarp + t + (1 << k) < n && sg[i] == part[i]) m[k] |= 1u << i;
  }
}

// `steps` steps of the ladder over C rows (or columns of one row) held in
// v, all sharing the step masks m; the C ladders are independent, so their
// shuffles overlap.
template <typename T, int R, int L, int C>
__device__ __forceinline__ void run_ladder(T (&v)[C][L],
                                           const uint32_t (&m)[kSteps<L>],
                                           int steps, int t) {
#pragma unroll
  for (int k = 0; k < kSteps<L>; ++k) {
    if (k >= steps) break;
    T part[C][L];
#pragma unroll
    for (int c = 0; c < C; ++c)
      partners<T, L>(v[c], part[c], k, Ops<T, R>::identity(), t);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int i = 0; i < L; ++i)
        if ((m[k] >> i) & 1u) v[c][i] = Ops<T, R>::op(v[c][i], part[c][i]);
  }
}

// The ladders of C neighbouring columns of one row in the shared buffer,
// column c at col + c * pitch, in place; a FULL_REDUCE row writes lane 0
// only, so the other lanes keep their value.
template <typename T, int R, int L, int C>
__device__ __forceinline__ void column_ladders(T* col, int pitch, int n,
                                               const uint32_t (&m)[kSteps<L>],
                                               int steps, bool full, int t) {
  T v[C][L];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int lane = i * kWarp + t;
      v[c][i] = lane < n ? col[c * pitch + lane] : Ops<T, R>::identity();
    }
  run_ladder<T, R, L, C>(v, m, steps, t);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (full) {
      if (t == 0) col[c * pitch] = v[c][0];
      continue;
    }
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int lane = i * kWarp + t;
      if (lane < n) col[c * pitch + lane] = v[c][i];
    }
  }
}

// A row's depth: the full ladder for a FULL_REDUCE row, else op steps, of
// which those of distance >= n are no-ops.
__device__ __forceinline__ int row_steps(const Plan& p, bool full) {
  return full ? p.steps_full : (p.op < p.steps_full ? p.op : p.steps_full);
}

__device__ __forceinline__ bool row_full(const Plan& p, const Operands& o,
                                         long long b) {
  return p.op == kFullReduce || (o.full != nullptr && o.full[b] != 0);
}

// a * b for "mul_all" (F = kMulAll), a + b for "add_all"
template <typename T, int R, int F>
__device__ __forceinline__ T apply(T a, T b) {
  return F == kMulAll ? Ops<T, R>::mul(a, b) : Ops<T, R>::add(a, b);
}

// Form F's combine of lane li's g0 value x with g1[src] and e0[li], the
// operands present, in that order, then + c where `with_c` ("add_all").
template <typename T, int R, int F>
__device__ __forceinline__ T combine(T x, const T* g1, long long src,
                                     const T* e0, long long li, bool with_c,
                                     T c) {
  if (g1) x = apply<T, R, F>(x, g1[src]);
  if (e0) x = apply<T, R, F>(x, e0[li]);
  if (F != kMulAll && with_c) x = Ops<T, R>::add(x, c);
  return x;
}

// Form F's combine of a thread's L lanes, their g1 values y and
// elementwise values e already loaded (lanes past n keep the identity:
// they are never combined).
template <typename T, int R, int F, int L>
__device__ __forceinline__ void combine_row(T (&v)[L], const T (&y)[L],
                                            const T (&e)[L], bool has_g1,
                                            bool has_e0, int n, int t,
                                            const Operands& o) {
  const bool with_c = o.combine == kAddAllConst;
  const T c = static_cast<T>(o.addend);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (i * kWarp + t >= n) continue;
    T x = v[i];
    if (has_g1) x = apply<T, R, F>(x, y[i]);
    if (has_e0) x = apply<T, R, F>(x, e[i]);
    if (F != kMulAll && with_c) x = Ops<T, R>::add(x, c);
    v[i] = x;
  }
}

// D = 1: warp w takes rows w, w + warps, ... of the CTA's `rows`.
template <typename T, int R, int L, class Index>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
    rows_kernel(Index ix, Operands o, Plan p) {
  const int t = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  const int n = p.n;
  const T* g0 = static_cast<const T*>(o.g0);
  const T* g1 = static_cast<const T*>(o.g1);
  const T* e0 = static_cast<const T*>(o.e0);
  T* out = static_cast<T*>(o.out);
  const T ident = Ops<T, R>::identity();
  for (int r = w; r < p.rows; r += p.warps) {
    const long long b = (long long)blockIdx.x * p.rows + r;
    const bool full = row_full(p, o, b);
    const int steps = row_steps(p, full);
    // the lanes' metadata, then the gathers it indexes and the elementwise
    // operand, then the step masks, which only need seg and so overlap the
    // loads' latency
    long long src[L];
    int sg[L];
    T v[1][L], y[L], e[L], orig[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int lane = i * kWarp + t;
      const long long li = b * n + lane;
      src[i] = lane < n ? ix(b, lane, li) : 0;
      sg[i] = lane < n ? o.seg[li] : kSegPad;
    }
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int lane = i * kWarp + t;
      const bool real = lane < n;
      v[0][i] = real ? g0[src[i]] : ident;
      y[i] = real && g1 ? g1[src[i]] : ident;
      e[i] = real && e0 ? e0[b * n + lane] : ident;
    }
    uint32_t m[kSteps<L>];
    step_masks<L>(sg, n, steps, full, t, m);
    if (o.combine == kMulAll)
      combine_row<T, R, kMulAll, L>(v[0], y, e, g1, e0, n, t, o);
    else
      combine_row<T, R, kAddAll, L>(v[0], y, e, g1, e0, n, t, o);
#pragma unroll
    for (int i = 0; i < L; ++i) orig[i] = v[0][i];
    run_ladder<T, R, L, 1>(v, m, steps, t);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int lane = i * kWarp + t;
      if (lane < n) out[b * n + lane] = (full && lane != 0) ? orig[i] : v[0][i];
    }
  }
}

template <typename T> struct __align__(16) Vec16 {
  T e[16 / sizeof(T)];
};

// Phase (2) of cols_kernel for combine form F: thread (g, lane0) loads
// column group g of lanes lane0, lane0 + lstride, ... of the pass's nr rows
// from block b0 on, combines and transposes them into
// vals[(r * dt + c) * pitch + lane].
template <typename T, int R, int F, class Index>
__device__ __forceinline__ void load_pass(const Index& ix, const Operands& o,
                                          const Plan& p, T* vals,
                                          long long b0, int nr, int g,
                                          int lane0, int lstride,
                                          long long c0) {
  constexpr int VW = 16 / sizeof(T);
  const int n = p.n, dt = p.dt, pitch = p.pitch;
  const T* g0 = static_cast<const T*>(o.g0);
  const T* g1 = static_cast<const T*>(o.g1);
  const T* e0 = static_cast<const T*>(o.e0);
  const bool with_c = o.combine == kAddAllConst;
  const T c = static_cast<T>(o.addend);
  for (int r = 0; r < nr; ++r) {
    const long long b = b0 + r;
    T* const row = vals + (size_t)r * dt * pitch;
    for (int lane = lane0; lane < n; lane += lstride) {
      const long long li = b * n + lane;
      const long long src = ix(b, lane, li) * p.d + c0 + (long long)g * p.vec;
      T* const dst = row + (size_t)g * p.vec * pitch + lane;
      if (p.vec > 1) {
        const Vec16<T> a = *reinterpret_cast<const Vec16<T>*>(g0 + src);
        Vec16<T> y = {};
        if (g1) y = *reinterpret_cast<const Vec16<T>*>(g1 + src);
        const T ev = e0 ? e0[li] : Ops<T, R>::identity();
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          T x = a.e[e];
          if (g1) x = apply<T, R, F>(x, y.e[e]);
          if (e0) x = apply<T, R, F>(x, ev);
          if (F != kMulAll && with_c) x = Ops<T, R>::add(x, c);
          dst[(size_t)e * pitch] = x;
        }
      } else {
        dst[0] = combine<T, R, F>(g0[src], g1, src, e0, li, with_c, c);
      }
    }
  }
}

// D > 1: dt columns (grid axis y walks the column tiles) of `rows` rows,
// in passes of ny rows; see the header for the four phases.
template <typename T, int R, int L, class Index>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
    cols_kernel(Index ix, Operands o, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int K = kSteps<L>;
  constexpr int VW = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int t = tid & (kWarp - 1);
  const int w = tid / kWarp;
  const int n = p.n, dt = p.dt, pitch = p.pitch;
  const long long d = p.d;
  const long long c0 = (long long)blockIdx.y * dt;
  const int dc = d - c0 < dt ? (int)(d - c0) : dt;   // columns of this tile
  const int groups = dc / p.vec;
  // thread tid loads and stores column group tid % groups of lanes
  // tid / groups, tid / groups + lstride, ... (threads past lstride * groups
  // idle in those phases)
  const int lstride = p.warps * kWarp / groups;
  const int g = tid % groups, lane0 = tid / groups;
  T* out = static_cast<T*>(o.out);
  const size_t buf_elems = (size_t)p.ny * dt * pitch;
  T* const vals0 = reinterpret_cast<T*>(smem);
  uint32_t* const masks = reinterpret_cast<uint32_t*>(vals0 + p.nbuf * buf_elems);
  int* const flags = reinterpret_cast<int*>(masks + p.ny * K * kWarp);

  for (int r0 = 0, pass = 0; r0 < p.rows; r0 += p.ny, ++pass) {
    const int nr = p.rows - r0 < p.ny ? p.rows - r0 : p.ny;
    T* const vals = vals0 + (pass & 1) * buf_elems;
    const long long b0 = (long long)blockIdx.x * p.rows + r0;
    // (1) each row's step masks and flags, one warp per row
    for (int r = w; r < nr; r += p.warps) {
      const long long b = b0 + r;
      const bool full = row_full(p, o, b);
      const int steps = row_steps(p, full);
      int sg[L];
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int lane = i * kWarp + t;
        sg[i] = lane < n ? o.seg[b * n + lane] : kSegPad;
      }
      uint32_t m[K];
      step_masks<L>(sg, n, steps, full, t, m);
#pragma unroll
      for (int k = 0; k < K; ++k) masks[(r * K + k) * kWarp + t] = m[k];
      if (t == 0) flags[r] = steps | (full ? 1 << 16 : 0);
    }
    // (2) load, combine and transpose into vals[(r * dt + c) * pitch + lane]
    if (lane0 < lstride) {
      if (o.combine == kMulAll)
        load_pass<T, R, kMulAll>(ix, o, p, vals, b0, nr, g, lane0, lstride,
                                 c0);
      else
        load_pass<T, R, kAddAll>(ix, o, p, vals, b0, nr, g, lane0, lstride,
                                 c0);
    }
    __syncthreads();
    // (3) the ladders: warp w takes a run of (row, column) pairs,
    // kLadderCols neighbouring columns of a row at a time
    {
      const int pairs = nr * dc;
      const int per = (pairs + p.warps - 1) / p.warps;
      const int hi = (w + 1) * per < pairs ? (w + 1) * per : pairs;
      int row = -1, steps = 0;
      bool full = false;
      uint32_t m[K];
      for (int pr = w * per; pr < hi;) {
        const int r = pr / dc, c = pr - r * dc;
        const int cols =
            kLadderCols<L> == 2 && pr + 1 < hi && c + 1 < dc ? 2 : 1;
        if (r != row) {
          row = r;
#pragma unroll
          for (int k = 0; k < K; ++k) m[k] = masks[(r * K + k) * kWarp + t];
          steps = flags[r] & 0xffff;
          full = (flags[r] >> 16) != 0;
        }
        T* const col = vals + ((size_t)r * dt + c) * pitch;
        if (steps > 0) {
          if (cols == 2)
            column_ladders<T, R, L, kLadderCols<L>>(col, pitch, n, m, steps,
                                                    full, t);
          else
            column_ladders<T, R, L, 1>(col, pitch, n, m, steps, full, t);
        }
        pr += cols;
      }
    }
    __syncthreads();
    // (4) write the pass out as (Bc, N, D) rows
    if (lane0 < lstride) {
      for (int r = 0; r < nr; ++r) {
        const long long b = b0 + r;
        const T* const row = vals + (size_t)r * dt * pitch;
        for (int lane = lane0; lane < n; lane += lstride) {
          const long long dst = (b * n + lane) * d + c0 + (long long)g * p.vec;
          const T* const src = row + (size_t)g * p.vec * pitch + lane;
          if (p.vec > 1) {
            Vec16<T> a;
#pragma unroll
            for (int e = 0; e < VW; ++e) a.e[e] = src[(size_t)e * pitch];
            *reinterpret_cast<Vec16<T>*>(out + dst) = a;
          } else {
            out[dst] = src[0];
          }
        }
      }
    }
  }
}

template <typename T, int R, int L, class Index>
int launch_lanes(const Index& ix, const Operands& o, const Plan& p,
                 unsigned blocks, cudaStream_t s) {
  const unsigned threads = (unsigned)(p.warps * kWarp);
  if (p.d == 1) {
    rows_kernel<T, R, L, Index><<<blocks, threads, 0, s>>>(ix, o, p);
  } else {
    const dim3 grid(blocks, (unsigned)((p.d + p.dt - 1) / p.dt));
    cols_kernel<T, R, L, Index><<<grid, threads, p.shmem, s>>>(ix, o, p);
  }
  return (int)cudaGetLastError();
}

template <typename T, int R, class Index>
int launch_reduce(const Index& ix, const Operands& o, const Plan& p,
                  unsigned blocks, cudaStream_t s) {
  switch (p.lanes) {
    case 1: return launch_lanes<T, R, 1>(ix, o, p, blocks, s);
    case 2: return launch_lanes<T, R, 2>(ix, o, p, blocks, s);
    case 4: return launch_lanes<T, R, 4>(ix, o, p, blocks, s);
    case 8: return launch_lanes<T, R, 8>(ix, o, p, blocks, s);
    case 16: return launch_lanes<T, R, 16>(ix, o, p, blocks, s);
    case 32: return launch_lanes<T, R, 32>(ix, o, p, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Check the shape, plan the launch and run it: `blocks` exec blocks of n
// lanes, `rows` per CTA.  Returns a CUDA error code.
template <typename T, class Index>
int launch(int reduce, const Index& ix, const Operands& o, long long blocks,
           int n, long long d, int op, int rows, cudaStream_t s) {
  if (n < 1 || n > kMaxLanes || rows < 1 || blocks < 0 || d < 1 ||
      op < kFullReduce || !o.g0 || !o.seg || !o.out ||
      o.combine < kMulAll || o.combine > kAddAllConst ||
      (blocks > 0 && blocks % rows != 0))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks / rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)o.g0 | (uintptr_t)o.g1 |
                        (uintptr_t)o.out) % 16 == 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const Plan p = make_plan(n, d, rows, op, sizeof(T), aligned, blocks / rows,
                           sms);
  if (d > 1 && (d + p.dt - 1) / p.dt > 65535) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(blocks / rows);
  switch (reduce) {
    case kAdd: return launch_reduce<T, kAdd>(ix, o, p, grid, s);
    case kMul: return launch_reduce<T, kMul>(ix, o, p, grid, s);
    case kMax: return launch_reduce<T, kMax>(ix, o, p, grid, s);
    case kMin: return launch_reduce<T, kMin>(ix, o, p, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace ladder
