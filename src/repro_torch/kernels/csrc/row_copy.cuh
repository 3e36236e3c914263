// The row copy of the gather kernels, for Hopper (sm_90a).
//
// Shared by gather_vload/csrc/gather_vload.cu and
// moe_dispatch/csrc/row_gather.cu: both move whole rows and do no
// arithmetic.  Output row o takes source row s(o); a row is `row_words`
// words of W = 1, 2, 4, 8 or 16 bytes, the widest access that the row's
// byte count and both base pointers allow.  Each source is an index policy
// (which source row output row o reads) over the one kernel body below.
// Rows come in groups: a policy maps group g's row slot k to its output
// row, its source row and whether the slot is a row.
//
// What bounds it: bytes.  The body keeps kSlots = 4 independent loads in
// flight per thread, all issued before its first store, and issues no
// division per element and no runtime API call:
//
//   short rows (row_words <= 32): a warp takes a group of 32 / tpl * kSlots
//       rows, tpl = 2^log_tpl threads per row (the least power of two
//       covering its words).  Thread (q, w) moves word w of rows q,
//       q + 32 / tpl, ...: a warp access covers whole neighbouring rows.
//   long rows: a warp takes one strip of 32 * kSlots words (2 KB in 16-byte
//       words) of one row, each thread kSlots words.  Strips are the slow
//       axis of the grid: the warps in flight read one strip of the source
//       at a time, so where sources are read many times (the MoE dispatch
//       reads each token top-k times) the strip (T x 2 KB) stays in L2 even
//       when the whole source does not.
//
// Loads go through the read-only path; stores are streaming (__stcs,
// evict-first), since nothing reads the output again, so they do not push
// the sources out of L2.  A CTA is 4 warps, one item (a group, or a strip
// of one row) each; the grid is one item per warp, so the hardware balances
// the items over the SMs and no SM count is needed.  Row and word indices
// are 32-bit; the one product that can pass 2^31 (source or output row
// times row_words) is a 32 x 32 -> 64-bit multiply, so sources and outputs
// of 2^31 bytes or more take the same code.
//
// The host side picks W and log_tpl (kernels/build.py row_copy_shape); any
// log_tpl in [0, 5] gives the same bits, only W must suit the pointers,
// which launch() checks.  The constants come from a scan on the card
// (PERF.md, section 6): 4 slots were faster than 8 (more warps in flight
// for the registers), 4 warps per CTA no slower than 8, and one row per
// long-row item as fast as groups of 2-16 rows whose ids reach the warp by
// a shuffle.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace row_copy {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlots = 4;          // independent loads in flight per thread
constexpr unsigned kFull = 0xffffffffu;

// a / b for a >= 0, b >= 1: a 32-bit division where a fits (a 64-bit one is
// a long instruction sequence on the SM); once per warp, never per element.
__device__ __forceinline__ long long div_index(long long a, long long b) {
  if (a <= UINT_MAX && b <= UINT_MAX) return (unsigned)a / (unsigned)b;
  return a / b;
}

// Source rows read from an int32 id array with row stride `ld`: row_gather
// (ld 1) and gather_vload's stream form (window 0 of each block).
struct IdRows {
  const int32_t* ids;
  long long ld;
  long long rows;
  int per_group;

  long long groups(int rows_per_group) {
    per_group = rows_per_group;
    return (rows + per_group - 1) / per_group;
  }

  // Called by every thread of the warp with its U row slots k[u] of group
  // g (the same slot for all threads of a long-row strip); sets the output
  // row, the source row and whether the slot is a row.
  template <int U>
  __device__ void map(long long g, const int (&k)[U], long long (&o)[U],
                      long long (&s)[U], bool (&ok)[U]) const {
    const long long first = g * per_group;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      o[u] = first + k[u];
      ok[u] = o[u] < rows;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = ok[u] ? __ldg(ids + o[u] * ld) : 0;
  }
};

// gather_vload's lanes: output row b * n + j takes view row
// win[b, slot[b, j]] * n + off[b, j].  A group lies in one block b, so one
// coalesced read gives the warp the block's window ids (thread t holds
// win[b, t]) and a lane's id is a shuffle from thread slot[b, j]; past 32
// windows the id is a load.
struct WindowLanes {
  const int32_t* win;
  long long ld;
  int ls;
  const int32_t* slot;
  const int32_t* off;
  long long blocks;
  int n;
  int per_group;
  int groups_per_block;

  long long groups(int rows_per_group) {
    per_group = rows_per_group;
    groups_per_block = (n + per_group - 1) / per_group;
    return blocks * groups_per_block;
  }

  template <int U>
  __device__ void map(long long g, const int (&k)[U], long long (&o)[U],
                      long long (&s)[U], bool (&ok)[U]) const {
    const long long b = div_index(g, groups_per_block);
    const int j0 = (int)(g - b * groups_per_block) * per_group;
    const int32_t* wrow = win + b * ld;
    const int t = threadIdx.x & 31;
    const int32_t mine = t < ls ? __ldg(wrow + t) : 0;
    int sl[U], of[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + k[u];
      ok[u] = j < n;
      o[u] = b * n + j;
      sl[u] = ok[u] ? __ldg(slot + o[u]) : 0;
      of[u] = ok[u] ? __ldg(off + o[u]) : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int w = __shfl_sync(kFull, mine, sl[u] & 31);
      if (ls > 32) w = ok[u] ? __ldg(wrow + sl[u]) : 0;
      s[u] = (long long)w * n + of[u];
    }
  }
};

// items = groups * strips; short rows have one strip.
template <typename W, class Rows>
__global__ void __launch_bounds__(kThreads)
copy_rows_kernel(Rows rows, const W* __restrict__ src, W* __restrict__ out,
                 int row_words, int log_tpl, long long groups,
                 long long items) {
  constexpr int U = kSlots;
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= items) return;                  // the whole warp together
  const int t = threadIdx.x & 31;
  W v[U];
  if (row_words <= (1 << log_tpl)) {
    const int w = t & ((1 << log_tpl) - 1);
    int k[U];
    long long o[U], s[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) k[u] = (t >> log_tpl) + u * (32 >> log_tpl);
    rows.map(item, k, o, s, ok);
    const bool word = w < row_words;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (ok[u] && word) v[u] = __ldg(src + s[u] * row_words + w);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (ok[u] && word) __stcs(out + o[u] * row_words + w, v[u]);
    return;
  }
  const long long strip = div_index(item, groups);
  const int k[1] = {0};
  long long o[1], s[1];
  bool ok[1];
  rows.map(item - strip * groups, k, o, s, ok);
  if (!ok[0]) return;
  const int c = (int)strip * 32 * U + t;
  const W* from = src + s[0] * row_words;
  W* to = out + o[0] * row_words;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (c + 32 * u < row_words) v[u] = __ldg(from + c + 32 * u);
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (c + 32 * u < row_words) __stcs(to + c + 32 * u, v[u]);
}

template <typename W, class Rows>
int launch_typed(Rows rows, const void* src, void* out, int row_words,
                 int log_tpl, cudaStream_t stream) {
  const bool short_rows = row_words <= (1 << log_tpl);
  const long long groups = rows.groups(short_rows ? (32 >> log_tpl) * kSlots
                                                  : 1);
  const long long strips =
      short_rows ? 1 : (row_words + 32 * kSlots - 1) / (32 * kSlots);
  const long long items = groups * strips;
  if (items == 0) return (int)cudaSuccess;
  const long long grid = (items + kWarps - 1) / kWarps;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  copy_rows_kernel<W, Rows><<<(unsigned)grid, kThreads, 0, stream>>>(
      rows, static_cast<const W*>(src), static_cast<W*>(out), row_words,
      log_tpl, groups, items);
  return (int)cudaGetLastError();
}

// Copies rows of row_bytes bytes as words of `width` bytes.  Returns
// cudaErrorInvalidValue where width is not 1, 2, 4, 8 or 16 or does not
// divide row_bytes or either pointer, or log_tpl is out of range; else
// cudaGetLastError() of the launch (none for zero rows).
template <class Rows>
int launch(Rows rows, const void* src, void* out, long long row_bytes,
           int width, int log_tpl, cudaStream_t stream) {
  if (!src || !out || row_bytes < 1 || log_tpl < 0 || log_tpl > 5 ||
      width < 1 || width > 16 || (width & (width - 1)) ||
      row_bytes % width || ((uintptr_t)src | (uintptr_t)out) % width ||
      row_bytes / width > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int rw = (int)(row_bytes / width);
  switch (width) {
    case 16: return launch_typed<uint4>(rows, src, out, rw, log_tpl, stream);
    case 8: return launch_typed<uint2>(rows, src, out, rw, log_tpl, stream);
    case 4: return launch_typed<uint32_t>(rows, src, out, rw, log_tpl, stream);
    case 2: return launch_typed<uint16_t>(rows, src, out, rw, log_tpl, stream);
    default: return launch_typed<uint8_t>(rows, src, out, rw, log_tpl, stream);
  }
}

}  // namespace row_copy
