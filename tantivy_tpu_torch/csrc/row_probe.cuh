// The probe shared by the port's probe kernels (K1, K3, K4 and K6): is a
// lane's doc in a window of cstore rows of one term region, and with what
// tf? (K4 and K6 bound each term's rows by `warp_lower_bound` over the
// blocks' last docs, then find a lane's row by `lower_bound_shared` over
// staged last docs or by `lower_bound4`, and settle it with `probe_row` or
// `probe_row_at`, the `_at` form giving the lane of the hit.)
//
// Precondition (checked where the fused store is built, and the callers
// clip every window to its region): inside a region docs ascend strictly
// across rows, apart from TERMINATED padding after the last doc, and every
// row holds a doc. So a doc can lie in at most one window row, the last one
// whose first doc (its fence) is <= it, and a search over the fences, then
// one search in the row found, settles the probe; its tf is the sum the TPU
// kernels' equality compares take.
//
// The cost on an H100 is the latency of dependent loads, so both searches
// are 4-ary: each step loads 3 pivots at once and keeps the quarter that
// holds the doc. A window of n rows takes ceil(log4(n)) fence steps; a row
// of 128 docs takes 3 steps (32-doc block, 8-doc octet, then the octet's
// docs and tfs as four 16-byte loads) instead of the 8 of a binary search.

#pragma once

#include <stdint.h>

namespace tantivy_port {

constexpr int kProbeRowWords = 384;  // docs | tfs | bitcast(cachev)
constexpr int kProbeLanes = 128;

// The first index i in [lo, lo + n) with keys[i] >= doc, or lo + n. Each
// step loads 3 pivots at once and keeps the quarter that holds the answer.
__device__ __forceinline__ long long lower_bound4(
    const int32_t* __restrict__ keys, long long lo, long long n,
    int32_t doc) {
  // the answer lies in [lo, lo + n]
  while (n > 0) {
    const long long q = (n + 3) >> 2;
    int k = 0;
#pragma unroll
    for (int i = 1; i <= 3; ++i) {
      if (i * q <= n) k += __ldg(keys + lo + i * q - 1) < doc ? 1 : 0;
    }
    lo += k * q;
    // the pivot after the kept quarter, where one was loaded, is >= doc
    n = (k < 3 && (k + 1) * q <= n) ? q - 1 : n - k * q;
  }
  return lo;
}

// lower_bound4's answer found by a whole warp at once: each step loads up to
// 32 pivots, one a lane, and one ballot keeps the 32nd that holds the
// answer, so a region of n rows takes ceil(log32(n + 1)) steps. Every lane
// of the warp calls it with the same arguments and gets the answer.
__device__ __forceinline__ long long warp_lower_bound(
    const int32_t* __restrict__ keys, long long lo, long long n,
    int32_t doc) {
  const int wl = threadIdx.x & 31;
  // the answer lies in [lo, lo + n]
  while (n > 0) {
    const long long q = (n + 31) >> 5;
    const long long at = (long long)(wl + 1) * q;
    const bool below = at <= n && __ldg(keys + lo + at - 1) < doc;
    // keys ascend, so the pivots below doc are a prefix of the lanes
    const long long k = __popc(__ballot_sync(0xffffffffu, below));
    lo += k * q;
    // the pivot after the kept part, where one was loaded, is >= doc
    n = (k + 1) * q <= n ? q - 1 : n - k * q;
  }
  return lo;
}

// The first index i in [0, n) with keys[i] >= doc, or n, over keys in
// shared memory (binary steps).
__device__ __forceinline__ int lower_bound_shared(const int32_t* keys, int n,
                                                  int32_t doc) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (keys[lo + half] < doc) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// Probes doc in one cstore row (its 128 ascending docs, then their tfs):
// returns whether it is there and sets *tf to its tf (0 when absent) and,
// when it is there, *lane to its lane.
__device__ __forceinline__ bool probe_row_at(
    const int32_t* __restrict__ docs, int32_t doc, int32_t* tf, int* lane) {
  // the doc's lower bound among the row's 128 ascending docs: its 32-doc
  // block, then its 8-doc octet, then the octet itself
  int base = 0;
#pragma unroll
  for (int span = 32; span >= 8; span >>= 2) {
    int k = 0;
#pragma unroll
    for (int i = 1; i <= 3; ++i) {
      k += __ldg(docs + base + i * span - 1) < doc ? 1 : 0;
    }
    base += k * span;
  }
  const int4* d4 = reinterpret_cast<const int4*>(docs + base);
  const int4* t4 = reinterpret_cast<const int4*>(docs + kProbeLanes + base);
  const int4 d0 = __ldg(d4);
  const int4 d1 = __ldg(d4 + 1);
  const int4 t0 = __ldg(t4);
  const int4 t1 = __ldg(t4 + 1);
  const int32_t dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
  const int32_t tv[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
  bool hit = false;
  *tf = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (dv[i] == doc) {
      hit = true;
      *tf = tv[i];
      *lane = base + i;
    }
  }
  return hit;
}

__device__ __forceinline__ bool probe_row(const int32_t* __restrict__ docs,
                                          int32_t doc, int32_t* tf) {
  int lane;
  return probe_row_at(docs, doc, tf, &lane);
}

// Probes doc in the rows [a, b) of one region, a < b: returns whether it is
// there and sets *tf to its tf (0 when absent) and, when it is there, *row
// and *lane to where.
__device__ __forceinline__ bool probe_window_at(
    const int32_t* __restrict__ cstore, int a, int b, int32_t doc,
    int32_t* tf, int* row_at, int* lane) {
  // the row: the last of the window whose fence is <= doc, else the first;
  // each step keeps a quarter, ceil(log4(b - a)) steps
  int row = a;
  int n = b - a;
  while (n > 1) {
    const int q = (n + 3) >> 2;
    int k = 0;
#pragma unroll
    for (int i = 1; i <= 3; ++i) {
      if (i * q < n) {
        k += __ldg(cstore + (long long)(row + i * q) * kProbeRowWords) <= doc
                 ? 1
                 : 0;
      }
    }
    row += k * q;
    n = min(q, n - k * q);
  }
  *row_at = row;
  return probe_row_at(cstore + (long long)row * kProbeRowWords, doc, tf,
                      lane);
}

__device__ __forceinline__ bool probe_window(
    const int32_t* __restrict__ cstore, int a, int b, int32_t doc,
    int32_t* tf) {
  int row, lane;
  return probe_window_at(cstore, a, b, doc, tf, &row, &lane);
}

}  // namespace tantivy_port
