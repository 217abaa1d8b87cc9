// Work items grouped by query on the card: the first kernel of each call of
// K7 (dense_flat.cu). (K8, merge_tail.cu, groups its rows across the whole
// grid inside its one cooperative kernel instead.)
//
// One CTA of kThreads threads takes a call's W work items, each with a
// query id, and lays them out for a select kernel that gives one warp to
// each tile of up to kTileRows items of one query:
// * a histogram of the qids in [0, num_queries) (shared memory atomics, one
//   a warp per distinct qid, `__match_any_sync`; a thread's loads all in
//   flight at once up to kThreads * kUnroll items); other qids are left
//   out;
// * a block scan into CSR offsets `qptr` [Q + 1] and each query's first
//   tile `qtile0` [Q + 1] (a query with no item has one empty tile, so that
//   every query's output is written), `tile_q` naming each tile's query;
// * a scatter of item indices into `order`, grouped by query. Within a
//   query the scatter's order is that of its warps' atomics: the select
//   kernels' results do not depend on it.
// It also zeroes the per-query `done` counters and shared keys `qth`.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qid_group {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kUnroll = 8;
// queries whose counters live in shared memory; more go to `cursor`
constexpr int kSharedQ = 8192;

// The group kernel's output, read by the select kernel (scratch of one
// call).
struct Groups {
  unsigned long long* qth;  // [Q] best k-th key a tile of the query has
  int32_t* qptr;    // [Q + 1] item offsets by query
  int32_t* cursor;  // [Q] counts, then scatter cursors (Q > kSharedQ)
  int32_t* qtile0;  // [Q + 1] first tile of each query; [Q] = tiles
  int32_t* done;    // [Q] tiles finished
  int32_t* order;   // [W] item indices grouped by query
  int32_t* tile_q;  // [tiles] query of each tile
};

// An upper bound on the tiles of a call.
inline long long tiles_max(int n_items, int num_queries, int tile_rows) {
  return (long long)n_items / tile_rows + num_queries + 1;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Exclusive scan of (x, y) over the kThreads threads of the block; `total`
// gets the sums. Every thread of the block calls it.
__device__ __forceinline__ int2 block_scan2(int2 v, int2* warp_sums,
                                            int2* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFull, inc.x, d);
    const int y = __shfl_up_sync(kFull, inc.y, d);
    if (lane >= d) {
      inc.x += x;
      inc.y += y;
    }
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int2 s = warp_sums[lane];
    int2 si = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(kFull, si.x, d);
      const int y = __shfl_up_sync(kFull, si.y, d);
      if (lane >= d) {
        si.x += x;
        si.y += y;
      }
    }
    warp_sums[lane] = make_int2(si.x - s.x, si.y - s.y);
    if (lane == 31) *total = si;
  }
  __syncthreads();
  const int2 base = warp_sums[warp];
  const int2 out = make_int2(base.x + inc.x - v.x, base.y + inc.y - v.y);
  __syncthreads();
  return out;
}

// The body of a group kernel: one CTA of kThreads threads.
template <int kTileRows>
__device__ __forceinline__ void group_by_query(const int32_t* qids, int W,
                                               int Q, const Groups& g) {
  __shared__ int32_t s_cnt[kSharedQ];
  __shared__ int2 warp_sums[32];
  __shared__ int2 total;
  const int tid = threadIdx.x, lane = tid & 31;
  int32_t* cnt = Q <= kSharedQ ? s_cnt : g.cursor;
  for (int q = tid; q < Q; q += kThreads) cnt[q] = 0;
  __syncthreads();

  // the histogram: one shared atomic a warp per distinct qid
  for (int base = 0; base < W; base += kThreads * kUnroll) {
    int32_t qs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + tid;
      qs[u] = i < W ? __ldg(qids + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = qs[u] >= 0 && qs[u] < Q;
      const unsigned peers = __match_any_sync(kFull, ok ? qs[u] : -1);
      if (ok && (peers & lanemask_lt()) == 0) {
        atomicAdd(cnt + qs[u], __popc(peers));
      }
    }
  }
  __syncthreads();

  // offsets and tiles
  int carry_items = 0, carry_tiles = 0;
  for (int base = 0; base < Q; base += kThreads) {
    const int q = base + tid;
    int n = 0, nt = 0;
    if (q < Q) {
      n = cnt[q];
      nt = n > 0 ? (n + kTileRows - 1) / kTileRows : 1;
    }
    const int2 ex = block_scan2(make_int2(n, nt), warp_sums, &total);
    if (q < Q) {
      const int p = carry_items + ex.x, t0 = carry_tiles + ex.y;
      g.qptr[q] = p;
      g.qtile0[q] = t0;
      g.done[q] = 0;
      g.qth[q] = 0ull;
      cnt[q] = p;  // from here on the query's scatter cursor
      for (int j = 0; j < nt; ++j) g.tile_q[t0 + j] = q;
    }
    carry_items += total.x;
    carry_tiles += total.y;
  }
  if (tid == 0) {
    g.qptr[Q] = carry_items;
    g.qtile0[Q] = carry_tiles;
  }
  __syncthreads();

  // the scatter: each warp's items of one qid take consecutive places
  for (int base = 0; base < W; base += kThreads * kUnroll) {
    int32_t qs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + tid;
      qs[u] = i < W ? __ldg(qids + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool ok = qs[u] >= 0 && qs[u] < Q;
      const unsigned peers = __match_any_sync(kFull, ok ? qs[u] : -1);
      const int leader = __ffs(peers) - 1;
      int p = 0;
      if (ok && lane == leader) p = atomicAdd(cnt + qs[u], __popc(peers));
      p = __shfl_sync(kFull, p, leader);
      if (ok) {
        g.order[p + __popc(peers & lanemask_lt())] =
            base + u * kThreads + tid;
      }
    }
  }
}

}  // namespace qid_group
