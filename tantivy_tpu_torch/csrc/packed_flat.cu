// Packed flat scorer (kernel K5 of the port): bit-packed posting blocks
// decoded on the fly, BM25, and a per-item top-kk, in one kernel.
//
// Replaces two XLA programs of the reference's packed mode, fused:
// `decode_doc_rows` / `decode_tf_rows` (tantivy_tpu/ops/decode.py:58-70),
// which the reference's `DeviceFieldPostings._gather_packed` runs per bit
// width to write dense [W, 128] docs and tfs, and the per-row stage of
// `flat_topk_kernel` (tantivy_tpu/ops/flat_scorer.py:43-95): BM25 over the
// decoded rows and `lax.top_k` of each row. The per-query merge that
// follows is the port's torch merge tail (`per_query_topk_from_rows`).
//
// Work item: (block id, qid) of one (segment, field)'s packed mirror
// (ops/device_index.py, `PackedMirror`). One warp serves kItemsPerWarp
// items at once, interleaved; thread t owns lanes 4t..4t+3 of each. Per
// item:
// * the block's table row, two 16-byte loads: doc row word offset and
//   width, tf row word offset and width, base doc, length;
// * unpack: lane j of a width-w row is bits [j*w % 32, +w) of word
//   j*w / 32 (widths are 0, 1, 2, 4, 8, 16 or 32, so no value straddles a
//   word; width 0 is all zeros and has no words): a thread's 4 lanes lie
//   in one word (w <= 8), one 8-byte pair (w = 16) or one 16-byte quad
//   (w = 32), one load each (row offsets are multiples of 4 words);
// * doc = base + (inclusive prefix sum of the deltas) + lane, all uint32
//   with wraparound: a prefix over the thread's 4 lanes, then a
//   __shfl_up_sync scan of the 32 thread sums; lanes >= length become
//   TERMINATED;
// * tf = unpacked tf + 1 (1 when the tf width is 0, which the mirror also
//   sets for a field without freqs);
// * score = w[q] * (tf / (tf + cache[q, norm_ids[min(doc, max_doc-1)]])),
//   as __fmul_rn(w, __fdiv_rn(tf, __fadd_rn(tf, norm))) under
//   --fmad=false; -inf when the doc is TERMINATED or not alive, or the
//   item is padding (qid outside [0, num_queries) or block out of range);
// * the item's top-kk of its 128 lanes by (score desc, lane asc), the
//   order `lax.top_k` keeps, in min(kk, live lanes) rounds of a warp
//   selection. Each thread first orders its live lanes once by the
//   order-keeping u32 image of the score (group_topk.cuh's key; both zeros
//   one image), the lower lane first on a tie, as 2-bit lane indices. Each
//   round it offers its next lane: `__reduce_max_sync` finds the round's
//   best image and `__reduce_min_sync` the lowest lane that offers it; that
//   lane's owner writes output slot `round` and moves on to its next lane.
//   Slots past the live lanes get -inf / TERMINATED.
//
// What bounds it on an H100: bytes. An item reads 16 * (w_doc + w_tf)
// bytes of packed words and a 32-byte table row, plus one norm-id byte and
// one alive byte per live doc, and writes kk scores and docs: about
// 100-250 bytes where a dense row of the fused store is 1,536. No
// tensor-core work.
//
// What the kernel's first design lost time on, at 1.6% of that bound
// (0.494 ms of device time per packed term batch of the 1M-doc smoke
// against 0.0079 ms, where this design takes 0.212 ms; NVIDIA H100 80GB
// HBM3, 700.00 W, both in one run, PERF.md):
// * the selection: every live lane was ranked against all 128 keys of its
//   item in shared memory, 128 shared loads and 512 64-bit compares a
//   thread, about 1,800 instructions an item, whatever kk; the rounds
//   above cost about 15 instructions each, min(kk, live) of them (kk = 10
//   in every suite), after a 12-compare ordering of a thread's 4 lanes;
// * the load chain: each item is a chain of dependent loads (item, table
//   row, packed words, alive and norm id, cache), and a warp had one chain
//   in flight, 40 warps an SM. Here a warp issues each stage's loads for
//   all its items together, so kItemsPerWarp chains are in flight per
//   warp, and no shared memory limits the warps resident on an SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_topk.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kLanesPerThread = 4;
constexpr int kItemsPerWarp = 2;
constexpr int kWarpsPerCta = 4;
constexpr int kThreads = 32 * kWarpsPerCta;
constexpr int kItemsPerCta = kItemsPerWarp * kWarpsPerCta;
constexpr int kTabCols = 8;
constexpr int kCacheCols = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoLane = 0xffffffffu;

// The 4 values of lanes 4t..4t+3 of a width-`bits` packed row: one load.
__device__ __forceinline__ void unpack4(const uint32_t* __restrict__ row,
                                        int bits, int t, uint32_t v[4]) {
  if (bits == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = 0u;
  } else if (bits == 32) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(row) + t);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if (bits == 16) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(row) + t);
    v[0] = x.x & 0xffffu;
    v[1] = x.x >> 16;
    v[2] = x.y & 0xffffu;
    v[3] = x.y >> 16;
  } else {
    const int bit = kLanesPerThread * t * bits;
    const uint32_t word = __ldg(row + (bit >> 5)) >> (bit & 31);
    const uint32_t mask = (1u << bits) - 1u;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (word >> (i * bits)) & mask;
  }
}

// Order-keeping u32 image of a score (both zeros map to one image), the
// upper bits of group_topk.cuh's key.
__device__ __forceinline__ uint32_t score_image(float s) {
  uint32_t u = __float_as_uint(s);
  if ((u << 1) == 0) u = 0;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads) packed_flat_kernel(
    const uint32_t* __restrict__ doc_words,
    const uint32_t* __restrict__ tf_words,
    const int32_t* __restrict__ blk_tab, int n_blocks,
    const uint8_t* __restrict__ norm_ids, const uint8_t* __restrict__ alive,
    int max_doc, const int32_t* __restrict__ blocks,
    const int32_t* __restrict__ qids, int n_items,
    const float* __restrict__ weights, const float* __restrict__ caches,
    int num_queries, int kk, float* __restrict__ out_scores,
    int32_t* __restrict__ out_docs) {
  const int t = threadIdx.x & 31;
  const int item0 =
      (blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5)) * kItemsPerWarp;
  if (item0 >= n_items) return;  // a whole warp leaves together

  // stage 1: the items and their table rows (every branch is warp-uniform)
  bool ok[kItemsPerWarp];
  int32_t q[kItemsPerWarp];
  int4 tab_a[kItemsPerWarp];  // doc offset, doc bits, tf offset, tf bits
  int4 tab_b[kItemsPerWarp];  // base, length
#pragma unroll
  for (int h = 0; h < kItemsPerWarp; ++h) {
    const int item = item0 + h;
    int32_t bid = -1;
    q[h] = -1;
    if (item < n_items) {
      bid = __ldg(blocks + item);
      q[h] = __ldg(qids + item);
    }
    ok[h] = q[h] >= 0 && q[h] < num_queries && bid >= 0 && bid < n_blocks;
    tab_a[h] = make_int4(0, 0, 0, 0);
    tab_b[h] = make_int4(0, 0, 0, 0);
    if (ok[h]) {
      const int4* tab =
          reinterpret_cast<const int4*>(blk_tab + (long long)bid * kTabCols);
      tab_a[h] = __ldg(tab);
      tab_b[h] = __ldg(tab + 1);
    }
  }

  // stage 2: the packed words and the query weight
  uint32_t dv[kItemsPerWarp][kLanesPerThread];
  uint32_t tv[kItemsPerWarp][kLanesPerThread];
  float w[kItemsPerWarp];
#pragma unroll
  for (int h = 0; h < kItemsPerWarp; ++h) {
    w[h] = 0.0f;
    if (ok[h]) {
      unpack4(doc_words + tab_a[h].x, tab_a[h].y, t, dv[h]);
      unpack4(tf_words + tab_a[h].z, tab_a[h].w, t, tv[h]);
      w[h] = __ldg(weights + q[h]);
    }
  }

  // stage 3: docs (prefix sums), then alive, norm ids and denominators
  const uint32_t last = (uint32_t)(max_doc - 1);
  const int lane0 = kLanesPerThread * t;
  uint32_t doc[kItemsPerWarp][kLanesPerThread];
  float sc[kItemsPerWarp][kLanesPerThread];
#pragma unroll
  for (int h = 0; h < kItemsPerWarp; ++h) {
    if (!ok[h]) continue;
    uint32_t run = 0u;
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      run += dv[h][i];
      dv[h][i] = run;  // the thread's inclusive prefix
    }
    // inclusive warp scan of the thread sums, uint32 with wraparound
    uint32_t incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t v = __shfl_up_sync(kFull, incl, off);
      if (t >= off) incl += v;
    }
    const uint32_t base = (uint32_t)tab_b[h].x + (incl - run);
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      const int lane = lane0 + i;
      doc[h][i] = lane < tab_b[h].y ? base + dv[h][i] + (uint32_t)lane
                                    : (uint32_t)tantivy_port::kTerminatedDoc;
    }
  }
  bool live[kItemsPerWarp][kLanesPerThread];
  uint8_t nid[kItemsPerWarp][kLanesPerThread];
#pragma unroll
  for (int h = 0; h < kItemsPerWarp; ++h) {
    if (!ok[h]) continue;
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      const uint32_t d = doc[h][i];
      const uint32_t safe = d < last ? d : last;
      live[h][i] = d != (uint32_t)tantivy_port::kTerminatedDoc &&
                   __ldg(alive + safe) != 0;
      nid[h][i] = __ldg(norm_ids + safe);
    }
  }
#pragma unroll
  for (int h = 0; h < kItemsPerWarp; ++h) {
    if (!ok[h]) continue;
    const float* cache = caches + (long long)q[h] * kCacheCols;
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      float s = -INFINITY;
      if (live[h][i]) {
        const float tf = __uint2float_rn(tv[h][i] + 1u);
        const float norm = __ldg(cache + nid[h][i]);
        s = __fmul_rn(w[h], __fdiv_rn(tf, __fadd_rn(tf, norm)));
      }
      sc[h][i] = s;
    }
  }

  // stage 4: each item's top-kk, one warp selection round per slot
#pragma unroll
  for (int h = 0; h < kItemsPerWarp; ++h) {
    const int item = item0 + h;
    if (item >= n_items) break;
    float* osc = out_scores + (long long)item * kk;
    int32_t* odoc = out_docs + (long long)item * kk;
    int n_out = 0;
    if (ok[h]) {
      uint32_t img[kLanesPerThread];
      bool cand[kLanesPerThread];
      int n_live = 0;
#pragma unroll
      for (int i = 0; i < kLanesPerThread; ++i) {
        cand[i] = sc[h][i] != -INFINITY;
        img[i] = score_image(sc[h][i]);
        n_live += __popc(__ballot_sync(kFull, cand[i]));
      }
      // the thread's candidates in selection order (image desc, lane asc):
      // 2-bit lane indices, the next one in the low bits of `order`
      unsigned order = 0u;
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < kLanesPerThread; ++i) {
        int pos = 0;
#pragma unroll
        for (int j = 0; j < kLanesPerThread; ++j) {
          if (j != i && cand[j] &&
              (img[j] > img[i] || (img[j] == img[i] && j < i))) {
            ++pos;
          }
        }
        if (cand[i]) {
          order |= (unsigned)i << (2 * pos);
          ++cnt;
        }
      }
      n_out = n_live < kk ? n_live : kk;
      for (int r = 0; r < n_out; ++r) {
        const unsigned hi = order & 3u;
        uint32_t mine = img[0];
#pragma unroll
        for (int i = 1; i < kLanesPerThread; ++i) {
          if (hi == (unsigned)i) mine = img[i];
        }
        uint32_t mlane = (uint32_t)(lane0 + hi);
        if (cnt == 0) {
          mine = 0u;
          mlane = kNoLane;
        }
        const uint32_t best = __reduce_max_sync(kFull, mine);
        const uint32_t pick = __reduce_min_sync(
            kFull, (mlane != kNoLane && mine == best) ? mlane : kNoLane);
        if (pick == mlane) {
          float s = sc[h][0];
          uint32_t d = doc[h][0];
#pragma unroll
          for (int i = 1; i < kLanesPerThread; ++i) {
            if (hi == (unsigned)i) {
              s = sc[h][i];
              d = doc[h][i];
            }
          }
          osc[r] = s;
          odoc[r] = (int32_t)d;
          order >>= 2;
          --cnt;
        }
      }
    }
    for (int j = n_out + t; j < kk; j += 32) {
      osc[j] = -INFINITY;
      odoc[j] = tantivy_port::kTerminatedDoc;
    }
  }
}

}  // namespace

extern "C" int packed_flat_launch(
    const void* doc_words, const void* tf_words, const void* blk_tab,
    int n_blocks, const void* norm_ids, const void* alive, int max_doc,
    const void* blocks, const void* qids, int n_items, const void* weights,
    const void* caches, int num_queries, int kk, void* out_scores,
    void* out_docs, void* stream) {
  if (kk < 1 || kk > kLanes || n_items < 0 || n_blocks < 0 ||
      (n_blocks > 0 && max_doc < 1) || ((uintptr_t)doc_words & 15) != 0 ||
      ((uintptr_t)tf_words & 15) != 0 || ((uintptr_t)blk_tab & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_items > 0) {
    const int ctas = (n_items + kItemsPerCta - 1) / kItemsPerCta;
    packed_flat_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)doc_words, (const uint32_t*)tf_words,
        (const int32_t*)blk_tab, n_blocks, (const uint8_t*)norm_ids,
        (const uint8_t*)alive, max_doc, (const int32_t*)blocks,
        (const int32_t*)qids, n_items, (const float*)weights,
        (const float*)caches, num_queries, kk, (float*)out_scores,
        (int32_t*)out_docs);
  }
  return (int)cudaGetLastError();
}

// Threads, static shared memory per CTA and CTAs resident per SM of the
// kernel on the current device; returns a CUDA error code.
extern "C" int packed_flat_occupancy(int* threads, int* smem_bytes,
                                     int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, packed_flat_kernel);
  if (err != cudaSuccess) return (int)err;
  *threads = kThreads;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, packed_flat_kernel, kThreads, 0);
}
