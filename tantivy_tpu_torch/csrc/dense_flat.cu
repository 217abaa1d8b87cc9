// Dense flat scorer (kernel K7 of the port): BM25 over decoded 128-lane
// posting rows and each row's top-kk, in one kernel.
//
// Replaces the row stage of two XLA programs of the reference:
// `term_scorer._topk_kernel` (tantivy_tpu/ops/term_scorer.py:25-49), BM25
// over a batch's [Q, B, 128] gathered blocks, and the per-row stage of
// `flat_topk_kernel` (tantivy_tpu/ops/flat_scorer.py:43-95), BM25 over a
// work list's rows and `lax.top_k` of each. The per-query merges that
// follow are the port's torch tails (ops/term_scorer.py,
// `per_query_topk_from_rows`).
//
// Work item: one row of 128 lanes and its query id. Two input forms share
// one kernel body (template parameter kStore):
// * store form: the item is a fused-store row index (int64). The row holds
//   docs (columns 0:128), tfs (128:256) and the BM25 denominator
//   cache[norm_id] (256:384, NaN on deleted and padding lanes); a lane is
//   -inf where its denominator is NaN, every lane of an item whose row is
//   outside the store (its docs read as TERMINATED) or whose query is
//   outside the weight table;
// * cache form: the item is row `item` of dense [W, 128] docs and tfs
//   (u32 bits) with a `valid` byte; the denominator is
//   caches[q, norm_ids[min(doc, max_doc - 1)]]; a lane is -inf where its
//   doc is TERMINATED or not alive (when `alive` is given), or its row is
//   not valid, or its query is outside the tables: `_topk_kernel`'s masks.
// score = w[q] * (tf / (tf + norm)), as __fmul_rn(w, __fdiv_rn(tf,
// __fadd_rn(tf, norm))) under --fmad=false, tf = __uint2float_rn(tf).
//
// Per item the top-kk of all 128 lanes in the total order (score desc,
// lane asc), -inf lanes included with their own docs: `lax.top_k` of a
// query with fewer than k live docs returns docs at the lowest -inf flat
// indices (dead docs, TERMINATED, docs of invalid rows), and the merge
// keeps or drops them by its own rule. This is where K7 differs from K5,
// which stops at the live lanes. Output: scores [W, kk] f32, docs [W, kk]
// (u32 bits) and, when asked, each slot's lane [W, kk] u8, which the cache
// form's merge turns into the flat index b * 128 + lane.
//
// Design (K5's, without the decode): one warp serves kItemsPerWarp items,
// interleaved; thread t owns lanes 4t..4t+3 of each and reads them as one
// 16-byte load per column (docs, tfs, denominators). Selection: each thread
// orders its 4 lanes once by the order-keeping u32 image of the score
// (both zeros one image; -inf has an image like any score), the lower lane
// first on a tie, as 2-bit lane indices; then kk rounds, each offering
// every thread's next lane: `__reduce_max_sync` finds the best image and
// `__reduce_min_sync` the lowest lane that offers it; that lane's owner
// writes slot `round` and moves on. No shared memory.
//
// What bounds it on an H100: bytes. A store-form item reads its 1,536-byte
// row and writes kk scores and docs; a row repeated in a launch is read
// again but counted once in the bound. No tensor-core work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kLanesPerThread = 4;
constexpr int kItemsPerWarp = 2;
constexpr int kWarpsPerCta = 4;
constexpr int kThreads = 32 * kWarpsPerCta;
constexpr int kItemsPerCta = kItemsPerWarp * kWarpsPerCta;
constexpr int kStoreCols = 384;
constexpr int kCacheCols = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoLane = 0xffffffffu;
constexpr uint32_t kTerminated = 0x7fffffffu;

struct Args {
  // store form
  const uint32_t* cstore;
  long long n_rows;
  const long long* rows;
  // cache form
  const uint32_t* docs;
  const uint32_t* tfs;
  const uint8_t* valid;
  const uint8_t* norm_ids;
  const uint8_t* alive;  // may be null
  int max_doc;
  const float* caches;
  // both
  const int32_t* qids;
  int n_items;
  const float* weights;
  int n_weights;
  int kk;
  float* out_scores;
  int32_t* out_docs;
  uint8_t* out_lanes;  // may be null
};

// Order-keeping u32 image of a score (both zeros map to one image).
__device__ __forceinline__ uint32_t score_image(float s) {
  uint32_t u = __float_as_uint(s);
  if ((u << 1) == 0) u = 0;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void split4(const uint4 x, uint32_t v[4]) {
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

template <bool kStore>
__global__ void __launch_bounds__(kThreads) dense_flat_kernel(const Args a) {
  const int t = threadIdx.x & 31;
  const int item0 =
      (blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5)) * kItemsPerWarp;
  if (item0 >= a.n_items) return;  // a whole warp leaves together

  // stage 1: the items (every branch is warp-uniform)
  bool row_ok[kItemsPerWarp];
  bool q_ok[kItemsPerWarp];
  int32_t q[kItemsPerWarp];
  long long row[kItemsPerWarp];
#pragma unroll
  for (int h = 0; h < kItemsPerWarp; ++h) {
    const int item = item0 + h;
    row_ok[h] = false;
    q[h] = -1;
    row[h] = item;
    if (item < a.n_items) {
      q[h] = __ldg(a.qids + item);
      if (kStore) {
        row[h] = __ldg(a.rows + item);
        row_ok[h] = row[h] >= 0 && row[h] < a.n_rows;
      } else {
        row_ok[h] = true;
      }
    }
    q_ok[h] = q[h] >= 0 && q[h] < a.n_weights;
  }

  // stage 2: the row's quads and the query weight
  uint32_t doc[kItemsPerWarp][kLanesPerThread];
  uint32_t tfv[kItemsPerWarp][kLanesPerThread];
  float norm[kItemsPerWarp][kLanesPerThread];
  bool live[kItemsPerWarp][kLanesPerThread];
  float w[kItemsPerWarp];
#pragma unroll
  for (int h = 0; h < kItemsPerWarp; ++h) {
    w[h] = q_ok[h] ? __ldg(a.weights + q[h]) : 0.0f;
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      doc[h][i] = kTerminated;
      tfv[h][i] = 0u;
      norm[h][i] = 0.0f;
      live[h][i] = false;
    }
    if (!row_ok[h]) continue;
    if (kStore) {
      const uint4* r =
          reinterpret_cast<const uint4*>(a.cstore + row[h] * kStoreCols);
      uint32_t c[kLanesPerThread];
      split4(__ldg(r + t), doc[h]);
      split4(__ldg(r + kLanes / 4 + t), tfv[h]);
      split4(__ldg(r + kLanes / 2 + t), c);
#pragma unroll
      for (int i = 0; i < kLanesPerThread; ++i) {
        norm[h][i] = __uint_as_float(c[i]);
        live[h][i] = q_ok[h] && !isnan(norm[h][i]);
      }
    } else {
      const long long off = row[h] * kLanes;
      const uint4* d = reinterpret_cast<const uint4*>(a.docs + off);
      const uint4* f = reinterpret_cast<const uint4*>(a.tfs + off);
      split4(__ldg(d + t), doc[h]);
      split4(__ldg(f + t), tfv[h]);
    }
  }

  // stage 3 (cache form): valid, alive, norm ids and denominators
  if (!kStore) {
    const uint32_t last = (uint32_t)(a.max_doc - 1);
#pragma unroll
    for (int h = 0; h < kItemsPerWarp; ++h) {
      if (!row_ok[h]) continue;
      const bool ok = q_ok[h] && __ldg(a.valid + row[h]) != 0;
      uint8_t nid[kLanesPerThread];
#pragma unroll
      for (int i = 0; i < kLanesPerThread; ++i) {
        const uint32_t d = doc[h][i];
        const uint32_t safe = d < last ? d : last;
        live[h][i] = ok && d != kTerminated &&
                     (a.alive == nullptr || __ldg(a.alive + safe) != 0);
        nid[i] = live[h][i] ? __ldg(a.norm_ids + safe) : 0;
      }
      const float* cache = a.caches + (long long)q[h] * kCacheCols;
#pragma unroll
      for (int i = 0; i < kLanesPerThread; ++i) {
        if (live[h][i]) norm[h][i] = __ldg(cache + nid[i]);
      }
    }
  }

  // stage 4: scores, then each item's top-kk, one warp round per slot
  const int lane0 = kLanesPerThread * t;
#pragma unroll
  for (int h = 0; h < kItemsPerWarp; ++h) {
    const int item = item0 + h;
    if (item >= a.n_items) break;
    float sc[kLanesPerThread];
    uint32_t img[kLanesPerThread];
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      float s = -INFINITY;
      if (live[h][i]) {
        const float tf = __uint2float_rn(tfv[h][i]);
        s = __fmul_rn(w[h], __fdiv_rn(tf, __fadd_rn(tf, norm[h][i])));
      }
      sc[i] = s;
      img[i] = score_image(s);
    }
    // the thread's lanes in selection order (image desc, lane asc): 2-bit
    // lane indices, the next one in the low bits of `order`
    unsigned order = 0u;
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      int pos = 0;
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) {
        if (img[j] > img[i] || (img[j] == img[i] && j < i)) ++pos;
      }
      order |= (unsigned)i << (2 * pos);
    }
    int cnt = kLanesPerThread;
    float* osc = a.out_scores + (long long)item * a.kk;
    int32_t* odoc = a.out_docs + (long long)item * a.kk;
    uint8_t* olane =
        a.out_lanes ? a.out_lanes + (long long)item * a.kk : nullptr;
    for (int r = 0; r < a.kk; ++r) {
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
      if (cnt > 0 && pick == mlane) {
        float s = sc[0];
        uint32_t d = doc[h][0];
#pragma unroll
        for (int i = 1; i < kLanesPerThread; ++i) {
          if (hi == (unsigned)i) {
            s = sc[i];
            d = doc[h][i];
          }
        }
        osc[r] = s;
        odoc[r] = (int32_t)d;
        if (olane) olane[r] = (uint8_t)mlane;
        order >>= 2;
        --cnt;
      }
    }
  }
}

int launch(const Args& a, bool store, void* stream) {
  if (a.kk < 1 || a.kk > kLanes || a.n_items < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.n_items > 0) {
    const int ctas = (a.n_items + kItemsPerCta - 1) / kItemsPerCta;
    if (store) {
      dense_flat_kernel<true>
          <<<ctas, kThreads, 0, (cudaStream_t)stream>>>(a);
    } else {
      dense_flat_kernel<false>
          <<<ctas, kThreads, 0, (cudaStream_t)stream>>>(a);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dense_flat_store_launch(
    const void* cstore, long long n_rows, const void* rows, const void* qids,
    int n_items, const void* weights, int n_weights, int kk,
    void* out_scores, void* out_docs, void* out_lanes, void* stream) {
  if (((uintptr_t)cstore & 15) != 0 || n_rows < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = {};
  a.cstore = (const uint32_t*)cstore;
  a.n_rows = n_rows;
  a.rows = (const long long*)rows;
  a.qids = (const int32_t*)qids;
  a.n_items = n_items;
  a.weights = (const float*)weights;
  a.n_weights = n_weights;
  a.kk = kk;
  a.out_scores = (float*)out_scores;
  a.out_docs = (int32_t*)out_docs;
  a.out_lanes = (uint8_t*)out_lanes;
  return launch(a, true, stream);
}

extern "C" int dense_flat_cache_launch(
    const void* docs, const void* tfs, const void* valid, const void* qids,
    int n_items, const void* norm_ids, const void* alive, int max_doc,
    const void* weights, const void* caches, int n_weights, int kk,
    void* out_scores, void* out_docs, void* out_lanes, void* stream) {
  if (((uintptr_t)docs & 15) != 0 || ((uintptr_t)tfs & 15) != 0 ||
      max_doc < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = {};
  a.docs = (const uint32_t*)docs;
  a.tfs = (const uint32_t*)tfs;
  a.valid = (const uint8_t*)valid;
  a.norm_ids = (const uint8_t*)norm_ids;
  a.alive = (const uint8_t*)alive;
  a.max_doc = max_doc;
  a.caches = (const float*)caches;
  a.qids = (const int32_t*)qids;
  a.n_items = n_items;
  a.weights = (const float*)weights;
  a.n_weights = n_weights;
  a.kk = kk;
  a.out_scores = (float*)out_scores;
  a.out_docs = (int32_t*)out_docs;
  a.out_lanes = (uint8_t*)out_lanes;
  return launch(a, false, stream);
}

// Threads, static shared memory per CTA and CTAs resident per SM of the
// kernel's store form (form 0) or cache form (form 1) on the current
// device; returns a CUDA error code.
extern "C" int dense_flat_occupancy(int form, int* threads, int* smem_bytes,
                                    int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err =
      form == 0 ? cudaFuncGetAttributes(&attr, dense_flat_kernel<true>)
                : cudaFuncGetAttributes(&attr, dense_flat_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  *threads = kThreads;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)(form == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                               ctas_per_sm, dense_flat_kernel<true>, kThreads,
                               0)
                         : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                               ctas_per_sm, dense_flat_kernel<false>,
                               kThreads, 0));
}
