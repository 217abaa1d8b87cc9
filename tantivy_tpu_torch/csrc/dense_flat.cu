// Dense flat scorer (kernel K7 of the port): BM25 over decoded 128-lane
// posting rows and each query's top-k, on the card.
//
// Replaces two XLA programs of the reference, whole:
// `flat_topk_kernel` (tantivy_tpu/ops/flat_scorer.py:43-95), BM25 over a
// work list's rows, each row's `lax.top_k` and the per-query 3-key sort,
// and `term_scorer._topk_kernel` (tantivy_tpu/ops/term_scorer.py:25-49),
// BM25 over a batch's [Q, B, 128] gathered blocks and `lax.top_k` of each
// query's B * 128 lanes.
//
// Work item: one row of 128 lanes and its query id, in any qid order. Two
// input forms share one kernel body (template parameter kStore):
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
// Output, per query q in [0, num_queries) (items of other qids are
// ignored), its top-k:
// * store form: packed [2, Q, k] int32 (score bits | doc), ordered (score
//   desc, doc asc as u32); -inf lanes dropped, -inf / 0 past the query's
//   hits; no dedup: a row repeated for one query gives its docs twice;
// * cache form: scores [Q, k] f32 and docs [Q, k], ordered as `lax.top_k`
//   orders the query's flat lanes: score desc, then flat index
//   b * 128 + lane ascending, b the item's rank among its query's items in
//   item order; -inf lanes kept with their own docs; -inf / 0 past the
//   query's lanes (never, for `_topk_kernel`'s [Q, B] items and k <= B*128).
// Both orders compare the order-keeping u32 image of the score (both
// zeros one image: a query's zeros all carry its weight's sign), then the
// tie key (doc, or flat index; b * 128 + lane orders as item * 128 +
// lane within a query, so the key needs no rank).
//
// Two kernels a call, k <= kMaxK (128):
// 1. group (one CTA of 1,024 threads, `qid_group.cuh`): a
//    histogram of the qids, a block scan into CSR offsets `qptr` [Q + 1]
//    and each query's tiles of up to kTileRows items (a query with no item
//    has one empty tile), and a scatter of item indices into `order`,
//    grouped by query. Within a query the scatter's order is that of its
//    warps' atomics: the tie keys above do not depend on it. It also
//    zeroes the per-query `done` counters and shared keys.
// 2. select (one warp a tile, kSelWarps tiles a CTA): lane i holds the
//    tile's item i; lane 0 keeps kStages rows in flight, each one TMA bulk
//    copy (`cp.async.bulk`, 1,536 bytes; the cache form's docs and tfs rows
//    are two of 512) into a shared-memory ring with one `mbarrier` a stage;
//    a row is refilled as soon as the warp has read it, so the next rows'
//    copies overlap this row's scoring. Thread t scores lanes 4t..4t+3. The
//    warp keeps the tile's running top-k in shared memory (two buffers of k
//    16-byte entries: image, ~tie key, score bits, doc) and the key of its
//    k-th entry as the threshold; the tiles of a query of several also
//    share the best k-th key any of them has (`atomicMax` on a 64-bit key:
//    a lane at or below it cannot enter the query's top-k). One ballot
//    finds the row's lanes that beat both: a row with none costs no
//    selection work, most rows once the lists fill. While the list is
//    short (k <= 32) a row's lanes below the k-th best of its 32 threads'
//    best lanes (a bitonic sort across the warp) are left out: k lanes of
//    the row beat them. Up to 32 remaining lanes merge in one batch,
//    gathered through shared memory; more merge a lane slot at a time. A
//    merge ranks each candidate by a binary search in the list plus a
//    count over the batch (read from shared memory), and moves each entry
//    down by the candidates ranked above it. A query of one tile writes
//    its output from the list; a query of
//    several writes each tile's list to scratch, and the last of its tiles
//    to finish (an atomic counter after `__threadfence`) merges all of
//    them, 128 entries a step with the next step's loads in flight, and
//    writes the output. Every output slot is written.
// For k above kMaxK the wrapper takes the row stage below (kernel
// `dense_flat_kernel`, K7's first design: each row's top-kk, kk = 128)
// and a torch merge, chosen from k before any launch.
//
// What bounds it on an H100: bytes. A store-form item reads its 1,536-byte
// row, 8 bytes of row index and 4 of qid; the output is Q * k * 8 bytes.
// A row repeated in a launch is read again but counted once in the bound.
// No tensor-core work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "qid_group.cuh"

namespace {

using qid_group::lanemask_lt;

constexpr int kLanes = 128;
constexpr int kLanesPerThread = 4;
constexpr int kStoreCols = 384;
constexpr int kCacheCols = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kTerminated = 0x7fffffffu;
constexpr uint32_t kNegInfBits = 0xff800000u;

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

// ---------------------------------------------------------------------------
// The row stage (the route for k > kMaxK): per item the top-kk of all 128
// lanes in the total order (score desc, lane asc), -inf lanes included with
// their own docs. One warp serves kItemsPerWarp items, interleaved; thread
// t owns lanes 4t..4t+3 of each, one 16-byte load per column. Selection:
// each thread orders its 4 lanes once by image (the lower lane first on a
// tie); then kk rounds, each offering every thread's next lane:
// `__reduce_max_sync` finds the best image and `__reduce_min_sync` the
// lowest lane that offers it; that lane's owner writes slot `round`.
// Output: scores [W, kk] f32, docs [W, kk] and, when asked, each slot's
// lane [W, kk] u8.

constexpr int kItemsPerWarp = 2;
constexpr int kWarpsPerCta = 4;
constexpr int kThreads = 32 * kWarpsPerCta;
constexpr int kItemsPerCta = kItemsPerWarp * kWarpsPerCta;
constexpr uint32_t kNoLane = 0xffffffffu;

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

// ---------------------------------------------------------------------------
// The per-query route (k <= kMaxK): the group and select kernels.

constexpr int kMaxK = 128;
constexpr int kTileRows = 16;  // a tile's items: one a lane
constexpr int kStages = 4;     // rows in flight a warp
constexpr int kSelWarps = 4;
constexpr int kSelThreads = 32 * kSelWarps;
constexpr int kGroupThreads = qid_group::kThreads;
constexpr int kStageBytes = kStoreCols * 4;  // the cache form uses 1,024
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kCacheBytes = kCacheCols * 4;
constexpr int kBarBytes = 64;
constexpr int kCompactBytes = 32 * 16 + 32 * 4;

// Scratch of one call, carved from one buffer (`dense_flat_scratch_bytes`).
struct Scratch : qid_group::Groups {
  uint4* partial;   // [t_max, k] tile lists of queries of several tiles
};

long long tiles_max(int n_items, int num_queries) {
  return qid_group::tiles_max(n_items, num_queries, kTileRows);
}

long long scratch_layout(int n_items, int num_queries, int k, char* base,
                         Scratch* s) {
  const long long t_max = tiles_max(n_items, num_queries);
  long long off = 0;
  long long at[8];
  const long long bytes[8] = {
      t_max * k * 16, 4LL * (num_queries + 1), 4LL * num_queries,
      4LL * (num_queries + 1), 4LL * num_queries, 4LL * n_items, 4LL * t_max,
      8LL * num_queries};
  for (int i = 0; i < 8; ++i) {
    at[i] = off;
    off += (bytes[i] + 15) & ~15LL;
  }
  if (s != nullptr) {
    s->partial = reinterpret_cast<uint4*>(base + at[0]);
    s->qptr = reinterpret_cast<int32_t*>(base + at[1]);
    s->cursor = reinterpret_cast<int32_t*>(base + at[2]);
    s->qtile0 = reinterpret_cast<int32_t*>(base + at[3]);
    s->done = reinterpret_cast<int32_t*>(base + at[4]);
    s->order = reinterpret_cast<int32_t*>(base + at[5]);
    s->tile_q = reinterpret_cast<int32_t*>(base + at[6]);
    s->qth = reinterpret_cast<unsigned long long*>(base + at[7]);
  }
  return off;
}

struct GroupArgs {
  const int32_t* qids;
  int n_items;
  int num_queries;
  Scratch s;
};

__global__ void __launch_bounds__(kGroupThreads)
    dense_flat_group_kernel(const GroupArgs a) {
  qid_group::group_by_query<kTileRows>(a.qids, a.n_items, a.num_queries,
                                       a.s);
}

// --- shared-memory staging by TMA and mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders the warp's earlier reads of a stage before the copy that
// refills it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- the running top-k: entries {image, ~tie key, score bits, doc}

__device__ __forceinline__ uint64_t key_of(const uint4 e) {
  return ((uint64_t)e.x << 32) | e.y;
}

struct SelArgs {
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
  const float* weights;
  int n_weights;
  int num_queries;
  int k;
  Scratch s;
  int32_t* out_packed;  // store form: [2, Q, k]
  float* out_scores;    // cache form: [Q, k]
  int32_t* out_docs;    // cache form: [Q, k]
};

__host__ __device__ constexpr int warp_smem_bytes(int k) {
  return kRingBytes + kCacheBytes + kBarBytes + kCompactBytes + 2 * k * 16;
}

// A warp's running top-k: `len` entries of list `buf` (of two, each k
// entries, in `lists`), best first; `th` the k-th entry's key once full;
// `gth` the best k-th key any tile of the query has published (0: none).
// A candidate is worth merging only if its key beats both.
struct Running {
  uint4* lists;
  uint4* batch;  // 32 candidates
  int* batch_rank;  // each candidate's place in the list
  int k;
  int len;
  int buf;
  unsigned long long th;
  unsigned long long gth;

  __device__ __forceinline__ bool beats(unsigned long long key) const {
    return key > gth && (len < k || key > th);
  }

  // Merges the m candidates of `batch` (m <= 32) into the list: each
  // candidate's place is its rank in the list (a binary search: entries at
  // or above it) plus its rank in the batch (higher keys, and equal keys
  // earlier in the batch); each entry moves down by the candidates ranked
  // above it. The places are a permutation; those past k are dropped.
  __device__ __forceinline__ void merge(int m) {
    const int lane = threadIdx.x & 31;
    const uint4* cur = lists + buf * k;
    uint4* nxt = lists + (buf ^ 1) * k;
    const bool has = lane < m;
    const uint4 mine = has ? batch[lane] : make_uint4(0u, 0u, 0u, 0u);
    const unsigned long long key = key_of(mine);
    int rl = 0;
    if (has) {
      int lo = 0, hi = len;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_of(cur[mid]) >= key) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      rl = lo;
      batch_rank[lane] = rl;
    }
    __syncwarp();
    int rc = 0;  // candidates above it
    int above[kMaxK / 32] = {0, 0, 0, 0};  // candidates above entry lane+32e
#pragma unroll 4
    for (int u = 0; u < m; ++u) {
      const uint2 ku2 = *reinterpret_cast<const uint2*>(batch + u);
      const unsigned long long ku = ((unsigned long long)ku2.x << 32) | ku2.y;
      const int rl_u = batch_rank[u];
      rc += (ku > key || (ku == key && u < lane)) ? 1 : 0;
#pragma unroll
      for (int e = 0; e < kMaxK / 32; ++e) {
        above[e] += rl_u <= lane + 32 * e ? 1 : 0;
      }
    }
#pragma unroll
    for (int e = 0; e < kMaxK / 32; ++e) {
      const int j = lane + 32 * e;
      if (j < len && j + above[e] < k) nxt[j + above[e]] = cur[j];
    }
    if (has && rl + rc < k) nxt[rl + rc] = mine;
    __syncwarp();
    len = min(k, len + m);
    buf ^= 1;
    if (len == k) th = key_of(lists[buf * k + k - 1]);
  }

  // Merges the candidates the lanes hold, up to four a lane (`has`,
  // `ent`). At most 32 in all go in one batch, gathered lane slot by lane
  // slot, lanes ascending; more go a lane slot at a time, each slot's
  // candidates tested again against the risen threshold.
  __device__ __forceinline__ void insert4(const uint4 ent[kLanesPerThread],
                                          const bool has[kLanesPerThread]) {
    const unsigned lt = lanemask_lt();
    unsigned b[kLanesPerThread];
    int m = 0;
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      b[i] = __ballot_sync(kFull, has[i]);
      m += __popc(b[i]);
    }
    if (m == 0) return;
    if (m <= 32) {
      int base = 0;
#pragma unroll
      for (int i = 0; i < kLanesPerThread; ++i) {
        if (has[i]) batch[base + __popc(b[i] & lt)] = ent[i];
        base += __popc(b[i]);
      }
      __syncwarp();
      merge(m);
      return;
    }
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      const bool h = has[i] && beats(key_of(ent[i]));
      const unsigned bi = __ballot_sync(kFull, h);
      if (bi == 0) continue;
      if (h) batch[__popc(bi & lt)] = ent[i];
      __syncwarp();
      merge(__popc(bi));
    }
  }
};

// The k-th largest (k <= 32) of the warp's 32 values `v`, by a bitonic
// sort across the lanes.
__device__ __forceinline__ uint32_t warp_kth_largest(uint32_t v, int k) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const uint32_t o = __shfl_xor_sync(kFull, v, stride);
      const bool desc = (lane & size) == 0;
      const bool lower = (lane & stride) == 0;
      v = (lower == desc) ? max(v, o) : min(v, o);
    }
  }
  return __shfl_sync(kFull, v, k - 1);
}

template <bool kStore>
__global__ void __launch_bounds__(kSelThreads)
    dense_flat_select_kernel(const SelArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x * kSelWarps + warp;
  const int Q = a.num_queries, k = a.k;
  if (tile >= __ldg(a.s.qtile0 + Q)) return;  // a whole warp leaves
  unsigned char* ws = smem + warp * warp_smem_bytes(k);
  uint32_t* ring = reinterpret_cast<uint32_t*>(ws);
  float* s_cache = reinterpret_cast<float*>(ws + kRingBytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(ws + kRingBytes + kCacheBytes);
  Running run;
  run.batch =
      reinterpret_cast<uint4*>(ws + kRingBytes + kCacheBytes + kBarBytes);
  run.batch_rank = reinterpret_cast<int*>(run.batch + 32);
  run.lists = run.batch + 40;
  run.k = k;
  run.len = 0;
  run.buf = 0;
  run.th = 0ull;
  run.gth = 0ull;

  // the tile: its query and items
  const int q = __ldg(a.s.tile_q + tile);
  const int t0 = __ldg(a.s.qtile0 + q);
  const int nt = __ldg(a.s.qtile0 + q + 1) - t0;
  const int lo = __ldg(a.s.qptr + q) + (tile - t0) * kTileRows;
  const int n = min(kTileRows, __ldg(a.s.qptr + q + 1) - lo);
  const bool q_ok = q < a.n_weights;
  const float w = q_ok ? __ldg(a.weights + q) : 0.0f;
  // the tiles of a query of several share their k-th keys: a lane at or
  // below any tile's k-th key cannot enter the query's top-k
  volatile unsigned long long* qth = a.s.qth + q;
  int my_item = 0;
  long long my_row = 0;
  bool my_load = false, my_valid = false;
  if (lane < n) {
    my_item = __ldg(a.s.order + lo + lane);
    if (kStore) {
      // rows outside the store and queries outside the weights give only
      // -inf lanes, which the store form drops: such rows are not read
      my_row = __ldg(a.rows + my_item);
      my_load = q_ok && my_row >= 0 && my_row < a.n_rows;
    } else {
      my_row = my_item;
      my_load = true;
      my_valid = __ldg(a.valid + my_item) != 0;
    }
  }
  const unsigned rows_todo = __ballot_sync(kFull, my_load);

  if (lane == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bar + st, 1);
    mbar_fence_init();
  }
  if (!kStore && q_ok) {
    const float* cache = a.caches + (long long)q * kCacheCols;
    for (int c = lane; c < kCacheCols; c += 32) s_cache[c] = __ldg(cache + c);
  }
  __syncwarp();

  // lane 0 copies the next row of `pmask` into stage `st` (warp-uniform)
  unsigned pmask = rows_todo;
  auto issue = [&](int st) {
    const int src = __ffs(pmask) - 1;
    pmask &= pmask - 1;
    const long long row = __shfl_sync(kFull, my_row, src);
    if (lane == 0) {
      uint32_t* dst = ring + st * kStoreCols;
      if (kStore) {
        mbar_expect_tx(bar + st, kStoreCols * 4);
        bulk_copy(dst, a.cstore + row * kStoreCols, kStoreCols * 4,
                  bar + st);
      } else {
        mbar_expect_tx(bar + st, 2 * kLanes * 4);
        bulk_copy(dst, a.docs + row * kLanes, kLanes * 4, bar + st);
        bulk_copy(dst + kLanes, a.tfs + row * kLanes, kLanes * 4, bar + st);
      }
    }
  };
  for (int st = 0; st < kStages && pmask; ++st) issue(st);

  const uint32_t last = (uint32_t)(a.max_doc - 1);
  int it = 0;
  for (unsigned cmask = rows_todo; cmask; cmask &= cmask - 1, ++it) {
    const int src = __ffs(cmask) - 1;
    const int item = __shfl_sync(kFull, my_item, src);
    const bool valid = __shfl_sync(kFull, my_valid, src);
    unsigned long long g = 0ull;
    if (nt > 1 && lane == 0) g = *qth;  // read while the row lands
    const int st = it % kStages;
    mbar_wait(bar + st, (uint32_t)((it / kStages) & 1));
    const uint32_t* r = ring + st * kStoreCols;
    uint32_t d[kLanesPerThread], tf[kLanesPerThread], c[kLanesPerThread];
    split4(reinterpret_cast<const uint4*>(r)[lane], d);
    split4(reinterpret_cast<const uint4*>(r + kLanes)[lane], tf);
    if (kStore) split4(reinterpret_cast<const uint4*>(r + 2 * kLanes)[lane], c);
    __syncwarp();
    if (pmask) {
      if (lane == 0) fence_proxy_async();
      issue(st);
    }

    // the row's lanes: scores, keys and candidates
    if (nt > 1) run.gth = __shfl_sync(kFull, g, 0);
    uint4 ent[kLanesPerThread];
    bool has[kLanesPerThread];
    bool any = false;
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      bool live;
      float norm;
      if (kStore) {
        norm = __uint_as_float(c[i]);
        live = !isnan(norm);
      } else {
        const uint32_t safe = d[i] < last ? d[i] : last;
        live = q_ok && valid && d[i] != kTerminated &&
               (a.alive == nullptr || __ldg(a.alive + safe) != 0);
        norm = live ? s_cache[__ldg(a.norm_ids + safe)] : 0.0f;
      }
      float s = -INFINITY;
      if (live) {
        const float f = __uint2float_rn(tf[i]);
        s = __fmul_rn(w, __fdiv_rn(f, __fadd_rn(f, norm)));
      }
      const uint32_t tie = kStore ? d[i]
                                  : (uint32_t)item * kLanes +
                                        kLanesPerThread * lane + i;
      ent[i] = make_uint4(score_image(s), ~tie, __float_as_uint(s), d[i]);
      // the store form drops -inf lanes; the cache form keeps every lane
      has[i] = (!kStore || s != -INFINITY) && run.beats(key_of(ent[i]));
      any |= has[i];
    }
    if (!__any_sync(kFull, any)) continue;
    if (run.len < k && k <= 32) {
      // a short list lets most of the row in: only lanes at or above the
      // k-th best of the threads' best candidates can be among the row's
      // top k (k lanes of the row are at or above it)
      uint32_t best = 0u;
#pragma unroll
      for (int i = 0; i < kLanesPerThread; ++i) {
        if ((!kStore || ent[i].z != kNegInfBits) && ent[i].x > best) {
          best = ent[i].x;
        }
      }
      const uint32_t t0 = warp_kth_largest(best, k);
#pragma unroll
      for (int i = 0; i < kLanesPerThread; ++i) has[i] &= ent[i].x >= t0;
    }
    // insert the lanes that beat the threshold
    const unsigned long long th0 = run.th;
    run.insert4(ent, has);
    if (nt > 1 && run.len == k && run.th > th0 && run.th > run.gth &&
        lane == 0) {
      atomicMax(a.s.qth + q, run.th);
    }
  }

  if (nt > 1) {
    // publish the tile's list; the last tile of the query merges them all
    uint4* part = a.s.partial + (long long)tile * k;
    for (int j = lane; j < k; j += 32) {
      part[j] = j < run.len ? run.lists[run.buf * k + j]
                            : make_uint4(0u, 0u, 0u, 0u);
    }
    __threadfence();
    __syncwarp();
    int prev = 0;
    if (lane == 0) prev = atomicAdd(a.s.done + q, 1);
    prev = __shfl_sync(kFull, prev, 0);
    if (prev != nt - 1) return;
    __threadfence();
    // every tile's list, 128 entries a step, the next step's loads in
    // flight; an empty slot's key is 0. The lists hold the entries that
    // set the shared key, so only the running list's own threshold holds.
    const uint4* src = a.s.partial + (long long)t0 * k;
    const int total = nt * k;
    run.len = 0;
    run.gth = 0ull;
    uint4 next[kLanesPerThread];
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      const int e = lane + 32 * i;
      next[i] = e < total ? __ldcg(src + e) : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int e0 = 0; e0 < total; e0 += 32 * kLanesPerThread) {
      uint4 ent[kLanesPerThread];
      bool has[kLanesPerThread];
      bool any = false;
#pragma unroll
      for (int i = 0; i < kLanesPerThread; ++i) {
        ent[i] = next[i];
        const int e = e0 + 32 * kLanesPerThread + lane + 32 * i;
        next[i] = e < total ? __ldcg(src + e) : make_uint4(0u, 0u, 0u, 0u);
        const unsigned long long key = key_of(ent[i]);
        has[i] = key != 0ull && run.beats(key);
        any |= has[i];
      }
      if (__any_sync(kFull, any)) run.insert4(ent, has);
    }
  }

  // every slot of the query's output
  for (int j = lane; j < k; j += 32) {
    uint32_t sb = kNegInfBits;
    int32_t doc = 0;
    if (j < run.len) {
      const uint4 e = run.lists[run.buf * k + j];
      sb = e.z;
      doc = (int32_t)e.w;
    }
    const long long o = (long long)q * k + j;
    if (kStore) {
      a.out_packed[o] = (int32_t)sb;
      a.out_packed[(long long)Q * k + o] = doc;
    } else {
      a.out_scores[o] = __uint_as_float(sb);
      a.out_docs[o] = doc;
    }
  }
}

int check_topk(int n_items, int num_queries, int k) {
  if (k < 1 || k > kMaxK || n_items < 0 || num_queries < 1 ||
      (long long)n_items * kLanes > 0xffffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int launch_select(const SelArgs& a, bool store, int n_items, void* stream) {
  const long long ctas =
      (tiles_max(n_items, a.num_queries) + kSelWarps - 1) / kSelWarps;
  const int smem = kSelWarps * warp_smem_bytes(a.k);
  if (store) {
    dense_flat_select_kernel<true>
        <<<(unsigned)ctas, kSelThreads, smem, (cudaStream_t)stream>>>(a);
  } else {
    dense_flat_select_kernel<false>
        <<<(unsigned)ctas, kSelThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// --- the row stage (k > 128), the first design's entry points

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
// row-stage kernel's store form (form 0) or cache form (form 1) on the
// current device; returns a CUDA error code.
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

// --- the per-query route (k <= 128)

// Bytes of the scratch buffer one call of `n_items` items, `num_queries`
// queries and `k` needs (group and select share it).
extern "C" long long dense_flat_scratch_bytes(int n_items, int num_queries,
                                              int k) {
  return scratch_layout(n_items, num_queries, k, nullptr, nullptr);
}

// Kernel 1 of a call: groups the items by query into `scratch`.
extern "C" int dense_flat_group_launch(const void* qids, int n_items,
                                       int num_queries, int k, void* scratch,
                                       void* stream) {
  const int err = check_topk(n_items, num_queries, k);
  if (err != 0 || ((uintptr_t)scratch & 15) != 0) {
    return err != 0 ? err : (int)cudaErrorInvalidValue;
  }
  GroupArgs a = {};
  a.qids = (const int32_t*)qids;
  a.n_items = n_items;
  a.num_queries = num_queries;
  scratch_layout(n_items, num_queries, k, (char*)scratch, &a.s);
  dense_flat_group_kernel<<<1, kGroupThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel 2 of a store-form call: each query's top-k into `out` [2, Q, k].
extern "C" int dense_flat_select_store_launch(
    const void* cstore, long long n_rows, const void* rows, int n_items,
    const void* weights, int n_weights, int num_queries, int k,
    void* scratch, void* out, void* stream) {
  const int err = check_topk(n_items, num_queries, k);
  if (err != 0 || ((uintptr_t)cstore & 15) != 0 || n_rows < 0 ||
      ((uintptr_t)scratch & 15) != 0) {
    return err != 0 ? err : (int)cudaErrorInvalidValue;
  }
  SelArgs a = {};
  a.cstore = (const uint32_t*)cstore;
  a.n_rows = n_rows;
  a.rows = (const long long*)rows;
  a.max_doc = 1;
  a.weights = (const float*)weights;
  a.n_weights = n_weights;
  a.num_queries = num_queries;
  a.k = k;
  scratch_layout(n_items, num_queries, k, (char*)scratch, &a.s);
  a.out_packed = (int32_t*)out;
  return launch_select(a, true, n_items, stream);
}

// Kernel 2 of a cache-form call: each query's top-k into `out_scores` and
// `out_docs` [Q, k].
extern "C" int dense_flat_select_cache_launch(
    const void* docs, const void* tfs, const void* valid, int n_items,
    const void* norm_ids, const void* alive, int max_doc,
    const void* weights, const void* caches, int n_weights, int num_queries,
    int k, void* scratch, void* out_scores, void* out_docs, void* stream) {
  const int err = check_topk(n_items, num_queries, k);
  if (err != 0 || ((uintptr_t)docs & 15) != 0 ||
      ((uintptr_t)tfs & 15) != 0 || max_doc < 1 ||
      ((uintptr_t)scratch & 15) != 0) {
    return err != 0 ? err : (int)cudaErrorInvalidValue;
  }
  SelArgs a = {};
  a.docs = (const uint32_t*)docs;
  a.tfs = (const uint32_t*)tfs;
  a.valid = (const uint8_t*)valid;
  a.norm_ids = (const uint8_t*)norm_ids;
  a.alive = (const uint8_t*)alive;
  a.max_doc = max_doc;
  a.caches = (const float*)caches;
  a.weights = (const float*)weights;
  a.n_weights = n_weights;
  a.num_queries = num_queries;
  a.k = k;
  scratch_layout(n_items, num_queries, k, (char*)scratch, &a.s);
  a.out_scores = (float*)out_scores;
  a.out_docs = (int32_t*)out_docs;
  return launch_select(a, false, n_items, stream);
}

// Threads, shared memory per CTA (static and dynamic) and CTAs resident per
// SM on the current device of the select kernel's store form (form 0) or
// cache form (form 1) at `k`, or of the group kernel (form 2); returns a
// CUDA error code.
extern "C" int dense_flat_topk_occupancy(int form, int k, int* threads,
                                         int* smem_bytes, int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (form == 2) {
    err = cudaFuncGetAttributes(&attr, dense_flat_group_kernel);
    if (err != cudaSuccess) return (int)err;
    *threads = kGroupThreads;
    *smem_bytes = (int)attr.sharedSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, dense_flat_group_kernel, kGroupThreads, 0);
  }
  const int dyn = kSelWarps * warp_smem_bytes(k);
  err = form == 0
            ? cudaFuncGetAttributes(&attr, dense_flat_select_kernel<true>)
            : cudaFuncGetAttributes(&attr, dense_flat_select_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  *threads = kSelThreads;
  *smem_bytes = (int)attr.sharedSizeBytes + dyn;
  return (int)(form == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                               ctas_per_sm, dense_flat_select_kernel<true>,
                               kSelThreads, dyn)
                         : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                               ctas_per_sm, dense_flat_select_kernel<false>,
                               kSelThreads, dyn));
}
