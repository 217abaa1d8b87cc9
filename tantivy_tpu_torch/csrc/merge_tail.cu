// Merge tails (kernel K8 of the port): each query's top-k of one launch's
// per-row candidates, on the card.
//
// Replaces the reference's two XLA merge tails, whole:
// * `per_query_topk_from_rows` (tantivy_tpu/ops/probe_scorer.py:120): one
//   3-key sort of the flattened candidates, (qid asc, score desc, doc asc),
//   and each query's first k;
// * `per_query_topk_rows_seg` (tantivy_tpu/ops/probe_scorer.py:178): a
//   4-key sort, a keep-max dedup of each query's (seg, doc) addresses, a
//   second 4-key sort (qid asc, score desc, seg asc, doc asc), and each
//   query's first k.
//
// Input of a call: W rows of kk candidates, scores [W, kk] f32 and docs
// [W, kk] (u32 bits), a qid a row [W] and, in the seg form, a segment a row
// [W]. A candidate whose score is -inf is dropped; a row whose qid lies
// outside [0, num_queries) is ignored (padding rows carry qid =
// num_queries).
//
// Output, per query q in [0, num_queries), its top-k, packed as the
// callers return it:
// * rows form (kSeg false): [2, Q, k] int32 (score bits | doc), ordered
//   score desc, then doc asc as u32; no dedup: a doc reported twice is
//   kept twice;
// * seg form (kSeg true): [3, Q, k] int32 (score bits | doc | seg),
//   ordered score desc, seg asc, doc asc; duplicate (seg, doc) addresses of
//   one query are deduplicated, keeping the max score, before the top-k
//   cut.
// Past a query's hits: score -inf, doc 0, seg 0. Scores compare by the
// reference's `_sortable_desc` image, which keeps +0.0 and -0.0 apart
// (+0.0 first): the zeros are not folded.
//
// Two kernels a call, any k >= 1 and kk <= kMaxKK (128):
// 1. group (`qid_group.cuh`, shared with K7): the rows grouped by query,
//    in tiles of up to kTileRows (32) rows, one a lane.
// 2. select (one warp a tile, kSelWarps tiles a CTA): row by row, the next
//    row's candidates loaded while this one is merged, lane l holds the
//    row's candidates l, l + 32, l + 64 and l + 96. A candidate is a
//    16-byte entry whose first three words are its 96-bit key, higher =
//    better: {score image, ~doc, ~0} in the rows form, {score image, ~seg,
//    ~doc} in the seg form. The warp keeps the tile's running top-k in
//    shared memory (two buffers of k entries, best first; in global
//    scratch for a k whose lists do not fit the opt-in shared memory,
//    k > kSmemMaxK) and its k-th entry as the threshold; each lane holds
//    the list entries l + 32e of each chunk of kChunk (128) in registers
//    while it merges a batch; the tiles of a query of several share the
//    best k-th key any of them has, its top 64 bits (`atomicMax`), below
//    which a candidate cannot enter the query's top-k: in the seg form a
//    tile's list holds k distinct addresses, each at or below its
//    query-wide max, so the query's k-th distinct address is at or above
//    the tile's k-th key. Only candidates that beat both are merged, each
//    lane slot of a row as one batch of up to 32:
//    * seg form, the dedup: a candidate beaten by one of the batch with
//      the same address (a higher key, or the same key earlier in the
//      batch) is dropped; one whose address the list holds replaces that
//      entry only with a strictly higher key, and is dropped otherwise;
//    * the merge: each kept candidate goes to its rank in the list (a
//      binary search: entries at or above it) less the replaced entries
//      above it, plus the kept candidates above it in the batch; each
//      entry that stays moves down by the candidates ranked above it and
//      up by the replaced entries above it; places past k are dropped.
//    A query of one tile writes its output from the list; a query of
//    several writes each tile's list to scratch, and the last of its tiles
//    to finish (an atomic counter after `__threadfence`) merges them all,
//    32 entries a batch with the next 128 loads in flight and the same
//    dedup (one address may sit in several tile lists, at different
//    scores), and writes the output. Every output slot is written.
//
// What bounds it on an H100: bytes. It reads W * kk * 8 bytes of
// candidates and W * 4 of qids (and W * 4 of segs), and writes
// Q * k * 4 * (2 or 3). Its design: one pass over the candidates and no
// sort; a candidate below the thresholds costs its load and one compare,
// and only those that beat them are merged. No tensor-core work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "qid_group.cuh"

namespace {

using qid_group::kFull;
using qid_group::lanemask_lt;

constexpr int kMaxKK = 128;
constexpr int kSlots = kMaxKK / 32;  // a lane's candidates of one row
constexpr int kChunk = 128;  // list entries a warp holds in registers
constexpr int kListSlots = kChunk / 32;  // a lane's entries of a chunk
constexpr int kTileRows = 32;  // a tile's rows: one a lane
constexpr int kSelWarps = 4;
constexpr int kSelThreads = 32 * kSelWarps;
constexpr uint32_t kNegInfBits = 0xff800000u;
constexpr int kDropped = 0x7fffffff;  // the rank of a dropped candidate
// per warp: the batch (32 entries), its ranks and replaced entries
constexpr int kBatchBytes = 32 * 16 + 2 * 32 * 4;
// the opt-in shared memory of a CTA on sm_90
constexpr int kSmemOptin = 227 * 1024;

// Scratch of one call, carved from one buffer (`merge_tail_scratch_bytes`).
struct Scratch : qid_group::Groups {
  uint4* partial;  // [t_max, k] tile lists of queries of several tiles
  uint4* lists;    // [t_max, 2, k] running lists when k > kSmemMaxK, else
                   // null (they are in shared memory)
};

__host__ __device__ constexpr int warp_smem_bytes(int k) {
  return kBatchBytes + 2 * k * 16;
}

// The largest k whose running lists fit in shared memory.
constexpr int kSmemMaxK = (kSmemOptin / kSelWarps - kBatchBytes) / 32;

// Dynamic shared memory of a select CTA at `k`.
int select_smem_bytes(int k) {
  return kSelWarps * (k <= kSmemMaxK ? warp_smem_bytes(k) : kBatchBytes);
}

long long tiles_max(int n_rows, int num_queries) {
  return qid_group::tiles_max(n_rows, num_queries, kTileRows);
}

long long scratch_layout(int n_rows, int num_queries, int k, char* base,
                         Scratch* s) {
  const long long t_max = tiles_max(n_rows, num_queries);
  long long off = 0;
  long long at[9];
  const long long bytes[9] = {
      t_max * k * 16, 4LL * (num_queries + 1), 4LL * num_queries,
      4LL * (num_queries + 1), 4LL * num_queries, 4LL * n_rows, 4LL * t_max,
      8LL * num_queries, k <= kSmemMaxK ? 0LL : t_max * 2 * k * 16};
  for (int i = 0; i < 9; ++i) {
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
    s->lists = k <= kSmemMaxK ? nullptr
                              : reinterpret_cast<uint4*>(base + at[8]);
  }
  return off;
}

struct GroupArgs {
  const int32_t* qids;
  int n_rows;
  int num_queries;
  Scratch s;
};

__global__ void __launch_bounds__(qid_group::kThreads)
    merge_tail_group_kernel(const GroupArgs a) {
  qid_group::group_by_query<kTileRows>(a.qids, a.n_rows, a.num_queries,
                                       a.s);
}

// --- entries: {score image, key word 1, key word 2, unused}

// The order-keeping u32 image of a score's bits: `_sortable_desc`'s
// complement, one image a bit pattern (+0.0 above -0.0).
__device__ __forceinline__ uint32_t score_image(uint32_t u) {
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The score bits of an image.
__device__ __forceinline__ uint32_t image_bits(uint32_t x) {
  return (x & 0x80000000u) ? (x & 0x7fffffffu) : ~x;
}

__device__ __forceinline__ bool key_gt(const uint4 a, const uint4 b) {
  if (a.x != b.x) return a.x > b.x;
  if (a.y != b.y) return a.y > b.y;
  return a.z > b.z;
}

__device__ __forceinline__ bool same_key(const uint4 a, const uint4 b) {
  return a.x == b.x && a.y == b.y && a.z == b.z;
}

// The seg form's address: (~seg, ~doc).
__device__ __forceinline__ bool same_addr(const uint4 a, const uint4 b) {
  return a.y == b.y && a.z == b.z;
}

// The key's top 64 bits: what the tiles of a query share.
__device__ __forceinline__ unsigned long long key_prefix(const uint4 e) {
  return ((unsigned long long)e.x << 32) | e.y;
}

struct SelArgs {
  const float* scores;  // [W, kk]
  const uint32_t* docs;  // [W, kk]
  const int32_t* segs;  // [W], the seg form
  int kk;
  int num_queries;
  int k;
  Scratch s;
  int32_t* out;  // [2 or 3, Q, k]
};

// A warp's running top-k: `len` entries of list `buf` (of two, each k
// entries, in `lists`), best first; `th` the k-th entry once full; `gth`
// the best k-th key prefix any tile of the query has published (0: none).
template <bool kSeg>
struct Running {
  uint4* lists;
  uint4* batch;  // 32 candidates
  int* brank;    // each candidate's rank in the list, kDropped if dropped
  int* bdel;     // the list entry each candidate replaces, or -1
  int k;
  int len;
  int buf;
  uint4 th;
  unsigned long long gth;

  __device__ __forceinline__ bool beats(const uint4 e) const {
    return key_prefix(e) >= gth && (len < k || key_gt(e, th));
  }

  // Merges the m candidates of `batch` (m <= 32) into the list.
  __device__ __forceinline__ void merge(int m) {
    const int lane = threadIdx.x & 31;
    const uint4* cur = lists + buf * k;
    uint4* nxt = lists + (buf ^ 1) * k;
    const bool has = lane < m;
    const uint4 mine = has ? batch[lane] : make_uint4(0u, 0u, 0u, 0u);
    bool keep = has;
    int del = -1;
    if (kSeg) {
      // the batch's duplicates: the best of each address stays
      for (int u = 0; u < m; ++u) {
        const uint4 o = batch[u];
        if (u != lane && same_addr(o, mine) &&
            (key_gt(o, mine) || (same_key(o, mine) && u < lane))) {
          keep = false;
        }
      }
      // the list's: lane l holds entries c0 + l + 32e of each chunk c0,
      // and marks the candidate whose address one of them holds (the
      // list's addresses are distinct)
      if (has) bdel[lane] = -1;
      __syncwarp();
      for (int c0 = 0; c0 < len; c0 += kChunk) {
        uint4 own[kListSlots];
#pragma unroll
        for (int e = 0; e < kListSlots; ++e) {
          const int j = c0 + lane + 32 * e;
          own[e] = j < len ? cur[j] : make_uint4(0u, 0u, 0u, 0u);
        }
        for (int u = 0; u < m; ++u) {
          const uint4 o = batch[u];
#pragma unroll
          for (int e = 0; e < kListSlots; ++e) {
            const int j = c0 + lane + 32 * e;
            if (j < len && same_addr(own[e], o)) bdel[u] = j;
          }
        }
      }
      __syncwarp();
      if (has) {
        const int j = bdel[lane];
        if (j >= 0) {
          // a strictly higher key replaces the entry
          if (keep && key_gt(mine, cur[j])) {
            del = j;
          } else {
            keep = false;
          }
        }
      }
    }
    int rl = 0;
    if (keep) {
      int lo = 0, hi = len;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (!key_gt(mine, cur[mid])) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      rl = lo;
    }
    if (has) {
      brank[lane] = keep ? rl : kDropped;
      bdel[lane] = del;
    }
    __syncwarp();
    int rc = 0;  // kept candidates above this one
    int dl = 0;  // replaced entries above its place in the list
    int n_kept = 0, n_del = 0;
    // the list a chunk at a time (at least once, for the batch's counts)
    for (int c0 = 0; c0 == 0 || c0 < len; c0 += kChunk) {
      int above[kListSlots] = {};  // kept candidates above entry c0+lane+32e
      int del_above[kListSlots] = {};  // replaced entries above it
      bool gone[kListSlots] = {};
      for (int u = 0; u < m; ++u) {
        const int r = brank[u], d = bdel[u];
        const bool ku = r != kDropped;
        if (c0 == 0) {
          const uint4 o = batch[u];
          n_kept += ku ? 1 : 0;
          n_del += d >= 0 ? 1 : 0;
          rc += (ku && (key_gt(o, mine) || (same_key(o, mine) && u < lane)))
                    ? 1 : 0;
          dl += (d >= 0 && d < rl) ? 1 : 0;
        }
#pragma unroll
        for (int e = 0; e < kListSlots; ++e) {
          const int j = c0 + lane + 32 * e;
          above[e] += (ku && r <= j) ? 1 : 0;
          del_above[e] += (d >= 0 && d < j) ? 1 : 0;
          gone[e] |= d == j;
        }
      }
#pragma unroll
      for (int e = 0; e < kListSlots; ++e) {
        const int j = c0 + lane + 32 * e;
        const int p = j - del_above[e] + above[e];
        if (j < len && !gone[e] && p < k) nxt[p] = cur[j];
      }
    }
    if (keep && rl - dl + rc < k) nxt[rl - dl + rc] = mine;
    __syncwarp();
    len = min(k, len - n_del + n_kept);
    buf ^= 1;
    if (len == k) th = lists[buf * k + k - 1];
  }

  // Merges the lanes' candidates `e` where `real` and beating the
  // thresholds, as one batch.
  __device__ __forceinline__ void insert(const uint4 e, bool real) {
    const bool h = real && beats(e);
    const unsigned b = __ballot_sync(kFull, h);
    if (b == 0) return;
    if (h) batch[__popc(b & lanemask_lt())] = e;
    __syncwarp();
    merge(__popc(b));
  }
};

// A lane's candidates of one row: score bits and docs.
struct Cands {
  uint32_t sb[kSlots];
  uint32_t dc[kSlots];
};

template <bool kSeg>
__device__ __forceinline__ uint4 entry(uint32_t score_bits, uint32_t doc,
                                       uint32_t seg) {
  return kSeg ? make_uint4(score_image(score_bits), ~seg, ~doc, 0u)
              : make_uint4(score_image(score_bits), ~doc, 0xffffffffu, 0u);
}

template <bool kSeg>
__global__ void __launch_bounds__(kSelThreads)
    merge_tail_select_kernel(const SelArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x * kSelWarps + warp;
  const int Q = a.num_queries, k = a.k, kk = a.kk;
  if (tile >= __ldg(a.s.qtile0 + Q)) return;  // a whole warp leaves
  const bool global_lists = a.s.lists != nullptr;
  unsigned char* ws =
      smem + warp * (global_lists ? kBatchBytes : warp_smem_bytes(k));
  Running<kSeg> run;
  run.batch = reinterpret_cast<uint4*>(ws);
  run.brank = reinterpret_cast<int*>(ws + 32 * 16);
  run.bdel = run.brank + 32;
  run.lists = global_lists ? a.s.lists + (long long)tile * 2 * k
                           : reinterpret_cast<uint4*>(ws + kBatchBytes);
  run.k = k;
  run.len = 0;
  run.buf = 0;
  run.th = make_uint4(0u, 0u, 0u, 0u);
  run.gth = 0ull;

  // the tile: its query and rows
  const int q = __ldg(a.s.tile_q + tile);
  const int t0 = __ldg(a.s.qtile0 + q);
  const int nt = __ldg(a.s.qtile0 + q + 1) - t0;
  const int lo = __ldg(a.s.qptr + q) + (tile - t0) * kTileRows;
  const int n = min(kTileRows, __ldg(a.s.qptr + q + 1) - lo);
  volatile unsigned long long* qth = a.s.qth + q;
  int my_row = 0;
  uint32_t my_seg = 0u;
  if (lane < n) {
    my_row = __ldg(a.s.order + lo + lane);
    if (kSeg) my_seg = (uint32_t)__ldg(a.segs + my_row);
  }

  // row r's candidates of this lane (-inf past kk)
  auto load = [&](int r) {
    const long long base = (long long)__shfl_sync(kFull, my_row, r) * kk;
    Cands c;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int j = lane + 32 * i;
      c.sb[i] = kNegInfBits;
      c.dc[i] = 0u;
      if (j < kk) {
        c.sb[i] = __float_as_uint(__ldg(a.scores + base + j));
        c.dc[i] = __ldg(a.docs + base + j);
      }
    }
    return c;
  };
  Cands next;
  if (n > 0) next = load(0);
  for (int r = 0; r < n; ++r) {
    const Cands c = next;
    if (r + 1 < n) next = load(r + 1);
    const uint32_t seg = kSeg ? __shfl_sync(kFull, my_seg, r) : 0u;
    if (nt > 1) {
      unsigned long long g = 0ull;
      if (lane == 0) g = *qth;
      run.gth = __shfl_sync(kFull, g, 0);
    }
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (32 * i < kk) {
        run.insert(entry<kSeg>(c.sb[i], c.dc[i], seg),
                   c.sb[i] != kNegInfBits);
      }
    }
    if (nt > 1 && run.len == k && lane == 0 &&
        key_prefix(run.th) > run.gth) {
      atomicMax(a.s.qth + q, key_prefix(run.th));
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
    // every tile's list, 32 entries a batch, the next 128 in flight; an
    // empty slot is all zeros. The lists hold the entries that set the
    // shared key, so only the running list's own threshold holds.
    const uint4* src = a.s.partial + (long long)t0 * k;
    const int total = nt * k;
    run.len = 0;
    run.gth = 0ull;
    uint4 next[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int e = lane + 32 * i;
      next[i] = e < total ? __ldcg(src + e) : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int e0 = 0; e0 < total; e0 += 32 * kSlots) {
      uint4 ent[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        ent[i] = next[i];
        const int e = e0 + 32 * kSlots + lane + 32 * i;
        next[i] = e < total ? __ldcg(src + e) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        run.insert(ent[i], (ent[i].x | ent[i].y | ent[i].z) != 0u);
      }
    }
  }

  // every slot of the query's output
  const long long plane = (long long)Q * k;
  for (int j = lane; j < k; j += 32) {
    uint32_t sb = kNegInfBits, doc = 0u, seg = 0u;
    if (j < run.len) {
      const uint4 e = run.lists[run.buf * k + j];
      sb = image_bits(e.x);
      if (kSeg) {
        seg = ~e.y;
        doc = ~e.z;
      } else {
        doc = ~e.y;
      }
    }
    const long long o = (long long)q * k + j;
    a.out[o] = (int32_t)sb;
    a.out[plane + o] = (int32_t)doc;
    if (kSeg) a.out[2 * plane + o] = (int32_t)seg;
  }
}

int check_args(int n_rows, int kk, int num_queries, int k) {
  if (k < 1 || kk < 1 || kk > kMaxKK || n_rows < 0 ||
      num_queries < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// Bytes of the scratch buffer one call of `n_rows` rows, `num_queries`
// queries and `k` needs (group and select share it).
extern "C" long long merge_tail_scratch_bytes(int n_rows, int num_queries,
                                              int k) {
  return scratch_layout(n_rows, num_queries, k, nullptr, nullptr);
}

// Kernel 1 of a call: groups the rows by query into `scratch`.
extern "C" int merge_tail_group_launch(const void* qids, int n_rows,
                                       int num_queries, int k, void* scratch,
                                       void* stream) {
  const int err = check_args(n_rows, 1, num_queries, k);
  if (err != 0 || ((uintptr_t)scratch & 15) != 0) {
    return err != 0 ? err : (int)cudaErrorInvalidValue;
  }
  GroupArgs a = {};
  a.qids = (const int32_t*)qids;
  a.n_rows = n_rows;
  a.num_queries = num_queries;
  scratch_layout(n_rows, num_queries, k, (char*)scratch, &a.s);
  merge_tail_group_kernel<<<1, qid_group::kThreads, 0,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel 2 of a call: each query's top-k into `out` ([2, Q, k] in the rows
// form, seg_form 0; [3, Q, k] in the seg form, seg_form 1).
extern "C" int merge_tail_select_launch(int seg_form, const void* scores,
                                        const void* docs, const void* segs,
                                        int n_rows, int kk, int num_queries,
                                        int k, void* scratch, void* out,
                                        void* stream) {
  const int err = check_args(n_rows, kk, num_queries, k);
  if (err != 0 || ((uintptr_t)scratch & 15) != 0 ||
      (seg_form != 0 && segs == nullptr && n_rows > 0)) {
    return err != 0 ? err : (int)cudaErrorInvalidValue;
  }
  SelArgs a = {};
  a.scores = (const float*)scores;
  a.docs = (const uint32_t*)docs;
  a.segs = (const int32_t*)segs;
  a.kk = kk;
  a.num_queries = num_queries;
  a.k = k;
  scratch_layout(n_rows, num_queries, k, (char*)scratch, &a.s);
  a.out = (int32_t*)out;
  const long long ctas =
      (tiles_max(n_rows, num_queries) + kSelWarps - 1) / kSelWarps;
  const int smem = select_smem_bytes(k);
  const cudaFuncAttribute opt = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e = cudaSuccess;
  if (seg_form != 0) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(merge_tail_select_kernel<true>, opt, smem);
    }
    if (e == cudaSuccess) {
      merge_tail_select_kernel<true>
          <<<(unsigned)ctas, kSelThreads, smem, (cudaStream_t)stream>>>(a);
    }
  } else {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(merge_tail_select_kernel<false>, opt, smem);
    }
    if (e == cudaSuccess) {
      merge_tail_select_kernel<false>
          <<<(unsigned)ctas, kSelThreads, smem, (cudaStream_t)stream>>>(a);
    }
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Threads, shared memory per CTA (static and dynamic) and CTAs resident per
// SM on the current device of the select kernel's rows form (form 0) or seg
// form (form 1) at `k`, or of the group kernel (form 2); returns a CUDA
// error code.
extern "C" int merge_tail_occupancy(int form, int k, int* threads,
                                    int* smem_bytes, int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (form == 2) {
    err = cudaFuncGetAttributes(&attr, merge_tail_group_kernel);
    if (err != cudaSuccess) return (int)err;
    *threads = qid_group::kThreads;
    *smem_bytes = (int)attr.sharedSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, merge_tail_group_kernel, qid_group::kThreads, 0);
  }
  const int dyn = select_smem_bytes(k);
  if (dyn > 48 * 1024) {
    err = form == 1 ? cudaFuncSetAttribute(
                          merge_tail_select_kernel<true>,
                          cudaFuncAttributeMaxDynamicSharedMemorySize, dyn)
                    : cudaFuncSetAttribute(
                          merge_tail_select_kernel<false>,
                          cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return (int)err;
  }
  err = form == 1
            ? cudaFuncGetAttributes(&attr, merge_tail_select_kernel<true>)
            : cudaFuncGetAttributes(&attr, merge_tail_select_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  *threads = kSelThreads;
  *smem_bytes = (int)attr.sharedSizeBytes + dyn;
  return (int)(form == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                               ctas_per_sm, merge_tail_select_kernel<true>,
                               kSelThreads, dyn)
                         : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                               ctas_per_sm, merge_tail_select_kernel<false>,
                               kSelThreads, dyn));
}
