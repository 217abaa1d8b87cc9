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
// Past a query's hits: score -inf, doc 0, seg 0. A candidate is a 16-byte
// entry {score image, ~seg, ~doc, 1} (seg form) or {score image, ~doc, ~0,
// 1} (rows form); its first three words are its 96-bit key, higher =
// better, the score image being the reference's `_sortable_desc` order,
// which keeps +0.0 above -0.0: the zeros are not folded. The fourth word
// tells a candidate (1) from padding (0) in a sort.
//
// One launch a call, any k >= 1 and kk <= kMaxKK (128), of one of two
// kernels, chosen from the call's shape (`make_plan`):
// * the small kernel, for calls of at most kSmallCands candidates,
//   kSmallRows rows and kSmallScan (query, row) pairs (a per-segment probe
//   launch's tail, mostly): one CTA a query walks every row's qid, stages
//   its query's rows in row order in shared memory and runs step 5 below
//   over all of them as one tile; no grouping, no scratch, no grid
//   barrier. The limits lie below where the two kernels cross on real
//   tails (`scripts/kernel_stages.py`, its "grid" and "small" copies): the
//   small kernel was faster on every call of up to 131,072 candidates
//   (8,192 rows, spread over 256 queries) and slower on most above, where
//   a query holding most of a call's rows leaves one CTA to walk them;
//   a call below the crossover whose rows crowd into a few queries was
//   not measured, so the limits stay where every such call is short;
// * the grid kernel, one cooperative launch, for the rest. Its grid is as
//   many CTAs of kThreads as the card holds at once, cut to one for each
//   kCtaCands candidates or for each query that may have rows (whichever
//   asks for more) and to the tiles a call can have; its phases:
// 1. zero the per-query counters; `grid.sync()`;
// 2. count: each row's place among its query's rows (one global atomic a
//    warp per distinct qid, `__match_any_sync`);
// 3. scan: the last CTA to finish counting (an arrival counter after
//    `__threadfence`) scans the counts into each query's row offset and
//    first tile, a query's rows making tiles of R = kTileCands / kk rows
//    (at most kMaxTileRows), and each tile's query, rows and its query's
//    first tile, while the other CTAs wait on its release flag;
// 4. scatter: each row's index into `order`, grouped by query (in the
//    order the atomics left; nothing below depends on it); the output
//    slots of a query with no row (it has no tile) are written here;
//    `grid.sync()`;
// 5. select: a CTA takes the tile of its own index, then tiles from a
//    shared counter. It stages its tile's row indices in shared memory
//    and walks the tile's R * kk candidates kRound at a time, the next
//    kRowDepth rounds' loads in flight (a window of registers that shifts
//    a round at a time). Filter, then select in bulk: a candidate that
//    beats the tile's running threshold (the k-th entry of its list, once
//    the list holds k) and the query's shared key (below) is appended to a
//    buffer after the list in shared memory (a ballot a warp, one shared
//    atomic a warp); when the next round might not fit, or the list is
//    short of k and list and buffer hold k, the CTA selects once over list
//    and buffer: a bitonic sort of the 128-bit entries, descending; in the
//    seg form a table on the address in shared memory keeps the first
//    (best) entry of each address; the first k survivors are the new list, its
//    k-th entry the threshold. The sort array holds S = the power of two
//    at or above k + kRound entries (at least kMinSort); up to
//    kSmemMaxSort (k <= 7680) in shared memory, above it in global scratch
//    (one array a CTA, the grid cut to one CTA an SM): same code, any k.
//    A query of one tile writes its output from the list.
// 6. cross-tile merge: the tiles of a query of several publish their
//    k-th key's top 64 bits (`atomicMax` on the query's shared key `qth`)
//    at every selection, and their lists (k entries, padding past their
//    length) to scratch; the last tile to finish (a counter after
//    `__threadfence`) runs step 5 over all the query's tile lists, every
//    thread of its CTA taking entries, with the query's final shared key
//    as the filter, and writes the output. Every output slot is written.
//
// Why the shared key filters exactly. A tile's list is the top-k of the
// tile's candidates after the dedup, so its k entries have k distinct
// addresses (seg form), each at or below its query-wide max: the query's
// k-th best distinct address is at or above every full tile's k-th key
// kappa_t (rows form: k entries of the query are at or above kappa_t).
// So every entry of the query's top-k is at or above max_t kappa_t, and
// its top 64 bits at or above max_t prefix(kappa_t) = qth. The filter
// drops an entry only when its top 64 bits lie strictly below qth: an
// entry whose top 64 bits equal qth's but whose third key word (the doc
// in the seg form) lies below kappa_t's is kept and left to the exact
// 96-bit selection. The same holds for the tile's own threshold: a
// candidate at or below the k-th entry of a full list is beaten by k
// entries of distinct addresses (rows form: by k entries); an equal key
// is an identical entry, whose output words are the same. The address
// dedup keeps the best entry of each address, and every address of the
// query's top-k has that entry in its tile's list, so the union of the
// filtered lists deduplicated gives the query's top-k; the result does not
// depend on the order of the rows, of the tiles, or of the appends.
//
// What bounds it on an H100: bytes. It reads W * kk * 8 bytes of
// candidates and W * 4 of qids (and W * 4 of segs), and writes
// Q * k * 4 * (2 or 3). Its design: one pass over the candidates, most of
// which cost their load and one compare once a tile's list is full; a
// selection is a sort in shared memory over a few hundred entries; the
// whole call is one launch, with no CTA walking a query alone except the
// tile lists of one query. Most calls are small (a per-segment tail is
// under 1 MB), so latency sets their time: the grid kernel's grouping is
// a chain of dependent round trips to device memory and grid barriers,
// which the small kernel skips. No tensor-core work.
//
// Why a tile's rows are not staged by bulk copies (cp.async.bulk, as K7's
// select kernel stages its rows): the rows are scattered by `order`, so
// each row is a copy of its own of kk * 4 bytes of scores and as many of
// docs, 40 bytes at the per-segment tails' kk = 10, where row r starts
// 16-byte aligned only for even r (a bulk copy needs a 16-byte aligned
// address and size), and 128 or 512 bytes at the fused chains' kk = 32 or
// 128, 512 or 128 copies a tile. Loads are not what a tile waits on: the
// window of registers keeps kRowDepth rounds of a CTA's loads in flight,
// and a copy that makes every load but offers no candidate
// (`scripts/kernel_stages.py`, its "loads" stage) adds 7-25% of a batch's
// time to the grouping, against 31-68% for the selections.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxKK = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 2;  // candidates a thread takes a round
constexpr int kRound = kThreads * kPer;
constexpr int kRowDepth = 4;   // rounds of row candidates in flight
constexpr int kListDepth = 2;  // rounds of tile-list entries in flight
constexpr int kCtaCands = 2048;  // the grid asks for a CTA per kCtaCands
constexpr int kTileCands = 8192;  // candidates a tile holds, R * kk
constexpr int kMaxTileRows = 1024;
constexpr int kMinSort = 1024;
constexpr int kSmemMaxSort = 8192;
constexpr int kQPer = 16;  // queries a thread scans in one pass
// calls of at most kSmallCands candidates, kSmallRows rows and kSmallScan
// (query, row) pairs take the small kernel, one CTA a query (below the
// crossover, above)
constexpr int kSmallCands = 16384;
constexpr int kSmallRows = 2048;
constexpr long long kSmallScan = 1LL << 22;
constexpr uint32_t kNegInfBits = 0xff800000u;
// the opt-in shared memory of a CTA on sm_90
constexpr int kSmemOptin = 227 * 1024;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// --- the plan of a call: tile rows, sort size, grid and scratch

struct Plan {
  int R;       // rows a tile
  int S;       // entries of a sort array
  bool global; // sort arrays in global scratch
  bool small;  // the small kernel: one CTA a query, no grouping
  int smem;    // dynamic shared memory of a CTA
  long long t_max;  // tiles a call can have
  long long want;   // CTAs the call's candidates ask for
};

int next_pow2(long long x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

Plan make_plan(int n_rows, int kk, int num_queries, int k, bool seg) {
  Plan p;
  p.R = kTileCands / kk;
  if (p.R > kMaxTileRows) p.R = kMaxTileRows;
  const long long need = (long long)k + kRound;
  p.S = need > (1LL << 30) ? (1 << 30) : next_pow2(need);
  if (p.S < kMinSort) p.S = kMinSort;
  p.global = p.S > kSmemMaxSort;
  p.small = !p.global && (long long)n_rows * kk <= kSmallCands &&
            n_rows <= kSmallRows &&
            (long long)n_rows * num_queries <= kSmallScan;
  if (p.small) p.R = kSmallRows;
  const int rows_bytes = p.R * 4;
  p.smem = rows_bytes +
           (p.global ? 0 : p.S * 16 + (seg ? 2 * p.S * 4 : 0));
  p.t_max = (long long)n_rows / p.R +
            (num_queries < n_rows ? num_queries : n_rows) + 1;
  // a CTA for each kCtaCands candidates, or for each query that may have
  // rows, whichever asks for more
  const long long busy = num_queries < n_rows ? num_queries : n_rows;
  p.want = ((long long)n_rows * kk + kCtaCands - 1) / kCtaCands;
  if (p.want < busy) p.want = busy;
  if (p.want < 1) p.want = 1;
  return p;
}

struct Scratch {
  int32_t* cnt;     // [Q] rows of each query
  int32_t* done;    // [Q] tiles of the query finished
  unsigned long long* qth;  // [Q] best k-th key prefix a tile published
  int32_t* qptr;    // [Q + 1] row offsets by query
  int32_t* qtile0;  // [Q + 1] first tile of each query; [Q] = tiles
  int32_t* slot;    // [W] each row's place among its query's rows
  int32_t* order;   // [W] row indices grouped by query
  int4* tile;       // [t_max] each tile: its query, first row in `order`,
                    // rows, and the query's first tile
  int32_t* sync;    // [4] the tile counter, the count's arrivals and
                    // its release
  uint4* partial;   // [t_max, k] tile lists of queries of several tiles
  uint4* gsort;     // [grid, S] sort arrays (global plan), else null
  int32_t* gtable;  // [grid, 2 S] address tables (global plan), else null
};

long long scratch_layout(const Plan& p, int n_rows, int num_queries, int k,
                         int grid, char* base, Scratch* s) {
  const long long Q = num_queries, W = n_rows;
  const long long bytes[12] = {
      4 * Q, 4 * Q, 8 * Q, 4 * (Q + 1), 4 * (Q + 1), 4 * W, 4 * W,
      16 * p.t_max, 16, p.t_max * k * 16,
      p.global ? (long long)grid * p.S * 16 : 0,
      p.global ? (long long)grid * p.S * 8 : 0};
  long long at[12], off = 0;
  for (int i = 0; i < 12; ++i) {
    at[i] = off;
    off += (bytes[i] + 15) & ~15LL;
  }
  if (s != nullptr) {
    s->cnt = reinterpret_cast<int32_t*>(base + at[0]);
    s->done = reinterpret_cast<int32_t*>(base + at[1]);
    s->qth = reinterpret_cast<unsigned long long*>(base + at[2]);
    s->qptr = reinterpret_cast<int32_t*>(base + at[3]);
    s->qtile0 = reinterpret_cast<int32_t*>(base + at[4]);
    s->slot = reinterpret_cast<int32_t*>(base + at[5]);
    s->order = reinterpret_cast<int32_t*>(base + at[6]);
    s->tile = reinterpret_cast<int4*>(base + at[7]);
    s->sync = reinterpret_cast<int32_t*>(base + at[8]);
    s->partial = reinterpret_cast<uint4*>(base + at[9]);
    s->gsort = p.global ? reinterpret_cast<uint4*>(base + at[10]) : nullptr;
    s->gtable = p.global ? reinterpret_cast<int32_t*>(base + at[11])
                         : nullptr;
  }
  return off;
}

struct Args {
  const float* scores;   // [W, kk]
  const uint32_t* docs;  // [W, kk]
  const int32_t* segs;   // [W], the seg form
  const int32_t* qids;   // [W]
  int n_rows;
  int kk;
  int num_queries;
  int k;
  int R;
  int S;
  Scratch s;
  int32_t* out;  // [2 or 3, Q, k]
};

// --- entries

// The order-keeping u32 image of a score's bits: `_sortable_desc`'s
// complement, one image a bit pattern (+0.0 above -0.0).
__device__ __forceinline__ uint32_t score_image(uint32_t u) {
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The score bits of an image.
__device__ __forceinline__ uint32_t image_bits(uint32_t x) {
  return (x & 0x80000000u) ? (x & 0x7fffffffu) : ~x;
}

// The 96-bit keys: a above b.
__device__ __forceinline__ bool key_gt(const uint4 a, const uint4 b) {
  if (a.x != b.x) return a.x > b.x;
  if (a.y != b.y) return a.y > b.y;
  return a.z > b.z;
}

// The sort's order: the key, then candidate above padding.
__device__ __forceinline__ bool entry_gt(const uint4 a, const uint4 b) {
  if (a.x != b.x) return a.x > b.x;
  if (a.y != b.y) return a.y > b.y;
  if (a.z != b.z) return a.z > b.z;
  return a.w > b.w;
}

// The key's top 64 bits: what the tiles of a query share.
__device__ __forceinline__ unsigned long long key_prefix(const uint4 e) {
  return ((unsigned long long)e.x << 32) | e.y;
}

template <bool kSeg>
__device__ __forceinline__ uint4 entry(uint32_t score_bits, uint32_t doc,
                                       uint32_t seg) {
  return kSeg ? make_uint4(score_image(score_bits), ~seg, ~doc, 1u)
              : make_uint4(score_image(score_bits), ~doc, 0xffffffffu, 1u);
}

__device__ __forceinline__ uint32_t addr_hash(const uint4 e) {
  uint32_t h = e.y * 0x9e3779b1u ^ (e.z * 0x85ebca77u);
  h ^= h >> 15;
  h *= 0x2c1b3c6du;
  h ^= h >> 13;
  return h;
}

// --- block-wide pieces (every thread of the CTA calls them)

struct BlockShared {
  int2 wsum[kWarps];
  int2 total;
  int cnt[3];               // entries a round appended, by round mod 3
  int tile;                 // the tile taken
  int last;                 // this CTA finishes the query
  unsigned long long gth[2];  // the query's shared key, by round parity
};

// Exclusive scan of (x, y) over the CTA; `total` gets the sums.
__device__ __forceinline__ int2 block_scan2(int2 v, BlockShared& sh,
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
  if (lane == 31) sh.wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int2 s = lane < kWarps ? sh.wsum[lane] : make_int2(0, 0);
    int2 si = s;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int x = __shfl_up_sync(kFull, si.x, d);
      const int y = __shfl_up_sync(kFull, si.y, d);
      if (lane >= d) {
        si.x += x;
        si.y += y;
      }
    }
    if (lane < kWarps) sh.wsum[lane] = make_int2(si.x - s.x, si.y - s.y);
    if (lane == kWarps - 1) sh.total = si;
  }
  __syncthreads();
  const int2 base = sh.wsum[warp];
  *total = sh.total;
  __syncthreads();
  return make_int2(base.x + inc.x - v.x, base.y + inc.y - v.y);
}

// Sorts arr[0, P) descending by `entry_gt` (P a power of two).
__device__ void bitonic_desc(uint4* arr, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const uint4 a = arr[lo], b = arr[hi];
        const bool desc = (lo & size) == 0;
        if (desc ? entry_gt(b, a) : entry_gt(a, b)) {
          arr[lo] = b;
          arr[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// A CTA's running top-k: the list arr[0, len), best first, then the
// buffer arr[len, len + n); `th` the list's k-th entry once it holds k;
// `gth` the query's shared key (0: none). Block-uniform.
template <bool kSeg>
struct Sel {
  uint4* arr;
  int32_t* table;  // 2 S slots (seg form)
  int S, k;
  int len, n;
  uint4 th;
  unsigned long long gth;

  __device__ __forceinline__ bool beats(const uint4 e) const {
    return key_prefix(e) >= gth && (len < k || key_gt(e, th));
  }

  // Whether the next round may not fit, or the list can be filled.
  __device__ __forceinline__ bool must_select() const {
    return len + n + kRound > S || (len < k && n > 0 && len + n >= k);
  }

  // Appends the candidates that beat the thresholds after the buffer's
  // n entries, counting them in `*cnt` (the round's count, zero at its
  // start); every thread calls it once per candidate slot of a round.
  __device__ __forceinline__ void offer(const uint4 e, bool real,
                                        int* cnt) {
    const bool pass = real && beats(e);
    const unsigned b = __ballot_sync(kFull, pass);
    if (b == 0) return;
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(b) - 1;
    int at = 0;
    if (lane == leader) at = atomicAdd(cnt, __popc(b));
    at = __shfl_sync(kFull, at, leader);
    if (pass) arr[len + n + at + __popc(b & lanemask_lt())] = e;
  }

  // The table slot holding entry i's address (after the inserts); reads
  // words y and z alone, as other threads mark word w meanwhile.
  __device__ __forceinline__ int find(const uint4 e, int mask) const {
    int h = (int)(addr_hash(e) & (uint32_t)mask);
    for (;;) {
      const int cur = table[h];
      if (arr[cur].y == e.y && arr[cur].z == e.z) return cur;
      h = (h + 1) & mask;
    }
  }

  // One selection over list and buffer: the new list is the first k
  // entries (seg form: of distinct addresses, each its best) of both.
  __device__ void select(BlockShared& sh) {
    const int N = len + n;
    int P = 2;
    while (P < N) P <<= 1;
    for (int i = N + threadIdx.x; i < P; i += kThreads) {
      arr[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    bitonic_desc(arr, P);
    int m = N < k ? N : k;
    if (kSeg) {
      // the first entry of each address in sorted order, its best
      const int T = 2 * P, mask = T - 1;
      volatile int32_t* vt = table;
      for (int i = threadIdx.x; i < T; i += kThreads) table[i] = -1;
      __syncthreads();
      for (int i = threadIdx.x; i < N; i += kThreads) {
        const uint4 e = arr[i];
        int h = (int)(addr_hash(e) & (uint32_t)mask);
        for (;;) {
          int cur = vt[h];
          if (cur < 0) {
            cur = atomicCAS(table + h, -1, i);
            if (cur < 0) break;
          }
          const uint4 o = arr[cur];
          if (o.y == e.y && o.z == e.z) {
            atomicMin(table + h, i);
            break;
          }
          h = (h + 1) & mask;
        }
      }
      __syncthreads();
      // each address's first entry, its best, marked w = 2 (the lookups
      // read words y and z alone)
      for (int i = threadIdx.x; i < N; i += kThreads) {
        if (find(arr[i], mask) == i) arr[i].w = 2u;
      }
      __syncthreads();
      // compaction a pass of kThreads entries at a time, in order: an
      // entry moves to its rank among the kept, never past its place
      int kept = 0;
      for (int r = 0; r * kThreads < N && kept < k; ++r) {
        const int i = r * kThreads + threadIdx.x;
        uint4 e = make_uint4(0u, 0u, 0u, 0u);
        if (i < N) e = arr[i];
        const bool f = e.w == 2u;
        int2 tot;
        const int2 ex = block_scan2(make_int2(f ? 1 : 0, 0), sh, &tot);
        if (f && kept + ex.x < k) {
          e.w = 1u;
          arr[kept + ex.x] = e;
        }
        kept += tot.x;
        __syncthreads();
      }
      m = kept < k ? kept : k;
    }
    len = m;
    n = 0;
    if (len == k) th = arr[k - 1];
    __syncthreads();
  }
};

// A tile's candidates: row r of the tile's staged rows, lane j, for
// f = r * kk + j; loaded raw, made entries when used.
struct RowSource {
  static constexpr int kDepth = kRowDepth;
  struct Raw {
    uint32_t sb, doc, seg;
  };
  const float* scores;
  const uint32_t* docs;
  const int32_t* segs;  // [W], the seg form, else null
  const int32_t* rows;  // the tile's row indices (shared memory)
  int kk;

  __device__ __forceinline__ Raw issue(long long f, long long M) const {
    Raw r = {kNegInfBits, 0u, 0u};
    if (f < M) {
      const int i = (int)f / kk, j = (int)f - i * kk;
      const int row = rows[i];
      const long long at = (long long)row * kk + j;
      r.sb = __float_as_uint(__ldg(scores + at));
      r.doc = __ldg(docs + at);
      if (segs != nullptr) r.seg = (uint32_t)__ldg(segs + row);
    }
    return r;
  }

  template <bool kSeg>
  __device__ __forceinline__ uint4 make(const Raw& r, long long,
                                        bool* real) const {
    *real = r.sb != kNegInfBits;
    return entry<kSeg>(r.sb, r.doc, r.seg);
  }
};

// The tile lists of a query of several: entry f of their concatenation,
// padding (w = 0) past a list's length.
struct ListSource {
  static constexpr int kDepth = kListDepth;
  using Raw = uint4;
  const uint4* src;

  __device__ __forceinline__ Raw issue(long long f, long long M) const {
    return f < M ? __ldcg(src + f) : make_uint4(0u, 0u, 0u, 0u);
  }

  template <bool kSeg>
  __device__ __forceinline__ uint4 make(const Raw& r, long long,
                                        bool* real) const {
    *real = r.w != 0u;
    return r;
  }
};

// Walks `M` candidates of `src` through the running top-k, a round of
// kRound at a time with Src::kDepth rounds of loads in flight (candidate
// f of round f0 is f0 + p * kThreads + thread); `q_multi` the query has
// several tiles: publish the k-th key, read the shared one.
template <bool kSeg, typename Src>
__device__ __forceinline__ void run_select(Sel<kSeg>& sel, BlockShared& sh,
                                           long long M, const Src& src,
                                           unsigned long long* qth,
                                           bool q_multi) {
  constexpr int D = Src::kDepth;
  // round r counts its appends in sh.cnt[r % 3]: thread 0 zeroes the
  // next round's slot before round r's barrier, and every thread adds the
  // slot to sel.n after it. A slot is zeroed two rounds after it was read,
  // so no thread still reads it then (with two slots, a warp that starts
  // round r + 1 early would count into the slot a late warp of round r has
  // yet to read, and the warps' sel.n, on which they all select or none,
  // could differ).
  if (threadIdx.x == 0) sh.cnt[0] = sh.cnt[1] = sh.cnt[2] = 0;
  __syncthreads();
  int slot = 0;
  // a window of D rounds' loads: round f0 uses window[0], then the window
  // shifts and loads round f0 + D * kRound into its end
  typename Src::Raw window[D][kPer];
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      window[d][p] = src.issue((long long)d * kRound + p * kThreads +
                               threadIdx.x, M);
    }
  }
  int parity = 0;
  // the shared key, read a round before it is published to the CTA
  unsigned long long g_next = 0ull;
  if (q_multi && threadIdx.x == 0) g_next = __ldcg(qth);
  for (long long f0 = 0; f0 < M; f0 += kRound) {
    if (sel.must_select()) {
      sel.select(sh);
      if (q_multi && sel.len == sel.k && threadIdx.x == 0 &&
          key_prefix(sel.th) > sel.gth) {
        atomicMax(qth, key_prefix(sel.th));
      }
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      bool real;
      const uint4 e = src.template make<kSeg>(
          window[0][p], f0 + p * kThreads + threadIdx.x, &real);
      sel.offer(e, real, sh.cnt + slot);
    }
#pragma unroll
    for (int d = 0; d + 1 < D; ++d) {
#pragma unroll
      for (int p = 0; p < kPer; ++p) window[d][p] = window[d + 1][p];
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      window[D - 1][p] = src.issue(f0 + (long long)D * kRound +
                                   p * kThreads + threadIdx.x, M);
    }
    const int next = slot == 2 ? 0 : slot + 1;
    if (threadIdx.x == 0) {
      sh.cnt[next] = 0;
      if (q_multi) {
        sh.gth[parity ^ 1] = g_next;
        g_next = __ldcg(qth);
      }
    }
    __syncthreads();
    sel.n += sh.cnt[slot];
    if (q_multi) {
      const unsigned long long g = sh.gth[parity ^ 1];
      if (g > sel.gth) sel.gth = g;
    }
    parity ^= 1;
    slot = next;
  }
  if (sel.n > 0) {
    sel.select(sh);
    if (q_multi && sel.len == sel.k && threadIdx.x == 0) {
      atomicMax(qth, key_prefix(sel.th));
    }
  }
}

// Every output slot of query q from the list.
template <bool kSeg>
__device__ __forceinline__ void write_out(const Sel<kSeg>& sel,
                                          const Args& a, int q) {
  const long long plane = (long long)a.num_queries * a.k;
  for (int j = threadIdx.x; j < a.k; j += kThreads) {
    uint32_t sb = kNegInfBits, doc = 0u, seg = 0u;
    if (j < sel.len) {
      const uint4 e = sel.arr[j];
      sb = image_bits(e.x);
      if (kSeg) {
        seg = ~e.y;
        doc = ~e.z;
      } else {
        doc = ~e.y;
      }
    }
    const long long o = (long long)q * a.k + j;
    a.out[o] = (int32_t)sb;
    a.out[plane + o] = (int32_t)doc;
    if (kSeg) a.out[2 * plane + o] = (int32_t)seg;
  }
}

template <bool kSeg>
__global__ void __launch_bounds__(kThreads)
    merge_tail_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ BlockShared sh;
  cg::grid_group grid = cg::this_grid();
  const Scratch& s = a.s;
  const int tid = threadIdx.x, lane = tid & 31;
  const int Q = a.num_queries, W = a.n_rows, R = a.R;
  const long long gtid = (long long)blockIdx.x * kThreads + tid;
  const long long gsize = (long long)gridDim.x * kThreads;

  // 1. zero the counters
  for (long long i = gtid; i < Q; i += gsize) {
    s.cnt[i] = 0;
    s.done[i] = 0;
    s.qth[i] = 0ull;
  }
  if (gtid < 4) s.sync[gtid] = 0;
  grid.sync();

  // 2. count: each row's place among its query's rows
  for (long long w0 = 0; w0 < W; w0 += gsize) {
    const long long w = w0 + gtid;
    const int q = w < W ? __ldg(a.qids + w) : -1;
    const bool ok = q >= 0 && q < Q;
    const unsigned peers = __match_any_sync(kFull, ok ? q : -1);
    const int leader = __ffs(peers) - 1;
    int at = 0;
    if (ok && lane == leader) at = atomicAdd(s.cnt + q, __popc(peers));
    at = __shfl_sync(kFull, at, leader);
    if (ok) s.slot[w] = at + __popc(peers & lanemask_lt());
  }

  // 3. scan, by the last CTA to finish counting while the others wait:
  //    each query's row offset, first tile and tiles' query (a query with
  //    no row has no tile)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    sh.last = atomicAdd(s.sync + 1, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (sh.last) {
    __threadfence();
    int2 carry = make_int2(0, 0);
    for (int q0 = 0; q0 < Q; q0 += kThreads * kQPer) {
      const int qa = q0 + tid * kQPer;
      int cnt[kQPer];
      int2 mine = make_int2(0, 0);
#pragma unroll
      for (int i = 0; i < kQPer; ++i) {
        cnt[i] = qa + i < Q ? __ldcg(s.cnt + qa + i) : 0;
        mine.x += cnt[i];
        mine.y += (cnt[i] + R - 1) / R;
      }
      int2 tot;
      const int2 ex = block_scan2(mine, sh, &tot);
      int2 at = make_int2(carry.x + ex.x, carry.y + ex.y);
#pragma unroll
      for (int i = 0; i < kQPer; ++i) {
        if (qa + i >= Q) break;
        const int n = cnt[i];
        const int nt = (n + R - 1) / R;
        s.qptr[qa + i] = at.x;
        s.qtile0[qa + i] = at.y;
        for (int j = 0; j < nt; ++j) {
          const int lo = at.x + j * R;
          s.tile[at.y + j] = make_int4(qa + i, lo, min(R, at.x + n - lo),
                                       at.y);
        }
        at.x += n;
        at.y += nt;
      }
      carry.x += tot.x;
      carry.y += tot.y;
    }
    if (tid == 0) {
      s.qptr[Q] = carry.x;
      s.qtile0[Q] = carry.y;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(s.sync + 2, 1);
  } else if (tid == 0) {
    while (*(volatile int32_t*)(s.sync + 2) == 0) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();

  // 4. scatter: each row's index, grouped by query; the slots of a query
  //    with no row
  for (long long w = gtid; w < W; w += gsize) {
    const int q = __ldg(a.qids + w);
    if (q >= 0 && q < Q) {
      s.order[__ldcg(s.qptr + q) + __ldcg(s.slot + w)] = (int32_t)w;
    }
  }
  {
    const long long plane = (long long)Q * a.k;
    for (long long i = gtid; i < plane; i += gsize) {
      if (__ldcg(s.cnt + i / a.k) == 0) {
        a.out[i] = (int32_t)kNegInfBits;
        a.out[plane + i] = 0;
        if (kSeg) a.out[2 * plane + i] = 0;
      }
    }
  }
  grid.sync();

  // 5. select: the tiles
  Sel<kSeg> sel;
  sel.S = a.S;
  sel.k = a.k;
  int32_t* s_rows;
  if (s.gsort != nullptr) {
    sel.arr = s.gsort + (long long)blockIdx.x * a.S;
    sel.table = s.gtable + (long long)blockIdx.x * 2 * a.S;
    s_rows = reinterpret_cast<int32_t*>(smem);
  } else {
    sel.arr = reinterpret_cast<uint4*>(smem);
    sel.table = reinterpret_cast<int32_t*>(smem + (size_t)a.S * 16);
    s_rows = reinterpret_cast<int32_t*>(
        smem + (size_t)a.S * (kSeg ? 24 : 16));
  }
  const int n_tiles = __ldcg(s.qtile0 + Q);
  const int kk = a.kk;
  // the first tile of each CTA by its index, the rest from the counter
  int tile = blockIdx.x;
  while (tile < n_tiles) {
    const int4 d = __ldcg(s.tile + tile);
    const int q = d.x, lo = d.y, n_rows = d.z, t0 = d.w;
    const int nt = __ldcg(s.qtile0 + q + 1) - t0;
    for (int r = tid; r < n_rows; r += kThreads) {
      s_rows[r] = __ldcg(s.order + lo + r);
    }
    if (tid == 0) {
      sh.gth[0] = sh.gth[1] = 0ull;
      sh.tile = n_tiles > (int)gridDim.x
                    ? (int)gridDim.x + atomicAdd(s.sync, 1) : n_tiles;
    }
    __syncthreads();
    const int next = sh.tile;
    sel.len = 0;
    sel.n = 0;
    sel.th = make_uint4(0u, 0u, 0u, 0u);
    sel.gth = 0ull;
    const bool multi = nt > 1;
    RowSource rsrc;
    rsrc.scores = a.scores;
    rsrc.docs = a.docs;
    rsrc.segs = kSeg ? a.segs : nullptr;
    rsrc.rows = s_rows;
    rsrc.kk = kk;
    run_select<kSeg>(sel, sh, (long long)n_rows * kk, rsrc, s.qth + q,
                     multi);
    if (!multi) {
      write_out<kSeg>(sel, a, q);
      __syncthreads();
      tile = next;
      continue;
    }
    // 6. publish the tile's list; the last tile of the query merges them
    uint4* part = s.partial + (long long)tile * a.k;
    for (int j = tid; j < a.k; j += kThreads) {
      part[j] = j < sel.len ? sel.arr[j] : make_uint4(0u, 0u, 0u, 0u);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) sh.last = atomicAdd(s.done + q, 1) == nt - 1;
    __syncthreads();
    tile = next;
    if (!sh.last) continue;
    __threadfence();
    const uint4* src = s.partial + (long long)t0 * a.k;
    sel.len = 0;
    sel.n = 0;
    sel.th = make_uint4(0u, 0u, 0u, 0u);
    sel.gth = __ldcg(s.qth + q);
    ListSource lsrc;
    lsrc.src = src;
    run_select<kSeg>(sel, sh, (long long)nt * a.k, lsrc, s.qth + q, false);
    write_out<kSeg>(sel, a, q);
    __syncthreads();
  }
}

// The small kernel: CTA q walks every row's qid, stages its query's rows
// in row order, and runs step 5 over all of them as one tile (no scratch,
// no grid barrier, no cross-tile merge).
template <bool kSeg>
__global__ void __launch_bounds__(kThreads)
    merge_tail_small_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ BlockShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x, W = a.n_rows;
  Sel<kSeg> sel;
  sel.S = a.S;
  sel.k = a.k;
  sel.arr = reinterpret_cast<uint4*>(smem);
  sel.table = reinterpret_cast<int32_t*>(smem + (size_t)a.S * 16);
  int32_t* s_rows = reinterpret_cast<int32_t*>(
      smem + (size_t)a.S * (kSeg ? 24 : 16));
  int n_rows = 0;
  for (int w0 = 0; w0 < W; w0 += kThreads) {
    const int w = w0 + tid;
    const bool mine = w < W && __ldg(a.qids + w) == q;
    const unsigned b = __ballot_sync(kFull, mine);
    if (lane == 0) sh.wsum[warp].x = __popc(b);
    __syncthreads();
    int before = n_rows, total = n_rows;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int c = sh.wsum[i].x;
      before += i < warp ? c : 0;
      total += c;
    }
    if (mine) s_rows[before + __popc(b & lanemask_lt())] = w;
    n_rows = total;
    __syncthreads();
  }
  // 5. select: the query's rows as one tile
  sel.len = 0;
  sel.n = 0;
  sel.th = make_uint4(0u, 0u, 0u, 0u);
  sel.gth = 0ull;
  RowSource rsrc;
  rsrc.scores = a.scores;
  rsrc.docs = a.docs;
  rsrc.segs = kSeg ? a.segs : nullptr;
  rsrc.rows = s_rows;
  rsrc.kk = a.kk;
  run_select<kSeg>(sel, sh, (long long)n_rows * a.kk, rsrc, nullptr, false);
  write_out<kSeg>(sel, a, q);
}

int check_args(int n_rows, int kk, int num_queries, int k) {
  if (k < 1 || kk < 1 || kk > kMaxKK || n_rows < 0 || num_queries < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// The kernel a plan launches.
const void* kernel_of(const Plan& p, bool seg) {
  if (p.small) {
    return seg ? (const void*)merge_tail_small_kernel<true>
               : (const void*)merge_tail_small_kernel<false>;
  }
  return seg ? (const void*)merge_tail_kernel<true>
             : (const void*)merge_tail_kernel<false>;
}

// CTAs an SM holds of the plan's kernel at its shared memory, and the
// SMs of the current device. Worked out once a (device, kernel, shared
// memory): a kernel's limit of dynamic shared memory is raised to what a
// call needs when it first needs more, and only ever rises, so that no
// call lowers the limit another launches under.
int occupancy_of(const Plan& p, bool seg, int* ctas_per_sm, int* sms) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, std::pair<int, int>>
      known;
  static std::map<std::pair<int, const void*>, int> opted;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const void* fn = kernel_of(p, seg);
  const auto key = std::make_tuple(dev, fn, p.smem);
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(key);
  if (it == known.end()) {
    int per_sm = 0, n_sm = 0;
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    int& limit = opted[std::make_pair(dev, fn)];
    if (e == cudaSuccess && p.smem > limit) {
      e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
      if (e == cudaSuccess) limit = p.smem;
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kThreads, p.smem);
    }
    if (e != cudaSuccess) return (int)e;
    it = known.emplace(key, std::make_pair(per_sm, n_sm)).first;
  }
  *ctas_per_sm = it->second.first;
  if (sms != nullptr) *sms = it->second.second;
  return 0;
}

// The grid of a call: the CTAs the card holds at once (one an SM when the
// sort arrays are in global scratch), at most the tiles a call can have.
int grid_of(const Plan& p, bool seg, int* grid) {
  int sms = 0, per_sm = 0;
  const int err = occupancy_of(p, seg, &per_sm, &sms);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long g = (long long)(p.global ? 1 : per_sm) * sms;
  if (g > p.t_max) g = p.t_max;
  if (g > p.want) g = p.want;
  *grid = (int)g;
  return 0;
}

}  // namespace

// Bytes of the scratch buffer one call needs (on the current device).
extern "C" long long merge_tail_scratch_bytes(int seg_form, int n_rows,
                                              int kk, int num_queries,
                                              int k) {
  if (check_args(n_rows, kk, num_queries, k) != 0) return -1;
  const Plan p = make_plan(n_rows, kk, num_queries, k, seg_form != 0);
  if (p.small) return 16;
  int grid = 0;
  if (grid_of(p, seg_form != 0, &grid) != 0) return -1;
  return scratch_layout(p, n_rows, num_queries, k, grid, nullptr, nullptr);
}

// The largest k whose sort arrays stay in shared memory.
extern "C" int merge_tail_smem_max_k() { return kSmemMaxSort - kRound; }

// One call: each query's top-k into `out` ([2, Q, k] in the rows form,
// seg_form 0; [3, Q, k] in the seg form, seg_form 1); `scratch` holds
// `merge_tail_scratch_bytes` bytes, 16-byte aligned. `*path` gets the
// kernel it launches: 0 the grid kernel with its sort arrays in shared
// memory, 1 the same with them in global scratch, 2 the small kernel.
extern "C" int merge_tail_launch(int seg_form, const void* scores,
                                 const void* docs, const void* segs,
                                 const void* qids, int n_rows, int kk,
                                 int num_queries, int k, void* scratch,
                                 void* out, void* stream, int* path) {
  const int err = check_args(n_rows, kk, num_queries, k);
  if (err != 0 || ((uintptr_t)scratch & 15) != 0 ||
      (seg_form != 0 && segs == nullptr && n_rows > 0)) {
    return err != 0 ? err : (int)cudaErrorInvalidValue;
  }
  const bool seg = seg_form != 0;
  const Plan p = make_plan(n_rows, kk, num_queries, k, seg);
  if (p.smem > kSmemOptin) return (int)cudaErrorInvalidValue;
  *path = p.small ? 2 : p.global ? 1 : 0;
  int grid = num_queries, per_sm = 0;
  const int gerr = p.small ? occupancy_of(p, seg, &per_sm, nullptr)
                           : grid_of(p, seg, &grid);
  if (gerr != 0) return gerr;
  Args a = {};
  a.scores = (const float*)scores;
  a.docs = (const uint32_t*)docs;
  a.segs = (const int32_t*)segs;
  a.qids = (const int32_t*)qids;
  a.n_rows = n_rows;
  a.kk = kk;
  a.num_queries = num_queries;
  a.k = k;
  a.R = p.R;
  a.S = p.S;
  a.out = (int32_t*)out;
  void* params[] = {&a};
  cudaError_t e;
  if (p.small) {
    e = cudaLaunchKernel(kernel_of(p, seg), dim3((unsigned)grid),
                         dim3(kThreads), params, (size_t)p.smem,
                         (cudaStream_t)stream);
  } else {
    scratch_layout(p, n_rows, num_queries, k, grid, (char*)scratch, &a.s);
    e = cudaLaunchCooperativeKernel(kernel_of(p, seg), dim3((unsigned)grid),
                                    dim3(kThreads), params, (size_t)p.smem,
                                    (cudaStream_t)stream);
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Threads, shared memory per CTA (static and dynamic) and CTAs resident per
// SM on the current device of the grid kernel (small 0; a k above
// `merge_tail_smem_max_k` puts its sort arrays in global scratch) or of
// the small kernel (small 1), in the rows form (seg_form 0) or the seg form
// (1), at `kk` and `k`; returns a CUDA error code.
extern "C" int merge_tail_occupancy(int seg_form, int small, int kk, int k,
                                    int* threads, int* smem_bytes,
                                    int* ctas_per_sm) {
  const int err = check_args(0, kk, 1, k);
  if (err != 0) return err;
  const bool seg = seg_form != 0;
  // a call of many rows takes the grid kernel, of one row the small one
  Plan p = make_plan(small ? 1 : kSmallRows + 1, kk, 1, k, seg);
  if (small && !p.small) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel_of(p, seg));
  if (e != cudaSuccess) return (int)e;
  *threads = kThreads;
  *smem_bytes = (int)attr.sharedSizeBytes + p.smem;
  return occupancy_of(p, seg, ctas_per_sm, nullptr);
}
