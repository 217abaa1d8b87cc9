// Deep per-lane boolean probe with per-item top-kk (kernel K4 of the port).
//
// Replaces the reference's XLA program `probe_bool_topk`
// (tantivy_tpu/ops/probe_scorer.py:398), the per-segment Block-WAND path's
// scorer for work items whose clause windows are wider than the windowed
// probe's widest rung (K3, kw = 64). It computes the same lane scores and
// the same per-item top-kk; it does not copy the reference's fixed-depth
// binary searches over every lane at once.
//
// Work item: one cstore row (128 lanes of one clause's posting block) of one
// query, given as one int32 row of `rows` [W, 3]: 0=bid, 1=qid, 2=lcl (the
// item's own clause). One CTA of 128 threads serves one item; thread `lane`
// owns lane `lane`.
//
// Per lane and clause t:
// * the own clause (t == lcl) is present with the lane's own tf: no probe;
// * any other clause is looked up in its region [cl_start, cl_start +
//   cl_len) of the store: the one row that can hold the doc is the first
//   whose last doc (`blk_last`) is >= it, and row_probe.cuh's `probe_row`
//   settles it in that row's 128 docs. The reference runs a fixed number of
//   binary steps, n_iters from `_ITER_LADDER`, chosen so that 2^(n_iters-1)
//   covers the longest region; such a search ends on the exact lower bound,
//   which this kernel finds directly, so both agree.
// The BM25 sum, the MUST / SHOULD / MUST_NOT counts and the primary-clause
// rule are K3's (`probe_scorer.lane_scores`): clause order, explicitly
// rounded f32 intrinsics under --fmad=false. A lane reports iff it is alive
// (not TERMINATED, its denominator not NaN) and the query is real. The item
// keeps its top-kk reporting lanes by (score desc, lane asc), the order of
// `lax.top_k` on the reference's [W, 128] lane scores, through
// group_topk.cuh.
//
// What bounds it on an H100: the latency of dependent loads. A region can
// span 2^20 rows, ten steps of a 4-ary search a lane and clause. But the
// item's live docs ascend, so every live lane's row in clause t lies in
// [a_t, b_t): a_t the lower bound of the first live doc, b_t one past that
// of the last live doc, cut to the region. Both bounds of every clause are
// found first, each by one warp at once (`warp_lower_bound`: 32 pivots a
// step, one ballot; the searches spread over the CTA's four warps). The
// clauses whose ranges fit, in clause order, into kLastCap rows get their
// `blk_last` words copied into shared memory in one round of cp.async
// copies, and their lanes search there; a wider range is searched in device
// memory, but only over [a_t, b_t). Then each lane probes one row in device
// memory. The bytes an item must move are its own row and, for each live
// lane and other clause, the sector of the row that holds its doc (and on a
// hit its tf sector); the smoke counts exactly these (`deep_probe_bytes`).
// A padding item (qid == num_queries) only writes its fill.
//
// Precondition (checked where the fused store is built): inside a region
// docs ascend strictly across rows, apart from TERMINATED padding after the
// last doc, and every row holds a doc, so the lower bound over the rows'
// last docs names the only row that can hold the doc.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_topk.cuh"
#include "row_probe.cuh"
#include "stage.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
constexpr int kRowWords = 384;  // docs | tfs | bitcast(cachev)
constexpr int kRowCols = 3;     // bid, qid, lcl
constexpr int kTMax = 16;
constexpr int kMust = 0;
constexpr int kShould = 1;
constexpr int kMustNot = 2;
// `blk_last` words a CTA stages (8 KB)
constexpr int kLastCap = 2048;

// what the top-kk needs, once the staged words are done with
struct Tail {
  float c_score[kLanes];
  int32_t c_flat[kLanes];
  int32_t c_doc[kLanes];
  tantivy_port::TopkScratch topk;
};

union Scratch {
  int32_t last[kLastCap];
  Tail tail;
};

__global__ void __launch_bounds__(kLanes) deep_probe_kernel(
    const int32_t* __restrict__ rows, int n_clauses,
    const float* __restrict__ cl_weight, const int32_t* __restrict__ cl_kind,
    const int32_t* __restrict__ cl_start, const int32_t* __restrict__ cl_len,
    const int32_t* __restrict__ cl_ship, const int32_t* __restrict__ req_must,
    const int32_t* __restrict__ req_should, int num_queries,
    const int32_t* __restrict__ cstore, const int32_t* __restrict__ blk_last,
    long long n_store_rows, int kk, float* __restrict__ out_scores,
    int32_t* __restrict__ out_docs) {
  __shared__ Scratch sm;
  __shared__ float s_weight[kTMax];
  __shared__ int32_t s_kind[kTMax];
  __shared__ int32_t s_ship[kTMax];
  __shared__ long long s_lb[kTMax][2];  // lower bounds of first, last doc
  __shared__ int32_t s_a[kTMax];        // each clause's range [a, a + m)
  __shared__ int32_t s_m[kTMax];
  __shared__ int32_t s_off[kTMax];  // its staged words' start, or -1
  __shared__ unsigned s_live[kWarps];
  __shared__ int n_sur;

  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const int T = n_clauses;
  float* osc = out_scores + (long long)g * kk;
  int32_t* odoc = out_docs + (long long)g * kk;
  const int32_t bid = __ldg(rows + (long long)g * kRowCols);
  const int32_t q = __ldg(rows + (long long)g * kRowCols + 1);
  const int32_t lcl = __ldg(rows + (long long)g * kRowCols + 2);
  // padding items (qid == num_queries) report nothing
  if (!(q >= 0 && q < num_queries && bid >= 0 && bid < n_store_rows)) {
    for (int j = lane; j < kk; j += kLanes) {
      osc[j] = -INFINITY;
      odoc[j] = tantivy_port::kTerminatedDoc;
    }
    return;
  }
  if (lane == 0) n_sur = 0;
  if (lane < T) {
    s_weight[lane] = cl_weight[q * T + lane];
    s_kind[lane] = cl_kind[q * T + lane];
    s_ship[lane] = cl_ship[q * T + lane];
  }
  const int32_t* crow = cstore + (long long)bid * kRowWords;
  const int32_t doc = __ldg(crow + lane);
  const int32_t tf_own = __ldg(crow + kLanes + lane);
  const float cachev = __int_as_float(__ldg(crow + 2 * kLanes + lane));
  const bool alive = doc != tantivy_port::kTerminatedDoc && !isnan(cachev);
  const unsigned live_bits = __ballot_sync(0xffffffffu, alive);
  if (wl == 0) s_live[warp] = live_bits;
  __syncthreads();

  // the first and last live lanes: their docs bound every probed doc
  int first = -1, last = -1;
  for (int w = 0; w < kWarps; ++w) {
    const unsigned b = s_live[w];
    if (b != 0u) {
      if (first < 0) first = 32 * w + __ffs(b) - 1;
      last = 32 * w + 31 - __clz(b);
    }
  }
  if (first >= 0) {
    // per probed clause: the lower bounds of the first and last live docs
    for (int i = warp; i < 2 * T; i += kWarps) {
      const int t = i >> 1;
      const long long s = cl_start[q * T + t];
      const long long n = cl_len[q * T + t];
      const long long e = s + n < n_store_rows ? s + n : n_store_rows;
      if (t != lcl && s >= 0 && e > s) {
        const long long lb = tantivy_port::warp_lower_bound(
            blk_last, s, e - s, __ldg(crow + ((i & 1) ? last : first)));
        if (wl == 0) s_lb[t][i & 1] = lb;
      }
    }
    __syncthreads();

    // each clause's range, and the ranges staged in clause order
    if (lane == 0) {
      int used = 0;
      for (int t = 0; t < T; ++t) {
        const long long s = cl_start[q * T + t];
        const long long n = cl_len[q * T + t];
        const long long e = s + n < n_store_rows ? s + n : n_store_rows;
        long long a = 0, b = 0;
        if (t != lcl && s >= 0 && e > s) {
          a = s_lb[t][0];
          b = s_lb[t][1] + 1 < e ? s_lb[t][1] + 1 : e;
        }
        const int m = b > a ? (int)(b - a) : 0;
        int off = -1;
        if (m > 0 && used + m <= kLastCap) {
          off = used;
          used += m;
        }
        s_a[t] = (int32_t)a;
        s_m[t] = m;
        s_off[t] = off;
      }
    }
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      const int off = s_off[t];
      if (off >= 0) {
        const int a = s_a[t];
        const int m = s_m[t];
        for (int i = lane; i < m; i += kLanes) {
          tantivy_port::cp_async4(&sm.last[off + i], blk_last + a + i);
        }
      }
    }
    tantivy_port::cp_async_commit_wait_all();
    __syncthreads();
  }

  float score = 0.0f;
  int cnt_must = 0;
  int cnt_should = 0;
  bool has_not = false;
  int primary = kTMax + 1;
  for (int t = 0; t < T; ++t) {
    bool found = false;
    int32_t tf_probe = 0;
    if (alive && t != lcl) {
      const int a = s_a[t];
      const int m = s_m[t];
      const int off = s_off[t];
      if (m > 0) {
        const long long row =
            off >= 0
                ? a + tantivy_port::lower_bound_shared(sm.last + off, m, doc)
                : tantivy_port::lower_bound4(blk_last, a, m, doc);
        if (row < a + m) {
          found = tantivy_port::probe_row(cstore + row * kRowWords, doc,
                                          &tf_probe);
        }
      }
    }

    const bool own = lcl == t;
    const bool present = found || own;
    const float tf = (float)(own ? tf_own : tf_probe);
    const int kind = s_kind[t];
    const float contrib =
        __fmul_rn(s_weight[t], __fdiv_rn(tf, __fadd_rn(tf, cachev)));
    const bool positive = present && (kind == kMust || kind == kShould);
    score = __fadd_rn(score, positive ? contrib : 0.0f);
    cnt_must += (present && kind == kMust) ? 1 : 0;
    cnt_should += (present && kind == kShould) ? 1 : 0;
    has_not = has_not || (present && kind == kMustNot);
    if (present && s_ship[t] > 0 && primary > kTMax) primary = t;
  }
  // the staged words are read: the tail may take their place
  __syncthreads();

  const bool ok = alive && lcl <= primary && cnt_must >= req_must[q] &&
                  cnt_should >= req_should[q] && !has_not;
  if (ok) {
    const int slot = atomicAdd(&n_sur, 1);
    sm.tail.c_score[slot] = score;
    sm.tail.c_flat[slot] = lane;
    sm.tail.c_doc[slot] = doc;
  }
  __syncthreads();

  tantivy_port::write_group_topk(sm.tail.c_score, sm.tail.c_flat,
                                 sm.tail.c_doc, n_sur, kk, osc, odoc,
                                 sm.tail.topk);
}

}  // namespace

extern "C" int deep_probe_launch(
    const void* rows, int n_items, int n_clauses, const void* cl_weight,
    const void* cl_kind, const void* cl_start, const void* cl_len,
    const void* cl_ship, const void* req_must, const void* req_should,
    int num_queries, const void* cstore, const void* blk_last,
    long long n_store_rows, int kk, void* out_scores, void* out_docs,
    void* stream) {
  if (n_clauses < 1 || n_clauses > kTMax || kk < 1 || kk > kLanes ||
      n_items < 0 || n_store_rows > 0x7fffffffLL ||
      ((uintptr_t)cstore & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_items > 0) {
    deep_probe_kernel<<<n_items, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rows, n_clauses, (const float*)cl_weight,
        (const int32_t*)cl_kind, (const int32_t*)cl_start,
        (const int32_t*)cl_len, (const int32_t*)cl_ship,
        (const int32_t*)req_must, (const int32_t*)req_should, num_queries,
        (const int32_t*)cstore, (const int32_t*)blk_last, n_store_rows, kk,
        (float*)out_scores, (int32_t*)out_docs);
  }
  return (int)cudaGetLastError();
}

// Threads, static shared memory per CTA and CTAs resident per SM of the
// kernel on the current device; returns a CUDA error code.
extern "C" int deep_probe_occupancy(int* threads, int* smem_bytes,
                                    int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, deep_probe_kernel);
  if (err != cudaSuccess) return (int)err;
  *threads = kLanes;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, deep_probe_kernel, kLanes, 0);
}
