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
// * any other clause is looked up in its whole region [cl_start, cl_start +
//   cl_len) of the store: a lower-bound search over `blk_last` (each row's
//   last doc, 4 bytes a row) finds the one row that can hold the doc, the
//   first whose last doc is >= it, then row_probe.cuh's `probe_row` settles
//   it in that row's 128 docs. The reference runs a fixed number of binary
//   steps, n_iters from `_ITER_LADDER`, chosen so that 2^(n_iters-1) covers
//   the longest region; such a search ends on the exact lower bound, which
//   this search finds directly, so both agree.
// The BM25 sum, the MUST / SHOULD / MUST_NOT counts and the primary-clause
// rule are K3's (`probe_scorer.lane_scores`): clause order, explicitly
// rounded f32 intrinsics under --fmad=false. A lane reports iff it is alive
// (not TERMINATED, its denominator not NaN) and the query is real. The item
// keeps its top-kk reporting lanes by (score desc, lane asc), the order of
// `lax.top_k` on the reference's [W, 128] lane scores, through
// group_topk.cuh.
//
// Precondition (checked where the fused store is built): inside a region
// docs ascend strictly across rows, apart from TERMINATED padding after the
// last doc, and every row holds a doc, so the lower bound over the rows'
// last docs names the only row that can hold the doc.
//
// What bounds it on an H100: the latency of dependent loads, as in K3. A
// region can span 2^20 rows; a binary search over it is 21 dependent loads
// a lane and clause, where this one is 4-ary (3 pivots loaded at once, a
// quarter kept a step): ceil(log4(n + 1)) steps over `blk_last`, whose
// 4-byte entries keep the top steps of all 128 lanes in a few cache lines,
// then 3 steps in the row. The bytes an item must move are its own row and
// the `blk_last` lines and row words its probes touch. Of what the plain
// version spends (tens of small tensor operations per clause, each a kernel
// launch), nothing is left but one launch per chunk. A padding item (qid
// == num_queries) only writes its fill.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_topk.cuh"
#include "row_probe.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kRowWords = 384;  // docs | tfs | bitcast(cachev)
constexpr int kRowCols = 3;     // bid, qid, lcl
constexpr int kTMax = 16;
constexpr int kMust = 0;
constexpr int kShould = 1;
constexpr int kMustNot = 2;

__global__ void __launch_bounds__(kLanes) deep_probe_kernel(
    const int32_t* __restrict__ rows, int n_clauses,
    const float* __restrict__ cl_weight, const int32_t* __restrict__ cl_kind,
    const int32_t* __restrict__ cl_start, const int32_t* __restrict__ cl_len,
    const int32_t* __restrict__ cl_ship, const int32_t* __restrict__ req_must,
    const int32_t* __restrict__ req_should, int num_queries,
    const int32_t* __restrict__ cstore, const int32_t* __restrict__ blk_last,
    long long n_store_rows, int kk, float* __restrict__ out_scores,
    int32_t* __restrict__ out_docs) {
  __shared__ float s_weight[kTMax];
  __shared__ int32_t s_kind[kTMax];
  __shared__ int32_t s_start[kTMax];
  __shared__ int32_t s_len[kTMax];
  __shared__ int32_t s_ship[kTMax];
  __shared__ float c_score[kLanes];
  __shared__ int32_t c_flat[kLanes];
  __shared__ int32_t c_doc[kLanes];
  __shared__ int n_sur;
  __shared__ tantivy_port::TopkScratch s_topk;

  const int g = blockIdx.x;
  const int lane = threadIdx.x;
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
    s_start[lane] = cl_start[q * T + lane];
    s_len[lane] = cl_len[q * T + lane];
    s_ship[lane] = cl_ship[q * T + lane];
  }
  const int32_t* crow = cstore + (long long)bid * kRowWords;
  const int32_t doc = __ldg(crow + lane);
  const int32_t tf_own = __ldg(crow + kLanes + lane);
  const float cachev = __int_as_float(__ldg(crow + 2 * kLanes + lane));
  const bool alive = doc != tantivy_port::kTerminatedDoc && !isnan(cachev);
  __syncthreads();

  float score = 0.0f;
  int cnt_must = 0;
  int cnt_should = 0;
  bool has_not = false;
  int primary = kTMax + 1;
  for (int t = 0; t < T; ++t) {
    bool found = false;
    int32_t tf_probe = 0;
    if (alive && t != lcl) {
      const long long s = s_start[t];
      long long e = s + s_len[t];
      if (e > n_store_rows) e = n_store_rows;
      if (s >= 0 && e > s) {
        const long long row =
            tantivy_port::lower_bound4(blk_last, s, e - s, doc);
        if (row < e) {
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

  const bool ok = alive && lcl <= primary && cnt_must >= req_must[q] &&
                  cnt_should >= req_should[q] && !has_not;
  if (ok) {
    const int slot = atomicAdd(&n_sur, 1);
    c_score[slot] = score;
    c_flat[slot] = lane;
    c_doc[slot] = doc;
  }
  __syncthreads();

  tantivy_port::write_group_topk(c_score, c_flat, c_doc, n_sur, kk, osc,
                                 odoc, s_topk);
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
