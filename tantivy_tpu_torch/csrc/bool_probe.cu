// Windowed single-row boolean probe with per-row top-kk (kernel K3 of the
// port).
//
// Replaces the Pallas TPU kernel `_bool_kernel_body` in
// tantivy_tpu/ops/pallas_probe.py (launched by `_probe_rows`, wrapped by
// `pallas_bool_topk`). It computes the same lane scores; it does not copy the
// TPU kernel's dense [128, RW*128] equality sums.
//
// Work item: one cstore row (128 lanes of one clause's posting block) of one
// query. One CTA of 128 threads serves one item; thread `lane` owns lane
// `lane`. Item scalars (row of `rows`): 0=bid, 1=qid, 2=lcl (the item's own
// clause), 3+t=jlo_t (window start, -1 = no probe), 3+T+t=wid_t.
//
// Per lane and clause t, the lane's doc is probed in the cstore rows of the
// window that lie inside the clause region [cl_start, cl_start + cl_len):
// * narrow rungs (kw <= 8): rows [jlo, jlo + max(kw, 2));
// * the wide rung: rows [jlo, jlo + used8), used8 = min(s + n - jlo, wid)
//   clamped to [0, kw8] and rounded up to 8, as the TPU kernel's 8-row
//   chunk loop probes them.
// The lane's own clause is present by construction with its own tf. The
// BM25 score is summed in clause order, sum_t w_t * (tf_t / (tf_t +
// cachev)), with explicitly rounded f32 intrinsics (and --fmad=false), so no
// FMA contraction or fast-math division changes a bit. A lane reports iff
// it is alive, qid < num_queries, its clause is <= the primary (lowest
// present fully-probing) clause, the MUST/SHOULD counts are met and no
// MUST_NOT clause is present. The row then keeps its top-kk reporting lanes
// ordered by (score desc, lane asc), the order of `lax.top_k` on the TPU
// kernel's raw [W, 128] output, through the radix select of group_topk.cuh.
//
// Precondition (checked where the fused store is built): inside a clause
// region docs ascend strictly across rows, apart from TERMINATED padding
// after the last doc, and every row holds a doc. The window is clipped to
// the region, so a lane's doc can lie in at most one window row; the
// probe of row_probe.cuh finds it.
//
// What bounds it on an H100: the latency of dependent loads. The first
// port of this kernel searched every window row in turn, a binary search
// of 8 dependent loads each: up to 72 rows, about 580 dependent loads per
// clause and lane on the wide rung, and the CTAs resident on an SM did not
// hide those chains. This design probes each clause's window with
// row_probe.cuh's 4-ary searches, a fence search over the window rows'
// first docs, then one search in the row found: 3 + ceil(log4(rows))
// dependent steps, 6 on the widest window. A design that staged each
// window (or its fences) in shared memory first measured slower (PERF.md,
// Findings): the copies and the barrier cost more than the loads they
// save. A padding item (qid == num_queries) only writes its fill.
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
constexpr int kTMax = 16;
constexpr int kMaxStride = 64;
constexpr int kMust = 0;
constexpr int kShould = 1;
constexpr int kMustNot = 2;

__global__ void __launch_bounds__(kLanes) bool_probe_kernel(
    const int32_t* __restrict__ rows, int stride, int n_clauses, int kw,
    const float* __restrict__ cl_weight, const int32_t* __restrict__ cl_kind,
    const int32_t* __restrict__ cl_start, const int32_t* __restrict__ cl_len,
    const int32_t* __restrict__ cl_ship, const int32_t* __restrict__ req_must,
    const int32_t* __restrict__ req_should, int num_queries,
    const int32_t* __restrict__ cstore, long long n_store_rows, int kk,
    float* __restrict__ out_scores, int32_t* __restrict__ out_docs) {
  __shared__ int32_t s_row[kMaxStride];
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
  const int32_t* grow = rows + (long long)g * stride;
  for (int i = lane; i < stride; i += kLanes) s_row[i] = grow[i];
  if (lane == 0) n_sur = 0;
  __syncthreads();

  const int32_t bid = s_row[0];
  const int32_t q = s_row[1];
  const int32_t lcl = s_row[2];
  // padding items (qid == num_queries) report nothing
  if (!(q >= 0 && q < num_queries && bid >= 0 && bid < n_store_rows)) {
    for (int j = lane; j < kk; j += kLanes) {
      osc[j] = -INFINITY;
      odoc[j] = tantivy_port::kTerminatedDoc;
    }
    return;
  }
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

  const int kw8 = ((kw + 7) & ~7) + (kw > 8 ? 8 : 0);
  float score = 0.0f;
  int cnt_must = 0;
  int cnt_should = 0;
  bool has_not = false;
  int primary = kTMax + 1;
  for (int t = 0; t < T; ++t) {
    // the window rows inside the clause region and the store; the own
    // clause is present by construction: no probe
    const long long j = s_row[3 + t];
    bool found = false;
    int32_t tf_probe = 0;
    if (alive && t != lcl && j >= 0) {
      const long long s = s_start[t];
      const long long e = s + s_len[t];
      long long r1;
      if (kw <= 8) {
        r1 = j + (kw >= 2 ? kw : 2);
      } else {
        long long used = e - j;
        const long long wid = s_row[3 + T + t];
        if (wid < used) used = wid;
        if (used < 0) used = 0;
        if (used > kw8) used = kw8;
        r1 = j + ((used + 7) & ~7LL);
      }
      const long long r0 = j > s ? j : s;
      if (r1 > e) r1 = e;
      if (r1 > n_store_rows) r1 = n_store_rows;
      if (r1 > r0) {
        found = tantivy_port::probe_window(cstore, (int)r0, (int)r1, doc,
                                           &tf_probe);
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

extern "C" int bool_probe_launch(
    const void* rows, int n_items, int stride, int n_clauses, int kw,
    const void* cl_weight, const void* cl_kind, const void* cl_start,
    const void* cl_len, const void* cl_ship, const void* req_must,
    const void* req_should, int num_queries, const void* cstore,
    long long n_store_rows, int kk, void* out_scores, void* out_docs,
    void* stream) {
  if (n_clauses < 1 || n_clauses > kTMax || stride > kMaxStride ||
      stride < 3 + 2 * n_clauses || kw < 1 || kk < 1 || kk > kLanes ||
      n_store_rows > 0x7fffffffLL || ((uintptr_t)cstore & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_items > 0) {
    bool_probe_kernel<<<n_items, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rows, stride, n_clauses, kw, (const float*)cl_weight,
        (const int32_t*)cl_kind, (const int32_t*)cl_start,
        (const int32_t*)cl_len, (const int32_t*)cl_ship,
        (const int32_t*)req_must, (const int32_t*)req_should, num_queries,
        (const int32_t*)cstore, n_store_rows, kk, (float*)out_scores,
        (int32_t*)out_docs);
  }
  return (int)cudaGetLastError();
}

// Threads, static shared memory per CTA and CTAs resident per SM of the
// kernel on the current device; returns a CUDA error code.
extern "C" int bool_probe_occupancy(int* threads, int* smem_bytes,
                                    int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, bool_probe_kernel);
  if (err != cudaSuccess) return (int)err;
  *threads = kLanes;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, bool_probe_kernel, kLanes, 0);
}
