// Boolean group-probe scorer with per-group top-kk (kernel K1 of the port).
//
// Replaces the Pallas TPU kernel `_grp_kernel_body` in
// tantivy_tpu/ops/pallas_probe.py (launched by `_grp_rows`). It computes the
// same function; it does not copy the TPU kernel's DMA/VMEM staging.
//
// Work item: one "group" = up to 8 consecutive cstore rows (member rows,
// gated by an 8-bit mask) of one clause region, belonging to one plan row
// (one query on one segment). One CTA of 128 threads serves one group; thread
// `lane` owns lane `lane` of every member row.
//
// Per lane and member row: the lane's doc is probed in every clause t's
// member sub-window, cstore rows [jlo_t + off, jlo_t + off + len) (packed per
// member as (off << 8) | len, len 0 = no probe). Docs ascend inside a clause
// region, so a 7-step binary search per window row is exact. The BM25 score
// is summed in clause order, sum_t w_t * (tf_t / (tf_t + cachev)), with
// explicitly rounded f32 intrinsics, so no FMA contraction and no fast-math
// division can change a bit against the host engine. A lane reports iff it is
// alive, its clause is the primary (lowest present fully-probing) clause,
// the MUST/SHOULD counts are met and no MUST_NOT clause is present.
// The group then keeps its top-kk reporting lanes with score >= row_th[prow],
// ordered by (score desc, flat index r*128 + lane asc).
//
// What bounds it on an H100: memory latency, not bandwidth or arithmetic.
// Each member-row probe is a dependent chain of 7 loads into a 1.5 KB cstore
// row; all 32 threads of a warp read the same row, so the loads are
// broadcasts that mostly hit L1/L2. The design keeps the group's scalar row
// and clause tables in shared memory, launches one CTA per group so that
// thousands of CTAs hide that latency, and compacts survivors into shared
// memory, where an O(n^2) rank count selects the top-kk (survivors are few
// once phase 2 carries a threshold).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_topk.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kMembers = 8;
constexpr int kCand = kLanes * kMembers;
constexpr int kRowWords = 384;  // docs | tfs | bitcast(cachev)
constexpr int kTMax = 16;
constexpr int kMaxStride = 256;
constexpr int kMust = 0;
constexpr int kShould = 1;
constexpr int kMustNot = 2;

// Adds the tf of `doc` to *tf and returns true when `doc` is in the 128
// ascending doc ids of one cstore row.
__device__ __forceinline__ bool probe_row(const int32_t* __restrict__ row,
                                          int32_t doc, int32_t* tf) {
  int lo = 0;
  int hi = kLanes;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < doc) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo < kLanes && __ldg(row + lo) == doc) {
    *tf += __ldg(row + kLanes + lo);
    return true;
  }
  return false;
}

__global__ void __launch_bounds__(kLanes) group_probe_kernel(
    const int32_t* __restrict__ rows, int stride, int n_clauses,
    const float* __restrict__ cl_weight, const int32_t* __restrict__ cl_kind,
    const int32_t* __restrict__ cl_ship, const int32_t* __restrict__ req_must,
    const int32_t* __restrict__ req_should,
    const float* __restrict__ row_th, int num_prows,
    const int32_t* __restrict__ cstore, long long n_store_rows, int kk,
    float* __restrict__ out_scores, int32_t* __restrict__ out_docs) {
  __shared__ int32_t s_row[kMaxStride];
  __shared__ float s_weight[kTMax];
  __shared__ int32_t s_kind[kTMax];
  __shared__ int32_t s_ship[kTMax];
  __shared__ float c_score[kCand];
  __shared__ int32_t c_flat[kCand];
  __shared__ int32_t c_doc[kCand];
  __shared__ int n_sur;

  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int T = n_clauses;
  const int32_t* grow = rows + (long long)g * stride;
  for (int i = lane; i < stride; i += kLanes) s_row[i] = grow[i];
  if (lane == 0) n_sur = 0;
  __syncthreads();

  const int32_t row_base = s_row[0];
  const int32_t prow = s_row[1];
  const int32_t lcl = s_row[2];
  const int32_t mask = s_row[3];
  // fully-masked groups are padding; rows past num_prows report nothing
  const bool live = mask != 0 && prow >= 0 && prow < num_prows;
  if (live && lane < T) {
    s_weight[lane] = cl_weight[prow * T + lane];
    s_kind[lane] = cl_kind[prow * T + lane];
    s_ship[lane] = cl_ship[prow * T + lane];
  }
  __syncthreads();

  if (live) {
    const int32_t need_must = req_must[prow];
    const int32_t need_should = req_should[prow];
    const float th = row_th[prow];
    for (int r = 0; r < kMembers; ++r) {
      if (((mask >> r) & 1) == 0) continue;
      const long long lrow = (long long)row_base + r;
      if (lrow < 0 || lrow >= n_store_rows) continue;
      const int32_t* crow = cstore + lrow * kRowWords;
      const int32_t doc = crow[lane];
      const int32_t tf_own = crow[kLanes + lane];
      const float cachev = __int_as_float(crow[2 * kLanes + lane]);
      if (doc == tantivy_port::kTerminatedDoc || isnan(cachev)) continue;

      float score = 0.0f;
      int cnt_must = 0;
      int cnt_should = 0;
      bool has_not = false;
      int primary = kTMax + 1;
      for (int t = 0; t < T; ++t) {
        const int32_t packed = s_row[4 + T + kMembers * t + r];
        const int32_t off = packed >> 8;
        const int32_t len = packed & 255;
        const int32_t jlo = s_row[4 + t];
        bool found = false;
        int32_t tf_probe = 0;
        if (len > 0 && jlo >= 0) {
          for (int i = 0; i < len; ++i) {
            const long long j = (long long)jlo + off + i;
            if (j >= n_store_rows) break;
            found |= probe_row(cstore + j * kRowWords, doc, &tf_probe);
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
      const bool ok = lcl <= primary && cnt_must >= need_must &&
                      cnt_should >= need_should && !has_not;
      if (ok && score >= th && score != -INFINITY) {
        const int slot = atomicAdd(&n_sur, 1);
        c_score[slot] = score;
        c_flat[slot] = r * kLanes + lane;
        c_doc[slot] = doc;
      }
    }
  }
  __syncthreads();

  tantivy_port::write_group_topk(c_score, c_flat, c_doc, n_sur, kk,
                                 out_scores + (long long)g * kk,
                                 out_docs + (long long)g * kk);
}

}  // namespace

extern "C" int group_probe_launch(
    const void* rows, int n_groups, int stride, int n_clauses,
    const void* cl_weight, const void* cl_kind, const void* cl_ship,
    const void* req_must, const void* req_should, const void* row_th,
    int num_prows, const void* cstore, long long n_store_rows, int kk,
    void* out_scores, void* out_docs, void* stream) {
  if (n_clauses < 1 || n_clauses > kTMax || stride > kMaxStride ||
      stride < 4 + (1 + kMembers) * n_clauses || kk < 1 || kk > kLanes) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_groups > 0) {
    group_probe_kernel<<<n_groups, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rows, stride, n_clauses, (const float*)cl_weight,
        (const int32_t*)cl_kind, (const int32_t*)cl_ship,
        (const int32_t*)req_must, (const int32_t*)req_should,
        (const float*)row_th, num_prows, (const int32_t*)cstore,
        n_store_rows, kk, (float*)out_scores, (int32_t*)out_docs);
  }
  return (int)cudaGetLastError();
}
