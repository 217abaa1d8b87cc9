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
// member as (off << 8) | len, len 0 = no probe). The BM25 score is summed in
// clause order, sum_t w_t * (tf_t / (tf_t + cachev)), by one thread, with
// explicitly rounded f32 intrinsics, so no FMA contraction and no fast-math
// division can change a bit against the host engine. A lane reports iff it
// is alive, its clause is the primary (lowest present fully-probing) clause,
// the MUST/SHOULD counts are met and no MUST_NOT clause is present. The group
// then keeps its top-kk reporting lanes with score >= row_th[prow], ordered by
// (score desc, flat index r*128 + lane asc), through the radix select of
// group_topk.cuh.
//
// Precondition (checked where the fused store is built): the host clips
// every member sub-window to its clause's term region, and inside a region
// docs ascend strictly across rows, apart from TERMINATED padding after the
// last doc. So a lane's doc can lie in at most one sub-window row, which
// the probe of row_probe.cuh finds; its tf is the sum the TPU kernel's
// equality compares take.
//
// What bounds it on an H100: the latency of dependent loads. The first
// port of this kernel searched every sub-window row in turn with a binary
// search, 8 loads each waiting on the one before, and ranked up to 1,024
// survivors against each other; the 12 CTAs resident on an SM did not hide
// those chains. This design keeps one lane a thread, as half of all groups
// have a single live member (spreading the 1,024 (member, lane) slots over
// more threads leaves most of them idle), and cuts the chains instead: each
// probe takes row_probe.cuh's 4-ary searches, over the sub-window rows'
// first docs, then in the one row found: 3 + ceil(log4(len)) dependent
// steps instead of 8 * len. The top-kk is group_topk.cuh's. A fully masked
// group (launch padding) only writes its fill. Designs that staged the
// member rows and the sub-windows in shared memory with cp.async, or
// interleaved the probes of 2-4 members or clauses, measured slower on the
// card (PERF.md, Findings): they cost registers or barriers, and so CTAs.
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
constexpr int kMembers = 8;
constexpr int kCand = kLanes * kMembers;
constexpr int kRowWords = 384;  // docs | tfs | bitcast(cachev)
constexpr int kTMax = 16;
constexpr int kMaxStride = 256;
constexpr int kMust = 0;
constexpr int kShould = 1;
constexpr int kMustNot = 2;

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

  const int32_t row_base = s_row[0];
  const int32_t prow = s_row[1];
  const int32_t lcl = s_row[2];
  // fully-masked groups are padding; rows past num_prows report nothing
  if (!(s_row[3] != 0 && prow >= 0 && prow < num_prows)) {
    for (int j = lane; j < kk; j += kLanes) {
      osc[j] = -INFINITY;
      odoc[j] = tantivy_port::kTerminatedDoc;
    }
    return;
  }
  if (lane < T) {
    s_weight[lane] = cl_weight[prow * T + lane];
    s_kind[lane] = cl_kind[prow * T + lane];
    s_ship[lane] = cl_ship[prow * T + lane];
  }
  const int32_t need_must = req_must[prow];
  const int32_t need_should = req_should[prow];
  const float th = row_th[prow];
  __syncthreads();

  for (int r = 0; r < kMembers; ++r) {
    const long long lrow = (long long)row_base + r;
    if (((s_row[3] >> r) & 1) == 0 || lrow < 0 || lrow >= n_store_rows) {
      continue;
    }
    const int32_t* crow = cstore + lrow * kRowWords;
    const int32_t doc = __ldg(crow + lane);
    const int32_t tf_own = __ldg(crow + kLanes + lane);
    const float cachev = __int_as_float(__ldg(crow + 2 * kLanes + lane));
    if (doc == tantivy_port::kTerminatedDoc || isnan(cachev)) continue;

    float score = 0.0f;
    int cnt_must = 0;
    int cnt_should = 0;
    bool has_not = false;
    int primary = kTMax + 1;
    for (int t = 0; t < T; ++t) {
      // the member's sub-window, cut at the store's end; the own clause is
      // present by construction: no probe
      const int32_t jlo = s_row[4 + t];
      const int32_t packed = s_row[4 + T + kMembers * t + r];
      const int len = packed & 255;
      const long long lo = (long long)jlo + (packed >> 8);
      bool found = false;
      int32_t tf_probe = 0;
      if (t != lcl && jlo >= 0 && len > 0 && lo < n_store_rows) {
        const long long hi = lo + len;
        found = tantivy_port::probe_window(
            cstore, (int)lo, (int)(hi < n_store_rows ? hi : n_store_rows), doc,
            &tf_probe);
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
  __syncthreads();

  tantivy_port::write_group_topk(c_score, c_flat, c_doc, n_sur, kk, osc,
                                 odoc, s_topk);
}

}  // namespace

extern "C" int group_probe_launch(
    const void* rows, int n_groups, int stride, int n_clauses,
    const void* cl_weight, const void* cl_kind, const void* cl_ship,
    const void* req_must, const void* req_should, const void* row_th,
    int num_prows, const void* cstore, long long n_store_rows, int kk,
    void* out_scores, void* out_docs, void* stream) {
  if (n_clauses < 1 || n_clauses > kTMax || stride > kMaxStride ||
      stride < 4 + (1 + kMembers) * n_clauses || kk < 1 || kk > kLanes ||
      n_store_rows > 0x7fffffffLL || ((uintptr_t)cstore & 15) != 0) {
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

// Threads, static shared memory per CTA and CTAs resident per SM of the
// kernel on the current device; returns a CUDA error code.
extern "C" int group_probe_occupancy(int* threads, int* smem_bytes,
                                     int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, group_probe_kernel);
  if (err != cudaSuccess) return (int)err;
  *threads = kLanes;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, group_probe_kernel, kLanes, 0);
}
