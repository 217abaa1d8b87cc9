// Per-segment phrase (slop 0) probe with per-item top-kk (kernel K6 of the
// port).
//
// Replaces the reference's XLA program `probe_phrase_topk`
// (tantivy_tpu/ops/phrase_scorer.py:71), the scorer of the per-segment
// Block-WAND phrase path. It computes the same lane scores and the same
// per-item top-kk; it does not build the reference's gathered [W, kw * 128]
// doc windows nor its [W, 128, pw] position windows.
//
// Work item: one cstore row (128 lanes of the phrase's leader term, its
// rarest) of one query, given as one int32 row of `rows` [W, 3]: 0=bid,
// 1=qid, 2=the leader's term index. One CTA of 128 threads serves one item;
// thread `lane` owns lane `lane`.
//
// Per item, thread t < T finds term t's probe window, as the reference's
// `probe_term_window` does: its first row is the lower bound of the item's
// first doc among the region's row last docs (`lower_bound4` over
// `blk_last`, the exact bound the reference's fixed-depth binary search
// reaches), and it spans kw rows, cut to the region. No host table of window
// starts is needed.
//
// Per live lane (doc not TERMINATED, BM25 denominator `cachev` not NaN) and
// term, in term order until a term misses:
// * `probe_window_at` (row_probe.cuh) finds the doc in the window and gives
//   its tf, row and lane;
// * the doc's first position is the row's `blk_pos` entry plus the tfs of
//   the row's earlier lanes (16-byte loads, independent of each other), the
//   index the reference reads from its per-lane `pos_cum`.
// Then the count: for each of the leader's first min(tf, MAX_P) positions
// p (MAX_P = 16 <= pw), every other term t must hold p + shift_leader -
// shift_t among its first min(tf_t, pw) positions. Both lists ascend, so
// one forward cursor per term serves all the leader's positions: a term's
// positions are read once, and a term that leaves no position matching
// ends the count. The reference compares every pair in its windows; the
// matches are the same. Score: q_weight * (count / (count + cachev)) with
// explicitly rounded f32 intrinsics under --fmad=false; a lane reports iff
// every term holds its doc and count > 0. The item keeps its top-kk
// reporting lanes by (score desc, lane asc), the order of `lax.top_k`,
// through group_topk.cuh.
//
// Preconditions (checked where the fused store is built): inside a region
// docs ascend strictly across rows, apart from TERMINATED padding after the
// last doc, and every row holds a doc; inside a doc a term's positions
// ascend, and every position is below 2^31 - 8, so that int32 compares keep
// their order. Position reads are clamped to the store, as the reference
// clamps its window gathers.
//
// What bounds it on an H100: the latency of dependent loads, as in K3 and
// K4. Per item and term one 4-ary search over `blk_last`; per lane and term
// ceil(log4(kw)) fence steps and 3 row steps, then the position reads, whose
// cursor loop waits on each load. The bytes an item must move are its own
// row's docs and denominators and the sectors its probes and position reads
// touch. Of what the plain version spends (the gathered windows, tens of
// tensor operations per term), nothing is left but one launch per chunk. A
// padding item (qid == num_queries) only writes its fill.
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
constexpr int kPosRowWords = 256;  // positions | owners
constexpr int kRowCols = 3;     // bid, qid, leader term
constexpr int kTMax = 8;
constexpr int kMaxP = 16;

// Position `idx` of the flat position store (clamped to it).
__device__ __forceinline__ int32_t load_pos(const int32_t* __restrict__ pos,
                                            long long n_pos, long long idx) {
  idx = idx < 0 ? 0 : (idx >= n_pos ? n_pos - 1 : idx);
  return __ldg(pos + (idx >> 7) * kPosRowWords + (idx & 127));
}

__global__ void __launch_bounds__(kLanes) seg_phrase_kernel(
    const int32_t* __restrict__ rows, int n_terms,
    const float* __restrict__ q_weight, const int32_t* __restrict__ cl_start,
    const int32_t* __restrict__ cl_len, const int32_t* __restrict__ cl_shift,
    int num_queries, const int32_t* __restrict__ cstore,
    const int32_t* __restrict__ blk_last, long long n_store_rows,
    const int32_t* __restrict__ postore, long long n_pos,
    const int32_t* __restrict__ blk_pos, int kw, int pw, int kk,
    float* __restrict__ out_scores, int32_t* __restrict__ out_docs) {
  __shared__ int32_t s_lo[kTMax];     // window rows [s_lo, s_hi)
  __shared__ int32_t s_hi[kTMax];
  __shared__ int32_t s_shift[kTMax];
  __shared__ int32_t s_tf[kTMax][kLanes];
  __shared__ int32_t s_pb[kTMax][kLanes];  // first position's index
  __shared__ float c_score[kLanes];
  __shared__ int32_t c_flat[kLanes];
  __shared__ int32_t c_doc[kLanes];
  __shared__ int n_sur;
  __shared__ tantivy_port::TopkScratch s_topk;

  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int T = n_terms;
  float* osc = out_scores + (long long)g * kk;
  int32_t* odoc = out_docs + (long long)g * kk;
  const int32_t bid = __ldg(rows + (long long)g * kRowCols);
  const int32_t q = __ldg(rows + (long long)g * kRowCols + 1);
  int lead = __ldg(rows + (long long)g * kRowCols + 2);
  lead = lead < 0 ? 0 : (lead >= T ? T - 1 : lead);
  // padding items (qid == num_queries) report nothing
  if (!(q >= 0 && q < num_queries && bid >= 0 && bid < n_store_rows)) {
    for (int j = lane; j < kk; j += kLanes) {
      osc[j] = -INFINITY;
      odoc[j] = tantivy_port::kTerminatedDoc;
    }
    return;
  }
  const int32_t* crow = cstore + (long long)bid * kRowWords;
  if (lane == 0) n_sur = 0;
  if (lane < T) {
    const long long s = cl_start[q * T + lane];
    const long long n = cl_len[q * T + lane];
    long long e = s + n;
    if (e > n_store_rows) e = n_store_rows;
    long long lo = s, hi = s;  // an empty window misses every doc
    if (n > 0 && s >= 0 && e > s) {
      lo = tantivy_port::lower_bound4(blk_last, s, e - s, __ldg(crow));
      hi = lo + kw < e ? lo + kw : e;
    }
    s_lo[lane] = (int32_t)lo;
    s_hi[lane] = (int32_t)hi;
    s_shift[lane] = cl_shift[q * T + lane];
  }
  const int32_t doc = __ldg(crow + lane);
  const float cachev = __int_as_float(__ldg(crow + 2 * kLanes + lane));
  __syncthreads();

  // every term's (tf, first position) for the lane's doc
  bool ok = doc != tantivy_port::kTerminatedDoc && !isnan(cachev);
  for (int t = 0; t < T && ok; ++t) {
    const int a = s_lo[t];
    const int b = s_hi[t];
    int32_t tf = 0;
    int row = 0, at = 0;
    ok = b > a && tantivy_port::probe_window_at(cstore, a, b, doc, &tf, &row,
                                                &at);
    if (ok) {
      const int32_t* rtf = cstore + (long long)row * kRowWords + kLanes;
      const int4* r4 = reinterpret_cast<const int4*>(rtf);
      int32_t sum = 0;
      int i = 0;
      for (; i + 4 <= at; i += 4) {
        const int4 v = __ldg(r4 + (i >> 2));
        sum += v.x + v.y + v.z + v.w;
      }
      for (; i < at; ++i) sum += __ldg(rtf + i);
      s_tf[t][lane] = tf;
      s_pb[t][lane] = __ldg(blk_pos + row) + sum;
    }
  }

  // aligned matches of the leader's first min(tf, MAX_P) positions
  int count = 0;
  if (ok) {
    const int jmax = min(s_tf[lead][lane], kMaxP);
    const long long pl = s_pb[lead][lane];
    int32_t lp[kMaxP];
#pragma unroll
    for (int j = 0; j < kMaxP; ++j) {
      lp[j] = j < jmax ? load_pos(postore, n_pos, pl + j) : 0;
    }
    unsigned mask = jmax > 0 ? (1u << jmax) - 1u : 0u;
    const int32_t shl = s_shift[lead];
    for (int t = 0; t < T && mask != 0u; ++t) {
      if (t == lead) continue;
      const int lim = min(s_tf[t][lane], pw);
      const long long pt = s_pb[t][lane];
      const int32_t d = shl - s_shift[t];
      int c = 0;
      int32_t cur = lim > 0 ? load_pos(postore, n_pos, pt) : 0;
      unsigned m = 0u;
#pragma unroll
      for (int j = 0; j < kMaxP; ++j) {
        if (j < jmax) {
          const int32_t target = lp[j] + d;
          while (c < lim && cur < target) {
            if (++c < lim) cur = load_pos(postore, n_pos, pt + c);
          }
          if (c < lim && cur == target) m |= 1u << j;
        }
      }
      mask &= m;
    }
    count = __popc(mask);
  }

  if (ok && count > 0) {
    const float cf = (float)count;
    const float score =
        __fmul_rn(__ldg(q_weight + q), __fdiv_rn(cf, __fadd_rn(cf, cachev)));
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

extern "C" int seg_phrase_launch(
    const void* rows, int n_items, int n_terms, const void* q_weight,
    const void* cl_start, const void* cl_len, const void* cl_shift,
    int num_queries, const void* cstore, const void* blk_last,
    long long n_store_rows, const void* postore, long long n_pos_rows,
    const void* blk_pos, int kw, int pw, int kk, void* out_scores,
    void* out_docs, void* stream) {
  if (n_terms < 1 || n_terms > kTMax || kk < 1 || kk > kLanes ||
      n_items < 0 || kw < 1 || pw < kMaxP || n_pos_rows < 1 ||
      n_store_rows > 0x7fffffffLL || n_pos_rows * 128 > 0x7fffffffLL ||
      ((uintptr_t)cstore & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_items > 0) {
    seg_phrase_kernel<<<n_items, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rows, n_terms, (const float*)q_weight,
        (const int32_t*)cl_start, (const int32_t*)cl_len,
        (const int32_t*)cl_shift, num_queries, (const int32_t*)cstore,
        (const int32_t*)blk_last, n_store_rows, (const int32_t*)postore,
        n_pos_rows * 128, (const int32_t*)blk_pos, kw, pw, kk,
        (float*)out_scores, (int32_t*)out_docs);
  }
  return (int)cudaGetLastError();
}

// Threads, static shared memory per CTA and CTAs resident per SM of the
// kernel on the current device; returns a CUDA error code.
extern "C" int seg_phrase_occupancy(int* threads, int* smem_bytes,
                                    int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, seg_phrase_kernel);
  if (err != cudaSuccess) return (int)err;
  *threads = kLanes;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, seg_phrase_kernel, kLanes, 0);
}
