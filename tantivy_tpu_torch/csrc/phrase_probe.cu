// Phrase (slop 0) position-probe scorer with per-group top-kk (kernel K2 of
// the port).
//
// Replaces the Pallas TPU kernel `_phrase_kernel_body` in
// tantivy_tpu/ops/pallas_phrase.py (launched by `_phrase_rows`). It computes
// the same function; it does not copy the TPU kernel's slab DMAs, 8-row
// chunk loops or dense all-pairs compares.
//
// Work item: one "group" = up to 8 consecutive cstore rows (member rows,
// gated by an 8-bit mask) of the ANCHOR term of one plan row (one phrase on
// one segment, or one expansion of a phrase-prefix). One CTA of 128 threads
// serves one group.
//
// The position store `postore` is [NPr, 256] int32: row q holds positions
// 128q..128q+127 in words 0..127 and each position's owner doc in words
// 128..255. Every term's positions are stored in (block, lane, position)
// order, so inside a term region they ascend by (owner, position); the
// fused store checks that once when it builds the store. Each group's
// scalar row gives the anchor slab's first row `arow0`, each partner slab's
// first row `crow0_s` and phrase offset `delta_s`, and per member the
// anchor sub-range [loff, loff + llen) and partner sub-ranges
// [off_s, off_s + len_s), counted in positions from the slab's first row.
// Every sub-range is cut to the first `slab_rows` rows of its slab: the
// window the TPU kernel fetched.
//
// Per member row: the lane docs go to shared memory; the threads stride
// over the anchor sub-range; for each anchor position p with owner o the
// thread finds o's lane by binary search over the ascending lane docs and,
// for every partner with len_s > 0, binary-searches the partner sub-range
// for (owner == o, position == p + delta_s) in int32 arithmetic (the store's
// 0xFFFFFFFF padding reads as -1 and never equals a doc). If every partner
// hits, the lane's count goes up by one (an integer atomicAdd, exact in any
// order). A lane then scores qw[prow] * (tf / (tf + cachev)) with explicitly
// rounded f32 intrinsics when its doc is not TERMINATED, cachev is not NaN
// (deleted) and tf > 0. Survivors (score >= row_th[prow], not -inf) are
// compacted into shared memory and ranked by (score desc, flat index
// r*128 + lane asc), as in kernel K1.
//
// What bounds it on an H100: memory latency. Each anchor position costs one
// dependent chain of ~log2(span) two-word loads per partner, into slabs of
// at most 136 rows x 1 KB that stay in L2 across the group's members. The
// design probes from global memory through the read-only path instead of
// staging slabs, keeps one CTA per group so that thousands of CTAs hide the
// latency, and counts with shared-memory integer atomics.
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
constexpr int kPosWords = 256;  // positions | owner docs
constexpr int kMaxPartners = 7;
constexpr int kMaxStride = 256;

// Position and owner of the global position index `g`.
__device__ __forceinline__ void read_pos(const int32_t* __restrict__ postore,
                                         long long g, int32_t* pos,
                                         int32_t* owner) {
  const int32_t* row = postore + (g >> 7) * kPosWords;
  const int c = (int)(g & 127);
  *pos = __ldg(row + c);
  *owner = __ldg(row + kLanes + c);
}

// True when positions [base + lo, base + hi), ascending by (owner, pos),
// hold (owner, pos).
__device__ bool partner_has(const int32_t* __restrict__ postore,
                            long long base, int lo, int hi, int32_t owner,
                            int32_t pos) {
  const int end = hi;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    int32_t p, o;
    read_pos(postore, base + mid, &p, &o);
    if (o < owner || (o == owner && p < pos)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo >= end) return false;
  int32_t p, o;
  read_pos(postore, base + lo, &p, &o);
  return o == owner && p == pos;
}

// Positions of the slab starting at row `row0` that a sub-range may read:
// the first `slab_rows` rows, and never past the store.
__device__ __forceinline__ int window(long long row0, int slab_rows,
                                      long long n_pos_rows) {
  const long long rows_left = n_pos_rows - row0;
  const long long rows = rows_left < slab_rows ? rows_left : slab_rows;
  return rows > 0 ? (int)(rows * kLanes) : 0;
}

__global__ void __launch_bounds__(kLanes) phrase_probe_kernel(
    const int32_t* __restrict__ rows, int stride, int n_partners,
    int slab_rows, const float* __restrict__ qw,
    const float* __restrict__ row_th, int num_prows,
    const int32_t* __restrict__ cstore, long long n_store_rows,
    const int32_t* __restrict__ postore, long long n_pos_rows, int kk,
    float* __restrict__ out_scores, int32_t* __restrict__ out_docs) {
  __shared__ int32_t s_row[kMaxStride];
  __shared__ int32_t s_docs[kLanes];
  __shared__ int32_t s_cnt[kLanes];
  __shared__ float c_score[kCand];
  __shared__ int32_t c_flat[kCand];
  __shared__ int32_t c_doc[kCand];
  __shared__ int n_sur;

  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int S = n_partners;
  const int A = 4 + 2 * S;
  const int32_t* grow = rows + (long long)g * stride;
  for (int i = lane; i < stride; i += kLanes) s_row[i] = grow[i];
  if (lane == 0) n_sur = 0;
  __syncthreads();

  const int32_t row_base = s_row[0];
  const int32_t prow = s_row[1];
  const int32_t mask = s_row[2];
  const long long arow0 = s_row[3];
  // fully-masked groups are padding; rows past num_prows report nothing
  const bool live = mask != 0 && prow >= 0 && prow < num_prows;

  if (live) {
    const float w = qw[prow];
    const float th = row_th[prow];
    const int a_lim = window(arow0, slab_rows, n_pos_rows);
    for (int r = 0; r < kMembers; ++r) {
      if (((mask >> r) & 1) == 0) continue;
      const long long lrow = (long long)row_base + r;
      if (lrow < 0 || lrow >= n_store_rows) continue;
      const int32_t* crow = cstore + lrow * kRowWords;
      const int32_t doc = crow[lane];
      const float cachev = __int_as_float(crow[2 * kLanes + lane]);
      s_docs[lane] = doc;
      s_cnt[lane] = 0;
      __syncthreads();

      const int loff = s_row[A + r];
      const int llen = s_row[A + kMembers + r];
      const int a_lo = loff > 0 ? loff : 0;
      const long long a_end_l = (long long)loff + llen;
      const int a_end = a_end_l < a_lim ? (int)a_end_l : a_lim;
      for (int e = a_lo + lane; llen > 0 && e < a_end; e += kLanes) {
        int32_t pos, owner;
        read_pos(postore, arow0 * kLanes + e, &pos, &owner);
        int lo = 0;
        int hi = kLanes;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_docs[mid] < owner) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        if (lo >= kLanes || s_docs[lo] != owner) continue;
        bool all = true;
        for (int s = 0; s < S && all; ++s) {
          const int plen = s_row[A + 24 + 16 * s + r];
          if (plen <= 0) continue;  // an empty partner is satisfied
          const int poff = s_row[A + 16 + 16 * s + r];
          const long long crow0 = s_row[4 + 2 * s];
          const int32_t delta = s_row[5 + 2 * s];
          const int p_lim = window(crow0, slab_rows, n_pos_rows);
          const int p_lo = poff > 0 ? poff : 0;
          const long long p_end_l = (long long)poff + plen;
          const int p_hi = p_end_l < p_lim ? (int)p_end_l : p_lim;
          const int32_t tgt = (int32_t)((uint32_t)pos + (uint32_t)delta);
          all = partner_has(postore, crow0 * kLanes, p_lo, p_hi, owner, tgt);
        }
        if (all) atomicAdd(&s_cnt[lo], 1);
      }
      __syncthreads();

      const int cnt = s_cnt[lane];
      if (doc != tantivy_port::kTerminatedDoc && !isnan(cachev) && cnt > 0) {
        const float tf = (float)cnt;
        const float score = __fmul_rn(w, __fdiv_rn(tf, __fadd_rn(tf, cachev)));
        if (score >= th && score != -INFINITY) {
          const int slot = atomicAdd(&n_sur, 1);
          c_score[slot] = score;
          c_flat[slot] = r * kLanes + lane;
          c_doc[slot] = doc;
        }
      }
      // s_docs / s_cnt are rewritten by the next member
      __syncthreads();
    }
  }
  __syncthreads();

  tantivy_port::write_group_topk(c_score, c_flat, c_doc, n_sur, kk,
                                 out_scores + (long long)g * kk,
                                 out_docs + (long long)g * kk);
}

}  // namespace

extern "C" int phrase_probe_launch(
    const void* rows, int n_groups, int stride, int n_partners,
    int slab_rows, const void* qw, const void* row_th, int num_prows,
    const void* cstore, long long n_store_rows, const void* postore,
    long long n_pos_rows, int kk, void* out_scores, void* out_docs,
    void* stream) {
  if (n_partners < 1 || n_partners > kMaxPartners || stride > kMaxStride ||
      stride < 20 + 18 * n_partners || slab_rows < 8 || kk < 1 ||
      kk > kLanes) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_groups > 0) {
    phrase_probe_kernel<<<n_groups, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)rows, stride, n_partners, slab_rows,
        (const float*)qw, (const float*)row_th, num_prows,
        (const int32_t*)cstore, n_store_rows, (const int32_t*)postore,
        n_pos_rows, kk, (float*)out_scores, (int32_t*)out_docs);
  }
  return (int)cudaGetLastError();
}
