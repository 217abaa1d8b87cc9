// Per-group top-kk selection shared by the port's probe kernels (K1-K3).
//
// Each kernel compacts a group's surviving lanes (score >= the plan row's
// threshold, not -inf) into shared memory, in any order. This writes the
// first min(n, kk) of them ordered by (score desc, flat index asc), the
// order of the Pallas kernels' repeated max / lowest-index extraction, and
// fills the rest of the group's kk output slots with -inf / TERMINATED.
// Every thread of the block calls it after a __syncthreads(), with the same
// n and kk and a TopkScratch in shared memory that nothing else uses
// meanwhile (a kernel may lend it a buffer it is done with).
//
// Each survivor gets a 48-bit rank key, larger = earlier: the order-keeping
// u32 image of its score above 16 bits of (0xFFFF - flat). Keys are
// distinct because flat indices are. Up to kTopkMax survivors are ranked
// directly, each against the others' keys in shared memory. More are cut by
// a radix select over the key, 8 bits a pass from the top, that finds the
// kk-th largest key; a pass ends the search as soon as the elements that
// share the chosen prefix are exactly those still needed, which typically
// takes 2-3 passes. The selected elements (at most kk <= 128) are compacted
// and ranked directly. Cost: O(n / threads) per pass plus O(kk) per thread,
// where a direct rank of every survivor is O(n) per survivor (8,192 steps a
// thread at n = 1,024).

#pragma once

#include <math.h>
#include <stdint.h>

namespace tantivy_port {

constexpr int32_t kTerminatedDoc = 0x7fffffff;
// the largest kk (and survivor count ranked directly) and flat index the
// keys and scratch take
constexpr int kTopkMax = 128;
constexpr int kFlatMax = 0xFFFF;

struct TopkScratch {
  unsigned int hist[2][256];
  unsigned int part[32];
  unsigned long long prefix;
  int shift;  // bits below the decided prefix; -1 = all decided
  int need;
  int m;
  unsigned long long sel_key[kTopkMax];
  int sel_idx[kTopkMax];
};

// Rank key of a survivor: the score's order-keeping u32 image (both zeros
// map to one key, as float comparison treats them) above 0xFFFF - flat.
__device__ __forceinline__ unsigned long long topk_key(float s, int32_t flat) {
  uint32_t u = __float_as_uint(s);
  if ((u << 1) == 0) u = 0;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 16) | (uint32_t)(kFlatMax - flat);
}

__device__ __forceinline__ void write_group_topk(
    const float* c_score, const int32_t* c_flat, const int32_t* c_doc, int n,
    int kk, float* __restrict__ osc, int32_t* __restrict__ odoc,
    TopkScratch& sc) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int m = n < kk ? n : kk;

  if (n <= kTopkMax) {
    for (int i = tid; i < n; i += nthreads) {
      sc.sel_key[i] = topk_key(c_score[i], c_flat[i]);
    }
    __syncthreads();
    for (int i = tid; i < n; i += nthreads) {
      const unsigned long long key = sc.sel_key[i];
      int rank = 0;
      for (int j = 0; j < n; ++j) rank += sc.sel_key[j] > key ? 1 : 0;
      if (rank < kk) {
        osc[rank] = c_score[i];
        odoc[rank] = c_doc[i];
      }
    }
    for (int j = m + tid; j < kk; j += nthreads) {
      osc[j] = -INFINITY;
      odoc[j] = kTerminatedDoc;
    }
    return;
  }

  // n > kTopkMax >= kk: a select is needed
  if (tid == 0) {
    sc.prefix = 0;
    sc.shift = 48;
    sc.need = kk;
    sc.m = 0;
  }
  for (int i = tid; i < 256; i += nthreads) sc.hist[0][i] = 0;
  __syncthreads();

  // radix select of the kk-th largest key
  int buf = 0;
  while (true) {
    const int shift = sc.shift;
    if (shift <= 0) break;
    const int dshift = shift - 8;
    const unsigned long long prefix = sc.prefix;
    const unsigned need = (unsigned)sc.need;
    for (int i = tid; i < n; i += nthreads) {
      const unsigned long long key = topk_key(c_score[i], c_flat[i]);
      if ((key >> shift) == (prefix >> shift)) {
        atomicAdd(&sc.hist[buf][(key >> dshift) & 255], 1u);
      }
    }
    __syncthreads();
    // 32 partial sums, digit 255 first
    if (tid < 32) {
      unsigned int sum = 0;
      for (int d = 255 - 8 * tid; d > 247 - 8 * tid; --d) {
        sum += sc.hist[buf][d];
      }
      sc.part[tid] = sum;
    }
    for (int i = tid; i < 256; i += nthreads) sc.hist[buf ^ 1][i] = 0;
    __syncthreads();
    // the digit d with (count above d) < need <= (count from d up): the
    // one thread whose 8 digits hold it finds it
    if (tid < 32) {
      unsigned above = 0;
      for (int p = 0; p < tid; ++p) above += sc.part[p];
      if (above < need && need <= above + sc.part[tid]) {
        unsigned rem = need - above;
        int d = 255 - 8 * tid;
        while (sc.hist[buf][d] < rem) rem -= sc.hist[buf][d--];
        sc.prefix = prefix | ((unsigned long long)d << dshift);
        sc.need = (int)rem;
        // done when every element with this prefix is needed
        sc.shift = sc.hist[buf][d] == rem ? -1 : dshift;
      }
    }
    __syncthreads();
    buf ^= 1;
  }

  // the kept elements: key >= the prefix with its undecided bits zero
  const unsigned long long cut = sc.prefix;
  for (int i = tid; i < n; i += nthreads) {
    const unsigned long long key = topk_key(c_score[i], c_flat[i]);
    if (key >= cut) {
      const int slot = atomicAdd(&sc.m, 1);
      sc.sel_key[slot] = key;
      sc.sel_idx[slot] = i;
    }
  }
  __syncthreads();
  for (int i = tid; i < m; i += nthreads) {
    const unsigned long long key = sc.sel_key[i];
    int rank = 0;
    for (int j = 0; j < m; ++j) rank += sc.sel_key[j] > key ? 1 : 0;
    const int src = sc.sel_idx[i];
    osc[rank] = c_score[src];
    odoc[rank] = c_doc[src];
  }
  for (int j = m + tid; j < kk; j += nthreads) {
    osc[j] = -INFINITY;
    odoc[j] = kTerminatedDoc;
  }
}

}  // namespace tantivy_port
