// Per-group top-kk selection shared by the port's probe kernels (K1, K2).
//
// Each kernel compacts a group's surviving lanes (score >= the plan row's
// threshold, not -inf) into shared memory, in any order. This writes the
// first min(n, kk) of them ordered by (score desc, flat index asc), the
// order of the Pallas kernels' repeated max / lowest-index extraction, and
// fills the rest of the group's kk output slots with -inf / TERMINATED.
// Every thread of the block calls it after a __syncthreads().

#pragma once

#include <math.h>
#include <stdint.h>

namespace tantivy_port {

constexpr int32_t kTerminatedDoc = 0x7fffffff;

__device__ __forceinline__ void write_group_topk(
    const float* c_score, const int32_t* c_flat, const int32_t* c_doc, int n,
    int kk, float* __restrict__ osc, int32_t* __restrict__ odoc) {
  // rank = number of survivors ordered before this one; ranks are distinct
  // because flat indices are, so each output slot < min(n, kk) is written
  // once
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float s = c_score[i];
    const int32_t f = c_flat[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const float o = c_score[j];
      rank += (o > s || (o == s && c_flat[j] < f)) ? 1 : 0;
    }
    if (rank < kk) {
      osc[rank] = s;
      odoc[rank] = c_doc[i];
    }
  }
  for (int j = min(n, kk) + threadIdx.x; j < kk; j += blockDim.x) {
    osc[j] = -INFINITY;
    odoc[j] = kTerminatedDoc;
  }
}

}  // namespace tantivy_port
