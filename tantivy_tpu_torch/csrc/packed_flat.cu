// Packed flat scorer (kernel K5 of the port): bit-packed posting blocks
// decoded on the fly, BM25, and a per-item top-kk, in one kernel.
//
// Replaces two XLA programs of the reference's packed mode, fused:
// `decode_doc_rows` / `decode_tf_rows` (tantivy_tpu/ops/decode.py:58-70),
// which the reference's `DeviceFieldPostings._gather_packed` runs per bit
// width to write dense [W, 128] docs and tfs, and the per-row stage of
// `flat_topk_kernel` (tantivy_tpu/ops/flat_scorer.py:43-95): BM25 over the
// decoded rows and `lax.top_k` of each row. The per-query merge that
// follows is the port's torch merge tail (`per_query_topk_from_rows`).
//
// Work item: (block id, qid) of one (segment, field)'s packed mirror
// (ops/device_index.py, `PackedMirror`). One warp serves one item, 4 items
// a CTA; thread t owns lanes 4t..4t+3. Per item:
// * the block's table row: doc row word offset and width, tf row word
//   offset and width, base doc, length;
// * unpack: lane j of a width-w row is bits [j*w % 32, +w) of word
//   j*w / 32 (widths are 0, 1, 2, 4, 8, 16 or 32, so no value straddles a
//   word; width 0 is all zeros and has no words);
// * doc = base + (inclusive prefix sum of the deltas) + lane, all uint32
//   with wraparound: a prefix over the thread's 4 lanes, then a
//   __shfl_up_sync scan of the 32 thread sums; lanes >= length become
//   TERMINATED;
// * tf = unpacked tf + 1 (1 when the tf width is 0, which the mirror also
//   sets for a field without freqs);
// * score = w[q] * (tf / (tf + cache[q, norm_ids[min(doc, max_doc-1)]])),
//   as __fmul_rn(w, __fdiv_rn(tf, __fadd_rn(tf, norm))) under
//   --fmad=false; -inf when the doc is TERMINATED or not alive, or the
//   item is padding (qid outside [0, num_queries) or block out of range);
// * the item's top-kk of its 128 lanes by (score desc, lane asc), the
//   order `lax.top_k` keeps, by direct rank: each live lane counts the
//   lanes of larger `topk_key` (group_topk.cuh) in shared memory. Slots
//   past the live lanes get -inf / TERMINATED.
//
// What bounds it on an H100: bytes. An item reads 16 * (w_doc + w_tf)
// bytes of packed words and a 32-byte table row, plus one norm-id byte and
// one alive byte per live doc, and writes kk scores and docs: about
// 100-250 bytes where a dense row of the fused store is 1,536. No
// tensor-core work. The design keeps every decoded value in registers (the
// reference writes dense [W, 128] docs and tfs to device memory before it
// scores them), so the kernel moves only those bytes; the direct rank
// costs 128 shared-memory reads a thread, far below an item's loads.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_topk.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kLanesPerThread = 4;
constexpr int kItemsPerCta = 4;
constexpr int kThreads = 32 * kItemsPerCta;
constexpr int kTabCols = 8;
constexpr int kCacheCols = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t unpack_lane(const uint32_t* __restrict__ row,
                                                int bits, int lane) {
  if (bits == 0) return 0u;
  const int bit = lane * bits;
  const uint32_t word = __ldg(row + (bit >> 5));
  const uint32_t mask = bits == 32 ? 0xffffffffu : ((1u << bits) - 1u);
  return (word >> (bit & 31)) & mask;
}

__global__ void __launch_bounds__(kThreads) packed_flat_kernel(
    const uint32_t* __restrict__ doc_words,
    const uint32_t* __restrict__ tf_words,
    const int32_t* __restrict__ blk_tab, int n_blocks,
    const uint8_t* __restrict__ norm_ids, const uint8_t* __restrict__ alive,
    int max_doc, const int32_t* __restrict__ blocks,
    const int32_t* __restrict__ qids, int n_items,
    const float* __restrict__ weights, const float* __restrict__ caches,
    int num_queries, int kk, float* __restrict__ out_scores,
    int32_t* __restrict__ out_docs) {
  __shared__ unsigned long long s_key[kItemsPerCta][kLanes];

  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int item = blockIdx.x * kItemsPerCta + warp;
  if (item >= n_items) return;  // a whole warp leaves together
  float* osc = out_scores + (long long)item * kk;
  int32_t* odoc = out_docs + (long long)item * kk;
  const int32_t bid = __ldg(blocks + item);
  const int32_t q = __ldg(qids + item);
  if (!(q >= 0 && q < num_queries && bid >= 0 && bid < n_blocks)) {
    for (int j = t; j < kk; j += 32) {
      osc[j] = -INFINITY;
      odoc[j] = tantivy_port::kTerminatedDoc;
    }
    return;
  }

  const int32_t* tab = blk_tab + (long long)bid * kTabCols;
  const uint32_t* drow = doc_words + __ldg(tab + 0);
  const int doc_bits = __ldg(tab + 1);
  const uint32_t* trow = tf_words + __ldg(tab + 2);
  const int tf_bits = __ldg(tab + 3);
  const uint32_t base = (uint32_t)__ldg(tab + 4);
  const int len = __ldg(tab + 5);

  const int lane0 = kLanesPerThread * t;
  uint32_t csum[kLanesPerThread];
  uint32_t tfv[kLanesPerThread];
  uint32_t run = 0u;
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    run += unpack_lane(drow, doc_bits, lane0 + i);
    csum[i] = run;
    tfv[i] = unpack_lane(trow, tf_bits, lane0 + i) + 1u;
  }
  // inclusive warp scan of the thread sums, uint32 with wraparound
  uint32_t incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(kFull, incl, off);
    if (t >= off) incl += v;
  }
  const uint32_t before = incl - run;

  const float w = __ldg(weights + q);
  const float* cache = caches + (long long)q * kCacheCols;
  const uint32_t last = (uint32_t)(max_doc - 1);
  float sc[kLanesPerThread];
  uint32_t doc[kLanesPerThread];
  int n_live = 0;
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    const int lane = lane0 + i;
    uint32_t d = base + before + csum[i] + (uint32_t)lane;
    if (lane >= len) d = (uint32_t)tantivy_port::kTerminatedDoc;
    const uint32_t safe = d < last ? d : last;
    float s = -INFINITY;
    if (d != (uint32_t)tantivy_port::kTerminatedDoc && __ldg(alive + safe)) {
      const float tf = __uint2float_rn(tfv[i]);
      const float norm = __ldg(cache + __ldg(norm_ids + safe));
      s = __fmul_rn(w, __fdiv_rn(tf, __fadd_rn(tf, norm)));
    }
    sc[i] = s;
    doc[i] = d;
    s_key[warp][lane] = tantivy_port::topk_key(s, lane);
    n_live += __popc(__ballot_sync(kFull, s != -INFINITY));
  }
  __syncwarp();

  unsigned long long key[kLanesPerThread];
  int rank[kLanesPerThread];
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    key[i] = s_key[warp][lane0 + i];
    rank[i] = 0;
  }
  for (int j = 0; j < kLanes; ++j) {
    const unsigned long long other = s_key[warp][j];
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) rank[i] += other > key[i] ? 1 : 0;
  }
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    if (sc[i] != -INFINITY && rank[i] < kk) {
      osc[rank[i]] = sc[i];
      odoc[rank[i]] = (int32_t)doc[i];
    }
  }
  for (int j = n_live + t; j < kk; j += 32) {
    osc[j] = -INFINITY;
    odoc[j] = tantivy_port::kTerminatedDoc;
  }
}

}  // namespace

extern "C" int packed_flat_launch(
    const void* doc_words, const void* tf_words, const void* blk_tab,
    int n_blocks, const void* norm_ids, const void* alive, int max_doc,
    const void* blocks, const void* qids, int n_items, const void* weights,
    const void* caches, int num_queries, int kk, void* out_scores,
    void* out_docs, void* stream) {
  if (kk < 1 || kk > kLanes || n_items < 0 || n_blocks < 0 ||
      (n_blocks > 0 && max_doc < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_items > 0) {
    const int ctas = (n_items + kItemsPerCta - 1) / kItemsPerCta;
    packed_flat_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)doc_words, (const uint32_t*)tf_words,
        (const int32_t*)blk_tab, n_blocks, (const uint8_t*)norm_ids,
        (const uint8_t*)alive, max_doc, (const int32_t*)blocks,
        (const int32_t*)qids, n_items, (const float*)weights,
        (const float*)caches, num_queries, kk, (float*)out_scores,
        (int32_t*)out_docs);
  }
  return (int)cudaGetLastError();
}

// Threads, static shared memory per CTA and CTAs resident per SM of the
// kernel on the current device; returns a CUDA error code.
extern "C" int packed_flat_occupancy(int* threads, int* smem_bytes,
                                     int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, packed_flat_kernel);
  if (err != cudaSuccess) return (int)err;
  *threads = kThreads;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, packed_flat_kernel, kThreads, 0);
}
