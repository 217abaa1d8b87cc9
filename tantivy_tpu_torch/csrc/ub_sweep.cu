// The fused boolean planner's block-max UB sweep on the card.
//
// Replaces no TPU kernel: the reference plans on the host, in numpy
// (`tantivy_tpu/parallel/wand.py`, `batched_clause_details`), and so did
// the port until this kernel. It computes what the port's numpy
// `batched_clause_details` (`parallel/wand.py`) computes, bit for bit; that
// function is its twin, which the tests hold it to, and the CPU executor's
// path.
//
// A call is one (segment, query, positive clause): the clause's block
// region [start, start + n) of the fused store, its weight, and the query's
// other clauses, each an entry (s2, n2, w2, must, column). One thread serves
// one block row b of one call. For every other clause it finds
// * i0: the first block of the other region [s2, s2 + n2) whose last doc is
//   >= blk_base[b] (a lower bound over `blast`),
// * i1: the first block of that region whose first doc is > blk_last[b] (an
//   upper bound over `bbase`), both s2 + n2 where none is,
// * ov: the max of `bfac` over [i0, i1), 0.0 for an empty range,
// and writes the window columns jlo = i0 rounded down to 8, i0, i1, width =
// i1 - jlo and the term w2 * ov. The block's own term is w * bfac[b]. The
// UB sums the terms from +0.0 in ascending clause position (the host sorts
// each call's entries, its own included, by position) with explicitly
// rounded f32 intrinsics, under --fmad=false: the probe kernels' score order
// and roundings, on which the planner's exact pruning rests (`wand.py`,
// `clause_blocks_ub`). A block is dropped when a MUST other has i1 <= i0.
//
// The numpy version searches one global composite key array (region << 32
// | doc); inside a region whose blocks' docs ascend (checked where the store
// is built) a search of the region alone gives the same index, s2 + n2
// past its end included. Max does not round, so the range max is exact in
// any order; a NaN in the range gives NaN, as numpy's does.
//
// Outputs, one int32 buffer the host copies back at once: for pair row p
// (call c, column oi, row i: p = pair_off[c] + oi * n[c] + i, so a column
// of a call is contiguous) jlo, i0, i1, width and the term's f32 bits, each
// an array of P words; then for row r the UB, the own term and the drop
// flag, each R words.
//
// What bounds it on an H100: the latency of the binary searches' dependent
// loads. The tables (blk_base, blk_last, bfac: 12 B a block, about 5 MB at
// 435k blocks) sit in the 50 MB L2; a thread makes some 2 log2(n2) loads an
// other clause. The bytes written, 20 B a pair row and 12 B a block row, set
// the floor at a few hundred MB a second's worth, well under a millisecond
// for a batch. Threads of one call take neighbouring rows and write
// neighbouring words of each column.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// call table columns
constexpr int kCallCols = 4;  // start, ent_off, ent_end, pair_off
// entry table columns
constexpr int kEntCols = 4;   // s2, n2, w bits, flags
constexpr int kSelf = -1;     // flags of the call's own entry
constexpr int kMustBit = 1 << 16;

__device__ __forceinline__ int lower_bound_u32(const uint32_t* a, int lo,
                                               int hi, uint32_t key) {
  // first i in [lo, hi) with a[i] >= key, else hi
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound_u32(const uint32_t* a, int lo,
                                               int hi, uint32_t key) {
  // first i in [lo, hi) with a[i] > key, else hi
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (__ldg(a + mid) <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) ub_sweep_kernel(
    const uint32_t* __restrict__ bbase, const uint32_t* __restrict__ blast,
    const float* __restrict__ bfac, const int32_t* __restrict__ row_off,
    const int32_t* __restrict__ calls, const int32_t* __restrict__ ents,
    int n_calls, int n_rows, int n_pairs, int32_t* __restrict__ out) {
  int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rows) return;
  // the call: the last c with row_off[c] <= r (calls of no rows share the
  // next one's offset and so are passed over)
  int lo = 0, hi = n_calls;
  while (hi - lo > 1) {
    int mid = (lo + hi) >> 1;
    if (__ldg(row_off + mid) <= r) lo = mid; else hi = mid;
  }
  const int c = lo;
  const int32_t* cc = calls + (size_t)c * kCallCols;
  const int i = r - __ldg(row_off + c);
  const int n = __ldg(row_off + c + 1) - __ldg(row_off + c);
  const int b = __ldg(cc + 0) + i;
  const uint32_t lo_doc = __ldg(bbase + b);
  const uint32_t hi_doc = __ldg(blast + b);
  const int pair_off = __ldg(cc + 3);
  int32_t* jlo_o = out;
  int32_t* i0_o = out + n_pairs;
  int32_t* i1_o = out + 2 * (size_t)n_pairs;
  int32_t* wid_o = out + 3 * (size_t)n_pairs;
  float* term_o = reinterpret_cast<float*>(out + 4 * (size_t)n_pairs);
  float* ub_o = reinterpret_cast<float*>(out + 5 * (size_t)n_pairs);
  float* self_o = ub_o + n_rows;
  int32_t* drop_o = out + 5 * (size_t)n_pairs + 2 * (size_t)n_rows;

  float ub = 0.0f;
  int drop = 0;
  const int e_end = __ldg(cc + 2);
  for (int e = __ldg(cc + 1); e < e_end; ++e) {
    const int32_t* en = ents + (size_t)e * kEntCols;
    const float w = __int_as_float(__ldg(en + 2));
    const int flags = __ldg(en + 3);
    float t;
    if (flags == kSelf) {
      t = __fmul_rn(w, __ldg(bfac + b));
      self_o[r] = t;
    } else {
      const int s2 = __ldg(en + 0);
      const int e2 = s2 + __ldg(en + 1);
      const int i0 = lower_bound_u32(blast, s2, e2, lo_doc);
      const int i1 = upper_bound_u32(bbase, s2, e2, hi_doc);
      float ov = 0.0f;
      if (i1 > i0) {
        ov = __ldg(bfac + i0);
        for (int j = i0 + 1; j < i1; ++j) {
          const float x = __ldg(bfac + j);
          // numpy's maximum: a NaN on either side wins
          ov = (x > ov || x != x) ? x : ov;
        }
      }
      t = __fmul_rn(w, ov);
      if ((flags & kMustBit) && i1 <= i0) drop = 1;
      const int col = flags & 0xffff;
      const size_t p = (size_t)pair_off + (size_t)col * n + i;
      const int jlo = i0 & ~7;
      jlo_o[p] = jlo;
      i0_o[p] = i0;
      i1_o[p] = i1;
      wid_o[p] = i1 - jlo;
      term_o[p] = t;
    }
    ub = __fadd_rn(ub, t);
  }
  ub_o[r] = ub;
  drop_o[r] = drop;
}

}  // namespace

// One launch over every block row of every call, on `stream`: `tables`
// holds row_off [n_calls + 1], then the call table [n_calls, 4], then the
// entry table [n_ents, 4], int32; `out` takes 5 n_pairs + 3 n_rows words.
// Returns a CUDA error code.
extern "C" int ub_sweep_launch(const void* bbase, const void* blast,
                               const void* bfac, const void* tables,
                               int n_calls, int n_rows, int n_pairs,
                               void* out, void* stream) {
  if (n_calls < 1 || n_rows < 0 || n_pairs < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows > 0) {
    const int32_t* row_off = (const int32_t*)tables;
    const int32_t* calls = row_off + n_calls + 1;
    const int32_t* ents = calls + (size_t)n_calls * kCallCols;
    const int grid = (n_rows + kThreads - 1) / kThreads;
    ub_sweep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)bbase, (const uint32_t*)blast, (const float*)bfac,
        row_off, calls, ents, n_calls, n_rows, n_pairs, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

// Threads, static shared memory per CTA and CTAs resident per SM of the
// kernel on the current device; returns a CUDA error code.
extern "C" int ub_sweep_occupancy(int* threads, int* smem_bytes,
                                  int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, ub_sweep_kernel);
  if (err != cudaSuccess) return (int)err;
  *threads = kThreads;
  *smem_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, ub_sweep_kernel, kThreads, 0);
}
