// Per-segment phrase (slop 0) probe with per-item top-kk (kernel K6 of the
// port).
//
// Replaces the reference's XLA program `probe_phrase_topk`
// (tantivy_tpu/ops/phrase_scorer.py:71), the scorer of the per-segment
// Block-WAND phrase path. It computes the same lane scores and the same
// per-item top-kk for any window width kw; it does not build the
// reference's gathered [W, kw * 128] doc windows nor its [W, 128, pw]
// position windows.
//
// Work item: one cstore row (128 lanes of the phrase's leader term, its
// rarest) of one query, given as one int32 row of `rows` [W, 3]: 0=bid,
// 1=qid, 2=the leader's term index. One CTA of 128 threads serves one item;
// thread `lane` owns lane `lane` until the position stage.
//
// What the reference computes, per term t: a window of kw rows that starts
// at the lower bound of the item's first doc among the region's row last
// docs (`blk_last`) and is cut to the region; a lane's doc is found in it or
// not, with its tf and its first position's index. Per live lane (doc not
// TERMINATED, BM25 denominator `cachev` not NaN) every term must hold the
// doc; then each of the leader's first min(tf, MAX_P) positions p (MAX_P =
// 16 <= pw) counts when every other term t holds p + shift_leader - shift_t
// among its first min(tf_t, pw) positions. Score: q_weight * (count /
// (count + cachev)) with explicitly rounded f32 intrinsics under
// --fmad=false; a lane reports iff every term holds its doc and count > 0.
// The item keeps its top-kk reporting lanes by (score desc, lane asc), the
// order of `lax.top_k`, through group_topk.cuh.
//
// What bounds it on an H100: the latency of dependent loads, and in the
// position stage the scattered sectors of device memory it reads. The
// design keeps each lane's chain short:
// * Narrowed ranges. The item's live docs ascend, so every live lane's row
//   in term t lies in [a_t, b_t): a_t the lower bound of the first live doc,
//   b_t one past that of the last live doc, cut to the window. The window
//   start and both bounds are three searches per term, each by one warp at
//   once (`warp_lower_bound`: 32 pivots a step, one ballot), all terms'
//   searches spread over the CTA's four warps.
// * Staging. Terms whose ranges fit, in term order, into kStageRows rows get
//   those rows' docs and tfs copied into shared memory in one round of
//   cp.async copies; one scan turns each staged row's tfs into inclusive
//   prefix sums, so a lane's tf and its first position's index (the row's
//   `blk_pos` entry plus the tfs of the row's earlier lanes) are two shared
//   reads and one load. A term whose range does not fit but holds at most
//   what is left of kLastCap rows gets its `blk_last` words staged in the
//   same round, and its lanes search them in shared memory, then probe one
//   row in device memory (row_probe.cuh's `probe_row_at`). Wider ranges are
//   searched in device memory (`lower_bound4` over the range). The three
//   forms are one kernel; a term takes the first that fits.
// * Survivors. The lanes every term holds are compacted into a list, and
//   the position stage runs one list entry a thread. The leader's first
//   min(tf, MAX_P) positions are independent loads into shared memory (the
//   staging area is free by then, and registers would cost occupancy).
//   Each other term's first min(tf, pw) positions follow in batches of
//   kPosBatch independent loads, each batch compared with every aligned
//   target in registers, until a batch reaches the last target (both
//   lists ascend); a term that leaves no leader position matching ends the
//   count. The position stage takes about half the kernel's time on a
//   bigram batch (scripts/kernel_stages.py): a survivor's positions are a
//   few sectors in device memory, apart from every other survivor's.
//   Independent loads in place of a forward cursor (one dependent load a
//   step) cut it a little; fewer, 16-byte loads did not.
// The bytes an item must move are its own row's docs and denominators, for
// each live lane and term the sector of the row that holds its doc (and on
// a hit its tf sector and `blk_pos` entry), and the positions the matching
// lanes compare; the smoke counts exactly these (`seg_phrase_bytes`). A
// padding item (qid == num_queries) only writes its fill.
//
// Preconditions (checked where the fused store is built): inside a region
// docs ascend strictly across rows, apart from TERMINATED padding after the
// last doc, and every row holds a doc; inside a doc a term's positions
// ascend, and every position is below 2^31 - 8, so that int32 compares keep
// their order. Position reads are clamped to the store, as the reference
// clamps its window gathers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_topk.cuh"
#include "row_probe.cuh"
#include "stage.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
constexpr int kRowWords = 384;     // docs | tfs | bitcast(cachev)
constexpr int kPosRowWords = 256;  // positions | owners
constexpr int kRowCols = 3;        // bid, qid, leader term
constexpr int kTMax = 8;
constexpr int kMaxP = 16;
// positions of a term a survivor loads at once
constexpr int kPosBatch = 8;
// rows whose docs and tfs a CTA stages (1 KB each), and `blk_last` words
constexpr int kStageRows = 12;
constexpr int kLastCap = 512;
// how a term's lanes find their rows
constexpr int kEmpty = 0;   // no row can hold a live doc
constexpr int kRows = 1;    // its rows are staged
constexpr int kLast = 2;    // its `blk_last` words are staged
constexpr int kGlobal = 3;  // search in device memory

struct Stage {
  int32_t rows[kStageRows][2 * kLanes];  // docs | inclusive tf prefix
  int32_t last[kLastCap];
};

// what the position stage and the top-kk need, once the stage is done with
struct Tail {
  int32_t lead_pos[kMaxP][kLanes];  // a survivor's leader positions
  float c_score[kLanes];
  int32_t c_flat[kLanes];
  int32_t c_doc[kLanes];
  tantivy_port::TopkScratch topk;
};

union Scratch {
  Stage st;
  Tail tail;
};

// Position `idx` of the flat position store (clamped to it).
__device__ __forceinline__ int32_t load_pos(const int32_t* __restrict__ pos,
                                            long long n_pos, long long idx) {
  idx = idx < 0 ? 0 : (idx >= n_pos ? n_pos - 1 : idx);
  return __ldg(pos + (idx >> 7) * kPosRowWords + (idx & 127));
}

// 9 CTAs an SM: at most 56 registers a thread
__global__ void __launch_bounds__(kLanes, 9) seg_phrase_kernel(
    const int32_t* __restrict__ rows, int n_terms,
    const float* __restrict__ q_weight, const int32_t* __restrict__ cl_start,
    const int32_t* __restrict__ cl_len, const int32_t* __restrict__ cl_shift,
    int num_queries, const int32_t* __restrict__ cstore,
    const int32_t* __restrict__ blk_last, long long n_store_rows,
    const int32_t* __restrict__ postore, long long n_pos,
    const int32_t* __restrict__ blk_pos, int kw, int pw, int kk,
    float* __restrict__ out_scores, int32_t* __restrict__ out_docs) {
  __shared__ Scratch sm;
  __shared__ int32_t s_tf[kTMax][kLanes];
  __shared__ int32_t s_pb[kTMax][kLanes];  // first position's index
  __shared__ long long s_lb[kTMax][3];     // window start, first, last
  __shared__ int32_t s_a[kTMax];           // each term's range [a, a + m)
  __shared__ int32_t s_m[kTMax];
  __shared__ int32_t s_mode[kTMax];
  __shared__ int32_t s_off[kTMax];  // where its staged rows or words start
  __shared__ int32_t s_shift[kTMax];
  __shared__ int32_t s_wsum[kStageRows][kWarps];
  __shared__ unsigned s_live[kWarps];
  __shared__ unsigned s_held[kWarps];
  __shared__ int32_t s_list[kLanes];
  __shared__ int n_staged;
  __shared__ int n_sur;

  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
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
  const int32_t doc = __ldg(crow + lane);
  const bool live = doc != tantivy_port::kTerminatedDoc &&
                    !isnan(__int_as_float(__ldg(crow + 2 * kLanes + lane)));
  const unsigned live_bits = __ballot_sync(0xffffffffu, live);
  if (wl == 0) s_live[warp] = live_bits;
  if (lane == 0) n_sur = 0;
  if (lane < T) s_shift[lane] = cl_shift[q * T + lane];
  __syncthreads();

  // the first and last live lanes: their docs bound every live doc
  int first = -1, last = -1;
  for (int w = 0; w < kWarps; ++w) {
    const unsigned b = s_live[w];
    if (b != 0u) {
      if (first < 0) first = 32 * w + __ffs(b) - 1;
      last = 32 * w + 31 - __clz(b);
    }
  }
  if (first >= 0) {
    // per term: the window start (the reference's, from the row's first
    // doc) and the lower bounds of the first and last live docs
    for (int i = warp; i < 3 * T; i += kWarps) {
      const int t = i / 3;
      const int which = i - 3 * t;
      const long long s = cl_start[q * T + t];
      const long long n = cl_len[q * T + t];
      const long long e = s + n < n_store_rows ? s + n : n_store_rows;
      long long lb = s;
      if (n > 0 && s >= 0 && e > s) {
        const int32_t key = __ldg(crow + (which == 0 ? 0
                                          : which == 1 ? first : last));
        lb = tantivy_port::warp_lower_bound(blk_last, s, e - s, key);
      }
      if (wl == 0) s_lb[t][which] = lb;
    }
    __syncthreads();

    // each term's range and how its lanes search it
    if (lane == 0) {
      int rows_used = 0, last_used = 0;
      for (int t = 0; t < T; ++t) {
        const long long s = cl_start[q * T + t];
        const long long n = cl_len[q * T + t];
        const long long e = s + n < n_store_rows ? s + n : n_store_rows;
        long long a = 0, b = 0;
        if (n > 0 && s >= 0 && e > s) {
          const long long lo = s_lb[t][0];
          const long long hi = lo + kw < e ? lo + kw : e;
          a = s_lb[t][1];
          b = s_lb[t][2] + 1 < hi ? s_lb[t][2] + 1 : hi;
        }
        const int m = b > a ? (int)(b - a) : 0;
        int mode = kGlobal, off = 0;
        if (m == 0) {
          mode = kEmpty;
        } else if (rows_used + m <= kStageRows) {
          mode = kRows;
          off = rows_used;
          rows_used += m;
        } else if (last_used + m <= kLastCap) {
          mode = kLast;
          off = last_used;
          last_used += m;
        }
        s_a[t] = (int32_t)a;
        s_m[t] = m;
        s_mode[t] = mode;
        s_off[t] = off;
      }
      n_staged = rows_used;
    }
    __syncthreads();

    // one round of copies: staged rows' docs and tfs, staged blk_last words
    for (int t = 0; t < T; ++t) {
      const int mode = s_mode[t];
      const int a = s_a[t];
      const int m = s_m[t];
      const int off = s_off[t];
      if (mode == kRows) {
        for (int i = lane; i < m * 64; i += kLanes) {
          const int r = i >> 6;
          const int c = (i & 63) << 2;
          tantivy_port::cp_async16(&sm.st.rows[off + r][c],
                                   cstore + (long long)(a + r) * kRowWords +
                                       c);
        }
      } else if (mode == kLast) {
        for (int i = lane; i < m; i += kLanes) {
          tantivy_port::cp_async4(&sm.st.last[off + i], blk_last + a + i);
        }
      }
    }
    tantivy_port::cp_async_commit_wait_all();
    __syncthreads();

    // staged tfs -> inclusive prefix sums along each row
    const int ns = n_staged;
    for (int r = 0; r < ns; ++r) {
      int32_t v = sm.st.rows[r][kLanes + lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t u = __shfl_up_sync(0xffffffffu, v, d);
        if (wl >= d) v += u;
      }
      sm.st.rows[r][kLanes + lane] = v;
      if (wl == 31) s_wsum[r][warp] = v;
    }
    __syncthreads();
    for (int r = 0; r < ns; ++r) {
      int32_t add = 0;
      for (int w = 0; w < warp; ++w) add += s_wsum[r][w];
      sm.st.rows[r][kLanes + lane] += add;
    }
    __syncthreads();
  }

  // every term's (tf, first position) for the lane's doc, in term order
  // until a term misses
  bool ok = live;
  for (int t = 0; t < T && ok; ++t) {
    const int mode = s_mode[t];
    const int a = s_a[t];
    const int m = s_m[t];
    int32_t tf = 0, pb = 0;
    if (mode == kEmpty) {
      ok = false;
    } else if (mode == kRows) {
      const int32_t* base = sm.st.rows[s_off[t]];
      // the last staged row whose first doc is <= doc, else the first
      int r = 0;
      for (int i = 1; i < m; ++i) r += base[i * 2 * kLanes] <= doc ? 1 : 0;
      const int32_t* rd = base + r * 2 * kLanes;
      const int at = tantivy_port::lower_bound_shared(rd, kLanes, doc);
      ok = at < kLanes && rd[at] == doc;
      if (ok) {
        const int32_t before = at > 0 ? rd[kLanes + at - 1] : 0;
        tf = rd[kLanes + at] - before;
        pb = __ldg(blk_pos + a + r) + before;
      }
    } else {
      const long long row =
          mode == kLast
              ? a + tantivy_port::lower_bound_shared(sm.st.last + s_off[t], m,
                                                     doc)
              : tantivy_port::lower_bound4(blk_last, a, m, doc);
      int at = 0;
      ok = row < a + m &&
           tantivy_port::probe_row_at(cstore + row * kRowWords, doc, &tf,
                                      &at);
      if (ok) {
        const int32_t* rtf = cstore + row * kRowWords + kLanes;
        const int4* r4 = reinterpret_cast<const int4*>(rtf);
        int32_t sum = 0;
        int i = 0;
        for (; i + 4 <= at; i += 4) {
          const int4 v = __ldg(r4 + (i >> 2));
          sum += v.x + v.y + v.z + v.w;
        }
        for (; i < at; ++i) sum += __ldg(rtf + i);
        pb = __ldg(blk_pos + row) + sum;
      }
    }
    if (ok) {
      s_tf[t][lane] = tf;
      s_pb[t][lane] = pb;
    }
  }

  // compact the lanes every term holds
  const unsigned ok_bits = __ballot_sync(0xffffffffu, ok);
  if (wl == 0) s_held[warp] = ok_bits;
  __syncthreads();
  int n_ok = 0, at_list = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = __popc(s_held[w]);
    if (w < warp) at_list += c;
    n_ok += c;
  }
  if (ok) at_list += __popc(ok_bits & ((1u << wl) - 1u));
  if (ok) s_list[at_list] = lane;
  __syncthreads();

  // aligned matches of the leader's first min(tf, MAX_P) positions, one
  // survivor a thread
  if (lane < n_ok) {
    const int L = s_list[lane];
    const int32_t shl = s_shift[lead];
    const int jmax = min(s_tf[lead][L], kMaxP);
    const long long pl = s_pb[lead][L];
    int32_t (*lp)[kLanes] = sm.tail.lead_pos;
#pragma unroll
    for (int j = 0; j < kMaxP; ++j) {
      if (j < jmax) lp[j][lane] = load_pos(postore, n_pos, pl + j);
    }
    unsigned mask = jmax > 0 ? (1u << jmax) - 1u : 0u;
    for (int t = 0; t < T && mask != 0u; ++t) {
      if (t == lead) continue;
      const int lim = min(s_tf[t][L], pw);
      const long long pt = s_pb[t][L];
      const int32_t d = shl - s_shift[t];
      const int32_t last_target = lp[jmax - 1][lane] + d;
      unsigned mt = 0u;
      for (int c0 = 0; c0 < lim; c0 += kPosBatch) {
        int32_t v[kPosBatch];
#pragma unroll
        for (int i = 0; i < kPosBatch; ++i) {
          v[i] = c0 + i < lim ? load_pos(postore, n_pos, pt + c0 + i) : 0;
        }
        int32_t top = v[0];
#pragma unroll
        for (int i = 1; i < kPosBatch; ++i) {
          if (c0 + i < lim) top = v[i];
        }
#pragma unroll
        for (int j = 0; j < kMaxP; ++j) {
          if (j < jmax) {
            const int32_t target = lp[j][lane] + d;
            bool hit = false;
#pragma unroll
            for (int i = 0; i < kPosBatch; ++i) {
              hit = hit || (c0 + i < lim && v[i] == target);
            }
            if (hit) mt |= 1u << j;
          }
        }
        // later positions lie above every target
        if (top >= last_target) break;
      }
      mask &= mt;
    }
    const int count = __popc(mask);
    if (count > 0) {
      const float cf = (float)count;
      const float cachev = __int_as_float(__ldg(crow + 2 * kLanes + L));
      const float score = __fmul_rn(__ldg(q_weight + q),
                                    __fdiv_rn(cf, __fadd_rn(cf, cachev)));
      const int slot = atomicAdd(&n_sur, 1);
      sm.tail.c_score[slot] = score;
      sm.tail.c_flat[slot] = L;
      sm.tail.c_doc[slot] = __ldg(crow + L);
    }
  }
  __syncthreads();

  tantivy_port::write_group_topk(sm.tail.c_score, sm.tail.c_flat,
                                 sm.tail.c_doc, n_sur, kk, osc, odoc,
                                 sm.tail.topk);
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
