// Phrase (slop 0) position-probe scorer with per-group top-kk (kernel K2 of
// the port).
//
// Replaces the Pallas TPU kernel `_phrase_kernel_body` in
// tantivy_tpu/ops/pallas_phrase.py (launched by `_phrase_rows`). It computes
// the same function; like the TPU kernel it stages the positions it
// compares against in fast memory, but as per-member partner sub-ranges
// merged in shared memory instead of whole slabs compared all-pairs.
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
// Per member row: its lane docs and cachev and every partner sub-range are
// copied into shared memory with 16-byte cp.async copies (positions and
// owners are each a contiguous 512-byte half of a postore row, so the
// copies coalesce). A partner sub-range longer than its buffer slot is
// staged as a sample instead: every stride-th key, at most a slot's worth,
// by 4-byte cp.async copies. Two buffers alternate: the next member's
// copies are in flight while this member is intersected. Each thread takes
// a contiguous slice of the member's anchor positions, read once from
// device memory. An anchor position p with owner o finds o's lane by a
// binary search over the member's 128 ascending lane docs in shared memory;
// an owner that is no lane doc never counts. For each partner with
// len_s > 0 the thread merges its slice's keys (o, p + delta_s) (p +
// delta_s wraps as uint32 and is compared as int32, as the keys of the
// store are) into the partner's staged keys (o', p'), which ascend: one
// search for its first key, then a cursor that only moves forward, by
// galloping (doubling steps, then halving), so the merge is linear when
// both sides are dense and logarithmic per key when the partner is much
// denser. Against a sample, a key that falls between two sampled keys is
// looked for among the at most stride - 1 keys between them, read in order
// from device memory. A key below the previous one (an int32 overflow of
// p + delta_s) restarts the cursor at the sub-range's start, so the result
// never depends on order. A partner with len_s = 0 is satisfied. An anchor
// position whose key every checked partner holds adds one to its lane's
// integer count. A lane then scores qw[prow] * (tf / (tf + cachev)) with
// explicitly rounded f32 intrinsics when its doc is not TERMINATED, cachev
// is not NaN (deleted) and tf > 0. Survivors (score >= row_th[prow], not
// -inf) are compacted into shared memory and ranked by (score desc, flat
// index r*128 + lane asc), as in kernel K1.
//
// What bounds it on an H100: latency, on the smoke's chunks (tens of
// thousands of groups of a few hundred positions): per member one copy
// round trip, hidden by the double buffer, and three barriers; per anchor
// position a read from device memory, a search over the lane docs and a
// short gallop per partner in shared memory, and, against a sample, a scan
// of up to stride - 1 keys (the stride is 28 for the longest sub-range a
// 136-row slab allows). The kernel is compiled once per partner count S,
// so the cursors live in registers. Shared memory per CTA: 12,288 bytes of
// member buffers (dynamic; 640 partner positions per slot at S = 1) and
// 13,840 bytes of fixed arrays; registers and spills per S as ptxas
// reports them (chip_smoke.py prints them).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC (see ops/_build.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "group_topk.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = kLanes;
constexpr int kMembers = 8;
constexpr int kCand = kLanes * kMembers;
constexpr int kRowWords = 384;  // docs | tfs | bitcast(cachev)
constexpr int kPosWords = 256;  // positions | owner docs
constexpr int kMaxPartners = 7;
constexpr int kMaxStride = 256;
// bytes of dynamic shared memory that the two member buffers take
constexpr int kBufferBytes = 12 * 1024;
static_assert(sizeof(tantivy_port::TopkScratch) <= kBufferBytes,
              "the top-kk scratch outgrows the member buffers");

// Positions (of 4-aligned chunks) one buffer holds per partner, for S
// partners: each buffer holds the lane docs and cachev (256 words) and S
// partner sub-ranges of positions and owners.
__host__ __device__ constexpr int range_cap(int S) {
  return ((kBufferBytes / 8 - 2 * kLanes) / (2 * S)) & ~3;
}

__host__ __device__ constexpr int buffer_words(int S) {
  return 2 * kLanes + 2 * S * range_cap(S);
}

__host__ constexpr size_t dynamic_smem(int S) {
  return (size_t)2 * buffer_words(S) * 4;
}

// One member's cut sub-range: global position index of its first element
// and its length (0 = empty).
struct Range {
  long long g0;
  int n;
};

// Positions of the slab starting at row `row0` that a sub-range may read:
// the first `slab_rows` rows, and never past the store.
__device__ __forceinline__ int window(long long row0, int slab_rows,
                                      long long n_pos_rows) {
  const long long rows_left = n_pos_rows - row0;
  const long long rows = rows_left < slab_rows ? rows_left : slab_rows;
  return rows > 0 ? (int)(rows * kLanes) : 0;
}

// The sub-range [off, off + len) of the slab at `row0`, cut to its window.
__device__ __forceinline__ Range cut(long long row0, int off, int len,
                                     int slab_rows, long long n_pos_rows) {
  const int lim = window(row0, slab_rows, n_pos_rows);
  const int lo = off > 0 ? off : 0;
  const long long end_l = (long long)off + len;
  const int end = end_l < lim ? (int)end_l : lim;
  Range out;
  out.g0 = row0 * kLanes + lo;
  out.n = (len > 0 && end > lo) ? end - lo : 0;
  return out;
}

// Slots a range takes once its copy is widened to whole 16-byte chunks.
__device__ __forceinline__ int span(long long g0, int n) {
  return n > 0 ? (int)((((g0 + n + 3) >> 2) - (g0 >> 2)) << 2) : 0;
}

// Total order of the store's (owner, position) keys: int32 owner, then
// int32 position.
__device__ __forceinline__ long long key(int32_t owner, int32_t pos) {
  return (long long)owner * 4294967296LL + (long long)pos;
}

__device__ __forceinline__ int32_t shifted(int32_t pos, int32_t delta) {
  return (int32_t)((uint32_t)pos + (uint32_t)delta);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies positions and owners of global positions [g0, g0 + n), widened to
// whole 4-position chunks, into pos/own: position g lands at slot
// g - (g0 & ~3). 4-position chunks never straddle a postore row.
__device__ __forceinline__ void stage_range(const int32_t* __restrict__ postore,
                                            long long g0, int n, int32_t* pos,
                                            int32_t* own) {
  if (n <= 0) return;
  const long long c0 = g0 >> 2;
  const int chunks = (int)(((g0 + n + 3) >> 2) - c0);
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const long long g = (c0 + c) << 2;
    const int32_t* src = postore + (g >> 7) * kPosWords + (g & 127);
    cp_async16(pos + 4 * c, src);
    cp_async16(own + 4 * c, src + kLanes);
  }
}

// Position and owner of the global position index `g`.
__device__ __forceinline__ void read_pos(const int32_t* __restrict__ postore,
                                         long long g, int32_t* pos,
                                         int32_t* owner) {
  const int32_t* row = postore + (g >> 7) * kPosWords;
  const int c = (int)(g & 127);
  *pos = __ldg(row + c);
  *owner = __ldg(row + kLanes + c);
}

// Lane of `owner` among the member's 128 ascending lane docs, or -1.
__device__ __forceinline__ int lane_of(const int32_t* docs, int32_t owner) {
  int lo = 0;
  int hi = kLanes;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (docs[mid] < owner) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (lo < kLanes && docs[lo] == owner) ? lo : -1;
}

// First index in [from, m) of the ascending staged keys whose key is >= k,
// given that every key before `from` is < k: doubling steps from `from`,
// then halving.
__device__ __forceinline__ int gallop(const int32_t* bpos, const int32_t* bown,
                                      int m, int from, long long k) {
  int lo = from;
  int hi = from;
  int step = 1;
  while (hi < m && key(bown[hi], bpos[hi]) < k) {
    lo = hi + 1;
    hi += step;
    step <<= 1;
  }
  if (hi > m) hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key(bown[mid], bpos[mid]) < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The stride of a partner sub-range of n positions in a buffer slot of
// cap positions: 1 when the whole sub-range, widened to 16-byte chunks,
// fits, else the step of a sample of at most cap keys (at least 2).
__device__ __forceinline__ int sample_stride(long long g0, int n, int cap) {
  if (span(g0, n) <= cap) return 1;
  const int stride = (n + cap - 1) / cap;
  return stride > 2 ? stride : 2;
}

// One partner's staged keys, seen by one thread's merge: `at` is the
// cursor, `last` the key it last looked up. With stride 1 the staged keys
// are the whole sub-range; with a larger stride, key q is the sub-range's
// key q * stride, and a key between two samples is looked for among the
// at most stride - 1 keys between them, read from device memory.
struct Cursor {
  const int32_t* pos;
  const int32_t* own;
  int m;
  int at;
  long long last;

  __device__ void reset(const int32_t* p, const int32_t* o, int n) {
    pos = p;
    own = o;
    m = n;
    at = 0;
    last = 0;
  }
  // True when the partner sub-range [g0, g0 + n) holds k; keys may come in
  // any order, the cursor moving forward while they ascend.
  __device__ bool holds(long long k, int stride,
                        const int32_t* __restrict__ postore, long long g0,
                        int n) {
    at = gallop(pos, own, m, (at > 0 && k >= last) ? at : 0, k);
    last = k;
    if (at < m && key(own[at], pos[at]) == k) return true;
    if (stride == 1 || at == 0) return false;
    // sample at - 1 < k < sample at (or the sub-range's end)
    const long long j0 = (long long)(at - 1) * stride;
    const long long j1 = j0 + stride < n ? j0 + stride : n;
    for (long long j = j0 + 1; j < j1; ++j) {
      int32_t p, o;
      read_pos(postore, g0 + j, &p, &o);
      const long long kj = key(o, p);
      if (kj >= k) return kj == k;
    }
    return false;
  }
};

// Member buffer views: lane docs, cachev bits, then S partner sub-ranges of
// positions and owners.
struct Buffer {
  int32_t* docs;
  int32_t* cachev;
  int32_t* base;
  int cap;
  __device__ int32_t* pos(int s) const { return base + 2 * s * cap; }
  __device__ int32_t* own(int s) const { return base + (2 * s + 1) * cap; }
};

__device__ __forceinline__ Buffer buffer_at(int32_t* smem, int b, int S) {
  Buffer buf;
  buf.cap = range_cap(S);
  buf.docs = smem + b * buffer_words(S);
  buf.cachev = buf.docs + kLanes;
  buf.base = buf.cachev + kLanes;
  return buf;
}

// Scalar-row view of one group and its members' cut sub-ranges.
struct Group {
  const int32_t* s_row;
  int S;
  int A;
  int slab_rows;
  long long n_pos_rows;

  __device__ Range anchor(int r) const {
    return cut(s_row[3], s_row[A + r], s_row[A + kMembers + r], slab_rows,
               n_pos_rows);
  }
  // len_s > 0: the partner must hold the anchor's key
  __device__ bool checks(int r, int s) const {
    return s_row[A + 24 + 16 * s + r] > 0;
  }
  __device__ Range partner(int r, int s) const {
    return cut(s_row[4 + 2 * s], s_row[A + 16 + 16 * s + r],
               s_row[A + 24 + 16 * s + r], slab_rows, n_pos_rows);
  }
  __device__ int32_t delta(int s) const { return s_row[5 + 2 * s]; }
};

// Issues member r's copies into `buf`: its lane docs and cachev, and per
// checked partner its whole sub-range (16-byte copies) or, past the slot, a
// sample of every stride-th key (4-byte copies). Commits one copy group.
__device__ void stage_member(const Group& grp, int r, long long lrow,
                             const int32_t* __restrict__ cstore,
                             const int32_t* __restrict__ postore,
                             const Buffer& buf) {
  const int32_t* crow = cstore + lrow * kRowWords;
  const int t = threadIdx.x;
  if (t < kLanes / 4) {
    cp_async16(buf.docs + 4 * t, crow + 4 * t);
  } else if (t < kLanes / 2) {
    const int c = t - kLanes / 4;
    cp_async16(buf.cachev + 4 * c, crow + 2 * kLanes + 4 * c);
  }
  for (int s = 0; s < grp.S; ++s) {
    if (!grp.checks(r, s)) continue;
    const Range p = grp.partner(r, s);
    const int stride = sample_stride(p.g0, p.n, buf.cap);
    if (stride == 1) {
      stage_range(postore, p.g0, p.n, buf.pos(s), buf.own(s));
      continue;
    }
    const int q_n = (p.n + stride - 1) / stride;
    for (int q = t; q < q_n; q += kThreads) {
      const long long g = p.g0 + (long long)q * stride;
      const int32_t* src = postore + (g >> 7) * kPosWords + (g & 127);
      cp_async4(buf.pos(s) + q, src);
      cp_async4(buf.own(s) + q, src + kLanes);
    }
  }
  cp_async_commit();
}

// This thread's contiguous slice [*lo, *hi) of n anchor positions.
__device__ __forceinline__ void my_slice(int n, int* lo, int* hi) {
  const int per = (n + kThreads - 1) / kThreads;
  *lo = min((int)threadIdx.x * per, n);
  *hi = min(*lo + per, n);
}

// Member r with every checked partner sub-range, or its sample, staged in
// `buf`: each thread merges its anchor slice into the partners and counts.
// Ends with a barrier.
template <int S>
__device__ void member(const Group& grp, int r, const Buffer& buf,
                       const int32_t* __restrict__ postore, int* s_cnt) {
  const Range a = grp.anchor(r);
  Cursor cur[S];
  Range part[S];
  int stride[S];
  bool check[S];
  int32_t delta[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    part[s] = grp.partner(r, s);
    stride[s] = sample_stride(part[s].g0, part[s].n, buf.cap);
    const int at = stride[s] == 1 ? (int)(part[s].g0 & 3) : 0;
    cur[s].reset(buf.pos(s) + at, buf.own(s) + at,
                 (part[s].n + stride[s] - 1) / stride[s]);
    check[s] = grp.checks(r, s);
    delta[s] = grp.delta(s);
  }
  int lo, hi;
  my_slice(a.n, &lo, &hi);
  for (int e = lo; e < hi; ++e) {
    int32_t pos, owner;
    read_pos(postore, a.g0 + e, &pos, &owner);
    const int lane = lane_of(buf.docs, owner);
    if (lane < 0) continue;
    bool all = true;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // an empty partner is satisfied
      if (all && check[s]) {
        all = cur[s].holds(key(owner, shifted(pos, delta[s])), stride[s],
                           postore, part[s].g0, part[s].n);
      }
    }
    if (all) atomicAdd(&s_cnt[lane], 1);
  }
  __syncthreads();
}

template <int S>
__global__ void __launch_bounds__(kThreads) phrase_probe_kernel(
    const int32_t* __restrict__ rows, int stride, int slab_rows, const float* __restrict__ qw,
    const float* __restrict__ row_th, int num_prows,
    const int32_t* __restrict__ cstore, long long n_store_rows,
    const int32_t* __restrict__ postore, long long n_pos_rows, int kk,
    float* __restrict__ out_scores, int32_t* __restrict__ out_docs) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int32_t s_row[kMaxStride];
  __shared__ int s_cnt[kLanes];
  __shared__ float c_score[kCand];
  __shared__ int32_t c_flat[kCand];
  __shared__ int32_t c_doc[kCand];
  __shared__ int n_sur;

  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int32_t* grow = rows + (long long)g * stride;
  for (int i = t; i < stride; i += kThreads) s_row[i] = grow[i];
  s_cnt[t] = 0;
  if (t == 0) n_sur = 0;
  __syncthreads();

  Group grp;
  grp.s_row = s_row;
  grp.S = S;
  grp.A = 4 + 2 * S;
  grp.slab_rows = slab_rows;
  grp.n_pos_rows = n_pos_rows;

  const int32_t row_base = s_row[0];
  const int32_t prow = s_row[1];
  const int32_t mask = s_row[2];
  // fully-masked groups are padding; rows past num_prows report nothing
  const bool live = mask != 0 && prow >= 0 && prow < num_prows;

  // the member rows still to stage, one bit each
  unsigned todo = 0;
  if (live) {
    for (int r = 0; r < kMembers; ++r) {
      const long long lrow = (long long)row_base + r;
      if (((mask >> r) & 1) && lrow >= 0 && lrow < n_store_rows) {
        todo |= 1u << r;
      }
    }
  }
  if (todo != 0) {
    const float w = qw[prow];
    const float th = row_th[prow];
    int r = __ffs(todo) - 1;
    todo &= todo - 1;
    int b = 0;
    stage_member(grp, r, (long long)row_base + r, cstore, postore,
                 buffer_at(smem, b, S));
    while (true) {
      // the next member's copies fly while this member is intersected
      const int rn = todo != 0 ? __ffs(todo) - 1 : -1;
      if (rn >= 0) {
        todo &= todo - 1;
        stage_member(grp, rn, (long long)row_base + rn, cstore, postore,
                     buffer_at(smem, b ^ 1, S));
      } else {
        cp_async_commit();
      }
      cp_async_wait<1>();
      __syncthreads();
      const Buffer buf = buffer_at(smem, b, S);
      member<S>(grp, r, buf, postore, s_cnt);

      const int32_t doc = buf.docs[t];
      const float cachev = __int_as_float(buf.cachev[t]);
      const int cnt = s_cnt[t];
      s_cnt[t] = 0;
      if (doc != tantivy_port::kTerminatedDoc && !isnan(cachev) && cnt > 0) {
        const float tf = (float)cnt;
        const float score = __fmul_rn(w, __fdiv_rn(tf, __fadd_rn(tf, cachev)));
        if (score >= th && score != -INFINITY) {
          const int slot = atomicAdd(&n_sur, 1);
          c_score[slot] = score;
          c_flat[slot] = r * kLanes + t;
          c_doc[slot] = doc;
        }
      }
      // this buffer takes the member after next
      __syncthreads();
      if (rn < 0) break;
      r = rn;
      b ^= 1;
    }
  }
  __syncthreads();

  // the member buffers, every copy into them done, lend the top-kk its
  // scratch
  tantivy_port::write_group_topk(
      c_score, c_flat, c_doc, n_sur, kk, out_scores + (long long)g * kk,
      out_docs + (long long)g * kk,
      *reinterpret_cast<tantivy_port::TopkScratch*>(smem));
}

// One launch for S partners: the kernel is compiled per partner count, so
// each thread's merge cursors live in registers.
template <int S>
cudaError_t launch(const void* rows, int n_groups, int stride, int slab_rows,
                   const void* qw, const void* row_th, int num_prows,
                   const void* cstore, long long n_store_rows,
                   const void* postore, long long n_pos_rows, int kk,
                   void* out_scores, void* out_docs, cudaStream_t stream) {
  // the member buffers' dynamic shared memory, allowed once
  static const cudaError_t allowed = cudaFuncSetAttribute(
      phrase_probe_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dynamic_smem(S));
  if (allowed != cudaSuccess) return allowed;
  if (n_groups > 0) {
    phrase_probe_kernel<S><<<n_groups, kThreads, dynamic_smem(S), stream>>>(
        (const int32_t*)rows, stride, slab_rows, (const float*)qw,
        (const float*)row_th, num_prows, (const int32_t*)cstore,
        n_store_rows, (const int32_t*)postore, n_pos_rows, kk,
        (float*)out_scores, (int32_t*)out_docs);
  }
  return cudaGetLastError();
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
      kk > kLanes || ((uintptr_t)cstore & 15) != 0 ||
      ((uintptr_t)postore & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
#define PHRASE_PROBE_LAUNCH(S)                                              \
  case S:                                                                  \
    return (int)launch<S>(rows, n_groups, stride, slab_rows, qw, row_th,   \
                          num_prows, cstore, n_store_rows, postore,        \
                          n_pos_rows, kk, out_scores, out_docs, st);
  switch (n_partners) {
    PHRASE_PROBE_LAUNCH(1)
    PHRASE_PROBE_LAUNCH(2)
    PHRASE_PROBE_LAUNCH(3)
    PHRASE_PROBE_LAUNCH(4)
    PHRASE_PROBE_LAUNCH(5)
    PHRASE_PROBE_LAUNCH(6)
    PHRASE_PROBE_LAUNCH(7)
  }
#undef PHRASE_PROBE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

namespace {

template <int S>
int occupancy(int* threads, int* smem_bytes, int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, phrase_probe_kernel<S>);
  if (err != cudaSuccess) return (int)err;
  *threads = kThreads;
  *smem_bytes = (int)(attr.sharedSizeBytes + dynamic_smem(S));
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, phrase_probe_kernel<S>, kThreads, dynamic_smem(S));
}

}  // namespace

// Threads, shared memory per CTA (static and dynamic) and CTAs resident per
// SM of the kernel for `n_partners` on the current device; returns a CUDA
// error code.
extern "C" int phrase_probe_occupancy(int n_partners, int* threads,
                                      int* smem_bytes, int* ctas_per_sm) {
  switch (n_partners) {
    case 1: return occupancy<1>(threads, smem_bytes, ctas_per_sm);
    case 2: return occupancy<2>(threads, smem_bytes, ctas_per_sm);
    case 3: return occupancy<3>(threads, smem_bytes, ctas_per_sm);
    case 4: return occupancy<4>(threads, smem_bytes, ctas_per_sm);
    case 5: return occupancy<5>(threads, smem_bytes, ctas_per_sm);
    case 6: return occupancy<6>(threads, smem_bytes, ctas_per_sm);
    case 7: return occupancy<7>(threads, smem_bytes, ctas_per_sm);
  }
  return (int)cudaErrorInvalidValue;
}
