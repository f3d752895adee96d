// Hybrid search's device programs for Hopper (sm_90a): B6a, the segmented
// BM25F scatter + masked top-k, and B6b, the hybrid fusion top-k.
//
// Neither replaces a TPU kernel: the JAX package runs both as jitted XLA
// programs (weaviate_tpu/ops/sparse.py:82 sparse_score_topk, :98
// sparse_score_topk_min_match; weaviate_tpu/ops/fusion.py:75
// ranked_fusion_topk, :90 relative_score_fusion_topk). They are written by
// hand here because each ends in a selection, and because the plain PyTorch
// versions sum with float atomics on the card, whose order changes from
// run to run: two identical requests could then page near-ties in another
// order. Both kernels sum in the plain version's CPU order (entry order)
// with no float atomics, and round each operation as the plain version
// does (__fmul_rn / __fadd_rn / __fdiv_rn keep nvcc from contracting to
// FMA), so two launches on the same inputs give the same bits.
//
// Both are bound by bytes (a few a posting entry or fusion slot), and both
// read so few that a call is its launch and its serial steps: what the
// design cuts is barriers, passes and launches, not bytes.
//
// B6a (sparse_topk_kernel). The entries are rows, tf and doc length each;
// the weight (boost x idf), avgdl and min-match group are the segment's
// (one segment a (property, term) posting list, its rows ascending and
// unique). A CTA owns `range` doc ids: a power of two from kSparseMinRange
// to kSparseMaxRange that gives a launch about kSparseCtas CTAs. A warp
// finds the CTA's range in a segment (32 probes a round), then the
// segments are walked in order, a thread an entry adding its contribution
// to its doc's sum in shared memory (no two threads share a doc within a
// segment; a barrier separates segments; a thread reads its first entry
// of kSegBatch segments before any is added), so a doc's sum is taken in
// entry order. A
// minimum-match query also ORs each segment's group bit into its docs'
// 64-bit masks, 64 groups a pass (a pass past the first walks only its
// groups' segments), and adds the masks' popcounts: any number of groups.
// The kept docs (touched, allowed, matched) are compacted as 64-bit keys
// (descending score, then ascending doc id: distinct), and the CTA writes
// its k best, in no order: up to kRankMax kept keys each find their rank
// by counting the keys below them, more go through select_k, a radix
// select over the bytes the keys do not share. The last CTA to finish (a
// ticket that resets itself) selects the k best of the m x k partial keys
// in one select_k (staged in shared memory by cp.async where they fit,
// read from L2 where not), and ranks the k survivors by counting: no sort
// of every kept doc, no pairwise merge rounds, one launch and no memset.
//
// B6b (fusion_small_kernel, fusion_topk_kernel). The widths hybrid search
// serves (up to kFusionSmallLegs legs of up to kFusionSmallLen, a union of
// up to kFusionSmallUnion slots, k up to kFusionSmallK) take the small
// path: a warp a leg holds the leg in registers (two entries a lane), its
// min and max by warp reductions; a leg's repeated slots are found by
// __match_any_sync, 32 positions at a time, and the lowest-position lane
// of each run adds the run's contributions in position order, legs in
// order, so the sums are taken in (leg, position) order; the slots present
// are sorted by the 64-bit key in registers by a warp-level bitonic of up
// to 128 keys. Wider shapes take the general path: one CTA a request, each
// leg's entries sorted by (slot, position) so that each run's head adds
// the run in order, the present slots compacted and sorted by the same
// key; a union (or a leg list) too large for shared memory is kept in the
// caller's scratch in device memory.
//
// Every entry point returns 0, a negative code for arguments it refuses, or
// a positive code for a failed launch (hybrid_error_string names each).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// B6a: the doc ids a CTA owns (a power of two in [min, max]), the CTAs a
// launch aims at, threads a CTA, kept keys ranked by counting (ranking up
// to 512 took phase hybrid's widest leg 0.0126 ms a launch on an H100,
// 0.0136 at 128 and 0.0169 at 32; equal at 550,000 docs), and the bytes
// the merge may stage its partial lists in (the widest range's scoring
// area: staging never costs a CTA of occupancy)
constexpr int kSparseMinRange = 512;
constexpr int kSparseMaxRange = 4096;
constexpr int kSparseCtas = 128;
constexpr int kSparseThreads = 512;
constexpr int kRankMax = 512;
constexpr int kSparseStage = 69632;
// B6b: the general path's threads and the widest union it holds in smem;
// the small path's bounds (legs, leg length, union, k)
constexpr int kFusionThreads = 512;
constexpr int kFusionSmem = 196608;
constexpr int kFusionSmallLegs = 2;
constexpr int kFusionSmallLen = 64;
constexpr int kFusionSmallUnion = 1024;
constexpr int kFusionSmallK = 64;
constexpr int kSparseWarps = kSparseThreads / 32;
// keys a thread has in flight in a pass over device memory
constexpr int kBatch = 8;
// segments whose first entries a thread reads at once
constexpr int kSegBatch = 4;
constexpr int kBins = 256;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kNone = ~0ull;

enum Err {
  kOk = 0,
  kBadShape = -1,
  kBadK = -2,
  kBadGroups = -3,
  kBadScratch = -4,
  kLaunch = 1,
  kAttr = 2,
};

// an ascending key of (descending score, ascending id)
__device__ __forceinline__ unsigned long long sort_key(float s, unsigned id) {
  if (s == 0.f) s = 0.f;  // -0 ranks as +0
  const unsigned u = __float_as_uint(s);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(~ord) << 32) | id;
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const unsigned ord = ~static_cast<unsigned>(key >> 32);
  const unsigned u = (ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord;
  return __uint_as_float(u);
}

__device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// ascending bitonic sort of a[0, n) by the whole block; n a power of two.
// The caller synchronises before; the sort ends synchronised.
__device__ void bitonic_sort(unsigned long long* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int pos = 2 * i - (i & (stride - 1));
        const int partner = pos + stride;
        const bool up = (pos & size) == 0;
        const unsigned long long x = a[pos], y = a[partner];
        if ((x > y) == up) {
          a[pos] = y;
          a[partner] = x;
        }
      }
      __syncthreads();
    }
  }
}

// first index in [lo, hi) of ascending a whose value is >= v (hi where
// none), by one warp: each round 32 probes cut the range 32-fold, so a
// posting list of n takes log32(n) dependent reads, not log2(n)
__device__ __forceinline__ int warp_lower_bound(const int* a, int lo, int hi,
                                                int v) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {  // the answer lies in [lo, hi]
    const int step = (hi - lo + 31) / 32;
    const int at = lo + lane * step;
    const unsigned below = __ballot_sync(kFull, at < hi && __ldg(a + at) < v);
    const int c = __popc(below);  // the probes below v: lanes 0 .. c - 1
    if (c == 0) return lo;
    hi = min(hi, lo + c * step);
    lo += (c - 1) * step + 1;
  }
  return lo;
}

__device__ __forceinline__ float entry_score(float tf, float dl, float w,
                                             float avgdl, float k1,
                                             float c1mb, float cb,
                                             float k1p1) {
  // denom = tf + k1 * ((1 - b) + b * dl / max(avgdl, 1e-9))
  float x = __fdiv_rn(__fmul_rn(cb, dl), fmaxf(avgdl, 1e-9f));
  x = __fadd_rn(c1mb, x);
  const float denom = __fadd_rn(tf, __fmul_rn(k1, x));
  // w * tf * (k1 + 1) / max(denom, 1e-9)
  return __fdiv_rn(__fmul_rn(__fmul_rn(w, tf), k1p1), fmaxf(denom, 1e-9f));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// -- the selection ------------------------------------------------------------

// A B6a CTA's shared state for select_k and the block reductions.
struct SelectSmem {
  int hist[kBins];
  unsigned long long w_or[kSparseWarps], w_and[kSparseWarps];
  int w_cnt[kSparseWarps];
  int pick[3];
  int n;
};

// f(key) for every key of a[0, n) (kNone past n: a warp's lanes stay
// together), the whole block at once; from device memory (GLOBAL, written
// by other CTAs: read from L2) kBatch keys a thread are loaded before any
// is used, so their latencies overlap.
template <bool GLOBAL, class F>
__device__ __forceinline__ void for_keys(const unsigned long long* a, int n,
                                         F f) {
  constexpr int U = GLOBAL ? kBatch : 1;
  for (int base = 0; base < n; base += U * kSparseThreads) {
    unsigned long long x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * kSparseThreads + threadIdx.x;
      x[u] = i < n ? (GLOBAL ? __ldcg(a + i) : a[i]) : kNone;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) f(x[u]);
  }
}

// The OR and AND of the block's live keys and their count, in every
// thread. Begins and ends synchronised.
__device__ void reduce_keys(unsigned long long& orv, unsigned long long& andv,
                            int& live, SelectSmem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned oh = __reduce_or_sync(kFull, static_cast<unsigned>(orv >> 32));
  const unsigned ol = __reduce_or_sync(kFull, static_cast<unsigned>(orv));
  const unsigned ah = __reduce_and_sync(kFull,
                                        static_cast<unsigned>(andv >> 32));
  const unsigned al = __reduce_and_sync(kFull, static_cast<unsigned>(andv));
  const int c = __reduce_add_sync(kFull, live);
  if (lane == 0) {
    s.w_or[warp] = (static_cast<unsigned long long>(oh) << 32) | ol;
    s.w_and[warp] = (static_cast<unsigned long long>(ah) << 32) | al;
    s.w_cnt[warp] = c;
  }
  __syncthreads();
  orv = 0;
  andv = kNone;
  live = 0;
#pragma unroll
  for (int w = 0; w < kSparseWarps; ++w) {
    orv |= s.w_or[w];
    andv &= s.w_and[w];
    live += s.w_cnt[w];
  }
  __syncthreads();
}

// The k smallest of the keys a[0, n) (distinct; kNone is no key) into
// out[0, min(k, live)), in no order; returns how many. A radix select:
// only the bytes the live keys do not all share are counted, from the
// highest, each pass a histogram (a shared atomic a key: adding a warp's
// equal digits once by `__match_any_sync` was slower, 0.084 against 0.041
// ms a launch at 550,000 docs and k 100 on an H100) of the keys that agree
// with the digits chosen so far, until the k-th key's bin is taken whole;
// then the keys at or below its prefix are collected. Every thread calls
// it; it begins and ends synchronised.
template <bool GLOBAL>
__device__ int select_k(const unsigned long long* a, int n, int k,
                        unsigned long long* out, SelectSmem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long orv = 0, andv = kNone;
  int live = 0;
  for_keys<GLOBAL>(a, n, [&](unsigned long long x) {
    if (x != kNone) {
      orv |= x;
      andv &= x;
      ++live;
    }
  });
  reduce_keys(orv, andv, live, s);
  unsigned long long limit = kNone - 1;  // every live key
  if (live > k) {
    const unsigned long long diff = orv ^ andv;
    unsigned long long pk = andv;  // the digits chosen so far
    int need = k;
    int shift = (63 - __clzll(diff)) & ~7;
    for (;;) {
      for (int i = tid; i < kBins; i += kSparseThreads) s.hist[i] = 0;
      __syncthreads();
      const unsigned long long hm = shift >= 56 ? 0ull : kNone << (shift + 8);
      const unsigned long long hv = pk & hm;
      for_keys<GLOBAL>(a, n, [&](unsigned long long x) {
        if (x != kNone && (x & hm) == hv)
          atomicAdd(&s.hist[static_cast<unsigned>(x >> shift) & 255u], 1);
      });
      __syncthreads();
      if (warp == 0) {  // the bin where the count reaches need
        int c[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[j] = s.hist[lane * 8 + j];
          sum += c[j];
        }
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        int before = incl - sum;
        if (before < need && need <= incl) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (before < need && need <= before + c[j]) {
              s.pick[0] = lane * 8 + j;
              s.pick[1] = need - before;
              s.pick[2] = c[j];
            }
            before += c[j];
          }
        }
      }
      __syncthreads();
      const int digit = s.pick[0];
      need = s.pick[1];
      pk = (pk & ~(0xFFull << shift)) |
           (static_cast<unsigned long long>(digit) << shift);
      if (s.pick[2] == need) {  // the k-th key's bin is taken whole
        limit = pk | (shift ? (1ull << shift) - 1 : 0ull);
        break;
      }
      // more than one key shares the prefix: they differ below it
      shift = (63 - __clzll(diff & ((1ull << shift) - 1))) & ~7;
    }
  }
  if (tid == 0) s.n = 0;
  __syncthreads();
  for_keys<GLOBAL>(a, n, [&](unsigned long long x) {
    const bool take = x != kNone && x <= limit;
    const unsigned bal = __ballot_sync(kFull, take);
    int base = 0;
    if (lane == 0 && bal) base = atomicAdd(&s.n, __popc(bal));
    base = __shfl_sync(kFull, base, 0);
    if (take) out[base + __popc(bal & ((1u << lane) - 1))] = x;
  });
  __syncthreads();
  return min(live, k);
}

// The rank of `mine` among keys[0, n) (the keys below it), n even or odd;
// keys 16-byte aligned. kNone ranks after every key.
__device__ __forceinline__ int rank_of(const unsigned long long* keys, int n,
                                       unsigned long long mine) {
  int r = 0;
  const ulonglong2* k2 = reinterpret_cast<const ulonglong2*>(keys);
#pragma unroll 4
  for (int j = 0; j < n / 2; ++j) {
    const ulonglong2 v = k2[j];
    r += (v.x < mine) + (v.y < mine);
  }
  if (n & 1) r += keys[n - 1] < mine;
  return r;
}

// -- B6a ----------------------------------------------------------------------

struct SparseArgs {
  const int* rows;             // [P] doc-sorted within each segment
  const float* tf;             // [P]
  const float* dl;             // [P]
  const int* seg;              // [n_seg + 1] segment boundaries
  const float* seg_w;          // [n_seg]
  const float* seg_avgdl;      // [n_seg]
  const int* seg_grp;          // [n_seg]; null: no minimum match
  int n_seg;
  const unsigned char* allow;  // [space]
  int space, range;
  float k1, c1mb, cb, k1p1;
  int n_groups, min_match, k;
  unsigned long long* scratch;  // [(gridDim.x + 1) * k] partials, survivors
  unsigned* ticket;             // 0 at launch; the last CTA leaves it 0
  float* out_vals;
  int* out_ids;
  int staged;     // the merge stages the partials (and survivors) in smem
  int surv_smem;  // the merge's survivors fit in smem
};

// a CTA's scoring area: group masks / kept keys, sums, matched-group
// counts, touched flags
__host__ __device__ constexpr int sparse_score_smem(int range) {
  return range * (8 + 4 + 4 + 1);
}

// segment s is walked in pass `pass`: every segment in the first (the
// sums), only those of the pass's 64 groups in a min-match pass after it
__device__ __forceinline__ bool seg_in_pass(const SparseArgs& p, int s,
                                            int pass) {
  if (pass == 0) return true;
  const int g = p.seg_grp[s];
  return g >= pass * 64 && g < pass * 64 + 64 && g < p.n_groups;
}

// one entry of doc d (of the CTA's range): its contribution c into the
// doc's sum in the first pass, and its group bit g (of the pass's 64; out
// of range: none) into the doc's mask
__device__ __forceinline__ void add_entry(const SparseArgs& p, float* acc,
                                          unsigned char* touched,
                                          unsigned long long* work, int d,
                                          float c, int g, int pass) {
  if (pass == 0) {
    acc[d] = __fadd_rn(acc[d], c);
    touched[d] = 1;
  }
  if (g >= 0 && g < 64 && g + pass * 64 < p.n_groups) work[d] |= 1ull << g;
}

__global__ void __launch_bounds__(kSparseThreads, 2)
sparse_topk_kernel(SparseArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = p.range;
  unsigned long long* work = reinterpret_cast<unsigned long long*>(smem);
  float* acc = reinterpret_cast<float*>(work + R);
  int* cnt = reinterpret_cast<int*>(acc + R);
  unsigned char* touched = reinterpret_cast<unsigned char*>(cnt + R);
  __shared__ int s_from[kSparseThreads], s_to[kSparseThreads];
  __shared__ int s_count;
  __shared__ int s_last;
  __shared__ SelectSmem ss;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = blockIdx.x * R;
  const int n = min(R, p.space - lo);
  const bool mm = p.seg_grp != nullptr;
  for (int i = tid; i < R; i += kSparseThreads) {
    acc[i] = 0.f;
    cnt[i] = 0;
    touched[i] = 0;
    work[i] = 0;
  }
  if (tid == 0) s_count = 0;
  __syncthreads();

  const int passes = mm ? (p.n_groups + 63) / 64 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    for (int s0 = 0; s0 < p.n_seg; s0 += kSparseThreads) {
      const int s1 = min(p.n_seg, s0 + kSparseThreads);
      // each segment's entries in the range: a warp a segment
      for (int s = s0 + warp; s < s1; s += kSparseWarps) {
        const int a = p.seg[s], b = p.seg[s + 1];
        const int from = warp_lower_bound(p.rows, a, b, lo);
        const int to = warp_lower_bound(p.rows, from, b, lo + n);
        if (lane == 0) {
          s_from[s - s0] = from;
          s_to[s - s0] = to;
        }
      }
      __syncthreads();
      for (int b0 = s0; b0 < s1; b0 += kSegBatch) {
        // a thread's first entry of kSegBatch segments, read at once ...
        int d[kSegBatch];
        float c[kSegBatch];
#pragma unroll
        for (int j = 0; j < kSegBatch; ++j) {
          const int s = b0 + j;
          d[j] = -1;
          c[j] = 0.f;
          if (s >= s1 || !seg_in_pass(p, s, pass)) continue;
          const int e = s_from[s - s0] + tid;
          if (e >= s_to[s - s0]) continue;
          d[j] = p.rows[e] - lo;
          if (pass == 0)
            c[j] = entry_score(p.tf[e], p.dl[e], p.seg_w[s], p.seg_avgdl[s],
                               p.k1, p.c1mb, p.cb, p.k1p1);
        }
        // ... then added segment after segment (a barrier between)
#pragma unroll
        for (int j = 0; j < kSegBatch; ++j) {
          const int s = b0 + j;
          if (s >= s1 || !seg_in_pass(p, s, pass)) continue;  // uniform
          const int g = mm ? p.seg_grp[s] - pass * 64 : -1;
          if (d[j] >= 0) add_entry(p, acc, touched, work, d[j], c[j], g, pass);
          const int to = s_to[s - s0];
          for (int e = s_from[s - s0] + tid + kSparseThreads; e < to;
               e += kSparseThreads)
            add_entry(p, acc, touched, work, p.rows[e] - lo,
                      pass == 0 ? entry_score(p.tf[e], p.dl[e], p.seg_w[s],
                                              p.seg_avgdl[s], p.k1, p.c1mb,
                                              p.cb, p.k1p1)
                                : 0.f,
                      g, pass);
          __syncthreads();
        }
      }
      __syncthreads();  // s_from / s_to are read before the next chunk
    }
    if (mm) {
      for (int i = tid; i < R; i += kSparseThreads) {
        cnt[i] += __popcll(work[i]);
        work[i] = 0;
      }
      __syncthreads();
    }
  }

  // the kept docs' keys, compacted (a warp's in one shared atomic)
  for (int i0 = warp * 32; i0 < n; i0 += kSparseThreads) {
    const int i = i0 + lane;
    const bool keep = i < n && touched[i] && p.allow[lo + i] &&
                      (!mm || cnt[i] >= p.min_match);
    const unsigned bal = __ballot_sync(kFull, keep);
    int base = 0;
    if (lane == 0 && bal) base = atomicAdd(&s_count, __popc(bal));
    base = __shfl_sync(kFull, base, 0);
    if (keep)
      work[base + __popc(bal & ((1u << lane) - 1))] =
          sort_key(acc[i], static_cast<unsigned>(lo + i));
  }
  __syncthreads();
  const int c = s_count;
  // the CTA's k best keys, in no order, then kNone
  unsigned long long* part = p.scratch + static_cast<size_t>(blockIdx.x) * p.k;
  int taken;
  if (c <= kRankMax) {
    if (tid < c) {
      const unsigned long long mine = work[tid];
      const int r = rank_of(work, c, mine);
      if (r < p.k) part[r] = mine;
    }
    taken = min(c, p.k);
  } else {
    taken = select_k<false>(work, c, p.k, part, ss);
  }
  for (int j = taken + tid; j < p.k; j += kSparseThreads) part[j] = kNone;

  // the last CTA to finish selects from every CTA's list
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicInc(p.ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int total = static_cast<int>(gridDim.x) * p.k;
  unsigned long long* stage = work;
  unsigned long long* surv =
      p.staged ? stage + ((total + 1) & ~1)
               : (p.surv_smem ? work : p.scratch + total);
  int live;
  if (p.staged) {
    for (int i = 2 * tid; i < total; i += 2 * kSparseThreads) {
      if (i + 1 < total) cp_async16(stage + i, p.scratch + i);
      else stage[i] = __ldcg(p.scratch + i);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (total <= kRankMax) {  // every partial key ranked by counting
      const unsigned long long mine = tid < total ? stage[tid] : kNone;
      live = __syncthreads_count(mine != kNone);
      if (mine != kNone) {
        const int r = rank_of(stage, total, mine);
        if (r < p.k) {
          p.out_vals[r] = key_score(mine);
          p.out_ids[r] = static_cast<int>(mine & 0xFFFFFFFFu);
        }
      }
      for (int j = min(live, p.k) + tid; j < p.k; j += kSparseThreads) {
        p.out_vals[j] = 0.f;
        p.out_ids[j] = -1;
      }
      return;
    }
    live = select_k<false>(stage, total, p.k, surv, ss);
  } else {
    live = select_k<true>(p.scratch, total, p.k, surv, ss);
  }
  // the survivors ranked among themselves by counting
  for (int j = tid; j < live; j += kSparseThreads) {
    const unsigned long long mine = surv[j];
    int r = 0;
    for (int i = 0; i < live; ++i) r += surv[i] < mine;
    p.out_vals[r] = key_score(mine);
    p.out_ids[r] = static_cast<int>(mine & 0xFFFFFFFFu);
  }
  for (int j = live + tid; j < p.k; j += kSparseThreads) {
    p.out_vals[j] = 0.f;
    p.out_ids[j] = -1;
  }
}

// -- B6b ----------------------------------------------------------------------

struct FusionArgs {
  const int* slots;      // [legs, L], -1 pad
  const float* scores;   // [legs, L]; null for rankedFusion
  const float* weights;  // [legs]
  int legs, L, uni, k;
  float* g_acc;                 // [uni] when the union is not in smem
  unsigned char* g_flag;        // [uni]
  unsigned long long* g_keys;   // [pow2(legs * L)]
  int in_smem;
  float* out_vals;
  int* out_ids;
};

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

__host__ __device__ inline int host_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline size_t fusion_bytes(int legs, int L, int uni) {
  return align16(static_cast<size_t>(host_pow2(legs * L)) * 8) +
         align16(static_cast<size_t>(uni) * 4) + align16(uni);
}

// One leg's contribution at position j (score sc, the leg's min lo and
// span; sc null: rankedFusion).
__device__ __forceinline__ float contribution(const float* sc, int j, float w,
                                              float lo, float span) {
  if (sc == nullptr) return __fdiv_rn(w, __fadd_rn(60.f, static_cast<float>(j)));
  const float norm =
      span > 0.f ? __fdiv_rn(__fsub_rn(sc[j], lo), fmaxf(span, 1e-30f)) : 1.f;
  return __fmul_rn(w, norm);
}

// ascending bitonic sort of the warp's 32 * E keys, key[i] of lane l being
// element i * 32 + l
template <int E>
__device__ __forceinline__ void warp_bitonic(unsigned long long (&key)[E]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int s = stride >> 5;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          if (i & s) continue;
          const bool up = ((i * 32 + lane) & size) == 0;
          const unsigned long long x = key[i], y = key[i | s];
          const bool swap = (x > y) == up;
          key[i] = swap ? y : x;
          key[i | s] = swap ? x : y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const unsigned long long other = __shfl_xor_sync(kFull, key[i], stride);
          const bool lower = (lane & stride) == 0;
          const bool up = ((i * 32 + lane) & size) == 0;
          const unsigned long long lo = min(key[i], other), hi = max(key[i], other);
          key[i] = lower == up ? lo : hi;
        }
      }
    }
  }
}

template <int E>
__device__ __forceinline__ void small_write(const int* uniq, const float* acc,
                                            int n, const FusionArgs& p) {
  const int lane = threadIdx.x & 31;
  unsigned long long key[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = i * 32 + lane;
    key[i] = e < n ? sort_key(acc[uniq[e]], static_cast<unsigned>(uniq[e]))
                   : kNone;
  }
  warp_bitonic<E>(key);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = i * 32 + lane;
    if (e < p.k) {
      const bool live = key[i] != kNone;
      p.out_vals[e] = live ? key_score(key[i]) : 0.f;
      p.out_ids[e] = live ? static_cast<int>(key[i] & 0xFFFFFFFFu) : -1;
    }
  }
}

// B6b's small path: a warp a leg, kFusionSmallLegs warps.
__global__ void __launch_bounds__(32 * kFusionSmallLegs)
fusion_small_kernel(FusionArgs p) {
  __shared__ float acc[kFusionSmallUnion];
  __shared__ unsigned char seen[kFusionSmallUnion];
  __shared__ float contrib[kFusionSmallLegs][kFusionSmallLen];
  __shared__ int uniq[kFusionSmallLegs * kFusionSmallLen];
  __shared__ int n_uniq;
  const int tid = threadIdx.x, lane = tid & 31, leg = tid >> 5;
  const float big = 3.4028234663852886e38f;
  for (int u = tid; u < p.uni; u += 32 * kFusionSmallLegs) {
    acc[u] = 0.f;
    seen[u] = 0;
  }
  if (tid == 0) n_uniq = 0;
  // the leg in registers: positions lane and lane + 32
  int sl[2];
  const bool mine = leg < p.legs;
  const int* lsl = p.slots + static_cast<size_t>(leg) * p.L;
  const float* lsc = p.scores == nullptr
      ? nullptr : p.scores + static_cast<size_t>(leg) * p.L;
  float lo = big, hi = -big;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    sl[h] = mine && j < p.L ? lsl[j] : -1;
    if (lsc != nullptr && sl[h] >= 0) {
      lo = fminf(lo, lsc[j]);
      hi = fmaxf(hi, lsc[j]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
  const float span = __fsub_rn(hi, lo);
  const float w = mine ? p.weights[leg] : 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    if (sl[h] >= 0) contrib[leg][j] = contribution(lsc, j, w, lo, span);
  }
  __syncthreads();
  // legs in order, 32 positions at a time in order: the lowest lane of
  // each run of one slot adds the run's contributions in position order
  for (int l = 0; l < p.legs; ++l) {
    if (leg == l) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = sl[h];
        const bool ok = u >= 0 && u < p.uni;
        const unsigned peers =
            __match_any_sync(kFull, ok ? static_cast<unsigned>(u)
                                       : 0x80000000u | lane);
        if (ok && lane == __ffs(peers) - 1) {
          float a = acc[u];
          for (unsigned m = peers; m; m &= m - 1)
            a = __fadd_rn(a, contrib[l][32 * h + __ffs(m) - 1]);
          acc[u] = a;
          if (!seen[u]) {
            seen[u] = 1;
            uniq[atomicAdd(&n_uniq, 1)] = u;
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
  // the present slots, sorted by key in the first warp's registers
  if (leg == 0) {
    const int n = n_uniq, held = max(n, p.k);  // keys the warp sorts
    if (held <= 32) small_write<1>(uniq, acc, n, p);
    else if (held <= 64) small_write<2>(uniq, acc, n, p);
    else small_write<4>(uniq, acc, n, p);
  }
}

// B6b's general path.
__global__ void __launch_bounds__(kFusionThreads)
fusion_topk_kernel(FusionArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n2 = host_pow2(max(p.legs * p.L, 1));
  unsigned long long* keys;
  float* acc;
  unsigned char* flag;
  if (p.in_smem) {
    keys = reinterpret_cast<unsigned long long*>(smem);
    acc = reinterpret_cast<float*>(smem + align16(static_cast<size_t>(n2) * 8));
    flag = reinterpret_cast<unsigned char*>(acc) +
           align16(static_cast<size_t>(p.uni) * 4);
  } else {
    keys = p.g_keys;
    acc = p.g_acc;
    flag = p.g_flag;
  }
  __shared__ float s_lo[kFusionThreads / 32], s_hi[kFusionThreads / 32];
  __shared__ int s_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float big = 3.4028234663852886e38f;
  const int l2 = host_pow2(p.L);

  for (int u = tid; u < p.uni; u += kFusionThreads) {
    acc[u] = 0.f;
    flag[u] = 0;
  }
  if (tid == 0) s_count = 0;
  __syncthreads();

  for (int leg = 0; leg < p.legs; ++leg) {
    const int* sl = p.slots + static_cast<size_t>(leg) * p.L;
    const float* sc = p.scores == nullptr
        ? nullptr : p.scores + static_cast<size_t>(leg) * p.L;
    const float w = p.weights[leg];
    float lo = big, hi = -big, span = 0.f;
    if (p.scores != nullptr) {
      for (int j = tid; j < p.L; j += kFusionThreads) {
        if (sl[j] >= 0) {
          lo = fminf(lo, sc[j]);
          hi = fmaxf(hi, sc[j]);
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
      }
      if (lane == 0) {
        s_lo[warp] = lo;
        s_hi[warp] = hi;
      }
      __syncthreads();
      lo = big;
      hi = -big;
      for (int i = 0; i < kFusionThreads / 32; ++i) {
        lo = fminf(lo, s_lo[i]);
        hi = fmaxf(hi, s_hi[i]);
      }
      span = __fsub_rn(hi, lo);
    }
    // the leg's entries sorted by (slot, position): each slot's entries in
    // a run, in the leg's order
    for (int j = tid; j < l2; j += kFusionThreads) {
      const int u = j < p.L ? sl[j] : -1;
      keys[j] = (u >= 0 && u < p.uni)
          ? (static_cast<unsigned long long>(u) << 32) | j : kNone;
    }
    __syncthreads();
    bitonic_sort(keys, l2);
    // the head of each run adds the run's contributions in order
    for (int i = tid; i < p.L; i += kFusionThreads) {
      const unsigned long long key = keys[i];
      const unsigned u = static_cast<unsigned>(key >> 32);
      if (key == kNone || (i > 0 && static_cast<unsigned>(keys[i - 1] >> 32) == u))
        continue;
      float a = acc[u];
      for (int r = i; r < p.L && keys[r] != kNone &&
                      static_cast<unsigned>(keys[r] >> 32) == u; ++r)
        a = __fadd_rn(a, contribution(sc, static_cast<int>(keys[r] & 0xFFFFFFFFu),
                                      w, lo, span));
      acc[u] = a;
      flag[u] = 1;
    }
    __syncthreads();
  }

  for (int u = tid; u < p.uni; u += kFusionThreads) {
    if (flag[u]) {
      const int slot = atomicAdd(&s_count, 1);
      keys[slot] = sort_key(acc[u], static_cast<unsigned>(u));
    }
  }
  __syncthreads();
  const int c = s_count;
  const int m2 = next_pow2(max(c, 1));
  for (int i = c + tid; i < m2; i += kFusionThreads) keys[i] = kNone;
  __syncthreads();
  if (c > 1) bitonic_sort(keys, m2);
  for (int j = tid; j < p.k; j += kFusionThreads) {
    const bool live = j < c;
    p.out_vals[j] = live ? key_score(keys[j]) : 0.f;
    p.out_ids[j] = live ? static_cast<int>(keys[j] & 0xFFFFFFFFu) : -1;
  }
}

// -- host ---------------------------------------------------------------------

int launched(cudaError_t e) { return e == cudaSuccess ? kOk : kLaunch; }

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device, once a device (`done` a flag a device).
int allow_smem_once(const void* kernel, int bytes, std::atomic<int>* done) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return kAttr;
  if (done[dev].load(std::memory_order_acquire)) return kOk;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return kAttr;
  done[dev].store(1, std::memory_order_release);
  return kOk;
}

std::atomic<int> g_sparse_attr[kMaxDevices];
std::atomic<int> g_fusion_attr[kMaxDevices];

// The smallest power of two in [kSparseMinRange, kSparseMaxRange] whose
// CTAs over `space` docs are at most kSparseCtas.
int range_for(int space) {
  int r = kSparseMinRange;
  while (r < kSparseMaxRange &&
         (static_cast<long long>(space) + r - 1) / r > kSparseCtas)
    r <<= 1;
  return r;
}

bool fusion_small(int legs, int L, int uni, int k) {
  return legs <= kFusionSmallLegs && L <= kFusionSmallLen &&
         uni <= kFusionSmallUnion && k <= kFusionSmallK;
}

}  // namespace

extern "C" {

const char* hybrid_error_string(int code) {
  switch (code) {
    case kOk: return "ok";
    case kBadShape: return "empty or oversized entries, doc space or legs";
    case kBadK: return "k must be >= 1 (and <= the union for fusion)";
    case kBadGroups: return "n_groups must be >= 1 with a group per segment";
    case kBadScratch: return "the scratch is smaller than the launch needs";
    case kLaunch: return "kernel launch failed";
    case kAttr: return "could not raise the kernel's shared memory";
    default: return "unknown error";
  }
}

// B6a's doc ids a CTA owns over a doc space (the wrapper sizes its scratch
// by it: (ceil(space / range) + 1) * k keys).
int sparse_range(int space) { return range_for(space); }

// B6a: see sparse_topk_kernel. scratch holds scratch_keys keys, 16-byte
// aligned; ticket one unsigned, 0 before the first launch on its stream
// (each launch leaves it 0), used by one stream.
int sparse_topk(const int* rows, const float* tf, const float* dl,
                const int* seg, const float* seg_w, const float* seg_avgdl,
                const int* seg_grp, int n_seg, const unsigned char* allow,
                int space, float k1, float c1mb, float cb, float k1p1,
                int n_groups, int min_match, int k, void* scratch,
                long long scratch_keys, void* ticket, float* out_vals,
                int* out_ids, void* stream) {
  if (space < 1 || n_seg < 0) return kBadShape;
  if (k < 1) return kBadK;
  if (seg_grp != nullptr && n_groups < 1) return kBadGroups;
  const int range = range_for(space);
  const int ctas = static_cast<int>((static_cast<long long>(space) + range - 1)
                                    / range);
  const long long keys = (static_cast<long long>(ctas) + 1) * k;
  if (scratch_keys < keys ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return kBadScratch;
  const size_t score = sparse_score_smem(range);
  // the merge stages the partials, then the survivors, after them
  const size_t stage = static_cast<size_t>(((ctas * static_cast<long long>(k)
                                             + 1) & ~1ll) + k) * 8;
  const bool staged = stage <= static_cast<size_t>(kSparseStage);
  const size_t smem = staged && stage > score ? stage : score;
  SparseArgs a{rows, tf, dl, seg, seg_w, seg_avgdl, seg_grp, n_seg, allow,
               space, range, k1, c1mb, cb, k1p1, n_groups, min_match, k,
               static_cast<unsigned long long*>(scratch),
               static_cast<unsigned*>(ticket), out_vals, out_ids, staged,
               static_cast<size_t>(k) * 8 <= smem};
  const int attr = allow_smem_once(
      reinterpret_cast<const void*>(sparse_topk_kernel),
      sparse_score_smem(kSparseMaxRange) > kSparseStage
          ? sparse_score_smem(kSparseMaxRange) : kSparseStage,
      g_sparse_attr);
  if (attr) return attr;
  sparse_topk_kernel<<<ctas, kSparseThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return launched(cudaGetLastError());
}

// B6b: see fusion_small_kernel and fusion_topk_kernel. scores null =
// rankedFusion. scratch ([pow2(legs * L)] keys, [union] floats, [union]
// bytes, 16-byte aligned) is used only where the general path's buffers do
// not fit its shared memory.
int fusion_topk(const int* slots, const float* scores, const float* weights,
                int legs, int L, int uni, int k, int ranked, void* scratch,
                float* out_vals, int* out_ids, void* stream) {
  if (legs < 1 || L < 1 || uni < 1) return kBadShape;
  if (k < 1 || k > uni) return kBadK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FusionArgs a{slots, ranked ? nullptr : scores, weights, legs, L, uni, k,
               nullptr, nullptr, nullptr, 1, out_vals, out_ids};
  if (fusion_small(legs, L, uni, k)) {
    fusion_small_kernel<<<1, 32 * kFusionSmallLegs, 0, s>>>(a);
    return launched(cudaGetLastError());
  }
  const size_t bytes = fusion_bytes(legs, L, uni);
  const bool in_smem = bytes <= static_cast<size_t>(kFusionSmem);
  if (!in_smem) {
    if (scratch == nullptr) return kBadScratch;
    unsigned char* base = static_cast<unsigned char*>(scratch);
    const size_t nk = static_cast<size_t>(host_pow2(legs * L));
    a.g_keys = reinterpret_cast<unsigned long long*>(base);
    a.g_acc = reinterpret_cast<float*>(base + nk * 8);
    a.g_flag = base + nk * 8 + static_cast<size_t>(uni) * 4;
    a.in_smem = 0;
  }
  const int attr = allow_smem_once(
      reinterpret_cast<const void*>(fusion_topk_kernel), kFusionSmem,
      g_fusion_attr);
  if (attr) return attr;
  fusion_topk_kernel<<<1, kFusionThreads, in_smem ? bytes : 0, s>>>(a);
  return launched(cudaGetLastError());
}

}  // extern "C"
