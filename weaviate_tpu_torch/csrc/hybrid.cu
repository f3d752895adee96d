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
// B6a (sparse_topk_kernel). The work is a few bytes an entry, so it is
// bound by the bytes it reads: the entries (20 bytes each), the allow mask
// (a byte a doc) and the output. A CTA owns kSparseRange doc ids. It finds
// the entries of its range in each (property, term) segment by binary
// search (a segment's rows ascend and are unique: a posting list is
// doc-sorted), then walks the segments in order, each thread adding one
// entry's contribution to its doc's sum in shared memory (no two threads
// share a doc within a segment; a barrier separates segments), so a doc's
// sum is taken in entry order. A minimum-match query also ORs each
// entry's group bit into its doc's 64-bit mask, 64 groups a pass over the
// segments, and adds the masks' popcounts: any number of groups. The kept
// docs (touched, allowed, matched) are compacted, sorted by a 64-bit key
// (descending score, then ascending doc id) with a bitonic sort in shared
// memory, and the CTA's first k go out as its partial list. The last CTA
// to finish (a ticket counter) merges the sorted partial lists pairwise,
// in rounds, each element placed at its rank by a binary search in the
// other list, in shared memory when they fit and in the scratch buffer
// when not.
//
// B6b (fusion_topk_kernel). One CTA a request: each leg's min and max
// (relativeScoreFusion) or its ranks (rankedFusion), the contributions,
// their sum into the union's accumulator (legs in order, entries of a leg
// in order: a leg's entries are sorted by (slot, position), so a slot's
// entries form a run whose head adds them in the leg's order), the present
// slots compacted and sorted by the same 64-bit key, the first k out: one
// launch for what the plain version does in a dozen. A union (or a leg
// list) too large for shared memory is kept in the caller's scratch in
// device memory instead.
//
// Every entry point returns 0, a negative code for arguments it refuses, or
// a positive code for a failed launch (hybrid_error_string names each).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSparseRange = 4096;     // doc ids a B6a CTA owns
constexpr int kSparseThreads = 512;
constexpr int kFusionThreads = 512;
constexpr int kMergeSmem = 98304;      // the widest merge B6a stages in smem
constexpr int kFusionSmem = 196608;    // the widest union B6b holds in smem
constexpr unsigned long long kNone = ~0ull;

enum Err {
  kOk = 0,
  kBadShape = -1,
  kBadK = -2,
  kBadGroups = -3,
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

// first index in [lo, hi) of sorted a whose value is >= v (or > v: upper)
template <typename T>
__device__ __forceinline__ int lower_bound(const T* a, int lo, int hi, T v,
                                           bool upper) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const T x = a[mid];
    if (x < v || (upper && x == v)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Merge m sorted lists of k keys each (a, ascending, kNone padded) down to
// the first k of their union, pairwise in rounds; b holds m * k more keys.
// Returns the buffer that holds the result.
__device__ unsigned long long* merge_lists(unsigned long long* a,
                                           unsigned long long* b, int m,
                                           int k) {
  while (m > 1) {
    const int total = m * k;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int l = idx / k, j = idx - l * k;
      const unsigned long long x = a[idx];
      const int pair = l >> 1;
      int rank = j;
      if ((l ^ 1) < m) {
        const unsigned long long* other = a + (l ^ 1) * k;
        // the even list's keys go first on equal keys
        rank += lower_bound(other, 0, k, x, (l & 1) != 0);
      }
      if (rank < k) b[pair * k + rank] = x;
    }
    __syncthreads();
    unsigned long long* t = a;
    a = b;
    b = t;
    m = (m + 1) >> 1;
  }
  return a;
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

struct SparseArgs {
  const int* rows;
  const float* tf;
  const float* dl;
  const float* w;
  const float* avgdl;
  const int* grp;            // null: no minimum match
  const int* seg;            // [n_seg + 1] segment boundaries
  int n_seg;
  const unsigned char* allow;  // [space]
  int space;
  float k1, c1mb, cb, k1p1;
  int n_groups, min_match, k;
  unsigned long long* scratch;  // [2 * gridDim.x * k]
  int* counter;                 // zero at launch
  float* out_vals;
  int* out_ids;
  int merge_in_smem;
};

constexpr int sparse_score_smem() {
  // sums, distinct-group counts, touched flags, group masks / keys
  return kSparseRange * (4 + 4 + 8) + kSparseRange;
}

__global__ void __launch_bounds__(kSparseThreads)
sparse_topk_kernel(SparseArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* work = reinterpret_cast<unsigned long long*>(smem);
  float* acc = reinterpret_cast<float*>(work + kSparseRange);
  int* cnt = reinterpret_cast<int*>(acc + kSparseRange);
  unsigned char* touched = reinterpret_cast<unsigned char*>(cnt + kSparseRange);
  __shared__ int s_from[kSparseThreads], s_to[kSparseThreads];
  __shared__ int s_count;
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lo = blockIdx.x * kSparseRange;
  const int n = min(kSparseRange, p.space - lo);
  for (int i = tid; i < kSparseRange; i += kSparseThreads) {
    acc[i] = 0.f;
    cnt[i] = 0;
    touched[i] = 0;
    work[i] = 0;
  }
  if (tid == 0) s_count = 0;
  __syncthreads();

  const bool mm = p.grp != nullptr;
  const int passes = mm ? (p.n_groups + 63) / 64 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const int g0 = pass * 64;
    for (int s0 = 0; s0 < p.n_seg; s0 += kSparseThreads) {
      const int ns = min(kSparseThreads, p.n_seg - s0);
      if (tid < ns) {
        const int a = p.seg[s0 + tid], b = p.seg[s0 + tid + 1];
        const int from = lower_bound(p.rows, a, b, lo, false);
        s_from[tid] = from;
        s_to[tid] = lower_bound(p.rows, from, b, lo + n, false);
      }
      __syncthreads();
      for (int s = 0; s < ns; ++s) {
        const int to = s_to[s];
        for (int e = s_from[s] + tid; e < to; e += kSparseThreads) {
          const int d = p.rows[e] - lo;
          if (pass == 0) {
            acc[d] = __fadd_rn(acc[d], entry_score(
                p.tf[e], p.dl[e], p.w[e], p.avgdl[e], p.k1, p.c1mb, p.cb,
                p.k1p1));
            touched[d] = 1;
          }
          if (mm) {
            const int g = p.grp[e];
            if (g >= g0 && g < g0 + 64 && g < p.n_groups)
              work[d] |= 1ull << (g - g0);
          }
        }
        __syncthreads();
      }
    }
    if (mm) {
      for (int i = tid; i < kSparseRange; i += kSparseThreads) {
        cnt[i] += __popcll(work[i]);
        work[i] = 0;
      }
      __syncthreads();
    }
  }

  // the kept docs of the range, compacted; their order is fixed by the sort
  for (int i = tid; i < n; i += kSparseThreads) {
    if (touched[i] && p.allow[lo + i] && (!mm || cnt[i] >= p.min_match)) {
      const int slot = atomicAdd(&s_count, 1);
      work[slot] = sort_key(acc[i], static_cast<unsigned>(lo + i));
    }
  }
  __syncthreads();
  const int c = s_count;
  const int n2 = next_pow2(max(c, 1));
  for (int i = c + tid; i < n2; i += kSparseThreads) work[i] = kNone;
  __syncthreads();
  if (c > 1) bitonic_sort(work, n2);
  unsigned long long* part = p.scratch + static_cast<size_t>(blockIdx.x) * p.k;
  for (int j = tid; j < p.k; j += kSparseThreads)
    part[j] = j < c ? work[j] : kNone;

  // the last CTA to finish merges every CTA's list
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(p.counter, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int m = gridDim.x;
  const size_t total = static_cast<size_t>(m) * p.k;
  unsigned long long* a = p.scratch;
  unsigned long long* b = p.scratch + total;
  if (p.merge_in_smem) {
    a = work;
    b = work + total;
    for (size_t i = tid; i < total; i += kSparseThreads)
      a[i] = __ldcg(p.scratch + i);
    __syncthreads();
  }
  const unsigned long long* res = merge_lists(a, b, m, p.k);
  for (int j = tid; j < p.k; j += kSparseThreads) {
    const unsigned long long key = res[j];
    const bool live = key != kNone;
    p.out_vals[j] = live ? key_score(key) : 0.f;
    p.out_ids[j] = live ? static_cast<int>(key & 0xFFFFFFFFu) : -1;
  }
}

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
        lo = fminf(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, o));
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
                      static_cast<unsigned>(keys[r] >> 32) == u; ++r) {
        const int j = static_cast<int>(keys[r] & 0xFFFFFFFFu);
        float c;
        if (p.scores != nullptr) {
          const float norm = span > 0.f
              ? __fdiv_rn(__fsub_rn(sc[j], lo), fmaxf(span, 1e-30f)) : 1.f;
          c = __fmul_rn(w, norm);
        } else {
          c = __fdiv_rn(w, __fadd_rn(60.f, static_cast<float>(j)));
        }
        a = __fadd_rn(a, c);
      }
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

int launched(cudaError_t e) { return e == cudaSuccess ? kOk : kLaunch; }

}  // namespace

extern "C" {

const char* hybrid_error_string(int code) {
  switch (code) {
    case kOk: return "ok";
    case kBadShape: return "empty or oversized entries, doc space or legs";
    case kBadK: return "k must be >= 1 (and <= the union for fusion)";
    case kBadGroups: return "n_groups must be >= 1 with a group per entry";
    case kLaunch: return "kernel launch failed";
    case kAttr: return "could not raise the kernel's shared memory";
    default: return "unknown error";
  }
}

// B6a: see sparse_topk_kernel. scratch holds 2 * ceil(space / kSparseRange)
// * k keys; counter one int.
int sparse_topk(const int* rows, const float* tf, const float* dl,
                const float* w, const float* avgdl, const int* grp,
                const int* seg, int n_seg, const unsigned char* allow,
                int space, float k1, float c1mb, float cb, float k1p1,
                int n_groups, int min_match, int k, void* scratch,
                void* counter, float* out_vals, int* out_ids, void* stream) {
  if (space < 1 || n_seg < 0) return kBadShape;
  if (k < 1) return kBadK;
  if (grp != nullptr && n_groups < 1) return kBadGroups;
  const int ctas = (space + kSparseRange - 1) / kSparseRange;
  const size_t merge = 2ull * ctas * k * 8;
  SparseArgs a{rows, tf, dl, w, avgdl, grp, seg, n_seg, allow, space,
               k1, c1mb, cb, k1p1, n_groups, min_match, k,
               static_cast<unsigned long long*>(scratch),
               static_cast<int*>(counter), out_vals, out_ids,
               merge <= static_cast<size_t>(kMergeSmem)};
  size_t smem = sparse_score_smem();
  if (a.merge_in_smem && merge > smem) smem = merge;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cudaFuncSetAttribute(sparse_topk_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return kAttr;
  if (cudaMemsetAsync(counter, 0, sizeof(int), s) != cudaSuccess)
    return kLaunch;
  sparse_topk_kernel<<<ctas, kSparseThreads, smem, s>>>(a);
  return launched(cudaGetLastError());
}

// B6b's dynamic shared memory at (legs, L, union): 0 when it keeps its
// buffers in the caller's scratch instead.
int fusion_smem_bytes(int legs, int L, int uni) {
  const size_t b = fusion_bytes(legs, L, uni);
  return b <= static_cast<size_t>(kFusionSmem) ? static_cast<int>(b) : 0;
}

// B6b: see fusion_topk_kernel. scores null = rankedFusion. g_acc, g_flag and
// g_keys ([union] float, [union] bytes, [pow2(legs * L)] keys) are used
// only when fusion_smem_bytes is 0.
int fusion_topk(const int* slots, const float* scores, const float* weights,
                int legs, int L, int uni, int k, int ranked, void* g_acc,
                void* g_flag, void* g_keys, float* out_vals, int* out_ids,
                void* stream) {
  if (legs < 1 || L < 1 || uni < 1) return kBadShape;
  if (k < 1 || k > uni) return kBadK;
  const int smem = fusion_smem_bytes(legs, L, uni);
  FusionArgs a{slots, ranked ? nullptr : scores, weights, legs, L, uni, k,
               static_cast<float*>(g_acc),
               static_cast<unsigned char*>(g_flag),
               static_cast<unsigned long long*>(g_keys), smem > 0,
               out_vals, out_ids};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(fusion_topk_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return kAttr;
  fusion_topk_kernel<<<1, kFusionThreads, smem, s>>>(a);
  return launched(cudaGetLastError());
}

}  // extern "C"
