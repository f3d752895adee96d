// B9a: the HFresh posting top-k. For each query row, the distance to each
// of its candidate rows (the union of its probed postings), masked, and the
// `kk` smallest, as (distance, column).
//
// Replaces: the XLA program of weaviate_tpu/index/hfresh.py:319-340 in
// `HFreshIndex.search` (`gather_distance` weaviate_tpu/ops/distance.py:104
// at fp32, `jnp.take(valid, rows)`, `jnp.where(mask & live, d,
// MASK_DISTANCE)`, `lax.top_k(-d, kk)`). Its semantics, step for step:
//
//   * Row `r` of the batch has `c` candidate columns; column j names corpus
//     row cand[r, j] (the host clips it to [0, n)). A column counts when
//     mask[r, j] and valid[cand[r, j]] are both set; its distance is then
//     l2-squared sum((q - x)^2), dot -sum(q x), cosine 1 - sum(q x) (rows
//     and query normalised by the caller), manhattan sum |q - x| or
//     hamming the count of differing dimensions, all in float32. A column
//     that does not count has the distance 1e30 (MASK_DISTANCE).
//   * The `kk` smallest distances ascending; equal distances put the lower
//     column first (lax.top_k's order on the negated distances). Every
//     column takes part, masked ones at 1e30, as in the JAX program: the
//     host maps them to -1 afterwards.
//
// Bound on this card: a (query, candidate) pair reads the candidate's D x
// 4 bytes for 2 D float32 operations: 0.5 operations a byte against the
// card's float32 ridge of 20 (67 TFLOP/s over 3.35 TB/s), so bytes bound
// it: the unique valid candidate rows once. Queries of one batch probe
// overlapping postings, so a row is read by several CTAs (from L2 where it
// stays there). What this first design does (one CTA a query row, simple
// and right; reuse of rows across the queries of a cluster, TMA and an
// async copy ring are later work):
//
//   1. The query is staged in shared memory once. The CTA's warps stride
//      over the row's columns, a warp a column: the lanes read the
//      candidate row in 16-byte loads where D % 4 == 0 (4-byte loads
//      otherwise), accumulate in float32 and reduce with shuffles. A
//      column that does not count is not read.
//   2. Each column's distance becomes a 64-bit key: the distance's
//      order-preserving bits (-0 taken as +0), then the column. Keys are
//      unique and their order is the selection's order. They stay in
//      shared memory where the row's columns fit, else in a global
//      scratch [b, c].
//   3. A radix select over the keys (8 passes of 8 bits, a shared-memory
//      histogram each) finds the kk-th smallest key exactly; the keys not
//      above it, exactly kk, are collected, and each one's rank among
//      them (a count of smaller keys) places it in the output. The
//      count is kk^2 / 256 comparisons a thread: small at the path's k
//      (10; 1,024 at most from `search_by_distance`).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;          // radix select: 8 bits a pass
constexpr int kMisc = 16;           // 4-byte words of scalars in shared memory
constexpr int kMaxDevices = 64;
constexpr int kCallBytes = 116;     // a packed PostingCall: 10 Q, 9 i
constexpr float kMask = 1e30f;      // MASK_DISTANCE of ops/distance.py
constexpr unsigned kFull = 0xffffffffu;

enum Metric { kL2 = 0, kDot = 1, kCosine = 2, kManhattan = 3, kHamming = 4 };

// error codes of the C interface beside cudaError_t values (those are > 0)
enum Refused {
  kBadShape = -1,
  kBadMetric = -2,
  kBadK = -3,
  kBadSmem = -4,
  kBadScratch = -5,
};

struct Params {
  const float* q;         // [b, d]
  const float* corpus;    // [n, d]
  const uint8_t* valid;   // [n]
  const int* cand;        // [b, c]
  const uint8_t* mask;    // [b, c]
  uint64_t* keys_g;       // [b, c] scratch where the keys do not fit
  uint64_t* sel_g;        // [b, kk] scratch where the kept keys do not fit
  float* out_d;           // [b, kk]
  int* out_c;             // [b, kk]
  int b, c, n, d, kk, metric;
  int vec;                // 16-byte loads of the rows and the query
  int keys_smem, sel_smem;
};

// bytes of a CTA's shared memory before the keys: the query (rounded to 16
// bytes), the histogram and the scalars
__host__ __device__ inline int head_bytes(int d) {
  return 4 * ((d + 3) & ~3) + 4 * kBins + 4 * kMisc;
}

__device__ __forceinline__ float term(int metric, float q, float x) {
  switch (metric) {
    case kL2: {
      const float t = q - x;
      return t * t;
    }
    case kManhattan: return fabsf(q - x);
    case kHamming: return q != x ? 1.0f : 0.0f;
    default: return q * x;
  }
}

__device__ __forceinline__ uint64_t make_key(float dist, int col) {
  if (dist == 0.0f) dist = 0.0f;  // -0 sorts as +0, as the plain sort does
  unsigned u = __float_as_uint(dist);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) | static_cast<unsigned>(col);
}

__device__ __forceinline__ float key_dist(uint64_t key) {
  const unsigned u = static_cast<unsigned>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__global__ void __launch_bounds__(kThreads)
    posting_topk_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = p.c, d = p.d, kk = p.kk;
  const int head = head_bytes(d);
  float* qs = reinterpret_cast<float*>(smem);
  unsigned* hist = reinterpret_cast<unsigned*>(smem + 4 * ((d + 3) & ~3));
  unsigned* misc = hist + kBins;
  uint64_t* keys = p.keys_smem
                       ? reinterpret_cast<uint64_t*>(smem + head)
                       : p.keys_g + static_cast<size_t>(row) * c;
  uint64_t* sel =
      p.sel_smem
          ? reinterpret_cast<uint64_t*>(smem + head +
                                        (p.keys_smem ? 8 * c : 0))
          : p.sel_g + static_cast<size_t>(row) * kk;

  // 1. the query, then a warp a column
  const float* q = p.q + static_cast<size_t>(row) * d;
  for (int i = tid; i < d; i += kThreads) qs[i] = q[i];
  __syncthreads();
  const int* cand = p.cand + static_cast<size_t>(row) * c;
  const uint8_t* mask = p.mask + static_cast<size_t>(row) * c;
  for (int j = warp; j < c; j += kWarps) {
    const int id = min(max(cand[j], 0), p.n - 1);
    float dist = kMask;
    if (mask[j] && p.valid[id]) {
      const float* x = p.corpus + static_cast<size_t>(id) * d;
      float acc = 0.0f;
      if (p.vec) {
        for (int i = 4 * lane; i < d; i += 128) {
          const float4 xv = __ldg(reinterpret_cast<const float4*>(x + i));
          const float4 qv = *reinterpret_cast<const float4*>(qs + i);
          acc += term(p.metric, qv.x, xv.x);
          acc += term(p.metric, qv.y, xv.y);
          acc += term(p.metric, qv.z, xv.z);
          acc += term(p.metric, qv.w, xv.w);
        }
      } else {
        for (int i = lane; i < d; i += 32)
          acc += term(p.metric, qs[i], __ldg(x + i));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
      dist = p.metric == kDot ? -acc : p.metric == kCosine ? 1.0f - acc : acc;
    }
    if (lane == 0) keys[j] = make_key(dist, j);
  }
  __syncthreads();

  // 2. the kk-th smallest key, 8 bits a pass from the top
  uint64_t prefix = 0, pmask = 0;
  unsigned want = static_cast<unsigned>(kk);
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int j = tid; j < c; j += kThreads) {
      const uint64_t k = keys[j];
      if ((k & pmask) == prefix)
        atomicAdd(&hist[static_cast<unsigned>(k >> shift) & 0xffu], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      unsigned s = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += hist[8 * lane + i];
      unsigned incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned hit = __ballot_sync(kFull, incl >= want);
      if (lane == __ffs(hit) - 1) {
        unsigned below = incl - s;
        for (int i = 0; i < 8; ++i) {
          const unsigned h = hist[8 * lane + i];
          if (below + h >= want) {
            misc[0] = 8 * lane + i;
            misc[1] = want - below;
            break;
          }
          below += h;
        }
      }
    }
    __syncthreads();
    prefix |= static_cast<uint64_t>(misc[0]) << shift;
    pmask |= static_cast<uint64_t>(0xffu) << shift;
    want = misc[1];
  }
  // every thread has read misc[0..1]; misc[2] is the collect's counter
  if (tid == 0) misc[2] = 0;
  __syncthreads();

  // 3. the kk keys not above it, then each one's rank among them
  for (int j = tid; j < c; j += kThreads) {
    const uint64_t k = keys[j];
    if (k <= prefix) sel[atomicAdd(&misc[2], 1u)] = k;
  }
  __syncthreads();
  float* out_d = p.out_d + static_cast<size_t>(row) * kk;
  int* out_c = p.out_c + static_cast<size_t>(row) * kk;
  for (int i = tid; i < kk; i += kThreads) {
    const uint64_t v = sel[i];
    int rank = 0;
    for (int j = 0; j < kk; ++j) rank += sel[j] < v;
    out_d[rank] = key_dist(v);
    out_c[rank] = static_cast<int>(v & 0xffffffffu);
  }
}

// each device's dynamic shared memory a block can take (the opt-in limit
// less the kernel's static part), read once, with the kernel's limit
// raised to it once
struct Device {
  int smem_max = 0;
  cudaError_t err = cudaSuccess;
  std::once_flag once;
};
Device g_devices[kMaxDevices];

cudaError_t device_info(int dev, const Device** out) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Device& g = g_devices[dev];
  std::call_once(g.once, [&] {
    g.err = cudaDeviceGetAttribute(
        &g.smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes fa;
    if (g.err == cudaSuccess)
      g.err = cudaFuncGetAttributes(&fa, (const void*)posting_topk_kernel);
    if (g.err == cudaSuccess) {
      g.smem_max -= static_cast<int>(fa.sharedSizeBytes);
      g.err = cudaFuncSetAttribute(
          (const void*)posting_topk_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_max);
    }
  });
  *out = &g;
  return g.err;
}

}  // namespace

extern "C" {

// The dynamic shared memory a block of B9a can take on device `dev` (what
// ops/hfresh.py sizes a launch for). Returns 0 or a cudaError_t.
int hfresh_device_info(int dev, int* smem_max) {
  const Device* g = nullptr;
  const cudaError_t e = device_info(dev, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  *smem_max = g->smem_max;
  return 0;
}

// Launches B9a with the arguments packed in `call` (kCallBytes, as
// ops/hfresh.py packs them), a PostingCall: on `stream`, one CTA a query
// row of `b`: queries `q` [b, d], the store's `corpus` [n, d] and `valid`
// [n] (one byte a row), candidates `cand` [b, c] (int32, in [0, n)) and
// `mask` [b, c] (one byte a column); `metric` 0 l2-squared, 1 dot, 2
// cosine, 3 manhattan, 4 hamming. The keys live in shared memory where
// `keys_smem`, else in `keys_g` [b, c] (8 bytes a key); the kept keys in
// shared memory where `sel_smem`, else in `sel_g` [b, kk]. `smem` bytes a
// CTA. Writes out_d / out_c [b, kk]. Returns 0, a cudaError_t (> 0), or a
// negative code for arguments outside the kernel's contract (see
// hfresh_error_string).
int hfresh_posting_topk(const unsigned char* call) {
  struct PostingCall {
    uint64_t q, corpus, valid, cand, mask, keys_g, sel_g, out_d, out_c,
        stream;
    int32_t b, c, n, d, kk, metric, keys_smem, sel_smem, smem;
  } a;
  static_assert(sizeof(uint64_t) * 10 + sizeof(int32_t) * 9 == kCallBytes,
                "PostingCall layout");
  memcpy(&a, call, kCallBytes);
  if (a.b < 1 || a.c < 1 || a.n < 1 || a.d < 1) return kBadShape;
  if (a.metric < kL2 || a.metric > kHamming) return kBadMetric;
  if (a.kk < 1 || a.kk > a.c) return kBadK;
  if ((!a.keys_smem && !a.keys_g) || (!a.sel_smem && !a.sel_g))
    return kBadScratch;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const Device* g = nullptr;
  if (e == cudaSuccess) e = device_info(dev, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = head_bytes(a.d) +
                         (a.keys_smem ? 8LL * a.c : 0) +
                         (a.sel_smem ? 8LL * a.kk : 0);
  if (a.smem < need || a.smem > g->smem_max) return kBadSmem;
  Params p;
  p.q = reinterpret_cast<const float*>(a.q);
  p.corpus = reinterpret_cast<const float*>(a.corpus);
  p.valid = reinterpret_cast<const uint8_t*>(a.valid);
  p.cand = reinterpret_cast<const int*>(a.cand);
  p.mask = reinterpret_cast<const uint8_t*>(a.mask);
  p.keys_g = reinterpret_cast<uint64_t*>(a.keys_g);
  p.sel_g = reinterpret_cast<uint64_t*>(a.sel_g);
  p.out_d = reinterpret_cast<float*>(a.out_d);
  p.out_c = reinterpret_cast<int*>(a.out_c);
  p.b = a.b;
  p.c = a.c;
  p.n = a.n;
  p.d = a.d;
  p.kk = a.kk;
  p.metric = a.metric;
  p.vec = a.d % 4 == 0 && a.corpus % 16 == 0 && a.q % 16 == 0;
  p.keys_smem = a.keys_smem;
  p.sel_smem = a.sel_smem;
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(a.stream);
  posting_topk_kernel<<<a.b, kThreads, a.smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* hfresh_error_string(int code) {
  switch (code) {
    case kBadShape: return "b, c, n, d must be >= 1";
    case kBadMetric: return "metric outside 0-4 (l2-squared, dot, cosine, "
                            "manhattan, hamming)";
    case kBadK: return "kk outside [1, c]";
    case kBadSmem: return "the shared memory is below the layout's or above "
                          "the card's a block";
    case kBadScratch: return "keys or kept keys neither in shared memory "
                             "nor given a scratch";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
