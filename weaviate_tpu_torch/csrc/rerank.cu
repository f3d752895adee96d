// B7a: the rerank stage of a search batch. For each query, gather its
// candidates' token planes, score each candidate with the rerank module
// (masked MaxSim, or the linear blend of MaxSim and the mean-pooled dot
// product), and keep the top `out_k` by score, as (ids, -score).
//
// Replaces: the XLA program `_rerank_stage` of
// weaviate_tpu/ops/device_beam.py:161 (with `_rerank_module_scores` :147,
// `batched_maxsim` weaviate_tpu/modules/device/maxsim.py:20 and
// `LinearRerank.score` weaviate_tpu/modules/device/linear.py:33), which
// the JAX package runs inside the fused walk (`_fused_search` :372-376)
// and after the FDE scan of the multivector index (`_fused_flat_rerank`
// :870). Its semantics, step for step:
//
//   * A candidate is valid when its id is >= 0 (and < n, the plane's
//     rows). A valid candidate's tokens are those its mask row keeps.
//   * MaxSim: for each query token the mask keeps, the maximum over the
//     candidate's kept tokens of the float32 dot product; a query token
//     with no finite maximum (a candidate with no kept token) adds 0; the
//     sum over query tokens is the score.
//   * Linear: w_max * MaxSim + w_mean * (mean_q . mean_c) + bias, the
//     means over the kept tokens, each count clamped to at least 1, each
//     mean's element divided before the dot product (as JAX does).
//   * Top-k: the `out_k` best scores, descending; equal scores keep the
//     lower candidate position first (lax.top_k's order). An invalid
//     candidate scores -inf; a slot whose score is not finite returns
//     (-1, 1e30), the mask distance.
//
// Bound on this card: a candidate's score costs Tq x T x D multiply-adds
// (2 Tq T D float32 operations) over the T x D x 4 bytes of its kept
// tokens, Tq / 2 operations a byte, against the card's float32 ridge of 20
// (67 TFLOP/s over 3.35 TB/s): bytes bound it up to Tq = 40 (the HNSW
// tier's self mode, Tq = 1, and the multivector path's 32 query tokens),
// operations above. What the design does:
//
//   1. One launch a batch: a CTA takes one query and a block of
//      candidates, a warp one candidate, so a batch of one query (the
//      multivector path) still spreads over C / warps CTAs.
//   2. The query's tokens sit in shared memory when they fit, a token's
//      row padded by 4 floats, so lane j (query token j) reads its 16-byte
//      pieces without bank conflicts; otherwise they are read from global
//      memory (L1). A lane holds one query token's running maximum.
//   3. The candidate's kept tokens are staged kTok at a time in the warp's
//      shared memory by coalesced 16-byte loads; each lane then forms kTok
//      dot products with its query token, every staged float a broadcast
//      read, the products float32 fused multiply-adds in this kernel (no
//      tensor cores, no TF32, no library call).
//   4. The scores go to a [b, c] scratch; the last CTA of a query (a
//      ticket a query that it wraps back to 0, so nothing is cleared
//      between launches) ranks the c scores by counting, in shared memory
//      where they fit (up to about 58,000), else from L2:
//      the rank of score i is the number of scores above it plus the
//      number equal to it at a lower position, and ranks below out_k are
//      written out.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kTok = 4;  // candidate tokens staged at once in a warp
constexpr int kMaxC = 65535;  // a CTA a warp's candidate: grid.y
constexpr float kMask = 1e30f;  // MASK_DISTANCE of ops/distance.py
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kMaxSim = 0, kLinear = 1 };

// error codes of the C interface beside cudaError_t values (those are > 0)
enum Refused {
  kBadShape = -1,
  kBadKind = -2,
  kBadK = -3,
  kBadSmem = -4,
  kBadCount = -5,
};

struct Params {
  const int* cand;       // [b, c], -1 padded
  const float* tokens;   // [n, t, d]
  const uint8_t* tmask;  // [n, t]
  const float* q;        // [b, tq, d]
  const uint8_t* qmask;  // [b, tq]
  float* scores;         // [b, c] scratch
  unsigned* tickets;     // [b], 0 at launch; the last CTA leaves it 0
  int* out_ids;          // [b, out_k]
  float* out_d;          // [b, out_k]
  int b, c, n, t, d, tq, out_k;
  int kind;
  float w_max, w_mean, bias;
  int warps;   // warps a CTA, one candidate each
  int q_smem;  // the query's tokens staged in shared memory
  int sel_smem;  // the last CTA stages the c scores in shared memory
  int qpitch;  // floats a staged query token
  int vec;     // d % 4 == 0: 16-byte loads
};

// Shared memory of a CTA: [the query's tokens] [mean_q] then a slice a
// warp: kTok staged candidate tokens and the candidate's token sum.
struct Layout {
  long long q, qmean, warp, total;
};

__host__ __device__ Layout layout(int tq, int d, int qpitch, bool q_smem,
                                  bool linear, int warps) {
  Layout l;
  l.q = q_smem ? 4LL * tq * qpitch : 0;
  l.qmean = linear ? 4LL * ((d + 3) & ~3) : 0;
  l.warp = 4LL * kTok * ((d + 3) & ~3) + (linear ? 4LL * ((d + 3) & ~3) : 0);
  l.total = l.q + l.qmean + warps * l.warp;
  return l;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The score of candidate `id` (valid) for query `qi`, every lane of the
// warp calling. `qs` the query's staged tokens (or null: global), `qmean`
// its mean (linear), `stage` and `csum` the warp's slices.
__device__ float score_candidate(const Params& p, int qi, int id,
                                 const float* qs, const float* qmean,
                                 float* stage, float* csum) {
  const int lane = threadIdx.x & 31;
  const int d = p.d, dp = (d + 3) & ~3;
  const uint8_t* mrow = p.tmask + (size_t)id * p.t;
  const float* crow = p.tokens + (size_t)id * p.t * d;
  const float* qg = p.q + (size_t)qi * p.tq * d;
  const uint8_t* qm = p.qmask + (size_t)qi * p.tq;
  const bool linear = p.kind == kLinear;
  if (linear)
    for (int k = lane; k < dp; k += 32) csum[k] = 0.f;
  float total = 0.f;
  int kept = 0;
  for (int q0 = 0; q0 < p.tq; q0 += 32) {
    const int qt = q0 + lane;
    const bool qlive = qt < p.tq && qm[qt];
    const float* qrow = qs ? qs + (size_t)qt * p.qpitch
                           : qg + (size_t)(qt < p.tq ? qt : 0) * d;
    float best = -__builtin_huge_valf();
    for (int t0 = 0; t0 < p.t; t0 += 32) {
      // the kept tokens of this chunk of 32, in order
      const int tt = t0 + lane;
      unsigned keep = __ballot_sync(kFull, tt < p.t && mrow[tt]);
      while (keep) {
        // stage up to kTok kept tokens
        int tok[kTok];
        int ns = 0;
#pragma unroll
        for (int j = 0; j < kTok; ++j) {
          tok[j] = -1;
          if (keep) {
            const int bit = __ffs(keep) - 1;
            keep &= keep - 1;
            tok[j] = t0 + bit;
            ns = j + 1;
          }
        }
        __syncwarp();  // the previous group's reads are done
        for (int j = 0; j < ns; ++j) {
          const float* src = crow + (size_t)tok[j] * d;
          float* dst = stage + j * dp;
          if (p.vec) {
            for (int k = 4 * lane; k < d; k += 128)
              *reinterpret_cast<float4*>(dst + k) =
                  __ldg(reinterpret_cast<const float4*>(src + k));
          } else {
            for (int k = lane; k < d; k += 32) dst[k] = __ldg(src + k);
          }
        }
        __syncwarp();
        if (linear && q0 == 0) {
          // the candidate's token sum, a lane its own elements
          for (int j = 0; j < ns; ++j)
            for (int k = lane; k < d; k += 32) csum[k] += stage[j * dp + k];
          kept += ns;
        }
        float acc[kTok];
#pragma unroll
        for (int j = 0; j < kTok; ++j) acc[j] = 0.f;
        if (qt < p.tq) {
          if (p.vec) {
            for (int k = 0; k < d; k += 4) {
              const float4 a = qs ? *reinterpret_cast<const float4*>(qrow + k)
                                  : __ldg(reinterpret_cast<const float4*>(
                                        qrow + k));
#pragma unroll
              for (int j = 0; j < kTok; ++j) {
                const float4 x =
                    *reinterpret_cast<const float4*>(stage + j * dp + k);
                acc[j] = fmaf(a.x, x.x, acc[j]);
                acc[j] = fmaf(a.y, x.y, acc[j]);
                acc[j] = fmaf(a.z, x.z, acc[j]);
                acc[j] = fmaf(a.w, x.w, acc[j]);
              }
            }
          } else {
            for (int k = 0; k < d; ++k) {
              const float a = qs ? qrow[k] : __ldg(qrow + k);
#pragma unroll
              for (int j = 0; j < kTok; ++j)
                acc[j] = fmaf(a, stage[j * dp + k], acc[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kTok; ++j)
          if (j < ns) best = fmaxf(best, acc[j]);
      }
    }
    float add = qlive && isfinite(best) ? best : 0.f;
    total += warp_sum(add);
  }
  if (!linear) return total;
  // mean_q . mean_c, each element of mean_c divided before the product
  const float cn = static_cast<float>(kept > 0 ? kept : 1);
  float md = 0.f;
  for (int k = lane; k < d; k += 32) md = fmaf(qmean[k], csum[k] / cn, md);
  md = warp_sum(md);
  return p.w_max * total + p.w_mean * md + p.bias;
}

__global__ void __launch_bounds__(32 * kMaxWarps)
rerank_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool s_last;
  const int qi = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool linear = p.kind == kLinear;
  const int d = p.d, dp = (d + 3) & ~3;
  const Layout l = layout(p.tq, d, p.qpitch, p.q_smem, linear, p.warps);
  float* qs = p.q_smem ? reinterpret_cast<float*>(smem) : nullptr;
  float* qmean = reinterpret_cast<float*>(smem + l.q);
  float* stage = reinterpret_cast<float*>(smem + l.q + l.qmean + warp * l.warp);
  float* csum = stage + kTok * dp;
  const float* qg = p.q + (size_t)qi * p.tq * d;
  const uint8_t* qm = p.qmask + (size_t)qi * p.tq;

  if (qs) {
    for (int e = threadIdx.x; e < p.tq * d; e += blockDim.x) {
      const int r = e / d, k = e - r * d;
      qs[(size_t)r * p.qpitch + k] = qg[e];
    }
  }
  if (linear) {
    // mean_q: the kept query tokens' sum over their count (at least 1)
    int qn = 0;
    for (int r = 0; r < p.tq; ++r) qn += qm[r] ? 1 : 0;
    const float qc = static_cast<float>(qn > 0 ? qn : 1);
    for (int k = threadIdx.x; k < d; k += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < p.tq; ++r)
        if (qm[r]) s += qg[(size_t)r * d + k];
      qmean[k] = s / qc;
    }
  }
  __syncthreads();

  const int ci = blockIdx.y * p.warps + warp;
  if (ci < p.c) {
    const int id = p.cand[(size_t)qi * p.c + ci];
    float s = -__builtin_huge_valf();
    if (id >= 0 && id < p.n)
      s = score_candidate(p, qi, id, qs, qmean, stage, csum);
    if (lane == 0) p.scores[(size_t)qi * p.c + ci] = s;
  }

  // the last CTA of this query ranks its scores
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicInc(p.tickets + qi, gridDim.y - 1) == gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the scores in shared memory where they fit, else read from L2
  const float* row = p.scores + (size_t)qi * p.c;
  float* sc = reinterpret_cast<float*>(smem);
  if (p.sel_smem) {
    for (int i = threadIdx.x; i < p.c; i += blockDim.x)
      sc[i] = __ldcg(row + i);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < p.c; i += blockDim.x) {
    const float v = p.sel_smem ? sc[i] : __ldcg(row + i);
    int rank = 0;
    for (int j = 0; j < p.c; ++j) {
      const float u = p.sel_smem ? sc[j] : __ldcg(row + j);
      rank += (u > v) || (u == v && j < i);
    }
    if (rank < p.out_k) {
      const bool ok = isfinite(v);
      p.out_ids[(size_t)qi * p.out_k + rank] =
          ok ? p.cand[(size_t)qi * p.c + i] : -1;
      p.out_d[(size_t)qi * p.out_k + rank] = ok ? -v : kMask;
    }
  }
}

}  // namespace

extern "C" {

// Launches B7a for `b` queries on `stream`: candidates `cand` [b, c] (-1
// padded) scored against the token plane `tokens` [n, t, d] and its mask
// `tmask` [n, t] (one byte a token), with the query tokens `q` [b, tq, d]
// and their mask `qmask` [b, tq]; `kind` 0 MaxSim, 1 linear with w_max,
// w_mean and bias. `scores` [b, c] is scratch; `tickets` [b] must be 0 at
// the first launch on its stream (every launch leaves it 0). Writes
// out_ids / out_d [b, out_k]. Returns 0, a cudaError_t (> 0), or a
// negative code for arguments outside the kernel's contract (see
// rerank_error_string).
int rerank_topk(const int* cand, const float* tokens, const uint8_t* tmask,
                const float* q, const uint8_t* qmask, float* scores,
                unsigned* tickets, int* out_ids, float* out_d, int b, int c,
                int n, int t, int d, int tq, int out_k, int kind, float w_max,
                float w_mean, float bias, void* stream) {
  if (b < 1 || c < 1 || n < 1 || t < 1 || d < 1 || tq < 1) return kBadShape;
  if (c > kMaxC) return kBadCount;
  if (kind != kMaxSim && kind != kLinear) return kBadKind;
  if (out_k < 1 || out_k > c) return kBadK;
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool linear = kind == kLinear;
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(tokens) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int qpitch = vec ? d + 4 : d + 1;
  // the query's tokens in shared memory at 8 warps down to 2, else from
  // global memory at 8 warps down to 1
  int warps = 0;
  bool q_smem = true;
  for (int w = kMaxWarps; w >= 2 && !warps; --w)
    if (layout(tq, d, qpitch, true, linear, w).total <= smem_max) warps = w;
  if (!warps) {
    q_smem = false;
    for (int w = kMaxWarps; w >= 1 && !warps; --w)
      if (layout(tq, d, qpitch, false, linear, w).total <= smem_max)
        warps = w;
  }
  if (!warps) return kBadSmem;
  long long smem = layout(tq, d, qpitch, q_smem, linear, warps).total;
  // the last CTA's scores, staged where they fit
  const bool sel_smem = 4LL * c <= smem_max;
  if (sel_smem && smem < 4LL * c) smem = 4LL * c;
  Params p;
  p.cand = cand;
  p.tokens = tokens;
  p.tmask = tmask;
  p.q = q;
  p.qmask = qmask;
  p.scores = scores;
  p.tickets = tickets;
  p.out_ids = out_ids;
  p.out_d = out_d;
  p.b = b;
  p.c = c;
  p.n = n;
  p.t = t;
  p.d = d;
  p.tq = tq;
  p.out_k = out_k;
  p.kind = kind;
  p.w_max = w_max;
  p.w_mean = w_mean;
  p.bias = bias;
  p.warps = warps;
  p.q_smem = q_smem ? 1 : 0;
  p.sel_smem = sel_smem ? 1 : 0;
  p.qpitch = qpitch;
  p.vec = vec ? 1 : 0;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(rerank_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(b, (c + warps - 1) / warps);
  rerank_kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

const char* rerank_error_string(int code) {
  switch (code) {
    case kBadShape: return "b, c, n, t, d, tq must be >= 1";
    case kBadKind: return "module kind outside 0 (MaxSim), 1 (linear)";
    case kBadK: return "out_k outside [1, c]";
    case kBadSmem: return "a warp's staged tokens exceed the card's shared "
                          "memory a block";
    case kBadCount: return "more than 65535 candidates a query";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
