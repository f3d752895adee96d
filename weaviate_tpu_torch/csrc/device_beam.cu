// Fused HNSW walk of a query batch: greedy descent over the upper layers,
// then the layer-0 best-first beam, one block per query, one launch per
// batch.
//
// Replaces: the XLA program `_fused_search` of
// weaviate_tpu/ops/device_beam.py:222 (with `_masked_scores` :138 and
// `RawScorer` :70, launched by `device_search` :796). The semantics are
// that program's, step for step:
//
//   * Upper descent (:272-293), per level, top level first: read the
//     current node's slot; gather its neighbours, drop the absent ones
//     (`present`), score the rest and take the first index of the minimum.
//     Move only on a strict `<`; stop when nothing improves or after
//     `max_steps` steps of that level.
//   * Layer-0 beam (:319-364): expand the first unexpanded beam entry (the
//     beam is kept sorted, so this is the JAX argmin with its first-index
//     tie rule); drop neighbours that are visited or absent and mark the
//     rest visited (all reads before any mark, as the JAX scatter does);
//     score them; merge as the stable argsort of [beam | neighbours] does
//     (beam entries first on equal distances, neighbours in adjacency
//     order) and keep `ef` entries with their expanded flags. Stop at beam
//     exhaustion or after `max_steps` expansions.
//   * Scoring: the five metrics of `gather_distance`
//     (weaviate_tpu/ops/distance.py:104-140). dot and cosine at bf16 round
//     the query and the row to bfloat16 (round to nearest even) and sum the
//     products in float32; l2-squared sums the float32 difference squared.
//
// Visited set: one bit a node and a query, [b, ceil(n/32)] uint32, zeroed
// by the caller (the JAX program keeps a [B, N] uint8 array). It is exact,
// so the same ids come out. Bits are read with ld.global.cg (L2), since the
// marks of the step before were made with atomics.
//
// Bound on this card: the walk is a dependent chain of hops. Each hop reads
// one adjacency row, then the rows it scores, then merges, and the next hop
// cannot start before the merge ends. The least time for the work is the
// bytes actually gathered over 3.35 TB/s: (scored rows x D x 4) + (adjacency
// rows read x M0 x 4, upper rows x M x 4); the kernel reports both counts
// per query when `stats` is given. At D = 25 that bound is far below the
// chain's latency: this first kernel is right and simple, not fast.
//
// Design: one block of 256 threads a query. The query (bf16-rounded where
// the metric asks) and a double-buffered beam of at most 512 entries live in
// shared memory. Candidates are scored by groups of G lanes (G = 4..32 by D;
// lanes stride over D, a shuffle sums the group), so 256/G candidates are
// scored at once. Rows are D floats at any 4-byte offset (D = 25 rows are
// 100 bytes): only scalar loads, no TMA, no vector loads. The merge ranks
// every entry by counting (new entries: against the other new entries, and
// a binary search in the sorted beam) and scatters into the other buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxEf = 512;
constexpr int kMaxWidth = 128;  // M0 and M
constexpr int kMaxD = 4096;
constexpr float kMask = 1e30f;  // MASK_DISTANCE of ops/distance.py
constexpr int kNone = 0x7fffffff;

enum Metric { kL2 = 0, kDot = 1, kCosine = 2, kManhattan = 3, kHamming = 4 };

// error codes of the C interface beside cudaError_t values (those are > 0)
enum Refused {
  kBadShape = -1,
  kBadEf = -2,
  kBadWidth = -3,
  kBadDims = -4,
  kBadMetric = -5,
};

struct Params {
  const float* queries;      // [b, d]
  const float* corpus;       // [n, d]
  const int* adj;            // [n, m0], -1 padded
  const uint8_t* present;    // [n]
  const int* eps;            // [b]
  const int* upper_adj;      // [levels, s, m], top level first
  const int* upper_slots;    // [levels, n], -1 = absent at that level
  uint32_t* visited;         // [b, words], zeroed
  int* out_ids;              // [b, ef]
  float* out_d;              // [b, ef]
  int* stats;                // [b, 4] or null
  int n, d, m0, levels, s, m, ef, max_steps, words, group;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Distance of the shared query `q` to corpus row `row`, summed by a group of
// G lanes (lane `gl` of the group strides over D). Every lane of the warp
// must call it; a lane whose group has no row passes row < 0.
template <int METRIC, bool ROUND>
__device__ __forceinline__ float group_distance(const Params& p,
                                                const float* q, int row,
                                                int gl, int G) {
  float acc = 0.f;
  if (row >= 0) {
    const float* c = p.corpus + (size_t)row * p.d;
    for (int k = gl; k < p.d; k += G) {
      float x = __ldg(c + k);
      float y = q[k];
      if (METRIC == kL2) {
        float t = y - x;
        acc += t * t;
      } else if (METRIC == kDot || METRIC == kCosine) {
        if (ROUND) x = bf16_round(x);
        acc += y * x;
      } else if (METRIC == kManhattan) {
        acc += fabsf(y - x);
      } else {
        acc += (y != x) ? 1.f : 0.f;
      }
    }
  }
  for (int off = G >> 1; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off, G);
  if (METRIC == kDot) return -acc;
  if (METRIC == kCosine) return 1.f - acc;
  return acc;
}

// Scores ids[0..count) into out[0..count); every thread calls it.
template <int METRIC, bool ROUND>
__device__ void score_list(const Params& p, const float* q, const int* ids,
                           float* out, int count) {
  const int G = p.group;
  const int groups = kThreads / G;
  const int gid = threadIdx.x / G, gl = threadIdx.x % G;
  for (int base = 0; base < count; base += groups) {
    int c = base + gid;
    int row = c < count ? ids[c] : -1;
    float v = group_distance<METRIC, ROUND>(p, q, row, gl, G);
    if (gl == 0 && c < count) out[c] = v;
  }
  __syncthreads();
}

// Writes the ids of the threads with `ok` to out[], in thread order, and
// returns their count to every thread.
__device__ int compact(bool ok, int id, int* out, int* warp_count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned bal = __ballot_sync(0xffffffffu, ok);
  if (lane == 0) warp_count[warp] = __popc(bal);
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    int c = warp_count[w];
    base += w < warp ? c : 0;
    total += c;
  }
  if (ok) out[base + __popc(bal & ((1u << lane) - 1u))] = id;
  __syncthreads();
  return total;
}

template <int METRIC, bool ROUND>
__global__ void __launch_bounds__(kThreads)
fused_search_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dpad = (p.d + 3) & ~3;
  float* q = reinterpret_cast<float*>(smem);
  int* beam_id = reinterpret_cast<int*>(q + dpad);           // [2][ef]
  float* beam_d = reinterpret_cast<float*>(beam_id + 2 * p.ef);
  int* beam_exp = reinterpret_cast<int*>(beam_d + 2 * p.ef);
  int* cand_id = beam_exp + 2 * p.ef;                          // [kMaxWidth]
  float* cand_d = reinterpret_cast<float*>(cand_id + kMaxWidth);

  __shared__ int warp_count[kWarps];
  __shared__ int s_first, s_next, s_beam_n, s_cur;
  __shared__ float s_cur_d;

  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  const float* qrow = p.queries + (size_t)qi * p.d;
  for (int k = tid; k < p.d; k += kThreads) {
    float v = qrow[k];
    q[k] = ROUND ? bf16_round(v) : v;
  }
  uint32_t* vis = p.visited + (size_t)qi * p.words;
  int scored = 0, adj_rows = 0, upper_rows = 0, expansions = 0;  // tid 0

  int cur = p.eps[qi];
  float cur_d = kMask;
  if (tid == 0) cand_id[0] = cur;
  __syncthreads();
  if (cur >= 0) {
    score_list<METRIC, ROUND>(p, q, cand_id, cand_d, 1);
    cur_d = cand_d[0];
    scored = 1;
  }

  // -- upper-layer greedy descent ---------------------------------------
  if (cur >= 0) {
    for (int li = 0; li < p.levels; ++li) {
      const int* slots = p.upper_slots + (size_t)li * p.n;
      const int* uadj = p.upper_adj + (size_t)li * p.s * p.m;
      for (int step = 0; step < p.max_steps; ++step) {
        const int slot = slots[cur];
        if (slot < 0) break;  // absent at this level: every score masked
        int nb = -1;
        bool ok = false;
        if (tid < p.m) {
          nb = uadj[(size_t)slot * p.m + tid];
          ok = nb >= 0 && p.present[nb];
        }
        const int count = compact(ok, nb, cand_id, warp_count);
        score_list<METRIC, ROUND>(p, q, cand_id, cand_d, count);
        if (tid < 32) {  // first index of the minimum
          float best = kMask;
          int bi = kNone;
          for (int c = tid; c < count; c += 32) {
            float v = cand_d[c];
            if (v < best) { best = v; bi = c; }
          }
          for (int off = 16; off > 0; off >>= 1) {
            float ov = __shfl_xor_sync(0xffffffffu, best, off);
            int oi = __shfl_xor_sync(0xffffffffu, bi, off);
            if (ov < best || (ov == best && oi < bi)) { best = ov; bi = oi; }
          }
          if (tid == 0) {
            // all masked: the JAX argmin lands on a masked slot (1e30)
            bool move = bi != kNone && best < cur_d;
            s_cur = move ? cand_id[bi] : -1;
            s_cur_d = best;
            scored += count;
            upper_rows += 1;
          }
        }
        __syncthreads();
        if (s_cur < 0) break;
        cur = s_cur;
        cur_d = s_cur_d;
        __syncthreads();
      }
    }
  }

  // -- layer-0 best-first beam ------------------------------------------
  for (int i = tid; i < p.ef; i += kThreads) {
    beam_id[i] = -1;
    beam_d[i] = kMask;
    beam_exp[i] = 0;
  }
  if (tid == 0) {
    beam_id[0] = cur;
    beam_d[0] = cur_d;
    s_beam_n = cur >= 0 ? 1 : 0;
    s_first = cur >= 0 ? 0 : kNone;
    s_next = kNone;
    if (cur >= 0) atomicOr(vis + (cur >> 5), 1u << (cur & 31));
  }
  __syncthreads();
  int buf = 0;
  for (int step = 0; step < p.max_steps; ++step) {
    const int first = s_first, beam_n = s_beam_n;
    if (first >= beam_n) break;  // nothing left to expand
    int* src_id = beam_id + buf * p.ef;
    float* src_d = beam_d + buf * p.ef;
    int* src_exp = beam_exp + buf * p.ef;
    int* dst_id = beam_id + (buf ^ 1) * p.ef;
    float* dst_d = beam_d + (buf ^ 1) * p.ef;
    int* dst_exp = beam_exp + (buf ^ 1) * p.ef;
    const int node = src_id[first];
    int nb = -1;
    bool ok = false;
    if (tid < p.m0) {
      nb = p.adj[(size_t)node * p.m0 + tid];
      if (nb >= 0 && p.present[nb])
        ok = !((__ldcg(vis + (nb >> 5)) >> (nb & 31)) & 1u);
    }
    __syncthreads();  // every read of the visited bits before any mark
    if (tid == 0) src_exp[first] = 1;
    if (ok) atomicOr(vis + (nb >> 5), 1u << (nb & 31));
    const int nn = compact(ok, nb, cand_id, warp_count);
    score_list<METRIC, ROUND>(p, q, cand_id, cand_d, nn);

    // merge: the stable order of [beam | new], first ef kept
    if (tid < nn) {
      const float dc = cand_d[tid];
      int r = 0;
      for (int k = 0; k < nn; ++k) {
        float dk = cand_d[k];
        r += (dk < dc) || (dk == dc && k < tid);
      }
      int lo = 0, hi = beam_n;  // beam entries with d <= dc come first
      while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (src_d[mid] <= dc) lo = mid + 1; else hi = mid;
      }
      const int pos = r + lo;
      if (pos < p.ef) {
        dst_id[pos] = cand_id[tid];
        dst_d[pos] = dc;
        dst_exp[pos] = 0;
        atomicMin(&s_next, pos);
      }
    }
    for (int i = tid; i < beam_n; i += kThreads) {
      const float di = src_d[i];
      int c = 0;
      for (int k = 0; k < nn; ++k) c += cand_d[k] < di;
      const int pos = i + c;
      if (pos < p.ef) {
        const int e = src_exp[i];
        dst_id[pos] = src_id[i];
        dst_d[pos] = di;
        dst_exp[pos] = e;
        if (!e) atomicMin(&s_next, pos);
      }
    }
    __syncthreads();
    if (tid == 0) {
      s_beam_n = min(p.ef, beam_n + nn);
      s_first = s_next;
      s_next = kNone;
      scored += nn;
      adj_rows += 1;
      expansions += 1;
    }
    buf ^= 1;
    __syncthreads();
  }

  const int beam_n = s_beam_n;
  const int* fin_id = beam_id + buf * p.ef;
  const float* fin_d = beam_d + buf * p.ef;
  for (int i = tid; i < p.ef; i += kThreads) {
    p.out_ids[(size_t)qi * p.ef + i] = i < beam_n ? fin_id[i] : -1;
    p.out_d[(size_t)qi * p.ef + i] = i < beam_n ? fin_d[i] : kMask;
  }
  if (tid == 0 && p.stats != nullptr) {
    int* st = p.stats + (size_t)qi * 4;
    st[0] = expansions;
    st[1] = scored;
    st[2] = adj_rows;
    st[3] = upper_rows;
  }
}

int group_for(int d) {
  if (d <= 32) return 4;
  if (d <= 64) return 8;
  if (d <= 256) return 16;
  return 32;
}

size_t smem_bytes(int d, int ef) {
  return (size_t)((d + 3) & ~3) * 4 + (size_t)ef * 2 * 12 +
         (size_t)kMaxWidth * 8;
}

template <int METRIC, bool ROUND>
cudaError_t launch(const Params& p, int b, cudaStream_t stream) {
  size_t smem = smem_bytes(p.d, p.ef);
  auto kern = fused_search_kernel<METRIC, ROUND>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<b, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the fused walk of `b` queries on `stream`. Returns 0, a
// cudaError_t (> 0), or a negative code for arguments outside the kernel's
// contract (see device_beam_error_string).
int device_beam_search(const float* queries, const float* corpus,
                       const int* adj, const uint8_t* present, const int* eps,
                       const int* upper_adj, const int* upper_slots,
                       uint32_t* visited, int* out_ids, float* out_d,
                       int* stats, int b, int n, int d, int m0, int levels,
                       int s, int m, int ef, int max_steps, int metric,
                       int bf16, void* stream) {
  if (b < 1 || n < 1 || max_steps < 0 || levels < 0) return kBadShape;
  if (ef < 1 || ef > kMaxEf) return kBadEf;
  if (m0 < 1 || m0 > kMaxWidth || (levels > 0 && (m < 1 || m > kMaxWidth ||
                                                  s < 1)))
    return kBadWidth;
  if (d < 1 || d > kMaxD) return kBadDims;
  Params p;
  p.queries = queries;
  p.corpus = corpus;
  p.adj = adj;
  p.present = present;
  p.eps = eps;
  p.upper_adj = upper_adj;
  p.upper_slots = upper_slots;
  p.visited = visited;
  p.out_ids = out_ids;
  p.out_d = out_d;
  p.stats = stats;
  p.n = n;
  p.d = d;
  p.m0 = m0;
  p.levels = levels;
  p.s = s;
  p.m = m;
  p.ef = ef;
  p.max_steps = max_steps;
  p.words = (n + 31) / 32;
  p.group = group_for(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  const bool round = bf16 != 0;
  switch (metric) {
    case kL2: e = launch<kL2, false>(p, b, st); break;
    case kDot:
      e = round ? launch<kDot, true>(p, b, st) : launch<kDot, false>(p, b, st);
      break;
    case kCosine:
      e = round ? launch<kCosine, true>(p, b, st)
                : launch<kCosine, false>(p, b, st);
      break;
    case kManhattan: e = launch<kManhattan, false>(p, b, st); break;
    case kHamming: e = launch<kHamming, false>(p, b, st); break;
    default: return kBadMetric;
  }
  return static_cast<int>(e);
}

const char* device_beam_error_string(int code) {
  switch (code) {
    case kBadShape: return "b, n >= 1, max_steps, levels >= 0 required";
    case kBadEf: return "ef outside [1, 512]";
    case kBadWidth: return "adjacency width outside [1, 128]";
    case kBadDims: return "D outside [1, 4096]";
    case kBadMetric: return "unknown metric code";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
