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
// The candidates come from postings: query r's columns are the sorted union
// of the rows of the postings it probes (each row once), padded with ids not
// below its last (the index pads with n - 1), so that the whole row is
// sorted; padding is masked. The posting snapshot stays on the card as a CSR
// (rows, off: ops/hfresh.py posting_table, rebuilt only when the postings
// change), and a batch passes only what it probes, probe [b, nprobe]
// (posting ids: posting_operands).
//
// Bound on this card: bytes, the unique kept rows once (2 D float32
// operations a kept pair against 4 D bytes a row read once for about ten
// queries: under the float32 ridge of 20 operations a byte). A query
// probes 8 postings of about 80 rows and a posting is probed by about 8
// of a batch's 256 queries, so the rows a batch reads are the probed
// postings' entries, not its (query, row) pairs. Three kernels, on one
// stream, with nothing between them:
//
//   0. The inverse, one CTA: the queries that probe each posting (a count
//      a posting by atomics, one block scan of the counts and of each
//      posting's tiles, a scatter) and each tile's posting, so that the
//      host does no per-batch grouping. A posting's queries come in the
//      atomics' order, which changes no result: a pair's key depends on
//      its row and query alone.
//   1. The scoring pass, CTAs that walk the batch's tiles (up to
//      kTileQueries of the queries that probe a posting, by up to kTileRows
//      of its rows). The tile's queries are staged in shared
//      memory; each warp takes kWarpRows of the tile's rows, its lanes
//      read them in 16-byte loads straight into registers (D % 4 == 0;
//      4-byte loads otherwise) and take every (row, query) product of the
//      tile from there, so a probed posting is read once a tile of
//      queries, not once a (query, row) pair. A posting's rows are split
//      over tiles (a warp a step of kWarpRows rows): the chain of a step
//      (the rows' loads, the products, the reduction, the search) is long,
//      and the split puts every step of the batch in flight at once
//      (PERF.md: with a CTA a whole posting, tiles of 16 queries and 2
//      rows a warp, 0.107 ms). A lane's partial sum runs over its own
//      dimensions in order and the warp's 32 partials are summed by the
//      same tree of shuffles for every pair (a transpose reduction: 31
//      shuffles leave lane L the sum of pair L), so a pair's distance
//      depends on its row and query alone, not on the tile. Each lane then
//      finds its pair's column by a binary search of the row id in the
//      query's sorted candidates (the first column holding it: padding
//      that repeats the id comes after it and is masked) and writes the
//      64-bit key (the distance's order-preserving bits, -0 as +0, then
//      the column) there in a [b, c] scratch. A row that two probed
//      postings of one query hold (a replica) writes the same bits to the
//      same slot twice.
//   2. The select pass, a CTA a query row over its c keys: a column whose
//      mask is off takes the key of MASK_DISTANCE without reading the
//      scratch (so the scratch needs no fill: every column with its mask
//      on was written by the scoring pass), then a radix select (8 bits a
//      pass from the top, a shared-memory histogram each; it stops at the
//      first pass whose chosen bin holds exactly the keys still wanted)
//      finds the kk-th smallest key exactly, the keys not above it are
//      collected and each one's count of smaller kept keys places it. The
//      keys stay in shared memory where they fit, else in the scratch.
//
// The scoring and the select pass are launched as programmatic dependents
// of the kernel before them on the stream: each starts while that one
// finishes and waits for its results (griddepcontrol.wait) before reading
// them, so the launches' gaps overlap the work.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileQueries = 8;     // queries a scoring tile
constexpr int kWarpRows = 4;        // rows a warp scores at a time
constexpr int kTileRows = kWarps * kWarpRows;  // rows a scoring tile
constexpr int kBins = 256;          // radix select: 8 bits a pass
constexpr int kMisc = 16;           // 4-byte words of scalars in shared memory
constexpr int kInvertThreads = 1024;  // the inverse's one CTA
constexpr int kScoreCtasPerSm = 8;  // the scoring pass's CTAs an SM at most
constexpr int kMaxDevices = 64;
constexpr int kCallBytes = 160;     // a packed PostingCall: 14 Q, 12 i
constexpr float kMask = 1e30f;      // MASK_DISTANCE of ops/distance.py
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarpRows * kTileQueries == 32, "a lane a (row, query) pair");

enum Metric { kL2 = 0, kDot = 1, kCosine = 2, kManhattan = 3, kHamming = 4 };

// error codes of the C interface beside cudaError_t values (those are > 0)
enum Refused {
  kBadShape = -1,
  kBadMetric = -2,
  kBadK = -3,
  kBadSmem = -4,
  kBadScratch = -5,
};

struct InvertParams {
  const int* probe;         // [s]: query s / nprobe probes posting probe[s]
  const int* off;           // [postings + 1]: the table's offsets
  int* cnt;                 // [postings]: a posting's probing queries
  int* qstart;              // [postings + 1]: where they start in qlist
  int* tstart;              // [postings + 1]: a posting's first tile
  int* pos;                 // [s]: a probe's place among its posting's
  int* qlist;               // [s]: the queries, posting after posting
  int* tile_post;           // [tiles_max]: each tile's posting
  int postings, s, nprobe, tiles_max;
};

struct ScoreParams {
  const float* q;           // [b, d]
  const float* corpus;      // [n, d]
  const uint8_t* valid;     // [n]
  const int* cand;          // [b, c], each row sorted, ids once
  const int* rows;          // every posting's rows, posting after posting
  const int* off;           // [postings + 1]
  const int* qlist;         // the inverse's outputs
  const int* qstart;
  const int* tstart;
  const int* tile_post;
  uint64_t* keys;           // [b, c]
  int c, n, d, dpad, postings, tiles_max;
};

struct SelectParams {
  const uint8_t* mask;      // [b, c]
  uint64_t* keys_g;         // [b, c]: the scoring pass's keys
  uint64_t* sel_g;          // [b, kk] where the kept keys do not fit
  float* out_d;             // [b, kk]
  int* out_c;               // [b, kk]
  int c, kk, keys_smem, sel_smem;
};

// bytes of a select CTA's shared memory before the keys: the histogram and
// the scalars
__host__ __device__ inline int head_bytes() { return 4 * kBins + 4 * kMisc; }

// bytes of a scoring CTA's shared memory: the tile's queries, each rounded
// to 16 bytes
__host__ __device__ inline long long score_bytes(int d) {
  return 4LL * kTileQueries * ((d + 3) & ~3);
}

// the most tiles a batch of `s` probes can have where no posting holds
// more than `max_len` rows: each probe at most its posting's row tiles
__host__ __device__ inline long long tiles_most(int s, int max_len) {
  return static_cast<long long>(s) * ((max_len + kTileRows - 1) / kTileRows);
}

// ints of the inverse's scratch: cnt, qstart, tstart, pos, qlist,
// tile_post
__host__ __device__ inline long long invert_ints(int postings, int s,
                                                 int max_len) {
  return 3LL * postings + 2 + 2LL * s + tiles_most(s, max_len);
}

// programmatic dependent launch: let the next kernel on the stream start,
// and wait for the kernel before this one to finish (a no-op in a kernel
// launched without the attribute)
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// the scoring tiles of a posting of `len` rows probed by `nq` queries
__device__ __forceinline__ int tiles_of(int nq, int len) {
  return ((nq + kTileQueries - 1) / kTileQueries) *
         ((len + kTileRows - 1) / kTileRows);
}

template <int M>
__device__ __forceinline__ float term(float q, float x) {
  if (M == kL2) {
    const float t = q - x;
    return t * t;
  }
  if (M == kManhattan) return fabsf(q - x);
  if (M == kHamming) return q != x ? 1.0f : 0.0f;
  return q * x;
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

// one step of the transpose reduction: the lanes whose bit H is clear keep
// values [0, H), the others [H, 2H), each adding its partner's partial of
// the values it keeps
template <int H>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

// the inverse, one CTA: each posting's probing queries (cnt, qstart,
// qlist) and its first tile (tstart; tstart[postings] the batch's tiles)
__global__ void __launch_bounds__(kInvertThreads)
    posting_invert_kernel(const InvertParams p) {
  __shared__ int s_q[kInvertThreads / 32], s_t[kInvertThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int np = p.postings;
  launch_dependents();
  for (int i = tid; i < np; i += kInvertThreads) p.cnt[i] = 0;
  __syncthreads();
  for (int i = tid; i < p.s; i += kInvertThreads)
    p.pos[i] = atomicAdd(p.cnt + p.probe[i], 1);
  __syncthreads();
  // a block scan of (queries, tiles) over the postings, a run a thread
  const int per = (np + kInvertThreads - 1) / kInvertThreads;
  const int lo = min(np, tid * per), hi = min(np, lo + per);
  int sq = 0, st = 0;
  for (int i = lo; i < hi; ++i) {
    const int n = p.cnt[i];
    sq += n;
    st += tiles_of(n, p.off[i + 1] - p.off[i]);
  }
  int iq = sq, it = st;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int tq = __shfl_up_sync(kFull, iq, o);
    const int tt = __shfl_up_sync(kFull, it, o);
    if (lane >= o) {
      iq += tq;
      it += tt;
    }
  }
  if (lane == 31) {
    s_q[warp] = iq;
    s_t[warp] = it;
  }
  __syncthreads();
  if (warp == 0) {
    int wq = s_q[lane], wt = s_t[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int tq = __shfl_up_sync(kFull, wq, o);
      const int tt = __shfl_up_sync(kFull, wt, o);
      if (lane >= o) {
        wq += tq;
        wt += tt;
      }
    }
    s_q[lane] = wq;
    s_t[lane] = wt;
  }
  __syncthreads();
  int bq = (warp ? s_q[warp - 1] : 0) + iq - sq;
  int bt = (warp ? s_t[warp - 1] : 0) + it - st;
  for (int i = lo; i < hi; ++i) {
    const int n = p.cnt[i];
    const int nt = tiles_of(n, p.off[i + 1] - p.off[i]);
    p.qstart[i] = bq;
    p.tstart[i] = bt;
    for (int t = bt; t < bt + nt && t < p.tiles_max; ++t) p.tile_post[t] = i;
    bq += n;
    bt += nt;
  }
  if (tid == kInvertThreads - 1) {  // its run ends the postings
    p.qstart[np] = bq;
    p.tstart[np] = bt;
  }
  __syncthreads();
  for (int i = tid; i < p.s; i += kInvertThreads)
    p.qlist[p.qstart[p.probe[i]] + p.pos[i]] = i / p.nprobe;
}

template <int M, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    posting_score_kernel(const ScoreParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_qid[kTileQueries], s_tile[4];
  float* qs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = p.d, dpad = p.dpad;
  launch_dependents();
  wait_prerequisite();
  const int ntiles = min(p.tstart[p.postings], p.tiles_max);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    if (tid == 0) {
      const int post = p.tile_post[tile];
      const int r_lo = p.off[post], r_hi = p.off[post + 1];
      const int q_lo = p.qstart[post], q_hi = p.qstart[post + 1];
      const int across = (r_hi - r_lo + kTileRows - 1) / kTileRows;
      const int at = tile - p.tstart[post];
      const int q0 = q_lo + kTileQueries * (at / across);
      const int r0 = r_lo + kTileRows * (at % across);
      s_tile[0] = q0;
      s_tile[1] = min(kTileQueries, q_hi - q0);
      s_tile[2] = r0;
      s_tile[3] = min(kTileRows, r_hi - r0);
    }
    __syncthreads();
    const int q0 = s_tile[0], nq = s_tile[1], r0 = s_tile[2], nr = s_tile[3];
    if (tid < kTileQueries) s_qid[tid] = tid < nq ? p.qlist[q0 + tid] : 0;
    __syncthreads();
    for (int e = tid; e < nq * dpad; e += kThreads) {
      const int t = e / dpad, i = e - t * dpad;
      qs[e] = i < d ? p.q[static_cast<size_t>(s_qid[t]) * d + i] : 0.0f;
    }
    __syncthreads();

    for (int base = warp * kWarpRows; base < nr; base += kTileRows) {
      int rid[kWarpRows];
      bool live[kWarpRows];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
        const bool in = base + r < nr;
        rid[r] = in ? min(max(p.rows[r0 + base + r], 0), p.n - 1) : 0;
        live[r] = in && p.valid[rid[r]];
      }
      // v[r * kTileQueries + t]: this lane's partial of (row r, query t)
      float v[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = 0.0f;
      if (VEC) {
        for (int i = 4 * lane; i < d; i += 128) {
          float4 x[kWarpRows];
#pragma unroll
          for (int r = 0; r < kWarpRows; ++r)
            x[r] = live[r]
                       ? __ldg(reinterpret_cast<const float4*>(
                             p.corpus + static_cast<size_t>(rid[r]) * d + i))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int t = 0; t < kTileQueries; ++t) {
            if (t < nq) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qs + t * dpad + i);
#pragma unroll
              for (int r = 0; r < kWarpRows; ++r) {
                float& a = v[r * kTileQueries + t];
                a += term<M>(qv.x, x[r].x);
                a += term<M>(qv.y, x[r].y);
                a += term<M>(qv.z, x[r].z);
                a += term<M>(qv.w, x[r].w);
              }
            }
          }
        }
      } else {
        for (int i = lane; i < d; i += 32) {
          float x[kWarpRows];
#pragma unroll
          for (int r = 0; r < kWarpRows; ++r)
            x[r] = live[r] ? __ldg(p.corpus + static_cast<size_t>(rid[r]) * d +
                                   i)
                           : 0.0f;
#pragma unroll
          for (int t = 0; t < kTileQueries; ++t) {
            if (t < nq) {
              const float qv = qs[t * dpad + i];
#pragma unroll
              for (int r = 0; r < kWarpRows; ++r)
                v[r * kTileQueries + t] += term<M>(qv, x[r]);
            }
          }
        }
      }
      // the same tree as a butterfly of xor 16, 8, 4, 2, 1 over one value
      halve<16>(v, lane);
      halve<8>(v, lane);
      halve<4>(v, lane);
      halve<2>(v, lane);
      halve<1>(v, lane);
      const int r = lane / kTileQueries, t = lane % kTileQueries;
      int id = rid[0];
      bool ok = live[0];
#pragma unroll
      for (int i = 1; i < kWarpRows; ++i) {
        if (r == i) {
          id = rid[i];
          ok = live[i];
        }
      }
      if (base + r < nr && t < nq) {
        const float dist = !ok ? kMask
                           : M == kDot ? -v[0]
                           : M == kCosine ? 1.0f - v[0] : v[0];
        const int qi = s_qid[t], len = p.c;
        const int* row = p.cand + static_cast<size_t>(qi) * p.c;
        int lo = 0, hi = len;  // the first column whose id is not below id
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (__ldg(row + mid) < id)
            lo = mid + 1;
          else
            hi = mid;
        }
        if (lo < len && __ldg(row + lo) == id)
          p.keys[static_cast<size_t>(qi) * p.c + lo] = make_key(dist, lo);
      }
    }
    __syncthreads();  // the tile's queries are read before the next's
  }
}

__global__ void __launch_bounds__(kThreads)
    posting_select_kernel(const SelectParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = p.c, kk = p.kk;
  unsigned* hist = reinterpret_cast<unsigned*>(smem);
  unsigned* misc = hist + kBins;
  uint64_t* scratch = p.keys_g + static_cast<size_t>(row) * c;
  uint64_t* keys = p.keys_smem
                       ? reinterpret_cast<uint64_t*>(smem + head_bytes())
                       : scratch;
  uint64_t* sel =
      p.sel_smem
          ? reinterpret_cast<uint64_t*>(smem + head_bytes() +
                                        (p.keys_smem ? 8 * c : 0))
          : p.sel_g + static_cast<size_t>(row) * kk;
  wait_prerequisite();

  // 1. the row's keys: a column whose mask is off the mask's key
  const uint8_t* mask = p.mask + static_cast<size_t>(row) * c;
  for (int j = tid; j < c; j += kThreads) {
    if (!mask[j])
      keys[j] = make_key(kMask, j);
    else if (p.keys_smem)
      keys[j] = scratch[j];
  }
  __syncthreads();

  // 2. the kk-th smallest key, 8 bits a pass from the top; where the
  // chosen bin holds exactly the keys still wanted, every key of it is
  // kept and the passes stop
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
            misc[3] = below + h == want;
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
    if (misc[3]) {  // the whole bin is kept: every key below its end
      if (shift) prefix |= (static_cast<uint64_t>(1) << shift) - 1;
      break;
    }
  }
  // every thread has read misc[0..1] and misc[3]; misc[2] is the
  // collect's counter
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

using ScoreFn = void (*)(const ScoreParams);

template <bool VEC>
ScoreFn score_fn(int metric) {
  switch (metric) {
    case kL2: return posting_score_kernel<kL2, VEC>;
    case kDot: return posting_score_kernel<kDot, VEC>;
    case kCosine: return posting_score_kernel<kCosine, VEC>;
    case kManhattan: return posting_score_kernel<kManhattan, VEC>;
    default: return posting_score_kernel<kHamming, VEC>;
  }
}

// each device's dynamic shared memory a block can take (the opt-in limit
// less the largest static part of the kernels) and its SMs, read once,
// with every kernel's limit raised to it once
struct Device {
  int smem_max = 0;
  int sms = 0;
  cudaError_t err = cudaSuccess;
  std::once_flag once;
};
Device g_devices[kMaxDevices];

cudaError_t device_info(int dev, const Device** out) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Device& g = g_devices[dev];
  std::call_once(g.once, [&] {
    const void* fns[2 * (kHamming + 1) + 1];
    int nf = 0;
    for (int m = kL2; m <= kHamming; ++m) {
      fns[nf++] = reinterpret_cast<const void*>(score_fn<true>(m));
      fns[nf++] = reinterpret_cast<const void*>(score_fn<false>(m));
    }
    fns[nf++] = reinterpret_cast<const void*>(posting_select_kernel);
    int optin = 0;
    g.err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (g.err == cudaSuccess)
      g.err = cudaDeviceGetAttribute(&g.sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    size_t stat = 0;
    for (int i = 0; i < nf && g.err == cudaSuccess; ++i) {
      cudaFuncAttributes fa;
      g.err = cudaFuncGetAttributes(&fa, fns[i]);
      if (g.err == cudaSuccess && fa.sharedSizeBytes > stat)
        stat = fa.sharedSizeBytes;
    }
    g.smem_max = optin - static_cast<int>(stat);
    for (int i = 0; i < nf && g.err == cudaSuccess; ++i)
      g.err = cudaFuncSetAttribute(
          fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_max);
  });
  *out = &g;
  return g.err;
}

// launches `fn` on `stream` as a programmatic dependent of the kernel
// before it there (it starts while that one finishes; the kernel waits for
// its results with griddepcontrol.wait)
cudaError_t launch_dependent(const void* fn, int grid, size_t smem,
                             cudaStream_t stream, void** args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelExC(&cfg, fn, args);
  return e != cudaSuccess ? e : cudaGetLastError();
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
// ops/hfresh.py packs them), a PostingCall, on `stream`: the inverse (one
// CTA) and the scoring pass (CTAs walking the tiles), none where no posting
// has a row, then the select pass, a CTA a query row of `b`. Queries `q` [b,
// d], the store's `corpus` [n, d] and `valid` [n] (one byte a row),
// candidates `cand` [b, c] (int32 in [0, n), each row sorted, an id once but
// in padding), `mask` [b, c] (one byte a column, off on padding), `probe`
// [b, nprobe] (posting ids in [0, postings)), the posting table `rows` and
// `off` [postings + 1] (int32; `max_len` its longest posting); `metric` 0
// l2-squared, 1 dot, 2 cosine, 3 manhattan, 4 hamming. `scratch` holds the
// inverse's invert_ints(postings, b nprobe, max_len) ints. The keys go to
// `keys_g` [b, c] (8 bytes a key), then to shared memory where `keys_smem`;
// the kept keys in shared memory where `sel_smem`, else in `sel_g` [b, kk].
// `smem` bytes a select CTA. Writes out_d / out_c [b, kk]. Returns 0, a
// cudaError_t (> 0), or a negative code for arguments outside the kernel's
// contract (see hfresh_error_string).
int hfresh_posting_topk(const unsigned char* call) {
  struct PostingCall {
    uint64_t q, corpus, valid, cand, mask, probe, rows, off, scratch, keys_g,
        sel_g, out_d, out_c, stream;
    int32_t b, c, n, d, kk, metric, postings, nprobe, max_len, keys_smem,
        sel_smem, smem;
  } a;
  static_assert(sizeof(uint64_t) * 14 + sizeof(int32_t) * 12 == kCallBytes,
                "PostingCall layout");
  memcpy(&a, call, kCallBytes);
  if (a.b < 1 || a.c < 1 || a.n < 1 || a.d < 1 || a.postings < 0 ||
      a.nprobe < 0 || a.max_len < 0)
    return kBadShape;
  if (a.metric < kL2 || a.metric > kHamming) return kBadMetric;
  if (a.kk < 1 || a.kk > a.c) return kBadK;
  const bool score = a.postings > 0 && a.nprobe > 0 && a.max_len > 0;
  if (!a.keys_g || (!a.sel_smem && !a.sel_g) || (score && !a.scratch))
    return kBadScratch;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const Device* g = nullptr;
  if (e == cudaSuccess) e = device_info(dev, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = head_bytes() + (a.keys_smem ? 8LL * a.c : 0) +
                         (a.sel_smem ? 8LL * a.kk : 0);
  if (a.smem < need || a.smem > g->smem_max ||
      score_bytes(a.d) > g->smem_max)
    return kBadSmem;
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(a.stream);
  if (score) {
    const int s = a.b * a.nprobe;
    int* scratch = reinterpret_cast<int*>(a.scratch);
    InvertParams v;
    v.probe = reinterpret_cast<const int*>(a.probe);
    v.off = reinterpret_cast<const int*>(a.off);
    v.cnt = scratch;
    v.qstart = scratch + a.postings;
    v.tstart = v.qstart + a.postings + 1;
    v.pos = v.tstart + a.postings + 1;
    v.qlist = v.pos + s;
    v.tile_post = v.qlist + s;
    v.postings = a.postings;
    v.s = s;
    v.nprobe = a.nprobe;
    // no more tiles than this, and no more CTAs
    const long long most = tiles_most(s, a.max_len);
    if (most > INT32_MAX) return kBadShape;
    v.tiles_max = static_cast<int>(most);
    posting_invert_kernel<<<1, kInvertThreads, 0, stream>>>(v);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ScoreParams sp;
    sp.q = reinterpret_cast<const float*>(a.q);
    sp.corpus = reinterpret_cast<const float*>(a.corpus);
    sp.valid = reinterpret_cast<const uint8_t*>(a.valid);
    sp.cand = reinterpret_cast<const int*>(a.cand);
    sp.rows = reinterpret_cast<const int*>(a.rows);
    sp.off = v.off;
    sp.qlist = v.qlist;
    sp.qstart = v.qstart;
    sp.tstart = v.tstart;
    sp.tile_post = v.tile_post;
    sp.keys = reinterpret_cast<uint64_t*>(a.keys_g);
    sp.c = a.c;
    sp.n = a.n;
    sp.d = a.d;
    sp.dpad = (a.d + 3) & ~3;
    sp.postings = a.postings;
    sp.tiles_max = v.tiles_max;
    const int grid = static_cast<int>(
        most < static_cast<long long>(kScoreCtasPerSm) * g->sms
            ? most
            : static_cast<long long>(kScoreCtasPerSm) * g->sms);
    const bool vec = a.d % 4 == 0 && a.corpus % 16 == 0;
    const ScoreFn fn = vec ? score_fn<true>(a.metric)
                           : score_fn<false>(a.metric);
    void* args[] = {&sp};
    e = launch_dependent(reinterpret_cast<const void*>(fn), grid,
                         static_cast<size_t>(score_bytes(a.d)), stream,
                         args);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  SelectParams p;
  p.mask = reinterpret_cast<const uint8_t*>(a.mask);
  p.keys_g = reinterpret_cast<uint64_t*>(a.keys_g);
  p.sel_g = reinterpret_cast<uint64_t*>(a.sel_g);
  p.out_d = reinterpret_cast<float*>(a.out_d);
  p.out_c = reinterpret_cast<int*>(a.out_c);
  p.c = a.c;
  p.kk = a.kk;
  p.keys_smem = a.keys_smem;
  p.sel_smem = a.sel_smem;
  void* args[] = {&p};
  return static_cast<int>(launch_dependent(
      reinterpret_cast<const void*>(posting_select_kernel), a.b,
      static_cast<size_t>(a.smem), stream, args));
}

const char* hfresh_error_string(int code) {
  switch (code) {
    case kBadShape: return "b, c, n, d must be >= 1 and postings, nprobe, "
                           "max_len >= 0";
    case kBadMetric: return "metric outside 0-4 (l2-squared, dot, cosine, "
                            "manhattan, hamming)";
    case kBadK: return "kk outside [1, c]";
    case kBadSmem: return "the shared memory is below the layout's or above "
                          "the card's a block";
    case kBadScratch: return "no key scratch, no inverse's scratch, or kept "
                             "keys neither in shared memory nor given a "
                             "scratch";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
