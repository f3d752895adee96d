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
//     means over the kept tokens, each count clamped to at least 1.
//     Here mean_q . mean_c is taken as (sum over kept tokens j of
//     mean_q . c_j) / count: the same value, summed in another order.
//   * Top-k: the `out_k` best scores, descending; equal scores keep the
//     lower candidate position first (lax.top_k's order). An invalid
//     candidate scores -inf; a slot whose score is not finite returns
//     (-1, 1e30), the mask distance.
//
// Bound on this card: a candidate's score costs Tq x T x D multiply-adds
// (2 Tq T D float32 operations) over the T x D x 4 bytes of its kept
// tokens, Tq / 2 operations a byte, against the card's float32 ridge of 20
// (67 TFLOP/s over 3.35 TB/s): bytes bound it up to Tq = 40 (the HNSW
// tier's Tq = 4, and the multivector path's 32 query tokens), operations
// above. At the main path's shapes the work is a microsecond or two, so
// what a launch costs is its chain of dependent steps and how much of the
// card it keeps busy. What the design does:
//
//   1. The card is filled whatever the batch: a CTA takes one query and a
//      group of `cpb` candidates (several where their tokens are few, as
//      on the HNSW tier), and where the batch holds fewer candidates than
//      two CTAs an SM, each candidate's kept tokens are split in `nblk`
//      blocks, one CTA each, the blocks of a candidate one thread block
//      cluster. A max is exact in any order, so each block's maxima per
//      query token, combined by max in the cluster's first CTA through
//      distributed shared memory, give the candidate's exact maxima; the
//      sum over query tokens follows once, there.
//   2. Every lane works at every shape: the dot products of a tile of
//      (query token, kept candidate token) pairs are a register tile, 4
//      query tokens x 2 candidate tokens a thread, over D in chunks of
//      128 floats (the main path's D in one). A tile of at most 32
//      tokens (the multivector path's blocks) puts two row groups in a
//      warp, a half-warp each, so each query row read from shared memory
//      serves two products: reading the tiles, not the products, sets
//      this step's time. Where the query has few tokens (the HNSW tier's
//      4), the CTA's warps split each chunk of D instead of taking more
//      query tokens, and their sums are added in a fixed order.
//   3. The query's live tokens (and the linear module's mean token, as one
//      more row) and the candidates' kept tokens, compacted through a
//      block scan of their mask bytes, are staged in one round where D
//      fits a chunk, else a chunk ahead of use, double-buffered, with
//      16-byte cp.async (4-byte where D is not a multiple of 4): a round
//      through memory costs more than the products of a tile. The
//      products are float32 fused multiply-adds in
//      this kernel (no tensor cores, no TF32, no library call).
//   4. Each tile's products go into their (candidate, query token)
//      maxima: a warp's max over each run of one candidate's columns, then
//      one shared-memory atomic max a run on the float's ordered integer
//      key, exact and independent of order.
//   5. The scores go to a [b, c] scratch; the last CTA of a query (a
//      ticket a query that it wraps back to 0, so nothing is cleared
//      between launches) ranks the c scores by counting, in shared memory
//      where they fit, else from L2: the rank of score i is the number of
//      scores above it plus the number equal to it at a lower position,
//      and ranks below out_k are written out. A score is counted by up to
//      32 lanes at once, each over every 32nd score: a count is a chain
//      of dependent loads, and c of them a lane would be the launch's
//      longest step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <string.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 64;          // candidate tokens a tile: 2 a lane
constexpr int kDK = 128;           // floats of D a staged chunk
constexpr int kPitch = kDK + 4;    // floats a staged row (banks)
constexpr int kWindow = kThreads;  // mask bytes compacted at once
constexpr int kMaxCluster = 8;     // blocks a candidate (portable)
constexpr int kMaxC = 65535;       // candidate groups: grid.y
constexpr int kMaxDevices = 64;
constexpr int kCallBytes = 140;    // a packed RerankCall: 10 Q, 12 i, 3 f
constexpr float kMask = 1e30f;     // MASK_DISTANCE of ops/distance.py
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kMaxSim = 0, kLinear = 1 };

// error codes of the C interface beside cudaError_t values (those are > 0)
enum Refused {
  kBadShape = -1,
  kBadKind = -2,
  kBadK = -3,
  kBadSmem = -4,
  kBadCount = -5,
  kBadPlan = -6,
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
  int cpb;       // candidates a CTA
  int nblk;      // CTAs (token blocks) a candidate: the cluster
  int groups;    // CTA groups of candidates a query: ceil(c / cpb)
  int vec;       // d % 4 == 0 and 16-byte aligned rows: 16-byte copies
  int sel_smem;  // the last CTA stages the c scores in shared memory
};

// Shared memory of a CTA, in 4-byte words: the staged chunks (the tile's
// query rows, then its kCols candidate tokens), the warps' partial
// tile sums, the window's token list (a token's position and its
// candidate in the CTA), the live query tokens, the
// (candidate, query token) maxima, the mean row's products, and per
// candidate its token sum against the mean row, kept count and id; the
// block scan's warp totals; the query's mean token (linear).
struct Layout {
  int stage, red, list, lcl, qlist, best, mrow, msum, kept, cid, scan, qmean;
  int words;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline int stages_for(int d) { return d > kDK ? 2 : 1; }

__host__ __device__ inline Layout layout(int rg, int cpb, int tq, int d,
                                         bool linear) {
  Layout l;
  int w = 0;
  l.stage = w;
  w += stages_for(d) * (4 * rg + kCols) * kPitch;
  l.red = w;
  w += 4 * kWarps * kCols;
  l.list = w;
  w += kWindow;
  l.lcl = w;
  w += kWindow;
  l.qlist = w;
  w += round4(tq);
  l.best = w;
  w += round4(cpb * tq);
  l.mrow = w;
  w += kCols;
  l.msum = w;
  w += round4(cpb);
  l.kept = w;
  w += round4(cpb);
  l.cid = w;
  w += round4(cpb);
  l.scan = w;
  w += 2 * kWarps;
  l.qmean = w;
  w += linear ? round4(d) : 0;
  l.words = w;
  return l;
}

// floats as integers in the same order (for atomicMax), and back
__device__ __forceinline__ int ord_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float ord_val(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Exclusive count of `flag` over the CTA's threads below this one; the
// CTA's total in `total`. Every thread calls it.
__device__ __forceinline__ int block_scan(bool flag, int* wtot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(kFull, flag);
  if (lane == 0) wtot[warp] = __popc(bal);
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = wtot[w];
    before += w < warp ? x : 0;
    all += x;
  }
  __syncthreads();  // wtot is free for the next call
  total = all;
  return before + __popc(bal & ((1u << lane) - 1u));
}

// The kernel's state for one CTA.
struct Cta {
  float* sm;        // the dynamic shared memory as words
  Layout l;
  int qi, blk, c0, ncand;
  int nq;           // live query tokens
  int rows;         // tile rows: nq, plus the mean row (linear)
};

// Stages chunk `kc` of D of the tile's rows [r0, r0 + 4 RG) and columns
// [col0, col0 + ncols) of the window's list into buffer `buf`; the D past
// its end reads as 0. Every thread calls it; completes on the CTA's next
// cp.async wait.
template <int RG>
__device__ void stage_chunk(const Params& p, const Cta& s, int r0, int col0,
                            int ncols, int kc, int buf) {
  constexpr int kRows = 4 * RG;
  float* qs = s.sm + s.l.stage + buf * (kRows + kCols) * kPitch;
  const int* list = reinterpret_cast<const int*>(s.sm + s.l.list);
  const int* lcl = reinterpret_cast<const int*>(s.sm + s.l.lcl);
  const int* qlist = reinterpret_cast<const int*>(s.sm + s.l.qlist);
  const int* cid = reinterpret_cast<const int*>(s.sm + s.l.cid);
  const float* qmean = s.sm + s.l.qmean;
  const int k0 = kc * kDK;
  // copies a row: kDK / 4 of 16 bytes, or kDK of 4 (powers of two)
  const int lg = p.vec ? 5 : 7;
  for (int u = threadIdx.x; u < (kRows + kCols) << lg; u += kThreads) {
    const int r = u >> lg, part = u & ((1 << lg) - 1);
    const int k = k0 + (p.vec ? 4 * part : part);
    float* dst = qs + r * kPitch + (k - k0);
    const float* src = nullptr;
    bool mean = false;
    if (r < kRows) {
      const int rr = r0 + r;
      if (rr < s.nq)
        src = p.q + ((size_t)s.qi * p.tq + qlist[rr]) * p.d;
      else if (rr < s.rows)
        mean = true;
      else
        continue;  // a padding row: its products are never read
    } else {
      const int j = r - kRows;
      if (j >= ncols) continue;  // a padding column: never read
      src = p.tokens + ((size_t)cid[lcl[col0 + j]] * p.t + list[col0 + j]) *
                           p.d;
    }
    if (p.vec) {
      if (k >= p.d)
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      else if (mean)
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(qmean + k);
      else
        cp_async16(dst, src + k);
    } else {
      if (k >= p.d)
        *dst = 0.f;
      else if (mean)
        *dst = qmean[k];
      else
        cp_async4(dst, src + k);
    }
  }
  cp_async_commit();
}

// A thread's share of one staged chunk: 4 rows (row group `rg`) by NC
// columns (c0, c0 + cstep) over the chunk's floats [k0, k0 + SLICE).
template <int NC, int SLICE>
__device__ __forceinline__ void mac(const float* qs, const float* cs, int k0,
                                    int rg, int c0, int cstep,
                                    float (&acc)[4][2]) {
#pragma unroll 8
  for (int kk = k0; kk < k0 + SLICE; kk += 4) {
    float4 a[4], x[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(qs + (rg * 4 + i) * kPitch + kk);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      x[j] = *reinterpret_cast<const float4*>(cs + (c0 + cstep * j) * kPitch +
                                              kk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        acc[i][j] = fmaf(a[i].x, x[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, x[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, x[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, x[j].w, acc[i][j]);
      }
  }
}

// The products of the tile's rows [r0, r0 + 4 RG) and columns [col0, col0
// + ncols) over all of D, each folded into its (candidate, query token)
// maximum, or for the mean row summed into its candidate's `msum`. Every
// thread calls it.
template <int RG>
__device__ void tile(const Params& p, Cta& s, int r0, int col0, int ncols) {
  constexpr int kRows = 4 * RG;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // The warps' layout over the tile. Wide (more than 32 columns): a warp
  // a row group, a lane 2 columns (lane, lane + 32), the 8 / RG warps of a
  // row group splitting each chunk of D. Narrow (32 columns at most) with
  // two row groups or more: a warp two row groups, a half-warp each, a
  // lane 2 columns (lane & 15, + 16), 16 / RG warps splitting D: a lane's
  // 4 query rows' loads serve twice the products of one column a lane.
  // Narrow with one row group: a lane one column, 8 warps splitting D.
  const bool narrow = ncols <= 32;
  const bool halves = narrow && RG >= 2;
  const int wpr = halves ? RG / 2 : RG;  // warps across the rows
  const int ks = warp / wpr, kks = halves ? 16 / RG : 8 / RG;
  const int rg = halves ? 2 * (warp % wpr) + (lane >> 4) : warp % wpr;
  const int c0 = halves ? lane & 15 : lane, cstep = halves ? 16 : 32;
  const int pitch = narrow ? 32 : kCols;  // of the partial sums
  float acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
  const int nk = (p.d + kDK - 1) / kDK;
  stage_chunk<RG>(p, s, r0, col0, ncols, 0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      stage_chunk<RG>(p, s, r0, col0, ncols, kc + 1, (kc + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qs = s.sm + s.l.stage + (kc & 1) * (kRows + kCols) * kPitch;
    const float* cs = qs + kRows * kPitch;
    if (!narrow)
      mac<2, kDK * RG / 8>(qs, cs, ks * (kDK * RG / 8), rg, c0, cstep, acc);
    else if (RG >= 2)
      mac<2, kDK * RG / 16>(qs, cs, ks * (kDK * RG / 16), rg, c0, cstep, acc);
    else
      mac<1, kDK * RG / 8>(qs, cs, ks * (kDK * RG / 8), rg, c0, cstep, acc);
    __syncthreads();  // the buffer is free for the chunk after next
  }
  // the warps' partial sums, added in a fixed order
  float* red = s.sm + s.l.red;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (j == 0 || !narrow || halves)
        red[(ks * kRows + rg * 4 + i) * pitch + c0 + cstep * j] = acc[i][j];
  __syncthreads();
  const int* lcl = reinterpret_cast<const int*>(s.sm + s.l.lcl);
  int* best = reinterpret_cast<int*>(s.sm + s.l.best);
  float* mrow = s.sm + s.l.mrow;
  // a warp takes 32 columns of one live row; a candidate's columns are
  // consecutive, so a max over each run of one candidate's lanes leaves
  // the run's maximum in its first lane, which alone folds it in (not a
  // shared atomic a column on one address)
  const int lgw = narrow ? 5 : 6;  // columns a row: 32 or 64
  const int nrow = min(kRows, s.rows - r0);
  for (int e = threadIdx.x; e < nrow << lgw; e += kThreads) {
    const int i = e >> lgw, j = e & ((1 << lgw) - 1), rr = r0 + i;
    float v = -__builtin_huge_valf();
    int cl = -1;
    if (j < ncols && rr < s.rows) {
      v = red[i * pitch + j];
      for (int w = 1; w < kks; ++w) v += red[(w * kRows + i) * pitch + j];
      if (rr < s.nq)
        cl = lcl[col0 + j];
      else
        mrow[j] = v;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float ov = __shfl_down_sync(kFull, v, o);
      const int oc = __shfl_down_sync(kFull, cl, o);
      if (lane + o < 32 && oc == cl) v = fmaxf(v, ov);
    }
    const int up = __shfl_up_sync(kFull, cl, 1);
    if (cl >= 0 && (lane == 0 || up != cl))
      atomicMax(best + cl * p.tq + rr, ord_key(v));
  }
  __syncthreads();
  if (s.nq >= r0 && s.nq < r0 + kRows && s.rows > s.nq) {
    // the mean row's products summed a candidate, in column order
    float* msum = s.sm + s.l.msum;
    for (int cl = threadIdx.x; cl < s.ncand; cl += kThreads) {
      float sum = 0.f;
      for (int j = 0; j < ncols; ++j)
        if (lcl[col0 + j] == cl) sum += mrow[j];
      msum[cl] += sum;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// three CTAs an SM (80 registers a thread): the multivector path's 320
// CTAs are then one wave on 132 SMs
template <int RG>
__global__ void __launch_bounds__(kThreads, 3) rerank_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ bool s_last;
  __shared__ int s_n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool linear = p.kind == kLinear;
  Cta s;
  s.sm = reinterpret_cast<float*>(smem_raw);
  s.l = layout(RG, p.cpb, p.tq, p.d, linear);
  s.qi = blockIdx.x / p.nblk;
  s.blk = blockIdx.x - s.qi * p.nblk;  // the CTA's rank in its cluster
  s.c0 = blockIdx.y * p.cpb;
  s.ncand = min(p.cpb, p.c - s.c0);
  int* qlist = reinterpret_cast<int*>(s.sm + s.l.qlist);
  int* best = reinterpret_cast<int*>(s.sm + s.l.best);
  float* msum = s.sm + s.l.msum;
  int* kept = reinterpret_cast<int*>(s.sm + s.l.kept);
  int* cid = reinterpret_cast<int*>(s.sm + s.l.cid);
  int* wtot = reinterpret_cast<int*>(s.sm + s.l.scan);
  int* list = reinterpret_cast<int*>(s.sm + s.l.list);
  int* lcl = reinterpret_cast<int*>(s.sm + s.l.lcl);
  float* qmean = s.sm + s.l.qmean;
  const float* qg = p.q + (size_t)s.qi * p.tq * p.d;
  const uint8_t* qm = p.qmask + (size_t)s.qi * p.tq;

  // the candidates, the query's live tokens, the maxima at -inf
  for (int i = tid; i < p.cpb; i += kThreads) {
    const int id = i < s.ncand ? p.cand[(size_t)s.qi * p.c + s.c0 + i] : -1;
    cid[i] = id >= 0 && id < p.n ? id : -1;
    kept[i] = 0;
    msum[i] = 0.f;
  }
  for (int e = tid; e < p.cpb * p.tq; e += kThreads)
    best[e] = ord_key(-__builtin_huge_valf());
  if (warp == 0) {
    int n = 0;
    for (int r0 = 0; r0 < p.tq; r0 += 32) {
      const bool live = r0 + lane < p.tq && qm[r0 + lane];
      const unsigned bal = __ballot_sync(kFull, live);
      if (live) qlist[n + __popc(bal & ((1u << lane) - 1u))] = r0 + lane;
      n += __popc(bal);
    }
    if (lane == 0) s_n = n;
  }
  __syncthreads();
  s.nq = s_n;
  s.rows = s.nq + (linear ? 1 : 0);
  if (linear) {
    // mean_q: the live query tokens' sum over their count (at least 1)
    const float qc = static_cast<float>(s.nq > 0 ? s.nq : 1);
    for (int k = tid; k < round4(p.d); k += kThreads) {
      float sum = 0.f;
      if (k < p.d)
        for (int r = 0; r < s.nq; ++r) sum += qg[(size_t)qlist[r] * p.d + k];
      qmean[k] = sum / qc;
    }
  }
  // this block's range of the candidate's kept tokens (in kept order)
  int klo = 0, khi = 0x7fffffff, total_kept = 0;
  if (p.nblk > 1) {  // cpb == 1
    const int id = cid[0];
    for (int w0 = 0; w0 < p.t; w0 += kWindow)
      total_kept += __syncthreads_count(id >= 0 && w0 + tid < p.t &&
                                        p.tmask[(size_t)id * p.t + w0 + tid]);
    klo = (int)((long long)total_kept * s.blk / p.nblk);
    khi = (int)((long long)total_kept * (s.blk + 1) / p.nblk);
  }
  __syncthreads();

  // the kept tokens a window of (candidate, position) slots at a time,
  // compacted into the list, then its tiles
  const int slots = p.cpb * p.t;
  int base = 0;  // kept tokens before the window (nblk > 1: of the one)
  for (int w0 = 0; w0 < slots; w0 += kWindow) {
    const int f = w0 + tid;
    const int cl = f / p.t;
    const bool k = f < slots && cl < s.ncand && cid[cl] >= 0 &&
                   p.tmask[(size_t)cid[cl] * p.t + (f - cl * p.t)];
    int wn = 0;
    const int excl = block_scan(k, wtot, wn);
    const int lo = max(klo, base);
    const int n_list = max(0, min(khi, base + wn) - lo);
    if (k) {
      if (p.nblk == 1) atomicAdd(kept + cl, 1);
      const int r = base + excl;
      if (r >= klo && r < khi) {
        list[r - lo] = f - cl * p.t;
        lcl[r - lo] = cl;
      }
    }
    base += wn;
    __syncthreads();
    for (int col0 = 0; col0 < n_list; col0 += kCols)
      for (int r0 = 0; r0 < s.rows; r0 += 4 * RG)
        tile<RG>(p, s, r0, col0, min(kCols, n_list - col0));
  }
  if (p.nblk > 1 && tid == 0) kept[0] = total_kept;

  // the cluster's blocks combined in its first CTA, through distributed
  // shared memory; then a warp a candidate sums its query tokens
  if (p.nblk > 1) cluster_sync();
  const bool first = s.blk == 0;
  if (first) {
    cg::cluster_group cluster = cg::this_cluster();
    for (int cl = warp; cl < s.ncand; cl += kWarps) {
      float total = 0.f;
      for (int r = lane; r < s.nq; r += 32) {
        int key = best[cl * p.tq + r];
        for (int o = 1; o < p.nblk; ++o)
          key = max(key, cluster.map_shared_rank(best, o)[cl * p.tq + r]);
        const float m = ord_val(key);
        total += isfinite(m) ? m : 0.f;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        total += __shfl_xor_sync(kFull, total, o);
      if (lane == 0) {
        float sc = total;
        if (linear) {
          float ms = msum[cl];
          for (int o = 1; o < p.nblk; ++o)
            ms += cluster.map_shared_rank(msum, o)[cl];
          const float cn = static_cast<float>(kept[cl] > 0 ? kept[cl] : 1);
          sc = p.w_max * total + p.w_mean * (ms / cn) + p.bias;
        }
        p.scores[(size_t)s.qi * p.c + s.c0 + cl] =
            cid[cl] >= 0 ? sc : -__builtin_huge_valf();
      }
    }
  }
  if (p.nblk > 1) cluster_sync();  // the others' memory stays until read
  if (!first) return;

  // the last CTA of this query ranks its scores
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicInc(p.tickets + s.qi, p.groups - 1) == p.groups - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the scores in shared memory where they fit, else read from L2
  const float* row = p.scores + (size_t)s.qi * p.c;
  float* sc = s.sm;
  if (p.sel_smem) {
    for (int i = tid; i < p.c; i += kThreads) sc[i] = __ldcg(row + i);
    __syncthreads();
  }
  // each score counted by `g` lanes of a warp (every g-th score each,
  // the counts added by shuffles), so the serial count is c / g long
  int g = 32;
  while (g > 1 && p.c * g > kThreads) g >>= 1;
  for (int e0 = 0; e0 < p.c * g; e0 += kThreads) {
    const int e = e0 + tid, i = e / g, sub = e - i * g;
    int rank = 0;
    float v = 0.f;
    if (i < p.c) {
      v = p.sel_smem ? sc[i] : __ldcg(row + i);
#pragma unroll 4
      for (int j = sub; j < p.c; j += g) {
        const float u = p.sel_smem ? sc[j] : __ldcg(row + j);
        rank += (u > v) | ((u == v) & (j < i));
      }
    }
    for (int o = g >> 1; o > 0; o >>= 1)
      rank += __shfl_xor_sync(kFull, rank, o, g);
    if (i < p.c && sub == 0 && rank < p.out_k) {
      const bool ok = isfinite(v);
      p.out_ids[(size_t)s.qi * p.out_k + rank] =
          ok ? p.cand[(size_t)s.qi * p.c + i] : -1;
      p.out_d[(size_t)s.qi * p.out_k + rank] = ok ? -v : kMask;
    }
  }
}

// each device's SMs and the dynamic shared memory a block can take (the
// opt-in limit less the kernels' static part), read once, with every
// instance's limit raised to it once
struct Device {
  int sms = 0, smem_max = 0;
  cudaError_t err = cudaSuccess;
  std::once_flag once;
};
Device g_devices[kMaxDevices];

cudaError_t device_info(int dev, const Device** out) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Device& g = g_devices[dev];
  std::call_once(g.once, [&] {
    g.err = cudaDeviceGetAttribute(&g.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (g.err == cudaSuccess)
      g.err = cudaDeviceGetAttribute(
          &g.smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const void* kernels[] = {(const void*)rerank_kernel<1>,
                             (const void*)rerank_kernel<2>,
                             (const void*)rerank_kernel<4>,
                             (const void*)rerank_kernel<8>};
    int dyn = g.smem_max;
    for (const void* k : kernels) {
      cudaFuncAttributes fa;
      if (g.err == cudaSuccess) g.err = cudaFuncGetAttributes(&fa, k);
      const int left = g.smem_max - static_cast<int>(fa.sharedSizeBytes);
      if (g.err == cudaSuccess && left < dyn) dyn = left;
    }
    for (const void* k : kernels)
      if (g.err == cudaSuccess)
        g.err = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    g.smem_max = dyn;
  });
  *out = &g;
  return g.err;
}

}  // namespace

extern "C" {

// The card's SMs and the dynamic shared memory a block of B7a can take
// on device `dev` (what the launch planner of ops/rerank.py sizes a launch
// for). Returns 0 or a cudaError_t.
int rerank_device_info(int dev, int* sms, int* smem_max) {
  const Device* g = nullptr;
  const cudaError_t e = device_info(dev, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  *sms = g->sms;
  *smem_max = g->smem_max;
  return 0;
}

// Launches B7a with the arguments packed in `call` (kCallBytes, as
// ops/rerank.py packs them: one argument through ctypes costs less of
// the host part than 25), a RerankCall: on `stream`, for `b` queries,
// with the plan of ops/rerank.py `rerank_plan` (rg 1, 2, 4 or 8 row
// groups; cpb candidates a CTA; nblk CTAs a candidate, one cluster; `smem`
// bytes a CTA): candidates `cand` [b, c] (-1 padded) scored against the
// token plane `tokens` [n, t, d] and its mask `tmask` [n, t] (one byte a
// token), with the query tokens `q` [b, tq, d] and their mask `qmask` [b,
// tq]; `kind` 0 MaxSim, 1 linear with w_max, w_mean and bias. `scores` [b,
// c] is scratch; `tickets` [b] must be 0 at the first launch on its
// stream (every launch leaves it 0). Writes out_ids / out_d [b, out_k].
// Returns 0, a cudaError_t (> 0), or a negative code for arguments outside
// the kernel's contract (see rerank_error_string).
int rerank_topk(const unsigned char* call) {
  struct RerankCall {
    uint64_t cand, tokens, tmask, q, qmask, scores, tickets, out_ids, out_d,
        stream;
    int32_t b, c, n, t, d, tq, out_k, kind, rg, cpb, nblk, smem;
    float w_max, w_mean, bias;
  } a;
  memcpy(&a, call, kCallBytes);
  const int b = a.b, c = a.c, n = a.n, t = a.t, d = a.d, tq = a.tq;
  const int out_k = a.out_k, kind = a.kind, rg = a.rg, cpb = a.cpb;
  const int nblk = a.nblk, smem = a.smem;
  if (b < 1 || c < 1 || n < 1 || t < 1 || d < 1 || tq < 1) return kBadShape;
  if (c > kMaxC) return kBadCount;
  if (kind != kMaxSim && kind != kLinear) return kBadKind;
  if (out_k < 1 || out_k > c) return kBadK;
  const int groups = (c + cpb - 1) / (cpb > 0 ? cpb : 1);
  if ((rg != 1 && rg != 2 && rg != 4 && rg != 8) || cpb < 1 ||
      (cpb > 1 && (cpb * t > kWindow || nblk != 1)) || nblk < 1 ||
      nblk > kMaxCluster || groups > kMaxC ||
      (long long)b * nblk > 0x7fffffffLL)
    return kBadPlan;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const Device* g = nullptr;
  if (e == cudaSuccess) e = device_info(dev, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool linear = kind == kLinear;
  if (smem < 4 * layout(rg, cpb, tq, d, linear).words || smem > g->smem_max)
    return kBadSmem;
  Params p;
  p.cand = reinterpret_cast<const int*>(a.cand);
  p.tokens = reinterpret_cast<const float*>(a.tokens);
  p.tmask = reinterpret_cast<const uint8_t*>(a.tmask);
  p.q = reinterpret_cast<const float*>(a.q);
  p.qmask = reinterpret_cast<const uint8_t*>(a.qmask);
  p.scores = reinterpret_cast<float*>(a.scores);
  p.tickets = reinterpret_cast<unsigned*>(a.tickets);
  p.out_ids = reinterpret_cast<int*>(a.out_ids);
  p.out_d = reinterpret_cast<float*>(a.out_d);
  p.b = b;
  p.c = c;
  p.n = n;
  p.t = t;
  p.d = d;
  p.tq = tq;
  p.out_k = out_k;
  p.kind = kind;
  p.w_max = a.w_max;
  p.w_mean = a.w_mean;
  p.bias = a.bias;
  p.cpb = cpb;
  p.nblk = nblk;
  p.groups = groups;
  p.vec = d % 4 == 0 && a.tokens % 16 == 0 && a.q % 16 == 0;
  p.sel_smem = 4LL * c <= smem;
  void (*kern)(Params) = rg == 1   ? rerank_kernel<1>
                         : rg == 2 ? rerank_kernel<2>
                         : rg == 4 ? rerank_kernel<4>
                                   : rerank_kernel<8>;
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(a.stream);
  if (nblk == 1) {
    kern<<<dim3(b, groups, 1), kThreads, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * nblk, groups, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(nblk);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

const char* rerank_error_string(int code) {
  switch (code) {
    case kBadShape: return "b, c, n, t, d, tq must be >= 1";
    case kBadKind: return "module kind outside 0 (MaxSim), 1 (linear)";
    case kBadK: return "out_k outside [1, c]";
    case kBadSmem: return "the plan's shared memory is below its layout or "
                          "above the card's a block";
    case kBadCount: return "more than 65535 candidates a query";
    case kBadPlan: return "a launch plan outside the kernel's (row groups "
                          "1, 2, 4, 8; candidates a CTA within a window of "
                          "256 token slots; 1 to 8 CTAs a candidate, only "
                          "for one candidate a CTA)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
