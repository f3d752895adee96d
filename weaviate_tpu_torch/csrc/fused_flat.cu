// Fused L2 distance + per-block bucketed top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_flat.py:104 `_kernel`,
// launched by `pallas_flat_topk`. For each corpus block of C rows and each
// query it computes the bf16 product with float32 sums, d = max(|q|^2 -
// 2 q.c + |c|^2, 0) with |q|^2 in float32 from the unrounded query, sets
// masked rows to 1e30, folds the C columns into C/fold strided buckets
// (bucket j holds columns {j, j + C/fold, ...} and keeps its minimum and the
// lowest column reaching it) and runs k rounds of extract-min over the
// bucket minima (lowest bucket on ties; a taken bucket retires to 1e30).
// Output: vals/ids [N/C, B, k], ids being the column inside the block. The
// global merge of the [B, (N/C)*k] candidates is plain PyTorch in
// ops/fused_flat.py.
//
// What bounds it on an H100: at the serving shapes (N = 1,048,576 rows of
// D = 768 float32, B = 256, k = 10) the corpus read is 3.2 GB, about 0.96 ms
// at 3.35 TB/s, while the product is 412 GFLOP, about 0.42 ms at the bf16
// tensor-core peak, so the bound is the corpus bytes. The score matrix
// [B, N] never reaches device memory. The first design (the legacy variant
// below) was held far above that bound by traffic from L2 into the SMs and
// by load latency: it restaged the query chunk at every step (12.9 GB a
// batch) and read each corpus block once per 64-query tile (12.9 GB), each
// load waiting on the last. This design is held by shared-memory bandwidth
// instead: mma.sync takes its operands from registers, so every product
// reads its fragments out of shared memory (48 KB per 64x128x32 step, plus
// the 16 KB the corpus copy writes).
//
// The cluster ring (variant 1): one CTA per (corpus block, tile of QT
// queries); the query tiles of one block run side by side as a thread-block
// cluster of up to MAX_CLUSTER CTAs.
//  - The query tile is resident: loaded once at CTA start, rounded to bf16
//    into shared memory with a pitch of D + 8 (D rounded up to 32) so the
//    ldmatrix fragment loads have no bank conflicts, |q|^2 summed in float32
//    in the same pass. Queries cross from L2 once per CTA (0.4 GB a batch).
//  - The corpus streams through a ring of S stages (3 to 8, as many as fit)
//    of RT x KS = 128 rows x 32 dims. A ninth, producer warp fills each
//    stage with one 2-D TMA copy of its CTA's share of the rows, multicast
//    into every CTA of the cluster, so each corpus block leaves L2 once per
//    cluster; TMA zero-fills the dims past D. Per stage and CTA a full
//    barrier counts the bytes, a consumed barrier the 8 consumer warps done
//    with it, and an empty barrier the cluster's CTAs done with it: the
//    producer refills a slot only once every CTA of the cluster has
//    released it. Cluster syncs follow the barriers' set-up and precede the
//    exit, so no CTA leaves while a peer may still copy into it. Every CTA
//    runs every stage, a ragged query tile included.
//  - The products are raw mma.sync m16n8k16 (bf16 in, float32 sums): each
//    consumer warp takes all QT queries by 16 rows of the stage, A from the
//    resident tile by ldmatrix, B straight from the stage in TMA's swizzle
//    (float2 loads rounded to bf16 into the fragment; a bf16 corpus is used
//    as it is), reading the rows of an 8-row group in the order
//    0,2,4,6,1,3,5,7 so the loads have no bank conflicts. The products of
//    JOIN stages sum apart and join the running float32 sums with plain
//    adds, so the tensor cores never add into a large sum (a single chain
//    over D = 1536 drifted past the tolerance).
//  - The fold: with a multiple of 128 buckets each column of a row tile is
//    its own bucket, always in the same thread, so each thread folds its
//    accumulators straight into the minima in shared memory with no
//    barrier.
// QT is 64, falling to 32 and 16, until the tile, a ring of 3 stages and
// the bucket state fit in the 232,448 bytes a block may use; that holds D
// up to 1536 at 128 buckets.
//
// The legacy design (variant 0) serves every other shape: corpus rows off
// 16-byte boundaries (TMA needs them), bucket counts that are not a
// multiple of 128, a D too wide for the resident tile at QT = 16, or a
// bucket state too large beside it. It stages a query chunk and a row chunk
// per 64-dimension step through registers into two shared buffers, WMMA
// products, a score tile and the per-bucket fold; blocks with more than 512
// buckets take QT = 16, RT = 128. The variant is chosen from the shape and
// the corpus alignment before the launch (`fused_flat_variant` says which)
// and never after a failure. The redesign set out to leave only two kinds
// of shape here, more than 512 buckets and a D too wide for the tile; rows
// off 16-byte boundaries (which want a per-thread cp.async path into the
// ring) and bucket counts off a multiple of 128 (which want another fold)
// go beyond that and are left for later.
//
// Tie rules match the JAX kernel exactly: within a bucket a strict `<` while
// walking rows upward keeps the lowest column; across buckets the shuffle
// reduction orders by (value, bucket); once live buckets run out, later
// rounds name the lowest bucket again at 1e30 and the wrapper maps those
// slots to id -1.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int KC = 64;          // dimensions staged per step
constexpr int LDK = KC + 8;     // bf16 pitch of a staged row (16-byte multiple)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr float MASKD = 1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t MAX_SMEM = 232448;  // shared memory a block may use on sm_90

enum Variant { LEGACY = 0, CLUSTER = 1 };

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

// k rounds of extract-min over the bucket minima of each live query row,
// one warp a query, the nw warps taking rows in turn. Row r's minima are at
// bval + r * vpitch, its positions in the bucket at bloc + r * folds.
// Minima are >= 0 (or -0), so their bits with the sign cleared order like
// the values: a round is two warp-wide integer minimums, the value's and
// then the lowest bucket holding it.
__device__ void extract_rounds(float* bval, int vpitch,
                               const uint8_t* bloc, int folds, int qrows,
                               int k, size_t obase0, float* out_v,
                               int* out_i, int nw, int warp, int lane) {
  for (int r = warp; r < qrows; r += nw) {
    float* v = bval + size_t(r) * vpitch;
    const uint8_t* lc = bloc + size_t(r) * folds;
    const size_t obase = obase0 + size_t(r) * k;
    for (int round = 0; round < k; ++round) {
      uint32_t best = 0xffffffffu, bj = 0xffffffffu;
      for (int j = lane; j < folds; j += 32) {
        const uint32_t key = __float_as_uint(v[j]) & 0x7fffffffu;
        if (key < best) {
          best = key;
          bj = uint32_t(j);
        }
      }
      const uint32_t m = __reduce_min_sync(FULL, best);
      const uint32_t jm = __reduce_min_sync(FULL, best == m ? bj : 0xffffffffu);
      if (lane == 0) {
        out_v[obase + round] = __uint_as_float(m);
        out_i[obase + round] = int(lc[jm]) * folds + int(jm);
        v[jm] = MASKD;
      }
      __syncwarp();
    }
  }
}

// The same rounds for up to 128 buckets, with each lane's 4 minima (of
// buckets lane, lane + 32, ...) in registers and the RPW query rows of a
// warp (warp, warp + NW, ...) interleaved, so the rounds of different rows
// overlap.
template <int RPW, int NW>
__device__ void extract_rounds_regs(const float* bval, int vpitch,
                                    const uint8_t* bloc, int folds,
                                    int qrows, int k, size_t obase0,
                                    float* out_v, int* out_i, int warp,
                                    int lane) {
  constexpr uint32_t NONE = 0xffffffffu;
  const uint32_t retired = __float_as_uint(MASKD);
  uint32_t key[RPW][4];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = warp + i * NW, j = lane + 32 * u;
      key[i][u] = r < qrows && j < folds
                      ? __float_as_uint(bval[r * vpitch + j]) & 0x7fffffffu
                      : NONE;
    }
  for (int round = 0; round < k; ++round) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + i * NW;
      uint32_t best = NONE, bj = NONE;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (key[i][u] < best) {
          best = key[i][u];
          bj = uint32_t(lane + 32 * u);
        }
      const uint32_t m = __reduce_min_sync(FULL, best);
      const uint32_t jm = __reduce_min_sync(FULL, best == m ? bj : NONE);
      if (r < qrows) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (uint32_t(lane + 32 * u) == jm) key[i][u] = retired;
        if (lane == 0) {
          const size_t o = obase0 + size_t(r) * k + round;
          out_v[o] = __uint_as_float(m);
          out_i[o] = int(bloc[r * folds + jm]) * folds + int(jm);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- legacy

// One load unit of a staged chunk: four values (16 or 8 bytes) when the
// rows allow vector loads, else one value.
__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(uint2& v) { v = make_uint2(0u, 0u); }
__device__ __forceinline__ void zero(float& v) { v = 0.f; }
__device__ __forceinline__ void zero(__nv_bfloat16& v) { v = __float2bfloat16_rn(0.f); }
__device__ __forceinline__ void load(float4& v, const float* p) {
  v = *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void load(uint2& v, const __nv_bfloat16* p) {
  v = *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ void load(float& v, const float* p) { v = *p; }
__device__ __forceinline__ void load(__nv_bfloat16& v, const __nv_bfloat16* p) { v = *p; }
__device__ __forceinline__ void put(__nv_bfloat16* d, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(d) = u;
}
__device__ __forceinline__ void put(__nv_bfloat16* d, uint2 v) {
  *reinterpret_cast<uint2*>(d) = v;
}
__device__ __forceinline__ void put(__nv_bfloat16* d, float v) { *d = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(__nv_bfloat16* d, __nv_bfloat16 v) { *d = v; }

template <typename T, bool VEC> struct Unit { using type = T; static constexpr int W = 1; };
template <> struct Unit<float, true> { using type = float4; static constexpr int W = 4; };
template <> struct Unit<__nv_bfloat16, true> { using type = uint2; static constexpr int W = 4; };

// A ROWS x KC chunk of `src` (row r at src + r * D, valid while r <
// valid_rows; dims past D are zero) held in registers between its global
// load and its bf16 store to shared memory, so the load of the next chunk
// overlaps the products on the current one.
template <typename T, int ROWS, bool VEC>
struct Chunk {
  using R = typename Unit<T, VEC>::type;
  static constexpr int W = Unit<T, VEC>::W;
  static constexpr int G = KC / W;
  static constexpr int N = ROWS * G / NTHREADS;
  static_assert(ROWS * G % NTHREADS == 0, "chunk must split over threads");
  R r[N];
  __device__ __forceinline__ void fetch(const T* src, int valid_rows, int D,
                                        int k0, int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * NTHREADS, row = e / G, col = k0 + (e % G) * W;
      if (row < valid_rows && col < D)
        load(r[i], src + size_t(row) * D + col);
      else
        zero(r[i]);
    }
  }
  __device__ __forceinline__ void stash(__nv_bfloat16* dst, int ld, int tid) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * NTHREADS;
      put(dst + (e / G) * ld + (e % G) * W, r[i]);
    }
  }
};

// Shared-memory layout, computed the same way on host and device: two
// buffers each for the query chunk and the row chunk (one is filled while the
// other feeds the products), the score tile, |q|^2, the row tile's norms and
// mask, and the bucket state (float minimum + 8-bit position in the bucket).
template <int QT, int RT>
struct Layout {
  static constexpr int LDS = RT + 4;  // float pitch of the score tile
  static constexpr size_t a_buf = align128(size_t(QT) * LDK * 2);
  static constexpr size_t b_buf = align128(size_t(RT) * LDK * 2);
  static constexpr size_t b_off = 2 * a_buf;
  static constexpr size_t s_off = b_off + 2 * b_buf;
  static constexpr size_t qsq_off = s_off + align128(size_t(QT) * LDS * 4);
  static constexpr size_t nrm_off = qsq_off + align128(size_t(QT) * 4);
  static constexpr size_t msk_off = nrm_off + align128(size_t(RT) * 4);
  static constexpr size_t val_off = msk_off + align128(size_t(RT));
  __host__ __device__ static size_t loc_off(int folds) {
    return val_off + align128(size_t(QT) * folds * 4);
  }
  static size_t bytes(int folds) {
    return loc_off(folds) + align128(size_t(QT) * folds);
  }
};

template <typename T, int QT, int RT, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
legacy_kernel(const float* __restrict__ q, const T* __restrict__ corpus,
              const float* __restrict__ sqn,
              const uint8_t* __restrict__ mask, int B, int D, int k,
              int block, int fold, float* __restrict__ out_v,
              int* __restrict__ out_i) {
  using L = Layout<QT, RT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int folds = block / fold;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + L::b_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* qsq = reinterpret_cast<float*>(smem + L::qsq_off);
  float* nrm = reinterpret_cast<float*>(smem + L::nrm_off);
  uint8_t* msk = smem + L::msk_off;
  float* bval = reinterpret_cast<float*>(smem + L::val_off);
  uint8_t* bloc = smem + L::loc_off(folds);

  const int ntiles = (B + QT - 1) / QT;
  const int tile = blockIdx.x % ntiles;
  const size_t g = blockIdx.x / ntiles;
  const int q0 = tile * QT;
  const int qrows = min(QT, B - q0);
  const size_t row0 = g * size_t(block);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* qtile = q + size_t(q0) * D;
  const T* cblock = corpus + row0 * D;

  // |q|^2 in float32 from the unrounded query, one warp a query
  for (int r = warp; r < QT; r += NWARPS) {
    float s = 0.f;
    if (r < qrows)
      for (int d = lane; d < D; d += 32) {
        float x = qtile[size_t(r) * D + d];
        s = fmaf(x, x, s);
      }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (lane == 0) qsq[r] = s;
  }
  for (int i = tid; i < QT * folds; i += NTHREADS) {
    bval[i] = INFINITY;
    bloc[i] = 0;
  }

  // One step = one KC chunk of one row tile; the row tiles' steps run back
  // to back, so the next step's chunks (possibly the next tile's first) are
  // loaded into registers while the current step's products run.
  const int nk = (D + KC - 1) / KC;
  const int steps = (block / RT) * nk;
  Chunk<float, QT, VEC> ca;
  Chunk<T, RT, VEC> cb;
  ca.fetch(qtile, qrows, D, 0, tid);
  ca.stash(As, LDK, tid);
  cb.fetch(cblock, RT, D, 0, tid);
  cb.stash(Bs, LDK, tid);
  __syncthreads();

  constexpr int FC = RT / 16;
  constexpr int FPW = (QT / 16) * FC / NWARPS;
  static_assert((QT / 16) * FC % NWARPS == 0, "tiles must split over warps");
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FPW];

  for (int s = 0; s < steps; ++s) {
    const int t = s / nk, kc = s - t * nk, c0 = t * RT;
    if (kc == 0) {
#pragma unroll
      for (int f = 0; f < FPW; ++f) wmma::fill_fragment(acc[f], 0.f);
      if (tid < RT) {
        nrm[tid] = sqn[row0 + c0 + tid];
        msk[tid] = mask[row0 + c0 + tid];
      }
    }
    const bool more = s + 1 < steps;
    if (more) {  // next step's chunk: global -> registers, in flight now
      const int t1 = (s + 1) / nk, k1 = (s + 1) - t1 * nk;
      ca.fetch(qtile, qrows, D, k1 * KC, tid);
      cb.fetch(cblock + size_t(t1) * RT * D, RT, D, k1 * KC, tid);
    }
    const __nv_bfloat16* A = As + (s & 1) * QT * LDK;
    const __nv_bfloat16* Bm = Bs + (s & 1) * RT * LDK;
    // the step's products sum apart and join the running sums with
    // float32 adds, so the tensor cores never add into a large sum
#pragma unroll
    for (int f = 0; f < FPW; ++f) {
      const int fid = warp * FPW + f, fr = fid / FC, fc = fid % FC;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> part;
      wmma::fill_fragment(part, 0.f);
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(a, A + fr * 16 * LDK + kk, LDK);
        wmma::load_matrix_sync(b, Bm + fc * 16 * LDK + kk, LDK);
        wmma::mma_sync(part, a, b, part);
      }
#pragma unroll
      for (int e = 0; e < part.num_elements; ++e) acc[f].x[e] += part.x[e];
    }
    if (more) {  // the other buffers: nobody reads them until the sync
      ca.stash(As + ((s + 1) & 1) * QT * LDK, LDK, tid);
      cb.stash(Bs + ((s + 1) & 1) * RT * LDK, LDK, tid);
    }
    if (kc == nk - 1) {
#pragma unroll
      for (int f = 0; f < FPW; ++f) {
        const int fid = warp * FPW + f, fr = fid / FC, fc = fid % FC;
        wmma::store_matrix_sync(Ss + fr * 16 * L::LDS + fc * 16, acc[f],
                                L::LDS, wmma::mem_row_major);
      }
      __syncthreads();
      // Fold the tile: one thread per (query, bucket present in the tile).
      // Columns of one bucket are visited in ascending order, so a strict
      // `<` keeps the lowest column among equal minima.
      const int ni = folds < RT ? folds : RT;
      for (int p = tid; p < qrows * ni; p += NTHREADS) {
        const int r = p / ni, i = p % ni;
        const float qs = qsq[r];
        for (int cc = i; cc < RT; cc += folds) {
          const int c = c0 + cc;
          const float d =
              msk[cc] ? fmaxf(qs - 2.f * Ss[r * L::LDS + cc] + nrm[cc], 0.f)
                      : MASKD;
          const int slot = r * folds + c % folds;
          if (d < bval[slot]) {
            bval[slot] = d;
            bloc[slot] = static_cast<uint8_t>(c / folds);
          }
        }
      }
    }
    __syncthreads();
  }

  extract_rounds(bval, folds, bloc, folds, qrows, k, (g * B + q0) * size_t(k),
                 out_v, out_i, NWARPS, warp, lane);
}

// ------------------------------------------------------------------ ring

constexpr int RT = 128;        // corpus rows per tile
constexpr int KS = 32;         // dimensions per ring stage
// Consumer warps of a ring CTA, each taking all QT queries by RT/CWARPS
// rows. Four warps of 32 rows read a quarter less shared memory a stage but
// ran no faster on an H100 (probe_fused_flat.py).
constexpr int CWARPS = 8;
// Ring stages whose products sum in the tensor cores before they join the
// running float32 sums
constexpr int JOIN = 4;
constexpr int CTHREADS = CWARPS * 32;
// Largest cluster. Up to 8 is portable, but on an H100 at the main path's
// shapes clusters of 4 ran 0.3-0.5 ms slower than clusters of 2, which ran
// level with no sharing at all (probe_fused_flat.py): 2 halves the L2 reads
// and costs nothing.
constexpr int MAX_CLUSTER = 2;

// Shared-memory layout of the ring kernel, the same on host and device:
// the resident bf16 query tile, the ring (1024-byte aligned for the TMA
// swizzle), the bucket minima, their positions in the bucket, |q|^2, and
// the ring's full, empty and consumed barriers.
struct RingLayout {
  int ldq;        // bf16 pitch of the query tile
  int vp;         // float pitch of the bucket minima
  size_t stage;   // bytes of one ring stage
  size_t ring_off, qsq_off, val_off, loc_off, bar_off, bytes;
};

__host__ __device__ constexpr size_t align1024(size_t x) {
  return (x + 1023) & ~size_t(1023);
}

// The ring kernel folds only bucket counts that are a multiple of RT: then
// every column of a row tile lies in its own bucket, the same one in every
// tile, so each thread folds its own accumulators without a barrier.
__host__ __device__ inline bool ring_folds(int folds) {
  return folds % RT == 0;
}

__host__ __device__ inline RingLayout ring_layout(int qt, int stages, int D,
                                                  int folds, int esize) {
  RingLayout L;
  L.ldq = (D + KS - 1) / KS * KS + 8;
  L.vp = folds + 8;
  L.stage = size_t(RT) * KS * esize;
  L.ring_off = align1024(size_t(qt) * L.ldq * 2);
  L.val_off = L.ring_off + stages * L.stage;
  L.loc_off = L.val_off + align128(size_t(qt) * L.vp * 4);
  L.qsq_off = L.loc_off + align128(size_t(qt) * folds);
  L.bar_off = L.qsq_off + align128(size_t(qt) * 4);
  L.bytes = L.bar_off + stages * 3 * sizeof(uint64_t);
  return L;
}

// Warp tiling of a QT x RT product: each consumer warp takes all QT
// queries by RT/CWARPS rows, MI m16 tiles by NI n8 tiles of mma.sync
// m16n8k16, so every row of a stage is read from shared memory by one warp
// only.
template <int QT>
struct Warps {
  static constexpr int MI = QT / 16;
  static constexpr int NI = RT / (8 * CWARPS);
  static_assert(MI >= 1 && NI >= 1, "warp tiling");
};

// Row of an 8-row group that B-fragment row n reads. A stage is dense with
// TMA's 128-byte swizzle (16-byte chunk ^= row % 8), which sends rows n and
// n + 1 to the same banks; reading rows 0,2,4,6 with lanes 0-15 and 1,3,5,7
// with lanes 16-31 keeps the float2 loads conflict-free.
__device__ __forceinline__ int frag_row(int n) {
  return (n & 3) * 2 + (n >> 2);
}

// Element offset of (row, dim k) in a ring stage, in the TMA swizzle:
// 128-byte rows of float32 (chunk ^= row % 8), 64-byte rows of bf16
// (chunk ^= (row / 2) % 4).
template <typename T>
__device__ __forceinline__ int ring_index(int row, int k) {
  if (sizeof(T) == 4) return row * KS + ((((k >> 2) ^ (row & 7)) << 2) | (k & 3));
  return row * KS + (k ^ (((row >> 1) & 3) << 3));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Spins until the barrier's phase of the given parity has completed. A wait
// that never ends (a broken ring protocol) traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 22)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}
// Arrives on the barrier at the same offset in CTA `cta` of the cluster.
// Release at CTA scope only: what it orders is this CTA's reads of a ring
// slot, whose values the products have already consumed, before a peer's
// copy overwrites the slot; a cluster-scope fence here would cost more
// than the products.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 ra;\n"
      " mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::
          "r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}
// TMA copy of the box at (x, y) of `map` into this CTA, or into every CTA
// of `mask`, each completing its bytes on the barrier at the same offset
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar,
                                         uint16_t mask) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  if (mask == 1)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
        "l"(m), "r"(x), "r"(y), "r"(smem_u32(bar))
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
            smem_u32(dst)),
        "l"(m), "r"(x), "r"(y), "r"(smem_u32(bar)), "h"(mask)
        : "memory");
}
__device__ __forceinline__ void mbar_arrive_local(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// B fragment of mma m16n8k16: dims k, k+1 (at p) and k+8, k+9 (at q) of one
// corpus row (B[k][n] is the row's dim k), lower dim in the lower half.
__device__ __forceinline__ void b_frag(const float* p, const float* q,
                                       uint32_t& b0, uint32_t& b1) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  const float2 y = *reinterpret_cast<const float2*>(q);
  b0 = pack_bf16(x.x, x.y);
  b1 = pack_bf16(y.x, y.y);
}
__device__ __forceinline__ void b_frag(const __nv_bfloat16* p,
                                       const __nv_bfloat16* q, uint32_t& b0,
                                       uint32_t& b1) {
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(q);
}

// the same with a zero accumulator in: c = a * b
__device__ __forceinline__ void mma_bf16_first(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

template <int QT>
using Acc = float[Warps<QT>::MI][Warps<QT>::NI][4];

// One stage's products into `part`: A from the resident query tile at the
// stage's dims, B from this warp's rows of the stage. The products of JOIN
// stages sum apart and join the running float32 sums `acc` with plain adds,
// so the tensor cores never add into a large sum (a single chain over
// D = 1536 drifted past the tolerance). FRESH starts a new `part`: the last
// one joins once this stage's first fragments are on their way, by when
// its products are done.
template <typename T, int QT, bool FRESH>
__device__ __forceinline__ void stage_mma(Acc<QT>& acc, Acc<QT>& part,
                                          const __nv_bfloat16* A, int ldq,
                                          const T* R, int ncol, int lane) {
  using W = Warps<QT>;
  const int lc = (lane & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < KS; kk += 16) {
    uint32_t a[W::MI][4], b[W::NI][2];
#pragma unroll
    for (int mi = 0; mi < W::MI; ++mi)
      ldmatrix_x4(a[mi], A + (mi * 16 + (lane & 15)) * ldq + kk +
                             (lane >> 4) * 8);
#pragma unroll
    for (int ni = 0; ni < W::NI; ++ni) {
      const int row = ncol + ni * 8 + frag_row(lane >> 2);
      b_frag(R + ring_index<T>(row, kk + lc),
             R + ring_index<T>(row, kk + lc + 8), b[ni][0], b[ni][1]);
    }
    if (FRESH && kk == 0) {
#pragma unroll
      for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
    }
#pragma unroll
    for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
      for (int mi = 0; mi < W::MI; ++mi) {
        if (FRESH && kk == 0)
          mma_bf16_first(part[mi][ni], a[mi], b[ni][0], b[ni][1]);
        else
          mma_bf16(part[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
  }
}

// The producer warp of a cluster CTA: fills every ring stage in turn with
// this CTA's share (rows rank * RT/cs on), one TMA box multicast into every
// CTA of the cluster (TMA zero-fills the dims past D). Before it refills a
// slot, this CTA's consumer warps must be done with it; the producer then
// releases the slot in every CTA of the cluster and waits until every CTA
// has released it, since its copy lands in all of them.
template <typename T>
__device__ __forceinline__ void produce_all(T* ring, uint64_t* full,
                                            uint64_t* empty,
                                            uint64_t* consumed,
                                            const CUtensorMap* map,
                                            size_t row0, int nk, int steps,
                                            int stages, int rank, int cs,
                                            int lane) {
  const int rows = RT / cs;
  const uint16_t mask = uint16_t((1u << cs) - 1);
  int slot = 0, phase = 0, t = 0, kc = 0;
  for (int p = 0; p < steps; ++p) {
    if (p >= stages) {  // the slot's previous round: phase ^ 1
      mbar_wait(consumed + slot, phase ^ 1);
      if (lane < cs) mbar_arrive_cluster(empty + slot, lane);
      mbar_wait(empty + slot, phase ^ 1);
    }
    if (lane == 0) {
      mbar_expect_tx(full + slot, RT * KS * int(sizeof(T)));
      tma_load(ring + size_t(slot) * RT * KS + rank * rows * KS, map,
               kc * KS, int(row0) + t * RT + rank * rows, full + slot, mask);
    }
    __syncwarp();
    if (++kc == nk) kc = 0, ++t;
    if (++slot == stages) slot = 0, phase ^= 1;
  }
}

// The consumer threads of a ring CTA (the producer warp goes its own way)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CTHREADS) : "memory");
}

// One CTA per (corpus block, query tile): CWARPS consumer warps and a
// producer warp. The block's query tiles form a cluster that shares every
// ring stage through TMA multicast (which needs rows on 16-byte
// boundaries).
template <typename T, int QT>
__global__ void __launch_bounds__(CTHREADS + 32, 1)
ring_kernel(const __grid_constant__ CUtensorMap map,
            const float* __restrict__ q, const T* __restrict__ corpus,
            const float* __restrict__ sqn, const uint8_t* __restrict__ mask,
            int B, int D, int k, int block, int fold, int stages,
            float* __restrict__ out_v, int* __restrict__ out_i) {
  using W = Warps<QT>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int folds = block / fold;
  const RingLayout L = ring_layout(QT, stages, D, folds, sizeof(T));
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  T* ring = reinterpret_cast<T*>(smem + L.ring_off);
  float* qsq = reinterpret_cast<float*>(smem + L.qsq_off);
  float* bval = reinterpret_cast<float*>(smem + L.val_off);
  uint8_t* bloc = smem + L.loc_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* empty = full + stages;
  uint64_t* consumed = empty + stages;

  const int ntiles = (B + QT - 1) / QT;
  const int tile = blockIdx.x % ntiles;
  const size_t g = blockIdx.x / ntiles;
  const int q0 = tile * QT, qrows = min(QT, B - q0);
  const size_t row0 = g * size_t(block);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk = (D + KS - 1) / KS, steps = (block / RT) * nk;
  const int stage_elems = RT * KS;

  {
    // The CTAs of one corpus block form the cluster; its barriers must
    // exist before any peer copies into this CTA or arrives on them.
    const int cs = int(cluster_size()), rank = int(cluster_rank());
    if (smem_u32(ring) % 1024) __trap();  // the swizzle needs it
    if (tid == 0) {
      for (int i = 0; i < stages; ++i) {
        mbar_init(full + i, 1);
        mbar_init(empty + i, cs);
        mbar_init(consumed + i, CWARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    cluster_sync();
    if (warp == CWARPS) {
      produce_all(ring, full, empty, consumed, &map, row0, nk, steps, stages,
                  rank, cs, lane);
      // no CTA leaves while a peer may still copy into it or arrive on
      // its barriers
      cluster_sync();
      return;
    }
  }
  // The query tile, once: bf16 into shared memory, |q|^2 in float32 from
  // the unrounded values; rows past B and dims past D are zero. Each warp
  // takes QT/CWARPS rows and keeps a load of each in flight together.
  {
    constexpr int RPW = QT / CWARPS;
    const int dp = L.ldq - 8;
    const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
    float sq[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) sq[i] = 0.f;
    for (int d = vec4 ? lane * 4 : lane; d < dp; d += vec4 ? 128 : 32) {
      float4 x[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + i * CWARPS;
        const float* src = q + size_t(q0 + r) * D + d;
        x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < qrows && d < D) {
          if (vec4)
            x[i] = *reinterpret_cast<const float4*>(src);
          else
            x[i].x = *src;
        }
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        __nv_bfloat16* dst = Qs + (warp + i * CWARPS) * L.ldq + d;
        sq[i] = fmaf(x[i].x, x[i].x, sq[i]);
        if (vec4) {
          sq[i] = fmaf(x[i].y, x[i].y, sq[i]);
          sq[i] = fmaf(x[i].z, x[i].z, sq[i]);
          sq[i] = fmaf(x[i].w, x[i].w, sq[i]);
          put(dst, x[i]);
        } else {
          *dst = __float2bfloat16_rn(x[i].x);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      float t = sq[i];
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(FULL, t, o);
      if (lane == 0) qsq[warp + i * CWARPS] = t;
    }
  }
  for (int i = tid; i < QT * L.vp; i += CTHREADS) bval[i] = INFINITY;
  for (int i = tid; i < QT * folds; i += CTHREADS) bloc[i] = 0;
  consumer_sync();

  // This thread's accumulators: rows mi*16 + lr (+8), and per n8 tile ni
  // the two columns cols[ni][e] of each row tile.
  const int ncol = warp * W::NI * 8;
  const int lr = lane >> 2;
  int cols[W::NI][2];
#pragma unroll
  for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      cols[ni][e] = ncol + ni * 8 + frag_row((lane & 3) * 2 + e);
  float qv[W::MI][2];
#pragma unroll
  for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) qv[mi][h] = qsq[mi * 16 + lr + h * 8];

  const int ntile = block / RT;
  int slot = 0, phase = 0;
  for (int t = 0; t < ntile; ++t) {
    const int c0 = t * RT;
    // column c0 + col lies in bucket c0 % folds + col, at position
    // c0 / folds in it
    const int jb = c0 % folds;
    const uint8_t pos = static_cast<uint8_t>(c0 / folds);
    Acc<QT> acc, part;
#pragma unroll
    for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = part[mi][ni][e] = 0.f;
    // this thread's norms and mask bits (bit ni*2+e) of the tile, loaded
    // now and first used by the fold, after the products
    float cn[W::NI][2];
    uint32_t cm = 0;
#pragma unroll
    for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const size_t c = row0 + size_t(c0) + cols[ni][e];
        cn[ni][e] = __ldg(sqn + c);
        cm |= uint32_t(__ldg(mask + c) != 0) << (ni * 2 + e);
      }

    for (int kc = 0; kc < nk; ++kc) {
      mbar_wait(full + slot, phase);
      const __nv_bfloat16* A = Qs + kc * KS;
      const T* R = ring + slot * stage_elems;
      if (kc % JOIN == 0)
        stage_mma<T, QT, true>(acc, part, A, L.ldq, R, ncol, lane);
      else
        stage_mma<T, QT, false>(acc, part, A, L.ldq, R, ncol, lane);
      // every lane's products have issued, so its reads of the slot are
      // done: tell the producer
      __syncwarp();
      if (lane == 0) mbar_arrive_local(consumed + slot);
      if (++slot == stages) slot = 0, phase ^= 1;
    }
#pragma unroll
    for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];

    // Column c is alone in bucket c % folds within the tile and every tile
    // puts that bucket in this thread, so the minima need no barrier; tiles
    // go upward and `<` is strict, so ties keep the lowest column.
#pragma unroll
    for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mi * 16 + lr + h * 8;
        if (r >= qrows) continue;
#pragma unroll
        for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = jb + cols[ni][e];
            const float d =
                cm >> (ni * 2 + e) & 1u
                    ? fmaxf(qv[mi][h] - 2.f * acc[mi][ni][2 * h + e] + cn[ni][e], 0.f)
                    : MASKD;
            if (d < bval[r * L.vp + j]) {
              bval[r * L.vp + j] = d;
              bloc[r * folds + j] = pos;
            }
          }
      }
  }
  consumer_sync();

  if (folds <= 128)
    extract_rounds_regs<QT / CWARPS, CWARPS>(bval, L.vp, bloc, folds, qrows,
                                             k, (g * B + q0) * size_t(k),
                                             out_v, out_i, warp, lane);
  else
    extract_rounds(bval, L.vp, bloc, folds, qrows, k, (g * B + q0) * size_t(k),
                   out_v, out_i, CWARPS, warp, lane);
  cluster_sync();
}

// ------------------------------------------------------------- dispatch

struct Plan {
  int variant, qt, stages, cluster;
  size_t smem;
};

bool valid_args(int B, int N, int D, int k, int block, int fold) {
  return !(B < 1 || D < 1 || k < 1 || k > 64 || fold < 1 || fold > 16 ||
           block < 128 || block > 2048 || block % 128 != 0 ||
           block % fold != 0 || block / fold < k || N < block ||
           N % block != 0);
}

// The variant and its tiling, from the shape and the corpus alignment
// alone. The cluster ring takes rows on 16-byte boundaries and bucket
// counts that are a multiple of RT, with the widest query tile and the
// deepest ring that fit, and the largest power-of-two cluster up to
// MAX_CLUSTER that divides the query tiles; every other shape takes the
// legacy kernel.
Plan make_plan(bool bf16, int B, int D, int block, int fold,
               uintptr_t corpus) {
  const int folds = block / fold, esize = bf16 ? 2 : 4;
  const bool aligned = size_t(D) * esize % 16 == 0 && corpus % 16 == 0;
  const int qts[] = {64, 32, 16};
  for (int qt : qts)
    for (int st = 8; st >= 3 && aligned && ring_folds(folds); --st) {
      const size_t b = ring_layout(qt, st, D, folds, esize).bytes;
      if (b > MAX_SMEM) continue;
      const int ntiles = (B + qt - 1) / qt;
      int cs = MAX_CLUSTER;
      while (ntiles % cs) cs /= 2;
      return {CLUSTER, qt, st, cs, b};
    }
  if (folds > 512) return {LEGACY, 16, 0, 1, Layout<16, 128>::bytes(folds)};
  return {LEGACY, 64, 0, 1, Layout<64, 64>::bytes(folds)};
}

// cuTensorMapEncodeTiled, reached through the runtime so the library needs
// no link to the driver; null where the driver does not offer it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The corpus as a 2-D tensor [N, D] with boxes of KS dims by RT/cs rows, in
// the swizzle ring_index reads: 128-byte rows of float32, 64-byte of bf16.
template <typename T>
cudaError_t corpus_map(CUtensorMap* map, const T* corpus, int N, int D,
                       int cs) {
  const EncodeTiled encode = encoder();
  if (!encode) return cudaErrorNotSupported;
  constexpr bool bf16 = sizeof(T) == 2;
  const cuuint64_t dims[2] = {cuuint64_t(D), cuuint64_t(N)};
  const cuuint64_t strides[1] = {cuuint64_t(D) * sizeof(T)};
  const cuuint32_t box[2] = {cuuint32_t(KS), cuuint32_t(RT / cs)};
  const cuuint32_t estrides[2] = {1, 1};
  const CUresult r = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<T*>(corpus), dims, strides, box, estrides,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      bf16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Opens the kernel's shared-memory limit and sizes its grid: one CTA per
// (corpus block, query tile), the query tiles of a block side by side.
template <typename Kern>
cudaError_t prepare(Kern kern, int qt, size_t smem, int B, int N, int block,
                    dim3& grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const long long g = (long long)((B + qt - 1) / qt) * (N / block);
  if (g > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  grid = dim3(unsigned(g));
  return cudaSuccess;
}

template <typename T, bool VEC>
cudaError_t run_legacy(const Plan& pl, const float* q, const T* c,
                       const float* sqn, const uint8_t* m, int B, int N,
                       int D, int k, int block, int fold, float* ov, int* oi,
                       cudaStream_t s) {
  dim3 grid;
  if (pl.qt == 16) {
    auto kern = legacy_kernel<T, 16, 128, VEC>;
    cudaError_t e = prepare(kern, 16, pl.smem, B, N, block, grid);
    if (e != cudaSuccess) return e;
    kern<<<grid, NTHREADS, pl.smem, s>>>(q, c, sqn, m, B, D, k, block, fold,
                                        ov, oi);
  } else {
    auto kern = legacy_kernel<T, 64, 64, VEC>;
    cudaError_t e = prepare(kern, 64, pl.smem, B, N, block, grid);
    if (e != cudaSuccess) return e;
    kern<<<grid, NTHREADS, pl.smem, s>>>(q, c, sqn, m, B, D, k, block, fold,
                                        ov, oi);
  }
  return cudaGetLastError();
}

template <typename T, int QT>
cudaError_t run_ring(const Plan& pl, const float* q, const T* c,
                     const float* sqn, const uint8_t* m, int B, int N, int D,
                     int k, int block, int fold, float* ov, int* oi,
                     cudaStream_t s) {
  auto kern = ring_kernel<T, QT>;
  dim3 grid;
  cudaError_t e = prepare(kern, QT, pl.smem, B, N, block, grid);
  if (e != cudaSuccess) return e;
  CUtensorMap map = {};
  e = corpus_map(&map, c, N, D, pl.cluster);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(CTHREADS + 32);  // consumer warps and the producer
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(pl.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, map, q, c, sqn, m, B, D, k, block, fold,
                         pl.stages, ov, oi);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Plan& pl, const float* q, const T* c,
                     const float* sqn, const uint8_t* m, int B, int N, int D,
                     int k, int block, int fold, float* ov, int* oi,
                     cudaStream_t s) {
  constexpr bool bf16 = sizeof(T) == 2;
  if (pl.variant == LEGACY) {
    const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
    const uintptr_t ca = reinterpret_cast<uintptr_t>(c);
    const bool vec = D % 4 == 0 && qa % 16 == 0 && ca % (bf16 ? 8 : 16) == 0;
    return vec ? run_legacy<T, true>(pl, q, c, sqn, m, B, N, D, k, block,
                                     fold, ov, oi, s)
               : run_legacy<T, false>(pl, q, c, sqn, m, B, N, D, k, block,
                                      fold, ov, oi, s);
  }
  if (pl.qt == 64)
    return run_ring<T, 64>(pl, q, c, sqn, m, B, N, D, k, block, fold, ov, oi,
                           s);
  if (pl.qt == 32)
    return run_ring<T, 32>(pl, q, c, sqn, m, B, N, D, k, block, fold, ov, oi,
                           s);
  return run_ring<T, 16>(pl, q, c, sqn, m, B, N, D, k, block, fold, ov, oi,
                         s);
}

}  // namespace

extern "C" {

// queries [B, D] float32; corpus [N, D] float32 (corpus_bf16 = 0) or
// bfloat16 (1); sqnorms [N] float32; mask [N] bool; all contiguous on the
// current device. Writes vals [N/block, B, k] float32 and ids int32 on
// `stream`. Returns a cudaError_t: the launch's own, or invalid-value for
// arguments outside the kernel's contract.
int fused_flat_l2_topk(const void* queries, const void* corpus,
                       int corpus_bf16, const void* sqnorms, const void* mask,
                       int B, int N, int D, int k, int block, int fold,
                       void* out_vals, void* out_ids, void* stream) {
  if (!valid_args(B, N, D, k, block, fold))
    return int(cudaErrorInvalidValue);
  const Plan pl = make_plan(corpus_bf16 != 0, B, D, block, fold,
                            reinterpret_cast<uintptr_t>(corpus));
  const float* q = static_cast<const float*>(queries);
  const float* sq = static_cast<const float*>(sqnorms);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* ov = static_cast<float*>(out_vals);
  int* oi = static_cast<int*>(out_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      corpus_bf16
          ? dispatch(pl, q, static_cast<const __nv_bfloat16*>(corpus), sq, m,
                     B, N, D, k, block, fold, ov, oi, s)
          : dispatch(pl, q, static_cast<const float*>(corpus), sq, m, B, N, D,
                     k, block, fold, ov, oi, s);
  return int(e);
}

// The variant a call with these arguments launches (0 legacy, 1 cluster),
// or -1 for arguments outside the kernel's contract. When
// `plan` is not null it receives {query tile rows, ring stages, cluster
// size, shared-memory bytes}.
int fused_flat_variant(const void* corpus, int corpus_bf16, int B, int N,
                       int D, int k, int block, int fold, int* plan) {
  if (!valid_args(B, N, D, k, block, fold)) return -1;
  const Plan pl = make_plan(corpus_bf16 != 0, B, D, block, fold,
                            reinterpret_cast<uintptr_t>(corpus));
  if (plan) {
    plan[0] = pl.qt;
    plan[1] = pl.stages;
    plan[2] = pl.cluster;
    plan[3] = int(pl.smem);
  }
  return pl.variant;
}

const char* fused_flat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
