// Fused L2 distance + per-block bucketed top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel weaviate_tpu/ops/pallas_flat.py `_kernel`, launched
// by `pallas_flat_topk`. For each corpus block of C rows and each query it
// computes the bf16 product with float32 sums, d = max(|q|^2 - 2 q.c + |c|^2, 0)
// with |q|^2 in float32 from the unrounded query, sets masked rows to 1e30,
// folds the C columns into C/fold strided buckets (bucket j holds columns
// {j, j + C/fold, ...} and keeps its minimum and the lowest column reaching
// it) and runs k rounds of extract-min over the bucket minima (lowest bucket
// on ties; a taken bucket retires to 1e30). Output: vals/ids [N/C, B, k],
// ids being the column inside the block. The global merge of the
// [B, (N/C)*k] candidates is plain PyTorch in ops/fused_flat.py.
//
// What bounds it on an H100: at the serving shapes (N = 1,048,576 rows of
// D = 768 float32, B = 256, k = 10) the corpus read is 3.2 GB, about 0.96 ms
// at 3.35 TB/s, while the product is 412 GFLOP, about 0.42 ms at the bf16
// tensor-core peak: the kernel is bound by the corpus bytes. The score
// matrix [B, N] (1 GB in float32) never reaches device memory: each block
// folds its scores in shared memory, so device traffic is the corpus read
// plus [N/C, B, k] candidates.
//
// The simple design: one CTA per (corpus block, tile of QT queries), the
// query tile fastest in the grid so the B/QT CTAs that read one corpus block
// run side by side and share it through L2. A CTA walks its block in tiles
// of RT rows and each tile in steps of 64 dimensions: the step's query and
// row chunks sit in shared memory as bf16, the QT x RT product runs on the
// tensor cores (WMMA bf16 16x16x16, float32 sums) while the next step's
// chunks load from device memory into registers (two shared buffers, one
// barrier a step). After a tile's last step the scores fold into
// per-(query, bucket) minima in shared memory (float value + 8-bit position
// in the bucket: 5 bytes a bucket); after the last tile one warp per query
// runs the k rounds with warp shuffles. The query chunk is restaged at every
// step and each corpus block is read once per query tile; a TMA/wgmma
// pipeline with the query tile resident is the next step toward the bound.
// Blocks with more than 512 buckets a query (fold 1 or 2 at C = 2048) take
// QT = 16, RT = 128 so the bucket state still fits in shared memory.
//
// Tie rules match the JAX kernel exactly: within a bucket a strict `<` while
// walking rows upward keeps the lowest column; across buckets the shuffle
// reduction orders by (value, bucket); once live buckets run out, later
// rounds name the lowest bucket again at 1e30 and the wrapper maps those
// slots to id -1.

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

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

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
fused_flat_l2_topk_kernel(const float* __restrict__ q,
                          const T* __restrict__ corpus,
                          const float* __restrict__ sqn,
                          const uint8_t* __restrict__ mask, int B, int D,
                          int k, int block, int fold,
                          float* __restrict__ out_v, int* __restrict__ out_i) {
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
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
#pragma unroll
      for (int f = 0; f < FPW; ++f) {
        const int fid = warp * FPW + f, fr = fid / FC, fc = fid % FC;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(a, A + fr * 16 * LDK + kk, LDK);
        wmma::load_matrix_sync(b, Bm + fc * 16 * LDK + kk, LDK);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
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

  // k rounds of extract-min over the bucket minima, one warp a query
  for (int r = warp; r < qrows; r += NWARPS) {
    float* v = bval + r * folds;
    const uint8_t* lc = bloc + r * folds;
    const size_t obase = (g * B + q0 + r) * size_t(k);
    for (int round = 0; round < k; ++round) {
      float bv = INFINITY;
      int bj = 0x7fffffff;
      for (int j = lane; j < folds; j += 32) {
        const float x = v[j];
        if (x < bv) {
          bv = x;
          bj = j;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, o);
        const int oj = __shfl_xor_sync(FULL, bj, o);
        if (ov < bv || (ov == bv && oj < bj)) {
          bv = ov;
          bj = oj;
        }
      }
      if (lane == 0) {
        out_v[obase + round] = bv;
        out_i[obase + round] = int(lc[bj]) * folds + bj;
        v[bj] = MASKD;
      }
      __syncwarp();
    }
  }
}

template <typename T, int QT, int RT, bool VEC>
cudaError_t launch(const float* q, const T* c, const float* sqn,
                   const uint8_t* m, int B, int N, int D, int k, int block,
                   int fold, float* ov, int* oi, cudaStream_t stream) {
  auto kern = fused_flat_l2_topk_kernel<T, QT, RT, VEC>;
  const size_t smem = Layout<QT, RT>::bytes(block / fold);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const long long grid = (long long)((B + QT - 1) / QT) * (N / block);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<unsigned(grid), NTHREADS, smem, stream>>>(q, c, sqn, m, B, D, k,
                                                  block, fold, ov, oi);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const float* q, const T* c, const float* sqn,
                     const uint8_t* m, int B, int N, int D, int k, int block,
                     int fold, float* ov, int* oi, cudaStream_t s, bool vec) {
  const bool wide = block / fold > 512;
  if (wide)
    return vec ? launch<T, 16, 128, true>(q, c, sqn, m, B, N, D, k, block,
                                          fold, ov, oi, s)
               : launch<T, 16, 128, false>(q, c, sqn, m, B, N, D, k, block,
                                           fold, ov, oi, s);
  return vec ? launch<T, 64, 64, true>(q, c, sqn, m, B, N, D, k, block, fold,
                                       ov, oi, s)
             : launch<T, 64, 64, false>(q, c, sqn, m, B, N, D, k, block, fold,
                                        ov, oi, s);
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
  if (B < 1 || D < 1 || k < 1 || k > 64 || fold < 1 || fold > 16 ||
      block < 128 || block > 2048 || block % 128 != 0 || block % fold != 0 ||
      block / fold < k || N < block || N % block != 0)
    return int(cudaErrorInvalidValue);
  const uintptr_t qa = reinterpret_cast<uintptr_t>(queries);
  const uintptr_t ca = reinterpret_cast<uintptr_t>(corpus);
  const bool vec = D % 4 == 0 && qa % 16 == 0 &&
                   ca % (corpus_bf16 ? 8 : 16) == 0;
  const float* q = static_cast<const float*>(queries);
  const float* sq = static_cast<const float*>(sqnorms);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* ov = static_cast<float*>(out_vals);
  int* oi = static_cast<int*>(out_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      corpus_bf16
          ? dispatch(q, static_cast<const __nv_bfloat16*>(corpus), sq, m, B, N,
                     D, k, block, fold, ov, oi, s, vec)
          : dispatch(q, static_cast<const float*>(corpus), sq, m, B, N, D, k,
                     block, fold, ov, oi, s, vec);
  return int(e);
}

const char* fused_flat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
