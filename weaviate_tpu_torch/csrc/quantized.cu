// Quantized scans with exact top-k: Q1 (BQ, packed hamming) and Q2 (SQ,
// float query x byte codes), and the selection passes they share.
//
// Replaces the XLA programs of weaviate_tpu/ops/quantized.py:
//
//   * Q1 `bq_search` (:138, with `_chunked_topk` :68 and `unpack_bits`
//     :55): hamming(q, x) = |q| + |x| - 2 q.x over the sign bits of the
//     first `dims` dimensions. The JAX program unpacks the bits to bf16 and
//     multiplies on the matrix unit; here each thread counts one row's
//     words against a tile of 16 queries held in shared memory
//     (`__popc(q & x)`). The distances are exact integers held as float32,
//     so this route and the plain one agree bit for bit.
//   * Q2 `sq_search` (:168, with `_bf16_ip` :122): q . decode(c) =
//     s * (bf16(q) . c) + a * sum(q). A block computes a 64-query x
//     128-row tile with warp matrix products (`wmma`, bf16 in, float32
//     sums): the queries come rounded to bf16 (round to nearest even, as
//     `_bf16_ip` casts them), code tiles are widened from uint8 to bf16 in
//     shared memory (exact: codes <= 255), and the epilogue applies the
//     affine decode with sum(q) and sum(q^2) taken in float32 from the
//     unrounded queries; l2-squared is clamped at 0, dot negated, cosine
//     1 - x.
//   * The selection (`_chunked_topk` and `merge_topk`, ops/topk.py:17): the
//     exact `k` smallest by (distance, row), lower row first on ties, as
//     the chunked `lax.top_k` + stable merges give. The scans write one
//     32-bit order key a (query, row) into a [B, N] block: the float bits,
//     sign-flipped so unsigned order is float order (-0 as +0); masked rows
//     get the key of MASK_DISTANCE. Three radix-histogram passes
//     (11/11/10 bits, the host picks each digit from the histogram's
//     prefix sums) find each query's k-th key T and how many of the keys
//     equal to T to take. A counting pass counts, per segment of a row,
//     the keys below T and equal to T; a collecting pass then writes, in
//     row order, the keys below T and the first `need` keys equal to T at
//     their exact positions. The host sorts those k entries stably by key.
//
// Bound on this card. Q1 at 10,000,000 x 768 bits and B = 256: 1.01 GB of
// words, popcounts and mask (0.30 ms at 3.35 TB/s) against 3.93e12 bit
// operations (1.99 ms at the int8 tensor-core rate): operations. `__popc`
// runs 16 a clock on an SM, so this first kernel is held by the popcount
// pipe (about 15 ms); int8 or b1 `mma` is a later design. Q2 at 550,000 x
// 768 and B = 256: 216 GFLOP, 0.219 ms at the bf16 tensor-core rate, over
// 0.126 ms of bytes: operations; this first kernel stages tiles through
// registers without a pipeline. The selection moves the [B, N] key block
// five times (three histograms, count, collect), which at Q1's shape is as
// much time again as the scan: the key block is what a later design
// removes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr float kMask = 1e30f;  // MASK_DISTANCE of ops/distance.py
constexpr int kMaxD = 4096;
constexpr int kMaxK = 4096;
constexpr int kBins = 2048;
constexpr unsigned kFull = 0xffffffffu;

// Q1: queries a block, threads a block (one row a thread)
constexpr int kBqQ = 16;
constexpr int kBqThreads = 256;
// Q2: a block's tile of queries x rows, the depth of a step, the tiles'
// leading dimension (padded), threads a block (2 x 4 warps of 32 x 32)
constexpr int kSqM = 64;
constexpr int kSqN = 128;
constexpr int kSqK = 32;
constexpr int kSqLd = kSqK + 8;
constexpr int kSqCLd = kSqN + 4;
constexpr int kSqThreads = 256;
// selection passes: threads a block, keys a thread a collecting step
constexpr int kSelThreads = 512;
constexpr int kItems = 4;

enum Refused {
  kBadShape = -1,
  kBadDims = -2,
  kBadK = -3,
  kBadMetric = -4,
  kBadBits = -5,
};

__device__ __forceinline__ uint32_t order_key(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;  // -0 orders as +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// -- Q1 --------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(kBqThreads)
bq_scan_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
               const float* __restrict__ pop, const uint8_t* __restrict__ mask,
               uint32_t* __restrict__ keys, int b, int n, int w,
               uint32_t last) {
  extern __shared__ __align__(16) uint32_t sq[];  // [kBqQ][wpad]
  __shared__ float qpop[kBqQ];
  const int wpad = (w + 7) & ~7;
  const int q0 = blockIdx.y * kBqQ;
  for (int i = threadIdx.x; i < kBqQ * wpad; i += blockDim.x) {
    const int qi = i / wpad, j = i % wpad;
    uint32_t v = 0u;
    if (q0 + qi < b && j < w) {
      v = q[(size_t)(q0 + qi) * w + j];
      if (j == w - 1) v &= last;  // bits past `dims` do not count
    }
    sq[i] = v;
  }
  __syncthreads();
  if (threadIdx.x < kBqQ) {
    int c = 0;
    for (int j = 0; j < wpad; ++j) c += __popc(sq[threadIdx.x * wpad + j]);
    qpop[threadIdx.x] = static_cast<float>(c);
  }
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  int acc[kBqQ];
#pragma unroll
  for (int i = 0; i < kBqQ; ++i) acc[i] = 0;
  const uint32_t* xr = x + (size_t)row * w;
  for (int j0 = 0; j0 < wpad; j0 += 8) {
    uint32_t xv[8];
    if (VEC) {  // w % 4 == 0: rows are 16-byte aligned
      const uint4* p4 = reinterpret_cast<const uint4*>(xr + j0);
      const uint4 lo = __ldg(p4);
      const uint4 hi = j0 + 4 < w ? __ldg(p4 + 1) : make_uint4(0, 0, 0, 0);
      xv[0] = lo.x; xv[1] = lo.y; xv[2] = lo.z; xv[3] = lo.w;
      xv[4] = hi.x; xv[5] = hi.y; xv[6] = hi.z; xv[7] = hi.w;
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) xv[t] = j0 + t < w ? __ldg(xr + j0 + t) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kBqQ; ++i) {
      const uint4* s4 = reinterpret_cast<const uint4*>(sq + i * wpad + j0);
      const uint4 s0 = s4[0], s1 = s4[1];
      acc[i] += __popc(xv[0] & s0.x) + __popc(xv[1] & s0.y) +
                __popc(xv[2] & s0.z) + __popc(xv[3] & s0.w) +
                __popc(xv[4] & s1.x) + __popc(xv[5] & s1.y) +
                __popc(xv[6] & s1.z) + __popc(xv[7] & s1.w);
    }
  }
  const float p = __ldg(pop + row);
  const bool live = mask == nullptr || mask[row] != 0;
#pragma unroll
  for (int i = 0; i < kBqQ; ++i) {
    if (q0 + i >= b) break;
    // (|q| + |x|) - 2 q.x: every term an exact integer in float32
    const float d = live ? (qpop[i] + p) - 2.0f * static_cast<float>(acc[i])
                         : kMask;
    keys[(size_t)(q0 + i) * n + row] = order_key(d);
  }
}

// -- Q2 --------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(kSqThreads)
sq_scan_kernel(const __nv_bfloat16* __restrict__ q,
               const uint8_t* __restrict__ codes,
               const float* __restrict__ dsq, const uint8_t* __restrict__ mask,
               const float* __restrict__ qsum, const float* __restrict__ qsq,
               float a, float s, int metric, uint32_t* __restrict__ keys,
               int b, int n, int d) {
  using namespace nvcuda;
  // the A/B tiles during the products, the float32 tile after them
  __shared__ __align__(128) unsigned char smem[kSqM * kSqCLd * 4];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // [kSqM][kSqLd]
  __nv_bfloat16* bs = as + kSqM * kSqLd;                       // [kSqN][kSqLd]
  float* cs = reinterpret_cast<float*>(smem);                  // [kSqM][kSqCLd]
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int q0 = blockIdx.y * kSqM, r0 = blockIdx.x * kSqN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int k0 = 0; k0 < d; k0 += kSqK) {
    {  // queries: 64 x 32, 8 a thread
      const int r = tid >> 2, c = (tid & 3) * 8, qi = q0 + r;
      __nv_bfloat16* dst = as + r * kSqLd + c;
      if (VEC && qi < b && k0 + c + 8 <= d) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(q + (size_t)qi * d + k0 + c);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t)
          dst[t] = qi < b && k0 + c + t < d ? q[(size_t)qi * d + k0 + c + t]
                                            : zero;
      }
    }
    {  // codes: 128 x 32, 16 a thread, widened to bf16
      const int r = tid >> 1, c = (tid & 1) * 16, row = r0 + r;
      __nv_bfloat16* dst = bs + r * kSqLd + c;
      uint8_t v[16];
      if (VEC && row < n && k0 + c + 16 <= d) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(
            codes + (size_t)row * d + k0 + c));
        const uint8_t* pu = reinterpret_cast<const uint8_t*>(&u);
#pragma unroll
        for (int t = 0; t < 16; ++t) v[t] = pu[t];
      } else {
#pragma unroll
        for (int t = 0; t < 16; ++t)
          v[t] = row < n && k0 + c + t < d ? codes[(size_t)row * d + k0 + c + t]
                                           : 0;
      }
#pragma unroll
      for (int t = 0; t < 16; ++t)
        dst[t] = __float2bfloat16(static_cast<float>(v[t]));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSqK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * kSqLd + kk,
                               kSqLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + (wn * 32 + j * 16) * kSqLd + kk,
                               kSqLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kSqCLd + wn * 32 + j * 16,
                              acc[i][j], kSqCLd, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kSqM * kSqN; e += kSqThreads) {
    const int qi = e / kSqN, r = e % kSqN;
    const int qg = q0 + qi, row = r0 + r;
    if (qg >= b || row >= n) continue;
    const float ip = cs[qi * kSqCLd + r];
    const float qdd = s * ip + a * qsum[qg];
    float dist;
    if (metric == 0) {
      dist = fmaxf(qsq[qg] - 2.0f * qdd + dsq[row], 0.0f);
    } else if (metric == 1) {
      dist = -qdd;
    } else {
      dist = 1.0f - qdd;
    }
    if (mask != nullptr && !mask[row]) dist = kMask;
    keys[(size_t)qg * n + row] = order_key(dist);
  }
}

// -- selection -------------------------------------------------------------

// Histogram of the digit (key >> shift) & (2^bits - 1) over the keys of row
// blockIdx.y, segment blockIdx.x, whose bits above shift + bits equal the
// row's prefix. Lanes with the same digit add once (__match_any_sync): the
// keys of a query crowd a few digits.
__global__ void __launch_bounds__(kSelThreads)
radix_hist_kernel(const uint32_t* __restrict__ keys,
                  const uint32_t* __restrict__ prefix, int* __restrict__ hist,
                  int n, int seg_len, int shift, int bits) {
  __shared__ int sh[kBins];
  const int nb = 1 << bits, hi = shift + bits;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const int qi = blockIdx.y, lane = threadIdx.x & 31;
  const uint32_t pre = prefix[qi];
  const uint32_t* row = keys + (size_t)qi * n;
  const int lo = blockIdx.x * seg_len;
  const int end = min(n, lo + seg_len);
  for (int i0 = lo; i0 < end; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    int bin = -1;
    if (i < end) {
      const uint32_t key = row[i];
      if (hi >= 32 || (key >> hi) == (pre >> hi))
        bin = static_cast<int>((key >> shift) & (nb - 1));
    }
    const unsigned peers = __match_any_sync(kFull, bin);
    if (bin >= 0 && __ffs(peers) - 1 == lane) atomicAdd(&sh[bin], __popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += blockDim.x)
    if (sh[i]) atomicAdd(hist + (size_t)qi * kBins + i, sh[i]);
}

// Keys below and equal to the row's threshold in each segment:
// counts[row][seg] = {below, equal}.
__global__ void __launch_bounds__(kSelThreads)
count_kernel(const uint32_t* __restrict__ keys,
             const uint32_t* __restrict__ thresh, int* __restrict__ counts,
             int n, int seg_len, int segs) {
  __shared__ int sh[2];
  if (threadIdx.x < 2) sh[threadIdx.x] = 0;
  __syncthreads();
  const int qi = blockIdx.y;
  const uint32_t t = thresh[qi];
  const uint32_t* row = keys + (size_t)qi * n;
  const int lo = blockIdx.x * seg_len;
  const int end = min(n, lo + seg_len);
  int lt = 0, eq = 0;
  for (int i = lo + threadIdx.x; i < end; i += blockDim.x) {
    const uint32_t key = row[i];
    lt += key < t;
    eq += key == t;
  }
  for (int off = 16; off > 0; off >>= 1) {
    lt += __shfl_xor_sync(kFull, lt, off);
    eq += __shfl_xor_sync(kFull, eq, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&sh[0], lt);
    atomicAdd(&sh[1], eq);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int* c = counts + ((size_t)qi * segs + blockIdx.x) * 2;
    c[0] = sh[0];
    c[1] = sh[1];
  }
}

// Exclusive block-wide prefix sum of v in thread order; `total` gets the
// block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* ws,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? ws[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    ws[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? ws[warp - 1] : 0;
  total = ws[nw - 1];
  __syncthreads();  // ws is read before the next scan writes it
  return before + x - v;
}

// Writes, in row order, the keys of segment blockIdx.x of row blockIdx.y
// below the threshold and the first `need` equal to it across the row, at
// their positions among the row's taken keys: the keys below it and the
// taken equal ones before them. offsets[row][seg] = {below, equal} before
// the segment.
__global__ void __launch_bounds__(kSelThreads)
collect_kernel(const uint32_t* __restrict__ keys,
               const uint32_t* __restrict__ thresh,
               const int* __restrict__ need,
               const int* __restrict__ offsets, uint32_t* __restrict__ out_keys,
               int* __restrict__ out_cols, int n, int seg_len, int segs,
               int k) {
  __shared__ int ws[32];
  const int qi = blockIdx.y;
  const uint32_t t = thresh[qi];
  const int nd = need[qi];
  const uint32_t* row = keys + (size_t)qi * n;
  const int* off = offsets + ((size_t)qi * segs + blockIdx.x) * 2;
  int lt_base = off[0], eq_base = off[1];
  const int lo = blockIdx.x * seg_len;
  const int end = min(n, lo + seg_len);
  uint32_t* ok = out_keys + (size_t)qi * k;
  int* oc = out_cols + (size_t)qi * k;
  for (int i0 = lo; i0 < end; i0 += blockDim.x * kItems) {
    const int first = i0 + threadIdx.x * kItems;
    uint32_t v[kItems];
    int lt = 0, eq = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = first + j;
      v[j] = i < end ? row[i] : 0xffffffffu;
      lt += i < end && v[j] < t;
      eq += i < end && v[j] == t;
    }
    int total;
    // both counts in one scan: a block's step holds at most 2048 keys
    const int ex = block_exclusive_scan(lt | (eq << 16), ws, total);
    int lt_before = lt_base + (ex & 0xffff);
    int eq_before = eq_base + (ex >> 16);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = first + j;
      if (i >= end) break;
      if (v[j] < t) {
        const int pos = lt_before + min(eq_before, nd);
        ok[pos] = v[j];
        oc[pos] = i;
        ++lt_before;
      } else if (v[j] == t) {
        if (eq_before < nd) {
          const int pos = lt_before + eq_before;
          ok[pos] = v[j];
          oc[pos] = i;
        }
        ++eq_before;
      }
    }
    lt_base += total & 0xffff;
    eq_base += total >> 16;
  }
}

int seg_len_of(int n, int segs) { return (n + segs - 1) / segs; }

}  // namespace

extern "C" {

// Q1: order keys [b, n] of the hamming distances of the packed queries
// [b, w] to the packed rows [n, w] (int32 words, bits past `dims` ignored),
// with the rows' popcounts [n]; mask [n] (null = every row live).
int bq_scan(const uint32_t* q, const uint32_t* x, const float* pop,
            const uint8_t* mask, uint32_t* keys, int b, int n, int w,
            int dims, void* stream) {
  if (b < 1 || n < 1 || w < 1) return kBadShape;
  if (dims < 1 || dims > kMaxD || w != (dims + 31) / 32) return kBadDims;
  const uint32_t last = dims % 32 ? (1u << (dims % 32)) - 1u : kFull;
  const dim3 grid((n + kBqThreads - 1) / kBqThreads, (b + kBqQ - 1) / kBqQ);
  const size_t smem = (size_t)kBqQ * ((w + 7) & ~7) * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w % 4 == 0)
    bq_scan_kernel<true><<<grid, kBqThreads, smem, st>>>(q, x, pop, mask, keys,
                                                        b, n, w, last);
  else
    bq_scan_kernel<false><<<grid, kBqThreads, smem, st>>>(q, x, pop, mask,
                                                         keys, b, n, w, last);
  return static_cast<int>(cudaGetLastError());
}

// Q2: order keys [b, n] of the SQ distances of the bf16 queries [b, d] to
// the codes [n, d] (metric 0 l2-squared, 1 dot, 2 cosine), with the
// queries' float32 sums and sums of squares [b] and the rows' decoded
// squared norms [n].
int sq_scan(const __nv_bfloat16* q, const uint8_t* codes, const float* dsq,
            const uint8_t* mask, const float* qsum, const float* qsq, float a,
            float s, int metric, uint32_t* keys, int b, int n, int d,
            void* stream) {
  if (b < 1 || n < 1) return kBadShape;
  if (d < 1 || d > kMaxD) return kBadDims;
  if (metric < 0 || metric > 2) return kBadMetric;
  const dim3 grid((n + kSqN - 1) / kSqN, (b + kSqM - 1) / kSqM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 16 == 0)
    sq_scan_kernel<true><<<grid, kSqThreads, 0, st>>>(
        q, codes, dsq, mask, qsum, qsq, a, s, metric, keys, b, n, d);
  else
    sq_scan_kernel<false><<<grid, kSqThreads, 0, st>>>(
        q, codes, dsq, mask, qsum, qsq, a, s, metric, keys, b, n, d);
  return static_cast<int>(cudaGetLastError());
}

// One radix-select pass over keys [b, n]: hist [b, 2048] (zeroed) gets the
// counts of digit (key >> shift) & (2^bits - 1) among the keys whose bits
// above shift + bits equal prefix[row].
int topk_radix_hist(const uint32_t* keys, const uint32_t* prefix, int* hist,
                    int b, int n, int segs, int shift, int bits,
                    void* stream) {
  if (b < 1 || n < 1 || segs < 1) return kBadShape;
  if (bits < 1 || bits > 11 || shift < 0 || shift + bits > 32) return kBadBits;
  const dim3 grid(segs, b);
  radix_hist_kernel<<<grid, kSelThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, prefix, hist, n, seg_len_of(n, segs), shift, bits);
  return static_cast<int>(cudaGetLastError());
}

// counts [b, segs, 2]: per segment of each row, the keys below thresh[row]
// and those equal to it.
int topk_count(const uint32_t* keys, const uint32_t* thresh, int* counts,
               int b, int n, int segs, void* stream) {
  if (b < 1 || n < 1 || segs < 1) return kBadShape;
  const dim3 grid(segs, b);
  count_kernel<<<grid, kSelThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, thresh, counts, n, seg_len_of(n, segs), segs);
  return static_cast<int>(cudaGetLastError());
}

// The k smallest keys of each row in row order: those below thresh[row] and
// the first need[row] equal to it (out_keys, out_cols [b, k]); offsets
// [b, segs, 2] are the exclusive prefix sums of topk_count's counts.
int topk_collect(const uint32_t* keys, const uint32_t* thresh, const int* need,
                 const int* offsets, uint32_t* out_keys, int* out_cols, int b,
                 int n, int segs, int k, void* stream) {
  if (b < 1 || n < 1 || segs < 1) return kBadShape;
  if (k < 1 || k > kMaxK || k > n) return kBadK;
  const dim3 grid(segs, b);
  collect_kernel<<<grid, kSelThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, thresh, need, offsets, out_keys, out_cols, n, seg_len_of(n, segs),
      segs, k);
  return static_cast<int>(cudaGetLastError());
}

const char* quantized_error_string(int code) {
  switch (code) {
    case kBadShape: return "b, n, w and segments must be >= 1";
    case kBadDims: return "dims outside [1, 4096] or words != ceil(dims/32)";
    case kBadK: return "k outside [1, min(4096, n)]";
    case kBadMetric: return "SQ metric code outside 0..2";
    case kBadBits: return "radix digit outside 1..11 bits below bit 32";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
