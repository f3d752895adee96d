// Quantized scans with an exact top-k in their epilogue: Q1 (BQ, packed
// hamming on the tensor cores), Q2 (SQ, bf16 queries x byte codes on the
// tensor cores), Q3 (PQ, bf16 queries x rows decoded through the codebooks)
// and Q4 (RQ, Q2 with a per-row decode), and the merge of their per-split
// partials.
//
// Replaces the XLA programs of weaviate_tpu/ops/quantized.py:
//
//   * Q1 `bq_search` (:138, with `_chunked_topk` :68 and `unpack_bits`
//     :55): hamming(q, x) = |q| + |x| - 2 q.x over the sign bits of the
//     first `dims` dimensions. The JAX program unpacks the bits to bf16 and
//     multiplies on the matrix unit. Here the packed words are the operands
//     of a 1-bit tensor-core product, `mma.m16n8k256 .b1 .and.popc`. Its sum
//     is an exact integer, so the distances equal the plain version's bit
//     for bit.
//   * Q2 `sq_search` (:168, with `_bf16_ip` :122): q . decode(c) =
//     s * (bf16(q) . c) + a * sum(q). `mma.m16n8k16` bf16 products with
//     float32 sums: the queries come rounded to bf16 (round to nearest
//     even, as `_bf16_ip` casts them), the code tiles arrive as bytes and
//     are widened to bf16 in shared memory (exact: codes <= 255), and the
//     epilogue applies the affine decode with sum(q) and sum(q^2) taken in
//     float32 from the unrounded queries; l2-squared is clamped at 0, dot
//     negated, cosine 1 - x.
//   * Q3 `pq_search` (:204): bf16(q) . bf16(decode(c)), decode(c) the
//     concatenated centroids of the row's codes, with float32 sums; the
//     epilogue is the metric of that product alone (l2-squared with the
//     decoded row's squared norm). Q4 `rq_search` (:241): step_x * (bf16(q)
//     . c) + sum(q) * lower_x, each row's own affine decode.
//   * The selection (`_chunked_topk` and `merge_topk`, ops/topk.py:17): the
//     exact `k` smallest by (distance, row), lower row first on ties, as
//     the chunked `lax.top_k` + stable merges give.
//
// What bounds each on this card at phase `quant`'s shapes. Q1, 10,002,432
// x 768 bits and B = 256: 3.93e12 bit operations, 1.99 ms at the int8
// tensor-core rate, over 1.01 GB of words, popcounts and mask (0.30 ms at
// 3.35 TB/s): operations. Q2, 552,960 x 768 and B = 256: 217 GFLOP, 0.220
// ms at the bf16 rate, over 0.43 GB (0.126 ms): operations, with bytes
// close behind. Q4 at the same shape: the same products, 4.4 MB more of
// per-row floats. Q3 at config 3 (1,000,000 x 1536, 96 segments, B = 256):
// 7.9e11 products, 0.80 ms at the bf16 rate, over 0.1 GB of codes and
// norms: operations.
//
// What the design does about it. The products run on the tensor cores, and
// nothing of size [B, N] reaches device memory: a CTA owns a tile of 128
// queries and a split (a contiguous range of rows, walked in increasing
// order in tiles through a cp.async ring) and keeps each query's exact
// top-k of the split in its epilogue. A tile's products land in shared
// memory as keys (Q1: the 16-bit distances; Q2: 32-bit order keys, the
// float bits sign-flipped so unsigned order is float order); a row masked
// or past the split gets a key that is never taken. Each query has a
// threshold and a candidate list in device memory, [splits, B, cap]: a row
// enters only if its key is below the threshold, so a later row that ties
// it loses the tie, and the list stays in row order. When a tile's takers
// would overflow the list, the query's warp compacts it to its k smallest
// by (key, row): four 8-bit radix passes find the k-th key, a stable pass
// keeps the keys below it and the first of those equal to it, and the k-th
// key becomes the threshold. At the end of its split a list is compacted
// to k and padded. The merge, one CTA a query, takes the [splits, k]
// partials to k the same way and sorts them by (key, row). A search is one
// scan launch and one merge launch, for any B.
//
// Q2, Q3 and Q4 are one template (`code_scan_kernel`): the same query ring,
// product tiles, epilogue and selection, with the row type's loader. Q3's
// rows do not fit the ring as bytes to widen: each ring step carries each
// row's code window (the words holding its codes of the segments the
// step's 64 dimensions touch, any sub-width dsub), and one step ahead of
// the products the CTA gathers every (row, piece) of the step from the bf16
// codebooks (the centroid of the row's code of that segment, the widest
// piece dsub allows: 8 values a copy, a constant of its own instance, or
// 4, 2 or 1, chosen at launch) with cp.async, straight
// into the product's bf16 tile; the gathers of step s + 1 are their own
// commit group, in flight while step s multiplies. The codebooks (786 KB at
// config 3) stay in L2: a gather moves no device-memory bytes after the
// first, and a per-query lookup table (96 KB a query) would not fit a CTA.
//
// Q1's product route: the 1-bit product measured faster than an int8 one
// (`mma.m16n8k32 .u8`) on the bits widened to {0,1} bytes in registers,
// 10.76 ms a scan against 19.43 ms on phase `quant`'s rows and 10.94
// against 19.70 on random codes at the same shapes (NVIDIA H100 80GB HBM3
// at 700 W; probe_quantized.py keeps the int8 product as its `int8`
// copy): widening bits to bytes costs more integer work than the int8
// rate wins, so only the 1-bit product is kept. Neither scan is held by
// its product: with the selection switched off Q1 takes 2.6 ms and Q2
// 1.4 ms, so the epilogue selection is most of their time (PERF.md
// section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


namespace {

constexpr float kMask = 1e30f;  // MASK_DISTANCE of ops/distance.py
constexpr int kMaxD = 4096;
constexpr int kMaxK = 4096;
constexpr uint32_t kNone = 0xffffffffu;  // never below a threshold
constexpr unsigned kFull = 0xffffffffu;

// both scans: threads a CTA (8 warps: 2 over the queries x 4 over the
// rows), queries a CTA, radix digit bins
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 128;
constexpr int kBins = 256;
// Q1: rows a tile (a ring stage), ring stages, CTAs an SM holds
constexpr int kBqR = 64;
constexpr int kBqStages = 3;
constexpr int kBqCtasPerSm = 2;
// Q2: rows a tile, depth of a ring step, ring stages, the bf16 tiles'
// leading dimension (144 bytes: ldmatrix rows fall in distinct banks)
constexpr int kSqR = 128;
constexpr int kSqK = 64;
constexpr int kSqStages = 4;
constexpr int kSqLd = kSqK + 8;
constexpr int kSqCtasPerSm = 1;

enum Refused {
  kBadShape = -1,
  kBadDims = -2,
  kBadK = -3,
  kBadMetric = -4,
  kBadPlan = -5,
  kBadCodebook = -6,
  kBadAlign = -7,
};

__device__ __forceinline__ uint32_t order_key(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;  // -0 orders as +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_to_float(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from global to shared, zero-filled when !ok (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// The mask bytes of rows r .. r + 3 (r a multiple of 4) into shared memory:
// one 4-byte copy, or byte by byte where the corpus ends
__device__ __forceinline__ void load_mask4(uint8_t* dst, const uint8_t* mask,
                                           int r, int n) {
  if (r + 3 < n) {
    cp_async4(dst, mask + r, true);
  } else {
    for (int j = 0; j < 4; ++j) dst[j] = r + j < n ? mask[r + j] : 0;
  }
}

// the oldest of a ring's stages in flight has landed
template <int STAGES>
__device__ __forceinline__ void cp_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
}

// -- the epilogue selection --------------------------------------------------

// queries a warp owns in a CTA: query tile rows warp, warp + 8, ...
constexpr int kQW = kQT / kWarps;

// Loads a batch of kBatch keys a lane (entries base + j * 32 + lane) before
// using any: the loads overlap instead of waiting one by one
constexpr int kBatch = 8;

// The digit (key >> shift) & 255 of a key equal to `prefix` above it,
// counted into hist[256]
__device__ __forceinline__ void count_digit(uint32_t key, bool ok,
                                            uint32_t prefix, uint32_t high,
                                            int shift, int* hist) {
  if (ok && (key & high) == prefix) atomicAdd(&hist[(key >> shift) & 255], 1);
}

// The digit holding the need-th key of hist[256] (warp-wide; lane l reads
// bins 8l..8l+7): returns it, and subtracts the keys below it from need.
__device__ __forceinline__ int pick_digit(const int* hist, int& need) {
  const int lane = threadIdx.x & 31;
  int c[8], sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = hist[lane * 8 + j];
    sum += c[j];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  int run = incl - sum, digit = -1, below = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (digit < 0 && run + c[j] >= need) {
      digit = lane * 8 + j;
      below = run;
    }
    run += c[j];
  }
  const int src = __ffs(__ballot_sync(kFull, digit >= 0)) - 1;
  need -= __shfl_sync(kFull, below, src);
  return __shfl_sync(kFull, digit, src);
}

// Radix select within one warp: the need-th smallest (1-based) of the n
// keys at `keys`, by four 8-bit digits. Returns that key; `need` becomes
// how many keys equal to it are among the need smallest. The list was
// written by this warp: after the first pass it is read from L1.
__device__ uint32_t warp_kth_key(const uint32_t* keys, int n, int& need,
                                 int* hist) {
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = lane; i < kBins; i += 32) hist[i] = 0;
    __syncwarp();
    const uint32_t high = shift == 24 ? 0u : (kFull << (shift + 8));
    for (int base = 0; base < n; base += 32 * kBatch) {
      uint32_t v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * 32 + lane;
        v[j] = i < n ? keys[i] : 0u;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        count_digit(v[j], base + j * 32 + lane < n, prefix, high, shift,
                    hist);
    }
    __syncwarp();
    prefix |= static_cast<uint32_t>(pick_digit(hist, need)) << shift;
    __syncwarp();  // the bins are read before the next pass clears them
  }
  return prefix;
}

// Compacts a query's list (n > k entries in row order) in place to its k
// smallest by (key, row), still in row order; returns the k-th key, the
// new threshold.
__device__ __noinline__ uint32_t warp_compact(uint32_t* lk, int* lr, int n,
                                              int k, int* hist) {
  const int lane = threadIdx.x & 31;
  const unsigned before = (1u << lane) - 1u;
  int need = k;
  const uint32_t t = warp_kth_key(lk, n, need, hist);
  int w = 0, eq_seen = 0;
  for (int base = 0; base < n; base += 32 * kBatch) {
    // a batch is read whole before any of it is written; writes land at
    // or before an entry's own slot, so no unread entry is overwritten
    uint32_t key[kBatch];
    int row[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * 32 + lane;
      key[j] = i < n ? lk[i] : kNone;
      row[j] = i < n ? lr[i] : -1;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool in = base + j * 32 + lane < n;
      const bool eq = in && key[j] == t;
      const unsigned em = __ballot_sync(kFull, eq);
      const bool keep = (in && key[j] < t) ||
                        (eq && eq_seen + __popc(em & before) < need);
      const unsigned km = __ballot_sync(kFull, keep);
      if (keep) {
        const int p = w + __popc(km & before);
        lk[p] = key[j];
        lr[p] = row[j];
      }
      w += __popc(km);
      eq_seen += __popc(em);
    }
    __syncwarp();
  }
  return t;
}

// A tile's keys as the scans write them. Q2's are the order keys the
// lists hold. Q1's are the hamming distances themselves, 16 bits (at most
// kMaxD; 0xffff for a row never taken): the list key of one is the order
// key of the distance as a float, and a list's threshold (an order key)
// is a distance again as a tile's threshold.
struct OrderKeys {
  using T = uint32_t;
  static constexpr uint32_t kAll = kNone;
  __device__ static uint32_t to_list(uint32_t key) { return key; }
  __device__ static uint32_t from_list(uint32_t t) { return t; }
};

struct HammingKeys {
  using T = uint16_t;
  static constexpr uint32_t kAll = 0xffffu;
  __device__ static uint32_t to_list(uint32_t d) {
    return order_key(static_cast<float>(d));
  }
  __device__ static uint32_t from_list(uint32_t t) {
    return static_cast<uint32_t>(key_to_float(t));
  }
};

// A warp's lists: lane i < kQW holds the threshold (in the tile's key
// domain) and the count of its query i (tile row warp + 8 i); a candidate
// enters if its key is below the threshold. A query past the batch gets
// threshold 0: nothing enters.
struct Lists {
  uint32_t thresh;
  int count;
};

template <typename K>
__device__ __forceinline__ Lists init_lists(int q0, int b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return {q0 + warp + kWarps * lane < b ? K::kAll : 0u, 0};
}

// The candidates of one tile: keys tk [kQT][ld] of rows r0.. (R of them).
// For each of the warp's queries, unrolled so their loads and ballots
// overlap: count the takers (keys below the threshold); if they would
// overflow the list (rare), compact it and apply the new threshold; append
// the takers in row order.
template <int R, typename K>
__device__ void select_tile(Lists& st, const typename K::T* tk, int ld,
                            uint32_t* lk, int* lr, int q0, int b, int split,
                            int cap, int k, int r0, int* hist) {
  constexpr int kC = R / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned before = (1u << lane) - 1u;
  const size_t base0 = ((size_t)split * b + q0 + warp) * cap;
  const size_t step = (size_t)kWarps * cap;  // from query i to i + 1
  const Lists in = st;  // read from here, written to st: no chain
#pragma unroll
  for (int i = 0; i < kQW; ++i) {
    uint32_t t = __shfl_sync(kFull, in.thresh, i);
    int cnt = __shfl_sync(kFull, in.count, i);
    const typename K::T* row = tk + (warp + kWarps * i) * ld + lane;
    uint32_t* qk = lk + base0 + i * step;
    int* qr = lr + base0 + i * step;
    uint32_t key[kC];
    unsigned m[kC];
    int takers = 0;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      key[c] = row[c * 32];
      m[c] = __ballot_sync(kFull, key[c] < t);
      takers += __popc(m[c]);
    }
    if (cnt + takers > cap) {
      t = K::from_list(warp_compact(qk, qr, cnt, k, hist));
      cnt = k;
#pragma unroll
      for (int c = 0; c < kC; ++c) m[c] = __ballot_sync(kFull, key[c] < t);
      st.thresh = lane == i ? t : st.thresh;
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (key[c] < t) {
        const int p = cnt + __popc(m[c] & before);
        qk[p] = K::to_list(key[c]);
        qr[p] = r0 + c * 32 + lane;
      }
      cnt += __popc(m[c]);
    }
    st.count = lane == i ? cnt : st.count;
  }
  __syncwarp();
}

// The end of a split: each list compacted to k entries and padded to k.
__device__ void finish_split(const Lists& st, uint32_t* lk, int* lr, int q0,
                             int b, int split, int cap, int k, int* hist) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < kQW; ++i) {
    const int ql = warp + kWarps * i;
    int cnt = __shfl_sync(kFull, st.count, i);
    if (q0 + ql >= b) break;
    const size_t base = ((size_t)split * b + q0 + ql) * cap;
    if (cnt > k) {
      warp_compact(lk + base, lr + base, cnt, k, hist);
      cnt = k;
    }
    for (int j = cnt + lane; j < k; j += 32) {
      lk[base + j] = kNone;
      lr[base + j] = -1;
    }
  }
}

// -- Q1 ----------------------------------------------------------------------

__device__ __forceinline__ void mma_b1(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A stage of Q1's ring, in words: a tile's rows [kBqR][ws], their
// popcounts [kBqR] and mask bytes [kBqR]; ws = words a row, padded.
__host__ __device__ constexpr int bq_stage(int ws) {
  return kBqR * ws + kBqR + kBqR / 4;
}

// Q1's key tiles: two (one is selected from while the next is made) of
// [kQT][kBqTk] 16-bit distances
constexpr int kBqTk = kBqR + 16;

// Dynamic shared memory of Q1: the query tile's words, the ring, the two
// key tiles.
__host__ __device__ constexpr size_t bq_smem(int ws) {
  return ((size_t)kQT * ws + (size_t)kBqStages * bq_stage(ws)) * 4 +
         (size_t)2 * kQT * kBqTk * 2;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, kBqCtasPerSm)
bq_scan_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ x,
               const float* __restrict__ pop, const uint8_t* __restrict__ mask,
               uint32_t* lk, int* lr, int b, int n, int w, uint32_t last,
               int k, int split_rows, int cap) {
  extern __shared__ __align__(16) uint32_t bq_dyn[];
  __shared__ float qpop[kQT];
  __shared__ int hist[kWarps][kBins];
  const int wpad = (w + 7) & ~7;  // whole 256-bit blocks
  const int ws = wpad + 4;        // 8 rows x 4 words hit 32 banks
  uint32_t* qs = bq_dyn;                         // [kQT][ws]
  uint32_t* ring = qs + kQT * ws;                // [kBqStages][stage]
  const int stage = bq_stage(ws);
  uint16_t* tk =  // [2][kQT][kBqTk]
      reinterpret_cast<uint16_t*>(ring + kBqStages * stage);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int q0 = blockIdx.x * kQT, split = blockIdx.y;
  const int row_begin = split * split_rows;
  const int row_end = min(n, row_begin + split_rows);
  const int tiles = (row_end - row_begin + kBqR - 1) / kBqR;

  for (int i = tid; i < kQT * ws; i += kThreads) {
    const int ql = i / ws, j = i % ws;
    uint32_t v = 0u;
    if (q0 + ql < b && j < w) {
      v = q[(size_t)(q0 + ql) * w + j];
      if (j == w - 1) v &= last;  // bits past `dims` do not count
    }
    qs[i] = v;
  }
  Lists st = init_lists<HammingKeys>(q0, b);
  __syncthreads();
  if (tid < kQT) {
    int c = 0;
    for (int j = 0; j < w; ++j) c += __popc(qs[tid * ws + j]);
    qpop[tid] = static_cast<float>(c);
  }

  auto load_tile = [&](int t) {
    uint32_t* dst = ring + (t % kBqStages) * stage;
    const int r0 = row_begin + t * kBqR;
    // the rows' popcounts and mask bytes ride with them
    if (tid < kBqR) {
      const bool ok = r0 + tid < row_end;
      cp_async4(dst + kBqR * ws + tid, ok ? pop + r0 + tid : pop, ok);
    } else if (mask != nullptr && tid < kBqR + kBqR / 4) {
      const int c = tid - kBqR;
      load_mask4(reinterpret_cast<uint8_t*>(dst + kBqR * ws + kBqR + c),
                 mask, r0 + 4 * c, n);
    }
    if (VEC) {  // w % 4 == 0: 16-byte pieces
      const int per_row = w >> 2;
      for (int c = tid; c < kBqR * per_row; c += kThreads) {
        const int r = c / per_row, j = (c % per_row) * 4;
        const bool ok = r0 + r < row_end;
        cp_async16(dst + r * ws + j, ok ? x + (size_t)(r0 + r) * w + j : x,
                   ok);
      }
    } else {
      for (int c = tid; c < kBqR * w; c += kThreads) {
        const int r = c / w, j = c % w;
        const bool ok = r0 + r < row_end;
        cp_async4(dst + r * ws + j, ok ? x + (size_t)(r0 + r) * w + j : x,
                  ok);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kBqStages - 1; ++t) {
    if (t < tiles) load_tile(t);
    cp_commit();
  }
  // A tile's products, then the previous tile's selection, then this
  // tile's keys (into the other key tile): one barrier a tile.
  for (int t = 0; t <= tiles; ++t) {
    if (t < tiles) cp_wait_ring<kBqStages>();
    // tile t landed; tile t - 1's keys are written; tile t - 2's are
    // selected, so its key tile and ring stage are free
    __syncthreads();
    if (t + kBqStages - 1 < tiles) load_tile(t + kBqStages - 1);
    cp_commit();
    const uint32_t* xs = ring + (t % kBqStages) * stage;
    int acc[4][2][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    if (t < tiles) {
      // a 256-bit block is 8 words: thread (gid, tig) holds word tig and
      // word 4 + tig of its rows, the same slots of A and of B
      for (int kb = 0; kb < wpad; kb += 8) {
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const uint32_t* qa = qs + (wm * 64 + mt * 16 + gid) * ws + kb + tig;
          a[mt][0] = qa[0];
          a[mt][1] = qa[8 * ws];
          a[mt][2] = qa[4];
          a[mt][3] = qa[8 * ws + 4];
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint32_t* xb = xs + (wn * 16 + nt * 8 + gid) * ws + kb + tig;
          const uint32_t b0 = xb[0], b1 = xb[4];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma_b1(acc[mt][nt], a[mt], b0, b1);
        }
      }
    }
    if (t > 0)
      select_tile<kBqR, HammingKeys>(
          st, tk + ((t - 1) & 1) * kQT * kBqTk, kBqTk, lk, lr, q0, b, split,
          cap, k, row_begin + (t - 1) * kBqR, hist[warp]);
    if (t == tiles) break;
    // the keys of this warp's 64 queries x 16 rows
    const int r0 = row_begin + t * kBqR;
    const float* xpop = reinterpret_cast<const float*>(xs + kBqR * ws);
    const uint8_t* xmask =
        reinterpret_cast<const uint8_t*>(xs + kBqR * ws + kBqR);
    uint16_t* tkt = tk + (t & 1) * kQT * kBqTk;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int rl = wn * 16 + nt * 8 + tig * 2;
      bool ok[2];
      float xp[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ok[e] = r0 + rl + e < row_end &&
                (mask == nullptr || xmask[rl + e] != 0);
        xp[e] = xpop[rl + e];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ql = wm * 64 + mt * 16 + gid + 8 * h;
          const float qp = qpop[ql];
          // (|q| + |x|) - 2 q.x: an exact integer in [0, dims]
          uint32_t d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            d[e] = ok[e] ? static_cast<uint32_t>(
                               (qp + xp[e]) - 2.0f * static_cast<float>(
                                                  acc[mt][nt][2 * h + e]))
                         : HammingKeys::kAll;
          *reinterpret_cast<uint32_t*>(tkt + ql * kBqTk + rl) =
              d[0] | (d[1] << 16);
        }
      }
    }
  }
  finish_split(st, lk, lr, q0, b, split, cap, k, hist[warp]);
}

// -- Q2 ----------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two codes (bytes lo and lo + 1 of w) as a bf16 pair, exactly: a byte
// under the exponent of 2^23 is 2^23 + byte
__device__ __forceinline__ uint32_t widen2(uint32_t w, int lo) {
  const float f0 =
      __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7540 | lo)) - 8388608.0f;
  const float f1 =
      __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7540 | (lo + 1))) -
      8388608.0f;
  const __nv_bfloat162 v = __floats2bfloat162_rn(f0, f1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int kSqTk = kSqR + 8;

// The code scans' row types: Q2's global-affine SQ codes, Q4's per-row
// affine RQ codes, Q3's PQ codes decoded through the codebooks.
enum Rows { kSqRows = 0, kRqRows = 1, kPqRows = 2 };
// Q3: a step's codes, each row's 4-byte words holding its codes of the
// segments the step's 64 dimensions touch (at most 65 of them, from 0-3
// bytes into the first word): kPqWords words a row
constexpr int kPqWords = 17;
constexpr int kPqWin = 4 * kPqWords;

// A stage of a code scan's ring: a step's codes (Q2, Q4: [kSqR][kSqK]
// bytes; Q3: [kSqR][kPqWin] bytes, the rows' code windows), then the tile's
// per-row floats [floats][kSqR] (decoded norms; Q4 also lower and step) and
// mask bytes [kSqR] (every step carries them, so the last step of a tile
// holds them for its epilogue).
template <int ROWS>
__host__ __device__ constexpr int code_bytes() {
  return ROWS == kPqRows ? kSqR * kPqWin : kSqR * kSqK;
}
template <int ROWS>
__host__ __device__ constexpr int row_floats() {
  return ROWS == kRqRows ? 3 : 1;
}
template <int ROWS>
__host__ __device__ constexpr int scan_stage() {
  return code_bytes<ROWS>() + kSqR * 4 * row_floats<ROWS>() + kSqR;
}
// Dynamic shared memory of a code scan: the query and code rings, the bf16
// code tile (two: one step is widened or decoded while the other feeds the
// products), the key tile.
template <int ROWS>
__host__ __device__ constexpr size_t scan_smem() {
  return (size_t)kSqStages * kQT * kSqLd * 2 +
         (size_t)kSqStages * scan_stage<ROWS>() +
         (size_t)2 * kSqR * kSqLd * 2 + (size_t)kQT * kSqTk * 4;
}

// A piece of p bf16 values (2p bytes) from global to shared memory through
// cp.async (p = 2, 4, 8), zero-filled when !ok; p = 1 is a plain load and
// store. p is the same in every thread of a launch.
__device__ __forceinline__ void copy_piece(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, bool ok,
                                           int p) {
  const uint32_t d = smem_addr(dst);
  switch (p) {
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(src), "r"(ok ? 16 : 0));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                   "l"(src), "r"(ok ? 8 : 0));
      break;
    case 2:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                   "l"(src), "r"(ok ? 4 : 0));
      break;
    default:
      *dst = ok ? src[0] : __float2bfloat16_rn(0.0f);
  }
}

// The operands of a code scan beside its queries and lists.
struct CodeRows {
  const uint8_t* codes;      // [n, w] (Q3: w = m segments)
  const float* dsq;          // [n] decoded squared norms
  const float* lower;        // Q4: [n] per-row offsets
  const float* step;         // Q4: [n] per-row steps
  const __nv_bfloat16* cb;   // Q3: [m, centroids, dsub] bf16 codebooks
  float a, s;                // Q2: the offset and step
  int m, dsub, centroids;    // Q3
  int piece;                 // Q3: values a gather copies, a divisor of dsub
};

// Q2, Q3 and Q4: the queries rounded to bf16 [b, dp] (zero past d) times
// the rows' decoded codes on the tensor cores, a tile's keys from the
// metric of q . decode(x), and the exact top-k of each split. ROWS picks the
// loader and the decode: Q2 widens the byte codes to bf16 and decodes
// a + s * (q . c); Q4 the same with the row's own lower and step; Q3
// gathers each code's centroid piece (x.piece values a copy) from the bf16
// codebooks, which stay in L2, into the product's tile. VEC: the codes
// load 16 bytes a copy (Q2, Q4), or Q3's pieces are 8 values (16 bytes),
// a constant.
template <int ROWS, bool VEC>
__global__ void __launch_bounds__(kThreads, kSqCtasPerSm)
code_scan_kernel(const __nv_bfloat16* __restrict__ q, CodeRows x,
                 const uint8_t* __restrict__ mask,
                 const float* __restrict__ qsum, const float* __restrict__ qsq,
                 int metric, uint32_t* lk, int* lr, int b, int n, int d,
                 int dp, int k, int split_rows, int cap) {
  constexpr int kStage = scan_stage<ROWS>();
  constexpr int kCodes = code_bytes<ROWS>();
  constexpr int kFloats = row_floats<ROWS>();
  extern __shared__ __align__(16) unsigned char sq_dyn[];
  __shared__ float sqsum[kQT], sqsq[kQT];
  __shared__ int hist[kWarps][kBins];
  __nv_bfloat16* aring = reinterpret_cast<__nv_bfloat16*>(sq_dyn);
  uint8_t* braw = sq_dyn + (size_t)kSqStages * kQT * kSqLd * 2;
  __nv_bfloat16* bw =  // [2][kSqR][kSqLd]
      reinterpret_cast<__nv_bfloat16*>(braw + kSqStages * kStage);
  uint32_t* tk = reinterpret_cast<uint32_t*>(bw + 2 * kSqR * kSqLd);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int q0 = blockIdx.x * kQT, split = blockIdx.y;
  const int row_begin = split * split_rows;
  const int row_end = min(n, row_begin + split_rows);
  const int tiles = (row_end - row_begin + kSqR - 1) / kSqR;
  const int chunks = dp / kSqK;
  const int steps = tiles * chunks;
  const uint8_t* __restrict__ codes = x.codes;

  for (int i = tid; i < kQT; i += kThreads) {
    const bool ok = q0 + i < b;
    sqsum[i] = ok ? qsum[q0 + i] : 0.0f;
    sqsq[i] = ok ? qsq[q0 + i] : 0.0f;
  }
  Lists st = init_lists<OrderKeys>(q0, b);

  auto load_step = [&](int step) {
    const int t = step / chunks, k0 = (step % chunks) * kSqK;
    const int stage = step % kSqStages;
    __nv_bfloat16* ad = aring + stage * kQT * kSqLd;
    // queries: 128 rows x 128 bytes, zero past b (the padded width dp
    // holds zeros past d)
    for (int c = tid; c < kQT * 8; c += kThreads) {
      const int r = c >> 3, j = (c & 7) * 8;
      const bool ok = q0 + r < b;
      cp_async16(ad + r * kSqLd + j,
                 ok ? q + (size_t)(q0 + r) * dp + k0 + j : q, ok);
    }
    uint8_t* bd = braw + stage * kStage;
    const int r0 = row_begin + t * kSqR;
    if (tid < kSqR) {  // the tile's decoded norms, 4 bytes a row
      const bool ok = r0 + tid < row_end;
      cp_async4(bd + kCodes + tid * 4, ok ? x.dsq + r0 + tid : x.dsq, ok);
    } else if (mask != nullptr && tid < kSqR + kSqR / 4) {
      const int c = tid - kSqR;
      load_mask4(bd + kCodes + kFloats * kSqR * 4 + 4 * c, mask, r0 + 4 * c,
                 n);
    }
    if constexpr (ROWS == kRqRows) {  // the rows' lower and step
      for (int c = tid; c < 2 * kSqR; c += kThreads) {
        const int r = c % kSqR;
        const float* src = c < kSqR ? x.lower : x.step;
        const bool ok = r0 + r < row_end;
        cp_async4(bd + kCodes + (kSqR + c) * 4, ok ? src + r0 + r : src, ok);
      }
    }
    if constexpr (ROWS == kPqRows) {
      // each row's code window: the words from the one holding segment
      // k0 / dsub, bytes past the codes zero-filled
      const long long total = (long long)n * x.m;
      const int seg_lo = k0 / x.dsub;
      for (int c = tid; c < kSqR * kPqWords; c += kThreads) {
        const int r = c / kPqWords, wd = c % kPqWords;
        const long long at =
            (((long long)(r0 + r) * x.m + seg_lo) & ~3LL) + 4 * wd;
        long long nb = r0 + r < row_end ? total - at : 0;
        nb = nb < 0 ? 0 : (nb > 4 ? 4 : nb);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                         smem_addr(bd + r * kPqWin + 4 * wd)),
                     "l"(nb ? codes + at : codes), "r"((int)nb));
      }
    } else if (VEC) {  // 16-byte pieces, zero past the row or d
      for (int c = tid; c < kSqR * 4; c += kThreads) {
        const int r = c >> 2, j = (c & 3) * 16;
        const bool ok = r0 + r < row_end && k0 + j < d;
        cp_async16(bd + r * kSqK + j,
                   ok ? codes + (size_t)(r0 + r) * d + k0 + j : codes, ok);
      }
    } else {
      for (int c = tid; c < kSqR * kSqK; c += kThreads) {
        const int r = c / kSqK, j = c % kSqK;
        bd[c] = r0 + r < row_end && k0 + j < d
                    ? codes[(size_t)(r0 + r) * d + k0 + j]
                    : 0;
      }
    }
  };
  // a step's codes widened to bf16 into buffer step % 2: 32 bytes a thread
  // (Q2, Q4)
  auto widen_step = [&](int step) {
    if constexpr (ROWS != kPqRows) {
      const int r = tid >> 1, j = (tid & 1) * 32;
      const uint4* src = reinterpret_cast<const uint4*>(
          braw + (step % kSqStages) * kStage + r * kSqK + j);
      uint4* dst = reinterpret_cast<uint4*>(bw + (step & 1) * kSqR * kSqLd +
                                            r * kSqLd + j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 u = src[h];
        dst[2 * h] = make_uint4(widen2(u.x, 0), widen2(u.x, 2),
                                widen2(u.y, 0), widen2(u.y, 2));
        dst[2 * h + 1] = make_uint4(widen2(u.z, 0), widen2(u.z, 2),
                                    widen2(u.w, 0), widen2(u.w, 2));
      }
    }
  };
  // Q3: a step's rows decoded into buffer step % 2, piece by piece: the
  // centroid of the row's code of the piece's segment (past d: zeros)
  auto decode_step = [&](int step) {
    if constexpr (ROWS == kPqRows) {
      const int t = step / chunks, k0 = (step % chunks) * kSqK;
      const uint8_t* win = braw + (step % kSqStages) * kStage;
      __nv_bfloat16* dst = bw + (step & 1) * kSqR * kSqLd;
      const int r0 = row_begin + t * kSqR;
      const int seg_lo = k0 / x.dsub;
      const int piece = VEC ? 8 : x.piece;
      const int per = kSqK / piece;  // pieces a row
      for (int c = tid; c < kSqR * per; c += kThreads) {
        const int r = c / per, j = (c % per) * piece;
        const int dim = k0 + j;
        const int off = (int)(((long long)(r0 + r) * x.m + seg_lo) & 3);
        const bool ok = dim < d;
        const __nv_bfloat16* src = x.cb;
        if (ok) {
          const int seg = dim / x.dsub;
          const int code = win[r * kPqWin + off + seg - seg_lo];
          src += ((size_t)seg * x.centroids + code) * x.dsub +
                 (dim - seg * x.dsub);
        }
        copy_piece(dst + r * kSqLd + j, src, ok, piece);
      }
    }
  };

  // steps 0 .. kSqStages - 2 in flight; step 0 widened (decoded) before the
  // loop
#pragma unroll
  for (int step = 0; step < kSqStages - 1; ++step) {
    if (step < steps) load_step(step);
    cp_commit();
  }
  cp_wait_ring<kSqStages>();
  __syncthreads();
  if constexpr (ROWS == kPqRows) {
    decode_step(0);
    cp_commit();
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {
    widen_step(0);
  }
  float acc[4][4][4];
  for (int step = 0; step < steps; ++step) {
    const int t = step / chunks, kc = step % chunks;
    // step + 1 has landed; every warp has widened `step` and finished the
    // products of step - 1, whose stage and bf16 buffer are free (Q3: the
    // pieces of `step` have landed)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kSqStages - 3));
    __syncthreads();
    if constexpr (ROWS == kPqRows) {
      // its own group, ahead of the ring's: the next barrier's wait
      // leaves only the ring's newest group in flight
      if (step + 1 < steps) decode_step(step + 1);
      cp_commit();
    }
    if (step + kSqStages - 1 < steps) load_step(step + kSqStages - 1);
    cp_commit();
    if (step + 1 < steps) widen_step(step + 1);
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
    const __nv_bfloat16* as = aring + (step % kSqStages) * kQT * kSqLd;
    const __nv_bfloat16* bs = bw + (step & 1) * kSqR * kSqLd;
#pragma unroll
    for (int ks = 0; ks < kSqK; ks += 16) {
      uint32_t fa[4][4], fb[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(fa[mt], as + (wm * 64 + mt * 16 + (lane & 15)) * kSqLd +
                                ks + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r4[4];
        ldmatrix_x4(r4, bs + (wn * 32 + np * 16 + (lane >> 4) * 8 +
                              (lane & 7)) * kSqLd +
                            ks + ((lane >> 3) & 1) * 8);
        fb[2 * np][0] = r4[0];
        fb[2 * np][1] = r4[1];
        fb[2 * np + 1][0] = r4[2];
        fb[2 * np + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], fa[mt], fb[nt][0], fb[nt][1]);
    }
    if (kc != chunks - 1) continue;
    // the tile's keys: this warp's 64 queries x 32 rows
    const int r0 = row_begin + t * kSqR;
    const uint8_t* held = braw + (step % kSqStages) * kStage + kCodes;
    const float* xdsq = reinterpret_cast<const float*>(held);
    const float* xlo = xdsq + kSqR;  // Q4
    const float* xst = xdsq + 2 * kSqR;
    const uint8_t* xmask = held + kFloats * kSqR * 4;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int rl = wn * 32 + nt * 8 + tig * 2;
      bool ok[2];
      float xs[2], rlo[2], rst[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ok[e] = r0 + rl + e < row_end &&
                (mask == nullptr || xmask[rl + e] != 0);
        xs[e] = xdsq[rl + e];
        rlo[e] = ROWS == kRqRows ? xlo[rl + e] : 0.0f;
        rst[e] = ROWS == kRqRows ? xst[rl + e] : 0.0f;
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ql = wm * 64 + mt * 16 + gid + 8 * h;
          uint32_t key[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // q . decode(x): Q3 the product itself; Q4 step_x * (q . c) +
            // sum(q) * lower_x; Q2 s * (q . c) + a * sum(q)
            float qdd = acc[mt][nt][2 * h + e];
            if (ROWS == kRqRows) {
              qdd = rst[e] * qdd + sqsum[ql] * rlo[e];
            } else if (ROWS == kSqRows) {
              qdd = x.s * qdd + x.a * sqsum[ql];
            }
            float dist;
            if (metric == 0) {
              dist = fmaxf(sqsq[ql] - 2.0f * qdd + xs[e], 0.0f);
            } else if (metric == 1) {
              dist = -qdd;
            } else {
              dist = 1.0f - qdd;
            }
            key[e] = ok[e] ? order_key(dist) : kNone;
          }
          *reinterpret_cast<uint2*>(tk + ql * kSqTk + rl) =
              make_uint2(key[0], key[1]);
        }
      }
    }
    __syncthreads();
    select_tile<kSqR, OrderKeys>(st, tk, kSqTk, lk, lr, q0, b, split, cap,
                                 k, r0, hist[warp]);
    // the next step's barrier orders these reads of tk before its writes
  }
  finish_split(st, lk, lr, q0, b, split, cap, k, hist[warp]);
}

// -- the merge ---------------------------------------------------------------

// Exclusive prefix sum of v over the CTA in thread order; `total` gets the
// CTA's sum.
__device__ __forceinline__ int block_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int c = wsum[i];
    before += i < warp ? c : 0;
    all += c;
  }
  __syncthreads();  // wsum is read before the next scan writes it
  total = all;
  return before + x - v;
}

// entries a thread collects at once in the merge
constexpr int kItems = 8;

// One CTA a query: the k smallest (key, row) of its splits x k partials
// (each split's in row order, splits in row order), sorted, as distances
// and ids (MASK_DISTANCE and -1 where nothing was taken). Entry e of a
// query is slot e % k of split e / k.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const uint32_t* __restrict__ lk, const int* __restrict__ lr,
             float* __restrict__ out_d, int* __restrict__ out_i, int splits,
             int b, int cap, int k, int p) {
  extern __shared__ unsigned long long sorted[];  // [p], (key << 32) | row
  __shared__ int hist[kBins];
  __shared__ int wsum[kWarps];
  __shared__ int pick[2];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int qg = blockIdx.x;
  const int total = splits * k;
  auto at = [&](int e) {
    const int sp = e / k;
    return ((size_t)sp * b + qg) * cap + (e - sp * k);
  };
  uint32_t prefix = 0;
  int need = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    const uint32_t high = shift == 24 ? 0u : (kFull << (shift + 8));
    for (int base = 0; base < total; base += kThreads * kBatch) {
      uint32_t v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = base + j * kThreads + tid;
        v[j] = e < total ? lk[at(e)] : 0u;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        count_digit(v[j], base + j * kThreads + tid < total, prefix, high,
                    shift, hist);
    }
    __syncthreads();
    if (warp == 0) {
      int nd = need;
      const int digit = pick_digit(hist, nd);
      if (tid == 0) {
        pick[0] = digit;
        pick[1] = nd;
      }
    }
    __syncthreads();
    prefix |= static_cast<uint32_t>(pick[0]) << shift;
    need = pick[1];
    __syncthreads();  // pick is read before the next pass writes it
  }
  // keys below the k-th, and the first `need` equal to it, in row order
  int w = 0, eq_seen = 0;
  for (int base = 0; base < total; base += kThreads * kItems) {
    const int e0 = base + tid * kItems;
    uint32_t key[kItems];
    int row[kItems], eq = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = e0 + j < total;
      key[j] = in ? lk[at(e0 + j)] : kNone;
      row[j] = in ? lr[at(e0 + j)] : -1;
      eq += in && key[j] == prefix;
    }
    int eq_total;
    int eq_rank = eq_seen + block_scan(eq, wsum, eq_total);
    bool keep[kItems];
    int kept = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = e0 + j < total;
      keep[j] = in && key[j] < prefix;
      if (in && key[j] == prefix) keep[j] = eq_rank++ < need;
      kept += keep[j];
    }
    int kept_total;
    int pos = w + block_scan(kept, wsum, kept_total);
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (keep[j])
        sorted[pos++] = (static_cast<unsigned long long>(key[j]) << 32) |
                        static_cast<uint32_t>(row[j]);
    w += kept_total;
    eq_seen += eq_total;
  }
  for (int i = k + tid; i < p; i += kThreads) sorted[i] = ~0ull;
  __syncthreads();
  // bitonic sort by (key, row)
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < p / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long x = sorted[lo], y = sorted[hi];
        if ((x > y) == ((lo & size) == 0)) {
          sorted[lo] = y;
          sorted[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < k; i += kThreads) {
    const unsigned long long v = sorted[i];
    const uint32_t key = static_cast<uint32_t>(v >> 32);
    const float dist = key == kNone ? kMask : key_to_float(key);
    out_d[(size_t)qg * k + i] = dist;
    out_i[(size_t)qg * k + i] =
        dist >= kMask ? -1 : static_cast<int>(static_cast<uint32_t>(v));
  }
}

int check_plan(int b, int n, int k, int splits, int split_rows, int cap,
               int rows_tile) {
  if (b < 1 || n < 1) return kBadShape;
  if (k < 1 || k > kMaxK) return kBadK;
  if (splits < 1 || splits > 65535 || split_rows < rows_tile ||
      split_rows % rows_tile != 0 || (long long)splits * split_rows < n ||
      (long long)(splits - 1) * split_rows >= n || cap < k + rows_tile)
    return kBadPlan;
  return 0;
}

// lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB)
template <typename F>
int allow_smem(F kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// The launch of a code scan on arguments already checked.
template <int ROWS, bool VEC>
int launch_code_scan(const __nv_bfloat16* q, const CodeRows& x,
                     const uint8_t* mask, const float* qsum, const float* qsq,
                     int metric, uint32_t* lk, int* lr, int b, int n, int d,
                     int dp, int k, int splits, int split_rows, int cap,
                     void* stream) {
  constexpr size_t smem = scan_smem<ROWS>();
  auto kernel = code_scan_kernel<ROWS, VEC>;
  const int e = allow_smem(kernel, smem);
  if (e) return e;
  const dim3 grid((b + kQT - 1) / kQT, splits);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, x, mask, qsum, qsq, metric, lk, lr, b, n, d, dp, k, split_rows, cap);
  return static_cast<int>(cudaGetLastError());
}

int check_code_scan(int b, int n, int d, int dp, int metric, int k,
                    int splits, int split_rows, int cap) {
  if (d < 1 || d > kMaxD || dp % kSqK != 0 || dp < d || dp - d >= kSqK)
    return kBadDims;
  if (metric < 0 || metric > 2) return kBadMetric;
  return check_plan(b, n, k, splits, split_rows, cap, kSqR);
}

}  // namespace

extern "C" {

// Q1: each query's k smallest (order key, row) of each split of the packed
// rows [n, w] (int32 words, bits past `dims` ignored) against the packed
// queries [b, w], with the rows' popcounts [n] and mask [n] (null = every
// row live), into lists lk/lr [splits, b, cap] (the first k of each list:
// the split's partial, in row order, padded with key 0xffffffff / row -1).
int bq_scan(const uint32_t* q, const uint32_t* x, const float* pop,
            const uint8_t* mask, uint32_t* lk, int* lr, int b, int n, int w,
            int dims, int k, int splits, int split_rows, int cap,
            void* stream) {
  if (w < 1) return kBadShape;
  if (dims < 1 || dims > kMaxD || w != (dims + 31) / 32) return kBadDims;
  const int bad = check_plan(b, n, k, splits, split_rows, cap, kBqR);
  if (bad) return bad;
  const uint32_t last = dims % 32 ? (1u << (dims % 32)) - 1u : kFull;
  const size_t smem = bq_smem(((w + 7) & ~7) + 4);
  const dim3 grid((b + kQT - 1) / kQT, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel) {
    const int e = allow_smem(kernel, smem);
    if (e) return e;
    kernel<<<grid, kThreads, smem, st>>>(q, x, pop, mask, lk, lr, b, n, w,
                                         last, k, split_rows, cap);
    return static_cast<int>(cudaGetLastError());
  };
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return vec ? go(bq_scan_kernel<true>) : go(bq_scan_kernel<false>);
}

// Q2: as bq_scan for the SQ distances of the bf16 queries [b, dp] (zero
// past d; dp a multiple of 64) to the codes [n, d] (metric 0 l2-squared, 1
// dot, 2 cosine), with the queries' float32 sums and sums of squares [b]
// and the rows' decoded squared norms [n].
int sq_scan(const __nv_bfloat16* q, const uint8_t* codes, const float* dsq,
            const uint8_t* mask, const float* qsum, const float* qsq, float a,
            float s, int metric, uint32_t* lk, int* lr, int b, int n, int d,
            int dp, int k, int splits, int split_rows, int cap,
            void* stream) {
  const int bad = check_code_scan(b, n, d, dp, metric, k, splits, split_rows,
                                  cap);
  if (bad) return bad;
  CodeRows x = {};
  x.codes = codes;
  x.dsq = dsq;
  x.a = a;
  x.s = s;
  const bool vec = d % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  return vec ? launch_code_scan<kSqRows, true>(
                   q, x, mask, qsum, qsq, metric, lk, lr, b, n, d, dp, k,
                   splits, split_rows, cap, stream)
             : launch_code_scan<kSqRows, false>(
                   q, x, mask, qsum, qsq, metric, lk, lr, b, n, d, dp, k,
                   splits, split_rows, cap, stream);
}

// Q4: as sq_scan for the RQ distances to the rotated codes [n, d] (d a
// multiple of 64, the codes 16-byte aligned), each row decoded with its own
// lower [n] and step [n].
int rq_scan(const __nv_bfloat16* q, const uint8_t* codes, const float* dsq,
            const float* lower, const float* step, const uint8_t* mask,
            const float* qsum, const float* qsq, int metric, uint32_t* lk,
            int* lr, int b, int n, int d, int dp, int k, int splits,
            int split_rows, int cap, void* stream) {
  const int bad = check_code_scan(b, n, d, dp, metric, k, splits, split_rows,
                                  cap);
  if (bad) return bad;
  CodeRows x = {};
  x.codes = codes;
  x.dsq = dsq;
  x.lower = lower;
  x.step = step;
  // rotated rows are whole ring steps: 16-byte loads only
  if (d % kSqK != 0) return kBadDims;
  if (reinterpret_cast<uintptr_t>(codes) % 16) return kBadAlign;
  return launch_code_scan<kRqRows, true>(q, x, mask, qsum, qsq, metric, lk,
                                         lr, b, n, d, dp, k, splits,
                                         split_rows, cap, stream);
}

// Q3: as sq_scan for the PQ distances to the rows whose codes [n, m] index
// the bf16 codebooks cb [m, centroids, dsub] (d = m * dsub), with the
// queries' float32 sums of squares [b] (qsum is not read).
int pq_scan(const __nv_bfloat16* q, const uint8_t* codes,
            const __nv_bfloat16* cb, const float* dsq, const uint8_t* mask,
            const float* qsq, int metric, uint32_t* lk, int* lr, int b, int n,
            int d, int dp, int m, int dsub, int centroids, int k, int splits,
            int split_rows, int cap, void* stream) {
  const int bad = check_code_scan(b, n, d, dp, metric, k, splits, split_rows,
                                  cap);
  if (bad) return bad;
  if (m < 1 || dsub < 1 || (long long)m * dsub != d || centroids < 1 ||
      centroids > 256)
    return kBadCodebook;
  if (reinterpret_cast<uintptr_t>(cb) % 16 ||
      reinterpret_cast<uintptr_t>(codes) % 4)
    return kBadAlign;
  CodeRows x = {};
  x.codes = codes;
  x.dsq = dsq;
  x.cb = cb;
  x.m = m;
  x.dsub = dsub;
  x.centroids = centroids;
  // the widest piece of a centroid one copy takes: a divisor of dsub
  x.piece = dsub % 8 == 0 ? 8 : (dsub % 4 == 0 ? 4 : (dsub % 2 == 0 ? 2 : 1));
  return x.piece == 8
             ? launch_code_scan<kPqRows, true>(q, x, mask, qsq, qsq, metric,
                                               lk, lr, b, n, d, dp, k, splits,
                                               split_rows, cap, stream)
             : launch_code_scan<kPqRows, false>(q, x, mask, qsq, qsq, metric,
                                                lk, lr, b, n, d, dp, k,
                                                splits, split_rows, cap,
                                                stream);
}

// The merge: out_d / out_i [b, k], each query's k smallest (key, row) over
// the first k entries of its lists lk/lr [splits, b, cap], ascending by
// (distance, row), as distances and ids.
int topk_merge(const uint32_t* lk, const int* lr, float* out_d, int* out_i,
               int splits, int b, int cap, int k, void* stream) {
  if (b < 1 || splits < 1 || cap < k) return kBadShape;
  if (k < 1 || k > kMaxK) return kBadK;
  int p = 1;
  while (p < k) p <<= 1;
  merge_kernel<<<b, kThreads, (size_t)p * 8,
                 static_cast<cudaStream_t>(stream)>>>(lk, lr, out_d, out_i,
                                                      splits, b, cap, k, p);
  return static_cast<int>(cudaGetLastError());
}

const char* quantized_error_string(int code) {
  switch (code) {
    case kBadShape: return "b, n, w and splits must be >= 1 and cap >= k";
    case kBadDims:
      return "dims outside [1, 4096], words != ceil(dims/32), or the padded "
             "query width not the next multiple of 64";
    case kBadK: return "k outside [1, 4096]";
    case kBadMetric: return "metric code outside 0..2";
    case kBadCodebook:
      return "PQ segments x sub-dimensions != d, or centroids outside "
             "[1, 256]";
    case kBadAlign:
      return "PQ codebooks not 16-byte aligned or codes not 4-byte "
             "aligned, or RQ codes not 16-byte aligned";
    case kBadPlan:
      return "split plan does not cover the rows in whole tiles, or the "
             "lists cannot hold k plus a tile";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
