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
//     s * (bf16(q) . c) + a * sum(q). bf16 products with float32 sums
//     (`wgmma`): the queries come rounded to bf16 (round to nearest even,
//     as `_bf16_ip` casts them), the codes arrive as bytes and are widened
//     to bf16 in shared memory (exact: codes <= 255), and the epilogue
//     applies the affine decode with sum(q) and sum(q^2) taken in float32
//     from the unrounded queries; l2-squared is clamped at 0, dot negated,
//     cosine 1 - x.
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
// nothing of size [B, N] reaches device memory: a CTA owns a tile of
// queries and a split (a contiguous range of rows, walked in increasing
// order in tiles) and keeps each query's exact top-k of the split in its
// epilogue. Each query has a threshold and a candidate list in device
// memory, [splits, B, cap]: a row enters only if its key (an order key:
// the float bits sign-flipped, so unsigned order is float order) is below
// the threshold, so a later row that ties it loses the tie, and the list
// stays in row order; a row masked or past the split gets a key that is
// never taken. A full list is compacted to its k smallest by (key, row),
// and the k-th key becomes the threshold. At the end of its split a list
// is compacted to k and padded. The merge, one CTA a query, takes the
// [splits, k] partials to k, reading only their taken entries (the
// merge's own section below).
// A search is one scan launch and one merge launch, for any B.
//
// Q1 (`bq_scan_kernel`): 128 queries a CTA, tiles of 64 rows through a
// cp.async ring; a tile's 16-bit distances land in shared memory, and each
// warp selects its queries' takers, compacting a list with four 8-bit
// radix passes (`warp_compact`). Q2, Q3 and Q4 are one warp-specialized
// template for Hopper (`wg_scan_kernel`, its own section below).
//
// Q1's product route: the 1-bit product measured faster than an int8 one
// (`mma.m16n8k32 .u8`) on the bits widened to {0,1} bytes in registers,
// 10.76 ms a scan against 19.43 ms on phase `quant`'s rows and 10.94
// against 19.70 on random codes at the same shapes (NVIDIA H100 80GB HBM3
// at 700 W; probe_quantized.py keeps the int8 product as its `int8`
// copy): widening bits to bytes costs more integer work than the int8
// rate wins, so only the 1-bit product is kept. Q1 is not held by its
// product: with the selection switched off it takes 2.6 ms of 10.9, so the
// epilogue selection is most of its time (PERF.md section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


namespace {

constexpr float kMask = 1e30f;  // MASK_DISTANCE of ops/distance.py
constexpr int kMaxD = 4096;
constexpr int kMaxK = 4096;
constexpr uint32_t kNone = 0xffffffffu;  // never below a threshold
constexpr unsigned kFull = 0xffffffffu;

// Q1: threads a CTA (8 warps, 2 over the queries x 4 over the rows),
// queries a CTA; radix digit bins (Q1 and the merge)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 128;
constexpr int kBins = 256;
// Q1: rows a tile (a ring stage), ring stages, CTAs an SM holds
constexpr int kBqR = 64;
constexpr int kBqStages = 3;
constexpr int kBqCtasPerSm = 2;
// Q2-Q4: dimensions a step of the products
constexpr int kSqK = 64;

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

// Q1's tile keys: the hamming distances themselves, 16 bits (at most
// kMaxD; 0xffff for a row never taken). The list key of one is the order
// key of the distance as a float, and a list's threshold (an order key) is
// a distance again as a tile's threshold.
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

// -- Q2, Q3 and Q4: the code rows -------------------------------------------

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

// The code scans' row types: Q2's global-affine SQ codes, Q4's per-row
// affine RQ codes, Q3's PQ codes decoded through the codebooks.
enum Rows { kSqRows = 0, kRqRows = 1, kPqRows = 2 };
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
  int piece;  // Q3: values a gather copies, a divisor of dsub; Q2, Q4: the
              // bytes a code copy moves (16, or 1 for codes off 16 bytes)
};

// -- Q2, Q3 and Q4 on Hopper: the warp-specialized scan ----------------------
//
// `wg_scan_kernel` replaced the earlier `code_scan_kernel` (commit
// 202d8c9). What the probe of that template found (probe_quantized.py, PERF.md section 6): Q3 spent
// its time on the loads (a 17-word code window a row a step and centroid
// gathers issued one step ahead of the products: 9.48 ms, 5.73 with them
// off) and on its tile ends (5.54 ms with the keys and the selection off),
// Q4 on its tile ends (2.85 ms, 0.74 with them off: the keys, a CTA-wide
// barrier and the selection's compactions held every warp's products).
//
// The design. A CTA holds 256 queries (the products' N) and a split of the
// rows, walked in tiles of 128 rows in steps of 64 dimensions, so each row
// is decoded once a search at B <= 256. Twelve warps:
//   * warp 0, the producer: one bulk copy (TMA) a step of the step's 32 KB
//     query block into a ring of two (the wrapper lays the queries out so
//     that a step's block is contiguous and each 8 x 16-byte piece is a
//     core matrix of `wgmma`'s operand), and for Q3 one bulk copy a row of
//     the codes a span of steps needs (a tile's 96 codes at config 3);
//   * warps 1-3, the helpers: at each tile's end they publish the split's
//     least pairs taken, compact the lists the tile filled while the
//     consumers multiply the next tile, and now and then read the bound
//     the splits share;
//   * warps 4-11, two consumer warpgroups of 64 rows each: `wgmma`
//     m64n256k16 (A the decoded rows, B the queries, both from shared
//     memory; 128 float32 sums a thread), with each thread staging its own
//     row's operand kWgAhead steps ahead: Q3 gathers the rows' centroid
//     pieces from the bf16 codebooks (L2) with cp.async straight into the A
//     ring, Q2 and Q4 copy the code bytes and widen them to bf16 a step
//     ahead, while the tensor cores run the current step.
// At a tile's end the consumers turn their sums into keys; a ballot a
// (query pair, row half) marks each warp's takers, and the takers are
// appended in row order to their query's list in device memory, [splits,
// B, cap]. A taker is below the list's threshold and, as a (key, row)
// pair, below the bound the splits share: each warpgroup of each split
// (a sub-stream of rows) publishes the least pair it has taken, and a
// query's bound is the largest of those, valid once 2 x splits >= k (so
// many distinct pairs lie at or below it). At config 3 and the tenant's
// shape it leaves few compactions or none. A list that could not take
// another tile is queued, and the helpers (and the consumers, if the queue
// is not empty when they reach the next tile's end) compact it to its k
// smallest by (key, row), the k-th key found by bisecting the key range
// with warp-wide counts. At the split's end every warp compacts and pads
// the lists. Registers (`setmaxnreg`): the producer and helpers 56 a
// thread, the consumers 224, which hands out the launch's 168 x 384
// exactly; no call may sit in the consumers' code (a call defeats their
// budget), so the compaction is inlined and holds few registers.

constexpr int kWgQT = 256;
constexpr int kWgR = 128;
constexpr int kWgThreads = 384;
constexpr int kWgCtasPerSm = 1;
// query ring stages; steps the consumers' loads run ahead of the products
constexpr int kWgQStages = 2;
constexpr int kWgAhead = 3;
// Q3: bytes of a row's staged code span (at most 114 segments, from 0-15
// bytes into its first 16-byte piece)
constexpr int kWgSpan = 144;
constexpr int kWgSpanSegs = 112;
// a query stage, a warpgroup's A stage, a warpgroup's code-byte stage (rows
// of 80 bytes: 16-byte pieces of 8 rows fall in distinct banks)
constexpr int kWgQBytes = kWgQT * kSqK * 2;
constexpr int kWgABytes = 64 * kSqK * 2;
constexpr int kWgRawPitch = kSqK + 16;
constexpr int kWgRawBytes = 64 * kWgRawPitch;

template <int ROWS>
__host__ __device__ constexpr int wg_astages() {
  return ROWS == kPqRows ? kWgAhead + 1 : 2;
}
template <int ROWS>
__host__ __device__ constexpr int wg_rawstages() {
  return ROWS == kPqRows ? 0 : kWgAhead + 1;
}
// Dynamic shared memory of the scan: the query ring, each warpgroup's A
// ring, and its code-byte ring (Q2, Q4) or two code spans (Q3).
template <int ROWS>
__host__ __device__ constexpr size_t wg_smem() {
  return (size_t)kWgQStages * kWgQBytes +
         (size_t)2 * wg_astages<ROWS>() * kWgABytes +
         (size_t)2 * wg_rawstages<ROWS>() * kWgRawBytes +
         (ROWS == kPqRows ? (size_t)2 * kWgR * kWgSpan : 0);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}
// Waits until the barrier's phase of the given parity has completed; a wait
// that never ends (a broken protocol) traps after about 4 s rather than
// hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) break;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// `bytes` (a multiple of 16) from global to shared memory by the TMA,
// completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}
// this thread's shared-memory writes before the async proxy (wgmma) reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// A no-swizzle K-major operand: 8 x 16-byte core matrices, `lbo` bytes
// apart along K and `sbo` bytes apart along M (N)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D (64 rows x 256 queries, 128 floats a thread) += A (64 x 16, bf16) x
// B (256 x 16, bf16), both read from shared memory by descriptor; `acc`
// 0 ignores D (the first product of a tile). Asynchronous: the caller
// fences, commits and waits.
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins the sums: the compiler moves none of them across this point, so
// none is read or copied while a product is in flight
__device__ __forceinline__ void pin_sums(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Compacts a query's list (n > k entries in row order) in place to its k
// smallest by (key, row), still in row order; returns the k-th key, the new
// threshold. The k-th key is the least t with at least k keys <= t, found
// by bisecting [min, max] with warp-wide counts; each count reads the list
// again (from L1: a list is a few KB), so the warp holds a handful of
// registers whatever n is, and the consumers can run it beside their sums.
__device__ __forceinline__ uint32_t wg_compact(uint32_t* lk, int* lr, int n,
                                               int k) {
  const int lane = threadIdx.x & 31;
  const unsigned before = (1u << lane) - 1u;
  uint32_t lo = kNone, hi = 0u;
#pragma unroll 8
  for (int i = lane; i < n; i += 32) {
    const uint32_t key = lk[i];
    lo = min(lo, key);
    hi = max(hi, key);
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  while (lo < hi) {
    const uint32_t mid = lo + ((hi - lo) >> 1);
    unsigned c = 0;
#pragma unroll 4
    for (int i = lane; i < n; i += 32) c += lk[i] <= mid;
    if ((int)__reduce_add_sync(kFull, c) >= k) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  const uint32_t t = lo;
  unsigned below = 0;
#pragma unroll 8
  for (int i = lane; i < n; i += 32) below += lk[i] < t;
  const int need = k - (int)__reduce_add_sync(kFull, below);
  // stable: an entry moves to its own place or before it, so four batches
  // of 32 are read before any of them is written
  constexpr int kB = 4;
  int w = 0, eq_seen = 0;
  for (int base = 0; base < n; base += 32 * kB) {
    uint32_t key[kB];
    int row[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int i = base + 32 * j + lane;
      key[j] = i < n ? lk[i] : kNone;
      row[j] = i < n ? lr[i] : -1;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const bool in = base + 32 * j + lane < n;
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

// The scan's small shared state. The compaction queue's counters only
// grow: `tail` counts the queued lists, `claimed` those a warp took,
// `done` those compacted; `fin` hands out the split's last compactions.
struct WgState {
  uint64_t full[kWgQStages], empty[kWgQStages];  // the query ring
  uint64_t span_full[2], span_empty[2];          // Q3's code spans
  uint64_t ep_done, sel_done;  // a tile's lists written; its queue taken
  uint32_t thr[kWgQT];         // a key enters a query's list below this
  int cnt[kWgQT];              // entries in a query's list
  uint32_t bal[kWgQT / 4][8][2];  // a tile's takers: (query pair, warp, half)
  int place[kWgQT][8];            // where a warp's takers of a query go
  // the shared bound: each warpgroup's least (key, row) taken of each
  // query, and the bound the helpers last read, a (key, row) pair
  unsigned long long smin[2][kWgQT], bound[kWgQT];
  float qsum[kWgQT], qsq[kWgQT];
  int queue[kWgQT];
  int tail, claimed, done, fin;
};

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// A shared-memory word loaded where it is written: the compiler can neither
// hoist nor merge it, so a long unrolled loop holds few values at once.
__device__ __forceinline__ uint32_t lds_u32(const void* p) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(smem_addr(p)));
  return v;
}
__device__ __forceinline__ unsigned long long lds_u64(const void* p) {
  unsigned long long v;
  asm volatile("ld.shared.u64 %0, [%1];\n" : "=l"(v) : "r"(smem_addr(p)));
  return v;
}
// `v` recomputed where it is used, for the same reason
__device__ __forceinline__ int pinned(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// Warp-wide: claims the next queued list below `lim` (-1: none left).
__device__ __forceinline__ int wg_claim(WgState& s, int lim) {
  int got = -1;
  if ((threadIdx.x & 31) == 0) {
    int c = ld_volatile(&s.claimed);
    while (c < lim) {
      const int prev = atomicCAS(&s.claimed, c, c + 1);
      if (prev == c) {
        got = c;
        break;
      }
      c = prev;
    }
  }
  return __shfl_sync(kFull, got, 0);
}

// Warp-wide: compacts queued lists below `lim` until none is left to claim.
__device__ __forceinline__ void wg_drain(WgState& s, int lim, uint32_t* lk,
                                         int* lr, size_t base0, int cap,
                                         int k) {
  for (int i; (i = wg_claim(s, lim)) >= 0;) {
    const int ql = s.queue[i % kWgQT];
    const size_t base = base0 + (size_t)ql * cap;
    const uint32_t t = wg_compact(lk + base, lr + base, s.cnt[ql], k);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      s.thr[ql] = t;
      s.cnt[ql] = k;
      __threadfence_block();
      atomicAdd(&s.done, 1);
    }
  }
}

__device__ __forceinline__ void wg_wait_done(WgState& s, int lim) {
  for (uint32_t spins = 0; ld_volatile(&s.done) < lim; ++spins) {
    if (spins == (1u << 24)) __trap();
    __nanosleep(256);
  }
}

// Warp-wide, at the split's end: each list compacted to k and padded.
__device__ __forceinline__ void wg_finish(WgState& s, uint32_t* lk, int* lr,
                                          size_t base0, int q0, int b,
                                          int cap, int k) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    int ql = 0;
    if (lane == 0) ql = atomicAdd(&s.fin, 1);
    ql = __shfl_sync(kFull, ql, 0);
    if (ql >= kWgQT || q0 + ql >= b) break;
    const size_t base = base0 + (size_t)ql * cap;
    int n = s.cnt[ql];
    if (n > k) {
      wg_compact(lk + base, lr + base, n, k);
      n = k;
    }
    for (int j = n + lane; j < k; j += 32) {
      lk[base + j] = kNone;
      lr[base + j] = -1;
    }
  }
}

// Q2, Q3 and Q4 (`ROWS`): each split's k smallest (order key, row) of
// each query into the lists lk/lr [splits, b, cap] (the first k entries,
// in row order, padded with kNone / -1), for the queries laid out by the
// wrapper, [ceil(b / 256)][dp / 8][256][8] bf16 (zero past b and d). VEC
// (Q3): the pieces are 8 values, a constant (else x.piece).
template <int ROWS, bool VEC>
__global__ void __launch_bounds__(kWgThreads, kWgCtasPerSm)
wg_scan_kernel(const __nv_bfloat16* __restrict__ q, CodeRows x,
               const uint8_t* __restrict__ mask,
               const float* __restrict__ qsum, const float* __restrict__ qsq,
               int metric, uint32_t* lk, int* lr, unsigned long long* pub,
               int b, int n, int d, int dp, int k, int split_rows, int cap) {
  constexpr int kAS = wg_astages<ROWS>();
  constexpr int kRS = wg_rawstages<ROWS>();
  extern __shared__ __align__(128) unsigned char wg_dyn[];
  __shared__ WgState s;
  unsigned char* qring = wg_dyn;
  unsigned char* aring = qring + kWgQStages * kWgQBytes;
  unsigned char* raw = aring + 2 * kAS * kWgABytes;
  unsigned char* spans = raw + 2 * kRS * kWgRawBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kWgQT, split = blockIdx.y;
  const int row_begin = split * split_rows;
  const int row_end = min(n, row_begin + split_rows);
  const int tiles = (row_end - row_begin + kWgR - 1) / kWgR;
  const int chunks = dp / kSqK;
  const int steps = tiles * chunks;
  const size_t base0 = ((size_t)split * b + q0) * cap;
  // the shared bound's sub-streams (a warpgroup's rows of a split): it
  // bounds the k-th only if there are k of them
  const int nsub = 2 * gridDim.y;
  const bool shared_bound = nsub >= k;
  // Q3: steps a code span covers (at most kWgSpanSegs + 1 segments), spans
  // a tile
  const int span_steps =
      ROWS == kPqRows ? max(1, min(chunks, kWgSpanSegs * x.dsub / kSqK)) : 1;
  const int spt = (chunks + span_steps - 1) / span_steps;

  for (int i = tid; i < kWgQT; i += kWgThreads) {
    const bool ok = q0 + i < b;
    s.thr[i] = ok ? kNone : 0u;  // a query past the batch takes nothing
    s.cnt[i] = 0;
    s.qsum[i] = ok ? qsum[q0 + i] : 0.0f;
    s.qsq[i] = ok ? qsq[q0 + i] : 0.0f;
    s.smin[0][i] = s.smin[1][i] = s.bound[i] = ~0ull;
  }
  if (tid == 0) {
    for (int i = 0; i < kWgQStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], 8);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.span_full[i], 1);
      mbar_init(&s.span_empty[i], 8);
    }
    mbar_init(&s.ep_done, 8);
    mbar_init(&s.sel_done, 3);
    s.tail = s.claimed = s.done = s.fin = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (warp == 0) {
      // the producer. Q3: a span is staged before the query block of the
      // step kWgAhead ahead of its first step (the consumers gather that
      // far ahead)
      auto stage_span = [&](int i) {
        const int t = i / spt, sp = i % spt, buf = i & 1;
        if (i >= 2) mbar_wait(&s.span_empty[buf], ((i >> 1) - 1) & 1);
        const int dim_lo = sp * span_steps * kSqK;
        const int dim_hi = min(d, (sp + 1) * span_steps * kSqK) - 1;
        const int seg_lo = dim_lo / x.dsub, seg_hi = dim_hi / x.dsub;
        const int r0 = row_begin + t * kWgR;
        uintptr_t src[kWgR / 32];
        unsigned bytes[kWgR / 32], total = 0;
#pragma unroll
        for (int j = 0; j < kWgR / 32; ++j) {
          const int row = r0 + lane + 32 * j;
          bytes[j] = 0;
          src[j] = 0;
          if (row < row_end) {
            const uintptr_t a = reinterpret_cast<uintptr_t>(x.codes) +
                                (size_t)row * x.m;
            src[j] = (a + seg_lo) & ~uintptr_t(15);
            bytes[j] = static_cast<unsigned>(
                ((a + seg_hi + 1 + 15) & ~uintptr_t(15)) - src[j]);
          }
          total += bytes[j];
        }
        total = __reduce_add_sync(kFull, total);
        if (lane == 0) mbar_expect_tx(&s.span_full[buf], total);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kWgR / 32; ++j)
          if (bytes[j])
            bulk_load(spans + (buf * kWgR + lane + 32 * j) * kWgSpan,
                      reinterpret_cast<const void*>(src[j]), bytes[j],
                      &s.span_full[buf]);
      };
      int span_next = 0;
      const int spans_total = tiles * spt;
      for (int st = 0; st < steps; ++st) {
        if constexpr (ROWS == kPqRows) {
          while (span_next < spans_total &&
                 (span_next / spt) * chunks +
                         (span_next % spt) * span_steps <=
                     st + kWgAhead) {
            stage_span(span_next);
            ++span_next;
          }
        }
        const int stage = st % kWgQStages, use = st / kWgQStages;
        if (use > 0) mbar_wait(&s.empty[stage], (use - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(&s.full[stage], kWgQBytes);
          bulk_load(qring + stage * kWgQBytes,
                    q + ((size_t)blockIdx.x * (dp / 8) + 8 * (st % chunks)) *
                            kWgQT * 8,
                    kWgQBytes, &s.full[stage]);
        }
        __syncwarp();
      }
      return;
    }
    // the helpers: each tile's end, this split's least pairs published,
    // the queued lists compacted while the consumers multiply on, and
    // after tiles 1, 2, 4, 8, ... the shared bound read
    const int hl = (warp - 1) * 32 + lane;  // 0 .. 95
    for (int t = 0; t < tiles; ++t) {
      mbar_wait(&s.ep_done, t & 1);
      if (shared_bound) {
        for (int i = hl; i < 2 * kWgQT; i += 96) {
          const int ql = i >> 1;
          if (q0 + ql < b)
            pub[(size_t)(q0 + ql) * nsub + 2 * split + (i & 1)] =
                s.smin[i & 1][ql];
        }
      }
      wg_drain(s, ld_volatile(&s.tail), lk, lr, base0, cap, k);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.sel_done);
      if (shared_bound && (t & (t + 1)) == 0) {
        // the bound: the largest of the sub-streams' least pairs (one that
        // has taken nothing is all ones: no bound yet). At least nsub >= k
        // distinct pairs are <= it, so a pair above it is not among the k
        // smallest. A reading of values not yet published is looser, and
        // as valid.
        for (int ql = warp - 1; ql < kWgQT && q0 + ql < b; ql += 3) {
          unsigned long long m = 0ull;
          for (int sid = lane; sid < nsub; sid += 32)
            m = max(m, __ldcg(pub + (size_t)(q0 + ql) * nsub + sid));
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            m = max(m, __shfl_xor_sync(kFull, m, o));
          if (lane == 0)
            *reinterpret_cast<volatile unsigned long long*>(&s.bound[ql]) =
                m;
        }
      }
    }
    wg_wait_done(s, ld_volatile(&s.tail));
    wg_finish(s, lk, lr, base0, q0, b, cap, k);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  // the consumers: warpgroup c holds rows 64c .. 64c + 63 of each tile
  const int c = (warp - 4) >> 2, wt = tid - 128 * (1 + c), wi = wt >> 5;
  const int ct = tid - 128;  // 0 .. 255 over both warpgroups
  // the row of the warpgroup's 64 whose operand this thread stages, and
  // which half of a step's 64 dimensions
  const int prow = wt & 63, half = wt >> 6;
  unsigned char* my_a = aring + c * kAS * kWgABytes;
  unsigned char* my_raw = raw + c * kRS * kWgRawBytes;
  int span_off = 0;  // Q3: the staged span's offset of this thread's row

  // stages step st's operand rows: Q3 gathers them into A stage st % kAS,
  // Q2 and Q4 copy their code bytes into byte stage st % kRS
  auto prep = [&](int st) {
    const int t = st / chunks, kc = st % chunks, k0 = kc * kSqK;
    const int row = row_begin + t * kWgR + c * 64 + prow;
    const bool okr = row < row_end;
    if constexpr (ROWS == kPqRows) {
      const int sp = kc / span_steps, i = t * spt + sp, buf = i & 1;
      const int seg_lo = (sp * span_steps * kSqK) / x.dsub;
      if (kc % span_steps == 0) {
        mbar_wait(&s.span_full[buf], (i >> 1) & 1);
        span_off = okr ? static_cast<int>(
                             (reinterpret_cast<uintptr_t>(x.codes) +
                              (size_t)row * x.m + seg_lo) & 15)
                       : 0;
      }
      // the code of segment g sits at cs[g]
      const unsigned char* cs =
          spans + (buf * kWgR + c * 64 + prow) * kWgSpan + span_off - seg_lo;
      __nv_bfloat16* a =
          reinterpret_cast<__nv_bfloat16*>(my_a + (st % kAS) * kWgABytes) +
          (prow >> 3) * 512 + (prow & 7) * 8;
      const int piece = VEC ? 8 : x.piece;
      const int dim0 = k0 + 32 * half;
      int seg = dim0 / x.dsub, off = dim0 - seg * x.dsub;
#pragma unroll 4
      for (int j = 0; j < 32; j += piece) {
        const bool ok = okr && dim0 + j < d;
        const __nv_bfloat16* src = x.cb;
        if (ok)
          src += ((size_t)seg * x.centroids + cs[seg]) * x.dsub + off;
        const int kk = 32 * half + j;  // the dimension in the step
        copy_piece(a + (kk >> 3) * 64 + (kk & 7), src, ok, piece);
        off += piece;
        if (off == x.dsub) {
          off = 0;
          ++seg;
        }
      }
      if (kc % span_steps == span_steps - 1 || kc == chunks - 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&s.span_empty[buf]);
      }
    } else {
      unsigned char* dst =
          my_raw + (st % kRS) * kWgRawBytes + prow * kWgRawPitch + 32 * half;
      const int j0 = k0 + 32 * half;
      if (x.piece == 16) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool ok = okr && j0 + 16 * i < d;
          cp_async16(dst + 16 * i,
                     ok ? x.codes + (size_t)row * d + j0 + 16 * i : x.codes,
                     ok);
        }
      } else {
        for (int i = 0; i < 32; ++i)
          dst[i] = okr && j0 + i < d ? x.codes[(size_t)row * d + j0 + i] : 0;
      }
    }
  };
  // Q2, Q4: this thread's 32 code bytes of step st widened to bf16 into A
  // stage st % kAS (exact: codes <= 255)
  auto widen = [&](int st) {
    if constexpr (ROWS != kPqRows) {
      const uint4* src = reinterpret_cast<const uint4*>(
          my_raw + (st % kRS) * kWgRawBytes + prow * kWgRawPitch + 32 * half);
      __nv_bfloat16* a =
          reinterpret_cast<__nv_bfloat16*>(my_a + (st % kAS) * kWgABytes) +
          (prow >> 3) * 512 + (prow & 7) * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 u = src[h];
        const int kg = 4 * half + 2 * h;  // the 8-dimension group
        *reinterpret_cast<uint4*>(a + kg * 64) =
            make_uint4(widen2(u.x, 0), widen2(u.x, 2), widen2(u.y, 0),
                       widen2(u.y, 2));
        *reinterpret_cast<uint4*>(a + (kg + 1) * 64) =
            make_uint4(widen2(u.z, 0), widen2(u.z, 2), widen2(u.w, 0),
                       widen2(u.w, 2));
      }
    }
  };

  // the epilogue's rows: this thread's sums hold rows er and er + 8 of
  // the tile and queries 8j + 2 (lane & 3) + {0, 1}
  const int er = c * 64 + 16 * wi + (lane >> 2);
  float acc[128];
  float rdsq[2], rlo[2], rst[2];
  bool rok[2];

#pragma unroll
  for (int st = 0; st < kWgAhead; ++st) {
    if (st < steps) prep(st);
    cp_commit();
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kWgAhead - 1));
  widen(0);
  fence_async_smem();
  named_bar(1 + c, 128);
  for (int st = 0; st < steps; ++st) {
    const int t = st / chunks, kc = st % chunks;
    const int r0 = row_begin + t * kWgR;
    if (kc == 0) {  // the tile's per-row terms, used at its end
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + er + 8 * h;
        const bool okr = row < row_end;
        rdsq[h] = okr ? x.dsq[row] : 0.0f;
        rok[h] = okr && (mask == nullptr || mask[row] != 0);
        // Q2's global offset and step as every row's
        rlo[h] = ROWS == kRqRows ? (okr ? x.lower[row] : 0.0f) : x.a;
        rst[h] = ROWS == kRqRows ? (okr ? x.step[row] : 0.0f) : x.s;
      }
    }
    const int stage = st % kWgQStages;
    mbar_wait(&s.full[stage], (st / kWgQStages) & 1);
    const uint32_t abase = smem_addr(my_a + (st % kAS) * kWgABytes);
    const uint32_t bbase = smem_addr(qring + stage * kWgQBytes);
    pin_sums(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n256k16(acc, wg_desc(abase + ks * 256, 128, 1024),
                       wg_desc(bbase + ks * 8192, 4096, 128),
                       (kc > 0 || ks > 0) ? 1 : 0);
    wgmma_commit();
    if (st + kWgAhead < steps) prep(st + kWgAhead);
    cp_commit();
    if (st + 1 < steps) {
      // step st + 1's rows have landed (this thread's); Q2/Q4 widen them
      // into the A stage that step st - 1 read
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kWgAhead - 1));
      widen(st + 1);
      fence_async_smem();
    }
    wgmma_wait0();
    pin_sums(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.empty[stage]);
    named_bar(1 + c, 128);
    if (kc != chunks - 1) continue;

    // -- the tile's end --------------------------------------------------
    // the lists the last tile's end queued: claim what the helpers have
    // not, wait for the rest (inlined code only: a call here would defeat
    // the consumers' register budget)
    if (t > 0) {
      const int lim = ld_volatile(&s.tail);
      wg_drain(s, lim, lk, lr, base0, cap, k);
      wg_wait_done(s, lim);
      mbar_wait(&s.sel_done, (t - 1) & 1);
    }
    // keys, and each warp's takers: a ballot a (query pair, row half), kept
    // by lane 0. Lane 4g + quad holds queries 8j + 2 quad + e of rows
    // 16 wq + g and 16 wq + g + 8 of the tile. The metric without branches:
    // l2-squared max((|q|^2 - 2 q.x) + |x|^2, 0), dot -q.x + 0, cosine
    // -q.x + 1 (each as the plain version rounds it).
    const int quad = lane & 3, wq = warp - 4;
    const float cq = metric == 0 ? 2.0f : 1.0f;
    const float lo = metric == 0 ? 0.0f : __int_as_float(0xff800000);
    float add[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      add[h] = metric == 0 ? rdsq[h] : (metric == 2 ? 1.0f : 0.0f);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = 8 * j + 2 * quad + e;
        const uint32_t th = lds_u32(&s.thr[ql]);
        const float qs = __uint_as_float(lds_u32(&s.qsum[ql]));
        const float qq =
            metric == 0 ? __uint_as_float(lds_u32(&s.qsq[ql])) : 0.0f;
        const unsigned long long g = lds_u64(&s.bound[ql]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // q . decode(x): Q3 the product itself; Q4 step_x * (q . c) +
          // sum(q) * lower_x; Q2 the same with s and a
          float qdd = acc[j * 4 + h * 2 + e];
          if (ROWS != kPqRows) qdd = rst[h] * qdd + qs * rlo[h];
          const float dist = fmaxf(fmaf(-cq, qdd, qq) + add[h], lo);
          const uint32_t key = rok[h] ? order_key(dist) : kNone;
          acc[j * 4 + h * 2 + e] = __uint_as_float(key);
          // below the list's threshold and, as a (key, row) pair, below
          // the shared bound
          const unsigned m = __ballot_sync(
              kFull, key < th && (static_cast<unsigned long long>(key) << 32 |
                                  static_cast<uint32_t>(r0 + er + 8 * h)) < g);
          if (lane == 0) s.bal[j * 2 + e][wq][h] = m;
        }
      }
    }
    named_bar(3, 256);
    {  // a query a thread: where each warp's takers go in its list (its
       // count and the takers of the warps before), and its new count; a
       // list that cannot take another tile is queued
      const uint32_t* bw = &s.bal[(ct >> 3) * 2 + (ct & 1)][0][0];
      const unsigned selq = 0x11111111u << ((ct >> 1) & 3);
      int at = s.cnt[ct];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        s.place[ct][w] = at;
        at += __popc(lds_u32(bw + 2 * w) & selq) +
              __popc(lds_u32(bw + 2 * w + 1) & selq);
      }
      s.cnt[ct] = at;
      if (at > cap - kWgR) s.queue[atomicAdd(&s.tail, 1) % kWgQT] = ct;
    }
    named_bar(3, 256);
    // the takers appended in row order: a row's place is its warp's place
    // and the takers before it in its warp (its rows in the order half 0,
    // then half 1)
    const unsigned sel = 0x11111111u << quad, before = (1u << lane) - 1u;
    const int row = r0 + er;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = 8 * j + 2 * quad + e;
        const uint32_t* bw = &s.bal[j * 2 + e][wq][0];
        const unsigned b0 = lds_u32(bw) & sel;
        const unsigned b1 = lds_u32(bw + 1) & sel;
        if ((b0 | b1) & (1u << lane)) {
          const uint32_t k0 = __float_as_uint(acc[j * 4 + e]);
          const uint32_t k1 = __float_as_uint(acc[j * 4 + 2 + e]);
          const size_t at =
              base0 + (size_t)ql * pinned(cap) + lds_u32(&s.place[ql][wq]);
          if (b0 & (1u << lane)) {
            const size_t p = at + __popc(b0 & before);
            lk[p] = k0;
            lr[p] = row;
            atomicMin(&s.smin[c][ql],
                      static_cast<unsigned long long>(k0) << 32 | row);
          }
          if (b1 & (1u << lane)) {
            const size_t p = at + __popc(b0) + __popc(b1 & before);
            lk[p] = k1;
            lr[p] = row + 8;
            atomicMin(&s.smin[c][ql],
                      static_cast<unsigned long long>(k1) << 32 | (row + 8));
          }
        }
      }
    }
    __threadfence_block();
    __syncwarp();
    if (lane == 0) mbar_arrive(&s.ep_done);
    named_bar(3, 256);
  }
  mbar_wait(&s.sel_done, (tiles - 1) & 1);
  wg_finish(s, lk, lr, base0, q0, b, cap, k);
}

// -- the merge ---------------------------------------------------------------

// The merge (`merge_kernel`): one CTA of kMThreads a query takes the
// partials its scan left, each split's list [cap] holding the split's taken
// entries first (in row order) and then kNone / -1 padding in its first k
// slots, to the query's k smallest (key, row), sorted. The order is the
// plain version's stable sort over the lists concatenated in split order:
// an entry's place in that order (split by split, each split's taken
// entries from a multiple of 4) stands for its position, and (key << 32 |
// place) values are distinct.
//
// Bound: the query's taken keys read once, its survivors' rows read once
// and k outputs written once (bytes). What the design does about it:
//   1. A split's taken count is searched, not read: the first padding slot
//      (a full list's last slot tells in one read; else rounds of kProbes
//      independent probes), a thread a split. Padding is never read or
//      counted.
//   2. The taken keys are staged once in shared memory by 16-byte
//      cp.async copies, every copy of the query in flight at once (4-byte
//      copies where the lists are not 16-byte aligned); where they do not
//      fit the launch's stage (`stage_cap` places), each pass reads them
//      from the lists instead (the streaming path).
//   3. The k-th smallest value by a radix select over the key's bytes that
//      differ between taken keys (their AND against their OR), then, only
//      for a tie at the k-th key, the place's bytes; it stops at the first
//      pass whose chosen bin is taken whole. A pass is a 16-byte read of
//      four keys, a mask compare and a shared atomic into the warp's own
//      histogram: its instructions, not its reads, set a pass's time.
//   4. The k survivors are collected in any order and sorted by counting
//      each one's rank among them (broadcast reads of shared memory); only
//      a survivor's row is read from the lists.

// the shared memory a merge CTA may stage in (a CTA takes what its shape's
// fullest lists need: one CTA an SM at SQ's [131, 256, 200] and BQ's [132,
// 256, 320]), the splits it takes, probes a round of the taken-count search
constexpr int kMergeSmem = 200704;
constexpr int kMergeMaxSplits = 4096;
constexpr int kProbes = 16;
// threads and warps a merge CTA: 16 warps, so the passes' latency hides
// where a query's stage leaves an SM to one CTA (512 threads took BQ's
// full lists 0.132 -> 0.099 ms and SQ's 0.088 -> 0.073 against 256 on an
// H100, `probe_quantized.py --merge`)
constexpr int kMThreads = 512;
constexpr int kMWarps = kMThreads / 32;

// Exclusive prefix sum of v over a merge CTA in thread order; `total` gets
// the CTA's sum.
__device__ __forceinline__ int merge_scan(int v, int* wsum, int& total) {
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
  for (int i = 0; i < kMWarps; ++i) {
    const int c = wsum[i];
    before += i < warp ? c : 0;
    all += c;
  }
  __syncthreads();  // wsum is read before the next scan writes it
  total = all;
  return before + x - v;
}

// Bytes of the merge's split offsets [splits + 1] and taken counts
// [splits], then its survivors [k] (8 bytes each), before the stage; each
// part from a multiple of 16 bytes.
__host__ __device__ constexpr size_t merge_fixed(int splits, int k) {
  return (((size_t)splits + 1) * 8 + 15) / 16 * 16 +
         ((size_t)k * 8 + 15) / 16 * 16;
}

// The taken entries of a list's first k slots: its first kNone slot. A
// full list (the usual one) takes one read of its last slot; else rounds
// of kProbes independent probes narrow the range.
__device__ __forceinline__ int taken_count(const uint32_t* keys, int k) {
  if (__ldg(keys + k - 1) != kNone) return k;
  int lo = 0, hi = k - 1;  // the slots below lo are taken; slot hi is not
  while (lo < hi) {
    const int step = (hi - lo + kProbes - 1) / kProbes;
    uint32_t v[kProbes];
#pragma unroll
    for (int m = 0; m < kProbes; ++m) {
      const int at = lo + m * step;
      v[m] = at < hi ? __ldg(keys + at) : kNone;
    }
    int f = kProbes;  // the first probe on padding
#pragma unroll
    for (int m = kProbes - 1; m >= 0; --m)
      if (v[m] == kNone) f = m;
    const int nlo = f == 0 ? lo : lo + (f - 1) * step + 1;
    if (f < kProbes) hi = min(hi, lo + f * step);
    lo = nlo;
  }
  return lo;
}

// The split holding place i: the last s with off[s] <= i.
__device__ __forceinline__ int split_of(const int* off, int splits, int i) {
  int lo = 0, hi = splits;  // off[lo] <= i < off[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

// The merge's view of one query's lists: the splits' places, taken counts
// and the staged keys (or, streaming, the lists themselves).
struct MergeLists {
  const uint32_t* lk;
  const int* lr;
  const int* off;   // [splits + 1] each split's first place (a multiple of 4)
  const int* cnt;   // [splits] taken entries
  const uint32_t* stage;  // [places] or null (streaming)
  size_t qbase, sstride;
  int splits;

  // keys of places 4g .. 4g + 3 (kNone where no entry)
  __device__ __forceinline__ uint4 group(int g) const {
    if (stage != nullptr) return reinterpret_cast<const uint4*>(stage)[g];
    const int s = split_of(off, splits, 4 * g);
    const int j = 4 * g - off[s], c = cnt[s];
    const uint32_t* src = lk + s * sstride + qbase + j;
    return make_uint4(j < c ? __ldg(src) : kNone,
                      j + 1 < c ? __ldg(src + 1) : kNone,
                      j + 2 < c ? __ldg(src + 2) : kNone,
                      j + 3 < c ? __ldg(src + 3) : kNone);
  }

  __device__ __forceinline__ int row(int place) const {
    const int s = split_of(off, splits, place);
    return __ldg(lr + s * sstride + qbase + (place - off[s]));
  }
};

// The n distinct survivors (key << 32 | place), each written at its rank
// among them as a distance and its row's id; slots n .. k-1 get
// MASK_DISTANCE / -1. E: survivors a thread holds (n <= E x kMThreads).
template <int E>
__device__ void rank_write(const unsigned long long* surv, int n,
                           const MergeLists& L, float* out_d, int* out_i,
                           int k) {
  const int tid = threadIdx.x;
  unsigned long long mine[E];
  int rank[E];
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int e = tid + m * kMThreads;
    mine[m] = e < n ? surv[e] : ~0ull;
    rank[m] = 0;
  }
  // two survivors a 16-byte read (surv starts on 16 bytes), then the odd
  // one
  const ulonglong2* surv2 = reinterpret_cast<const ulonglong2*>(surv);
#pragma unroll 4
  for (int j = 0; j < n / 2; ++j) {
    const ulonglong2 v = surv2[j];
#pragma unroll
    for (int m = 0; m < E; ++m) rank[m] += (v.x < mine[m]) + (v.y < mine[m]);
  }
  if (n & 1) {
    const unsigned long long v = surv[n - 1];
#pragma unroll
    for (int m = 0; m < E; ++m) rank[m] += v < mine[m];
  }
#pragma unroll
  for (int m = 0; m < E; ++m) {
    if (tid + m * kMThreads >= n) continue;
    const uint32_t key = static_cast<uint32_t>(mine[m] >> 32);
    const float dist = key_to_float(key);
    out_d[rank[m]] = dist;
    out_i[rank[m]] =
        dist >= kMask ? -1 : L.row(static_cast<int>(
                                 static_cast<uint32_t>(mine[m])));
  }
  for (int r = n + tid; r < k; r += kMThreads) {
    out_d[r] = kMask;
    out_i[r] = -1;
  }
}

// One count into bin `digit` of the shared histogram at `base` where `on`,
// a predicated reduction: an `atomicAdd` there compiled into a branch, a
// convergence barrier and the histogram's address worked out anew for each
// key, about 90 instructions a key in a radix pass.
__device__ __forceinline__ void shared_inc(uint32_t base, uint32_t digit,
                                           bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
      "@p red.shared.add.u32 [%0], 1;\n}\n" ::"r"(base + (digit << 2)),
      "r"(static_cast<uint32_t>(on))
      : "memory");
}

// The key of place 4g + u of the query's lists (kNone where no entry):
// from the stage, or (STAGED false) from the lists themselves.
template <bool STAGED>
__device__ __forceinline__ uint4 place_group(const MergeLists& L, int g) {
  if (STAGED) return reinterpret_cast<const uint4*>(L.stage)[g];
  return L.group(g);
}

// A thread's OR and AND of the taken keys of its places.
template <bool STAGED>
__device__ __forceinline__ void key_bits(const MergeLists& L, int groups,
                                         uint32_t& orv, uint32_t& andv) {
  for (int g = threadIdx.x; g < groups; g += kMThreads) {
    const uint4 v = place_group<STAGED>(L, g);
    const uint32_t key[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (key[u] != kNone) {
        orv |= key[u];
        andv &= key[u];
      }
  }
}

// The merge's passes over the query's places [0, 4 groups): the survivors
// (key << 32 | place) into surv, k of them where more are taken (total),
// else every one. `bits`: the key bits that differ between taken keys;
// `shared`: the bits every taken key holds. Each pass counts, into its
// warp's histogram, the digit at `shift` of the places that agree with the
// prefix above it: a key's bytes (shift >= 32: key bits shift - 32 up),
// then the place's.
template <bool STAGED>
__device__ __forceinline__ void select_survivors(
    const MergeLists& L, int groups, int total, int k, uint32_t bits,
    uint32_t shared_bits, unsigned long long* surv, int* wh, int* pick,
    int* n_surv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) *n_surv = 0;
  // a survivor: a taken key at or below klim; or, where the k-th key is
  // tied (ties), a key below tkey, or equal to it with the place's bits
  // from `pshift` up at most pmax
  uint32_t klim = kNone, tkey = 0, pmax = 0;
  int pshift = 0;
  bool ties = false;
  if (total > k) {
    uint32_t todo = 0;  // bit j: key byte j differs between taken keys
    for (int j = 0; j < 4; ++j)
      if ((bits >> (8 * j)) & 255u) todo |= 1u << j;
    uint32_t pk = shared_bits, pp = 0;  // the prefixes chosen so far
    const int place_top = (31 - __clz(max(4 * groups - 1, 1))) & ~7;
    int shift = todo ? 32 + 8 * (31 - __clz(todo)) : place_top;
    int need = k;
    const uint32_t mine = smem_addr(wh + warp * kBins);  // the warp's bins
    for (;;) {
      for (int i = tid; i < kMWarps * kBins; i += kMThreads) wh[i] = 0;
      __syncthreads();
      if (shift >= 32) {
        const int sh = shift - 32;
        const uint32_t hm = sh >= 24 ? 0u : kFull << (sh + 8), hv = pk & hm;
        for (int g = tid; g < groups; g += kMThreads) {
          const uint4 v = place_group<STAGED>(L, g);
          const uint32_t key[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            shared_inc(mine, (key[u] >> sh) & 255u,
                       (key[u] & hm) == hv && key[u] != kNone);
        }
      } else {
        const uint32_t hm = shift >= 24 ? 0u : kFull << (shift + 8),
                       hv = pp & hm;
        for (int g = tid; g < groups; g += kMThreads) {
          const uint4 v = place_group<STAGED>(L, g);
          const uint32_t key[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint32_t place = 4 * g + u;
            shared_inc(mine, (place >> shift) & 255u,
                       key[u] == pk && (place & hm) == hv);
          }
        }
      }
      __syncthreads();
      {  // the warps' histograms summed into the first
        int sum = 0;
        if (tid < kBins) {
#pragma unroll
          for (int w = 0; w < kMWarps; ++w) sum += wh[w * kBins + tid];
        }
        __syncthreads();
        if (tid < kBins) wh[tid] = sum;
      }
      __syncthreads();
      if (warp == 0) {
        int nd = need;
        const int digit = pick_digit(wh, nd);
        if (lane == 0) {
          pick[0] = digit;
          pick[1] = nd;
          pick[2] = wh[digit];
        }
      }
      __syncthreads();
      if (shift >= 32)
        pk |= static_cast<uint32_t>(pick[0]) << (shift - 32);
      else
        pp |= static_cast<uint32_t>(pick[0]) << shift;
      need = pick[1];
      const bool whole = pick[2] == need;
      __syncthreads();  // pick and wh are read before they are rewritten
      if (whole || shift == 0) {  // at shift 0 every bin is one value
        if (shift >= 32) {  // the keys at or below pk's prefix from sh up
          const int sh = shift - 32;
          klim = (pk >> sh << sh) | (sh ? kFull >> (32 - sh) : 0u);
        } else {
          ties = true;
          tkey = pk;
          pmax = pp >> shift;
          pshift = shift;
        }
        break;
      }
      if (shift > 32) {
        // the next key byte that differs, else the place's first
        const uint32_t below = todo & ((1u << ((shift - 32) / 8)) - 1u);
        shift = below ? 32 + 8 * (31 - __clz(below)) : place_top;
      } else {
        shift = shift == 32 ? place_top : shift - 8;
      }
    }
  }
  __syncthreads();  // n_surv is zeroed
  for (int g = tid; g < groups; g += kMThreads) {
    const uint4 v = place_group<STAGED>(L, g);
    const uint32_t key[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t place = 4 * g + u;
      const bool take =
          ties ? key[u] < tkey ||
                     (key[u] == tkey && (place >> pshift) <= pmax)
               : key[u] <= klim;
      if (key[u] != kNone && take)
        surv[atomicAdd(n_surv, 1)] =
            (static_cast<unsigned long long>(key[u]) << 32) | place;
    }
  }
}

// One CTA a query: the k smallest (key, row) of its splits' lists, sorted,
// as distances and ids (MASK_DISTANCE and -1 where nothing was taken).
// Dynamic shared memory: merge_fixed(splits, k) bytes, then the stage of
// `stage_cap` places. VEC: the lists are 16-byte aligned (cap a multiple
// of 4), so the stage takes 16-byte copies.
template <bool VEC>
__global__ void __launch_bounds__(kMThreads)
merge_kernel(const uint32_t* __restrict__ lk, const int* __restrict__ lr,
             float* __restrict__ out_d, int* __restrict__ out_i, int splits,
             int b, int cap, int k, int stage_cap) {
  extern __shared__ __align__(16) unsigned char merge_dyn[];
  int* off = reinterpret_cast<int*>(merge_dyn);  // [splits + 1]
  int* cnt = off + splits + 1;                    // [splits]
  unsigned long long* surv = reinterpret_cast<unsigned long long*>(
      merge_dyn + merge_fixed(splits, 0));  // [k]
  uint32_t* stage = reinterpret_cast<uint32_t*>(
      merge_dyn + merge_fixed(splits, k));  // [stage_cap]
  __shared__ int wh[kMWarps * kBins];  // a histogram a warp
  __shared__ int wsum[kMWarps];
  __shared__ int pick[3];
  __shared__ int n_surv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qbase = (size_t)blockIdx.x * cap, sstride = (size_t)b * cap;
  out_d += (size_t)blockIdx.x * k;
  out_i += (size_t)blockIdx.x * k;

  // each split's taken count, then its first place (a multiple of 4)
  for (int s = tid; s < splits; s += kMThreads)
    cnt[s] = taken_count(lk + s * sstride + qbase, k);
  __syncthreads();
  int places = 0, total = 0;
  for (int s0 = 0; s0 < splits; s0 += kMThreads) {
    const int s = s0 + tid;
    const int c = s < splits ? cnt[s] : 0;
    int all, all_taken;
    const int ex = places + merge_scan((c + 3) & ~3, wsum, all);
    merge_scan(c, wsum, all_taken);
    if (s < splits) off[s] = ex;
    places += all;
    total += all_taken;
  }
  if (tid == 0) off[splits] = places;
  __syncthreads();
  const int groups = places / 4;
  const bool staged = places <= stage_cap;
  MergeLists L = {lk, lr, off, cnt, staged ? stage : nullptr, qbase, sstride,
                  splits};

  if (staged) {
    // every taken key of the query in flight at once (a warp a split, a
    // lane a group of 4 places), then the places past a split's taken
    // entries set to kNone
    for (int s = warp; s < splits; s += kMWarps) {
      const int c = cnt[s];
      const uint32_t* src = lk + s * sstride + qbase;
      uint32_t* dst = stage + off[s];
      for (int j = 4 * lane; j < c; j += 128) {
        if (VEC) {
          cp_async16(dst + j, src + j, true);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            cp_async4(dst + j + u, j + u < c ? src + j + u : src, j + u < c);
        }
      }
    }
    cp_commit();
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    for (int s = tid; s < splits; s += kMThreads)
      for (int j = cnt[s]; j < ((cnt[s] + 3) & ~3); ++j)
        stage[off[s] + j] = kNone;
    __syncthreads();
  }
  // the bits every taken key holds (AND) and any holds (OR)
  uint32_t orv = 0, andv = kFull;
  if (staged)
    key_bits<true>(L, groups, orv, andv);
  else
    key_bits<false>(L, groups, orv, andv);
  orv = __reduce_or_sync(kFull, orv);
  andv = __reduce_and_sync(kFull, andv);
  if (lane == 0) {  // the histograms are free until the select
    wh[warp] = static_cast<int>(orv);
    wh[kMWarps + warp] = static_cast<int>(andv);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMWarps; ++i) {
    orv |= static_cast<uint32_t>(wh[i]);
    andv &= static_cast<uint32_t>(wh[kMWarps + i]);
  }
  __syncthreads();  // read before the select clears the histograms
  if (staged)
    select_survivors<true>(L, groups, total, k, orv ^ andv, andv, surv, wh,
                           pick, &n_surv);
  else
    select_survivors<false>(L, groups, total, k, orv ^ andv, andv, surv, wh,
                            pick, &n_surv);
  __syncthreads();  // every survivor is written
  const int n = min(total, k);
  if (n <= kMThreads)
    rank_write<1>(surv, n, L, out_d, out_i, k);
  else if (n <= 2 * kMThreads)
    rank_write<2>(surv, n, L, out_d, out_i, k);
  else if (n <= 4 * kMThreads)
    rank_write<4>(surv, n, L, out_d, out_i, k);
  else
    rank_write<kMaxK / kMThreads>(surv, n, L, out_d, out_i, k);
}

// The merge's stage: the places a CTA stages, every split's k (rounded up
// to 4) at most.
int merge_stage_cap(int splits, int k) {
  const long long room =
      ((long long)kMergeSmem - (long long)merge_fixed(splits, k)) / 16 * 4;
  const long long want = (long long)splits * ((k + 3) & ~3);
  return static_cast<int>(want < room ? want : room);
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
int launch_wg_scan(const __nv_bfloat16* q, const CodeRows& x,
                   const uint8_t* mask, const float* qsum, const float* qsq,
                   int metric, uint32_t* lk, int* lr,
                   unsigned long long* pub, int b, int n, int d, int dp,
                   int k, int splits, int split_rows, int cap,
                   void* stream) {
  constexpr size_t smem = wg_smem<ROWS>();
  auto kernel = wg_scan_kernel<ROWS, VEC>;
  const int e = allow_smem(kernel, smem);
  if (e) return e;
  const dim3 grid((b + kWgQT - 1) / kWgQT, splits);
  kernel<<<grid, kWgThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, x, mask, qsum, qsq, metric, lk, lr, pub, b, n, d, dp, k, split_rows,
      cap);
  return static_cast<int>(cudaGetLastError());
}

int check_code_scan(int b, int n, int d, int dp, int metric, int k,
                    int splits, int split_rows, int cap) {
  if (d < 1 || d > kMaxD || dp % kSqK != 0 || dp < d || dp - d >= kSqK)
    return kBadDims;
  if (metric < 0 || metric > 2) return kBadMetric;
  return check_plan(b, n, k, splits, split_rows, cap, kWgR);
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

// Q2: as bq_scan for the SQ distances of the bf16 queries, laid out
// [ceil(b / 256)][dp / 8][256][8] (zero past b and d; dp a multiple of 64),
// to the codes [n, d] (metric 0 l2-squared, 1 dot, 2 cosine), with the
// queries' float32 sums and sums of squares [b] and the rows' decoded
// squared norms [n]. pub [b, 2 splits] (all ones before the launch) is the
// splits' exchange for the shared bound.
int sq_scan(const __nv_bfloat16* q, const uint8_t* codes, const float* dsq,
            const uint8_t* mask, const float* qsum, const float* qsq, float a,
            float s, int metric, uint32_t* lk, int* lr,
            unsigned long long* pub, int b, int n, int d, int dp, int k,
            int splits, int split_rows, int cap, void* stream) {
  const int bad = check_code_scan(b, n, d, dp, metric, k, splits, split_rows,
                                  cap);
  if (bad) return bad;
  CodeRows x = {};
  x.codes = codes;
  x.dsq = dsq;
  x.a = a;
  x.s = s;
  x.piece =
      d % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0 ? 16 : 1;
  return launch_wg_scan<kSqRows, true>(q, x, mask, qsum, qsq, metric, lk, lr,
                                       pub, b, n, d, dp, k, splits,
                                       split_rows, cap, stream);
}

// Q4: as sq_scan for the RQ distances to the rotated codes [n, d] (d a
// multiple of 64, the codes 16-byte aligned), each row decoded with its own
// lower [n] and step [n].
int rq_scan(const __nv_bfloat16* q, const uint8_t* codes, const float* dsq,
            const float* lower, const float* step, const uint8_t* mask,
            const float* qsum, const float* qsq, int metric, uint32_t* lk,
            int* lr, unsigned long long* pub, int b, int n, int d, int dp,
            int k, int splits, int split_rows, int cap, void* stream) {
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
  x.piece = 16;
  return launch_wg_scan<kRqRows, true>(q, x, mask, qsum, qsq, metric, lk,
                                       lr, pub, b, n, d, dp, k, splits,
                                       split_rows, cap, stream);
}

// Q3: as sq_scan for the PQ distances to the rows whose codes [n, m] index
// the bf16 codebooks cb [m, centroids, dsub] (d = m * dsub), with the
// queries' float32 sums of squares [b] (qsum is not read).
int pq_scan(const __nv_bfloat16* q, const uint8_t* codes,
            const __nv_bfloat16* cb, const float* dsq, const uint8_t* mask,
            const float* qsq, int metric, uint32_t* lk, int* lr,
            unsigned long long* pub, int b, int n, int d, int dp, int m,
            int dsub, int centroids, int k, int splits, int split_rows,
            int cap, void* stream) {
  const int bad = check_code_scan(b, n, d, dp, metric, k, splits, split_rows,
                                  cap);
  if (bad) return bad;
  if (m < 1 || dsub < 1 || (long long)m * dsub != d || centroids < 1 ||
      centroids > 256)
    return kBadCodebook;
  if (reinterpret_cast<uintptr_t>(cb) % 16) return kBadAlign;
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
             ? launch_wg_scan<kPqRows, true>(q, x, mask, qsq, qsq, metric, lk,
                                             lr, pub, b, n, d, dp, k, splits,
                                             split_rows, cap, stream)
             : launch_wg_scan<kPqRows, false>(q, x, mask, qsq, qsq, metric,
                                              lk, lr, pub, b, n, d, dp, k,
                                              splits, split_rows, cap,
                                              stream);
}

// The merge: out_d / out_i [b, k], each query's k smallest (key, row) over
// the first k entries of its lists lk/lr [splits, b, cap] (each list's
// taken entries first, then key 0xffffffff / row -1), ascending by
// (distance, row), as distances and ids.
int topk_merge(const uint32_t* lk, const int* lr, float* out_d, int* out_i,
               int splits, int b, int cap, int k, void* stream) {
  if (b < 1 || splits < 1 || splits > kMergeMaxSplits || cap < k)
    return kBadShape;
  if (k < 1 || k > kMaxK) return kBadK;
  const int stage_cap = merge_stage_cap(splits, k);
  const size_t smem = merge_fixed(splits, k) + (size_t)stage_cap * 4;
  // every launch takes at most kMergeSmem bytes: allowed once a kernel
  // and a device
  static bool allowed[2][64] = {};
  int dev = 0;
  const int de = static_cast<int>(cudaGetDevice(&dev));
  if (de) return de;
  bool spare = false;
  auto go = [&](auto kernel, bool& done) {
    if (!done) {
      const int e = allow_smem(kernel, kMergeSmem);
      if (e) return e;
      done = true;
    }
    kernel<<<b, kMThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        lk, lr, out_d, out_i, splits, b, cap, k, stage_cap);
    return static_cast<int>(cudaGetLastError());
  };
  const bool vec = cap % 4 == 0 && reinterpret_cast<uintptr_t>(lk) % 16 == 0;
  bool& done = dev < 64 ? allowed[vec][dev] : spare;
  return vec ? go(merge_kernel<true>, done) : go(merge_kernel<false>, done);
}

// The keys the merge stages in shared memory for a query of `splits`
// lists keeping k (a query with more taken entries takes the streaming
// path).
int topk_merge_stage_cap(int splits, int k) {
  if (splits < 1 || splits > kMergeMaxSplits || k < 1 || k > kMaxK) return -1;
  return merge_stage_cap(splits, k);
}

const char* quantized_error_string(int code) {
  switch (code) {
    case kBadShape:
      return "b, n, w and splits must be >= 1 (the merge's splits <= 4096) "
             "and cap >= k";
    case kBadDims:
      return "dims outside [1, 4096], words != ceil(dims/32), or the padded "
             "query width not the next multiple of 64";
    case kBadK: return "k outside [1, 4096]";
    case kBadMetric: return "metric code outside 0..2";
    case kBadCodebook:
      return "PQ segments x sub-dimensions != d, or centroids outside "
             "[1, 256]";
    case kBadAlign:
      return "PQ codebooks or RQ codes not 16-byte aligned";
    case kBadPlan:
      return "split plan does not cover the rows in whole tiles, or the "
             "lists cannot hold k plus a tile";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
