// Fused HNSW walk of a query batch: greedy descent over the upper layers,
// then the layer-0 best-first beam, with the filtered walk's kept track and
// two-hop widening. One warp a query, several queries a block, one launch a
// batch. Below it, B7b (`mt_join_kernel`): the join of a multi-target
// search after one walk a target, scoring with the same row functions.
//
// Replaces: the XLA program `_fused_search` of
// weaviate_tpu/ops/device_beam.py:222 (with `_two_hop_widen` :180,
// `_masked_scores` :138 and the scorers `RawScorer` :70, `SQScorer` :85,
// `PQScorer` :98, `BQScorer` :112 and `RQScorer` :125, launched by
// `device_search` :796). The semantics are
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
//     rest visited (all reads of a hop before any of its marks, as the JAX
//     scatter does); score them; merge as the stable argsort of
//     [beam | new] does (beam entries first on equal distances, new ones in
//     frontier order) and keep `ef` entries with their expanded flags. Stop
//     at beam exhaustion or after `max_steps` expansions.
//   * Filtered walk (`allow`, `keep_k` > 0; :303-308, :339-362): the walk
//     is unchanged; each hop merges its allowed new entries into a kept
//     track of `keep_k` by the same stable rule (the seed counts when it is
//     allowed); kept slots left at the mask distance come out as -1. With
//     `expand` > 0 (`_two_hop_widen`), after the one-hop marks, the
//     `expand` closest blocked (disallowed) new entries (lower frontier
//     index first on ties, as lax.top_k) open their adjacency rows; second-
//     hop ids repeated inside the hop keep their first occurrence, visited
//     or absent ones drop, the rest are marked, scored and appended to the
//     hop's frontier, which then feeds both merges.
//   * Scoring, by the row type (a template parameter, as the metric is for
//     float32 rows; a code row's metric is a run-time value, one kernel a
//     code row type):
//     raw float32 rows with the five metrics of `gather_distance`
//     (weaviate_tpu/ops/distance.py:104-140): dot and cosine at bf16 round
//     the query and the row to bfloat16 (round to nearest even) and sum the
//     products in float32; l2-squared sums the float32 difference squared.
//     BQ rows (`bq_gather_distance`, ops/quantized.py:323): packed uint32
//     words and a float32 popcount a row; the query is its packed words (the
//     bits past `dims` cleared) and |q| is counted here; the distance
//     (|q| + |x|) - 2 popc(q & x) is an exact integer in float32, so BQ walks
//     equal the plain version's. The words of a row fit the speculative
//     path's 32 four-byte slots up to 1,024 dimensions. SQ rows
//     (`sq_gather_distance`, :279): uint8 codes and the decoded squared norm
//     a row; the query is rounded to bf16, sum(q) and sum(q^2) come from
//     the caller (float32, from the unrounded query); the epilogue is
//     s * (q . c) + a * sum(q), then the metric (l2-squared clamped at 0,
//     dot negated, cosine 1 - x). RQ rows (`rq_gather_distance`, :337): SQ's
//     row with the row's own lower and step, step_x * (q . c) + sum(q) *
//     lower_x. PQ rows (`pq_gather_distance`, :300): M code bytes and the
//     decoded squared norm a row; q . decode(x) sums bf16(q) x the bf16
//     centroid of each segment's code in float32; the epilogue is the metric
//     of that sum.
//
// Visited set: one bit a node and a query, [b, ceil(n/32)] uint32, zeroed
// by the caller (the JAX program keeps a [B, N] uint8 array); it is exact.
// Only the query's own warp touches its words: marks are atomics (lanes
// share words), read back with ld.global.cg (L2) after a __syncwarp.
//
// Bound on this card: the dependent chain of hops, not bytes. A query's
// hop cannot start before the previous hop's merge has picked its node,
// and each hop waits on global loads; at D = 25 the bytes a walk moves
// take a few percent of its time (the kernel counts them in `stats`).
// `probe_device_beam.py` splits a hop at 1.2M nodes: about half the
// gather's rounds, 40% the rank and merge, a serial chain of one warp's
// instructions that no other warp hides at two warps an SM (B = 256).
// What the design does about that:
//
//   1. One launch a batch: up to thousands of independent walks in flight.
//   2. One warp a query and several queries a block (the launch sizes
//      blocks so the batch spreads over every SM). No hop crosses a
//      __syncthreads: a warp syncs only itself, compacts its frontier with
//      __ballot_sync and popc, and ranks its merges by counting. Each
//      warp's query, beam (double-buffered), expanded flags, kept track and
//      frontier live in its slice of shared memory.
//   3. Two dependent global rounds a hop instead of four: the adjacency
//      row; then, issued together, `present[nb]`, the visited word,
//      `allow[nb]` and, for rows of up to 32 floats, the candidates' corpus
//      rows (groups of 8 lanes a row, 32 bytes a load, every load of the
//      hop's 32 rows in registers before the first is used). Scoring a row
//      that turns out visited costs bytes, not latency; `stats` counts
//      those rows. Wider float32 and BQ rows are scored by groups of lanes
//      after the visited test, where their bytes count. The widening adds
//      one round for the parents' rows.
//   3a. BQ rows on that path are scored a lane a row (`score_bq_lane`):
//      the row's words arrive in 16-byte loads and the lane sums its
//      popcounts alone, with the query's words in its registers, where
//      the 8-lane groups spent eight rounds of shuffles on 32 rows. On an
//      H100, `probe_device_beam.py --row bq` split a BQ hop at 262,144
//      rows into 3.7k cycles of that scoring (the same with the rows hot
//      in L1: not memory), 1.2k of rank and 2.3k of merge; the lane a row
//      took the scoring to 2.1k.
//      The rank of a BQ hop's landing entries (up to 32) is a lane an
//      entry with the counts over the kept lanes by shuffles, not a
//      compaction through shared memory and a counting loop over it.
//   3b. Code rows (SQ, RQ, PQ bytes) are staged, not loaded a row at a
//      time: after the visited test and the compaction, each lane issues
//      one bulk copy (the TMA) of an accepted row, the 16-byte aligned span
//      that holds it (so any row width and offset), into the query's slice
//      of shared memory, completing on the warp's mbarrier, and a 4-byte
//      cp.async of each of the row's floats, all before the first wait;
//      then groups of kCodeG lanes score the rows from shared memory, 32 /
//      kCodeG rows side by side (an odd row pitch in 16-byte pieces keeps
//      the groups on other banks). A hop's rows are one round, in chunks of
//      `stage_rows` that the launch sizes from the shared memory a query can
//      have at this batch. The entry point and the upper descent take the
//      same path.
//   3c. PQ has no code -> centroid round a segment: where the query's ADC
//      table (segments x centroids float32 inner products of its bf16 piece
//      with each bf16 centroid, built once at the walk's start from the
//      codebooks in L2) fits beside its state, a row is `segs` shared-memory
//      lookups of its staged codes. Where it does not, a chunk's codes land
//      first, then one pass issues every (row, segment) centroid piece of
//      the chunk together (16-byte cp.async of the aligned span) and the
//      groups sum them: two rounds a chunk, whatever the row's width. With
//      the table a lane scores a whole row (its lookups are independent).
//   4. While a hop merges, the adjacency row of its best new entry is read
//      ahead: that entry is the next hop's node whenever it lands ahead of
//      every unexpanded beam entry, and that hop then skips its first round.
//      A row read ahead for another node costs bytes; `stats` counts those.
//   5. The merges take only the new entries that can land: once the beam
//      (or the kept track) is full, an entry at or past its last one would
//      land at ef (keep_k) or later, so a ballot drops it before the rank,
//      and the serial rank and merge run over a few entries, not M0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxEf = 512;
constexpr int kMaxWidth = 128;  // M0 and M
constexpr int kMaxD = 4096;
constexpr int kMaxFrontier = 640;  // M0 * (1 + expand)
constexpr int kMaxWarps = 8;
// Rows of at most kSpecD floats are scored before the visited test, by
// groups of kSpecG lanes: a lane holds kSpecK floats of its row, and a chunk
// of 32 candidates is kSpecRounds rounds of 32 / kSpecG rows.
constexpr int kSpecD = 32;
constexpr int kSpecG = 8;
constexpr int kSpecK = kSpecD / kSpecG;
constexpr int kSpecRounds = kSpecG;
// BQ's merge: landing entries a hop counted against each old entry in
// registers (more take the search)
constexpr int kFewNew = 8;
// Code rows: kCodeG lanes a staged row; a chunk holds at least kMinStage
// rows (or the whole frontier) whatever the batch.
constexpr int kCodeG = 4;
constexpr int kMinStage = 8;
constexpr float kMask = 1e30f;  // MASK_DISTANCE of ops/distance.py
constexpr float kInf = __builtin_huge_valf();
constexpr int kNone = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

enum Metric { kL2 = 0, kDot = 1, kCosine = 2, kManhattan = 3, kHamming = 4 };
enum Row { kRawRow = 0, kBqRow = 1, kSqRow = 2, kRqRow = 3, kPqRow = 4 };
enum Mode { kUpper = 0, kHop = 1, kHop2 = 2 };
enum Stat { kExpansions, kScored, kAdjRows, kUpperRows, kSpeculative,
            kAheadLost, kStats };

// error codes of the C interface beside cudaError_t values (those are > 0)
enum Refused {
  kBadShape = -1,
  kBadEf = -2,
  kBadWidth = -3,
  kBadDims = -4,
  kBadMetric = -5,
  kBadKeep = -6,
  kBadFrontier = -7,
  kBadSmem = -8,
  kBadRow = -9,
  kBadAlign = -10,
};

struct Params {
  const float* queries;      // [b, d] (BQ: [b, d] words as their bits)
  const void* corpus;        // [rows, d] floats, BQ words or SQ codes;
                             // every node id is a row
  const float* row_aux;      // [rows]: BQ popcounts, SQ/RQ/PQ decoded
                             // squared norms
  const float* row_lo;       // RQ: [rows] per-row offsets
  const float* row_step;     // RQ: [rows] per-row steps
  const __nv_bfloat16* cb;   // PQ: [segs, centroids, dsub] bf16 codebooks
  const float* qaux;         // [b, 2]: SQ/RQ/PQ sum(q), sum(q^2)
  float sq_a, sq_s;          // SQ offset and step
  int segs, dsub, centroids; // PQ: a row is `segs` codes
  int metric;                // code rows: l2-squared, dot or cosine
  uint32_t last_word;        // BQ: the bits of a query's last word that count
  const int* adj;            // [n, m0], -1 padded
  const uint8_t* present;    // [n]
  const uint8_t* allow;      // [n] or null (no kept track)
  const int* eps;            // [b]
  const int* upper_adj;      // [levels, s, m], top level first
  const int* upper_slots;    // [levels, n], -1 = absent at that level
  uint32_t* visited;         // [b, words], zeroed
  int* out_ids;              // [b, ef]
  float* out_d;              // [b, ef]
  int* kept_ids;             // [b, keep_k] or null
  float* kept_d;             // [b, keep_k] or null
  int* stats;                // [b, kStats] or null
  int rows, n, d, m0, levels, s, m, ef, keep_k, expand, max_steps, words, group,
      frontier;
  int b, warp_bytes;
  int sms, smem_max;  // the card's SMs and opt-in shared memory a block
  // code rows (see CodeLayout)
  int stage_rows, stage_pitch, piece_slot, table;
};

// One query's shared memory beside the walk's state, for code rows: the
// staged rows of a chunk, their floats and, for PQ, the ADC table or the
// chunk's staged centroid pieces.
struct CodeLayout {
  int rows = 0;        // rows a chunk
  int pitch = 0;       // bytes a staged row: the 16-byte pieces of its
                       // aligned span, an odd count (banks)
  int piece_slot = 0;  // PQ without the table: bytes a staged centroid
  bool table = false;  // PQ: the [segs, centroids] float32 table
  int table_bytes = 0; // the table's, when it is taken
  int segs = 0;

  long long bytes(int r) const {  // with the copies' mbarrier
    const long long pq = table ? table_bytes : (long long)r * segs * piece_slot;
    return 16 + pq + (long long)r * pitch + ((12 * r + 15) & ~15);
  }
};

// One query's slice of shared memory.
struct Warp {
  float* q;        // [dpad] the query, bf16-rounded where the metric asks
  int* bid;        // [2][ef] beam ids, double-buffered
  float* bd;       // [2][ef] beam distances, ascending
  int* kid;        // [2][keep_k] kept track ids
  float* kd;       // [2][keep_k] kept track distances, ascending
  int* fid;        // [F] the hop's raw frontier (adjacency rows)
  float* fd;       // [F] lane-scored distances of the raw frontier
  int* cid;        // [F] accepted entries, frontier order
  float* cd;       // [F]
  int* sid;        // [F] accepted entries sorted (also the hop's parents)
  float* sd;       // [F]
  int* aid;        // [F] accepted allowed entries sorted
  float* ad;       // [F]
  uint8_t* fal;    // [F] allow flags of the raw frontier
  uint8_t* callow; // [F] allow flags of the accepted entries
  uint8_t* bexp;   // [2][ef] expanded flags
  // code rows, first in the slice (16-byte aligned)
  uint64_t* bar;   // the mbarrier the row copies complete on
  unsigned* phase; // its phase parity
  float* table;    // PQ: [segs, centroids] ADC table, or null
  unsigned char* stage;  // [stage_rows, stage_pitch] staged rows
  unsigned char* piece;  // PQ without the table: [stage_rows, segs, slot]
  float* saux;     // [stage_rows] the staged rows' aux, lower and step
  float* slo;
  float* sst;
};

inline int warp_bytes_for(int d, int m0, int m, int ef, int keep_k,
                          int expand) {
  const int f = m0 * (1 + expand) > m ? m0 * (1 + expand) : m;
  const int dpad = (d + 3) & ~3;
  const int words = dpad + 4 * ef + 4 * keep_k + 8 * f;
  return (4 * words + 2 * ef + 2 * f + 15) & ~15;
}

__device__ Warp carve(unsigned char* base, const Params& p) {
  Warp w;
  const int f = p.frontier;
  w.table = w.saux = w.slo = w.sst = nullptr;
  w.stage = w.piece = nullptr;
  w.bar = nullptr;
  w.phase = nullptr;
  if (p.stage_rows > 0) {  // the code rows' part, as CodeLayout counts it
    w.bar = reinterpret_cast<uint64_t*>(base);
    w.phase = reinterpret_cast<unsigned*>(base + 8);
    base += 16;
    if (p.table) {
      w.table = reinterpret_cast<float*>(base);
      base += (p.segs * p.centroids * 4 + 15) & ~15;
    }
    w.stage = base;
    base += p.stage_rows * p.stage_pitch;
    if (!p.table && p.piece_slot > 0) {
      w.piece = base;
      base += p.stage_rows * p.segs * p.piece_slot;
    }
    w.saux = reinterpret_cast<float*>(base);
    w.slo = w.saux + p.stage_rows;
    w.sst = w.slo + p.stage_rows;
    base += (12 * p.stage_rows + 15) & ~15;
  }
  float* x = reinterpret_cast<float*>(base);
  w.q = x; x += (p.d + 3) & ~3;
  w.bid = reinterpret_cast<int*>(x); x += 2 * p.ef;
  w.bd = x; x += 2 * p.ef;
  w.kid = reinterpret_cast<int*>(x); x += 2 * p.keep_k;
  w.kd = x; x += 2 * p.keep_k;
  w.fid = reinterpret_cast<int*>(x); x += f;
  w.fd = x; x += f;
  w.cid = reinterpret_cast<int*>(x); x += f;
  w.cd = x; x += f;
  w.sid = reinterpret_cast<int*>(x); x += f;
  w.sd = x; x += f;
  w.aid = reinterpret_cast<int*>(x); x += f;
  w.ad = x; x += f;
  uint8_t* u = reinterpret_cast<uint8_t*>(x);
  w.fal = u; u += f;
  w.callow = u; u += f;
  w.bexp = u;
  return w;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A query's scalars beside its row: BQ |q|; SQ, RQ, PQ sum(q) and sum(q^2).
struct QScal {
  float a, b;
};

// A row's floats beside its codes: `aux` (BQ popcount; SQ, RQ, PQ decoded
// squared norm) and RQ's lower and step.
struct RowAux {
  float aux, lo, st;
};

template <int METRIC, bool ROUND, int ROW>
__device__ __forceinline__ float term(float acc, float y, float x) {
  if (ROW == kBqRow) {
    // words carried as float bits: popc(q & x), exact in float32
    return acc + static_cast<float>(__popc(__float_as_uint(y) &
                                           __float_as_uint(x)));
  } else if (METRIC == kL2) {
    const float t = y - x;
    return acc + t * t;
  } else if (METRIC == kDot || METRIC == kCosine) {
    if (ROUND) x = bf16_round(x);
    return acc + y * x;
  } else if (METRIC == kManhattan) {
    return acc + fabsf(y - x);
  }
  return acc + ((y != x) ? 1.f : 0.f);
}

template <int METRIC>
__device__ __forceinline__ float finish(float acc) {
  if (METRIC == kDot) return -acc;
  if (METRIC == kCosine) return 1.f - acc;
  return acc;
}

// The distance from a row's summed terms and its floats, in the plain
// version's order of operations: q . decode(x) is s * (q . c) + a * sum(q)
// (SQ), step_x * (q . c) + sum(q) * lower_x (RQ) or the sum itself (PQ),
// then the metric (p.metric for code rows).
template <int METRIC, int ROW>
__device__ __forceinline__ float finish_row(const Params& p, const QScal& qs,
                                            float acc, const RowAux& ra) {
  if (ROW == kBqRow) return (qs.a + ra.aux) - 2.f * acc;
  if (ROW == kSqRow || ROW == kRqRow || ROW == kPqRow) {
    float qdd = acc;
    if (ROW == kSqRow) qdd = p.sq_s * acc + p.sq_a * qs.a;
    if (ROW == kRqRow) qdd = ra.st * acc + qs.a * ra.lo;
    if (p.metric == kL2) return fmaxf(qs.b - 2.f * qdd + ra.aux, 0.f);
    if (p.metric == kDot) return -qdd;
    return 1.f - qdd;
  }
  return finish<METRIC>(acc);
}

// Scores the candidates w.fid[base, min(base + 32, hi)) into w.fd: every
// row's loads are issued (kSpecRounds x kSpecK a lane, kSpecG lanes a row,
// 32 bytes of a row a load, and the row's aux value) before the first is
// used. `qv` holds the lane's four-byte slots of the query (floats, or BQ
// words). Raw and BQ rows only. Every lane of the warp calls it; `loaded`
// counts the rows a group leader scored.
template <int METRIC, bool ROUND, int ROW>
__device__ __forceinline__ void score_chunk(const Params& p, const Warp& w,
                                            const float (&qv)[kSpecK],
                                            const QScal& qs, int base, int hi,
                                            int& loaded) {
  const int lane = threadIdx.x & 31, gl = lane % kSpecG;
  float x[kSpecRounds][kSpecK];
  float aux[kSpecRounds];
  int rows[kSpecRounds];
  const float* corpus = static_cast<const float*>(p.corpus);
#pragma unroll
  for (int r = 0; r < kSpecRounds; ++r) {
    const int c = base + r * (32 / kSpecG) + lane / kSpecG;
    int row = c < hi ? w.fid[c] : -1;
    if (row >= p.rows) row = -1;
    rows[r] = row;
    const float* src = corpus + (size_t)(row < 0 ? 0 : row) * p.d;
#pragma unroll
    for (int t = 0; t < kSpecK; ++t) {
      const int k = gl + kSpecG * t;
      x[r][t] = row >= 0 && k < p.d ? __ldg(src + k) : 0.f;
    }
    aux[r] = ROW != kRawRow && row >= 0 ? __ldg(p.row_aux + row) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kSpecRounds; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kSpecK; ++t)
      if (gl + kSpecG * t < p.d)
        acc = term<METRIC, ROUND, ROW>(acc, qv[t], x[r][t]);
#pragma unroll
    for (int off = kSpecG / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFull, acc, off, kSpecG);
    const int c = base + r * (32 / kSpecG) + lane / kSpecG;
    if (gl == 0 && c < hi) {
      w.fd[c] = rows[r] >= 0
                    ? finish_row<METRIC, ROW>(p, qs, acc, {aux[r], 0.f, 0.f})
                    : kMask;
      loaded += rows[r] >= 0;
    }
  }
}

// BQ rows of the speculative path, a lane a row: lane j scores candidate
// w.fid[base + j] (j < hi - base) alone, its row's words (16-byte loads
// where the rows are 16-byte aligned) and popcount loaded together, against
// the query's words `qw` held in every lane; no shuffle, one round. The sum
// of popcounts is an exact integer, as the groups' float sums are.
__device__ __forceinline__ void score_bq_lane(const Params& p, const Warp& w,
                                              const uint32_t (&qw)[kSpecD],
                                              const QScal& qs, int base,
                                              int hi, int& loaded) {
  const int c = base + (threadIdx.x & 31);
  int row = c < hi ? w.fid[c] : -1;
  if (row >= p.rows) row = -1;
  const uint32_t* src = static_cast<const uint32_t*>(p.corpus) +
                        (size_t)(row < 0 ? 0 : row) * p.d;
  uint32_t x[kSpecD];
  const bool vec = (p.d & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(p.corpus) & 15u) == 0;
  if (vec) {
#pragma unroll
    for (int t = 0; t < kSpecD; t += 4) {
      const uint4 v = row >= 0 && t < p.d
                          ? __ldg(reinterpret_cast<const uint4*>(src + t))
                          : make_uint4(0u, 0u, 0u, 0u);
      x[t] = v.x;
      x[t + 1] = v.y;
      x[t + 2] = v.z;
      x[t + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < kSpecD; ++t)
      x[t] = row >= 0 && t < p.d ? __ldg(src + t) : 0u;
  }
  const float aux = row >= 0 ? __ldg(p.row_aux + row) : 0.f;
  int sum = 0;
#pragma unroll
  for (int t = 0; t < kSpecD; ++t) sum += __popc(qw[t] & x[t]);
  if (c < hi) {
    w.fd[c] = row >= 0 ? (qs.a + aux) - 2.f * static_cast<float>(sum) : kMask;
    loaded += row >= 0;
  }
}

// Distance of the shared query to float32 or BQ row `row` (wider than the
// speculative path's), summed by a group of G lanes (lane `gl` of the group
// strides over the row). Every lane of the warp calls it; a lane whose
// group has no row passes row < 0.
template <int METRIC, bool ROUND, int ROW>
__device__ __forceinline__ float group_distance(const Params& p,
                                                const float* q,
                                                const QScal& qs, int row,
                                                int gl, int G) {
  static_assert(ROW == kRawRow || ROW == kBqRow, "code rows are staged");
  float acc = 0.f;
  RowAux ra = {0.f, 0.f, 0.f};
  if (row >= 0) {
    if (ROW != kRawRow) ra.aux = __ldg(p.row_aux + row);
    const float* c = static_cast<const float*>(p.corpus) + (size_t)row * p.d;
    for (int k = gl; k < p.d; k += G)
      acc = term<METRIC, ROUND, ROW>(acc, q[k], __ldg(c + k));
  }
  for (int off = G >> 1; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off, G);
  return finish_row<METRIC, ROW>(p, qs, acc, ra);
}

// -- code rows ---------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}

// Waits for this lane's copies; a __syncwarp after it shows every lane's.
// (The copies themselves carry no memory clobber, so the loads that feed
// their addresses are issued ahead; the stage is read only after the wait
// and written only after a __syncwarp that ends the previous reads.)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Code byte i of word v as a float: 2^23 + byte, less 2^23, both exact.
__device__ __forceinline__ float code_f(uint32_t v, int i) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 | i)) -
         8388608.f;
}

// The bytes [a, a + len) of global memory sit at the returned offset in
// the 16-byte pieces of their aligned span. A piece that holds one byte of
// an allocation lies in its mapped pages, so the span's ends are safe to
// copy whatever the row's width and offset.
__device__ __forceinline__ unsigned span_offset(uintptr_t a) {
  return static_cast<unsigned>(a & 15u);
}

// The row copies: one bulk copy (the TMA) of each row's aligned span,
// completing on the warp's mbarrier; its phase parity sits in the word
// after it.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(phase) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, uintptr_t src,
                                          unsigned bytes, uint64_t* bar) {
  // the stage's earlier reads (generic proxy) before the copy's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void stage_span(unsigned char* dst, uintptr_t a,
                                           int len) {
  const uintptr_t a0 = a & ~uintptr_t(15);
  for (uintptr_t g = a0; g < a + len; g += 16, dst += 16) cp_async16(dst, g);
}

// Issues the copies of the accepted rows w.cid[base, base + nr): a lane a
// row, one bulk copy of the row's aligned span (the mbarrier expects the
// bytes of every 32 rows before the copies; lane 0 arrives after the last)
// and a 4-byte copy of each of its floats. Nothing waits here.
template <int ROW>
__device__ __forceinline__ void stage_rows(const Params& p, const Warp& w,
                                           int len, int base, int nr) {
  const int lane = threadIdx.x & 31;
  const uintptr_t corpus = reinterpret_cast<uintptr_t>(p.corpus);
  for (int r0 = 0; r0 < nr; r0 += 32) {
    const int r = r0 + lane;
    const bool mine = r < nr;
    const int row = mine ? w.cid[base + r] : 0;
    const uintptr_t a = corpus + (size_t)row * len;
    const uintptr_t a0 = a & ~uintptr_t(15);
    const unsigned bytes =
        mine ? static_cast<unsigned>(((a + len + 15) & ~uintptr_t(15)) - a0)
             : 0u;
    const unsigned total = __reduce_add_sync(kFull, bytes);
    if (lane == 0) bar_expect(w.bar, total);
    __syncwarp();  // the bytes are expected before any copy completes
    if (mine) {
      bulk_copy(w.stage + r * p.stage_pitch, a0, bytes, w.bar);
      cp_async4(w.saux + r, p.row_aux + row);
      if (ROW == kRqRow) {
        cp_async4(w.slo + r, p.row_lo + row);
        cp_async4(w.sst + r, p.row_step + row);
      }
    }
  }
  if (lane == 0) bar_arrive(w.bar);
}

// PQ without the table, once the chunk's codes have landed: issues every
// (row, segment) centroid piece of the chunk, lanes over the pairs.
__device__ __forceinline__ void stage_pieces(const Params& p, const Warp& w,
                                             int base, int nr) {
  const int lane = threadIdx.x & 31;
  const uintptr_t corpus = reinterpret_cast<uintptr_t>(p.corpus);
  const uintptr_t cb = reinterpret_cast<uintptr_t>(p.cb);
  const int segs = p.segs, bytes = 2 * p.dsub;
  for (int e = lane; e < nr * segs; e += 32) {
    const int r = e / segs, sg = e - r * segs;
    const unsigned off = span_offset(corpus + (size_t)w.cid[base + r] * segs);
    const int code = w.stage[r * p.stage_pitch + off + sg];
    stage_span(w.piece + (size_t)e * p.piece_slot,
               cb + ((size_t)sg * p.centroids + code) * bytes, bytes);
  }
}

// Word k of a staged code row at byte offset `off` of its slot, bytes past
// `len` zero.
__device__ __forceinline__ uint32_t staged_word(const unsigned char* src,
                                                unsigned off, int k, int len) {
  if ((off & 3u) == 0)
    return reinterpret_cast<const uint32_t*>(src + off)[k];
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * k + i < len) v |= static_cast<uint32_t>(src[off + 4 * k + i]) << (8 * i);
  return v;
}

// Lane `gl`'s part of q . decode(row) for the staged row r of the chunk,
// the row's codes at `src` + `off`: SQ and RQ a word of four codes against
// four query floats a step; PQ without the table the staged centroid pieces
// against the query's piece.
template <int ROW>
__device__ __forceinline__ float staged_sum(const Params& p, const Warp& w,
                                            const unsigned char* src,
                                            unsigned off, int r, int gl,
                                            int len) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  const int words = (len + 3) >> 2;
  if (ROW == kSqRow || ROW == kRqRow) {
    // the query is zero past d, so a word's bytes past the row add nothing
    const float4* q4 = reinterpret_cast<const float4*>(w.q);
    auto word = [&](uint32_t v, int k) {
      const float4 q = q4[k];
      a0 = fmaf(q.x, code_f(v, 0), a0);
      a1 = fmaf(q.y, code_f(v, 1), a1);
      a2 = fmaf(q.z, code_f(v, 2), a2);
      a3 = fmaf(q.w, code_f(v, 3), a3);
    };
    if ((off & 3u) == 0) {  // aligned words: loads a few steps ahead
      const uint32_t* s4 = reinterpret_cast<const uint32_t*>(src + off);
#pragma unroll 4
      for (int k = gl; k < words; k += kCodeG) word(s4[k], k);
    } else {
      for (int k = gl; k < words; k += kCodeG)
        word(staged_word(src, off, k, len), k);
    }
  } else {
    const uintptr_t cb = reinterpret_cast<uintptr_t>(p.cb);
    const int dsub = p.dsub;
    for (int sg = gl; sg < len; sg += kCodeG) {
      const int code = src[off + sg];
      const unsigned po = span_offset(
          cb + ((size_t)sg * p.centroids + code) * 2 * dsub);
      const unsigned char* pc =
          w.piece + ((size_t)r * len + sg) * p.piece_slot + po;
      const float* qk = w.q + sg * dsub;
      if ((dsub & 7) == 0 && po == 0) {
        for (int t = 0; t < dsub; t += 8) {
          const uint4 v = *reinterpret_cast<const uint4*>(pc + 2 * t);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
          const float2 f0 = __bfloat1622float2(h[0]);
          const float2 f1 = __bfloat1622float2(h[1]);
          const float2 f2 = __bfloat1622float2(h[2]);
          const float2 f3 = __bfloat1622float2(h[3]);
          a0 = fmaf(qk[t], f0.x, fmaf(qk[t + 1], f0.y, a0));
          a1 = fmaf(qk[t + 2], f1.x, fmaf(qk[t + 3], f1.y, a1));
          a2 = fmaf(qk[t + 4], f2.x, fmaf(qk[t + 5], f2.y, a2));
          a3 = fmaf(qk[t + 6], f3.x, fmaf(qk[t + 7], f3.y, a3));
        }
      } else {
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(pc);
        for (int t = 0; t < dsub; ++t)
          a0 = fmaf(qk[t], __bfloat162float(h[t]), a0);
      }
    }
  }
  return (a0 + a1) + (a2 + a3);
}

// PQ with the table: q . decode(row) of the row staged at `src` + `off`,
// summed by one lane, a table lookup a segment (16 codes a load where the
// row's span is aligned; the odd pitch keeps 8 lanes' loads on other banks).
__device__ __forceinline__ float table_sum(const Params& p, const Warp& w,
                                           const unsigned char* src,
                                           unsigned off, int len) {
  const int c = p.centroids;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if ((off & 15u) == 0 && (len & 15) == 0) {
    const uint4* s16 = reinterpret_cast<const uint4*>(src + off);
#pragma unroll 2
    for (int k = 0; k < len / 16; ++k) {
      const uint4 v = s16[k];
      const float* t = w.table + 16 * k * c;
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i, t += 4 * c) {
        a0 += t[u[i] & 255u];
        a1 += t[c + ((u[i] >> 8) & 255u)];
        a2 += t[2 * c + ((u[i] >> 16) & 255u)];
        a3 += t[3 * c + (u[i] >> 24)];
      }
    }
  } else {
    for (int k = 0; 4 * k < len; ++k) {
      const uint32_t v = staged_word(src, off, k, len);
      const float* t = w.table + 4 * k * c;
      a0 += t[v & 255u];
      if (4 * k + 1 < len) a1 += t[c + ((v >> 8) & 255u)];
      if (4 * k + 2 < len) a2 += t[2 * c + ((v >> 16) & 255u)];
      if (4 * k + 3 < len) a3 += t[3 * c + (v >> 24)];
    }
  }
  return (a0 + a1) + (a2 + a3);
}

// Scores the accepted code rows w.cid[start, count) into w.cd, a chunk of
// p.stage_rows rows at a time: every copy of the chunk is issued before the
// first wait (PQ without the table: the codes, then every centroid piece),
// then groups of kCodeG lanes sum kCodeG-wide strides of a staged row and
// reduce by shuffles (PQ with the table: a lane a row). Every lane of the
// warp calls it.
template <int METRIC, int ROW>
__device__ void score_rows(const Params& p, const Warp& w, const QScal& qs,
                           int start, int count) {
  const int lane = threadIdx.x & 31, gl = lane % kCodeG;
  const int len = ROW == kPqRow ? p.segs : p.d;
  const uintptr_t corpus = reinterpret_cast<uintptr_t>(p.corpus);
  for (int base = start; base < count; base += p.stage_rows) {
    const int nr = min(p.stage_rows, count - base);
    const unsigned phase = *w.phase;
    stage_rows<ROW>(p, w, len, base, nr);
    cp_async_wait_all();
    bar_wait(w.bar, phase);
    if (ROW == kPqRow && !p.table) {
      __syncwarp();  // the chunk's codes have landed
      stage_pieces(p, w, base, nr);
      cp_async_wait_all();
    }
    __syncwarp();  // every staged row has landed
    if (lane == 0) *w.phase = phase ^ 1u;
    if (ROW == kPqRow && p.table) {
      for (int r = lane; r < nr; r += 32) {
        const int row = w.cid[base + r];
        const unsigned off = span_offset(corpus + (size_t)row * len);
        const float acc = table_sum(p, w, w.stage + r * p.stage_pitch, off,
                                    len);
        w.cd[base + r] = finish_row<METRIC, ROW>(p, qs, acc,
                                                 {w.saux[r], 0.f, 0.f});
      }
    } else {
      for (int r0 = 0; r0 < nr; r0 += 32 / kCodeG) {
        const int r = r0 + lane / kCodeG;
        float acc = 0.f;
        if (r < nr) {
          const unsigned off =
              span_offset(corpus + (size_t)w.cid[base + r] * len);
          acc = staged_sum<ROW>(p, w, w.stage + r * p.stage_pitch, off, r,
                                gl, len);
        }
#pragma unroll
        for (int o = kCodeG / 2; o > 0; o >>= 1)
          acc += __shfl_xor_sync(kFull, acc, o, kCodeG);
        if (gl == 0 && r < nr) {
          const RowAux ra = {w.saux[r], ROW == kRqRow ? w.slo[r] : 0.f,
                             ROW == kRqRow ? w.sst[r] : 0.f};
          w.cd[base + r] = finish_row<METRIC, ROW>(p, qs, acc, ra);
        }
      }
    }
    __syncwarp();  // the chunk is scored before the stage is reused
  }
}

// PQ: the query's ADC table, table[s, c] = bf16(q)[s] . centroid[s, c] in
// float32, a segment at a time: the lanes take kTableU centroids each, every
// one's loads (16 bf16 a round) in flight before the first is used, against
// the segment's query piece read once a round (the codebooks stay in L2:
// every query reads them).
constexpr int kTableU = 8;

__device__ void build_table(const Params& p, const Warp& w) {
  const int lane = threadIdx.x & 31;
  const int c = p.centroids, dsub = p.dsub;
  for (int sg = 0; sg < p.segs; ++sg) {
    const __nv_bfloat16* cbs = p.cb + (size_t)sg * c * dsub;
    const float* qs = w.q + sg * dsub;
    for (int c0 = lane; c0 < c; c0 += 32 * kTableU) {
      float acc[kTableU];
#pragma unroll
      for (int u = 0; u < kTableU; ++u) acc[u] = 0.f;
      if ((dsub & 7) == 0) {
        for (int t = 0; t < dsub; t += 16) {
          const bool two = t + 8 < dsub;
          uint4 v[kTableU][2];
#pragma unroll
          for (int u = 0; u < kTableU; ++u) {
            const int e = c0 + 32 * u;
            const uint4* src =
                reinterpret_cast<const uint4*>(cbs + (size_t)e * dsub + t);
            const uint4 z = make_uint4(0, 0, 0, 0);
            v[u][0] = e < c ? __ldg(src) : z;
            v[u][1] = e < c && two ? __ldg(src + 1) : z;
          }
          float q[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) q[i] = i < 8 || two ? qs[t + i] : 0.f;
#pragma unroll
          for (int u = 0; u < kTableU; ++u) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const __nv_bfloat162* b =
                  reinterpret_cast<const __nv_bfloat162*>(&v[u][h]);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float2 f = __bfloat1622float2(b[i]);
                acc[u] = fmaf(q[8 * h + 2 * i], f.x, acc[u]);
                acc[u] = fmaf(q[8 * h + 2 * i + 1], f.y, acc[u]);
              }
            }
          }
        }
      } else {
        for (int t = 0; t < dsub; ++t) {
          float v[kTableU];
#pragma unroll
          for (int u = 0; u < kTableU; ++u) {
            const int e = c0 + 32 * u;
            v[u] = e < c ? __bfloat162float(cbs[(size_t)e * dsub + t]) : 0.f;
          }
          const float q = qs[t];
#pragma unroll
          for (int u = 0; u < kTableU; ++u) acc[u] = fmaf(q, v[u], acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kTableU; ++u)
        if (c0 + 32 * u < c) w.table[sg * c + c0 + 32 * u] = acc[u];
    }
  }
  __syncwarp();
}

// The raw frontier w.fid[lo, hi) (-1 = no entry) -> the accepted entries,
// appended in frontier order to w.cid/cd/callow from `count`; returns the
// new count (the same in every lane). Accepted: present and, at layer 0,
// not visited, and at the second hop also the first occurrence of its id
// in [lo, hi); layer-0 entries are marked visited. Pass 1 issues every
// lane's loads together; no mark is made before every read of the span.
// `loaded` counts, per lane, the rows scored before the test (SPEC). Code
// rows are scored by `score_rows`, raw and BQ rows wider than the
// speculative path's by groups of lanes.
template <int METRIC, bool ROUND, bool SPEC, int ROW>
__device__ int gather(const Params& p, const Warp& w,
                      const float (&qv)[kSpecK],
                      const uint32_t (&qw)[kSpecD], const QScal& qs,
                      uint32_t* vis, int lo, int hi, int mode, bool track,
                      int count, int& loaded) {
  const int lane = threadIdx.x & 31;
  for (int base = lo; base < hi; base += 32) {
    const int j = base + lane;
    const int nb = j < hi ? w.fid[j] : -1;
    uint8_t pres = 0, al = 0;
    uint32_t word = 0;
    if (nb >= 0) {
      pres = p.present[nb];
      if (mode != kUpper) word = __ldcg(vis + (nb >> 5));
      if (track) al = p.allow[nb];
    }
    if constexpr (SPEC && ROW == kBqRow)
      score_bq_lane(p, w, qw, qs, base, hi, loaded);
    else if constexpr (SPEC)
      score_chunk<METRIC, ROUND, ROW>(p, w, qv, qs, base, hi, loaded);
    const bool ok = nb >= 0 && pres && !((word >> (nb & 31)) & 1u);
    __syncwarp();  // the chunk's ids are read before they are overwritten
    if (j < hi) {
      w.fid[j] = ok ? nb : -1;
      w.fal[j] = al;
    }
  }
  __syncwarp();
  const int start = count;
  for (int base = lo; base < hi; base += 32) {
    const int j = base + lane;
    int nb = j < hi ? w.fid[j] : -1;
    if (mode == kHop2 && nb >= 0) {
      for (int i = lo; i < j; ++i) {
        if (w.fid[i] == nb) {
          nb = -1;
          break;
        }
      }
    }
    const unsigned bal = __ballot_sync(kFull, nb >= 0);
    if (nb >= 0) {
      const int pos = count + __popc(bal & ((1u << lane) - 1u));
      w.cid[pos] = nb;
      w.cd[pos] = w.fd[j];
      w.callow[pos] = w.fal[j];
      if (mode != kUpper) atomicOr(vis + (nb >> 5), 1u << (nb & 31));
    }
    count += __popc(bal);
  }
  __syncwarp();
  if constexpr (ROW == kSqRow || ROW == kRqRow || ROW == kPqRow) {
    score_rows<METRIC, ROW>(p, w, qs, start, count);
  } else if (!SPEC) {
    const int G = p.group, per = 32 / G, gl = lane % G;
    for (int base = start; base < count; base += per) {
      const int c = base + lane / G;
      const float v = group_distance<METRIC, ROUND, ROW>(
          p, w.q, qs, c < count ? w.cid[c] : -1, gl, G);
      if (gl == 0 && c < count) w.cd[c] = v;
    }
    __syncwarp();
  }
  return count;
}

// Entries of the ascending d[0, n) with d <= v (count_le) or d < v
// (count_lt).
__device__ __forceinline__ int count_le(const float* d, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (d[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_lt(const float* d, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (d[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int METRIC, bool ROUND, bool SPEC, int ROW>
__global__ void __launch_bounds__(32 * kMaxWarps)
walk_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (qi >= p.b) return;  // whole warps only: nothing syncs the block
  const Warp w = carve(smem + (size_t)(threadIdx.x >> 5) * p.warp_bytes, p);
  const bool track = p.allow != nullptr && p.keep_k > 0;
  const int ef = p.ef, kk = p.keep_k, m0 = p.m0;

  const float* qrow = p.queries + (size_t)qi * p.d;
  int qbits = 0;  // BQ: |q|, summed by lanes
  for (int k = lane; k < p.d; k += 32) {
    float v = qrow[k];
    if (ROW == kBqRow) {
      uint32_t u = __float_as_uint(v);
      if (k == p.d - 1) u &= p.last_word;  // bits past `dims` do not count
      qbits += __popc(u);
      v = __uint_as_float(u);
    }
    w.q[k] = ROUND ? bf16_round(v) : v;
  }
  for (int k = p.d + lane; k < ((p.d + 3) & ~3); k += 32) w.q[k] = 0.f;
  QScal qs = {0.f, 0.f};
  if (ROW == kBqRow) {
    for (int off = 16; off > 0; off >>= 1)
      qbits += __shfl_xor_sync(kFull, qbits, off);
    qs.a = static_cast<float>(qbits);
  } else if (ROW != kRawRow) {
    qs.a = p.qaux[(size_t)qi * 2];
    qs.b = p.qaux[(size_t)qi * 2 + 1];
  }
  uint32_t* vis = p.visited + (size_t)qi * p.words;
  int loaded = 0;  // per lane: rows scored before the visited test
  int accepted = 0, adj_rows = 0, upper_rows = 0, expansions = 0;
  int ahead_lost = 0;  // rows read ahead that the next hop did not expand
  __syncwarp();
  float qv[kSpecK];
#pragma unroll
  for (int t = 0; t < kSpecK; ++t) {
    const int k = lane % kSpecG + kSpecG * t;
    qv[t] = SPEC && k < p.d ? w.q[k] : 0.f;
  }
  uint32_t qw[kSpecD];  // BQ's speculative path: the query's words
#pragma unroll
  for (int t = 0; t < kSpecD; ++t)
    qw[t] = SPEC && ROW == kBqRow && t < p.d ? __float_as_uint(w.q[t]) : 0u;

  constexpr bool kCoded = ROW == kSqRow || ROW == kRqRow || ROW == kPqRow;
  if (kCoded && lane == 0) {
    bar_init(w.bar);
    *w.phase = 0u;
  }
  __syncwarp();
  if (ROW == kPqRow && p.table) build_table(p, w);

  int cur = p.eps[qi];
  float cur_d = kMask;
  if (cur >= 0) {
    if constexpr (kCoded) {
      if (lane == 0) w.cid[0] = cur;
      __syncwarp();
      score_rows<METRIC, ROW>(p, w, qs, 0, 1);
      cur_d = w.cd[0];
      __syncwarp();
    } else {
      cur_d = group_distance<METRIC, ROUND, ROW>(p, w.q, qs, cur, lane, 32);
    }
  }

  // -- upper-layer greedy descent ---------------------------------------
  for (int li = 0; cur >= 0 && li < p.levels; ++li) {
    const int* slots = p.upper_slots + (size_t)li * p.n;
    const int* uadj = p.upper_adj + (size_t)li * p.s * p.m;
    for (int step = 0; step < p.max_steps; ++step) {
      const int slot = slots[cur];
      if (slot < 0) break;  // absent at this level: every score masked
      for (int j = lane; j < p.m; j += 32)
        w.fid[j] = __ldg(uadj + (size_t)slot * p.m + j);
      __syncwarp();
      const int cnt = gather<METRIC, ROUND, SPEC, ROW>(
          p, w, qv, qw, qs, vis, 0, p.m, kUpper, false, 0, loaded);
      float best = kMask;
      int bi = kNone;
      for (int c = lane; c < cnt; c += 32) {
        const float v = w.cd[c];
        if (v < best) { best = v; bi = c; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, best, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (ov < best || (ov == best && oi < bi)) { best = ov; bi = oi; }
      }
      accepted += cnt;
      upper_rows += 1;
      // all masked: the JAX argmin lands on a masked slot (1e30), no move
      const bool move = bi != kNone && best < cur_d;
      const int next = move ? w.cid[bi] : -1;
      __syncwarp();  // every lane has read cid before the next step
      if (!move) break;
      cur = next;
      cur_d = best;
    }
  }

  // -- layer-0 best-first beam ------------------------------------------
  int beam_n = cur >= 0 ? 1 : 0;
  int first = cur >= 0 ? 0 : kNone;
  int kept_n = 0;
  if (lane == 0) {
    w.bid[0] = cur;
    w.bd[0] = cur_d;
    w.bexp[0] = 0;
    if (cur >= 0) atomicOr(vis + (cur >> 5), 1u << (cur & 31));
  }
  if (track && cur >= 0 && p.allow[cur]) {
    if (lane == 0) {
      w.kid[0] = cur;
      w.kd[0] = cur_d;
    }
    kept_n = 1;
  }
  __syncwarp();
  int buf = 0;
  // the adjacency row read ahead during the last merge, and its node
  int pre_node = -1;
  int pre[kMaxWidth / 32];
  for (int step = 0; step < p.max_steps && first < beam_n; ++step) {
    int* src_id = w.bid + buf * ef;
    float* src_d = w.bd + buf * ef;
    uint8_t* src_exp = w.bexp + buf * ef;
    if (src_d[first] >= kMask) break;  // JAX: active = cd < INF
    const int node = src_id[first];
    if (node == pre_node) {
#pragma unroll
      for (int t = 0; t < kMaxWidth / 32; ++t)
        if (lane + 32 * t < m0) w.fid[lane + 32 * t] = pre[t];
    } else {
      for (int j = lane; j < m0; j += 32)
        w.fid[j] = __ldg(p.adj + (size_t)node * m0 + j);
      ahead_lost += pre_node >= 0;
    }
    adj_rows += 1;
    if (lane == 0) src_exp[first] = 1;
    __syncwarp();
    int nn = gather<METRIC, ROUND, SPEC, ROW>(p, w, qv, qw, qs, vis, 0, m0,
                                              kHop, track, 0, loaded);
    expansions += 1;

    if (track && p.expand > 0) {
      // parents: the `expand` closest blocked new entries, ranked by
      // counting (frontier order on ties)
      int blocked = 0;
      for (int base = 0; base < nn; base += 32) {
        const int c = base + lane;
        const bool bl = c < nn && !w.callow[c] && w.cd[c] < kMask;
        if (bl) {
          const float dc = w.cd[c];
          int r = 0;
#pragma unroll 8
          for (int k = 0; k < nn; ++k) {
            const float dk = w.cd[k];
            r += !w.callow[k] && dk < kMask && (dk < dc || (dk == dc && k < c));
          }
          if (r < p.expand) w.sid[r] = w.cid[c];
        }
        blocked += __popc(__ballot_sync(kFull, bl));
      }
      const int np = blocked < p.expand ? blocked : p.expand;
      __syncwarp();
      const int e2 = p.expand * m0;
      for (int e = lane; e < e2; e += 32) {
        const int pi = e / m0;
        w.fid[m0 + e] =
            pi < np ? __ldg(p.adj + (size_t)w.sid[pi] * m0 + e % m0) : -1;
      }
      adj_rows += np;
      __syncwarp();
      nn = gather<METRIC, ROUND, SPEC, ROW>(p, w, qv, qw, qs, vis, m0,
                                            m0 + e2, kHop2, track, nn,
                                            loaded);
    }
    accepted += nn;

    // a new entry at or past the last of a full beam lands at ef or later,
    // and an allowed one at or past the last of a full kept track likewise:
    // keep only the entries one of the merges takes (in frontier order)
    const float bworst = beam_n == ef ? src_d[ef - 1] : kInf;
    const float kworst = track && kept_n == kk ? w.kd[buf * kk + kk - 1]
                                               : kInf;
    int nna = 0;
    if (ROW == kBqRow && nn <= 32) {
      // BQ: a lane an entry, the landing filter, then each kept entry's
      // rank among the kept ones (and the allowed ones'), counted over the
      // kept lanes by shuffles
      int id = -1, al = 0;
      float dc = kInf;
      if (lane < nn) {
        id = w.cid[lane];
        dc = w.cd[lane];
        al = w.callow[lane];
      }
      const bool keep = lane < nn && (dc < bworst || (al && dc < kworst));
      const unsigned kmask = __ballot_sync(kFull, keep);
      const int alk = track && al;
      int r = 0, ra = 0;
      for (unsigned m = kmask; m; m &= m - 1u) {
        const int j = __ffs(m) - 1;
        const float dj = __shfl_sync(kFull, dc, j);
        const int aj = __shfl_sync(kFull, alk, j);
        const int less = (dj < dc) || (dj == dc && j < lane);
        r += less;
        ra += less & aj;
      }
      if (keep) {
        w.sid[r] = id;
        w.sd[r] = dc;
        if (alk) {
          w.aid[ra] = id;
          w.ad[ra] = dc;
        }
      }
      nn = __popc(kmask);
      nna = __popc(__ballot_sync(kFull, keep && alk));
    } else {
      int kept_new = 0;
      for (int base = 0; base < nn; base += 32) {
        const int c = base + lane;
        int id = -1, al = 0;
        float dc = kInf;
        if (c < nn) {
          id = w.cid[c];
          dc = w.cd[c];
          al = w.callow[c];
        }
        const bool keep = c < nn && (dc < bworst || (al && dc < kworst));
        const unsigned bal = __ballot_sync(kFull, keep);
        __syncwarp();  // the chunk is read before it is overwritten
        if (keep) {
          const int pos = kept_new + __popc(bal & ((1u << lane) - 1u));
          w.cid[pos] = id;
          w.cd[pos] = dc;
          w.callow[pos] = al;
        }
        kept_new += __popc(bal);
      }
      nn = kept_new;
      __syncwarp();

      // rank the new entries among themselves (stable: frontier order on
      // ties), all of them and the allowed ones
      for (int base = 0; base < nn; base += 32) {
        const int c = base + lane;
        bool al = false;
        if (c < nn) {
          const float dc = w.cd[c];
          al = track && w.callow[c];
          int r = 0, ra = 0;
#pragma unroll 8
          for (int k = 0; k < nn; ++k) {
            const float dk = w.cd[k];
            const int less = (dk < dc) || (dk == dc && k < c);
            r += less;
            ra += less & w.callow[k];
          }
          w.sid[r] = w.cid[c];
          w.sd[r] = dc;
          if (al) {
            w.aid[ra] = w.cid[c];
            w.ad[ra] = dc;
          }
        }
        nna += __popc(__ballot_sync(kFull, al));
      }
    }
    __syncwarp();
    // the best new entry is the next hop's node whenever it lands ahead of
    // every unexpanded entry: read its adjacency row during the merge
    pre_node = nn > 0 ? w.sid[0] : -1;
#pragma unroll
    for (int t = 0; t < kMaxWidth / 32; ++t)
      pre[t] = pre_node >= 0 && lane + 32 * t < m0
                   ? __ldg(p.adj + (size_t)pre_node * m0 + lane + 32 * t)
                   : -1;

    // merge into the other buffers: the stable order of [old | new], a new
    // entry after the old ones at or below it, an old one after the new
    // ones below it
    int* dst_id = w.bid + (buf ^ 1) * ef;
    float* dst_d = w.bd + (buf ^ 1) * ef;
    uint8_t* dst_exp = w.bexp + (buf ^ 1) * ef;
    int mine = kNone;
    for (int s = lane; s < nn; s += 32) {
      const float ds = w.sd[s];
      const int pos = s + count_le(src_d, beam_n, ds);
      if (pos < ef) {
        dst_id[pos] = w.sid[s];
        dst_d[pos] = ds;
        dst_exp[pos] = 0;
        mine = min(mine, pos);
      }
    }
    if (ROW == kBqRow && nn <= kFewNew) {
      // BQ, few landing entries (89% of the probe's hops): each old entry
      // counts the new ones below it against their distances held in
      // registers, with no search, so its moves do not wait on each other
      float nd[kFewNew];
#pragma unroll
      for (int u = 0; u < kFewNew; ++u) nd[u] = u < nn ? w.sd[u] : kInf;
#pragma unroll 4
      for (int i = lane; i < beam_n; i += 32) {
        const float di = src_d[i];
        int pos = i;
#pragma unroll
        for (int u = 0; u < kFewNew; ++u) pos += nd[u] < di;
        if (pos < ef) {
          const uint8_t e = src_exp[i];
          dst_id[pos] = src_id[i];
          dst_d[pos] = di;
          dst_exp[pos] = e;
          if (!e) mine = min(mine, pos);
        }
      }
    } else {
      for (int i = lane; i < beam_n; i += 32) {
        const float di = src_d[i];
        const int pos = i + count_lt(w.sd, nn, di);
        if (pos < ef) {
          const uint8_t e = src_exp[i];
          dst_id[pos] = src_id[i];
          dst_d[pos] = di;
          dst_exp[pos] = e;
          if (!e) mine = min(mine, pos);
        }
      }
    }
    first = __reduce_min_sync(kFull, mine);
    beam_n = min(ef, beam_n + nn);
    if (track) {
      const int* ksrc_id = w.kid + buf * kk;
      const float* ksrc_d = w.kd + buf * kk;
      int* kdst_id = w.kid + (buf ^ 1) * kk;
      float* kdst_d = w.kd + (buf ^ 1) * kk;
      for (int s = lane; s < nna; s += 32) {
        const float ds = w.ad[s];
        const int pos = s + count_le(ksrc_d, kept_n, ds);
        if (pos < kk) {
          kdst_id[pos] = w.aid[s];
          kdst_d[pos] = ds;
        }
      }
      for (int i = lane; i < kept_n; i += 32) {
        const float di = ksrc_d[i];
        const int pos = i + count_lt(w.ad, nna, di);
        if (pos < kk) {
          kdst_id[pos] = ksrc_id[i];
          kdst_d[pos] = di;
        }
      }
      kept_n = min(kk, kept_n + nna);
    }
    buf ^= 1;
    __syncwarp();
  }
  ahead_lost += pre_node >= 0;  // the walk ended after it was read

  const int* fin_id = w.bid + buf * ef;
  const float* fin_d = w.bd + buf * ef;
  for (int i = lane; i < ef; i += 32) {
    p.out_ids[(size_t)qi * ef + i] = i < beam_n ? fin_id[i] : -1;
    p.out_d[(size_t)qi * ef + i] = i < beam_n ? fin_d[i] : kMask;
  }
  if (track) {
    const int* kfin_id = w.kid + buf * kk;
    const float* kfin_d = w.kd + buf * kk;
    for (int i = lane; i < kk; i += 32) {
      const float v = i < kept_n ? kfin_d[i] : kMask;
      p.kept_ids[(size_t)qi * kk + i] = v < kMask ? kfin_id[i] : -1;
      p.kept_d[(size_t)qi * kk + i] = v;
    }
  }
  const int spec = SPEC ? __reduce_add_sync(kFull, loaded) - accepted : 0;
  if (lane == 0 && p.stats != nullptr) {
    int* st = p.stats + (size_t)qi * kStats;
    st[kExpansions] = expansions;
    st[kScored] = accepted + (p.eps[qi] >= 0 ? 1 : 0);
    st[kAdjRows] = adj_rows;
    st[kUpperRows] = upper_rows;
    st[kSpeculative] = spec;
    st[kAheadLost] = ahead_lost;
  }
}

// The code rows' part of a query's shared memory: a chunk of `len`-byte rows
// (SQ, RQ: d codes; PQ: segs codes), sized so the batch's queries share an
// SM's shared memory (`per_sm` queries an SM wanted), between kMinStage
// rows (or the frontier) and the frontier, as far as a block's limit
// allows; PQ takes the table where it fits beside `state` and the smallest
// chunk. False when even one row does not fit.
bool code_layout(int len, bool pq, int segs, int dsub, int centroids,
                 int frontier, int state, int per_sm, int smem_sm,
                 int smem_max, CodeLayout* out) {
  CodeLayout c;
  // the pieces of an unaligned span at most, an odd count: the kCodeG-lane
  // groups' words of 8 rows, and 8 lanes' 16-byte loads of a row each (the
  // table path), fall on other banks
  c.pitch = 16 * (((len + 15) / 16 + 1) | 1);
  c.segs = segs;
  const int rmin = frontier < kMinStage ? frontier : kMinStage;
  if (pq) {
    // a centroid's 2 * dsub bytes start at a multiple of `align`
    const int bytes = 2 * dsub;
    const int align = (bytes & -bytes) < 16 ? (bytes & -bytes) : 16;
    c.piece_slot = 16 * ((16 - align + bytes + 15) / 16);
    c.table_bytes = (segs * centroids * 4 + 15) & ~15;
    c.table = true;
    if (state + c.bytes(rmin) > smem_max) c.table = false;
  }
  const long long share = smem_sm / (per_sm < 1 ? 1 : per_sm);
  int r = frontier;
  while (r > rmin && state + c.bytes(r) > share) --r;
  while (r > 1 && state + c.bytes(r) > smem_max) --r;
  if (state + c.bytes(r) > smem_max) return false;
  c.rows = r;
  *out = c;
  return true;
}

int group_for(int d) {
  if (d <= 64) return 8;
  if (d <= 256) return 16;
  return 32;
}

template <int METRIC, bool ROUND, int ROW = kRawRow>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // spread the batch over every SM, then fit the block's shared memory
  int wpb = (p.b + p.sms - 1) / p.sms;
  wpb = wpb < 1 ? 1 : (wpb > kMaxWarps ? kMaxWarps : wpb);
  while (wpb > 1 && (size_t)wpb * p.warp_bytes > (size_t)p.smem_max) --wpb;
  const size_t smem = (size_t)wpb * p.warp_bytes;
  // raw and BQ rows of up to kSpecD four-byte slots take the speculative
  // path; code rows (SQ, RQ and PQ bytes) are scored after the visited test
  auto kern = walk_kernel<METRIC, ROUND, false, ROW>;
  if constexpr (ROW == kRawRow || ROW == kBqRow)
    if (p.d <= kSpecD) kern = walk_kernel<METRIC, ROUND, true, ROW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<(p.b + wpb - 1) / wpb, 32 * wpb, smem, stream>>>(p);
  return cudaGetLastError();
}

// -- B7b: the multi-target join ----------------------------------------------
//
// Replaces: the join of the XLA program `_fused_multi_search` of
// weaviate_tpu/ops/device_beam.py:986 after its walks (:1013-1040, with
// `_mt_dedup` :940, `_masked_scores` :138, `_mt_join` :950 and `_mt_topk`
// :974). The walks themselves are B2's launches, one a target, on the same
// stream before this one. For each query row:
//
//   * Union: each target's pool (its kept track when that target's walk
//     was filtered, else its beam), cut to `fetch`, concatenated and sorted
//     ascending; a repeated id keeps one slot (`_mt_dedup`). Empty slots
//     (-1) are carried as INT_MAX here, so they sort last instead of first:
//     every such slot comes out as (-1, 1e30) either way, and the live ids
//     keep their ascending order, which is all the top-k's ties look at.
//   * A member is valid when, for every target t, 0 <= id < cap_t and
//     present_t[id]. Only valid members are scored and joined.
//   * Cross-scores: member x under target t with t's own row type, through
//     the scoring functions of B2's rows above (`term`, `finish`,
//     `finish_row`, `code_f`): raw float32 rows (five metrics, bf16-rounded
//     dot and cosine), BQ words, SQ and RQ codes, PQ codes through the
//     query's ADC table in shared memory (built as B2-PQ builds it) where
//     it fits, else through the centroid pieces read from L2.
//   * Join (`_mt_join`): weighted, sum over t of w[b, t] * d_t in target
//     order; minimum, the least d_t; relative, each target min-max
//     normalised over the valid members (a span of 0 taken as 1), then the
//     weighted sum. Invalid members are 1e30.
//   * Top-k (`_mt_topk`): the `fetch` least joined distances, equal ones
//     in union order (the lower id first); slots at 1e30 or above, and
//     slots past the valid members, are (-1, 1e30).
//
// Bound on this card: bytes, the valid members' rows of every target read
// once, T x fetch rows of a few KB a query, and the pools: half a
// microsecond at the main path's shape (B 1, two targets of 768 and 256
// floats, fetch 64, 127 members). What a launch costs there is its chain
// of dependent global rounds, so the design spreads a query's rows over
// the card and keeps the chain short:
//
//   1. A thread block cluster a query row, `ranks` CTAs of 512 threads
//      (up to 8, portable). Each CTA stages the targets' queries and
//      finds the union's members itself (a repeat of a few hundred ids
//      costs less than a round through the cluster), so the members are
//      the same in every CTA without an exchange. Nothing is sorted: the
//      lowest slot of an id stays (each slot compares its id with those
//      before it), and the rank breaks ties by the lower id, which is the
//      sorted union's order; each slot's presence in every target is read
//      with its id, in the same round.
//   2. CTA r scores the members of its slice, [r V / R, (r + 1) V / R),
//      under every target: a group of lanes a (member, target) pair, as
//      wide as leaves a group for every pair of the slice (16 lanes at
//      the main path's 16 members and two targets: twelve 16-byte loads
//      a lane of a 768-float row, issued before the first is used), so
//      all the slice's pairs, every target's, are one round of loads.
//   3. PQ's ADC table is built once a cluster, not once a CTA: CTA r
//      builds the table's rows of segments [r M / R, (r + 1) M / R) in its
//      shared memory, and a lookup reads the row's segment from the CTA
//      that holds it, through distributed shared memory. A table whose
//      slice does not fit leaves the lookups to the centroid pieces in L2.
//   4. Each member's distance goes straight into the first CTA's shared
//      memory (a distributed shared memory store); after one cluster
//      barrier that CTA does the relative min-max over all valid members
//      (every target's in one block reduction, as are the queries'
//      sums), the join and a rank by counting, and writes the row's
//      `fetch`.

constexpr int kMtMaxTargets = 8;
constexpr int kMtMaxUnion = 4096;
constexpr int kMtMaxFetch = 512;
constexpr int kMtThreads = 512;
constexpr int kMtMaxCluster = 8;
constexpr int kMtNone = 0x7fffffff;
constexpr int kMtHeadBytes = 64;   // a packed MtCall: 4 Q, 8 i

enum Join { kWeighted = 0, kMinimum = 1, kRelative = 2 };

struct MtTarget {
  const int* pool;           // [b, pool_w], -1 padded
  const float* queries;      // [b, d] (BQ: words as their bits)
  const void* rows;          // [nrows, d] floats, BQ words, SQ or RQ codes;
                             // PQ [nrows, segs] codes
  const float* row_aux;      // BQ popcounts, code rows' decoded sq norms
  const float* row_lo;       // RQ
  const float* row_step;     // RQ
  const __nv_bfloat16* cb;   // PQ [segs, centroids, dsub]
  const uint8_t* present;    // [cap]
  int pool_w, cap, nrows, d, kind, metric, round, segs, dsub, centroids;
  float sq_a, sq_s;
  uint32_t last_word;        // BQ: the bits of a query's last word that count
  int q_off;                 // floats: the query's offset in shared memory
  int table_off;             // floats: PQ's table slice, or -1 (none)
  int table_per;             // PQ: segments a CTA's slice holds
  int vec;                   // raw rows read 16 bytes at a time
};

struct MtParams {
  MtTarget tg[kMtMaxTargets];
  const float* weights;  // [b, targets]
  int* out_ids;          // [b, fetch]
  float* out_d;          // [b, fetch]
  int targets, b, fetch, join, upad, ranks;
  // byte offsets in shared memory
  int off_vidx, off_comb, off_dist, off_valid, off_q;
};

// The layout of one CTA's shared memory (bytes): the union's ids, the
// members' ids, their joined distances, their distances a target (the
// first CTA's are read), the slots' validity, the targets' queries, then
// PQ's table slices.
struct MtLayout {
  long long vidx, comb, dist, valid, q, tables;
};

inline MtLayout mt_layout(int upad, int targets, long long q_floats) {
  MtLayout l;
  l.vidx = 4LL * upad;
  l.comb = l.vidx + 4LL * upad;
  l.dist = l.comb + 4LL * upad;
  l.valid = l.dist + 4LL * targets * upad;
  l.q = l.valid + ((upad + 15) & ~15);
  l.tables = l.q + 4 * q_floats;
  return l;
}

// 16-byte pieces of a raw row a lane loads before it uses the first
constexpr int kMtBatch = 16;

template <int METRIC, bool ROUND>
__device__ __forceinline__ float mt_raw_sum(const MtTarget& t, const float* q,
                                            const float* x, int gl, int g) {
  float acc = 0.f;
  if (t.vec) {
    // the lane's pieces a batch at a time, every load of a batch issued
    // before the first is used (a 768-float row over 16 lanes: one batch)
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int n4 = t.d >> 2;
    for (int u0 = gl; u0 < n4; u0 += kMtBatch * g) {
      float4 v[kMtBatch];
#pragma unroll
      for (int b = 0; b < kMtBatch; ++b) {
        const int u = u0 + b * g;
        v[b] = u < n4 ? __ldg(x4 + u) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int b = 0; b < kMtBatch; ++b) {
        const int u = u0 + b * g;
        if (u < n4) {
          const float4 y = q4[u];
          acc = term<METRIC, ROUND, kRawRow>(acc, y.x, v[b].x);
          acc = term<METRIC, ROUND, kRawRow>(acc, y.y, v[b].y);
          acc = term<METRIC, ROUND, kRawRow>(acc, y.z, v[b].z);
          acc = term<METRIC, ROUND, kRawRow>(acc, y.w, v[b].w);
        }
      }
    }
    return acc;
  }
#pragma unroll 4
  for (int k = gl; k < t.d; k += g)
    acc = term<METRIC, ROUND, kRawRow>(acc, q[k], __ldg(x + k));
  return acc;
}

// Lane `gl` (of `g` lanes) of member `id`'s sum under target `t` (raw: the
// metric's terms; BQ: popcounts; SQ, RQ, PQ: q . c), summed by the caller.
// `smem_f` is this CTA's shared memory as floats; PQ's table rows are read
// from the CTA of the cluster that holds their segment.
__device__ float mt_lane_sum(const MtTarget& t, const float* q, float* smem_f,
                             int id, int gl, int g) {
  const int d = t.d;
  if (t.kind == kRawRow) {
    const float* x = static_cast<const float*>(t.rows) + (size_t)id * d;
    switch (t.metric) {
      case kL2: return mt_raw_sum<kL2, false>(t, q, x, gl, g);
      case kDot:
        return t.round ? mt_raw_sum<kDot, true>(t, q, x, gl, g)
                       : mt_raw_sum<kDot, false>(t, q, x, gl, g);
      case kCosine:
        return t.round ? mt_raw_sum<kCosine, true>(t, q, x, gl, g)
                       : mt_raw_sum<kCosine, false>(t, q, x, gl, g);
      case kManhattan: return mt_raw_sum<kManhattan, false>(t, q, x, gl, g);
      default: return mt_raw_sum<kHamming, false>(t, q, x, gl, g);
    }
  }
  float acc = 0.f;
  if (t.kind == kBqRow) {
    const float* x = static_cast<const float*>(t.rows) + (size_t)id * d;
    for (int k = gl; k < d; k += g)
      acc = term<kL2, false, kBqRow>(acc, q[k], __ldg(x + k));
    return acc;
  }
  if (t.kind == kSqRow || t.kind == kRqRow) {
    const uint8_t* x = static_cast<const uint8_t*>(t.rows) + (size_t)id * d;
#pragma unroll 4
    for (int k = gl; k < d; k += g)
      acc = fmaf(q[k], static_cast<float>(__ldg(x + k)), acc);
    return acc;
  }
  // PQ
  const uint8_t* codes =
      static_cast<const uint8_t*>(t.rows) + (size_t)id * t.segs;
  if (t.table_off >= 0) {
    cg::cluster_group cluster = cg::this_cluster();
    for (int s = gl; s < t.segs; s += g) {
      const int owner = s / t.table_per;
      const float* slice = cluster.map_shared_rank(smem_f + t.table_off,
                                                   owner);
      acc += slice[(s - owner * t.table_per) * t.centroids + __ldg(codes + s)];
    }
    return acc;
  }
  for (int s = gl; s < t.segs; s += g) {
    const __nv_bfloat16* piece =
        t.cb + ((size_t)s * t.centroids + __ldg(codes + s)) * t.dsub;
    const float* qk = q + s * t.dsub;
    for (int j = 0; j < t.dsub; ++j)
      acc = fmaf(qk[j], __bfloat162float(piece[j]), acc);
  }
  return acc;
}

// The distance of member `id` under target `t` from its summed terms.
__device__ float mt_finish(const MtTarget& t, float acc, float qa, float qb,
                           int id) {
  if (t.kind == kRawRow) {
    switch (t.metric) {
      case kL2: return finish<kL2>(acc);
      case kDot: return finish<kDot>(acc);
      case kCosine: return finish<kCosine>(acc);
      case kManhattan: return finish<kManhattan>(acc);
      default: return finish<kHamming>(acc);
    }
  }
  Params p;  // the fields `finish_row` reads
  p.metric = t.metric;
  p.sq_a = t.sq_a;
  p.sq_s = t.sq_s;
  const QScal qs = {qa, qb};
  RowAux ra = {__ldg(t.row_aux + id), 0.f, 0.f};
  if (t.kind == kBqRow) return finish_row<kL2, kBqRow>(p, qs, acc, ra);
  if (t.kind == kSqRow) return finish_row<kL2, kSqRow>(p, qs, acc, ra);
  if (t.kind == kRqRow) {
    ra.lo = __ldg(t.row_lo + id);
    ra.st = __ldg(t.row_step + id);
    return finish_row<kL2, kRqRow>(p, qs, acc, ra);
  }
  return finish_row<kL2, kPqRow>(p, qs, acc, ra);
}

__device__ __forceinline__ void mt_cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kMtThreads) mt_join_kernel(MtParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kW = kMtThreads / 32;
  __shared__ float s_q[2 * kMtMaxTargets];  // a target: a, then b
  __shared__ float s_lo[kMtMaxTargets], s_span[kMtMaxTargets];
  __shared__ float s_w[kMtMaxTargets];
  __shared__ float s_red[kW][2 * kMtMaxTargets];
  __shared__ int s_valid_n;
  const int R = p.ranks;
  const int qi = blockIdx.x / R, rank = blockIdx.x - qi * R;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int T = p.targets, U = p.upad;
  int* ids = reinterpret_cast<int*>(smem);
  int* vid = reinterpret_cast<int*>(smem + p.off_vidx);
  float* comb = reinterpret_cast<float*>(smem + p.off_comb);
  float* dist = reinterpret_cast<float*>(smem + p.off_dist);
  uint8_t* valid = smem + p.off_valid;
  float* smem_f = reinterpret_cast<float*>(smem + p.off_q);

  // the union's slots, each id's presence in every target read at once,
  // the hash cleared
  for (int u = tid; u < U; u += nt) {
    int id = kMtNone;
    bool ok = false;
    if (u < T * p.fetch) {
      const int t = u / p.fetch, j = u - t * p.fetch;
      const int v = p.tg[t].pool[(size_t)qi * p.tg[t].pool_w + j];
      if (v >= 0) {
        id = v;
        int all = 1;  // the targets' loads issued together
        for (int s = 0; s < T; ++s) {
          const MtTarget& g = p.tg[s];
          const bool in = id < g.cap && id < g.nrows;
          all &= in ? __ldg(g.present + id) != 0 : 0;
        }
        ok = all != 0;
      }
    }
    ids[u] = id;
    valid[u] = ok;
  }
  if (tid < T) s_w[tid] = p.weights[(size_t)qi * T + tid];
  // each target's query, as B2 stages it, and its scalars (BQ: |q|; the
  // code rows: sum(q) and sum(q^2)), summed for every target at once
  float part[2 * kMtMaxTargets];
#pragma unroll
  for (int i = 0; i < 2 * kMtMaxTargets; ++i) part[i] = 0.f;
  for (int t = 0; t < T; ++t) {
    const MtTarget& g = p.tg[t];
    const float* qrow = g.queries + (size_t)qi * g.d;
    float* q = smem_f + g.q_off;
    float a = 0.f, b2 = 0.f;
    for (int k = tid; k < ((g.d + 3) & ~3); k += nt) {
      float v = k < g.d ? qrow[k] : 0.f;
      if (g.kind == kBqRow) {
        uint32_t u = __float_as_uint(v);
        if (k == g.d - 1) u &= g.last_word;
        a += static_cast<float>(__popc(u));
        q[k] = __uint_as_float(u);
        continue;
      }
      a += v;
      b2 += v * v;
      const bool round = g.kind != kRawRow ||
                         (g.round && (g.metric == kDot || g.metric == kCosine));
      q[k] = round ? bf16_round(v) : v;
    }
#pragma unroll
    for (int i = 0; i < kMtMaxTargets; ++i)
      if (i == t) {
        part[2 * i] = a;
        part[2 * i + 1] = b2;
      }
  }
#pragma unroll
  for (int i = 0; i < 2 * kMtMaxTargets; ++i) {
    float v = part[i];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    if (lane == 0) s_red[warp][i] = v;
  }
  __syncthreads();
  if (tid < 2 * T) {
    float v = 0.f;
    for (int w = 0; w < kW; ++w) v += s_red[w][tid];
    s_q[tid] = v;
  }
  // PQ: this CTA's slice of the query's ADC table (B2-PQ's `build_table`
  // sums), where the tables fit
  for (int t = 0; t < T; ++t) {
    const MtTarget& g = p.tg[t];
    if (g.kind != kPqRow || g.table_off < 0) continue;
    const float* q = smem_f + g.q_off;
    float* slice = smem_f + g.table_off;
    const int s0 = rank * g.table_per;
    const int ns = min(g.table_per, g.segs - s0);
    for (int e = tid; e < ns * g.centroids; e += nt) {
      const int s = s0 + e / g.centroids;
      const __nv_bfloat16* piece =
          g.cb + ((size_t)s0 * g.centroids + e) * g.dsub;
      float acc = 0.f;
      for (int j = 0; j < g.dsub; ++j)
        acc = fmaf(q[s * g.dsub + j], __bfloat162float(piece[j]), acc);
      slice[e] = acc;
    }
  }
  // one slot an id (`_mt_dedup`): the lowest slot of an id stays, so
  // every CTA lists the same members in the same order (the rank's ties go
  // to the lower id, the order of the sorted union); a slot compares its id
  // with every slot before it (the same id has the same presence, so the
  // earlier slot is the member), four at a time
  for (int u = tid; u < U; u += nt) {
    if (!valid[u]) continue;
    const int id = ids[u];
    int dup = 0;
#pragma unroll 4
    for (int j = 0; j < u; ++j) dup |= ids[j] == id;
    valid[u] = !dup;
  }
  __syncthreads();
  // the valid members (one warp's ballot scan)
  if (warp == 0) {
    int n = 0;
    for (int u0 = 0; u0 < U; u0 += 32) {
      const bool ok = valid[u0 + lane];
      const unsigned bal = __ballot_sync(kFull, ok);
      if (ok) vid[n + __popc(bal & ((1u << lane) - 1u))] = ids[u0 + lane];
      n += __popc(bal);
    }
    if (lane == 0) s_valid_n = n;
  }
  __syncthreads();
  const int vn = s_valid_n;
  // every CTA's table slices are built before any lookup
  mt_cluster_sync();

  // this CTA's slice of the members under every target, a group of `gw`
  // lanes a (member, target) pair: as wide as leaves a group for every
  // pair (all of them one round of loads), 4 to 32 lanes; the distance
  // stored in the first CTA
  {
    cg::cluster_group cluster = cg::this_cluster();
    float* dist0 = cluster.map_shared_rank(dist, 0);
    const int lo = (int)((long long)vn * rank / R);
    const int hi = (int)((long long)vn * (rank + 1) / R);
    const int pairs = (hi - lo) * T;
    int gw = 32;
    while (gw > 4 && (nt / gw) < pairs) gw >>= 1;
    const int groups = nt / gw, grp = tid / gw, gl = tid - grp * gw;
    for (int e0 = 0; e0 < pairs; e0 += groups) {
      const int e = e0 + grp;
      const bool live = e < pairs;
      const int m = live ? e / T : 0;
      const int t = live ? e - m * T : 0;
      const MtTarget& g = p.tg[t];
      const int id = live ? vid[lo + m] : 0;
      float acc = live ? mt_lane_sum(g, smem_f + g.q_off, smem_f, id, gl, gw)
                       : 0.f;
      for (int o = gw >> 1; o > 0; o >>= 1)
        acc += __shfl_xor_sync(kFull, acc, o, gw);
      if (live && gl == 0)
        dist0[t * U + lo + m] =
            mt_finish(g, acc, s_q[2 * t], s_q[2 * t + 1], id);
    }
  }
  // the distances in the first CTA; the others' tables read to the end
  mt_cluster_sync();
  if (rank != 0) return;

  // the join: relative takes each target's min and max over the members,
  // every target's at once
  if (p.join == kRelative) {
    float lo[kMtMaxTargets], hi[kMtMaxTargets];
#pragma unroll
    for (int i = 0; i < kMtMaxTargets; ++i) {
      lo[i] = kMask;
      hi[i] = -kInf;
    }
    for (int v = tid; v < vn; v += nt)
#pragma unroll
      for (int i = 0; i < kMtMaxTargets; ++i)
        if (i < T) {
          lo[i] = fminf(lo[i], dist[i * U + v]);
          hi[i] = fmaxf(hi[i], dist[i * U + v]);
        }
#pragma unroll
    for (int i = 0; i < kMtMaxTargets; ++i) {
      for (int o = 16; o > 0; o >>= 1) {
        lo[i] = fminf(lo[i], __shfl_xor_sync(kFull, lo[i], o));
        hi[i] = fmaxf(hi[i], __shfl_xor_sync(kFull, hi[i], o));
      }
      if (lane == 0) {
        s_red[warp][i] = lo[i];
        s_red[warp][kMtMaxTargets + i] = hi[i];
      }
    }
    __syncthreads();
    if (tid < T) {
      float l = kMask, h = -kInf;
      for (int w = 0; w < kW; ++w) {
        l = fminf(l, s_red[w][tid]);
        h = fmaxf(h, s_red[w][kMtMaxTargets + tid]);
      }
      s_lo[tid] = l;
      s_span[tid] = h - l > 0.f ? h - l : 1.f;
    }
    __syncthreads();
  }
  const float* w = s_w;
  for (int v = tid; v < vn; v += nt) {
    float c;
    if (p.join == kMinimum) {
      c = dist[v];
      for (int t = 1; t < T; ++t) c = fminf(c, dist[t * U + v]);
    } else if (p.join == kRelative) {
      c = 0.f;
      for (int t = 0; t < T; ++t)
        c += ((dist[t * U + v] - s_lo[t]) / s_span[t]) * w[t];
    } else {
      c = 0.f;
      for (int t = 0; t < T; ++t) c += dist[t * U + v] * w[t];
    }
    comb[v] = c;
  }
  __syncthreads();

  // each member's rank by counting: lower joined distance first, the
  // lower id (union order) on ties; a member counted by `g` lanes of a
  // warp (every g-th member each, the counts added by shuffles), so the
  // serial count, a chain of dependent loads, is vn / g long
  int* oid = p.out_ids + (size_t)qi * p.fetch;
  float* od = p.out_d + (size_t)qi * p.fetch;
  int g = 32;
  while (g > 1 && vn * g > nt) g >>= 1;
  for (int e0 = 0; e0 < vn * g; e0 += nt) {
    const int e = e0 + tid, i = e / g, sub = e - i * g;
    int rank_i = 0;
    float v = 0.f;
    int id = 0;
    if (i < vn) {
      v = comb[i];
      id = vid[i];
#pragma unroll 4
      for (int j = sub; j < vn; j += g) {
        const float x = comb[j];
        rank_i += (x < v) | ((x == v) & (vid[j] < id));
      }
    }
    for (int o = g >> 1; o > 0; o >>= 1)
      rank_i += __shfl_xor_sync(kFull, rank_i, o, g);
    if (i < vn && sub == 0 && rank_i < p.fetch) {
      const bool ok = v < kMask;
      oid[rank_i] = ok ? id : -1;
      od[rank_i] = ok ? v : kMask;
    }
  }
  for (int r = vn + tid; r < p.fetch; r += nt) {
    oid[r] = -1;
    od[r] = kMask;
  }
}

// each device's SMs and the dynamic shared memory a block of B7b can take
// (the opt-in limit less the kernel's static part), read once, with the
// kernel's limit raised to it once
struct MtDevice {
  int sms = 0, smem_max = 0;
  cudaError_t err = cudaSuccess;
  std::once_flag once;
};
MtDevice g_mt_devices[64];

cudaError_t mt_device_info(int dev, const MtDevice** out) {
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  MtDevice& g = g_mt_devices[dev];
  std::call_once(g.once, [&] {
    int optin = 0;
    g.err = cudaDeviceGetAttribute(&g.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (g.err == cudaSuccess)
      g.err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes fa;
    if (g.err == cudaSuccess)
      g.err = cudaFuncGetAttributes(&fa, (const void*)mt_join_kernel);
    if (g.err == cudaSuccess) {
      g.smem_max = optin - static_cast<int>(fa.sharedSizeBytes);
      g.err = cudaFuncSetAttribute((const void*)mt_join_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   g.smem_max);
    }
  });
  *out = &g;
  return g.err;
}

}  // namespace

extern "C" {

// Launches the fused walk of `b` queries on `stream`. `allow` null (or
// keep_k 0) runs the unfiltered walk, and kept_ids/kept_d are not written.
// `row_kind` 0 walks float32 rows [rows, d]; 1 BQ rows, `d` = ceil(dims /
// 32) words a row and a query, `row_aux` the rows' popcounts; 2 SQ rows, d
// uint8 codes a row, `row_aux` their decoded squared norms, `qaux` [b, 2]
// the queries' sums and sums of squares, `sq_a`/`sq_s` the decode (metric
// l2-squared, dot or cosine; queries rounded to bf16); 3 RQ rows, as SQ
// rows with each row's own `row_lo`/`row_step` [rows]; 4 PQ rows, `segs`
// codes a row into the bf16 codebooks `cb` [segs, centroids, dsub] (16-byte
// aligned; d = segs * dsub, the query's width), `row_aux` and `qaux` as SQ.
// Returns 0, a cudaError_t (> 0), or a negative code for arguments outside
// the kernel's contract (see device_beam_error_string).
int device_beam_search(const float* queries, const void* corpus,
                       const float* row_aux, const float* qaux,
                       const int* adj, const uint8_t* present,
                       const uint8_t* allow, const int* eps,
                       const int* upper_adj, const int* upper_slots,
                       uint32_t* visited, int* out_ids, float* out_d,
                       int* kept_ids, float* kept_d, int* stats, int b,
                       int rows, int n, int d, int m0, int levels, int s,
                       int m, int ef, int keep_k, int expand, int max_steps,
                       int metric, int bf16, int row_kind, int dims,
                       float sq_a, float sq_s, const float* row_lo,
                       const float* row_step, const void* cb, int segs,
                       int dsub, int centroids, void* stream) {
  if (b < 1 || rows < 1 || n < 1 || max_steps < 0 || levels < 0)
    return kBadShape;
  const bool coded = row_kind == kSqRow || row_kind == kRqRow ||
                     row_kind == kPqRow;
  if (row_kind < kRawRow || row_kind > kPqRow ||
      (row_kind != kRawRow && row_aux == nullptr) ||
      (coded && (qaux == nullptr || metric > kCosine)) ||
      (row_kind == kRqRow && (row_lo == nullptr || row_step == nullptr)) ||
      (row_kind == kPqRow &&
       (cb == nullptr || segs < 1 || dsub < 1 || centroids < 1 ||
        centroids > 256 || (long long)segs * dsub != d)) ||
      (row_kind == kBqRow && (dims < 1 || d != (dims + 31) / 32)))
    return kBadRow;
  if (row_kind == kPqRow && reinterpret_cast<uintptr_t>(cb) % 16)
    return kBadAlign;
  if (ef < 1 || ef > kMaxEf) return kBadEf;
  if (m0 < 1 || m0 > kMaxWidth ||
      (levels > 0 && (m < 1 || m > kMaxWidth || s < 1)))
    return kBadWidth;
  if (d < 1 || d > kMaxD) return kBadDims;
  const bool track = allow != nullptr && keep_k > 0;
  if (track && (keep_k > ef || kept_ids == nullptr || kept_d == nullptr))
    return kBadKeep;
  if (!track) {
    keep_k = 0;
    expand = 0;
    allow = nullptr;
  }
  if (expand < 0 || expand > m0 || m0 * (1 + expand) > kMaxFrontier)
    return kBadFrontier;
  const int state = warp_bytes_for(d, m0, levels > 0 ? m : 1, ef, keep_k,
                                   expand);
  int dev = 0, sms = 0, smem_max = 0, smem_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int frontier = m0 * (1 + expand) > (levels > 0 ? m : 1)
                           ? m0 * (1 + expand) : (levels > 0 ? m : 1);
  CodeLayout code;
  if (coded && !code_layout(row_kind == kPqRow ? segs : d, row_kind == kPqRow,
                            segs, dsub, centroids, frontier, state,
                            (b + sms - 1) / sms, smem_sm, smem_max, &code))
    return kBadSmem;
  const long long wb = state + (coded ? code.bytes(code.rows) : 0);
  if (wb > smem_max) return kBadSmem;
  Params p;
  p.queries = queries;
  p.corpus = corpus;
  p.row_aux = row_aux;
  p.qaux = qaux;
  p.sq_a = sq_a;
  p.sq_s = sq_s;
  p.row_lo = row_lo;
  p.row_step = row_step;
  p.cb = static_cast<const __nv_bfloat16*>(cb);
  p.segs = segs;
  p.dsub = dsub;
  p.centroids = centroids;
  p.metric = metric;
  p.last_word = row_kind == kBqRow && dims % 32 ? (1u << (dims % 32)) - 1u
                                                : kFull;
  p.adj = adj;
  p.present = present;
  p.allow = allow;
  p.eps = eps;
  p.upper_adj = upper_adj;
  p.upper_slots = upper_slots;
  p.visited = visited;
  p.out_ids = out_ids;
  p.out_d = out_d;
  p.kept_ids = kept_ids;
  p.kept_d = kept_d;
  p.stats = stats;
  p.rows = rows;
  p.n = n;
  p.d = d;
  p.m0 = m0;
  p.levels = levels;
  p.s = s;
  p.m = levels > 0 ? m : 1;
  p.ef = ef;
  p.keep_k = keep_k;
  p.expand = expand;
  p.max_steps = max_steps;
  p.words = (n + 31) / 32;
  p.group = group_for(d);
  p.frontier = frontier;
  p.b = b;
  p.warp_bytes = static_cast<int>(wb);
  p.stage_rows = code.rows;
  p.stage_pitch = code.pitch;
  p.piece_slot = code.piece_slot;
  p.table = code.table ? 1 : 0;
  p.sms = sms;
  p.smem_max = smem_max;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool round = bf16 != 0;
  if (row_kind == kBqRow) return static_cast<int>(launch<kL2, false, kBqRow>(p, st));
  if (row_kind == kSqRow) return static_cast<int>(launch<kL2, true, kSqRow>(p, st));
  if (row_kind == kRqRow) return static_cast<int>(launch<kL2, true, kRqRow>(p, st));
  if (row_kind == kPqRow) return static_cast<int>(launch<kL2, true, kPqRow>(p, st));
  switch (metric) {
    case kL2: e = launch<kL2, false>(p, st); break;
    case kDot:
      e = round ? launch<kDot, true>(p, st) : launch<kDot, false>(p, st);
      break;
    case kCosine:
      e = round ? launch<kCosine, true>(p, st) : launch<kCosine, false>(p, st);
      break;
    case kManhattan: e = launch<kManhattan, false>(p, st); break;
    case kHamming: e = launch<kHamming, false>(p, st); break;
    default: return kBadMetric;
  }
  return static_cast<int>(e);
}

// Launches B7b, the multi-target join, with the arguments packed in `call`
// as ops/device_beam.py packs them (one argument through ctypes): first
// an MtCall (kMtHeadBytes) of `weights` [b, targets], `out_ids` / `out_d`
// [b, fetch] and `stream`, then `targets`, `b`, `fetch`, `join` (0
// weighted, 1 minimum, 2 relative) and the plan of ops/device_beam.py
// `mt_join_plan`: `ranks` CTAs a query row (one cluster), bit t of
// `tables` set where PQ target t reads its ADC table from shared memory,
// `smem` bytes a CTA. For `b` query rows on `stream`, after the targets'
// walks. Then, for the `targets` targets (at most 8), eight 8-byte
// pointers each: its pool [b, pool_w] (the beam, or the kept track of a
// filtered walk), its queries [b, d] as its walk took them, its rows,
// row_aux, row_lo, row_step, PQ codebooks (bf16) and present [cap]; then
// eleven 4-byte ints each: pool_w, cap, rows, d, row_kind (B2's: 0 raw, 1
// BQ, 2 SQ, 3 RQ, 4 PQ), metric, bf16 rounding of raw dot/cosine, segs,
// dsub, centroids, BQ dims; then two 4-byte floats each: SQ's a and s.
// Writes out_ids / out_d [b, fetch]. Returns 0, a cudaError_t (> 0), or a
// negative code (see device_beam_error_string).
int mt_join_topk(const unsigned char* call) {
  struct MtCall {
    uint64_t weights, out_ids, out_d, stream;
    int32_t targets, b, fetch, join, ranks, tables, smem, pad;
  } a;
  memcpy(&a, call, kMtHeadBytes);
  const unsigned char* spec = call + kMtHeadBytes;
  const int targets = a.targets, b = a.b, fetch = a.fetch, join = a.join;
  const int ranks = a.ranks, tables = a.tables, smem = a.smem;
  const float* weights = reinterpret_cast<const float*>(a.weights);
  int* out_ids = reinterpret_cast<int*>(a.out_ids);
  float* out_d = reinterpret_cast<float*>(a.out_d);
  void* stream = reinterpret_cast<void*>(a.stream);
  if (b < 1 || targets < 1 || targets > kMtMaxTargets) return kBadShape;
  if (fetch < 1 || fetch > kMtMaxFetch || targets * fetch > kMtMaxUnion)
    return kBadEf;
  if (join < kWeighted || join > kRelative) return kBadMetric;
  if (ranks < 1 || ranks > kMtMaxCluster || (long long)b * ranks > 0x7fffffff)
    return kBadShape;
  MtParams p;
  int upad = 32;
  while (upad < targets * fetch) upad <<= 1;
  p.targets = targets;
  p.b = b;
  p.fetch = fetch;
  p.join = join;
  p.upad = upad;
  p.ranks = ranks;
  p.weights = weights;
  p.out_ids = out_ids;
  p.out_d = out_d;
  const unsigned char* ints_at = spec + 8 * 8 * targets;
  const unsigned char* floats_at = ints_at + 4 * 11 * targets;
  long long floats_used = 0;
  for (int t = 0; t < targets; ++t) {
    MtTarget& g = p.tg[t];
    uint64_t pp[8];
    int ii[11];
    float ff[2];
    memcpy(pp, spec + 8 * 8 * t, sizeof(pp));
    memcpy(ii, ints_at + 4 * 11 * t, sizeof(ii));
    memcpy(ff, floats_at + 4 * 2 * t, sizeof(ff));
    g.pool = reinterpret_cast<const int*>(pp[0]);
    g.queries = reinterpret_cast<const float*>(pp[1]);
    g.rows = reinterpret_cast<const void*>(pp[2]);
    g.row_aux = reinterpret_cast<const float*>(pp[3]);
    g.row_lo = reinterpret_cast<const float*>(pp[4]);
    g.row_step = reinterpret_cast<const float*>(pp[5]);
    g.cb = reinterpret_cast<const __nv_bfloat16*>(pp[6]);
    g.present = reinterpret_cast<const uint8_t*>(pp[7]);
    g.pool_w = ii[0];
    g.cap = ii[1];
    g.nrows = ii[2];
    g.d = ii[3];
    g.kind = ii[4];
    g.metric = ii[5];
    g.round = ii[6];
    g.segs = ii[7];
    g.dsub = ii[8];
    g.centroids = ii[9];
    const int dims = ii[10];
    g.sq_a = ff[0];
    g.sq_s = ff[1];
    g.last_word = g.kind == kBqRow && dims % 32 ? (1u << (dims % 32)) - 1u
                                                : kFull;
    const bool coded = g.kind == kSqRow || g.kind == kRqRow ||
                       g.kind == kPqRow;
    if (g.pool == nullptr || g.queries == nullptr || g.rows == nullptr ||
        g.present == nullptr || g.pool_w < fetch || g.cap < 1 ||
        g.nrows < 1 || g.d < 1 || g.d > kMaxD)
      return kBadShape;
    if (g.kind < kRawRow || g.kind > kPqRow ||
        (g.kind != kRawRow && g.row_aux == nullptr) ||
        (coded && g.metric > kCosine) || g.metric < kL2 ||
        g.metric > kHamming ||
        (g.kind == kRqRow && (g.row_lo == nullptr || g.row_step == nullptr)) ||
        (g.kind == kPqRow &&
         (g.cb == nullptr || g.segs < 1 || g.dsub < 1 || g.centroids < 1 ||
          g.centroids > 256 || (long long)g.segs * g.dsub != g.d)) ||
        (g.kind == kBqRow && (dims < 1 || g.d != (dims + 31) / 32)))
      return kBadRow;
    if (((tables >> t) & 1) && g.kind != kPqRow) return kBadRow;
    g.vec = g.kind == kRawRow && g.d % 4 == 0 &&
            reinterpret_cast<uintptr_t>(g.rows) % 16 == 0;
    g.q_off = static_cast<int>(floats_used);
    floats_used += (g.d + 3) & ~3;
    g.table_off = -1;
    g.table_per = g.segs > 0 ? g.segs : 1;
  }
  // PQ's table slices, `table_per` segments a CTA
  for (int t = 0; t < targets; ++t) {
    MtTarget& g = p.tg[t];
    if (!((tables >> t) & 1)) continue;
    g.table_per = (g.segs + ranks - 1) / ranks;
    g.table_off = static_cast<int>(floats_used);
    floats_used += ((long long)g.table_per * g.centroids + 3) & ~3LL;
  }
  const MtLayout l = mt_layout(upad, targets, floats_used);
  p.off_vidx = static_cast<int>(l.vidx);
  p.off_comb = static_cast<int>(l.comb);
  p.off_dist = static_cast<int>(l.dist);
  p.off_valid = static_cast<int>(l.valid);
  p.off_q = static_cast<int>(l.q);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const MtDevice* g = nullptr;
  if (e == cudaSuccess) e = mt_device_info(dev, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (l.tables > smem || smem > g->smem_max) return kBadSmem;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * ranks, 1, 1);
  cfg.blockDim = dim3(kMtThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ranks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, mt_join_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The card's SMs and the dynamic shared memory a block of B7b can take on
// device `dev` (what `mt_join_plan` of ops/device_beam.py sizes a launch
// for). Returns 0 or a cudaError_t.
int mt_join_device_info(int dev, int* sms, int* smem_max) {
  const MtDevice* g = nullptr;
  const cudaError_t e = mt_device_info(dev, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  *sms = g->sms;
  *smem_max = g->smem_max;
  return 0;
}

const char* device_beam_error_string(int code) {
  switch (code) {
    case kBadShape: return "b, rows, n >= 1, max_steps, levels >= 0 "
                           "required (the join: 1 to 8 targets, pools at "
                           "least fetch wide, D within [1, 4096], 1 to 8 "
                           "CTAs a query row)";
    case kBadEf: return "ef (or the join's fetch) outside [1, 512], or "
                        "targets x fetch above 4096";
    case kBadWidth: return "adjacency width outside [1, 128]";
    case kBadDims: return "D outside [1, 4096]";
    case kBadMetric: return "unknown metric or join code";
    case kBadKeep: return "keep_k above ef, or no kept outputs";
    case kBadFrontier: return "expand outside [0, M0] or M0 * (1 + expand) "
                              "above 640";
    case kBadSmem: return "one query's state exceeds the card's shared "
                          "memory a block (the join: its plan's shared "
                          "memory is below its layout or above the card's)";
    case kBadRow: return "row kind outside 0..4, a BQ row's words not "
                         "ceil(dims / 32), a code row's metric other than "
                         "l2-squared/dot/cosine, a missing aux array, or "
                         "PQ segments x sub-dimensions != d or centroids "
                         "outside [1, 256] (the join: or a table planned for "
                         "a target that is not PQ)";
    case kBadAlign: return "PQ codebooks not 16-byte aligned";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
