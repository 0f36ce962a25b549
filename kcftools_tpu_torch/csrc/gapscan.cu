// Window gap-run scan for Hopper (sm_90a): three front ends over one
// summary (gapsum.cuh's Sum).
//
// Replaces the XLA program kcftools_tpu/engine/device_prefix.py::_scan_core
// as kcftools_tpu/engine/device_join.py::_slab_scan runs it on the routed
// join counts, all slabs of a sample in one program (the JOIN mode), as
// device_prefix.py::_score_batch vmaps it over a group's presence bitmaps
// (the ROWS mode) and as device_prefix.py::_score_runs decodes a group's
// absent-run streams and vmaps it over the rows (the RUNS mode). For every
// window [w_start, w_hi] (inclusive k-mer start positions of one slab, in
// any order, overlapping or empty) and every row it writes the gap-run
// statistics of Plugins/GetVariants.java:219-273 as int64: observed,
// variations, inner, left, right and, in the JOIN mode, the count sum. A
// window with w_hi < w_start - 1 gets what the prefix differences of the
// plain version give (negated sums over [w_hi + 1, w_start - 1], the rest
// 0). Bounds outside the slab are clamped.
//
// The statistics of any range of positions follow from one summary that
// combines associatively (not commutatively, not invertibly). Presence is
// taken inside the valid bitmap.
//
// What bounds it: device memory. Each input byte read once and each output
// written once: in the JOIN mode the slot maps (4 B a position) and one
// 4-byte count per valid position, gathered at random from the routed
// counts (268 MB at the main path's 2^26 slots, over the 50 MB L2), so each
// gather really costs a 32-byte sector (the "sector floor"); in the ROWS
// mode the valid bitmap and the presence rows (n/8 B each); in the RUNS
// mode the run streams (2 B an entry) and the valid bitmap, plus the
// decoded absent bitmaps that this design writes and reads back (the
// "design floor"); 16 B of bounds and 40-48 B of output a window and row.
// Short of those bytes, the ROWS and RUNS modes are bound by instructions
// and their latency: folding one 4-byte word into a summary takes some 25,
// and each window and row ends in a chain of shuffles and combines.
//
// What the design does about it:
// - JOIN pass 1 (join_chunks): a warp per chunk of 1,024 positions and slab.
//   The warp stages the chunk's slot map in shared memory with 16-byte
//   streaming loads (evict-first, so they do not push routed sectors out
//   of L2), then each lane owns one 32-position word and issues kBatch
//   independent count gathers before it uses any, so the random sectors,
//   not latency, bound the pass. Each count is gathered exactly once. The
//   pass writes the slab's presence bitmap (n/8 B), one int64 count sum a
//   word (n/4 B) and the chunk summaries (40 B per 1,024 positions).
//   JOIN pass 2 (join_windows): one warp per window and slab combines the
//   partial head chunk, the whole chunks' summaries (32 a step, combined by
//   an ordered shuffle tree) and the partial tail chunk; only a window's
//   partial edge words (at most 2 x 31 positions, one position a lane) go
//   back to the slot map and the routed counts.
// - ROWS and RUNS: the work owned by windows, not by chunks; no chunk
//   summary is stored or read. Pass 1 (rows_short): a group of L lanes a
//   window and row, the rows of a window in adjacent groups (so their valid
//   loads coincide), L the least power of two up to 32 with which W x S x L
//   lanes fill every SM's threads, as the device reports them (one lane a
//   window and row when there are that many). The lanes of a group fold
//   contiguous stretches of the window's 16-byte quads (128 positions)
//   serially in registers, kBatchQuads quads of valid and presence words in
//   flight at once (fold_word: word_sum and combine in one, no shuffle a
//   word), then combine in log2 L ordered shuffle steps. A window of more
//   than kShortQuads quads (8,192 positions: the feature windows of -f
//   gene|transcript, up to a whole slab) goes to a list instead. Pass 2
//   (rows_long): persistent blocks (kLongBlocksPerSm an SM) take the listed
//   windows one at a time, a warp a row (or, for fewer than 8 rows, a row's
//   piece), its lanes' stretches combined by an ordered shuffle tree, so
//   windows of any length spread over the card. The repeats of a word (the
//   valid bitmap across rows, sliding windows) come from L1 and L2.
// - The RUNS decode turns the (S, 2, R) uint8 absent-run streams (delta
//   from the previous run's end with (255, 0) fillers, length with (0, 255)
//   continuations, zero padding) into an absent bitmap a row in three
//   launches that never wait on one another inside: runs_totals (a block
//   the total of a segment of kDecSeg entries),
//   runs_offsets (a block a row: the exclusive scan of its totals, and
//   the words where a span starts, or the stream ends, inside a word
//   zeroed) and runs_paint (a block a segment: its span of positions
//   painted into a window of words in shared memory, kDecWin a pass,
//   starts at or past n dropped and ends clamped to n; every word of the
//   span then written once, coalesced: the two words it may share with
//   another span or-ed, the rest stored; the words past the stream zeroed
//   in shares). So the bitmap needs no memset and no scattered store
//   reaches device memory. The window passes then read valid & ~absent:
//   no copy of the valid words is made.
//
// C entry points for ctypes (kcf_gapscan_join, kcf_gapscan_rows,
// kcf_gapscan_runs) return a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gapsum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;  // positions of a chunk: one 32-bit word a lane
constexpr int kStage = 33;    // staged slot-map words a lane (one of padding)
// count gathers a lane of JOIN pass 1 keeps in flight: its whole word (16
// ties with 32 on the card, 8 is slower)
constexpr int kBatch = 32;

// -- the JOIN mode ------------------------------------------------------

// the chunk summary as stored by pass 1 (40 bytes)
struct StoredSum {
  int nval, obs, lead, trail, var, pad;
  long long dist, csum;
};

struct Params {
  uint32_t* presence;        // (S, nw) words, written by pass 1
  long long* wsum;           // (S, nw) count sum of each word
  const uint32_t* routed;    // routed counts (uint32)
  long long n_routed;
  const int32_t* slot_map;   // (S, n) routed slot of each position
  const uint32_t* valid;     // (S, nw) LSB-first words
  const long long* w_start;  // (S, W) bounds
  const long long* w_hi;
  StoredSum* chunks;         // (S, n_chunks)
  long long* out;            // (S, 6, W)
  long long n, nw, n_chunks;
  int S, W, k;
  long long min_count;
};

// The count at position pos of a slab; a slot outside the routed counts
// reads as count 0.
__device__ __forceinline__ long long routed_count(const Params& p, int row,
                                                  long long pos) {
  const long long s = p.slot_map[(long long)row * p.n + pos];
  return (unsigned long long)s < (unsigned long long)p.n_routed
             ? (long long)__ldg(p.routed + s)
             : 0ll;
}

// The summary of positions [lo, hi] (lo <= hi) of one chunk and slab, from
// the presence words, the word count sums and the counts of the partial
// edge words; the result is lane 0's. Lane j takes word j of the chunk.
__device__ Sum chunk_range(const Params& p, int row, long long lo,
                           long long hi) {
  const int lane = threadIdx.x & 31;
  const long long base = lo - lo % kChunk;
  const int j0 = (int)((lo - base) >> 5);
  const int j1 = (int)((hi - base) >> 5);
  const long long word = (base >> 5) + lane;
  const long long at = (long long)row * p.nw + word;
  unsigned vw = 0u, pw = 0u, mask = 0u;
  long long csum = 0;
  if (lane >= j0 && lane <= j1) {
    mask = kFull;
    if (lane == j0) mask &= kFull << (lo & 31);
    if (lane == j1) mask &= kFull >> (31 - (hi & 31));
    vw = p.valid[at] & mask;
    pw = p.presence[at] & vw;
    if (mask == kFull) csum = p.wsum[at];
  }
  // the partial edge words' present positions, one position a lane
  const unsigned edge = mask != kFull ? pw : 0u;
  const unsigned e0 = __shfl_sync(kFull, edge, j0);
  const unsigned e1 = j1 != j0 ? __shfl_sync(kFull, edge, j1) : 0u;
  if ((e0 >> lane) & 1u) csum += routed_count(p, row, base + 32ll * j0 + lane);
  if ((e1 >> lane) & 1u) csum += routed_count(p, row, base + 32ll * j1 + lane);
  Sum s = word_sum(pw, vw, p.k);
  s.csum = csum;
  return warp_combine(s, p.k);
}

// JOIN pass 1: a warp per chunk and slab gathers each count once.
__global__ void __launch_bounds__(kThreads) join_chunks(Params p) {
  __shared__ int32_t stage[kWarps][32 * kStage];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + warp;
  if (item >= (long long)p.S * p.n_chunks) return;  // whole warps
  const int row = (int)(item / p.n_chunks);
  const long long lo = (item % p.n_chunks) * kChunk;
  const long long rem = (p.n - lo) >> 5;
  const int nwc = rem < 32 ? (int)rem : 32;  // words of this chunk
  int32_t* st = stage[warp];
  const int32_t* sm = p.slot_map + (long long)row * p.n + lo;
#pragma unroll
  for (int v = 0; v < kChunk / 128; ++v) {
    const int pos = 128 * v + 4 * lane;  // 16 B a lane, coalesced
    if (pos < 32 * nwc) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(sm + pos));
      int32_t* d = st + (pos >> 5) * kStage + (pos & 31);
      d[0] = q.x;
      d[1] = q.y;
      d[2] = q.z;
      d[3] = q.w;
    }
  }
  __syncwarp();
  const long long word = (lo >> 5) + lane;
  const unsigned vw = lane < nwc ? p.valid[row * p.nw + word] : 0u;
  const int32_t* mine = st + lane * kStage;
  unsigned pw = 0u;
  long long csum = 0;
#pragma unroll
  for (int t0 = 0; t0 < 32; t0 += kBatch) {
    uint32_t cnt[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {  // kBatch gathers in flight
      const long long s = mine[t0 + u];
      const bool live = ((vw >> (t0 + u)) & 1u) &&
                        (unsigned long long)s < (unsigned long long)p.n_routed;
      cnt[u] = live ? __ldg(p.routed + s) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      // unsigned count against a 64-bit min_count
      if (((vw >> (t0 + u)) & 1u) && (long long)cnt[u] >= p.min_count) {
        pw |= 1u << (t0 + u);
        csum += cnt[u];
      }
    }
  }
  if (lane < nwc) {
    p.presence[(long long)row * p.nw + word] = pw;
    p.wsum[(long long)row * p.nw + word] = csum;
  }
  Sum s = word_sum(pw, vw, p.k);
  s.csum = csum;
  s = warp_combine(s, p.k);
  if (lane == 0) {
    p.chunks[item] = {s.nval, s.obs, s.lead, s.trail, s.var, 0, s.dist,
                      s.csum};
  }
}

// JOIN pass 2: a warp per window and slab.
__global__ void __launch_bounds__(kThreads) join_windows(Params p) {
  const long long item =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= (long long)p.S * p.W) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int row = (int)(item / p.W);
  const int w = (int)(item % p.W);
  // bounds outside the slab are outside the contract: clamp, to stay in it
  long long s = p.w_start[(long long)row * p.W + w];
  long long h = p.w_hi[(long long)row * p.W + w];
  s = s < 0 ? 0 : (s > p.n ? p.n : s);
  h = h < -1 ? -1 : (h > p.n - 1 ? p.n - 1 : h);
  const bool neg = h < s - 1;
  const long long lo = neg ? h + 1 : s;
  const long long hi = neg ? s - 1 : h;
  Sum t = empty_sum();
  if (lo <= hi) {
    const long long c0 = lo / kChunk, c1 = hi / kChunk;
    if (c0 == c1) {
      t = chunk_range(p, row, lo, hi);
    } else {
      t = chunk_range(p, row, lo, c0 * kChunk + kChunk - 1);
      const StoredSum* cs = p.chunks + (long long)row * p.n_chunks;
      for (long long c = c0 + 1; c < c1; c += 32) {
        Sum x = empty_sum();
        if (c + lane < c1) {
          const StoredSum& y = cs[c + lane];
          x = {y.nval, y.obs, y.lead, y.trail, y.var, y.dist, y.csum};
        }
        x = warp_combine(x, p.k);
        t = combine(t, x, p.k);  // lane 0's is the one kept
      }
      t = combine(t, chunk_range(p, row, c1 * kChunk, hi), p.k);
    }
  }
  if (lane != 0) return;
  long long f[6];
  if (neg) {
    f[0] = -(long long)t.obs;
    f[1] = 0;
    f[2] = 0;
    f[3] = 0;
    f[4] = -(long long)t.nval;
    f[5] = -t.csum;
  } else {
    const bool has = t.obs > 0;
    f[0] = t.obs;
    f[1] = has ? (long long)t.var + (t.lead > 0) + (t.trail > 0)
               : (long long)(t.nval > 0);
    f[2] = t.dist;
    f[3] = has ? t.lead : 0;
    f[4] = has ? t.trail : t.nval;
    f[5] = t.csum;
  }
  long long* o = p.out + (long long)row * 6 * p.W + w;
#pragma unroll
  for (int i = 0; i < 6; ++i) o[i * p.W] = f[i];
}

// -- the ROWS and RUNS modes: windows -----------------------------------

constexpr int kRowWarps = 8;  // warps of a block of either pass
constexpr int kRowThreads = 32 * kRowWarps;
constexpr long long kShortQuads = 64;  // quads of a short window, at most
constexpr int kBatchQuads = 4;  // quads a lane loads at once
constexpr int kLongBlocksPerSm = 4;  // persistent blocks of the long pass

struct Rows {
  const uint32_t* bits;      // (S, stride) words: presence, or (RUNS) absent
  long long stride;          // words a row of bits
  const uint32_t* valid;     // nw words, one bitmap for every row
  const long long* w_start;  // W bounds, one list for every row
  const long long* w_hi;
  long long* out;            // (5, S, W)
  long long n, nw;
  int S, W, k;
  int vec;                   // 16-byte loads of both bitmaps
  int group;                 // pass 1: lanes a window and row
  int long_blocks;           // pass 2: persistent blocks
  int* long_count;           // [0] long windows, [1] the next to take
  int* long_list;            // (W,) the long windows, in any order
};

// Words 4q .. 4q + 3 of a bitmap; words at or past nw read 0.
__device__ __forceinline__ uint4 load_quad(const uint32_t* base, long long q,
                                           long long nw, int vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(base) + q);
  const long long w = 4 * q;
  return make_uint4(w < nw ? __ldg(base + w) : 0u,
                    w + 1 < nw ? __ldg(base + w + 1) : 0u,
                    w + 2 < nw ? __ldg(base + w + 2) : 0u,
                    w + 3 < nw ? __ldg(base + w + 3) : 0u);
}

// The bits of word wi inside positions [lo, hi].
__device__ __forceinline__ unsigned range_mask(long long wi, long long lo,
                                               long long hi) {
  const long long a = wi << 5;
  if (a > hi || a + 31 < lo) return 0u;
  unsigned m = kFull;
  if (a < lo) m &= kFull << (int)(lo - a);
  if (a + 31 > hi) m &= kFull >> (int)(a + 31 - hi);
  return m;
}

// Quad q of the valid bitmap, masked to positions [lo, hi].
__device__ __forceinline__ uint4 valid_quad(const Rows& p, long long q,
                                            long long lo, long long hi) {
  uint4 v = load_quad(p.valid, q, p.nw, p.vec);
  if (128 * q < lo || 128 * q + 127 > hi) {
    v.x &= range_mask(4 * q, lo, hi);
    v.y &= range_mask(4 * q + 1, lo, hi);
    v.z &= range_mask(4 * q + 2, lo, hi);
    v.w &= range_mask(4 * q + 3, lo, hi);
  }
  return v;
}

// a = combine(a, word_sum(pw, vw, k)) without building the word's
// summary: pw inside vw, both masked.
__device__ __forceinline__ void fold_word(Sum& a, unsigned pw, unsigned vw,
                                          int k) {
  const int nv = __popc(vw);
  if (pw == 0u) {
    a.nval += nv;
    a.trail += nv;
    if (a.obs == 0) a.lead = a.nval;
    return;
  }
  const int f = __ffs(pw) - 1;
  const int l = 31 - __clz(pw);
  const int lead = __popc(vw & ((1u << f) - 1u));
  if (a.obs) {
    const int g = a.trail + lead;
    if (g > 0) {
      a.var += 1;
      a.dist += gap_dist(g, k);
    }
  } else {
    a.lead = a.nval + lead;
  }
  // the word's own closed gaps, as word_sum walks them
  unsigned m = vw & ~pw & ((1u << l) - 1u) & ~((2u << f) - 1u);
  while (m) {
    const int q = __ffs(m) - 1;
    const int x = 31 - __clz(pw & ((1u << q) - 1u));
    const int y = __ffs(pw & ~((2u << q) - 1u)) - 1;
    a.var += 1;
    a.dist += gap_dist(__popc(vw & ((1u << y) - 1u) & ~((2u << x) - 1u)), k);
    m &= ~((1u << y) - 1u);
  }
  a.trail = __popc(vw & ~((2u << l) - 1u));  // 2u << 31 wraps to 0: none
  a.obs += __popc(pw);
  a.nval += nv;
}

// a, then the four words of a quad in order: v the masked valid words, x
// the row's presence (or, RUNS, absent) words.
template <bool RUNS>
__device__ __forceinline__ void fold_quad(Sum& a, uint4 v, uint4 x, int k) {
  fold_word(a, RUNS ? v.x & ~x.x : v.x & x.x, v.x, k);
  fold_word(a, RUNS ? v.y & ~x.y : v.y & x.y, v.y, k);
  fold_word(a, RUNS ? v.z & ~x.z : v.z & x.z, v.z, k);
  fold_word(a, RUNS ? v.w & ~x.w : v.w & x.w, v.w, k);
}

// The summaries of each group of L lanes (a power of two) combined in lane
// order; the result is the group's first lane's. Count sums left out.
__device__ __forceinline__ Sum group_fold(Sum s, int L, int k) {
  for (int o = 1; o < L; o <<= 1) {
    Sum y;
    y.nval = __shfl_down_sync(kFull, s.nval, o, L);
    y.obs = __shfl_down_sync(kFull, s.obs, o, L);
    y.lead = __shfl_down_sync(kFull, s.lead, o, L);
    y.trail = __shfl_down_sync(kFull, s.trail, o, L);
    y.var = __shfl_down_sync(kFull, s.var, o, L);
    y.dist = __shfl_down_sync(kFull, s.dist, o, L);
    y.csum = 0;
    s = combine(s, y, k);
  }
  return s;
}

__device__ __forceinline__ void store_row(const Rows& p, int row, int w,
                                          const Sum& t, bool neg) {
  long long f[5];
  if (neg) {
    f[0] = -(long long)t.obs;
    f[1] = 0;
    f[2] = 0;
    f[3] = 0;
    f[4] = -(long long)t.nval;
  } else {
    const bool has = t.obs > 0;
    f[0] = t.obs;
    f[1] = has ? (long long)t.var + (t.lead > 0) + (t.trail > 0)
               : (long long)(t.nval > 0);
    f[2] = t.dist;
    f[3] = has ? t.lead : 0;
    f[4] = has ? t.trail : t.nval;
  }
  long long* o = p.out + (long long)row * p.W + w;
  const long long field = (long long)p.S * p.W;
#pragma unroll
  for (int i = 0; i < 5; ++i) o[i * field] = f[i];
}

// Window w's positions [lo, hi] (lo <= hi: a window with w_hi < w_start - 1
// covers [w_hi + 1, w_start - 1] and is negated); bounds outside the slab
// are outside the contract: clamp, to stay in it.
__device__ __forceinline__ bool window_range(const Rows& p, int w,
                                             long long* lo, long long* hi) {
  long long s = p.w_start[w], h = p.w_hi[w];
  s = s < 0 ? 0 : (s > p.n ? p.n : s);
  h = h < -1 ? -1 : (h > p.n - 1 ? p.n - 1 : h);
  const bool neg = h < s - 1;
  *lo = neg ? h + 1 : s;
  *hi = neg ? s - 1 : h;
  return neg;
}

// acc, then quads [qb, qe) of one row folded in order, positions [lo, hi],
// kBatchQuads loads in flight at once.
template <bool RUNS>
__device__ __forceinline__ void fold_quads(const Rows& p, const uint32_t* row,
                                           long long qb, long long qe,
                                           long long lo, long long hi,
                                           Sum& acc) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (long long q = qb; q < qe; q += kBatchQuads) {
    uint4 v[kBatchQuads], x[kBatchQuads];
#pragma unroll
    for (int i = 0; i < kBatchQuads; ++i) {
      v[i] = q + i < qe ? valid_quad(p, q + i, lo, hi) : zero;
      x[i] = q + i < qe ? load_quad(row, q + i, p.nw, p.vec) : zero;
    }
#pragma unroll
    for (int i = 0; i < kBatchQuads; ++i) fold_quad<RUNS>(acc, v[i], x[i], p.k);
  }
}

// Pass 1: a group of p.group lanes (L, a power of two the host picks so
// that the card fills: W x S x L lanes) a window and row, the rows of a
// window in adjacent groups, so their valid loads coincide. The lanes of
// a group fold contiguous stretches of the window's quads serially and
// combine them in log2 L shuffle steps. A window of more than kShortQuads
// quads goes to the long list instead.
template <bool RUNS>
__global__ void __launch_bounds__(kRowThreads, 4) rows_short(Rows p) {
  const int lane = threadIdx.x & 31;
  const int L = p.group;
  const long long pair =
      ((long long)blockIdx.x * kRowThreads + threadIdx.x) / L;
  const long long w = pair / p.S;
  const int r = (int)(pair - w * p.S);
  long long lo = 0, hi = -1;
  bool neg = false;
  if (w < p.W) neg = window_range(p, (int)w, &lo, &hi);
  const long long q0 = lo >> 7;
  const long long q1 = lo <= hi ? (hi >> 7) + 1 : q0;
  const bool live = w < p.W && q1 - q0 <= kShortQuads;
  Sum acc = empty_sum();
  if (live) {
    const long long per = (q1 - q0 + L - 1) / L;
    const long long b = q0 + (lane & (L - 1)) * per;
    fold_quads<RUNS>(p, p.bits + (long long)r * p.stride, b,
                     b + per < q1 ? b + per : q1, lo, hi, acc);
  }
  acc = group_fold(acc, L, p.k);  // every lane: the shuffles are warp-wide
  if ((lane & (L - 1)) != 0 || w >= p.W) return;
  if (live) {
    store_row(p, r, (int)w, acc, neg);
  } else if (r == 0) {
    p.long_list[atomicAdd(p.long_count, 1)] = (int)w;
  }
}

// Quads [qb, qe) of one row, positions [lo, hi], by one warp: a lane a
// contiguous stretch, kBatchQuads of its loads in flight at once; the
// result is lane 0's.
template <bool RUNS>
__device__ Sum warp_stretch(const Rows& p, int r, long long qb, long long qe,
                            long long lo, long long hi) {
  const int lane = threadIdx.x & 31;
  const long long per = (qe - qb + 31) >> 5;
  const long long b = qb + lane * per;
  const long long e = b + per < qe ? b + per : qe;
  Sum acc = empty_sum();
  fold_quads<RUNS>(p, p.bits + (long long)r * p.stride, b, e, lo, hi, acc);
  return group_fold(acc, 32, p.k);
}

// Pass 2: persistent blocks take the long windows one at a time, a block a
// window: S x P tasks, a warp a task, each a row and one of P contiguous
// pieces of the window (P = 1 for kRowWarps rows or more, else kRowWarps /
// S), the pieces of a row then combined in order from shared memory.
template <bool RUNS>
__global__ void __launch_bounds__(kRowThreads, 4) rows_long(Rows p) {
  __shared__ int s_w;
  __shared__ Sum part[kRowWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = p.S >= kRowWarps ? 1 : kRowWarps / p.S;
  for (;;) {
    if (threadIdx.x == 0) {
      const int i = atomicAdd(p.long_count + 1, 1);
      s_w = i < p.long_count[0] ? p.long_list[i] : -1;
    }
    __syncthreads();
    const int w = s_w;
    if (w < 0) return;  // the whole block
    long long lo, hi;
    const bool neg = window_range(p, w, &lo, &hi);
    const long long q0 = lo >> 7, nq = (hi >> 7) - q0 + 1;
    const long long pq = (nq + P - 1) / P;
    for (int t = warp; t < p.S * P; t += kRowWarps) {
      const int r = t / P, j = t - r * P;
      const long long b = q0 + j * pq;
      const long long e = b + pq < q0 + nq ? b + pq : q0 + nq;
      const Sum x = warp_stretch<RUNS>(p, r, b, e, lo, hi);
      if (lane == 0) {
        if (P == 1) {
          store_row(p, r, w, x, neg);
        } else {
          part[t] = x;
        }
      }
    }
    if (P > 1) {
      __syncthreads();
      if (warp < p.S && lane == 0) {
        Sum t = part[warp * P];
        for (int j = 1; j < P; ++j) t = combine(t, part[warp * P + j], p.k);
        store_row(p, warp, w, t, neg);
      }
    }
    __syncthreads();  // s_w and part are refilled
  }
}

// -- the RUNS mode: the decode ------------------------------------------

constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
// run entries a thread: one 4-byte load (more a thread, with segments as
// many times longer, ran slower on an H100)
constexpr int kDecEntries = 4;
constexpr int kDecSeg = kDecThreads * kDecEntries;  // entries a segment
// the shared window of absent words: a segment's span in one pass at any
// realistic run density (1,024 entries of ~140 positions take ~4,500
// words), in several passes past it (fillers: up to 510 positions each)
constexpr int kDecWin = 8192;

struct Decode {
  const uint8_t* dl;   // (S, 2, R): deltas, then lengths
  long long R, n_seg, n, nw;
  long long* seg;      // (S, n_seg): segment totals, then their offsets
  long long* row_end;  // (S,): the end of each row's stream
  uint32_t* absent;    // (S, stride) words
  long long stride;
  int vec;             // 4-byte loads of the streams
};

// Inclusive prefix sum of v over the block's kDecThreads threads; *all
// gets the block's total.
__device__ long long dec_scan(long long v, long long* all) {
  __shared__ long long warp_tot[kDecWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  long long before = 0, total = 0;
#pragma unroll
  for (int i = 0; i < kDecWarps; ++i) {
    if (i < warp) before += warp_tot[i];
    total += warp_tot[i];
  }
  __syncthreads();  // warp_tot is free for the next call
  *all = total;
  return v + before;
}

// The 4 bytes from i0 of a stream, byte u in bits 8u (bytes at or past R
// read 0).
__device__ __forceinline__ unsigned load4(const uint8_t* s, long long i0,
                                          long long R, int vec) {
  if (vec && i0 < R) return __ldg(reinterpret_cast<const uint32_t*>(s + i0));
  unsigned w = 0u;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (i0 + u < R) w |= (unsigned)s[i0 + u] << (8 * u);
  }
  return w;
}

__device__ __forceinline__ int byte_at(unsigned w, int u) {
  return (w >> (8 * u)) & 0xff;
}

// A thread's entries of segment seg of a row (deltas, lengths: a byte
// each), and their delta + length.
__device__ __forceinline__ long long dec_entries(const Decode& r,
                                                 long long row, long long seg,
                                                 unsigned* d4, unsigned* l4) {
  const uint8_t* dp = r.dl + row * 2 * r.R;
  const long long i0 = seg * kDecSeg + (long long)threadIdx.x * kDecEntries;
  *d4 = load4(dp, i0, r.R, r.vec);
  *l4 = load4(dp + r.R, i0, r.R, r.vec);
  long long sum = 0;
#pragma unroll
  for (int u = 0; u < kDecEntries; ++u) sum += byte_at(*d4, u) + byte_at(*l4, u);
  return sum;
}

// grid S x n_seg: each segment's total of delta + length
__global__ void __launch_bounds__(kDecThreads) runs_totals(Decode r) {
  const long long row = blockIdx.x / r.n_seg, seg = blockIdx.x % r.n_seg;
  unsigned d4, l4;
  long long all;
  dec_scan(dec_entries(r, row, seg, &d4, &l4), &all);
  if (threadIdx.x == 0) r.seg[blockIdx.x] = all;
}

// grid S: a row's segment offsets (the exclusive scan of its totals, in
// place) and its stream's end; zeroes the words that two spans share (a
// span's start, or the stream's end, inside a word), which runs_paint
// or-s into.
__global__ void __launch_bounds__(kDecThreads) runs_offsets(Decode r) {
  long long* tot = r.seg + blockIdx.x * r.n_seg;
  uint32_t* out = r.absent + blockIdx.x * r.stride;
  long long carry = 0;
  for (long long b = 0; b < r.n_seg; b += kDecThreads) {
    const long long i = b + threadIdx.x;
    const long long v = i < r.n_seg ? tot[i] : 0;
    long long all;
    const long long off = carry + dec_scan(v, &all) - v;
    if (i < r.n_seg) {
      tot[i] = off;
      if (off < r.n && (off & 31)) out[off >> 5] = 0u;
    }
    carry += all;
  }
  if (threadIdx.x == 0) {
    r.row_end[blockIdx.x] = carry;
    if (carry < r.n && (carry & 31)) out[carry >> 5] = 0u;
  }
}

// Or the absent bits of a thread's runs (from pos, the end of the run
// before them) that fall in words [w0, w0 + kDecWin) into the window.
__device__ __forceinline__ void paint(uint32_t* win, long long w0,
                                      long long pos, unsigned d4,
                                      unsigned l4, long long n) {
  const long long w1 = w0 + kDecWin;
#pragma unroll
  for (int u = 0; u < kDecEntries; ++u) {
    const int len = byte_at(l4, u);
    pos += byte_at(d4, u) + len;
    const long long s = pos - len;
    if (len == 0 || s >= n) continue;
    const long long e = (pos < n ? pos : n) - 1;  // last absent position
    const long long a = (s >> 5) > w0 ? (s >> 5) : w0;
    const long long b = (e >> 5) < w1 - 1 ? (e >> 5) : w1 - 1;
    for (long long wi = a; wi <= b; ++wi) {
      atomicOr(win + (wi - w0), range_mask(wi, s, e));
    }
  }
}

// grid S x n_seg: a segment's span [P, E) of positions (clamped to n)
// painted into a shared window (kDecWin words a pass) and every word of
// it written once, coalesced: the words it shares with another span (P or
// E inside a word) or-ed, the rest stored. The segments also share out the
// zeroing of the words past the row's stream.
__global__ void __launch_bounds__(kDecThreads) runs_paint(Decode r) {
  __shared__ uint32_t win[kDecWin];
  const long long row = blockIdx.x / r.n_seg, seg = blockIdx.x % r.n_seg;
  unsigned d4, l4;
  const long long mine = dec_entries(r, row, seg, &d4, &l4);
  long long all;
  const long long incl = dec_scan(mine, &all);
  const long long off = r.seg[blockIdx.x];
  const long long P = off < r.n ? off : r.n;
  const long long E = off + all < r.n ? off + all : r.n;
  const long long wbase = P >> 5;
  const long long nwords = E > P ? ((E - 1) >> 5) - wbase + 1 : 0;
  uint32_t* out = r.absent + row * r.stride;
  for (long long c0 = 0; c0 < nwords; c0 += kDecWin) {
    const int cn = (int)(nwords - c0 < kDecWin ? nwords - c0 : kDecWin);
    for (int i = threadIdx.x; i < cn; i += kDecThreads) win[i] = 0u;
    __syncthreads();
    paint(win, wbase + c0, off + incl - mine, d4, l4, r.n);
    __syncthreads();
    for (int i = threadIdx.x; i < cn; i += kDecThreads) {
      const long long at = c0 + i;  // the word's index in the span
      if ((at == 0 && (P & 31)) || (at == nwords - 1 && (E & 31))) {
        atomicOr(out + wbase + at, win[i]);
      } else {
        out[wbase + at] = win[i];
      }
    }
    __syncthreads();  // the window is refilled
  }
  // this segment's share of the words past the stream
  const long long end = r.row_end[row];
  const long long z0 = ((end < r.n ? end : r.n) + 31) >> 5;
  const long long each = (r.nw - z0 + r.n_seg - 1) / r.n_seg;
  const long long a = z0 + seg * each;
  const long long b = a + each < r.nw ? a + each : r.nw;
  for (long long w = a + threadIdx.x; w < b; w += kDecThreads) out[w] = 0u;
}

// -- launches -----------------------------------------------------------

unsigned blocks_of(long long items, int per_block) {
  return (unsigned)((items + per_block - 1) / per_block);
}

cudaError_t make_rows(Rows& p, const void* bits, long long stride,
                      const void* valid, const void* w_start, const void* w_hi,
                      void* out, long long n, int S, int W, int k) {
  int dev = 0, sms = 0, sm_threads = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sm_threads,
                               cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (err != cudaSuccess) return err;
  p.bits = static_cast<const uint32_t*>(bits);
  p.stride = stride;
  p.valid = static_cast<const uint32_t*>(valid);
  p.w_start = static_cast<const long long*>(w_start);
  p.w_hi = static_cast<const long long*>(w_hi);
  p.out = static_cast<long long*>(out);
  p.n = n;
  p.nw = n >> 5;
  p.S = S;
  p.W = W;
  p.k = k;
  p.vec = p.nw % 4 == 0 && stride % 4 == 0 && (uintptr_t)bits % 16 == 0 &&
          (uintptr_t)valid % 16 == 0;
  // lanes a window and row in pass 1: enough (window, row, lane) items to
  // fill every SM's threads (on the H100, 132 x 2,048), one lane a window
  // and row when there are that many
  const long long fill = (long long)sms * sm_threads;
  p.group = 1;
  while (p.group < 32 && (long long)W * S * p.group < fill) p.group <<= 1;
  p.long_blocks = kLongBlocksPerSm * sms;
  p.long_count = nullptr;
  p.long_list = nullptr;
  return cudaSuccess;
}

// The two window passes (the long list's counters zeroed first).
template <bool RUNS>
cudaError_t launch_windows(const Rows& p, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(p.long_count, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return err;
  rows_short<RUNS><<<blocks_of((long long)p.W * p.S * p.group, kRowThreads),
                     kRowThreads, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int grid = p.W < p.long_blocks ? p.W : p.long_blocks;
  rows_long<RUNS><<<grid, kRowThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// JOIN mode over S slabs: slot_maps (S, n) int32 into routed (n_routed
// uint32 counts), valid (S, n/8) bytes, w_start / w_hi (S, W) int64.
// Scratch: presence (S, n/8) bytes, wsum (S, n/32) int64, chunks
// S * ceil(n / 1024) * 40 bytes. out: (S, 6, W) int64. n a multiple of 32,
// the slot maps 16-byte and the bitmaps 4-byte aligned.
extern "C" int kcf_gapscan_join(const void* routed, long long n_routed,
                                const void* slot_maps, const void* valid,
                                const void* w_start, const void* w_hi,
                                void* presence, void* wsum, void* chunks,
                                void* out, long long n, int S, int W, int k,
                                long long min_count, void* stream) {
  Params p = {};
  p.presence = static_cast<uint32_t*>(presence);
  p.wsum = static_cast<long long*>(wsum);
  p.routed = static_cast<const uint32_t*>(routed);
  p.n_routed = n_routed;
  p.slot_map = static_cast<const int32_t*>(slot_maps);
  p.valid = static_cast<const uint32_t*>(valid);
  p.w_start = static_cast<const long long*>(w_start);
  p.w_hi = static_cast<const long long*>(w_hi);
  p.chunks = static_cast<StoredSum*>(chunks);
  p.out = static_cast<long long*>(out);
  p.n = n;
  p.nw = n >> 5;
  p.n_chunks = (n + kChunk - 1) / kChunk;
  p.S = S;
  p.W = W;
  p.k = k;
  p.min_count = min_count;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long items = (long long)S * p.n_chunks;
  if (items > 0) {
    join_chunks<<<blocks_of(items, kWarps), kThreads, 0, st>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((long long)S * W > 0) {
    join_windows<<<blocks_of((long long)S * W, kWarps), kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// ROWS mode: presence (S, n/8) bytes, one valid bitmap (n/8 bytes) and one
// window list (W) for every row. scratch: W + 2 int32 (the long windows'
// list and two counters, zeroed here on the stream). out: (5, S, W) int64.
// n a multiple of 32, the bitmaps 4-byte aligned (16-byte loads where both
// are 16-byte aligned and n is a multiple of 128).
extern "C" int kcf_gapscan_rows(const void* presence, const void* valid,
                                const void* w_start, const void* w_hi,
                                void* scratch, void* out, long long n, int S,
                                int W, int k, void* stream) {
  Rows p;
  const cudaError_t err = make_rows(p, presence, n >> 5, valid, w_start,
                                    w_hi, out, n, S, W, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((long long)S * W == 0) return 0;
  p.long_count = static_cast<int*>(scratch);
  p.long_list = p.long_count + 2;
  return static_cast<int>(
      launch_windows<false>(p, static_cast<cudaStream_t>(stream)));
}

// RUNS mode: dl (S, 2, R) uint8 absent-run streams, decoded into absent
// bitmaps, then scanned as the ROWS mode scans presence (valid & ~absent).
// scratch: S * stride uint32 absent words (stride = n/32 rounded up to a
// multiple of 4), S * max(1, ceil(R / 1024)) + S int64 segment offsets and
// row ends, then the ROWS mode's W + 2 int32. Otherwise as
// kcf_gapscan_rows.
extern "C" int kcf_gapscan_runs(const void* dl, long long R,
                                const void* valid, const void* w_start,
                                const void* w_hi, void* scratch, void* out,
                                long long n, int S, int W, int k,
                                void* stream) {
  const long long stride = ((n >> 5) + 3) / 4 * 4;
  Rows p;
  cudaError_t err = make_rows(p, scratch, stride, valid, w_start, w_hi, out,
                              n, S, W, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((long long)S * W == 0) return 0;
  Decode r;
  r.dl = static_cast<const uint8_t*>(dl);
  r.R = R;
  r.n_seg = R > 0 ? (R + kDecSeg - 1) / kDecSeg : 1;
  r.n = n;
  r.nw = n >> 5;
  r.absent = static_cast<uint32_t*>(scratch);
  r.stride = stride;
  r.seg = reinterpret_cast<long long*>(r.absent + S * stride);
  r.row_end = r.seg + S * r.n_seg;
  r.vec = R % 4 == 0 && (uintptr_t)dl % 4 == 0;
  p.long_count = reinterpret_cast<int*>(r.row_end + S);
  p.long_list = p.long_count + 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)(S * r.n_seg);
  runs_totals<<<grid, kDecThreads, 0, st>>>(r);
  runs_offsets<<<(unsigned)S, kDecThreads, 0, st>>>(r);
  runs_paint<<<grid, kDecThreads, 0, st>>>(r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_windows<true>(p, st));
}
