// The on-chip hash engine's window scoring for Hopper (sm_90a): the k-mer
// probe (kcf_hash_probe) and the per-window gap-run scan (kcf_hash_scan).
//
// Replaces the XLA program of kcftools_tpu/engine/pipeline.py::
// score_windows_core (:46) as the hash engine runs it (getVariations
// -f gene|transcript --engine device, and every hash-engine run on a mesh):
// kcftools_tpu/ops/kmerize.py (:29-69) with ops/lookup.py::table_lookup
// (:36-61), on a mesh parallel/sharded.py::_sharded_lookup (:33-75), become
// the probe; gap_scan_core (:192-253) with the count sum of
// score_windows_core (:76-86) become the scan.
//
// A row is one window: Lp sentinel-coded bytes (0..3 a base, any other
// byte invalid) and its length win_len. k-mer start i < n_out = Lp - 32 is
// valid when its k bytes are all bases and i <= win_len - k (1 <= k <= 32).
//
// kcf_hash_probe writes the uint32 count of every valid k-mer, 0 elsewhere,
// and issues no probe where a k-mer is invalid (N runs, the padding past a
// window). The k-mer is one 64-bit value f (forward, big-endian) or r (its
// reverse complement); the canonical one is min(f, r), which is the
// lexicographic minimum of the (hi, lo) halves. hi is its first min(k, 16)
// bases, lo the k - 16 after them (0 for k <= 16); the 64-bit shifts keep
// k = 16 and k = 32 defined. The two seeded fmix32 hashes in plain uint32
// arithmetic (engine/hashtable.py::bucket_hashes_np) give the buckets h1 and
// b2 = (h1 & ~lm) | (h2 & lm) of an nb_total-bucket table, of which this
// table holds [shard * nb, (shard + 1) * nb) (lm = nb - 1; with one shard
// b2 = h2). A bucket outside the shard is not probed, b2 == h1 is probed
// once, and every matching slot of both rows adds its count, wrapping in
// uint32 like the JAX sums (a key may sit in both of its buckets, so there
// is no early exit).
//
// kcf_hash_scan writes per row, as int64 (8, B) in FIELDS order: total,
// observed, variations, inner, left, right (gapsum.cuh's Sum over the valid
// k-mers, present where the uint32 count >= min_count), count_sum (the
// exact sum of the present counts) and eff_length (the ACGT runs of at
// least k bases over the whole row). eff_length needs no run state: a run
// of L >= k bases holds L - k + 1 starts whose k bases are all valid, one
// of them right after an invalid byte (or at 0), so it is the count of such
// starts plus k - 1 per run start.
//
// What bounds them: device memory. The probe reads 1 B a position, writes
// 4 B a k-mer start and gathers one 48-byte bucket row a probe from a table
// far over the 50 MB L2 (805 MB at 2^24 buckets), so each row costs two
// 32-byte sectors (the sector floor: 64 B a probed row) at the card's rate
// for random rows. The scan reads the bytes and the counts once (~5 B a
// position) and writes 64 B a row: 13.5 MB at a gene batch, less than a
// launch's latency, so its latency chain sets its time.
//
// What the design does about it:
// - Probe: a warp a warp tile of 32 x kStretch consecutive starts of a
//   row, a lane a stretch; the grid covers every tile, so the card's block
//   scheduler balances tiles of padding, N runs and k-mers. A warp stages
//   its tile's bytes (with the k - 1 after it, in aligned 16-byte
//   granules) into its shared buffer by cp.async, with no block barrier. A
//   lane builds its stretch's k-mers by rolling: k - 1 bytes of prologue,
//   then one base shifted into f and r a start, and a count of consecutive
//   bases that resets at any byte >= 4 (a start is a k-mer where it reaches
//   k). The loads of both bucket rows of the next start (three 16-byte
//   loads each) issue before the current start's rows are compared: two
//   starts' rows in flight a lane. Counts leave as 16-byte stores. The
//   random rows bound it: on an H100 longer stretches, a persistent grid
//   walking tiles, cache hints and loading a row's counts only on a match
//   were all slower (PERF.md §6).
// - Scan: one launch. A block of up to kScanWarps warps scores a span of
//   consecutive 1,024-position chunks of one row, a warp a chunk. A lane
//   reads its 32 bytes as 16-byte granules and turns them into an invalid-
//   bit word with byte compares; a lane's valid k-mer starts are the zero
//   bits of the OR of k shifts of its word and the next (doubling shifts);
//   the counts arrive as coalesced 16-byte loads wherever one of their four
//   starts is a valid k-mer, and presence words are assembled by shuffles.
//   word_sum and the ordered shuffle tree give the chunk's summary, warp 0
//   combines the block's chunks in order. A row of one block writes its
//   fields at once; a row spanning several blocks has each block store its
//   summary (40 B), and the block that draws the row's last ticket (an
//   atomic count per row, after __threadfence) combines the row's summaries
//   in position order (combine is associative, not commutative). The
//   tickets live in the call's scratch and are zeroed by a memset on the
//   call's stream before the launch, so back-to-back calls and calls on
//   other streams never share them.
//
// C entry points for ctypes (kcf_hash_probe, kcf_hash_scan) return a
// cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gapsum.cuh"

namespace {

constexpr long long kMaxGrid = 1ll << 20;

// -- the probe ----------------------------------------------------------------

constexpr int kProbeThreads = 256;
constexpr int kProbeWarps = kProbeThreads / 32;
constexpr int kStretch = 4;               // consecutive starts a lane owns
constexpr int kWarpTile = 32 * kStretch;  // starts a warp tile holds
static_assert(kStretch % 4 == 0, "counts leave in fours");
// a warp tile's bytes in whole 16-byte granules: up to 15 before it (the
// alignment of its first byte), the tile and the k - 1 <= 31 after it
constexpr int kStage = kWarpTile + 48;

struct Probe {
  const uint8_t* rows;        // (B, Lp)
  const long long* win_len;   // (B,)
  const uint4* tbl;           // (nb, 12) uint32: three 16-byte loads a row
  uint32_t* out;              // (B, n_out)
  long long Lp, n_out, wtiles, n_wtiles;  // warp tiles: per row, in all
  unsigned long long kmask;   // the low 2k bits
  uint32_t nb, lm, mask, base;  // mask = nb_total - 1, base = shard * nb
  int k, both, vec;           // vec: 16-byte stores of the counts
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The counts of the slots of one bucket row that hold (hi, lo); an empty
// slot has count 0 and adds nothing.
__device__ __forceinline__ uint32_t row_sum(const uint4 (&t)[3], uint32_t hi,
                                            uint32_t lo) {
  return (t[0].x == hi && t[1].x == lo ? t[2].x : 0u) +
         (t[0].y == hi && t[1].y == lo ? t[2].y : 0u) +
         (t[0].z == hi && t[1].z == lo ? t[2].z : 0u) +
         (t[0].w == hi && t[1].w == lo ? t[2].w : 0u);
}

// one start's probe in flight: its key halves and both bucket rows
struct Req {
  uint4 a[3], b[3];
  uint32_t hi, lo;
  bool o1, o2;
};

__device__ __forceinline__ void issue(const Probe& p, unsigned long long key,
                                      bool live, Req& q) {
  const int n_lo = p.k > 16 ? p.k - 16 : 0;
  q.hi = (uint32_t)(key >> (2 * n_lo));
  q.lo = (uint32_t)(key & ((1ull << (2 * n_lo)) - 1ull));
  const uint32_t h1 =
      fmix32(q.hi * 0x9E3779B1u + q.lo * 0x85EBCA77u + 0xA5A5A5A5u) & p.mask;
  const uint32_t h2 =
      fmix32(q.hi * 0xC2B2AE3Du + q.lo * 0x27D4EB2Fu + 0x3C6EF372u) & p.mask;
  const uint32_t b2 = (h1 & ~p.lm) | (h2 & p.lm);
  const uint32_t l1 = h1 - p.base, l2 = b2 - p.base;  // wraps: a range test
  q.o1 = live && l1 < p.nb;
  q.o2 = live && b2 != h1 && l2 < p.nb;
  if (q.o1) {
#pragma unroll
    for (int u = 0; u < 3; ++u) q.a[u] = __ldg(p.tbl + 3ull * l1 + u);
  }
  if (q.o2) {
#pragma unroll
    for (int u = 0; u < 3; ++u) q.b[u] = __ldg(p.tbl + 3ull * l2 + u);
  }
}

__device__ __forceinline__ uint32_t finish(const Req& q) {
  return (q.o1 ? row_sum(q.a, q.hi, q.lo) : 0u) +
         (q.o2 ? row_sum(q.b, q.hi, q.lo) : 0u);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

// commits this thread's copies and waits for them all
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

struct Tile {
  long long row, lo, last;  // last: the row's last valid start
  int off;                  // the tile's first byte in its staged granules
};

__device__ __forceinline__ Tile tile_of(const Probe& p, long long t) {
  Tile x;
  x.row = t / p.wtiles;
  x.lo = (t - x.row * p.wtiles) * kWarpTile;
  x.last = p.win_len[x.row] - p.k;
  x.off = (int)((uintptr_t)(p.rows + x.row * p.Lp + x.lo) & 15);
  return x;
}

// Copies a tile's granules into buf; nothing for a tile of padding. A
// granule that starts past the row is not read (it holds no byte a start
// below n_out needs); one that starts inside it lies in the allocation.
__device__ __forceinline__ void stage(const Probe& p, const Tile& x,
                                      uint8_t* buf, int lane) {
  if (x.last < x.lo) return;
  const uint8_t* row = p.rows + x.row * p.Lp;
  const uint8_t* g0 = row + x.lo - x.off;  // 16-byte aligned
  for (int g = lane; g < kStage / 16; g += 32) {
    const uint8_t* src = g0 + 16 * g;
    const bool in = src < row + p.Lp;
    cp_async16(buf + 16 * g, in ? src : g0, in ? 16 : 0);
  }
}

__device__ __forceinline__ void store4(uint32_t* out, const uint32_t (&c)[4],
                                       bool vec, int n, int j) {
  if (vec) {
    *reinterpret_cast<uint4*>(out + j) = make_uint4(c[0], c[1], c[2], c[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (j + e < n) out[j + e] = c[e];
    }
  }
}

// A lane's stretch of a staged tile: kStretch starts from s0, their counts
// written to the row's output.
__device__ __forceinline__ void probe_stretch(const Probe& p, const Tile& x,
                                              const uint8_t* buf, int lane) {
  const long long s0 = x.lo + (long long)lane * kStretch;
  const long long left = p.n_out - s0;
  if (left <= 0) return;
  const int n = left < kStretch ? (int)left : kStretch;
  const bool vec = p.vec && n == kStretch;
  uint32_t* out = p.out + x.row * p.n_out + s0;
  if (x.last < s0) {  // no valid start: zeros, no byte read
    const uint32_t z[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < kStretch; j += 4) store4(out, z, vec, n, j);
    return;
  }
  const uint8_t* src = buf + x.off + lane * kStretch;
  const int up = 2 * (p.k - 1);
  unsigned long long f = 0ull, r = 0ull;
  int run = 0;  // consecutive bases up to the byte last shifted in
  for (int u = 0; u < p.k - 1; ++u) {
    const unsigned c = src[u];
    run = c < 4u ? run + 1 : 0;
    f = ((f << 2) | (c & 3u)) & p.kmask;
    r = (r >> 2) | ((unsigned long long)(~c & 3u) << up);  // 3 - c
  }
  src += p.k - 1;
  Req q[2];
  uint32_t c4[4];
#pragma unroll
  for (int j = 0; j <= kStretch; ++j) {
    if (j < kStretch) {
      const unsigned c = src[j];
      run = c < 4u ? run + 1 : 0;
      f = ((f << 2) | (c & 3u)) & p.kmask;
      r = (r >> 2) | ((unsigned long long)(~c & 3u) << up);
      const bool live = run >= p.k && s0 + j <= x.last && j < n;
      issue(p, p.both && r < f ? r : f, live, q[j & 1]);
    }
    if (j > 0) {  // the previous start's rows, loaded while this one's issue
      const int i = j - 1;
      c4[i & 3] = finish(q[i & 1]);
      if ((i & 3) == 3) store4(out, c4, vec, n, i - 3);
    }
  }
}

__global__ void __launch_bounds__(kProbeThreads) hash_probe(Probe p) {
  __shared__ __align__(16) uint8_t stage_buf[kProbeWarps][kStage];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long nw = (long long)gridDim.x * kProbeWarps;
  // whole warps; no block barrier follows
  for (long long t = (long long)blockIdx.x * kProbeWarps + w; t < p.n_wtiles;
       t += nw) {
    const Tile x = tile_of(p, t);
    stage(p, x, stage_buf[w], lane);
    cp_async_wait_all();
    __syncwarp();  // every lane's granules have landed
    probe_stretch(p, x, stage_buf[w], lane);
    __syncwarp();  // read before the warp's next tile refills it
  }
}

// -- the scan -----------------------------------------------------------------

constexpr int kChunk = 1024;  // positions of a scan chunk: a word a lane
constexpr int kScanWarps = 16;  // chunks a block spans at most

// a block's summary as a row of several blocks stores it (40 bytes)
struct BlockSum {
  int nval, obs, lead, trail, var, eff;
  long long dist, csum;
};

struct Scan {
  const uint8_t* rows;       // (B, Lp)
  const uint32_t* counts;    // (B, n_out)
  const long long* win_len;  // (B,)
  BlockSum* sums;            // (B, bpr), rows of several blocks only
  int* tickets;              // (B,), zeroed before the launch
  long long* out;            // (8, B)
  long long B, Lp, n_out, n_chunks, bpr, n_items;  // bpr: blocks a row
  long long min_count;
  int k, wpb, vec;  // wpb: warps a block; vec: 16-byte count loads
};

// the invalid bits (byte >= 4) of 4 bytes, byte 0 in bit 0
__device__ __forceinline__ unsigned inv4(unsigned x) {
  const unsigned m = __vcmpgeu4(x, 0x04040404u);  // 0xff a byte >= 4
  return ((m & 0x80808080u) * 0x00204081u) >> 28;  // top bits gathered
}

__device__ __forceinline__ unsigned inv16(uint4 v) {
  return inv4(v.x) | inv4(v.y) << 4 | inv4(v.z) << 8 | inv4(v.w) << 12;
}

// The invalid bits of the 32 bytes of a row from pos; bytes past the row
// are invalid. The bytes arrive as the aligned 16-byte granules that hold
// them; a granule that starts past the row is not read.
__device__ __forceinline__ unsigned inv_word(const uint8_t* row,
                                             long long pos, long long Lp) {
  if (pos >= Lp) return kFull;
  const uint8_t* a = row + pos;
  const int off = (int)((uintptr_t)a & 15);
  const uint4* g = reinterpret_cast<const uint4*>(a - off);
  const uint8_t* end = row + Lp;
  unsigned long long m = inv16(__ldg(g));
  m |= (unsigned long long)(reinterpret_cast<const uint8_t*>(g + 1) < end
                                ? inv16(__ldg(g + 1))
                                : 0xFFFFu)
       << 16;
  if (off) {
    m |= (unsigned long long)(reinterpret_cast<const uint8_t*>(g + 2) < end
                                  ? inv16(__ldg(g + 2))
                                  : 0xFFFFu)
         << 32;
  }
  unsigned inv = (unsigned)(m >> off);
  const long long left = Lp - pos;
  if (left < 32) inv |= kFull << left;
  return inv;
}

// One warp's chunk of a row from lo: its summary (lane 0's) and eff.
__device__ __forceinline__ void chunk_sum(const Scan& p, long long row,
                                          long long lo, int lane, Sum& s,
                                          int& eff) {
  const uint8_t* src = p.rows + row * p.Lp;
  const unsigned inv = inv_word(src, lo + 32ll * lane, p.Lp);
  // the word after (the k - 1 halo) and the byte before each word (before
  // position 0: invalid)
  unsigned inv_next = __shfl_down_sync(kFull, inv, 1);
  if (lane == 31) inv_next = inv_word(src, lo + kChunk, p.Lp);
  unsigned before = __shfl_up_sync(kFull, inv, 1) >> 31;
  if (lane == 0) before = lo == 0 || src[lo - 1] >= 4;
  // starts whose k bytes are bases: the AND of k shifts of the valid bits,
  // by doubling (f(2n) = f(n) & f(n) >> n)
  unsigned long long v = ~(((unsigned long long)inv_next << 32) | inv);
  unsigned long long acc = ~0ull;
  int at = 0;
  for (int b = 1; b <= p.k; b <<= 1) {
    if (p.k & b) {
      acc &= v >> at;
      at += b;
    }
    v &= v >> b;
  }
  const unsigned av = (unsigned)acc;
  const unsigned run_starts = av & ((inv << 1) | before);
  eff = __popc(av) + (p.k - 1) * __popc(run_starts);
  // valid k-mers: below n_out and at most win_len - k
  const long long lim_a = p.n_out - 1, lim_b = p.win_len[row] - p.k;
  const long long d = (lim_a < lim_b ? lim_a : lim_b) - (lo + 32ll * lane);
  const unsigned kv =
      av & (d >= 31 ? kFull : (d >= 0 ? (2u << d) - 1u : 0u));
  // presence from the counts of the valid k-mers, read once: in step j a
  // lane reads the four counts at 128 j + 4 lane (word 4 j + lane / 8) where
  // one of them is a valid k-mer; the nibbles of a word are gathered by
  // shuffles, and its owner (lane 4 j + lane / 8) keeps it
  const uint32_t* cnt = p.counts + row * p.n_out + lo;
  const int sh = 4 * (lane & 7);
  uint4 c[8];
  unsigned nk[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    nk[j] = (__shfl_sync(kFull, kv, 4 * j + (lane >> 3)) >> sh) & 15u;
    c[j] = make_uint4(0u, 0u, 0u, 0u);
    const uint32_t* q = cnt + 128 * j + 4 * lane;
    if (nk[j]) {
      if (p.vec) {
        c[j] = __ldg(reinterpret_cast<const uint4*>(q));
      } else {
        if (nk[j] & 1u) c[j].x = __ldg(q);
        if (nk[j] & 2u) c[j].y = __ldg(q + 1);
        if (nk[j] & 4u) c[j].z = __ldg(q + 2);
        if (nk[j] & 8u) c[j].w = __ldg(q + 3);
      }
    }
  }
  unsigned pw = 0u;
  long long csum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t e[4] = {c[j].x, c[j].y, c[j].z, c[j].w};
    unsigned nib = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      // a valid k-mer is present where its unsigned count >= min_count
      if (((nk[j] >> b) & 1u) && (long long)e[b] >= p.min_count) {
        nib |= 1u << b;
        csum += e[b];
      }
    }
    unsigned g = nib << sh;
    g |= __shfl_xor_sync(kFull, g, 1);
    g |= __shfl_xor_sync(kFull, g, 2);
    g |= __shfl_xor_sync(kFull, g, 4);
    const unsigned word = __shfl_sync(kFull, g, 8 * (lane & 3));
    if ((lane >> 2) == j) pw = word;
  }
  s = word_sum(pw, kv, p.k);
  s.csum = csum;
  s = warp_combine(s, p.k);
  eff = __reduce_add_sync(kFull, eff);
}

__device__ __forceinline__ void write_row(const Scan& p, long long row,
                                          const Sum& t, long long eff) {
  const bool has = t.obs > 0;
  long long* o = p.out + row;
  o[0] = t.nval;
  o[p.B] = t.obs;
  o[2 * p.B] = has ? (long long)t.var + (t.lead > 0) + (t.trail > 0)
                   : (long long)(t.nval > 0);
  o[3 * p.B] = t.dist;
  o[4 * p.B] = has ? t.lead : 0;
  o[5 * p.B] = has ? t.trail : t.nval;
  o[6 * p.B] = t.csum;
  o[7 * p.B] = eff;
}

// warp 0 of a block of a row that spans several: store the block's
// summary, draw a ticket, and if it is the row's last, combine the row's
// summaries in position order and write the row
__device__ __forceinline__ void row_of_blocks(const Scan& p, long long row,
                                              long long span, const Sum& b,
                                              int e, int lane) {
  BlockSum* sums = p.sums + row * p.bpr;
  int last = 0;
  if (lane == 0) {
    sums[span] = {b.nval, b.obs, b.lead, b.trail, b.var, e, b.dist, b.csum};
    __threadfence();
    last = atomicAdd(p.tickets + row, 1) == (int)p.bpr - 1;
  }
  if (!__shfl_sync(kFull, last, 0)) return;
  __threadfence();
  Sum t = empty_sum();
  long long eff = 0;
  for (long long c = 0; c < p.bpr; c += 32) {
    Sum x = empty_sum();
    int xe = 0;
    if (c + lane < p.bpr) {
      const BlockSum* y = sums + c + lane;  // other blocks' stores: via L2
      x = {__ldcg(&y->nval), __ldcg(&y->obs), __ldcg(&y->lead),
           __ldcg(&y->trail), __ldcg(&y->var), __ldcg(&y->dist),
           __ldcg(&y->csum)};
      xe = __ldcg(&y->eff);
    }
    x = warp_combine(x, p.k);
    t = combine(t, x, p.k);  // lane 0's is the one kept
    eff += __reduce_add_sync(kFull, xe);
  }
  if (lane == 0) write_row(p, row, t, eff);
}

// (at most 64 registers: two blocks of 16 warps an SM)
__global__ void __launch_bounds__(kScanWarps * 32, 2) hash_scan(Scan p) {
  __shared__ Sum part[kScanWarps];
  __shared__ int part_eff[kScanWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const long long row = item / p.bpr, span = item - row * p.bpr;
    const long long c = span * p.wpb + warp;
    Sum s = empty_sum();
    int eff = 0;
    if (c < p.n_chunks) chunk_sum(p, row, c * kChunk, lane, s, eff);
    if (lane == 0) {
      part[warp] = s;
      part_eff[warp] = eff;
    }
    __syncthreads();
    if (warp == 0) {
      Sum b = lane < p.wpb ? part[lane] : empty_sum();
      int e = lane < p.wpb ? part_eff[lane] : 0;
      b = warp_combine(b, p.k);
      e = __reduce_add_sync(kFull, e);
      if (p.bpr == 1) {
        if (lane == 0) write_row(p, row, b, e);
      } else {
        row_of_blocks(p, row, span, b, e, lane);
      }
    }
    __syncthreads();  // part is refilled by the next item
  }
}

}  // namespace

// rows (B, Lp) uint8, win_len (B,) int64, tbl (nb, 12) int32 holding uint32
// bits, 16-byte aligned, shard `shard` of an nb_total-bucket table (both
// powers of two). out: (B, n_out) int32, the uint32 counts. n_out = Lp - 32.
extern "C" int kcf_hash_probe(const void* rows, const void* win_len,
                              const void* tbl, void* out, long long B,
                              long long Lp, long long n_out, long long nb,
                              long long nb_total, long long shard, int k,
                              int both_strands, void* stream) {
  Probe p;
  p.rows = static_cast<const uint8_t*>(rows);
  p.win_len = static_cast<const long long*>(win_len);
  p.tbl = static_cast<const uint4*>(tbl);
  p.out = static_cast<uint32_t*>(out);
  p.Lp = Lp;
  p.n_out = n_out;
  p.wtiles = (n_out + kWarpTile - 1) / kWarpTile;
  p.n_wtiles = B * p.wtiles;
  p.kmask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1ull;
  p.nb = (uint32_t)nb;
  p.lm = (uint32_t)(nb - 1);
  p.mask = (uint32_t)(nb_total - 1);
  p.base = (uint32_t)(shard * nb);
  p.k = k;
  p.both = both_strands;
  p.vec = (uintptr_t)out % 16 == 0 && n_out % 4 == 0;
  if (p.n_wtiles == 0) return 0;
  const long long want = (p.n_wtiles + kProbeWarps - 1) / kProbeWarps;
  const long long grid = want < kMaxGrid ? want : kMaxGrid;
  hash_probe<<<(unsigned)grid, kProbeThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// rows (B, Lp) uint8, counts (B, n_out) int32 holding uint32 counts,
// win_len (B,) int64. scratch: for rows of more than kScanWarps chunks,
// B * bpr * 40 bytes of block summaries then B int32 tickets (bpr = the
// blocks a row: ceil(ceil(Lp / 1024) / 16)); unused otherwise. out: (8, B)
// int64.
extern "C" int kcf_hash_scan(const void* rows, const void* counts,
                             const void* win_len, void* scratch, void* out,
                             long long B, long long Lp, long long n_out,
                             int k, long long min_count, void* stream) {
  Scan p;
  p.rows = static_cast<const uint8_t*>(rows);
  p.counts = static_cast<const uint32_t*>(counts);
  p.win_len = static_cast<const long long*>(win_len);
  p.out = static_cast<long long*>(out);
  p.B = B;
  p.Lp = Lp;
  p.n_out = n_out;
  p.n_chunks = (Lp + kChunk - 1) / kChunk;
  p.wpb = (int)(p.n_chunks < kScanWarps ? p.n_chunks : kScanWarps);
  p.bpr = p.wpb ? (p.n_chunks + p.wpb - 1) / p.wpb : 0;
  p.n_items = B * p.bpr;
  p.sums = static_cast<BlockSum*>(scratch);
  p.tickets = reinterpret_cast<int*>(p.sums + B * p.bpr);
  p.min_count = min_count;
  p.k = k;
  p.vec = (uintptr_t)counts % 16 == 0 && n_out % 4 == 0;
  if (p.n_items == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.bpr > 1) {
    const cudaError_t err =
        cudaMemsetAsync(p.tickets, 0, B * sizeof(int), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long grid = p.n_items < kMaxGrid ? p.n_items : kMaxGrid;
  hash_scan<<<(unsigned)grid, 32 * p.wpb, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
