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
// uint32 like the JAX sums.
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
// 32-byte sectors (the sector floor: 64 B a probed row). The scan reads the
// bytes and the counts once (~5 B a position) and writes 64 B a row.
//
// What the design does about it:
// - Probe: a block of 256 threads per tile of 1,024 starts of one row stages
//   the tile's bytes and the 32 after it in shared memory with coalesced
//   loads (a tile past win_len only writes zeros), then a thread builds each
//   k-mer of its starts from shared memory and issues the loads of both
//   bucket rows (three 16-byte loads each) before comparing either, so the
//   SM holds thousands of random rows in flight. Tiles run on a grid-stride
//   loop over x: any number of rows.
// - Scan, pass 1: a warp per chunk of 1,024 positions of a row. The invalid
//   bytes become one word a lane by ballots over coalesced byte loads (33
//   words: the chunk and the word after it, the k - 1 halo); a lane's valid
//   k-mer starts are the zero bits of the OR of k shifts of its two words.
//   The counts are read once, coalesced, where the k-mer is valid, and
//   presence is balloted into words; word_sum and the ordered shuffle tree
//   give the chunk's summary (40 B).
// - Pass 2: a warp per row combines its chunk summaries in order, 32 a step,
//   so a feature of 2^20 bases is spread over 1,024 warps in pass 1.
//
// C entry points for ctypes (kcf_hash_probe, kcf_hash_scan) return a
// cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gapsum.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;   // k-mer starts a probe block stages at once
constexpr int kHalo = 32;     // bytes past the tile a k-mer may read
constexpr int kChunk = 1024;  // positions of a scan chunk: a word a lane
constexpr long long kMaxGrid = 1ll << 20;

struct Probe {
  const uint8_t* rows;        // (B, Lp)
  const long long* win_len;   // (B,)
  const uint4* tbl;           // (nb, 12) uint32: three 16-byte loads a row
  uint32_t* out;              // (B, n_out)
  long long Lp, n_out, tiles, n_tiles;  // tiles: per row
  uint32_t nb, lm, mask, base;  // mask = nb_total - 1, base = shard * nb
  int k, both;
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

__device__ __forceinline__ uint32_t probe(const Probe& p,
                                          unsigned long long key) {
  const int n_lo = p.k > 16 ? p.k - 16 : 0;
  const uint32_t hi = (uint32_t)(key >> (2 * n_lo));
  const uint32_t lo = (uint32_t)(key & ((1ull << (2 * n_lo)) - 1ull));
  const uint32_t h1 =
      fmix32(hi * 0x9E3779B1u + lo * 0x85EBCA77u + 0xA5A5A5A5u) & p.mask;
  const uint32_t h2 =
      fmix32(hi * 0xC2B2AE3Du + lo * 0x27D4EB2Fu + 0x3C6EF372u) & p.mask;
  const uint32_t b2 = (h1 & ~p.lm) | (h2 & p.lm);
  const uint32_t l1 = h1 - p.base, l2 = b2 - p.base;  // wraps: a range test
  const bool o1 = l1 < p.nb;
  const bool o2 = b2 != h1 && l2 < p.nb;
  uint4 a[3] = {}, b[3] = {};
  if (o1) {
#pragma unroll
    for (int u = 0; u < 3; ++u) a[u] = __ldg(p.tbl + 3ull * l1 + u);
  }
  if (o2) {
#pragma unroll
    for (int u = 0; u < 3; ++u) b[u] = __ldg(p.tbl + 3ull * l2 + u);
  }
  return (o1 ? row_sum(a, hi, lo) : 0u) + (o2 ? row_sum(b, hi, lo) : 0u);
}

__global__ void __launch_bounds__(kThreads) hash_probe(Probe p) {
  __shared__ uint8_t stage[kTile + kHalo];
  for (long long t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const long long row = t / p.tiles;
    const long long lo = (t % p.tiles) * kTile;
    const long long last = p.win_len[row] - p.k;  // the last valid start
    const long long left = p.n_out - lo;
    const int n = left < kTile ? (int)left : kTile;
    uint32_t* out = p.out + row * p.n_out + lo;
    if (last < lo) {  // all padding: the whole block takes this branch
      for (int j = threadIdx.x; j < n; j += kThreads) out[j] = 0u;
      continue;
    }
    const uint8_t* src = p.rows + row * p.Lp + lo;
    __syncthreads();  // the previous tile's k-mers are built
    for (int j = threadIdx.x; j < kTile + kHalo; j += kThreads) {
      stage[j] = lo + j < p.Lp ? src[j] : 4;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      uint32_t cnt = 0u;
      if (lo + j <= last) {
        unsigned long long f = 0ull, r = 0ull;
        unsigned bad = 0u;
        for (int u = 0; u < p.k; ++u) {
          const unsigned c = stage[j + u];
          bad |= c >> 2;  // any byte >= 4
          f = (f << 2) | (c & 3u);
          r |= (unsigned long long)(~c & 3u) << (2 * u);  // 3 - c
        }
        if (bad == 0u) cnt = probe(p, p.both && r < f ? r : f);
      }
      out[j] = cnt;
    }
  }
}

// a chunk's summary as pass 1 stores it (40 bytes)
struct ChunkSum {
  int nval, obs, lead, trail, var, eff;
  long long dist, csum;
};

struct Scan {
  const uint8_t* rows;       // (B, Lp)
  const uint32_t* counts;    // (B, n_out)
  const long long* win_len;  // (B,)
  ChunkSum* chunks;          // (B, n_chunks)
  long long* out;            // (8, B)
  long long B, Lp, n_out, n_chunks;
  long long min_count;
  int k;
};

// pass 1: a warp per chunk of a row
__global__ void __launch_bounds__(kThreads) scan_chunks(Scan p) {
  const long long item =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= p.B * p.n_chunks) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const long long row = item / p.n_chunks;
  const long long lo = (item % p.n_chunks) * kChunk;
  const uint8_t* src = p.rows + row * p.Lp;
  // invalid bytes, a word a lane, and the word after it (the k - 1 halo);
  // bytes past the row are invalid
  unsigned inv = 0u, inv_next = 0u;
#pragma unroll
  for (int t = 0; t <= 32; ++t) {
    const long long pos = lo + 32ll * t + lane;
    const unsigned w = __ballot_sync(kFull, pos >= p.Lp || src[pos] >= 4);
    if (t == lane) inv = w;
    if (t == lane + 1) inv_next = w;
  }
  // is the byte before each word invalid (before position 0: yes)
  unsigned before = __shfl_up_sync(kFull, inv, 1) >> 31;
  if (lane == 0) before = lo == 0 || src[lo - 1] >= 4;
  const unsigned long long w64 = ((unsigned long long)inv_next << 32) | inv;
  unsigned long long any = 0ull;
  for (int t = 0; t < p.k; ++t) any |= w64 >> t;
  const unsigned av = ~(unsigned)any;  // starts whose k bytes are bases
  const unsigned run_starts = av & ((inv << 1) | before);
  int eff = __popc(av) + (p.k - 1) * __popc(run_starts);
  // valid k-mers: below n_out and at most win_len - k
  const long long lim_a = p.n_out - 1, lim_b = p.win_len[row] - p.k;
  const long long d = (lim_a < lim_b ? lim_a : lim_b) - (lo + 32ll * lane);
  const unsigned kv =
      av & (d >= 31 ? kFull : (d >= 0 ? (2u << d) - 1u : 0u));
  // presence from the counts of the valid k-mers, read once, coalesced
  const uint32_t* cnt = p.counts + row * p.n_out + lo;
  unsigned pw = 0u;
  long long csum = 0;
#pragma unroll 8
  for (int t = 0; t < 32; ++t) {
    const bool live = (__shfl_sync(kFull, kv, t) >> lane) & 1u;
    const uint32_t c = live ? cnt[32 * t + lane] : 0u;
    const bool pres = live && (long long)c >= p.min_count;  // unsigned count
    if (pres) csum += c;
    const unsigned w = __ballot_sync(kFull, pres);
    if (t == lane) pw = w;
  }
  Sum s = word_sum(pw, kv, p.k);
  s.csum = csum;
  s = warp_combine(s, p.k);
  eff = __reduce_add_sync(kFull, eff);
  if (lane == 0) {
    p.chunks[item] = {s.nval, s.obs, s.lead, s.trail, s.var, eff, s.dist,
                      s.csum};
  }
}

// pass 2: a warp per row combines its chunks in order and writes the row
__global__ void __launch_bounds__(kThreads) scan_rows(Scan p) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p.B) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const ChunkSum* cs = p.chunks + row * p.n_chunks;
  Sum t = empty_sum();
  long long eff = 0;
  for (long long c = 0; c < p.n_chunks; c += 32) {
    Sum x = empty_sum();
    int e = 0;
    if (c + lane < p.n_chunks) {
      const ChunkSum& y = cs[c + lane];
      x = {y.nval, y.obs, y.lead, y.trail, y.var, y.dist, y.csum};
      e = y.eff;
    }
    x = warp_combine(x, p.k);
    t = combine(t, x, p.k);  // lane 0's is the one kept
    eff += __reduce_add_sync(kFull, e);
  }
  if (lane != 0) return;
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

unsigned warp_blocks(long long items) {
  return (unsigned)((items + kWarps - 1) / kWarps);
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
  p.tiles = (n_out + kTile - 1) / kTile;
  p.n_tiles = B * p.tiles;
  p.nb = (uint32_t)nb;
  p.lm = (uint32_t)(nb - 1);
  p.mask = (uint32_t)(nb_total - 1);
  p.base = (uint32_t)(shard * nb);
  p.k = k;
  p.both = both_strands;
  if (p.n_tiles == 0) return 0;
  const long long grid = p.n_tiles < kMaxGrid ? p.n_tiles : kMaxGrid;
  hash_probe<<<(unsigned)grid, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// rows (B, Lp) uint8, counts (B, n_out) int32 holding uint32 counts,
// win_len (B,) int64. chunks: B * ceil(Lp / 1024) * 40 bytes of scratch.
// out: (8, B) int64.
extern "C" int kcf_hash_scan(const void* rows, const void* counts,
                             const void* win_len, void* chunks, void* out,
                             long long B, long long Lp, long long n_out,
                             int k, long long min_count, void* stream) {
  Scan p;
  p.rows = static_cast<const uint8_t*>(rows);
  p.counts = static_cast<const uint32_t*>(counts);
  p.win_len = static_cast<const long long*>(win_len);
  p.chunks = static_cast<ChunkSum*>(chunks);
  p.out = static_cast<long long*>(out);
  p.B = B;
  p.Lp = Lp;
  p.n_out = n_out;
  p.n_chunks = (Lp + kChunk - 1) / kChunk;
  p.min_count = min_count;
  p.k = k;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * p.n_chunks == 0) return 0;
  scan_chunks<<<warp_blocks(B * p.n_chunks), kThreads, 0, st>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_rows<<<warp_blocks(B), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
