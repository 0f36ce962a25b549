// Window gap-run scan for Hopper (sm_90a): chunk summaries, then one warp
// per window; three front ends.
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
// 0).
//
// The statistics of any range of positions follow from one summary that
// combines associatively (not invertibly), gapsum.cuh's Sum. Presence is
// taken inside the valid bitmap.
//
// What bounds it: device memory. Each input byte read once and each output
// written once: in the JOIN mode the slot maps (4 B a position) and one
// 4-byte count per valid position, gathered at random from the routed
// counts (268 MB at the main path's 2^26 slots, over the 50 MB L2), so each
// gather really costs a 32-byte sector (the "sector floor"); the valid
// bitmaps, the presence rows (n/8 B a row), the run streams (2 B an
// entry), 16 B of bounds and 40-48 B of output a window per row.
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
// - Pass 2 (windows): one warp per window and row combines the partial head
//   chunk, the whole chunks' summaries (32 a step, combined by an ordered
//   shuffle tree) and the partial tail chunk. The partial chunks come from
//   the presence and valid words (popc / ffs / clz, a loop only over a
//   word's closed gaps) and, in the JOIN mode, the word count sums; only a
//   window's partial edge words (at most 2 x 31 positions, one position a
//   lane) go back to the slot map and the routed counts.
// - All slabs of a sample, or all rows of a dprefix group, go through one
//   call: the row is the slab (JOIN: its own slot map, valid bitmap and
//   windows) or the sample (ROWS / RUNS: one valid bitmap and windows).
// - The RUNS front end decodes the (S, 2, R) uint8 absent-run streams
//   (delta from the previous run's end with (255, 0) fillers, length with
//   (0, 255) continuations, zero padding) on the card: per row, segment
//   totals of delta + length, an exclusive scan of the totals, then each
//   block rescans its segment and clears every run [start, end) from a copy
//   of the valid words by atomicAnd (starts at or past n dropped, ends
//   clamped to n). The ROWS passes then read that (S, n/8) bitmap.
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
constexpr int kRunSeg = 4 * kThreads;  // run entries per front-end block
// count gathers a lane of JOIN pass 1 keeps in flight: its whole word (16
// ties with 32 on the card, 8 is slower)
constexpr int kBatch = 32;

// the chunk summary as stored by pass 1 (40 bytes)
struct StoredSum {
  int nval, obs, lead, trail, var, pad;
  long long dist, csum;
};

struct Params {
  uint32_t* presence;        // (S, nw) words: ROWS input; JOIN / RUNS output
  long long* wsum;           // JOIN: (S, nw) count sum of each word
  const uint32_t* routed;    // JOIN: routed counts (uint32)
  long long n_routed;
  const int32_t* slot_map;   // JOIN: (S, n) routed slot of each position
  const uint32_t* valid;     // LSB-first words, valid_stride apart a row
  long long valid_stride;    // 0: one bitmap for every row
  const long long* w_start;  // W bounds, win_stride apart a row
  const long long* w_hi;
  long long win_stride;      // 0: one window list for every row
  StoredSum* chunks;         // (S, n_chunks)
  long long* out;            // field f, row r, window w: f*out_field + r*out_row + w
  long long out_field, out_row;
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

// The summary of positions [lo, hi] (lo <= hi) of one chunk and row, from
// the presence words (and, in the JOIN mode, the word count sums and the
// counts of the partial edge words); the result is lane 0's. Lane j takes
// word j of the chunk.
template <bool JOIN>
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
    vw = p.valid[row * p.valid_stride + word] & mask;
    pw = p.presence[at] & vw;
    if (JOIN && mask == kFull) csum = p.wsum[at];
  }
  if (JOIN) {
    // the partial edge words' present positions, one position a lane
    const unsigned edge = mask != kFull ? pw : 0u;
    const unsigned e0 = __shfl_sync(kFull, edge, j0);
    const unsigned e1 = j1 != j0 ? __shfl_sync(kFull, edge, j1) : 0u;
    if ((e0 >> lane) & 1u) csum += routed_count(p, row, base + 32ll * j0 + lane);
    if ((e1 >> lane) & 1u) csum += routed_count(p, row, base + 32ll * j1 + lane);
  }
  Sum s = word_sum(pw, vw, p.k);
  s.csum = csum;
  return warp_combine(s, p.k);
}

__device__ __forceinline__ void store_chunk(const Params& p, long long item,
                                            const Sum& s) {
  p.chunks[item] = {s.nval, s.obs, s.lead, s.trail, s.var, 0, s.dist,
                    s.csum};
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
  const unsigned vw = lane < nwc ? p.valid[row * p.valid_stride + word] : 0u;
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
  if (lane == 0) store_chunk(p, item, s);
}

// ROWS pass 1: a warp per chunk and row reads the presence words.
__global__ void __launch_bounds__(kThreads) rows_chunks(Params p) {
  const long long item =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= (long long)p.S * p.n_chunks) return;  // whole warps
  const int row = (int)(item / p.n_chunks);
  const long long lo = (item % p.n_chunks) * kChunk;
  const long long hi = (lo + kChunk < p.n ? lo + kChunk : p.n) - 1;
  const Sum s = chunk_range<false>(p, row, lo, hi);
  if ((threadIdx.x & 31) == 0) store_chunk(p, item, s);
}

template <bool JOIN>
__global__ void __launch_bounds__(kThreads) windows(Params p) {
  const long long item =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= (long long)p.S * p.W) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int row = (int)(item / p.W);
  const int w = (int)(item % p.W);
  // bounds outside the slab are outside the contract: clamp, to stay in it
  long long s = p.w_start[row * p.win_stride + w];
  long long h = p.w_hi[row * p.win_stride + w];
  s = s < 0 ? 0 : (s > p.n ? p.n : s);
  h = h < -1 ? -1 : (h > p.n - 1 ? p.n - 1 : h);
  const bool neg = h < s - 1;
  const long long lo = neg ? h + 1 : s;
  const long long hi = neg ? s - 1 : h;
  Sum t = empty_sum();
  if (lo <= hi) {
    const long long c0 = lo / kChunk, c1 = hi / kChunk;
    if (c0 == c1) {
      t = chunk_range<JOIN>(p, row, lo, hi);
    } else {
      t = chunk_range<JOIN>(p, row, lo, c0 * kChunk + kChunk - 1);
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
      t = combine(t, chunk_range<JOIN>(p, row, c1 * kChunk, hi), p.k);
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
  long long* o = p.out + (long long)row * p.out_row + w;
#pragma unroll
  for (int i = 0; i < (JOIN ? 6 : 5); ++i) o[i * p.out_field] = f[i];
}

// -- the RUNS front end -------------------------------------------------

struct Runs {
  const uint8_t* dl;  // (S, 2, R): deltas, then lengths
  long long R;
  long long n_seg;    // ceil(R / kRunSeg)
  long long* seg;     // (S, n_seg): segment totals, then their offsets
};

// Inclusive block-wide prefix sum of v (every thread calls it); *all gets
// the block's total.
__device__ long long block_scan(long long v, long long* all) {
  __shared__ long long warp_tot[kWarps];
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
  for (int i = 0; i < kWarps; ++i) {
    if (i < warp) before += warp_tot[i];
    total += warp_tot[i];
  }
  __syncthreads();  // warp_tot is free for the next call
  *all = total;
  return v + before;
}

// A thread's four run entries of its segment: delta + length of each.
__device__ __forceinline__ void run_entries(const Runs& r, int row,
                                            long long seg, int d[4],
                                            int l[4]) {
  const uint8_t* dp = r.dl + (long long)row * 2 * r.R;
  const long long i0 = seg * kRunSeg + 4 * threadIdx.x;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const bool in = i0 + u < r.R;
    d[u] = in ? dp[i0 + u] : 0;
    l[u] = in ? dp[r.R + i0 + u] : 0;
  }
}

// presence = the valid words, for every row
__global__ void __launch_bounds__(kThreads) runs_init(Params p) {
  const long long total = (long long)p.S * p.nw;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    p.presence[i] = p.valid[i % p.nw];
  }
}

// grid (n_seg, S): each segment's total of delta + length
__global__ void __launch_bounds__(kThreads) runs_totals(Runs r) {
  int d[4], l[4];
  run_entries(r, blockIdx.y, blockIdx.x, d, l);
  long long all;
  block_scan(d[0] + l[0] + d[1] + l[1] + d[2] + l[2] + d[3] + l[3], &all);
  if (threadIdx.x == 0) r.seg[(long long)blockIdx.y * r.n_seg + blockIdx.x] = all;
}

// grid S: the exclusive scan of a row's segment totals, in place
__global__ void __launch_bounds__(kThreads) runs_offsets(Runs r) {
  long long* s = r.seg + (long long)blockIdx.x * r.n_seg;
  long long carry = 0;
  for (long long b = 0; b < r.n_seg; b += kThreads) {
    const long long i = b + threadIdx.x;
    const long long v = i < r.n_seg ? s[i] : 0;
    long long all;
    const long long incl = block_scan(v, &all);
    if (i < r.n_seg) s[i] = carry + incl - v;
    carry += all;
  }
}

// Clear [s, e) (clamped to n) from a row's presence words. Atomic on every
// word, so runs that share a word (and any overlap) clear exactly.
__device__ __forceinline__ void clear_run(uint32_t* pres, long long s,
                                          long long e, long long n) {
  if (s >= n) return;
  if (e > n) e = n;
  const long long w0 = s >> 5, w1 = (e - 1) >> 5;
  const unsigned m0 = kFull << (s & 31);
  const unsigned m1 = kFull >> (31 - ((e - 1) & 31));
  if (w0 == w1) {
    atomicAnd(pres + w0, ~(m0 & m1));
    return;
  }
  atomicAnd(pres + w0, ~m0);
  for (long long w = w0 + 1; w < w1; ++w) atomicAnd(pres + w, 0u);
  atomicAnd(pres + w1, ~m1);
}

// grid (n_seg, S): rescan the segment from its offset and clear its runs
__global__ void __launch_bounds__(kThreads) runs_paint(Params p, Runs r) {
  int d[4], l[4];
  run_entries(r, blockIdx.y, blockIdx.x, d, l);
  const long long mine = d[0] + l[0] + d[1] + l[1] + d[2] + l[2] + d[3] + l[3];
  long long all;
  const long long incl = block_scan(mine, &all);
  long long end =
      r.seg[(long long)blockIdx.y * r.n_seg + blockIdx.x] + incl - mine;
  uint32_t* pres = p.presence + (long long)blockIdx.y * p.nw;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    end += d[u] + l[u];
    if (l[u] > 0) clear_run(pres, end - l[u], end, p.n);
  }
}

// -- launches -----------------------------------------------------------

unsigned warp_blocks(long long items) {
  return (unsigned)((items + kWarps - 1) / kWarps);
}

Params make_params(long long n, int S, int W, int k, const void* valid,
                   const void* w_start, const void* w_hi, void* chunks,
                   void* out) {
  Params p = {};
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
  // ROWS / RUNS: (5, S, W)
  p.out_field = (long long)S * W;
  p.out_row = W;
  return p;
}

cudaError_t launch_rows(const Params& p, cudaStream_t st) {
  if ((long long)p.S * p.n_chunks > 0) {
    rows_chunks<<<warp_blocks((long long)p.S * p.n_chunks), kThreads, 0,
                  st>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if ((long long)p.S * p.W > 0) {
    windows<false><<<warp_blocks((long long)p.S * p.W), kThreads, 0, st>>>(p);
  }
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
  Params p = make_params(n, S, W, k, valid, w_start, w_hi, chunks, out);
  p.presence = static_cast<uint32_t*>(presence);
  p.wsum = static_cast<long long*>(wsum);
  p.routed = static_cast<const uint32_t*>(routed);
  p.n_routed = n_routed;
  p.slot_map = static_cast<const int32_t*>(slot_maps);
  p.valid_stride = p.nw;
  p.win_stride = W;
  p.out_field = W;
  p.out_row = 6ll * W;
  p.min_count = min_count;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long items = (long long)S * p.n_chunks;
  if (items > 0) {
    join_chunks<<<warp_blocks(items), kThreads, 0, st>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((long long)S * W > 0) {
    windows<true><<<warp_blocks((long long)S * W), kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// ROWS mode: presence (S, n/8) bytes, one valid bitmap (n/8 bytes) and one
// window list (W) for every row. chunks: S * ceil(n / 1024) * 40 bytes.
// out: (5, S, W) int64. n a multiple of 32, the bitmaps 4-byte aligned.
extern "C" int kcf_gapscan_rows(const void* presence, const void* valid,
                                const void* w_start, const void* w_hi,
                                void* chunks, void* out, long long n, int S,
                                int W, int k, void* stream) {
  Params p = make_params(n, S, W, k, valid, w_start, w_hi, chunks, out);
  p.presence = static_cast<uint32_t*>(const_cast<void*>(presence));
  return static_cast<int>(launch_rows(p, static_cast<cudaStream_t>(stream)));
}

// RUNS mode: dl (S, 2, R) uint8 absent-run streams, decoded into the
// presence scratch (S, n/8) bytes, then the ROWS passes. seg: S *
// ceil(R / 1024) int64 scratch. Otherwise as kcf_gapscan_rows. S <= 65535.
extern "C" int kcf_gapscan_runs(const void* dl, long long R,
                                const void* valid, const void* w_start,
                                const void* w_hi, void* seg, void* presence,
                                void* chunks, void* out, long long n, int S,
                                int W, int k, void* stream) {
  Params p = make_params(n, S, W, k, valid, w_start, w_hi, chunks, out);
  p.presence = static_cast<uint32_t*>(presence);
  Runs r;
  r.dl = static_cast<const uint8_t*>(dl);
  r.R = R;
  r.n_seg = (R + kRunSeg - 1) / kRunSeg;
  r.seg = static_cast<long long*>(seg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long words = (long long)S * p.nw;
  if (words > 0) {
    const long long want = (words + kThreads - 1) / kThreads;
    runs_init<<<(unsigned)(want < 8192 ? want : 8192), kThreads, 0, st>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (r.n_seg > 0) {
      const dim3 grid((unsigned)r.n_seg, (unsigned)S);
      runs_totals<<<grid, kThreads, 0, st>>>(r);
      runs_offsets<<<(unsigned)S, kThreads, 0, st>>>(r);
      runs_paint<<<grid, kThreads, 0, st>>>(p, r);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(launch_rows(p, st));
}
