// Window gap-run scan for Hopper (sm_90a): chunk summaries, then one warp
// per window.
//
// Replaces the XLA program kcftools_tpu/engine/device_prefix.py::_scan_core
// as kcftools_tpu/engine/device_join.py::_slab_scan runs it on the routed
// join counts (the JOIN mode) and as device_prefix.py::_score_batch and
// ::_score_runs vmap it over a group's presence rows (the ROWS mode). For
// every window [w_start, w_hi] (inclusive k-mer start positions of one
// slab, in any order, overlapping or empty) and every row it writes the
// gap-run statistics of Plugins/GetVariants.java:219-273 as int64:
// observed, variations, inner, left, right and, in the JOIN mode, the
// count sum. A window with w_hi < w_start - 1 gets what the prefix
// differences of the plain version give (negated sums over
// [w_hi + 1, w_start - 1], the rest 0).
//
// The statistics of any range of positions follow from one summary that
// combines associatively (not invertibly):
//   nval  valid positions;           obs   present positions;
//   lead  valid positions before the first present (nval if none);
//   trail valid positions after the last present (nval if none);
//   var   closed gaps: g > 0 valid positions between consecutive presents;
//   dist  the sum of dist(g), d = g - (k - 1), dist = d > 0 ? d : |d + 1|;
//   csum  the sum of the counts of the present positions.
// Two ranges A, B with present positions on both sides close one more gap
// of g = A.trail + B.lead if g > 0. A window's result is then
//   left = obs ? lead : 0, right = obs ? trail : nval, inner = dist,
//   variations = obs ? var + (lead > 0) + (trail > 0) : (nval > 0).
// Presence is taken inside the valid bitmap (the JOIN mode's presence
// test includes it; in the ROWS mode the kernel masks the rows with it,
// which the native packers and the run decode already do).
//
// What bounds it: device memory. Each input byte read once and each output
// written once: the slot map (4 B a position), one 4-byte count per valid
// position (a random gather into the routed counts), the valid bitmap, the
// presence rows (n/8 B a row), 16 B of bounds and 40-48 B of output a
// window per row. The eager torch formulation it replaces moved about a
// dozen slab-sized int64 temporaries through ~40 launches, and cummax /
// cummin dominated it.
//
// What the design does about it:
// - Pass 1 (gapscan_chunks): one warp per chunk of 1,024 positions and row,
//   one 32-position word a lane. The JOIN mode loads 32 consecutive slot
//   indices a step (coalesced), gathers their counts, eight steps in flight
//   at once, and builds the lanes' presence words by ballot; the ROWS mode
//   reads one presence and one valid word a lane. Each lane summarises its
//   word with popc / ffs / clz (a loop only over the word's closed gaps),
//   and a shuffle tree combines the 32 lanes in order. Only the chunk
//   summaries (40 B per 1,024 positions) reach memory: no per-position
//   temporary.
// - Pass 2 (gapscan_windows): one warp per window and row combines the
//   partial head chunk (rescanned as in pass 1), the whole chunks'
//   summaries (32 a step, combined by the same tree) and the partial tail
//   chunk. A window costs O(1,024 + length / 1,024) whatever the overlap;
//   for the main path's tiling windows the rescanned partial chunks add
//   about one chunk per window to the n positions of pass 1.
// - Every row of a group goes through one launch of each pass.
//
// C entry point for ctypes: kcf_gapscan_launch returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;  // positions of a chunk: one 32-bit word a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 8;  // JOIN mode: word steps with their loads in flight

struct Sum {
  int nval, obs, lead, trail, var;
  long long dist, csum;
};

// the chunk summary as stored by pass 1 (40 bytes)
struct StoredSum {
  int nval, obs, lead, trail, var, pad;
  long long dist, csum;
};

struct Params {
  const uint32_t* presence;  // ROWS: (S, n / 32) words
  const uint32_t* routed;    // JOIN: routed counts (uint32)
  long long n_routed;
  const int32_t* slot_map;   // JOIN: (n,) slot of each position
  const uint32_t* valid;     // (n / 32) words, LSB first
  const long long* w_start;  // (W,)
  const long long* w_hi;     // (W,)
  StoredSum* chunks;         // (S, n_chunks)
  long long* out;            // (F, S, W)
  long long n;
  long long n_chunks;
  int S, W, k;
  long long min_count;
};

__device__ __forceinline__ Sum empty_sum() { return {0, 0, 0, 0, 0, 0, 0}; }

__device__ __forceinline__ long long gap_dist(int g, int k) {
  const long long d = (long long)g - (k - 1);
  return d > 0 ? d : (d + 1 < 0 ? -(d + 1) : d + 1);
}

__device__ __forceinline__ Sum combine(const Sum& a, const Sum& b, int k) {
  Sum r;
  r.nval = a.nval + b.nval;
  r.obs = a.obs + b.obs;
  r.lead = a.obs ? a.lead : a.nval + b.lead;
  r.trail = b.obs ? b.trail : a.trail + b.nval;
  r.var = a.var + b.var;
  r.dist = a.dist + b.dist;
  r.csum = a.csum + b.csum;
  if (a.obs && b.obs) {
    const int g = a.trail + b.lead;
    if (g > 0) {
      r.var += 1;
      r.dist += gap_dist(g, k);
    }
  }
  return r;
}

// The summary of one 32-position word; pw (present) lies inside vw (valid)
// and both are masked to the range.
__device__ __forceinline__ Sum word_sum(unsigned pw, unsigned vw, int k) {
  Sum s = empty_sum();
  s.nval = __popc(vw);
  s.obs = __popc(pw);
  if (pw == 0u) {
    s.lead = s.trail = s.nval;
    return s;
  }
  const int f = __ffs(pw) - 1;
  const int l = 31 - __clz(pw);
  s.lead = __popc(vw & ((1u << f) - 1u));
  s.trail = __popc(vw & ~((2u << l) - 1u));  // 2u << 31 wraps to 0: none
  // valid-absent positions strictly between the first and last present:
  // each starts a closed gap, walked one gap at a time
  unsigned m = vw & ~pw & ((1u << l) - 1u) & ~((2u << f) - 1u);
  while (m) {
    const int q = __ffs(m) - 1;
    const int a = 31 - __clz(pw & ((1u << q) - 1u));  // present before q
    const int b = __ffs(pw & ~((2u << q) - 1u)) - 1;   // present after q
    const int g = __popc(vw & ((1u << b) - 1u) & ~((2u << a) - 1u));
    s.var += 1;
    s.dist += gap_dist(g, k);
    m &= ~((1u << b) - 1u);
  }
  return s;
}

__device__ __forceinline__ Sum shfl_down(const Sum& s, int o) {
  Sum r;
  r.nval = __shfl_down_sync(kFull, s.nval, o);
  r.obs = __shfl_down_sync(kFull, s.obs, o);
  r.lead = __shfl_down_sync(kFull, s.lead, o);
  r.trail = __shfl_down_sync(kFull, s.trail, o);
  r.var = __shfl_down_sync(kFull, s.var, o);
  r.dist = __shfl_down_sync(kFull, s.dist, o);
  r.csum = __shfl_down_sync(kFull, s.csum, o);
  return r;
}

// The lanes' summaries combined in lane order; the result is lane 0's.
__device__ __forceinline__ Sum warp_combine(Sum s, int k) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) s = combine(s, shfl_down(s, o), k);
  return s;
}

// The summary of positions [lo, hi] (lo <= hi) of one chunk and row; the
// result is lane 0's. Lane j takes word j of the chunk.
template <bool JOIN>
__device__ Sum chunk_range(const Params& p, int row, long long lo,
                           long long hi) {
  const int lane = threadIdx.x & 31;
  const long long base = lo - lo % kChunk;
  const int j0 = (int)((lo - base) >> 5);
  const int j1 = (int)((hi - base) >> 5);
  const long long word = (base >> 5) + lane;
  unsigned vw = 0u, pw = 0u;
  if (lane >= j0 && lane <= j1) {
    unsigned mask = kFull;
    if (lane == j0) mask &= kFull << (lo & 31);
    if (lane == j1) mask &= kFull >> (31 - (hi & 31));
    vw = p.valid[word] & mask;
    if (!JOIN) pw = p.presence[(long long)row * (p.n >> 5) + word] & vw;
  }
  Sum s;
  if (JOIN) {
    long long csum = 0;
    for (int jb = j0; jb <= j1; jb += kBatch) {
      int slot[kBatch];
      uint32_t cnt[kBatch];
      bool live[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = jb + u;
        const unsigned vj = __shfl_sync(kFull, vw, j & 31);
        live[u] = j <= j1 && ((vj >> lane) & 1u);
        slot[u] = live[u] ? p.slot_map[base + 32 * j + lane] : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        // an index outside the routed counts reads as count 0
        cnt[u] = live[u] && (unsigned long long)slot[u] <
                                (unsigned long long)p.n_routed
                     ? p.routed[slot[u]]
                     : 0u;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool present =
            live[u] && (long long)cnt[u] >= p.min_count;  // unsigned count
        if (present) csum += cnt[u];
        const unsigned bits = __ballot_sync(kFull, present);
        if (lane == jb + u) pw = bits;
      }
    }
    s = word_sum(pw, vw, p.k);
    s.csum = csum;  // positions of every word: the sum does not care
  } else {
    s = word_sum(pw, vw, p.k);
  }
  return warp_combine(s, p.k);
}

template <bool JOIN>
__global__ void __launch_bounds__(kThreads) gapscan_chunks(Params p) {
  const long long item =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= (long long)p.S * p.n_chunks) return;  // whole warps
  const int row = (int)(item / p.n_chunks);
  const long long c = item % p.n_chunks;
  const long long lo = c * kChunk;
  const long long hi = (lo + kChunk < p.n ? lo + kChunk : p.n) - 1;
  const Sum s = chunk_range<JOIN>(p, row, lo, hi);
  if ((threadIdx.x & 31) == 0) {
    p.chunks[item] = {s.nval, s.obs, s.lead, s.trail, s.var, 0, s.dist,
                      s.csum};
  }
}

template <bool JOIN>
__global__ void __launch_bounds__(kThreads) gapscan_windows(Params p) {
  const long long item =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= (long long)p.S * p.W) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int row = (int)(item / p.W);
  const int w = (int)(item % p.W);
  // bounds outside the slab are outside the contract: clamp, to stay in it
  long long s = p.w_start[w], h = p.w_hi[w];
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
  const long long plane = (long long)p.S * p.W;
  const long long at = (long long)row * p.W + w;
#pragma unroll
  for (int i = 0; i < (JOIN ? 6 : 5); ++i) p.out[i * plane + at] = f[i];
}

template <bool JOIN>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const long long chunk_items = (long long)p.S * p.n_chunks;
  if (chunk_items > 0) {
    const long long blocks = (chunk_items + kWarps - 1) / kWarps;
    gapscan_chunks<JOIN><<<(unsigned)blocks, kThreads, 0, st>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long win_items = (long long)p.S * p.W;
  if (win_items > 0) {
    const long long blocks = (win_items + kWarps - 1) / kWarps;
    gapscan_windows<JOIN><<<(unsigned)blocks, kThreads, 0, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// presence: ROWS mode (S, n/8) bytes, or null for the JOIN mode, which
// reads routed (n_routed uint32 counts) through slot_map (n int32). chunks:
// scratch of S * ceil(n / 1024) * 40 bytes. out: (6 or 5, S, W) int64.
// n must be a multiple of 32 and the bitmaps 4-byte aligned.
extern "C" int kcf_gapscan_launch(const void* presence, const void* routed,
                                  long long n_routed, const void* slot_map,
                                  const void* valid, const void* w_start,
                                  const void* w_hi, void* chunks, void* out,
                                  long long n, int S, int W, int k,
                                  long long min_count, void* stream) {
  Params p;
  p.presence = static_cast<const uint32_t*>(presence);
  p.routed = static_cast<const uint32_t*>(routed);
  p.n_routed = n_routed;
  p.slot_map = static_cast<const int32_t*>(slot_map);
  p.valid = static_cast<const uint32_t*>(valid);
  p.w_start = static_cast<const long long*>(w_start);
  p.w_hi = static_cast<const long long*>(w_hi);
  p.chunks = static_cast<StoredSum*>(chunks);
  p.out = static_cast<long long*>(out);
  p.n = n;
  p.n_chunks = (n + kChunk - 1) / kChunk;
  p.S = S;
  p.W = W;
  p.k = k;
  p.min_count = min_count;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      presence == nullptr ? launch<true>(p, st) : launch<false>(p, st);
  return static_cast<int>(err);
}
