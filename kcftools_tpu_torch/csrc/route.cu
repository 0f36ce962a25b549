// The device join's reference routing and sample tiling for Hopper (sm_90a).
//
// Replaces the host numpy of kcftools_tpu_torch/ops/pjoin.py::tile_sorted,
// the slab slot maps that engine/device_join.py built on the host, and the
// native host packer of the sample's table (native/kcf_native.cpp
// kcf_pjoin_hist and kcf_pjoin_pack, whose output it equals bit for bit;
// the JAX package does all three on the host: ops/pjoin.py::tile_sorted,
// engine/device_join.py::_finalize and _pack_tiles). From n sorted unique
// keys, P = 2^b quantile partitions, both callers share (route_starts,
// route_maxima):
//
//   start[p]        first key of partition p (start[P] = n), by a binary
//                   search a partition;
//   maxima          the largest partition, from which the caller picks the
//                   width Tq or Tt, and the largest count where the keys
//                   have counts (0 where not), which decides whether the
//                   sample's counts byte-pack.
//
// From the reference k-mers it then writes (route_tiles):
//
//   qh, ql (P, Tq)  each key's (hi, lo) halves at slot p * Tq + rank, zeros
//                   elsewhere (engine/encode.py::split_hi_lo's split);
//   slot_of_ord[i]  key i's slot;
//
// for the stacked slabs of a layout, from each position's reference
// ordinal r_idx (-1 where no valid k-mer starts) (route_slabs):
//
//   slot_maps       slot_of_ord[r_idx], 0 where r_idx < 0;
//   valid bitmap    bit j of byte m set where position 8m + j is live
//                   (np.packbits(live, bitorder="little"));
//
// and from a sample's keys and uint32 counts the join's table operand
// (sample_tiles):
//
//   [hi | lo | c]   (P, Tt) planes of each key's halves at slot
//                   p * Tt + rank, zeros elsewhere; c the (P, Tt) counts,
//                   or where every count is <= 255 (P, Tt / 4) words with
//                   byte m of word j holding the count of rank m * Tt/4 + j
//                   (ops/pjoin.py::pack_planar).
//
// The partition id is ops/pjoin.py::quantile_partition_ids in native uint64:
// x = key << (64 - 2k) >> 32, F = (x << 32) - (x * x >> 1), F >> (63 - b),
// clamped to P - 1. Keys are sorted, so ids are monotone and a key's rank
// in its partition is i - start[id].
//
// What bounds it: device memory. Every kernel is elementwise over keys,
// slots or positions (one gather a live position), so each reads its
// operands once and writes its outputs once: at the lettuce cell's shapes
// (39.9 M reference keys, P = 2^16, Tq = 768, 3 slabs of 2^24 positions)
// about 1.8 GB, ~0.55 ms at 3.35 TB/s; a sample of 43.9 M keys at Tt = 896
// 1.06 GB (byte counts) to 1.23 GB, ~0.32-0.37 ms. The design keeps every
// access coalesced but the slot-map gather: a thread a key (neighbouring
// keys land in neighbouring slots of one partition, as ids step up at most
// once a few hundred keys), a position, or four slots of a partition, a
// column apart (neighbouring threads on neighbouring slots and keys; the
// four give one planar count word, so the count plane is written whole
// and no memset runs), and a warp ballot for each 32-bit word of the valid
// bitmap (positions come in whole warps: a slab's length is a multiple of
// 32). The starts take a binary search each (P searches of log2 n
// steps), not a pass over the keys.
//
// C entry points for ctypes; each returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 8;  // the grid-stride maxima: 8 an SM

__device__ __forceinline__ long long part_of(uint64_t key, int k, int b,
                                             long long last) {
  const uint64_t x = (key << (64 - 2 * k)) >> 32;
  const uint64_t f = (x << 32) - ((x * x) >> 1);
  const long long id = static_cast<long long>(f >> (63 - b));
  return id < last ? id : last;
}

// qh / ql (zeroed before the launch) and slot_of_ord, a thread a key.
__global__ void route_tiles(const uint64_t* __restrict__ keys, long long n,
                            int k, int b, const long long* __restrict__ start,
                            long long Tq, uint32_t* __restrict__ qh,
                            uint32_t* __restrict__ ql,
                            int32_t* __restrict__ slot_of_ord) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const uint64_t key = keys[i];
  const long long p = part_of(key, k, b, (1LL << b) - 1);
  const long long slot = p * Tq + (i - start[p]);
  const int n_lo = k > 16 ? k - 16 : 0;
  qh[slot] = static_cast<uint32_t>(key >> (2 * n_lo));
  ql[slot] = static_cast<uint32_t>(key & ((1ULL << (2 * n_lo)) - 1));
  slot_of_ord[i] = static_cast<int32_t>(slot);
}

// Slot maps and valid bitmap words of `total` positions (a multiple of 32,
// so each warp holds one whole word), a thread a position.
__global__ void route_slabs(const int32_t* __restrict__ r_idx,
                            long long total,
                            const int32_t* __restrict__ slot_of_ord,
                            int32_t* __restrict__ slot_maps,
                            uint32_t* __restrict__ valid) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= total) return;
  const int32_t r = r_idx[i];
  const bool live = r >= 0;
  slot_maps[i] = live ? __ldg(slot_of_ord + r) : 0;
  const unsigned word = __ballot_sync(0xffffffffu, live);
  if (!(threadIdx.x & 31)) valid[i >> 5] = word;
}

// start[q] = the first key whose partition is >= q, by a binary search over
// the sorted keys (ids are monotone), for q < P; start[P] = n.
__global__ void route_starts(const uint64_t* __restrict__ keys, long long n,
                             int k, int b, long long* __restrict__ start) {
  const long long q = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long P = 1LL << b;
  if (q > P) return;
  long long lo = 0, hi = n;
  if (q == P) lo = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (part_of(keys[mid], k, b, P - 1) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  start[q] = lo;
}

// maxima[0] = the most keys in any partition, maxima[1] = the largest of
// n_counts counts (both zeroed before the launch); a grid-stride loop, one
// atomic a block.
__global__ void route_maxima(const long long* __restrict__ start,
                             long long P,
                             const uint32_t* __restrict__ counts,
                             long long n_counts,
                             unsigned long long* __restrict__ maxima) {
  unsigned long long w = 0, c = 0;
  const long long m = n_counts > P ? n_counts : P;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < m; i += stride) {
    if (i < P) {
      const unsigned long long x =
          static_cast<unsigned long long>(start[i + 1] - start[i]);
      w = x > w ? x : w;
    }
    if (i < n_counts) {
      const unsigned long long x = counts[i];
      c = x > c ? x : c;
    }
  }
  for (int off = 16; off; off >>= 1) {
    const unsigned long long ow = __shfl_down_sync(0xffffffffu, w, off);
    const unsigned long long oc = __shfl_down_sync(0xffffffffu, c, off);
    w = ow > w ? ow : w;
    c = oc > c ? oc : c;
  }
  __shared__ unsigned long long warp_w[kThreads / 32], warp_c[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (!lane) {
    warp_w[warp] = w;
    warp_c[warp] = c;
  }
  __syncthreads();
  if (!warp) {
    w = lane < kThreads / 32 ? warp_w[lane] : 0;
    c = lane < kThreads / 32 ? warp_c[lane] : 0;
    for (int off = 4; off; off >>= 1) {
      const unsigned long long ow = __shfl_down_sync(0xffffffffu, w, off);
      const unsigned long long oc = __shfl_down_sync(0xffffffffu, c, off);
      w = ow > w ? ow : w;
      c = oc > c ? oc : c;
    }
    if (!lane) {
      if (w) atomicMax(maxima, w);
      if (c) atomicMax(maxima + 1, c);
    }
  }
}

// The (P, Tt) table planes, a thread four slots of one partition: thread
// t = p * W + j (W = Tt / 4) writes ranks j, j + W, j + 2W, j + 3W of
// partition p, the key of that rank where the partition has one, zeros
// elsewhere; packed, their four counts' low bytes as word p * W + j.
__global__ void sample_tiles(const uint64_t* __restrict__ keys,
                             const uint32_t* __restrict__ counts,
                             const long long* __restrict__ start, int k,
                             long long P, long long Tt, int packed,
                             uint32_t* __restrict__ hi,
                             uint32_t* __restrict__ lo,
                             uint32_t* __restrict__ cnt) {
  const long long W = Tt >> 2;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= P * W) return;
  const long long p = t / W, j = t - p * W;
  const long long a = start[p], e = start[p + 1];
  const int n_lo = k > 16 ? k - 16 : 0;
  const uint64_t lo_mask = (1ULL << (2 * n_lo)) - 1;
  uint32_t word = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const long long r = j + m * W, i = a + r, slot = p * Tt + r;
    uint64_t key = 0;
    uint32_t c = 0;
    if (i < e) {
      key = keys[i];
      c = counts[i];
    }
    hi[slot] = static_cast<uint32_t>(key >> (2 * n_lo));
    lo[slot] = static_cast<uint32_t>(key & lo_mask);
    if (packed) {
      word |= (c & 0xFFu) << (8 * m);
    } else {
      cnt[slot] = c;
    }
  }
  if (packed) cnt[t] = word;
}

unsigned blocks(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// start (P + 1 int64) and maxima (two uint64: the largest partition, the
// largest count) from the n sorted keys and, where counts is not null,
// their uint32 counts (maxima[1] = 0 where it is).
extern "C" int kcf_route_starts(const void* keys, long long n,
                                const void* counts, int k, int b,
                                void* start, void* maxima, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long P = 1LL << b, n_counts = counts ? n : 0;
  cudaError_t err =
      cudaMemsetAsync(maxima, 0, 2 * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  route_starts<<<blocks(P + 1), kThreads, 0, st>>>(
      static_cast<const uint64_t*>(keys), n, k, b,
      static_cast<long long*>(start));
  const long long m = n_counts > P ? n_counts : P;
  const unsigned grid = blocks(m) < kMaxBlocks ? blocks(m) : kMaxBlocks;
  route_maxima<<<grid, kThreads, 0, st>>>(
      static_cast<const long long*>(start), P,
      static_cast<const uint32_t*>(counts), n_counts,
      static_cast<unsigned long long*>(maxima));
  return static_cast<int>(cudaGetLastError());
}

// The (P, Tq) tiles and slot_of_ord, given start and Tq.
extern "C" int kcf_route_tiles(const void* keys, long long n, int k, int b,
                               const void* start, long long Tq, void* qh,
                               void* ql, void* slot_of_ord, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t tile_bytes = (1ULL << b) * Tq * sizeof(uint32_t);
  cudaError_t err = cudaMemsetAsync(qh, 0, tile_bytes, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(ql, 0, tile_bytes, st);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  route_tiles<<<blocks(n), kThreads, 0, st>>>(
      static_cast<const uint64_t*>(keys), n, k, b,
      static_cast<const long long*>(start), Tq, static_cast<uint32_t*>(qh),
      static_cast<uint32_t*>(ql), static_cast<int32_t*>(slot_of_ord));
  return static_cast<int>(cudaGetLastError());
}

// Slot maps and valid bitmaps of `total` stacked slab positions.
extern "C" int kcf_route_slabs(const void* r_idx, long long total,
                               const void* slot_of_ord, void* slot_maps,
                               void* valid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total == 0) return 0;
  route_slabs<<<blocks(total), kThreads, 0, st>>>(
      static_cast<const int32_t*>(r_idx), total,
      static_cast<const int32_t*>(slot_of_ord),
      static_cast<int32_t*>(slot_maps), static_cast<uint32_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

// The flat [hi | lo | counts] table buffer of (P, Tt) planes (Tt a multiple
// of 4), given start; the counts plane (P, Tt / 4) words where packed.
extern "C" int kcf_sample_tiles(const void* keys, const void* counts,
                                const void* start, int k, int b,
                                long long Tt, int packed, void* tiles,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long P = 1LL << b, nt = P * Tt;
  uint32_t* hi = static_cast<uint32_t*>(tiles);
  sample_tiles<<<blocks(nt / 4), kThreads, 0, st>>>(
      static_cast<const uint64_t*>(keys),
      static_cast<const uint32_t*>(counts),
      static_cast<const long long*>(start), k, P, Tt, packed, hi, hi + nt,
      hi + 2 * nt);
  return static_cast<int>(cudaGetLastError());
}
