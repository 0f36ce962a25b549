// The device join's reference routing for Hopper (sm_90a).
//
// Replaces the host numpy of kcftools_tpu_torch/ops/pjoin.py::tile_sorted
// and the slab slot maps that engine/device_join.py built on the host (the
// JAX package does the same on the host: ops/pjoin.py::tile_sorted and
// engine/device_join.py::_finalize). From the sorted unique reference
// k-mers it writes, for P = 2^b quantile partitions:
//
//   start[p]        first key of partition p (start[P] = n);
//   width           the largest partition, from which the caller picks Tq;
//   qh, ql (P, Tq)  each key's (hi, lo) halves at slot p * Tq + rank, zeros
//                   elsewhere (engine/encode.py::split_hi_lo's split);
//   slot_of_ord[i]  key i's slot;
//
// and, for the stacked slabs of a layout, from each position's reference
// ordinal r_idx (-1 where no valid k-mer starts):
//
//   slot_maps       slot_of_ord[r_idx], 0 where r_idx < 0;
//   valid bitmap    bit j of byte m set where position 8m + j is live
//                   (np.packbits(live, bitorder="little")).
//
// The partition id is ops/pjoin.py::quantile_partition_ids in native uint64:
// x = key << (64 - 2k) >> 32, F = (x << 32) - (x * x >> 1), F >> (63 - b),
// clamped to P - 1. Keys are sorted, so ids are monotone and a key's rank
// in its partition is i - start[id].
//
// What bounds it: device memory. Every kernel is elementwise over keys or
// positions (one gather a live position), so each reads its operands once
// and writes its outputs once: at the lettuce cell's shapes (39.9 M keys,
// P = 2^16, Tq = 768, 3 slabs of 2^24 positions) about 1.8 GB, ~0.55 ms at
// 3.35 TB/s. The design keeps every access coalesced but the slot-map
// gather: a thread a key (neighbouring keys land in neighbouring slots of
// one partition, as ids step up at most once a few hundred keys) or a
// position, and a warp ballot for each 32-bit word of the valid bitmap
// (positions come in whole warps: a slab's length is a multiple of 32).
//
// C entry points for ctypes; each returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long part_of(uint64_t key, int k, int b,
                                             long long last) {
  const uint64_t x = (key << (64 - 2 * k)) >> 32;
  const uint64_t f = (x << 32) - ((x * x) >> 1);
  const long long id = static_cast<long long>(f >> (63 - b));
  return id < last ? id : last;
}

// start[q] = i for every partition q that key i opens (those after key
// i - 1's), and start[q] = n for the partitions after the last key's.
__global__ void route_starts(const uint64_t* __restrict__ keys, long long n,
                             int k, int b, long long* __restrict__ start) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const long long P = 1LL << b;
  const long long p = part_of(keys[i], k, b, P - 1);
  const long long prev = i ? part_of(keys[i - 1], k, b, P - 1) : -1;
  for (long long q = prev + 1; q <= p; ++q) start[q] = i;
  if (i == n - 1) {
    for (long long q = p + 1; q <= P; ++q) start[q] = n;
  }
}

// *width = the most keys in any partition (zeroed before the launch).
__global__ void route_width(const long long* __restrict__ start, long long P,
                            unsigned long long* __restrict__ width) {
  const long long q = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  unsigned long long c = 0;
  if (q < P) c = static_cast<unsigned long long>(start[q + 1] - start[q]);
  for (int off = 16; off; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, c, off);
    c = o > c ? o : c;
  }
  __shared__ unsigned long long warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (!lane) warp_max[warp] = c;
  __syncthreads();
  if (!warp) {
    c = lane < kThreads / 32 ? warp_max[lane] : 0;
    for (int off = 4; off; off >>= 1) {
      const unsigned long long o = __shfl_down_sync(0xffffffffu, c, off);
      c = o > c ? o : c;
    }
    if (!lane && c) atomicMax(width, c);
  }
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

unsigned blocks(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// start (P + 1 int64) and width (one uint64) from the n sorted keys.
extern "C" int kcf_route_starts(const void* keys, long long n, int k, int b,
                                void* start, void* width, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long P = 1LL << b;
  cudaError_t err = cudaMemsetAsync(width, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) {
    err = cudaMemsetAsync(start, 0, (P + 1) * sizeof(long long), st);
    return static_cast<int>(err);
  }
  route_starts<<<blocks(n), kThreads, 0, st>>>(
      static_cast<const uint64_t*>(keys), n, k, b,
      static_cast<long long*>(start));
  route_width<<<blocks(P), kThreads, 0, st>>>(
      static_cast<const long long*>(start), P,
      static_cast<unsigned long long*>(width));
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
