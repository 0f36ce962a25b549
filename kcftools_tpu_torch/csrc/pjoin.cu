// Partitioned k-mer join for Hopper (sm_90a): a hash probe in shared memory.
//
// Replaces the Pallas TPU kernels kcftools_tpu/ops/pjoin.py::_kernel and
// ::_kernel_packed (with _unpack_planar), launched by _pjoin_fn. For every
// partition p and query slot q it computes
//
//   out[p, q] = sum_t [qh[p,q] == th[p,t] && ql[p,q] == tl[p,t]] * tc[p,t]
//
// summed over ALL matching slots, as the TPU kernel does (padding slots are
// key (0, 0) with count 0 and also match the all-A k-mer's query), in
// uint32 (wrapping mod 2^32), written as its bit pattern into the int32
// output. The contract holds for any operands: unsorted tiles, duplicate
// keys, any key value, any Tq and Tt.
//
// What bounds it: device memory. Each operand is read once and the output
// written once: at the main path's shapes (P = 2^16, Tq = Tt = 1024) that
// is 1.61 GB with uint32 counts and 1.41 GB with byte-packed counts, 0.48
// and 0.42 ms at 3.35 TB/s. The all-pairs join this file held before did
// Tq * Tt key compares per partition (~7 * 10^10 a launch) and sat at ~3%
// of that bound.
//
// What the design does about it: O(Tq + Tt) shared-memory work per
// partition, and copies that overlap it.
// - A persistent grid (as many blocks as fit on the SMs) walks over the
//   partitions. Each block keeps one partition's rows (table keys and
//   counts, query keys; contiguous per partition) in shared memory and
//   refills them with cp.async in two halves: the next partition's table
//   rows land while this one is probed (the hash table holds its keys by
//   then), its query rows while it is cleared and built.
// - Build: an open-addressed table of S >= 4 * Tt slots (a power of two):
//   64-bit key (hi << 32 | lo) and a uint32 count per slot, slot by
//   multiply-shift of the whole key (a quantile partition's keys share
//   their top bits), linear probing. Insert claims an EMPTY slot with a
//   64-bit atomicCAS; the count goes in with atomicAdd, so duplicate keys
//   sum as the all-pairs sum does. A slot whose count is 0 adds nothing to
//   any sum and is not inserted (the padding). The EMPTY marker is all ones;
//   a table key equal to it sums into one accumulator of its own, so no key
//   value is special.
// - Probe: each thread takes queries, walks from the query's slot to its
//   key or to EMPTY, and writes the sum; the EMPTY key reads the
//   accumulator.
// - Wide rows: when the rows and the table do not fit the shared-memory
//   budget of two blocks per SM, a second variant reads the rows from
//   device memory directly and builds the table from at most kChunkMax
//   keys at a time: build, probe, add to the output, rebuild.
//
// Measured on an H100 at the main shapes, the time beyond the bare copy
// stream goes to the probe's walks and the build's 64-bit atomicCAS. The
// sizes here measured fastest: 512 threads a block, a load of at most 1/4
// (shorter walks), and one row buffer refilled in halves (68 KB a block,
// three blocks per SM) rather than two whole buffers (88 KB, two blocks).
// A load of 1/2, 256, 384 or 1,024 threads a block, slots of 16 bytes with
// the count beside the key, a claim by 32-bit CAS, and two queries walked
// together by one thread were all slower.
//
// C entry point for ctypes: kcf_pjoin_launch returns a cudaError_t.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr unsigned long long kEmpty = ~0ull;
constexpr size_t kStagedMaxBytes = 113 * 1024;  // >= two blocks per SM
constexpr int kChunkMax = 2048;  // table keys per build in the chunked variant
constexpr int kMinSlotsLog2 = 6;

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ __forceinline__ int slots_log2(int n_keys) {
  int b = kMinSlotsLog2;
  while ((1ll << b) < 4ll * n_keys) ++b;  // load <= 1/4
  return b;
}

__host__ __device__ __forceinline__ size_t table_bytes(int log2s) {
  // keys, counts, and 16 bytes for the EMPTY key's accumulator
  return ((size_t)12 << log2s) + 16;
}

__device__ __forceinline__ unsigned long long make_key(uint32_t hi,
                                                       uint32_t lo) {
  return ((unsigned long long)hi << 32) | lo;
}

__device__ __forceinline__ unsigned slot_of(unsigned long long key,
                                            int log2s) {
  return (unsigned)((key * 0x9E3779B97F4A7C15ull) >> (64 - log2s));
}

struct Table {
  unsigned long long* keys;
  uint32_t* cnt;
  uint32_t* empty_acc;
  int log2s;

  __device__ __forceinline__ Table(unsigned char* smem, int log2s_)
      : keys(reinterpret_cast<unsigned long long*>(smem)),
        cnt(reinterpret_cast<uint32_t*>(smem + ((size_t)8 << log2s_))),
        empty_acc(cnt + (1 << log2s_)),
        log2s(log2s_) {}

  // all threads; the caller syncs before the next use
  __device__ __forceinline__ void clear() const {
    const int S = 1 << log2s;
    ulonglong2* k2 = reinterpret_cast<ulonglong2*>(keys);
    for (int i = threadIdx.x; i < S / 2; i += blockDim.x) {
      k2[i] = make_ulonglong2(kEmpty, kEmpty);
    }
    uint4* c4 = reinterpret_cast<uint4*>(cnt);
    for (int i = threadIdx.x; i < S / 4; i += blockDim.x) {
      c4[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    if (threadIdx.x == 0) *empty_acc = 0u;
  }

  __device__ __forceinline__ void insert(unsigned long long key,
                                         uint32_t c) const {
    if (c == 0u) return;  // adds nothing to any sum
    if (key == kEmpty) {
      atomicAdd(empty_acc, c);
      return;
    }
    const unsigned mask = (1u << log2s) - 1u;
    const volatile unsigned long long* vkeys = keys;
    unsigned s = slot_of(key, log2s);
    while (true) {
      // a slot's key, once set, stays for the whole build: only a read of
      // EMPTY can be stale, and the CAS settles it
      unsigned long long cur = vkeys[s];
      if (cur == kEmpty) {
        cur = atomicCAS(&keys[s], kEmpty, key);
        if (cur == kEmpty) cur = key;
      }
      if (cur == key) {
        atomicAdd(&cnt[s], c);  // wraps mod 2^32, as the reference sum
        return;
      }
      s = (s + 1u) & mask;
    }
  }

  __device__ __forceinline__ uint32_t probe(unsigned long long key,
                                            uint32_t empty_sum) const {
    if (key == kEmpty) return empty_sum;
    const unsigned mask = (1u << log2s) - 1u;
    unsigned s = slot_of(key, log2s);
    while (true) {
      const unsigned long long cur = keys[s];
      if (cur == key) return cnt[s];
      if (cur == kEmpty) return 0u;  // load <= 1/4: an EMPTY slot exists
      s = (s + 1u) & mask;
    }
  }
};

// s / W as a multiply and a shift, for 0 <= s < 2^31 and W >= 1:
// m = ceil(2^(31 + l) / W) with l = ceil(log2 W) (Granlund and
// Montgomery), so that the packed counts' planar index costs no division.
struct DivW {
  unsigned long long m;
  int sh;
  int W;

  __device__ __forceinline__ explicit DivW(int W_) : W(W_) {
    int l = 0;
    while ((1 << l) < W_) ++l;
    sh = 31 + l;
    m = ((1ull << sh) + W_ - 1) / W_;
  }
  __device__ __forceinline__ int div(int s) const {
    return (int)(((unsigned long long)s * m) >> sh);
  }
};

// The count of table slot s: a uint32 word, or byte s / W of word s % W in
// the planar packed layout (W = Tt / 4).
template <bool PACKED>
__device__ __forceinline__ uint32_t count_of(const uint32_t* tcp, int s,
                                             const DivW& dw) {
  if (PACKED) {
    const int b = dw.div(s);
    return (tcp[s - b * dw.W] >> (8 * b)) & 0xFFu;
  }
  return tcp[s];
}

// n words from device memory into shared memory, asynchronously: 16-byte
// copies when ``vec`` (n % 4 == 0 and both rows 16-byte aligned), else 4.
__device__ __forceinline__ void copy_row(uint32_t* dst, const uint32_t* src,
                                         int n, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < (n >> 2); i += blockDim.x) {
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      __pipeline_memcpy_async(dst + i, src + i, 4);
    }
  }
}

// Staged variant: one partition at a time, its rows in one buffer in
// shared memory beside the table; the whole table row fits one build. The
// buffer's two halves are refilled in turn: once the table holds
// partition p's keys, the next partition's table rows (T) land while p is
// probed; once p is probed, its query rows (Q) land while the next
// partition is cleared and built.
template <bool PACKED>
__global__ void __launch_bounds__(kThreads)
pjoin_staged(const uint32_t* __restrict__ qh, const uint32_t* __restrict__ ql,
             const uint32_t* __restrict__ th, const uint32_t* __restrict__ tl,
             const uint32_t* __restrict__ tc, uint32_t* __restrict__ out,
             int P, int Tq, int Tt, int log2s, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Table table(smem, log2s);
  const int W = Tt >> 2;
  const int Tc = PACKED ? W : Tt;
  const DivW dw(PACKED ? W : 1);
  const int Tp = round4(Tt), Cp = round4(Tc), Qp = round4(Tq);
  uint32_t* sth = reinterpret_cast<uint32_t*>(smem + table_bytes(log2s));
  uint32_t* stl = sth + Tp;
  uint32_t* stc = stl + Tp;
  uint32_t* sqh = stc + Cp;
  uint32_t* sql = sqh + Qp;

  auto stage_t = [&](int p) {
    copy_row(sth, th + (size_t)p * Tt, Tt, vec);
    copy_row(stl, tl + (size_t)p * Tt, Tt, vec);
    copy_row(stc, tc + (size_t)p * Tc, Tc, vec);
  };
  auto stage_q = [&](int p) {
    copy_row(sqh, qh + (size_t)p * Tq, Tq, vec);
    copy_row(sql, ql + (size_t)p * Tq, Tq, vec);
  };

  // copy groups are committed in the order T_p, Q_p, T_p', Q_p', ...:
  // waiting for all but the newest group waits for the one needed next
  int p = blockIdx.x;
  if (p < P) stage_t(p);
  __pipeline_commit();
  if (p < P) stage_q(p);
  __pipeline_commit();
  for (; p < P; p += gridDim.x) {
    const int pn = p + gridDim.x;
    table.clear();
    __pipeline_wait_prior(1);  // T_p has landed
    __syncthreads();
    // one slot a thread at a time over the whole row (the packed words'
    // four planes too): the walks' latency hides behind all the threads
    for (int s = threadIdx.x; s < Tt; s += blockDim.x) {
      table.insert(make_key(sth[s], stl[s]), count_of<PACKED>(stc, s, dw));
    }
    __syncthreads();
    if (pn < P) stage_t(pn);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // Q_p has landed
    __syncthreads();

    const uint32_t empty_sum = *table.empty_acc;
    uint32_t* o = out + (size_t)p * Tq;
    for (int q = threadIdx.x; q < Tq; q += blockDim.x) {
      o[q] = table.probe(make_key(sqh[q], sql[q]), empty_sum);
    }
    __syncthreads();  // the table and the query rows are reused next
    if (pn < P) stage_q(pn);
    __pipeline_commit();
  }
}

// Chunked variant for rows too wide to stage: rows read from device memory,
// the table built from ``chunk`` keys at a time, each chunk's sums added
// into the output (each thread rereads only what it wrote).
template <bool PACKED>
__global__ void __launch_bounds__(kThreads)
pjoin_chunked(const uint32_t* __restrict__ qh,
              const uint32_t* __restrict__ ql,
              const uint32_t* __restrict__ th,
              const uint32_t* __restrict__ tl,
              const uint32_t* __restrict__ tc, uint32_t* __restrict__ out,
              int P, int Tq, int Tt, int log2s, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Table table(smem, log2s);
  const int W = Tt >> 2;
  const int Tc = PACKED ? W : Tt;
  const DivW dw(PACKED ? W : 1);
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const size_t qoff = (size_t)p * Tq;
    const size_t toff = (size_t)p * Tt;
    const uint32_t* tcp = tc + (size_t)p * Tc;
    for (int c0 = 0; c0 < Tt; c0 += chunk) {
      const int n = min(chunk, Tt - c0);
      table.clear();
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int s = c0 + i;
        table.insert(make_key(th[toff + s], tl[toff + s]),
                     count_of<PACKED>(tcp, s, dw));
      }
      __syncthreads();
      const uint32_t empty_sum = *table.empty_acc;
      for (int q = threadIdx.x; q < Tq; q += blockDim.x) {
        const uint32_t r =
            table.probe(make_key(qh[qoff + q], ql[qoff + q]), empty_sum);
        out[qoff + q] = (c0 == 0) ? r : out[qoff + q] + r;
      }
      __syncthreads();
    }
  }
}

template <typename Kernel>
cudaError_t launch_persistent(Kernel kernel, size_t smem, int P,
                              cudaStream_t st, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = (long long)per_sm * sms;
  *grid = (int)(P < fit ? P : fit);
  return cudaSuccess;
}

template <bool PACKED>
cudaError_t pjoin_launch(const uint32_t* qh, const uint32_t* ql,
                         const uint32_t* th, const uint32_t* tl,
                         const uint32_t* tc, uint32_t* out, int P, int Tq,
                         int Tt, cudaStream_t st) {
  const int Tc = PACKED ? Tt / 4 : Tt;
  // (in size_t: any Tq, Tt below 2^31 must pick a variant, not overflow)
  const size_t stage_bytes =
      4 * (2 * ((size_t)Tt + 3) + ((size_t)Tc + 3) + 2 * ((size_t)Tq + 3));
  int log2s = slots_log2(Tt);
  const size_t staged = table_bytes(log2s) + stage_bytes;
  int grid = 0;
  cudaError_t err;
  if (staged <= kStagedMaxBytes) {
    const uintptr_t any = (uintptr_t)qh | (uintptr_t)ql | (uintptr_t)th |
                          (uintptr_t)tl | (uintptr_t)tc;
    const int vec = (any % 16 == 0) && Tt % 4 == 0 && Tc % 4 == 0 &&
                    Tq % 4 == 0;
    err = launch_persistent(pjoin_staged<PACKED>, staged, P, st, &grid);
    if (err != cudaSuccess) return err;
    pjoin_staged<PACKED><<<grid, kThreads, staged, st>>>(
        qh, ql, th, tl, tc, out, P, Tq, Tt, log2s, vec);
  } else {
    const int chunk = Tt < kChunkMax ? Tt : kChunkMax;
    log2s = slots_log2(chunk);
    const size_t smem = table_bytes(log2s);
    err = launch_persistent(pjoin_chunked<PACKED>, smem, P, st, &grid);
    if (err != cudaSuccess) return err;
    pjoin_chunked<PACKED><<<grid, kThreads, smem, st>>>(
        qh, ql, th, tl, tc, out, P, Tq, Tt, log2s, chunk);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int kcf_pjoin_launch(const void* qh, const void* ql,
                                const void* th, const void* tl,
                                const void* tc, void* out, int P, int Tq,
                                int Tt, int packed, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(qh);
  const uint32_t* b = static_cast<const uint32_t*>(ql);
  const uint32_t* c = static_cast<const uint32_t*>(th);
  const uint32_t* d = static_cast<const uint32_t*>(tl);
  const uint32_t* e = static_cast<const uint32_t*>(tc);
  uint32_t* o = static_cast<uint32_t*>(out);
  const cudaError_t err =
      packed ? pjoin_launch<true>(a, b, c, d, e, o, P, Tq, Tt, st)
             : pjoin_launch<false>(a, b, c, d, e, o, P, Tq, Tt, st);
  return static_cast<int>(err);
}
