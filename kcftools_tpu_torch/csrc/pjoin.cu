// Partitioned all-pairs k-mer join for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels kcftools_tpu/ops/pjoin.py::_kernel and
// ::_kernel_packed (with _unpack_planar), launched by _pjoin_fn. For every
// partition p and query slot q it computes
//
//   out[p, q] = sum_t [qh[p,q] == th[p,t] && ql[p,q] == tl[p,t]] * tc[p,t]
//
// summed over ALL matching slots, as the TPU kernel does (padding slots are
// key (0, 0) with count 0 and also match the all-A k-mer's query), in
// uint32, written as its bit pattern into the int32 output.
//
// Design (simple first): one block per partition, grid-striding over P.
// The block stages its partition's table keys and unpacked counts in
// shared memory in fixed chunks of kChunk slots (12 KB, under the 48 KB
// static limit for any table width Tt, which grows with the sample); each
// thread owns queries q = tid, tid + blockDim, ... and sums the chunk's
// matching counts, adding into its own output words across chunks. All
// threads of a warp read the same shared-memory slot, so the reads are
// broadcasts without bank conflicts.
//
// What bounds it: Tq * Tt key compares per partition (~10^3 x 10^3 at the
// main path's shapes, ~7 * 10^10 for a 2^16-partition join), i.e. integer
// ALU and shared-memory load throughput, not device memory: each partition's
// operands are read once. A per-query binary search over the sorted tile
// would do Tq * log2(Tt) work instead, but needs per-partition lengths the
// upload buffer does not carry.
//
// C entry point for ctypes: kcf_pjoin_launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;
constexpr int kMaxGrid = 65535;

template <bool PACKED>
__global__ void __launch_bounds__(kThreads)
pjoin_kernel(const uint32_t* __restrict__ qh, const uint32_t* __restrict__ ql,
             const uint32_t* __restrict__ th, const uint32_t* __restrict__ tl,
             const uint32_t* __restrict__ tc, uint32_t* __restrict__ out,
             int P, int Tq, int Tt) {
  __shared__ uint2 s_key[kChunk];
  __shared__ uint32_t s_cnt[kChunk];
  const int W = Tt >> 2;                 // packed: words per partition
  const int Tc = PACKED ? W : Tt;        // count operand row width
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const size_t qoff = (size_t)p * Tq;
    const size_t toff = (size_t)p * Tt;
    const uint32_t* tcp = tc + (size_t)p * Tc;
    for (int c0 = 0; c0 < Tt; c0 += kChunk) {
      const int n = min(kChunk, Tt - c0);
      __syncthreads();  // the previous chunk's readers are done
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int s = c0 + i;
        s_key[i] = make_uint2(th[toff + s], tl[toff + s]);
        if (PACKED) {
          // planar bytes: byte b of word j is the count of slot b*W + j
          s_cnt[i] = (tcp[s % W] >> (8 * (s / W))) & 0xFFu;
        } else {
          s_cnt[i] = tcp[s];
        }
      }
      __syncthreads();
      for (int q = threadIdx.x; q < Tq; q += blockDim.x) {
        const uint32_t h = qh[qoff + q];
        const uint32_t l = ql[qoff + q];
        uint32_t acc = 0;
#pragma unroll 8
        for (int i = 0; i < n; ++i) {
          const uint2 key = s_key[i];
          acc += (key.x == h && key.y == l) ? s_cnt[i] : 0u;
        }
        out[qoff + q] = (c0 == 0) ? acc : out[qoff + q] + acc;
      }
    }
  }
}

}  // namespace

extern "C" int kcf_pjoin_launch(const void* qh, const void* ql,
                                const void* th, const void* tl,
                                const void* tc, void* out, int P, int Tq,
                                int Tt, int packed, void* stream) {
  const dim3 grid(P < kMaxGrid ? P : kMaxGrid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(qh);
  const uint32_t* b = static_cast<const uint32_t*>(ql);
  const uint32_t* c = static_cast<const uint32_t*>(th);
  const uint32_t* d = static_cast<const uint32_t*>(tl);
  const uint32_t* e = static_cast<const uint32_t*>(tc);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (packed) {
    pjoin_kernel<true><<<grid, kThreads, 0, st>>>(a, b, c, d, e, o, P, Tq, Tt);
  } else {
    pjoin_kernel<false><<<grid, kThreads, 0, st>>>(a, b, c, d, e, o, P, Tq, Tt);
  }
  return static_cast<int>(cudaGetLastError());
}
