// The gap-run summary shared by the window scan kernels (gapscan.cu,
// hashscan.cu): its fields, its associative combine, one 32-position word's
// summary from bit arithmetic and the ordered combine across a warp.
//
// A summary of a range of k-mer start positions:
//   nval  valid positions;           obs   present positions;
//   lead  valid positions before the first present (nval if none);
//   trail valid positions after the last present (nval if none);
//   var   closed gaps: g > 0 valid positions between consecutive presents;
//   dist  the sum of dist(g), d = g - (k - 1), dist = d > 0 ? d : |d + 1|;
//   csum  the sum of the counts of the present positions.
// Two ranges A, B with present positions on both sides close one more gap
// of g = A.trail + B.lead if g > 0. A range's statistics are then
//   left = obs ? lead : 0, right = obs ? trail : nval, inner = dist,
//   variations = obs ? var + (lead > 0) + (trail > 0) : (nval > 0)
// (Plugins/GetVariants.java:219-273).
//
// Each source that includes this file is its own library, so the
// definitions stay local to it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Sum {
  int nval, obs, lead, trail, var;
  long long dist, csum;
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
// and both are masked to the range. csum is left 0.
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

}  // namespace
