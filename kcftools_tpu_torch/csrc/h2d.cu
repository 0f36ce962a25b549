// The device join's host-to-device copies, staged through pinned memory.
//
// Replaces no TPU kernel: the JAX package hands its host arrays to
// jax.device_put. A copy from pageable memory runs at CUDA's own
// single-threaded staging rate (~5-6 GB/s on the H100's host, whether the
// source is a mapped file or the heap); a copy from pinned memory at the
// link's (45-55 GB/s there). kcf_h2d_staged copies host memory through
// `workers` pinned buffers of `chunk` bytes, one a host thread (the caller
// is the first): each thread takes the next chunk of all the copies (one
// atomic counter), waits for its buffer's last DMA (an event), memcpys the
// chunk into the buffer, queues its cudaMemcpyAsync on the caller's stream
// and records the event. So the fills run side by side with no lock or
// barrier between them (a thread that the OS stalls holds back only its
// own chunk), and the DMAs overlap them. What bounds it: the host's memory
// copy (~15-20 GB/s on that host), not the link. It returns once every
// buffer's last DMA is done, so the caller may free or reuse the buffers.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

namespace {

struct Staging {
  void* const* dsts;
  const void* const* srcs;
  const long long* sizes;
  char* buffers;
  long long chunk;
  cudaStream_t stream;
  int device;
  std::vector<std::pair<int, long long>> jobs;  // (copy, offset)
  std::vector<cudaEvent_t> done;                 // a worker's buffer's DMA
  std::atomic<long long> next{0};
  std::atomic<int> failed{0};

  void work(int w) {
    cudaError_t e = cudaSetDevice(device);
    char* buf = buffers + w * chunk;
    const long long n_jobs = static_cast<long long>(jobs.size());
    for (long long j; e == cudaSuccess && failed.load() == 0 &&
                      (j = next.fetch_add(1)) < n_jobs;) {
      const int c = jobs[j].first;
      const long long off = jobs[j].second;
      const long long m = std::min(chunk, sizes[c] - off);
      e = cudaEventSynchronize(done[w]);  // at once before its 1st record
      if (e != cudaSuccess) break;
      std::memcpy(buf, static_cast<const char*>(srcs[c]) + off, m);
      e = cudaMemcpyAsync(static_cast<char*>(dsts[c]) + off, buf, m,
                          cudaMemcpyHostToDevice, stream);
      if (e == cudaSuccess) e = cudaEventRecord(done[w], stream);
    }
    int expected = 0;
    if (e != cudaSuccess)
      failed.compare_exchange_strong(expected, static_cast<int>(e));
  }
};

}  // namespace

// Copy n_copies host regions (srcs[c], sizes[c] bytes) to device memory
// (dsts[c]) on `stream`, through `workers` pinned buffers of `chunk` bytes
// laid end to end at `buffers`. Returns a CUDA error code, or -1 where a
// host thread could not start.
extern "C" int kcf_h2d_staged(void* const* dsts, const void* const* srcs,
                              const long long* sizes, int n_copies,
                              void* buffers, long long chunk, int workers,
                              void* stream) {
  Staging s;
  s.dsts = dsts;
  s.srcs = srcs;
  s.sizes = sizes;
  s.buffers = static_cast<char*>(buffers);
  s.chunk = chunk;
  s.stream = static_cast<cudaStream_t>(stream);
  for (int c = 0; c < n_copies; ++c)
    for (long long off = 0; off < sizes[c]; off += chunk)
      s.jobs.emplace_back(c, off);
  if (s.jobs.empty()) return 0;
  workers = static_cast<int>(
      std::min<long long>(workers, static_cast<long long>(s.jobs.size())));
  cudaError_t err = cudaGetDevice(&s.device);
  for (int w = 0; err == cudaSuccess && w < workers; ++w) {
    cudaEvent_t ev;
    err = cudaEventCreateWithFlags(
        &ev, cudaEventDisableTiming | cudaEventBlockingSync);
    if (err == cudaSuccess) s.done.push_back(ev);
  }
  int rc = static_cast<int>(err);
  if (err == cudaSuccess) {
    std::vector<std::thread> pool;
    try {
      for (int w = 1; w < workers; ++w) pool.emplace_back(&Staging::work, &s, w);
    } catch (...) {
      int expected = 0;
      s.failed.compare_exchange_strong(expected, -1);
    }
    s.work(0);
    for (auto& t : pool) t.join();
    rc = s.failed.load();
  }
  for (cudaEvent_t ev : s.done) {
    const cudaError_t e = cudaEventSynchronize(ev);
    if (rc == 0 && e != cudaSuccess) rc = static_cast<int>(e);
    cudaEventDestroy(ev);
  }
  return rc;
}
