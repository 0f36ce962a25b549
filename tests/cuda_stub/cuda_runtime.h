// A host-only stand-in for the CUDA runtime calls of
// kcftools_tpu_torch/csrc/h2d.cu, so that its host code builds with g++
// and runs in the CPU tests (tests/test_torch_stagetimer.py).
//
// One stream for every stream handle: a thread that runs the queued work
// in order. An async copy reads its source only when it runs, after a
// delay (kcf_stub_set_delay_us), as a DMA reads a pinned buffer; so a
// buffer refilled before its copy ran, or a call that returned before
// its last copy ran, shows in the destination. An event records the
// queue's length; synchronising waits until that much of it has run.
#pragma once

#include <chrono>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <utility>

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaMemcpyKind { cudaMemcpyHostToDevice = 1 };
typedef struct CUstream_st* cudaStream_t;
typedef struct StubEvent* cudaEvent_t;
#define cudaEventBlockingSync 0x01
#define cudaEventDisableTiming 0x02

struct StubEvent {
  long long ticket = 0;  // the queue's length when last recorded
};

namespace kcf_stub {

struct Queue {
  std::mutex m;
  std::condition_variable cv;
  std::deque<std::function<void()>> work;
  long long queued = 0, ran = 0;
  int delay_us = 0;

  Queue() {
    std::thread([this] {
      for (;;) {
        std::unique_lock<std::mutex> lock(m);
        cv.wait(lock, [this] { return !work.empty(); });
        std::function<void()> fn = std::move(work.front());
        work.pop_front();
        const int us = delay_us;
        lock.unlock();
        std::this_thread::sleep_for(std::chrono::microseconds(us));
        fn();
        lock.lock();
        ++ran;
        cv.notify_all();
      }
    }).detach();
  }
};

// Never destroyed: its thread runs until the process ends.
inline Queue& queue() {
  static Queue* q = new Queue();
  return *q;
}

}  // namespace kcf_stub

// Defined here, not inline: the header serves one translation unit.
extern "C" void kcf_stub_set_delay_us(int us) {
  std::lock_guard<std::mutex> lock(kcf_stub::queue().m);
  kcf_stub::queue().delay_us = us;
}

inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}

inline cudaError_t cudaSetDevice(int device) {
  return device == 0 ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t cudaEventCreateWithFlags(cudaEvent_t* ev, unsigned) {
  *ev = new StubEvent();
  return cudaSuccess;
}

inline cudaError_t cudaEventDestroy(cudaEvent_t ev) {
  delete ev;
  return cudaSuccess;
}

inline cudaError_t cudaEventRecord(cudaEvent_t ev, cudaStream_t) {
  std::lock_guard<std::mutex> lock(kcf_stub::queue().m);
  ev->ticket = kcf_stub::queue().queued;
  return cudaSuccess;
}

inline cudaError_t cudaEventSynchronize(cudaEvent_t ev) {
  kcf_stub::Queue& q = kcf_stub::queue();
  std::unique_lock<std::mutex> lock(q.m);
  const long long ticket = ev->ticket;
  q.cv.wait(lock, [&] { return q.ran >= ticket; });
  return cudaSuccess;
}

inline cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t n,
                                   cudaMemcpyKind, cudaStream_t) {
  kcf_stub::Queue& q = kcf_stub::queue();
  std::lock_guard<std::mutex> lock(q.m);
  q.work.emplace_back([=] { std::memcpy(dst, src, n); });
  ++q.queued;
  q.cv.notify_all();
  return cudaSuccess;
}
