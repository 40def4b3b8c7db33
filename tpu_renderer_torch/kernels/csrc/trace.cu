// The device stamps of the program's trace (utils/profiling.py: tracing,
// device_span, device_frame). Replaces no kernel of the JAX package: the
// TPU program has no spans of its own; this one names the stages of a frame
// where the frame runs, inside a replayed CUDA graph and inside the
// conditional nodes of its peel loop, where a profiler sees nothing.
//
// A stamp is one thread of one block: it reads the card's global timer
// (%globaltimer, nanoseconds) and appends (tag, time, instance, frame) to a
// preallocated log at an atomicAdd cursor. The cursor keeps counting past
// the log's capacity, so what was dropped is cursor - capacity. instance is
// read on the card when given (a peel pass's number, the `layers` count of
// pipeline._peel_on_device), so each pass of a WHILE body stamps its own.
// A frame's first stamp bumps the device frame counter, so stamps replayed
// from one graph still carry the frame they ran in. Bound by launch latency
// alone: 32 bytes written a stamp.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// state[0]: the cursor; state[1]: the device frame counter
__global__ void stamp_kernel(long long* log, long long* state, long long capacity,
                             long long tag, const int* instance, int new_frame) {
  long long t = global_ns();
  if (new_frame) state[1] += 1;
  unsigned long long i =
      atomicAdd(reinterpret_cast<unsigned long long*>(state), 1ull);
  if (i >= static_cast<unsigned long long>(capacity)) return;
  long long* e = log + 4 * i;
  e[0] = tag;
  e[1] = t;
  e[2] = instance != nullptr ? static_cast<long long>(*instance) : -1;
  e[3] = state[1];
}

__global__ void clock_kernel(long long* out) { *out = global_ns(); }

// The smallest nonzero step between n consecutive reads of the timer.
__global__ void timer_step_kernel(long long* out, int n) {
  long long last = global_ns(), best = -1;
  for (int k = 0; k < n; ++k) {
    long long t = global_ns();
    if (t != last) {
      if (best < 0 || t - last < best) best = t - last;
      last = t;
    }
  }
  *out = best;
}

}  // namespace

// Append one stamp to log (capacity rows of 4 int64) on `stream`; instance
// may be null (-1 is written). new_frame != 0 bumps the frame counter first.
extern "C" int trace_stamp(void* log, void* state, long long capacity, long long tag,
                           const void* instance, int new_frame, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(log), static_cast<long long*>(state), capacity, tag,
      static_cast<const int*>(instance), new_frame);
  return cudaGetLastError();
}

// Write the global timer's reading to *out on `stream` (the calibration).
extern "C" int trace_clock(void* out, void* stream) {
  clock_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(out));
  return cudaGetLastError();
}

// Write the timer's smallest step over n reads to *out (-1: it never moved).
extern "C" int trace_timer_step(void* out, int n, void* stream) {
  timer_step_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), n);
  return cudaGetLastError();
}
