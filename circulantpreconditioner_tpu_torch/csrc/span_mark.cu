// The device spans' marker (utils/profiling.py): a one-thread kernel that
// runs at a span's entry and at its exit, in stream order with the span's
// work, and keeps the span accounting on the device clock.
//
// Replaces no TPU kernel: the JAX package has no spans inside its compiled
// programs. It exists because the port's solves run as CUDA graphs, whose
// replays no host code reaches: the time of a layer inside a replay can only
// be taken on the device. Each marker reads the SM global timer
// (%globaltimer, nanoseconds, the clock CUPTI stamps kernels with) once.
//
// The buffer (int64, made before any capture and never moved) holds
//   [0]                        the stack depth
//   [1 + 3k .. 3 + 3k]         stack entry k: span id, entry time, time of
//                              the spans closed inside it (k < max_depth)
//   [1 + 3 max_depth + 3 id]   span id's accumulators: entries, inclusive
//                              ns, self ns (inclusive less the nested spans)
// An entry pushes; an exit pops, adds its inclusive time to the parent's
// nested time, and adds to its accumulators. A span opens and closes inside
// one graph or one eager call, so the stack is balanced at each replay's
// end. Past max_depth an entry only counts the depth, and its exit only
// pops it.
//
// What bounds it: its launch, about a microsecond in a graph, the
// same as any kernel's; the work is a few loads and stores of one thread.
// A graph holds the markers as kernel nodes, disabled (an empty node) while
// no profiler runs: `span_set_enabled` flips them.
//
// Plain C interface for ctypes; each entry returns its cudaError_t.

#include <cuda_runtime.h>

namespace {

__global__ void span_mark_kernel(long long* buf, int id, int enter, int max_depth) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long* stack = buf + 1;
  long long* acc = buf + 1 + 3 * max_depth;
  const long long depth = buf[0];
  if (enter) {
    if (depth < max_depth) {
      stack[3 * depth] = id;
      stack[3 * depth + 1] = (long long)now;
      stack[3 * depth + 2] = 0;
    }
    acc[3 * id] += 1;
    buf[0] = depth + 1;
    return;
  }
  if (depth <= 0) return;  // an exit with no entry: nothing to close
  buf[0] = depth - 1;
  if (depth > max_depth) return;
  const long long* top = stack + 3 * (depth - 1);
  const long long incl = (long long)now - top[1];
  acc[3 * top[0] + 1] += incl;
  acc[3 * top[0] + 2] += incl - top[2];
  if (depth >= 2) stack[3 * (depth - 2) + 2] += incl;
}

}  // namespace

extern "C" {

const char* span_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Launch one marker on `stream`. While the stream is being captured, the
// marker's graph node is written to *node (else *node = 0).
int span_mark(void* buf, int id, int enter, int max_depth, int device, void* stream_ptr,
              void** node) {
  if (id < 0 || max_depth <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  span_mark_kernel<<<1, 1, 0, stream>>>(static_cast<long long*>(buf), id, enter, max_depth);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  *node = nullptr;
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
#if CUDART_VERSION >= 13000
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, nullptr, &deps, nullptr, &ndeps);
#else
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, nullptr, &deps, &ndeps);
#endif
  if (err != cudaSuccess) return err;
  if (status == cudaStreamCaptureStatusActive) {
    // the node just captured is the stream's one dependency now
    if (ndeps != 1) return cudaErrorStreamCaptureUnsupported;
    *node = deps[0];
  }
  return cudaSuccess;
}

// Enable (on = 1) or disable the n marker nodes of an instantiated graph;
// the change holds from the graph's next launch.
int span_set_enabled(void* graph_exec, void** nodes, int n, int on) {
  cudaGraphExec_t exec = static_cast<cudaGraphExec_t>(graph_exec);
  for (int i = 0; i < n; ++i) {
    cudaError_t err =
        cudaGraphNodeSetEnabled(exec, static_cast<cudaGraphNode_t>(nodes[i]), on ? 1u : 0u);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
