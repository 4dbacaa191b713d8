// Marker kernels of the step's device spans (utils/spans.py).
//
// Replaces no TPU kernel: a host range (NVTX, record_function) does not
// replay with a CUDA graph, so a span inside a captured unit is a pair of
// these empty kernels launched on the unit's stream at its boundaries,
// captured with the unit and replayed with it. Each carries its span's
// name in its symbol (extern "C": unmangled), spherharm_span__<name>__begin
// and __end with the name's dots as underscores, so any profiler trace
// names it. A mark is one launch of one thread that does nothing: what
// bounds it is the launch, about 2 us inside a graph.
//
// Built on its own (ops/cuda_build.span_library) the first time spans are
// switched on, so a run without spans never compiles or loads it.

#include <cuda_runtime.h>

// The spans, in the order of utils/spans.SPANS.
#define SPAN_LIST(X)                                                         \
  X(step_pre) X(step_trigger)                                                \
  X(rebuild) X(rebuild_cell_list) X(rebuild_remap) X(rebuild_pair_build)     \
  X(rebuild_prefilter)                                                       \
  X(pair) X(pair_pack) X(pair_law) X(pair_reduce)                            \
  X(walls) X(step_post)                                                      \
  X(runner_store) X(runner_load) X(runner_result)

#define SPAN_KERNELS(s)                                                      \
  extern "C" __global__ void spherharm_span__##s##__begin() {}               \
  extern "C" __global__ void spherharm_span__##s##__end() {}
SPAN_LIST(SPAN_KERNELS)

#define SPAN_ENTRIES(s)                                                      \
  (const void*)spherharm_span__##s##__begin,                                 \
  (const void*)spherharm_span__##s##__end,
static const void* const kMarks[] = {SPAN_LIST(SPAN_ENTRIES)};
static const int kNumMarks = sizeof(kMarks) / sizeof(kMarks[0]);

// Spans compiled in (utils/spans checks it against SPANS).
extern "C" int sh_span_count() { return kNumMarks / 2; }

// Launches mark i (2 s: span s begins, 2 s + 1: it ends) on the stream.
extern "C" int sh_span_mark(int i, void* stream) {
  if (i < 0 || i >= kNumMarks) return (int)cudaErrorInvalidValue;
  void* no_args[1] = {nullptr};
  cudaError_t err = cudaLaunchKernel(kMarks[i], dim3(1), dim3(1), no_args, 0,
                                     (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" const char* sh_span_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
