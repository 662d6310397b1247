// The launch floor: an empty kernel, timed as one launch alone in the
// same harness as the port's kernels (a CUDA graph of 100,
// tools/timing.py::launch_floor_ms), at a kernel's own grid. It replaces
// no TPU kernel and is on no search path: it tells how much of a small
// kernel's time (RR's bound is a quarter of a microsecond) is the launch
// itself and not its work.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Plain C entry point (bound with ctypes): launches `blocks` blocks of
// 256 threads (the port's kernels' block) on `stream`; returns
// cudaGetLastError() as an int.
extern "C" int gblastn_empty_launch(int blocks, void* stream) {
  empty_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
