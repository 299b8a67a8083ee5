// An empty kernel, launched through the same C interface as the port's
// kernels: utils/cudatime.empty_ms times it as the floor that a small
// call site (a few thousand threads, a few dependent loads) can approach.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int cfd_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
