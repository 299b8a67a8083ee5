// K5 patch_spmv: the in-patch scalar ELL SpMV.
//
// Replaces scripts/gather_micro.py pallas_patch_spmv, the repo's one
// Pallas kernel (pl.pallas_call over (8, 128) tiles of 8 patches, K lane
// gathers jnp.take_along_axis + FMAs per tile, x kept in VMEM):
//
//   y[p, j] = sum_{k<K} vals[p, j, k] * x[p, idx[p, j, k]]
//
// for P patches of L slots (L = 128 in the microbenchmark). Every column
// lies in the row's own patch, so the gather never leaves the patch.
//
// Bound: device memory. vals and idx are read once (at P = 8192, K = 8,
// L = 128, float32: 67 MB, plus 8 MB of x and y, ~22 us at 3.35 TB/s);
// the gathers hit on-chip memory. Design: one thread block per patch;
// the patch's x row is staged in shared memory (512 B in float32), and
// one thread per output slot j loops over k, reading x through shared
// memory. Thread j reads its K values and indices contiguously, so the
// lanes of a warp load addresses K*4 bytes apart and each warp-wide
// load touches K times the cache lines it uses: a transposed (P, K, L)
// layout, or a warp that reads a row's K values together, would
// coalesce it. Left for a later version. idx lies in [0, L) by
// construction (the wrapper does not check it on the device).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void patch_spmv_kernel(const T* __restrict__ x,
                                  const T* __restrict__ vals,
                                  const int* __restrict__ idx,
                                  T* __restrict__ y, int64_t L, int64_t K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  const int64_t p = blockIdx.x;
  for (int64_t j = threadIdx.x; j < L; j += blockDim.x)
    xs[j] = __ldg(x + p * L + j);
  __syncthreads();
  for (int64_t j = threadIdx.x; j < L; j += blockDim.x) {
    const int64_t r = (p * L + j) * K;
    T acc = T(0);
    for (int64_t k = 0; k < K; ++k)
      acc += __ldg(vals + r + k) * xs[__ldg(idx + r + k)];
    y[p * L + j] = acc;
  }
}

template <typename T>
int launch(const void* x, const void* vals, const void* idx, void* y,
           int64_t P, int64_t L, int64_t K, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(L) * sizeof(T);
  patch_spmv_kernel<T><<<(unsigned)P, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(vals),
      static_cast<const int*>(idx), static_cast<T*>(y), L, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cfd_patch_spmv(const void* x, const void* vals,
                              const void* idx, void* y, int64_t P,
                              int64_t L, int64_t K, int is_f64,
                              void* stream) {
  if (P <= 0 || L <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) return launch<double>(x, vals, idx, y, P, L, K, st);
  return launch<float>(x, vals, idx, y, P, L, K, st);
}
