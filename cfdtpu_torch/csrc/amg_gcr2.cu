// K11 amg_gcr2: the K-cycle's GCR(2) step, two launches.
//
// Replaces the jnp dot products and vector updates of cfdtpu's _gcr2
// (cfdtpu/la/amg.py:27-55), the Krylov acceleration of the K-cycle's
// coarse corrections (:503-506, :675-678):
//   launch 1, after q1 = A z1 (K1):
//     q1q1 = max(<q1, q1>, tiny); a1 = <q1, b> / q1q1;  r = b - a1 q1
//     (q1q1, a1) kept in coef, in device memory
//   launch 2, after z2 = M r and q2 = A z2 (the cycle, K1):
//     beta = <q1, q2> / q1q1;  q2' = q2 - beta q1
//     a2 = <q2', r> / max(<q2', q2'>, tiny)
//     x = a1 z1 + a2 (z2 - beta z1)
// tiny = sqrt(finfo(dtype).tiny), the reference's floor. The host reads
// nothing (a CUDA graph captures both launches).
//
// Bound: latency. The K-cycle runs on the coarse levels only (k >= 1:
// ~5,000 rows at the SELFP AMG's L1 and ~15,500 at BlockAMG's L1 at the
// DFG 2D-1 slice of 106,275 DOF): launch 1 reads two vectors and writes
// one (60-190 KB), launch 2 reads five and writes one. Each launch is
// ONE block of 1024 threads: a thread sums its strided share of the
// rows in row order, then the warps' sums meet in a fixed shuffle tree
// and the 32 warp sums in another, so two calls are bitwise equal and no
// grid-wide barrier is needed between launch 2's two dependent
// reductions (beta first, then <q2', q2'> and <q2', r>). One block reads
// at a small fraction of the card's rate; at these sizes the launch and
// the reductions' dependent steps are what it costs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// the block's sums of NV values a thread, every thread receives them
template <typename T, int NV>
__device__ __forceinline__ void block_sums(T (&v)[NV], T* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    }
  }
  __syncthreads();  // red may hold an earlier call's sums
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) red[k * kWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    T s = red[k * kWarps + lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    v[k] = s;  // every warp forms the same sum in the same order
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    amg_gcr2_first_kernel(const T* __restrict__ q1,
                          const T* __restrict__ b, T* __restrict__ r,
                          T* __restrict__ coef, int64_t n, T tiny) {
  __shared__ T red[2 * kWarps];
  T s[2] = {T(0), T(0)};
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const T q = q1[i];
    s[0] = fma(q, q, s[0]);
    s[1] = fma(q, b[i], s[1]);
  }
  block_sums<T, 2>(s, red);
  const T q1q1 = s[0] > tiny ? s[0] : tiny;
  const T a1 = s[1] / q1q1;
  if (threadIdx.x == 0) {
    coef[0] = q1q1;
    coef[1] = a1;
  }
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    r[i] = b[i] - a1 * q1[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    amg_gcr2_second_kernel(const T* __restrict__ q1,
                           const T* __restrict__ q2,
                           const T* __restrict__ z1,
                           const T* __restrict__ z2,
                           const T* __restrict__ r,
                           const T* __restrict__ coef, T* __restrict__ x,
                           int64_t n, T tiny) {
  __shared__ T red[2 * kWarps];
  const T q1q1 = coef[0], a1 = coef[1];
  T s1[1] = {T(0)};
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    s1[0] = fma(q1[i], q2[i], s1[0]);
  }
  block_sums<T, 1>(s1, red);
  const T beta = s1[0] / q1q1;
  T s[2] = {T(0), T(0)};
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const T q = q2[i] - beta * q1[i];
    s[0] = fma(q, q, s[0]);
    s[1] = fma(q, r[i], s[1]);
  }
  block_sums<T, 2>(s, red);
  const T a2 = s[1] / (s[0] > tiny ? s[0] : tiny);
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const T z = z2[i] - beta * z1[i];
    x[i] = a1 * z1[i] + a2 * z;
  }
}

template <typename T>
int run(int second, const void* q1, const void* bq2, const void* z1,
        const void* z2, const void* r, void* coef, void* out, int64_t n,
        double tiny, cudaStream_t st) {
  if (second) {
    amg_gcr2_second_kernel<T><<<1, kThreads, 0, st>>>(
        static_cast<const T*>(q1), static_cast<const T*>(bq2),
        static_cast<const T*>(z1), static_cast<const T*>(z2),
        static_cast<const T*>(r), static_cast<const T*>(coef),
        static_cast<T*>(out), n, static_cast<T>(tiny));
  } else {
    amg_gcr2_first_kernel<T><<<1, kThreads, 0, st>>>(
        static_cast<const T*>(q1), static_cast<const T*>(bq2),
        static_cast<T*>(out), static_cast<T*>(coef), n,
        static_cast<T>(tiny));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cfd_amg_gcr2(int second, const void* q1, const void* bq2,
                            const void* z1, const void* z2, const void* r,
                            void* coef, void* out, int64_t n, double tiny,
                            int is_f64, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (second && (z1 == nullptr || z2 == nullptr || r == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return is_f64 ? run<double>(second, q1, bq2, z1, z2, r, coef, out, n, tiny,
                              st)
                : run<float>(second, q1, bq2, z1, z2, r, coef, out, n, tiny,
                             st);
}
