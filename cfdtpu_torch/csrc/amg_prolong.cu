// K8 amg_prolong: the coarse-grid correction of an aggregation V-cycle.
//
// Replaces the jnp gather and add of cfdtpu's cycles:
//   la/amg.py:165  AMGLevel.prolong        xc[agg]          (width 1)
//   la/amg.py:173  AMGLevel.prolong_block  xc[agg] per node (width d)
//   la/amg.py:525  x + P xc (AMG.v_cycle), :706 (BlockAMG.v_cycle)
// and, through its scaled base, the first pre-smooth from x0 = 0,
//   la/amg.py:520, 701   x = omega * b / d
// which at n_smooth = 1 is never stored: the level's residual is K1 on
// b with the input scale s = omega / d, and the correction is this
// kernel with the base s * b.
//
//   y[i*w + c] = base[i*w + c] + xc[agg[i]*w + c],   i < n, c < w
//   base = x            (sc null)
//   base = sc * x       (sc given: s * b above)
//
// Bound: the bytes, and below them the launch. At BlockAMG's finest level
// of the DFG 2D-1 slice (35,425 nodes, w = 2, float32) x and y are
// 0.28 MB each, sc 0.28 MB, agg 0.14 MB and xc 0.03 MB: ~0.74 MB without
// sc, 0.22 us at 3.35 TB/s (1.0 MB, 0.31 us with it), under the ~2.5 us
// the card takes to run any kernel. Every site is bound by its launch,
// so the design is one pass with nothing to stage: one thread an output
// value, neighbouring threads on neighbouring values of x, sc and y; the
// gather of xc reads w neighbouring values a node, mostly from L2 (xc is
// ~1/8 of the fine vector). Each output has one owner: two calls are
// bitwise equal.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T, int W, bool SCALED>
__global__ void __launch_bounds__(kThreads)
    amg_prolong_kernel(const T* __restrict__ xc, const int* __restrict__ agg,
                       const T* __restrict__ x, const T* __restrict__ sc,
                       T* __restrict__ y, int64_t n) {
  const int64_t total = n * W;
  for (int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * kThreads) {
    const int64_t i = t / W;
    const int c = (int)(t - i * W);
    const T base = SCALED ? sc[t] * x[t] : x[t];
    y[t] = base + __ldg(xc + (int64_t)__ldg(agg + i) * W + c);
  }
}

template <typename T, int W>
int launch(const void* xc, const void* agg, const void* x, const void* sc,
           void* y, int64_t n, cudaStream_t st) {
  const int64_t total = n * W;
  const int grid = (int)std::min<int64_t>((total + kThreads - 1) / kThreads,
                                          1 << 20);
  const T* s = static_cast<const T*>(sc);
  if (s != nullptr) {
    amg_prolong_kernel<T, W, true><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(xc), static_cast<const int*>(agg),
        static_cast<const T*>(x), s, static_cast<T*>(y), n);
  } else {
    amg_prolong_kernel<T, W, false><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(xc), static_cast<const int*>(agg),
        static_cast<const T*>(x), s, static_cast<T*>(y), n);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* xc, const void* agg, const void* x, const void* sc,
        void* y, int64_t n, int w, cudaStream_t st) {
  switch (w) {
    case 1: return launch<T, 1>(xc, agg, x, sc, y, n, st);
    case 2: return launch<T, 2>(xc, agg, x, sc, y, n, st);
    case 3: return launch<T, 3>(xc, agg, x, sc, y, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int cfd_amg_prolong(const void* xc, const void* agg,
                               const void* x, const void* sc, void* y,
                               int64_t n, int w, int is_f64, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const auto st = static_cast<cudaStream_t>(stream);
  return is_f64 ? run<double>(xc, agg, x, sc, y, n, w, st)
                : run<float>(xc, agg, x, sc, y, n, w, st);
}
