// K6 ras_apply: the restricted additive Schwarz (RAS) apply.
//
// Replaces la/ras.py RASPrecond.apply of cfdtpu (gather of the node
// windows, batched einsum with the window inverses, slice of the owned
// centre rows):
//
//   xw[k, b]        = x[win[k, b/d]*d + b%d]    (win == n reads zero)
//   z[k*s*d + a]    = sum_{b<m} inv[k, o*d + a, b] * xw[k, b]
//   out[k*s*d + a]  = z  (mode 0)   or   base + z  (mode 1)
//   for a < s*d and k*s*d + a < n*d.
//
// Window k covers nodes [k*s - o, k*s + s + o) (w = s + 2o nodes,
// m = w*d rows) and owns its centre s nodes, so every output row is
// written by exactly one window: no atomics, and rows past n*d (the
// padded tail of the last window) are never written. Mode 1 is the fine
// smoother's x + RAS(r) of BlockAMG.v_cycle.
//
// Bound: device memory. The inverses are read once per apply and only
// the s*d owned rows of each are needed (at the bench settings, 1,108
// windows of m = 80, s*d = 64, float32: 22.7 MB, ~7 us at 3.35 TB/s,
// against 28.4 MB for the plain version, which multiplies all m rows).
// Design: one thread block per window; the window's m gathered x values
// are staged once in shared memory; one warp per owned row reads the
// row's m inverse values coalesced (neighbouring lanes, neighbouring
// addresses) and sums them with a fixed-order warp-shuffle tree, so the
// result is the same on every run.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void ras_apply_kernel(const T* __restrict__ inv,
                                 const T* __restrict__ x,
                                 const int* __restrict__ win,
                                 const T* __restrict__ base,
                                 T* __restrict__ out, int64_t n, int64_t d,
                                 int64_t s, int64_t o, int64_t w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xw = reinterpret_cast<T*>(smem_raw);
  const int64_t k = blockIdx.x;
  const int64_t m = w * d;
  const int* wk = win + k * w;
  for (int64_t b = threadIdx.x; b < m; b += blockDim.x) {
    const int64_t node = __ldg(wk + b / d);
    xw[b] = node < n ? __ldg(x + node * d + b % d) : T(0);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t sd = s * d;
  const int64_t nd = n * d;
  const T* invk = inv + k * m * m;
  for (int64_t a = warp; a < sd; a += kWarps) {
    const int64_t row = k * sd + a;
    if (row >= nd) break;  // rows grow with a: the rest are past n*d too
    const T* ir = invk + (o * d + a) * m;
    T acc = T(0);
    for (int64_t b = lane; b < m; b += 32) acc += __ldg(ir + b) * xw[b];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[row] = base != nullptr ? base[row] + acc : acc;
  }
}

template <typename T>
int launch(const void* inv, const void* x, const void* win,
           const void* base, void* out, int64_t n, int64_t d, int64_t s,
           int64_t o, int64_t w, int64_t n_sub, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(w * d) * sizeof(T);
  ras_apply_kernel<T><<<(unsigned)n_sub, kThreads, smem, st>>>(
      static_cast<const T*>(inv), static_cast<const T*>(x),
      static_cast<const int*>(win), static_cast<const T*>(base),
      static_cast<T*>(out), n, d, s, o, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cfd_ras_apply(const void* inv, const void* x,
                             const void* win, const void* base, void* out,
                             int64_t n, int64_t d, int64_t s, int64_t o,
                             int64_t w, int64_t n_sub, int is_f64,
                             void* stream) {
  if (n_sub <= 0 || n * d <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch<double>(inv, x, win, base, out, n, d, s, o, w, n_sub, st);
  return launch<float>(inv, x, win, base, out, n, d, s, o, w, n_sub, st);
}
