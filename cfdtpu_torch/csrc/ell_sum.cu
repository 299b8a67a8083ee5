// K2 ell_sum: deterministic sorted-segment gather-reduce.
//
// Replaces utils/geometry.py SortedScatter.__call__ of cfdtpu (the
// padded ELL gather src[ell_idx].sum(axis=1)), which serves the cell
// residual scatters, the node-BSR assembly and the SELFP product
// scatter; and the segment_sum of la/amg.py AMGLevel.restrict and
// coarsen_vals.
//
//   out[i, f] = sum_{row_ptr[i] <= j < row_ptr[i+1]} src[pos[j], f]
//
// (row_ptr, pos) is the scatter in CSR form: pos lists the source rows
// sorted by destination (the stable argsort SortedScatter builds), so no
// slot is padded and no row is read twice. There are no atomics: each
// output has one owner group and a fixed order of summation, so two
// calls are bitwise equal.
//
// Bound: at the solver's sizes, latency more than bytes (most call sites
// move 0.1-3 MB: a few microseconds at 3.35 TB/s, against a chain of
// three dependent loads: row_ptr, then pos, then src). Design:
// - G lanes per output (G chosen on the host from the map's mean and
//   largest counts): lane q takes the row's contributions q, q+G, ...,
//   so the pos reads of a group are coalesced;
// - a lane loads up to kU indices, then their kU source values, then
//   sums: one round of two dependent loads per kU contributions. kU is
//   4 (few registers, many threads resident: the short rows, and the
//   long rows of a launch that fills the card), or 16 where a small
//   launch would otherwise take more than two rounds (the coarsen maps
//   of the coarse levels, up to ~130 contributions a row);
// - thread t maps to (row i, lane q, feature f) with f fastest: the F
//   threads of one contribution read one contiguous source row, and
//   neighbouring rows lie on neighbouring lanes;
// - the G partial sums are reduced by a fixed shuffle tree (lanes F
//   apart; G*F divides 32, so a group never crosses a warp).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T, int kU>
__global__ void __launch_bounds__(kThreads)
    ell_sum_kernel(const T* __restrict__ src, const int* __restrict__ row_ptr,
                   const int* __restrict__ pos, T* __restrict__ out,
                   int64_t n_out, int64_t F, int G) {
  // 32-bit index arithmetic: the host keeps n_out * F * G below 2^31
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  const unsigned f = t % (unsigned)F;
  const unsigned iq = t / (unsigned)F;
  const int q = (int)(iq % (unsigned)G);
  const int64_t i = iq / (unsigned)G;
  T acc = T(0);
  if (i < n_out) {
    const int64_t end = __ldg(row_ptr + i + 1);
    for (int64_t j0 = __ldg(row_ptr + i) + q; j0 < end;
         j0 += (int64_t)G * kU) {
      int idx[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int64_t j = j0 + (int64_t)u * G;
        idx[u] = j < end ? __ldg(pos + j) : -1;
      }
      T v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        v[u] = idx[u] >= 0 ? __ldg(src + (int64_t)idx[u] * F + f) : T(0);
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (idx[u] >= 0) acc += v[u];
    }
  }
  if (G > 1) {  // G > 1 only when G*F divides 32 (the host's plan)
    for (int off = G >> 1; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off * (int)F);
  }
  if (i < n_out && q == 0) out[i * F + (int64_t)f] = acc;
}

template <typename T, int kU>
void launch(const void* src, const int* rp, const int* ps, void* out,
            int64_t n_out, int64_t F, int G, int64_t blocks,
            cudaStream_t st) {
  ell_sum_kernel<T, kU><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(src), rp, ps, static_cast<T*>(out), n_out, F, G);
}

}  // namespace

// src (n_in, F), row_ptr (n_out + 1,) int32, pos (nnz,) int32, out
// (n_out, F); G the lanes per output (a power of two; G > 1 needs G*F
// to divide 32) and `loads` the contributions a lane loads per round
// (4 or 16), chosen by kernels/ell_sum.py ell_plan
extern "C" int cfd_ell_sum(const void* src, const void* row_ptr,
                           const void* pos, void* out, int64_t n_out,
                           int64_t F, int G, int loads, int is_f64,
                           void* stream) {
  const int64_t total = n_out * F * G;
  if (total <= 0) return (int)cudaGetLastError();
  if (loads != 4 && loads != 16) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* ps = static_cast<const int*>(pos);
  if (is_f64) {
    if (loads == 16)
      launch<double, 16>(src, rp, ps, out, n_out, F, G, blocks, st);
    else
      launch<double, 4>(src, rp, ps, out, n_out, F, G, blocks, st);
  } else {
    if (loads == 16)
      launch<float, 16>(src, rp, ps, out, n_out, F, G, blocks, st);
    else
      launch<float, 4>(src, rp, ps, out, n_out, F, G, blocks, st);
  }
  return (int)cudaGetLastError();
}
