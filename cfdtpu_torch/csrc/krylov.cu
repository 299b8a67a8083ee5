// K9 krylov: the Gram-Schmidt step of GMRES's Arnoldi process and the
// small least-squares solve of the fixed sweeps.
//
// Replaces the jnp products, norms and solve of cfdtpu/la/gmres.py:
//   gmres_fixed (:28-82): V[0] = b / max(||b||, tiny); each sweep's
//     classical Gram-Schmidt over the active rows (once, or twice with
//     reorth); the normal equations (H^T H + reg I) y = H^T beta e1,
//     reg = max(trace / m, tiny) * 1e-12, and Z^T y;
//   fgmres (:179-220): the CGS2 step of every inner iteration.
//
// cfd_krylov_cgs, for the active rows V[0..j] (none at j = -1):
//   h1 = V w; u = w - V^T h1; [h2 = V u; u = u - V^T h2]   (reorth)
//   V[j+1] = u / max(||u||, tiny); hcol[k] = h1[k] (+ h2[k]), k <= j;
//   hcol[j+1] = ||u||
// in three launches (four with reorth; two at j = -1), each a pass over
// the n columns with the basis rows it needs:
//   dots    block partials of V w
//   update  every block sums the partials in one fixed order (so each
//           holds the same h), writes u = src - V^T h into V[j+1] and
//           takes the partials of the next pass: V u (reorth, first
//           pass), or ||u||^2
//   norm    every block sums the norm partials in the fixed order and
//           divides its share of V[j+1] by max(||u||, tiny)
// The grid syncs between the passes are the launch boundaries. Every
// reduction is two-stage (block partials, then one fixed-order pass) with
// no atomics: two calls are bitwise equal, and so are the graph's replays.
//
// Bound: the bytes of V. One step reads the (j+1) active rows twice (4
// times with reorth) plus w, writes V[j+1] and reads it once more: at the
// FGMRES site of the DFG 2D-1 slice (n = 106,275, j = 19, CGS2,
// float32) ~34 MB, ~10 us at 3.35 TB/s; at the S stage's sweeps
// (n = 35,425, j <= 4, CGS) <= 1.4 MB, where the three launches bound it.
// The basis rows a thread walks are in flight together (independent
// loads of one column), and a row set of 32 keeps its sums in registers.
//
// cfd_krylov_lsq: every block solves the same m x m system in shared
// memory, in float64 whatever the vectors' type (the normal equations
// square H's condition number), by Gauss elimination with partial
// pivoting (the first largest pivot, as LAPACK's getrf), masks y by
// beta > tiny, and writes its share of Z^T y: one launch, no cuSOLVER
// call, so nothing in a captured CUDA graph synchronises. Bound: the
// launch and the solve's m steps of three block barriers; Z is m*n
// values.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;      // basis rows whose sums a thread keeps at once
constexpr int kMaxRows = 128;  // restart + 1 at most
constexpr int kMaxM = 64;      // krylov_lsq's m at most

// the block's sums of acc[kk] (kk < cnt) into out[kk]; fixed order
template <typename T>
__device__ void block_sums(const T (&acc)[kRows], int cnt, T* out) {
  __shared__ T red[kWarps][kRows];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int kk = 0; kk < kRows; ++kk) {
    if (kk < cnt) {  // uniform over the block
      T v = acc[kk];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == 0) red[warp][kk] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < cnt) {
    T s = T(0);
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// the sum over the nb block partials part[b*ld + k] of each row k < rows,
// into h[k] (shared): each thread adds the partials of blocks t, t + 256,
// ..., then block_sums; every block the same, in the same fixed order
template <typename T>
__device__ void sum_partials(const T* part, int nb, int ld, int rows, T* h) {
  for (int k0 = 0; k0 < rows; k0 += kRows) {
    const int cnt = min(kRows, rows - k0);
    T acc[kRows];
#pragma unroll
    for (int kk = 0; kk < kRows; ++kk) acc[kk] = T(0);
    for (int b = threadIdx.x; b < nb; b += kThreads) {
      const T* pb = part + (int64_t)b * ld + k0;
#pragma unroll
      for (int kk = 0; kk < kRows; ++kk) {
        if (kk < cnt) acc[kk] += pb[kk];
      }
    }
    block_sums(acc, cnt, h + k0);
  }
}

// pass 1: partials of V[0..rows) . src
template <typename T>
__global__ void __launch_bounds__(kThreads)
    krylov_cgs_dots(const T* __restrict__ V, int64_t n, int rows,
                    const T* __restrict__ src, T* __restrict__ part) {
  for (int k0 = 0; k0 < rows; k0 += kRows) {
    const int cnt = min(kRows, rows - k0);
    T acc[kRows];
#pragma unroll
    for (int kk = 0; kk < kRows; ++kk) acc[kk] = T(0);
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * kThreads) {
      const T u = src[i];
#pragma unroll
      for (int kk = 0; kk < kRows; ++kk) {
        if (kk < cnt) acc[kk] = fma(__ldg(V + (k0 + kk) * n + i), u, acc[kk]);
      }
    }
    block_sums(acc, cnt, part + (int64_t)blockIdx.x * rows + k0);
  }
}

// pass 2 (and 3): u = src - V[0..rows)^T h into dst, h the summed
// partials of the pass before; then the partials of V u (DOTS) or of
// ||u||^2. Block 0 keeps h: into hs (first pass of two) or, with the
// first pass's hs added (ADD), into the H column. dst is row j+1 of V,
// which no thread reads through V (rows 0..j), and src may be dst.
template <typename T, bool DOTS, bool ADD>
__global__ void __launch_bounds__(kThreads)
    krylov_cgs_update(const T* V, int64_t n, int rows, const T* src,
                      T* dst, const T* __restrict__ part_in, int nb,
                      T* part_out, T* hs, T* hcol, int64_t hstride) {
  __shared__ T h[kMaxRows];
  if (rows > 0) sum_partials(part_in, nb, rows, rows, h);
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k < rows; k += kThreads) {
      if (DOTS) {
        hs[k] = h[k];
      } else {
        hcol[k * hstride] = ADD ? hs[k] + h[k] : h[k];
      }
    }
  }
  const int passes = DOTS ? (rows + kRows - 1) / kRows : 1;
  for (int c = 0; c < passes; ++c) {
    const int k0 = c * kRows, cnt = DOTS ? min(kRows, rows - k0) : 1;
    T acc[kRows];
#pragma unroll
    for (int kk = 0; kk < kRows; ++kk) acc[kk] = T(0);
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * kThreads) {
      T u;
      if (c == 0) {  // the update, in the order k = 0, 1, ...
        T t = T(0);
#pragma unroll 8
        for (int k = 0; k < rows; ++k) t = fma(__ldg(V + k * n + i), h[k], t);
        u = src[i] - t;
        dst[i] = u;  // src may be dst: each thread its own columns
      } else {
        u = dst[i];
      }
      if (DOTS) {
#pragma unroll
        for (int kk = 0; kk < kRows; ++kk) {
          if (kk < cnt) acc[kk] = fma(V[(k0 + kk) * n + i], u, acc[kk]);
        }
      } else {
        acc[0] = fma(u, u, acc[0]);
      }
    }
    block_sums(acc, cnt, part_out + (int64_t)blockIdx.x * (DOTS ? rows : 1)
                             + k0);
  }
}

// the last pass: ||u|| from the norm partials, V[j+1] /= max(||u||, tiny)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    krylov_cgs_norm(T* dst, int64_t n, const T* __restrict__ part_in,
                    int nb, T* hnorm, T tiny) {
  __shared__ T nrm[1];
  sum_partials(part_in, nb, 1, 1, nrm);
  const T w = sqrt(nrm[0]);
  if (blockIdx.x == 0 && threadIdx.x == 0) *hnorm = w;
  const T den = w > tiny ? w : tiny;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    dst[i] = dst[i] / den;
  }
}

template <typename T>
int cgs(const void* Vp, int64_t n, int j, const void* wp, void* hp,
        int64_t hstride, int reorth, void* scratch, int nb, double tiny,
        cudaStream_t st) {
  const T* V = static_cast<const T*>(Vp);
  const T* w = static_cast<const T*>(wp);
  T* dst = const_cast<T*>(V) + (int64_t)(j + 1) * n;
  T* hcol = static_cast<T*>(hp);
  const int rows = j + 1;
  // scratch: P1 (nb*rows), P2 (nb*rows), P3 (nb), hs (rows)
  T* p1 = static_cast<T*>(scratch);
  T* p2 = p1 + (int64_t)nb * rows;
  T* p3 = p2 + (int64_t)nb * rows;
  T* hs = p3 + nb;
  if (rows > 0) {
    krylov_cgs_dots<T><<<nb, kThreads, 0, st>>>(V, n, rows, w, p1);
  }
  if (rows > 0 && reorth) {
    krylov_cgs_update<T, true, false><<<nb, kThreads, 0, st>>>(
        V, n, rows, w, dst, p1, nb, p2, hs, hcol, hstride);
    krylov_cgs_update<T, false, true><<<nb, kThreads, 0, st>>>(
        V, n, rows, dst, dst, p2, nb, p3, hs, hcol, hstride);
  } else {
    krylov_cgs_update<T, false, false><<<nb, kThreads, 0, st>>>(
        V, n, rows, w, dst, p1, nb, p3, hs, hcol, hstride);
  }
  krylov_cgs_norm<T><<<nb, kThreads, 0, st>>>(
      dst, n, p3, nb, hcol + rows * hstride, static_cast<T>(tiny));
  return (int)cudaGetLastError();
}

// every block: the m x m normal equations of H ((m+1) x m, row-major)
// in float64, solved by Gauss elimination with partial pivoting; then
// its share of out = Z^T y (Z (m, n) row-major)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    krylov_lsq_kernel(const T* __restrict__ H, int m,
                      const T* __restrict__ beta, const T* __restrict__ Z,
                      int64_t n, T* __restrict__ out, double tiny) {
  __shared__ double A[kMaxM][kMaxM + 1];  // [H^T H + reg I | H^T beta e1]
  __shared__ double yd[kMaxM];
  __shared__ T y[kMaxM];
  __shared__ int piv;
  const int t = threadIdx.x;
  const double bt = (double)beta[0];
  for (int e = t; e < m * m; e += kThreads) {
    const int r = e / m, c = e - r * m;
    double s = 0.0;
    for (int k = 0; k <= m; ++k) {
      s = fma((double)H[k * m + r], (double)H[k * m + c], s);
    }
    A[r][c] = s;
  }
  for (int r = t; r < m; r += kThreads) A[r][m] = (double)H[r] * bt;
  __syncthreads();
  if (t == 0) {  // reg from the trace, in order
    double tr = 0.0;
    for (int r = 0; r < m; ++r) tr += A[r][r];
    const double reg = fmax(tr / m, tiny) * 1e-12;
    for (int r = 0; r < m; ++r) A[r][r] += reg;
  }
  __syncthreads();
  for (int col = 0; col < m; ++col) {
    if (t == 0) {  // the first largest |pivot|
      int p = col;
      double best = fabs(A[col][col]);
      for (int r = col + 1; r < m; ++r) {
        if (fabs(A[r][col]) > best) {
          best = fabs(A[r][col]);
          p = r;
        }
      }
      piv = p;
    }
    __syncthreads();
    const int p = piv;
    if (p != col) {
      for (int c = col + t; c <= m; c += kThreads) {
        const double a = A[col][c];
        A[col][c] = A[p][c];
        A[p][c] = a;
      }
    }
    __syncthreads();
    const int w = m - col;  // columns col+1 .. m (the rhs last)
    for (int e = t; e < (m - col - 1) * w; e += kThreads) {
      const int r = col + 1 + e / w, c = col + 1 + e % w;
      A[r][c] -= (A[r][col] / A[col][col]) * A[col][c];
    }
    __syncthreads();
  }
  if (t == 0) {
    for (int r = m - 1; r >= 0; --r) {
      double s = A[r][m];
      for (int c = r + 1; c < m; ++c) s -= A[r][c] * yd[c];
      yd[r] = s / A[r][r];
    }
    for (int r = 0; r < m; ++r) {
      y[r] = beta[0] > static_cast<T>(tiny) ? static_cast<T>(yd[r]) : T(0);
    }
  }
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * kThreads + t; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    T s = T(0);
    for (int k = 0; k < m; ++k) s = fma(__ldg(Z + k * n + i), y[k], s);
    out[i] = s;
  }
}

}  // namespace

extern "C" int cfd_krylov_cgs(const void* V, int64_t n, int j,
                              const void* w, void* h, int64_t hstride,
                              int reorth, void* scratch, int nb, double tiny,
                              int is_f64, void* stream) {
  if (n <= 0 || nb <= 0 || j < -1 || j + 1 > kMaxRows) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return is_f64 ? cgs<double>(V, n, j, w, h, hstride, reorth, scratch, nb,
                              tiny, st)
                : cgs<float>(V, n, j, w, h, hstride, reorth, scratch, nb,
                             tiny, st);
}

extern "C" int cfd_krylov_lsq(const void* H, int m, const void* beta,
                              const void* Z, int64_t n, void* out, int nb,
                              double tiny, int is_f64, void* stream) {
  if (m < 1 || m > kMaxM || n <= 0 || nb <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    krylov_lsq_kernel<double><<<nb, kThreads, 0, st>>>(
        static_cast<const double*>(H), m, static_cast<const double*>(beta),
        static_cast<const double*>(Z), n, static_cast<double*>(out), tiny);
  } else {
    krylov_lsq_kernel<float><<<nb, kThreads, 0, st>>>(
        static_cast<const float*>(H), m, static_cast<const float*>(beta),
        static_cast<const float*>(Z), n, static_cast<float*>(out), tiny);
  }
  return (int)cudaGetLastError();
}
