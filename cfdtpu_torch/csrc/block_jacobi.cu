// K10 block_jacobi: node-block Jacobi, its apply and its inverses.
//
// Replaces cfdtpu/la/nodebsr.py:169-189 (NodeBSR.uu_block_jacobi): the
// jnp einsum of each apply,
//   z[i*d + a] = sum_b inv[i, a, b] * v[i*d + b],   d in 1..3
// (d = 2 the velocity block of the 2D solver; d = 1 a diagonal scale,
// x0 = w b of a Chebyshev sweep, or with DIV a division: cfdtpu's
// v / d_p, the S stage's preconditioner of its gmres inner method,
// la/schur.py:349-355, divided as there), and,
// once per preconditioner build, the masked diagonal blocks and
// det_and_inv (cfdtpu/utils/geometry.py) of the inverses:
//   D = vals[diag_pos[i]][:d, :d], rows and columns at the Dirichlet
//   components of node i (mask) replaced by the identity's, inv = D^-1
// by the cofactor formulas, the same expressions in the same order.
//
// Bound: the bytes, and below them the launch. The apply at the DFG
// 2D-1 slice (35,425 nodes, d = 2, float32) reads 0.57 MB of inverses
// and 0.28 MB of v and writes 0.28 MB: 1.13 MB, 0.34 us at 3.35 TB/s;
// the inverses read 35,425 of the node blocks (bs x bs, but only the
// d x d part: 0.57 MB) and write 0.57 MB. One thread a node: its d x d
// values and its d values of v are neighbours of its neighbour's, so a
// warp's loads are contiguous; each output has one owner, so two calls
// are bitwise equal.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// rounded products and sums, never contracted into an fma: the plain
// version's (torch's) arithmetic
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

template <typename T, int D, bool DIV>
__global__ void __launch_bounds__(kThreads)
    block_jacobi_kernel(const T* __restrict__ inv, const T* __restrict__ v,
                        T* __restrict__ z, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const T* m = inv + i * D * D;
    if constexpr (DIV) {  // D == 1 (the host checks)
      z[i] = v[i] / m[0];
      continue;
    }
    T x[D];
#pragma unroll
    for (int b = 0; b < D; ++b) x[b] = v[i * D + b];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T acc = m[a * D] * x[0];
#pragma unroll
      for (int b = 1; b < D; ++b) acc = fma(m[a * D + b], x[b], acc);
      z[i * D + a] = acc;
    }
  }
}

// the masked diagonal block of node i, D x D, row-major
template <typename T, int D>
__device__ __forceinline__ void masked_block(const T* vals, int bs,
                                             const int64_t* diag_pos,
                                             const unsigned char* mask,
                                             int64_t i, T (&a)[D][D]) {
  const T* blk = vals + diag_pos[i] * bs * bs;
  bool mk[D];
#pragma unroll
  for (int r = 0; r < D; ++r) mk[r] = mask[i * D + r] != 0;
#pragma unroll
  for (int r = 0; r < D; ++r) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const T e = r == c ? T(1) : T(0);
      a[r][c] = (mk[r] || mk[c]) ? e : blk[r * bs + c];
    }
  }
}

// det_and_inv's cofactor formulas (utils/geometry.py), each product and
// sum as it is written there
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    block_jacobi_inv_kernel(const T* __restrict__ vals, int bs,
                            const int64_t* __restrict__ diag_pos,
                            const unsigned char* __restrict__ mask,
                            T* __restrict__ inv, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    T a[D][D];
    masked_block<T, D>(vals, bs, diag_pos, mask, i, a);
    T* o = inv + i * D * D;
    if constexpr (D == 1) {
      o[0] = T(1) / a[0][0];
    } else if constexpr (D == 2) {
      const T det = sub_rn(mul_rn(a[0][0], a[1][1]),
                           mul_rn(a[0][1], a[1][0]));
      const T idet = T(1) / det;
      o[0] = a[1][1] * idet;
      o[1] = -a[0][1] * idet;
      o[2] = -a[1][0] * idet;
      o[3] = a[0][0] * idet;
    } else {
      const T c00 = sub_rn(mul_rn(a[1][1], a[2][2]),
                           mul_rn(a[1][2], a[2][1]));
      const T c01 = sub_rn(mul_rn(a[1][2], a[2][0]),
                           mul_rn(a[1][0], a[2][2]));
      const T c02 = sub_rn(mul_rn(a[1][0], a[2][1]),
                           mul_rn(a[1][1], a[2][0]));
      const T c10 = sub_rn(mul_rn(a[0][2], a[2][1]),
                           mul_rn(a[0][1], a[2][2]));
      const T c11 = sub_rn(mul_rn(a[0][0], a[2][2]),
                           mul_rn(a[0][2], a[2][0]));
      const T c12 = sub_rn(mul_rn(a[0][1], a[2][0]),
                           mul_rn(a[0][0], a[2][1]));
      const T c20 = sub_rn(mul_rn(a[0][1], a[1][2]),
                           mul_rn(a[0][2], a[1][1]));
      const T c21 = sub_rn(mul_rn(a[0][2], a[1][0]),
                           mul_rn(a[0][0], a[1][2]));
      const T c22 = sub_rn(mul_rn(a[0][0], a[1][1]),
                           mul_rn(a[0][1], a[1][0]));
      const T det = add_rn(
          add_rn(mul_rn(a[0][0], c00), mul_rn(a[0][1], c01)),
          mul_rn(a[0][2], c02));
      const T idet = T(1) / det;
      const T cf[3][3] = {{c00, c10, c20}, {c01, c11, c21}, {c02, c12, c22}};
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) o[r * 3 + c] = cf[r][c] * idet;
      }
    }
  }
}

int grid_for(int64_t n) {
  return (int)std::min<int64_t>((n + kThreads - 1) / kThreads, 1 << 20);
}

template <typename T, int D, bool DIV = false>
int apply_d(const void* inv, const void* v, void* z, int64_t n,
            cudaStream_t st) {
  block_jacobi_kernel<T, D, DIV><<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const T*>(inv), static_cast<const T*>(v),
      static_cast<T*>(z), n);
  return (int)cudaGetLastError();
}

template <typename T>
int apply(const void* inv, const void* v, void* z, int64_t n, int d,
          int divide, cudaStream_t st) {
  if (divide) {
    return d == 1 ? apply_d<T, 1, true>(inv, v, z, n, st)
                  : (int)cudaErrorInvalidValue;
  }
  switch (d) {
    case 1: return apply_d<T, 1>(inv, v, z, n, st);
    case 2: return apply_d<T, 2>(inv, v, z, n, st);
    case 3: return apply_d<T, 3>(inv, v, z, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int D>
int inv_d(const void* vals, int bs, const void* diag_pos, const void* mask,
          void* inv, int64_t n, cudaStream_t st) {
  block_jacobi_inv_kernel<T, D><<<grid_for(n), kThreads, 0, st>>>(
      static_cast<const T*>(vals), bs,
      static_cast<const int64_t*>(diag_pos),
      static_cast<const unsigned char*>(mask), static_cast<T*>(inv), n);
  return (int)cudaGetLastError();
}

template <typename T>
int inverses(const void* vals, int bs, const void* diag_pos,
             const void* mask, void* inv, int64_t n, int d,
             cudaStream_t st) {
  switch (d) {
    case 1: return inv_d<T, 1>(vals, bs, diag_pos, mask, inv, n, st);
    case 2: return inv_d<T, 2>(vals, bs, diag_pos, mask, inv, n, st);
    case 3: return inv_d<T, 3>(vals, bs, diag_pos, mask, inv, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int cfd_block_jacobi(const void* inv, const void* v, void* z,
                                int64_t n, int d, int divide, int is_f64,
                                void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const auto st = static_cast<cudaStream_t>(stream);
  return is_f64 ? apply<double>(inv, v, z, n, d, divide, st)
                : apply<float>(inv, v, z, n, d, divide, st);
}

extern "C" int cfd_block_jacobi_inv(const void* vals, int bs,
                                    const void* diag_pos, const void* mask,
                                    void* inv, int64_t n, int d, int is_f64,
                                    void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (bs < d) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return is_f64 ? inverses<double>(vals, bs, diag_pos, mask, inv, n, d, st)
                : inverses<float>(vals, bs, diag_pos, mask, inv, n, d, st);
}
