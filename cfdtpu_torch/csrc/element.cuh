// Shared pieces of the element kernels (K3, K7): forward-mode dual
// numbers, 2-vector types and the P1 triangle's geometry.
//
// cfdtpu takes its exact element Jacobians as jax.vmap(jax.jacfwd(kernel))
// of the residual kernels. Here each residual body is a template on its
// number type N: instantiated with the plain type T it is the residual,
// with Dual<T, ND> it carries ND tangent directions through the same
// arithmetic, so the physics is written once. Only +, - and * meet a
// dual (the bodies divide by plain geometry and by constants only);
// quantities that are constants of the derivative (geometry, u_prev, the
// stabilisation parameters) stay plain T and cost no tangent work.

#pragma once

#include <cuda_runtime.h>

constexpr int NLOC = 9;  // flat element dofs: u(3, 2) then p(3)

template <typename T, int ND>
struct Dual {
  T v;
  T d[ND];
};

template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator+(const Dual<T, ND>& a,
                                                 const Dual<T, ND>& b) {
  Dual<T, ND> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < ND; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator+(const Dual<T, ND>& a, T b) {
  Dual<T, ND> r = a;
  r.v = a.v + b;
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator-(const Dual<T, ND>& a,
                                                 const Dual<T, ND>& b) {
  Dual<T, ND> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < ND; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator-(const Dual<T, ND>& a, T b) {
  Dual<T, ND> r = a;
  r.v = a.v - b;
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator*(const Dual<T, ND>& a,
                                                 const Dual<T, ND>& b) {
  Dual<T, ND> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < ND; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator*(const Dual<T, ND>& a, T b) {
  Dual<T, ND> r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < ND; ++k) r.d[k] = a.d[k] * b;
  return r;
}
template <typename T, int ND>
__device__ __forceinline__ Dual<T, ND> operator*(T a, const Dual<T, ND>& b) {
  return b * a;
}

// Lift<N>::of(x): the constant x as a number of type N
template <typename N>
struct Lift;
template <>
struct Lift<float> {
  static __device__ __forceinline__ float of(float x) { return x; }
};
template <>
struct Lift<double> {
  static __device__ __forceinline__ double of(double x) { return x; }
};
template <typename T, int ND>
struct Lift<Dual<T, ND>> {
  static __device__ __forceinline__ Dual<T, ND> of(T x) {
    Dual<T, ND> r;
    r.v = x;
#pragma unroll
    for (int k = 0; k < ND; ++k) r.d[k] = T(0);
    return r;
  }
};

// 2-vectors of the plain types, for 8- and 16-byte loads and stores,
// and the 16-byte vector of each
template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// 1 / x: in float32 by the special-function unit (2 ulp), in float64
// exactly
__device__ __forceinline__ float recip(float x) { return __fdividef(1.0f, x); }
__device__ __forceinline__ double recip(double x) { return 1.0 / x; }

// the physical basis gradients of a P1 triangle at one point:
// gu[b][g] = sum_d dphi[b][d] dxi_d/dx_g, with J[g][d] = sum_v X[v][g]
// gdphi[v][d]; adet = |det J|
template <typename T>
struct Geom {
  T gu[3][2];
  T adet;
};

template <typename T>
__device__ __forceinline__ void p1_geometry(const T (&X)[3][2], const T* gd,
                                            const T* dp, Geom<T>& g) {
  T J[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int d = 0; d < 2; ++d)
      J[a][d] = X[0][a] * gd[d] + X[1][a] * gd[2 + d] + X[2][a] * gd[4 + d];
  const T det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
  const T idet = recip(det);
  const T i00 = J[1][1] * idet, i01 = -J[0][1] * idet;
  const T i10 = -J[1][0] * idet, i11 = J[0][0] * idet;
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    g.gu[b][0] = dp[b * 2] * i00 + dp[b * 2 + 1] * i10;
    g.gu[b][1] = dp[b * 2] * i01 + dp[b * 2 + 1] * i11;
  }
  g.adet = fabs(det);
}
