// K7's bodies: the natural-correction facet term, residual and
// Jacobian, one facet (residual) or one (facet, column) (Jacobian) a
// lane. csrc/ns_facet_natural.cu launches them alone; csrc/
// ns_cell_residual.cu runs them in K3's launch, as a second range of
// blocks after the cells' (see the file comment of ns_facet_natural.cu
// for the term).

#pragma once

#include <cstdint>

#include "element.cuh"

// per-facet tabulations (nf, nq, ...), as add_facet_term builds them
template <typename T>
struct FacetTabs {
  const T* phi_u;   // (nf, nq, 3)
  const T* dphi_u;  // (nf, nq, 3, 2)
  const T* phi_p;   // (nf, nq, 3)
  const T* gdphi;   // (nf, nq, 3, 2)
  const T* normal;  // (nf, nq, 2)
  const T* dS;      // (nf, nq)
};

template <typename T>
struct FacetIn {
  const T* u;
  const T* uprev;
  const T* p;
  const int* dofmap_u;  // (nf, 3)
  const int* dofmap_p;  // (nf, 3)
  const T* coords;      // (nf, 3, 2)
};

// r_u of facet f; um[b][i] and pe[b] carry the tangents
template <typename T, typename N>
__device__ __forceinline__ void facet_body(const FacetTabs<T>& tb, int64_t f,
                                           int nq, const T (&X)[3][2],
                                           const N (&um)[3][2],
                                           const N (&pe)[3], T mu,
                                           N (&ru)[3][2]) {
  const N zero = Lift<N>::of(T(0));
#pragma unroll
  for (int b = 0; b < 3; ++b) ru[b][0] = ru[b][1] = zero;
  for (int q = 0; q < nq; ++q) {
    const int64_t fq = f * nq + q;
    T gd[6], dp[6], ph[3], pp[3];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      gd[k] = __ldg(tb.gdphi + fq * 6 + k);
      dp[k] = __ldg(tb.dphi_u + fq * 6 + k);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ph[k] = __ldg(tb.phi_u + fq * 3 + k);
      pp[k] = __ldg(tb.phi_p + fq * 3 + k);
    }
    const T n[2] = {__ldg(tb.normal + fq * 2), __ldg(tb.normal + fq * 2 + 1)};
    const T dS = __ldg(tb.dS + fq);
    Geom<T> g;
    p1_geometry(X, gd, dp, g);
    const N pq = pe[0] * pp[0] + pe[1] * pp[1] + pe[2] * pp[2];
    N term[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // gtn_i = sum_j d(u_mid)_j/dx_i n_j
      N gtn = zero;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const N gji = um[0][j] * g.gu[0][i] + um[1][j] * g.gu[1][i] +
                      um[2][j] * g.gu[2][i];
        gtn = gtn + gji * n[j];
      }
      term[i] = pq * n[i] - mu * gtn;
    }
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const T w = dS * ph[b];
      ru[b][0] = ru[b][0] + w * term[0];
      ru[b][1] = ru[b][1] + w * term[1];
    }
  }
}

// the facet's vertices: X, u_mid = (u + u_prev) / 2 and p through the
// dofmaps
template <typename T, typename N>
__device__ __forceinline__ void load_facet(const FacetIn<T>& in, int64_t f,
                                           T (&X)[3][2], N (&um)[3][2],
                                           N (&pe)[3]) {
  using V2 = typename Vec2<T>::type;
  int nu[3], np[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    nu[b] = __ldg(in.dofmap_u + f * 3 + b);
    np[b] = __ldg(in.dofmap_p + f * 3 + b);
  }
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const V2 a = __ldg(reinterpret_cast<const V2*>(in.u) + nu[b]);
    const V2 c = __ldg(reinterpret_cast<const V2*>(in.uprev) + nu[b]);
    const V2 x = __ldg(reinterpret_cast<const V2*>(in.coords) + f * 3 + b);
    um[b][0] = Lift<N>::of(T(0.5) * (a.x + c.x));
    um[b][1] = Lift<N>::of(T(0.5) * (a.y + c.y));
    pe[b] = Lift<N>::of(__ldg(in.p + np[b]));
    X[b][0] = x.x;
    X[b][1] = x.y;
  }
}

// the residual of facet f < nf: ru_f (nf, 3, 2)
template <typename T>
__device__ __forceinline__ void facet_residual_lane(const FacetIn<T>& in,
                                                    const FacetTabs<T>& tb,
                                                    int64_t f, int nq, T mu,
                                                    T* __restrict__ ru_f) {
  T X[3][2], um[3][2], pe[3], ru[3][2];
  load_facet<T, T>(in, f, X, um, pe);
  facet_body<T, T>(tb, f, nq, X, um, pe, mu, ru);
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    ru_f[(f * 3 + b) * 2] = ru[b][0];
    ru_f[(f * 3 + b) * 2 + 1] = ru[b][1];
  }
}

// column lane % 9 of facet lane / 9 < nf: A_f (nf, 9, 9)
template <typename T>
__device__ __forceinline__ void facet_jacobian_lane(const FacetIn<T>& in,
                                                    const FacetTabs<T>& tb,
                                                    int64_t lane, int nq,
                                                    T mu, T* __restrict__ A) {
  using N = Dual<T, 1>;
  const int64_t f = lane / NLOC;
  const int j = (int)(lane - f * NLOC);  // the column
  T X[3][2];
  N um[3][2], pe[3], ru[3][2];
  load_facet<T, N>(in, f, X, um, pe);
  // d u_mid / d u = 1/2
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    um[b][0].d[0] = j == 2 * b ? T(0.5) : T(0);
    um[b][1].d[0] = j == 2 * b + 1 ? T(0.5) : T(0);
    pe[b].d[0] = j == 6 + b ? T(1) : T(0);
  }
  facet_body<T, N>(tb, f, nq, X, um, pe, mu, ru);
  T* col = A + f * (NLOC * NLOC) + j;
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    col[(b * 2) * NLOC] = ru[b][0].d[0];
    col[(b * 2 + 1) * NLOC] = ru[b][1].d[0];
    col[(6 + b) * NLOC] = T(0);
  }
}

// the arguments of both, from the C entry points' pointers
template <typename T>
FacetIn<T> facet_in(const void* u, const void* uprev, const void* p,
                    const void* dofmap_u, const void* dofmap_p,
                    const void* coords) {
  return FacetIn<T>{static_cast<const T*>(u), static_cast<const T*>(uprev),
                    static_cast<const T*>(p),
                    static_cast<const int*>(dofmap_u),
                    static_cast<const int*>(dofmap_p),
                    static_cast<const T*>(coords)};
}

template <typename T>
FacetTabs<T> facet_tabs(const void* phi_u, const void* dphi_u,
                        const void* phi_p, const void* gdphi,
                        const void* normal, const void* dS) {
  return FacetTabs<T>{static_cast<const T*>(phi_u),
                      static_cast<const T*>(dphi_u),
                      static_cast<const T*>(phi_p),
                      static_cast<const T*>(gdphi),
                      static_cast<const T*>(normal),
                      static_cast<const T*>(dS)};
}
