// The facet-term bodies, residual and Jacobian, one facet (residual) or
// one (facet, column) (Jacobian) a lane: K7 the natural correction, K12
// the viscous traction, K13 the backflow stabilisation (see the file
// comment of ns_facet.cu for the terms). csrc/ns_facet.cu launches each
// alone; csrc/ns_cell_residual.cu runs a form's facet blocks in the
// element kernel's launch, each block a range of blocks after the
// cells' (FacetRange below).

#pragma once

#include <cstdint>

#include "element.cuh"

// the terms, as the C entry points number them
constexpr int TERM_NATURAL = 0;   // K7:  p n.v - mu (nabla_grad u)^T n.v
constexpr int TERM_VISCOUS = 1;   // K12: sign (2 mu eps(u) n).v
constexpr int TERM_BACKFLOW = 2;  // K13: -beta rho (u_prev.n)_- (u.v)
constexpr int NTERMS = 3;

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

// one facet block: its arguments, its term and options, and the one
// scalar the term's body takes: mu (natural), sign mu (viscous),
// -beta rho (backflow)
template <typename T>
struct FacetRange {
  FacetIn<T> in;
  FacetTabs<T> tb;
  int64_t nf;
  int nq;
  int term;
  int implicit;  // the velocity u (BDF2), else the midpoint (u + u_prev) / 2
  T c;
  T* out;  // ru_f (nf, 3, 2) or A_f (nf, 9, 9)
};

// r_u of facet f; uv[b][i] (the term's velocity) and pe[b] carry the
// tangents, upe (u_prev) is a constant of the derivative
template <typename T, typename N, int TERM>
__device__ __forceinline__ void facet_body(const FacetTabs<T>& tb, int64_t f,
                                           int nq, const T (&X)[3][2],
                                           const N (&uv)[3][2],
                                           const T (&upe)[3][2],
                                           const N (&pe)[3], T c,
                                           N (&ru)[3][2]) {
  const N zero = Lift<N>::of(T(0));
#pragma unroll
  for (int b = 0; b < 3; ++b) ru[b][0] = ru[b][1] = zero;
  for (int q = 0; q < nq; ++q) {
    const int64_t fq = f * nq + q;
    T ph[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) ph[k] = __ldg(tb.phi_u + fq * 3 + k);
    const T n[2] = {__ldg(tb.normal + fq * 2), __ldg(tb.normal + fq * 2 + 1)};
    const T dS = __ldg(tb.dS + fq);
    N term[2];
    if constexpr (TERM == TERM_BACKFLOW) {
      // (u_prev.n)_- = (a - |a|) / 2 at the point: plain numbers, so
      // the term is linear in u and no dual meets |.|
      T un = T(0);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        un = un + (upe[0][i] * ph[0] + upe[1][i] * ph[1] +
                   upe[2][i] * ph[2]) * n[i];
      const T s = c * (T(0.5) * (un - fabs(un)));
#pragma unroll
      for (int i = 0; i < 2; ++i)
        term[i] = s * (uv[0][i] * ph[0] + uv[1][i] * ph[1] +
                       uv[2][i] * ph[2]);
    } else {
      T gd[6], dp[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        gd[k] = __ldg(tb.gdphi + fq * 6 + k);
        dp[k] = __ldg(tb.dphi_u + fq * 6 + k);
      }
      Geom<T> g;
      p1_geometry(X, gd, dp, g);
      // G[i][a] = d uv_i / d x_a
      N G[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int a = 0; a < 2; ++a)
          G[i][a] = uv[0][i] * g.gu[0][a] + uv[1][i] * g.gu[1][a] +
                    uv[2][i] * g.gu[2][a];
      if constexpr (TERM == TERM_NATURAL) {
        T pp[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) pp[k] = __ldg(tb.phi_p + fq * 3 + k);
        const N pq = pe[0] * pp[0] + pe[1] * pp[1] + pe[2] * pp[2];
        // sum_j d uv_j / d x_i n_j
#pragma unroll
        for (int i = 0; i < 2; ++i)
          term[i] = pq * n[i] - c * (G[0][i] * n[0] + G[1][i] * n[1]);
      } else {
        // 2 eps(uv) n = (G + G^T) n, times sign mu
#pragma unroll
        for (int i = 0; i < 2; ++i)
          term[i] = c * ((G[i][0] + G[0][i]) * n[0] +
                         (G[i][1] + G[1][i]) * n[1]);
      }
    }
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const T w = dS * ph[b];
      ru[b][0] = ru[b][0] + w * term[0];
      ru[b][1] = ru[b][1] + w * term[1];
    }
  }
}

// the facet's vertices: X, the term's velocity uv, u_prev and p
// through the dofmaps
template <typename T, typename N>
__device__ __forceinline__ void load_facet(const FacetIn<T>& in, int64_t f,
                                           int implicit, T (&X)[3][2],
                                           N (&uv)[3][2], T (&upe)[3][2],
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
    uv[b][0] = Lift<N>::of(implicit ? a.x : T(0.5) * (a.x + c.x));
    uv[b][1] = Lift<N>::of(implicit ? a.y : T(0.5) * (a.y + c.y));
    upe[b][0] = c.x;
    upe[b][1] = c.y;
    pe[b] = Lift<N>::of(__ldg(in.p + np[b]));
    X[b][0] = x.x;
    X[b][1] = x.y;
  }
}

// the residual of facet f < nf: ru_f (nf, 3, 2)
template <typename T, int TERM>
__device__ __forceinline__ void facet_residual_lane(const FacetRange<T>& r,
                                                    int64_t f) {
  T X[3][2], uv[3][2], upe[3][2], pe[3], ru[3][2];
  load_facet<T, T>(r.in, f, r.implicit, X, uv, upe, pe);
  facet_body<T, T, TERM>(r.tb, f, r.nq, X, uv, upe, pe, r.c, ru);
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    r.out[(f * 3 + b) * 2] = ru[b][0];
    r.out[(f * 3 + b) * 2 + 1] = ru[b][1];
  }
}

// column lane % 9 of facet lane / 9 < nf: A_f (nf, 9, 9); the three
// pressure rows are zero (no term has a continuity part)
template <typename T, int TERM>
__device__ __forceinline__ void facet_jacobian_lane(const FacetRange<T>& r,
                                                    int64_t lane) {
  using N = Dual<T, 1>;
  const int64_t f = lane / NLOC;
  const int j = (int)(lane - f * NLOC);  // the column
  T X[3][2], upe[3][2];
  N uv[3][2], pe[3], ru[3][2];
  load_facet<T, N>(r.in, f, r.implicit, X, uv, upe, pe);
  // d uv / d u: 1 (implicit) or 1/2 (midpoint)
  const T du = r.implicit ? T(1) : T(0.5);
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    uv[b][0].d[0] = j == 2 * b ? du : T(0);
    uv[b][1].d[0] = j == 2 * b + 1 ? du : T(0);
    pe[b].d[0] = j == 6 + b ? T(1) : T(0);
  }
  facet_body<T, N, TERM>(r.tb, f, r.nq, X, uv, upe, pe, r.c, ru);
  T* col = r.out + f * (NLOC * NLOC) + j;
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    col[(b * 2) * NLOC] = ru[b][0].d[0];
    col[(b * 2 + 1) * NLOC] = ru[b][1].d[0];
    col[(6 + b) * NLOC] = T(0);
  }
}

// lane `lane` of a facet range whose term is known at run time only (a
// fused launch: every block of the range takes the same branch)
template <typename T>
__device__ __forceinline__ void facet_lane(const FacetRange<T>& r,
                                           int64_t lane, bool jacobian) {
  if (jacobian) {
    if (lane >= r.nf * NLOC) return;
    if (r.term == TERM_NATURAL)
      facet_jacobian_lane<T, TERM_NATURAL>(r, lane);
    else if (r.term == TERM_VISCOUS)
      facet_jacobian_lane<T, TERM_VISCOUS>(r, lane);
    else
      facet_jacobian_lane<T, TERM_BACKFLOW>(r, lane);
  } else {
    if (lane >= r.nf) return;
    if (r.term == TERM_NATURAL)
      facet_residual_lane<T, TERM_NATURAL>(r, lane);
    else if (r.term == TERM_VISCOUS)
      facet_residual_lane<T, TERM_VISCOUS>(r, lane);
    else
      facet_residual_lane<T, TERM_BACKFLOW>(r, lane);
  }
}

// a facet range from the C entry points' pointers: dofmap_u,
// dofmap_p, coords and the six tables phi_u, dphi_u, phi_p, gdphi,
// normal, dS, in this order
template <typename T>
FacetRange<T> facet_range(const void* u, const void* uprev, const void* p,
                          const void* const* fp, int64_t nf, int nq,
                          int term, int implicit, double c, void* out) {
  FacetRange<T> r;
  r.in = FacetIn<T>{static_cast<const T*>(u), static_cast<const T*>(uprev),
                    static_cast<const T*>(p), static_cast<const int*>(fp[0]),
                    static_cast<const int*>(fp[1]),
                    static_cast<const T*>(fp[2])};
  r.tb = FacetTabs<T>{static_cast<const T*>(fp[3]),
                      static_cast<const T*>(fp[4]),
                      static_cast<const T*>(fp[5]),
                      static_cast<const T*>(fp[6]),
                      static_cast<const T*>(fp[7]),
                      static_cast<const T*>(fp[8])};
  r.nf = nf;
  r.nq = nq;
  r.term = term;
  r.implicit = implicit;
  r.c = (T)c;
  r.out = static_cast<T*>(out);
  return r;
}
