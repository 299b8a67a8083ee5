// The facet-term bodies, residual and Jacobian, one facet (residual) or
// one (facet, column) (Jacobian) a lane: K7 the natural correction, K12
// the viscous traction, K13 the backflow stabilisation, K16 the weak
// pressure, K17 the symmetric Nitsche u_T = 0 (sigma and curl forms),
// K18 the convective and directional do-nothing outlets (see the file
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
constexpr int TERM_WEAKP = 3;     // K16: scale pbar (v.n)
constexpr int TERM_NITSCHE = 4;   // K17: Nitsche u_T = 0, sigma form
constexpr int TERM_NITSCHE_CURL = 5;  // K17: Nitsche u_T = 0, curl form
constexpr int TERM_CBC = 6;       // K18: -1/2 (u_prev.n) (u.v)
constexpr int TERM_DDN = 7;       // K18: -1/2 min(u_prev.n, 0) (u.v)
constexpr int NTERMS = 8;

// per-facet tabulations (nf, nq, ...), as add_facet_term builds them
template <typename T>
struct FacetTabs {
  const T* phi_u;   // (nf, nq, 3)
  const T* dphi_u;  // (nf, nq, 3, 2)
  const T* phi_p;   // (nf, nq, 3)
  const T* gdphi;   // (nf, nq, 3, 2)
  const T* normal;  // (nf, nq, 2)
  const T* dS;      // (nf, nq)
  const T* h;       // (nf,): the size of the cell behind the facet
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

// one facet block: its arguments, its term and options, and the
// scalars the term's body takes: c is mu (natural), sign mu (viscous),
// -beta rho (backflow), scale pbar (weak pressure), mu (Nitsche) or
// -1/2 (CBC, DDN); c2 is beta mu (Nitsche's penalty), else unused
template <typename T>
struct FacetRange {
  FacetIn<T> in;
  FacetTabs<T> tb;
  int64_t nf;
  int nq;
  int term;
  int implicit;  // the velocity u (BDF2), else the midpoint (u + u_prev) / 2
  T c;
  T c2;
  T* out;  // ru_f (nf, 3, 2) or A_f (nf, 9, 9)
};

// r_u of facet f; uv[b][i] (the term's velocity) and pe[b] carry the
// tangents, upe (u_prev) is a constant of the derivative
template <typename T, typename N, int TERM>
__device__ __forceinline__ void facet_body(const FacetTabs<T>& tb, int64_t f,
                                           int nq, const T (&X)[3][2],
                                           const N (&uv)[3][2],
                                           const T (&upe)[3][2],
                                           const N (&pe)[3], T c, T c2,
                                           N (&ru)[3][2]) {
  constexpr bool UPREV =
      TERM == TERM_BACKFLOW || TERM == TERM_CBC || TERM == TERM_DDN;
  constexpr bool NITSCHE = TERM == TERM_NITSCHE || TERM == TERM_NITSCHE_CURL;
  const N zero = Lift<N>::of(T(0));
#pragma unroll
  for (int b = 0; b < 3; ++b) ru[b][0] = ru[b][1] = zero;
  // Nitsche's penalty beta mu / h, once a facet
  T pen = T(0);
  if constexpr (NITSCHE) pen = c2 * recip(__ldg(tb.h + f));
  for (int q = 0; q < nq; ++q) {
    const int64_t fq = f * nq + q;
    T ph[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) ph[k] = __ldg(tb.phi_u + fq * 3 + k);
    const T n[2] = {__ldg(tb.normal + fq * 2), __ldg(tb.normal + fq * 2 + 1)};
    const T dS = __ldg(tb.dS + fq);
    N term[2];
    if constexpr (UPREV) {
      // the coefficient at u_prev: plain numbers, so the term is linear
      // in u and no dual meets |.|; (a)_- = (a - |a|) / 2 = min(a, 0)
      T un = T(0);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        un = un + (upe[0][i] * ph[0] + upe[1][i] * ph[1] +
                   upe[2][i] * ph[2]) * n[i];
      T s;
      if constexpr (TERM == TERM_CBC)
        s = c * un;
      else
        s = c * (T(0.5) * (un - fabs(un)));
#pragma unroll
      for (int i = 0; i < 2; ++i)
        term[i] = s * (uv[0][i] * ph[0] + uv[1][i] * ph[1] +
                       uv[2][i] * ph[2]);
    } else if constexpr (TERM == TERM_WEAKP) {
      // reads no state: its tangents are zero
#pragma unroll
      for (int i = 0; i < 2; ++i) term[i] = Lift<N>::of(c * n[i]);
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
      } else if constexpr (TERM == TERM_VISCOUS) {
        // 2 eps(uv) n = (G + G^T) n, times sign mu
#pragma unroll
        for (int i = 0; i < 2; ++i)
          term[i] = c * ((G[i][0] + G[0][i]) * n[0] +
                         (G[i][1] + G[1][i]) * n[1]);
      } else {
        // Nitsche: uv at the point and its tangential part u_T
        N uq[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          uq[i] = uv[0][i] * ph[0] + uv[1][i] * ph[1] + uv[2][i] * ph[2];
        const N un = uq[0] * n[0] + uq[1] * n[1];
        const N uT[2] = {uq[0] - un * n[0], uq[1] - un * n[1]};
        const T cw = c * dS;  // mu dS: the symmetry term's weight
        if constexpr (TERM == TERM_NITSCHE) {
          // consistency -(2 mu eps(u) n)_T . v and penalty (beta mu / h)
          // u_T . v (u_T . n = 0), both against phi_b
          N sn[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            sn[i] = c * ((G[i][0] + G[0][i]) * n[0] +
                         (G[i][1] + G[1][i]) * n[1]);
          const N snn = sn[0] * n[0] + sn[1] * n[1];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            term[i] = pen * uT[i] - (sn[i] - snn * n[i]);
          // symmetry -(2 mu eps(v) n) . u_T, v = phi_b e_i:
          // -mu ((grad phi_b . n) u_T,i + (grad phi_b . u_T) n_i)
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const T gn = g.gu[b][0] * n[0] + g.gu[b][1] * n[1];
            const N gt = uT[0] * g.gu[b][0] + uT[1] * g.gu[b][1];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              ru[b][i] = ru[b][i] - cw * (uT[i] * gn + gt * n[i]);
          }
        } else {
          // curl form, 2D: omega = d u_y / dx - d u_x / dy, curl u x n =
          // (-omega n_y, omega n_x); consistency -mu (curl u x n)_T . v
          // and the penalty, against phi_b
          const N om = G[1][0] - G[0][1];
          const N ccn[2] = {om * (-n[1]), om * n[0]};
          const N cn = ccn[0] * n[0] + ccn[1] * n[1];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            term[i] = pen * uT[i] - c * (ccn[i] - cn * n[i]);
          // symmetry -mu (curl v x n) . u_T, v = phi_b e_i: curl v is
          // -d phi_b / dy (i = 0) or d phi_b / dx (i = 1), so the term is
          // -mu curl(v) (u_T,y n_x - u_T,x n_y)
          const N w = uT[1] * n[0] - uT[0] * n[1];
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            ru[b][0] = ru[b][0] + (cw * g.gu[b][1]) * w;
            ru[b][1] = ru[b][1] - (cw * g.gu[b][0]) * w;
          }
        }
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
  facet_body<T, T, TERM>(r.tb, f, r.nq, X, uv, upe, pe, r.c, r.c2, ru);
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    r.out[(f * 3 + b) * 2] = ru[b][0];
    r.out[(f * 3 + b) * 2 + 1] = ru[b][1];
  }
}

// column lane % 9 of facet lane / 9 < nf: A_f (nf, 9, 9); the three
// pressure rows are zero (no term has a continuity part), and so is
// the whole block of the weak pressure, which reads no state
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
  facet_body<T, N, TERM>(r.tb, f, r.nq, X, uv, upe, pe, r.c, r.c2, ru);
  T* col = r.out + f * (NLOC * NLOC) + j;
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    col[(b * 2) * NLOC] = ru[b][0].d[0];
    col[(b * 2 + 1) * NLOC] = ru[b][1].d[0];
    col[(6 + b) * NLOC] = T(0);
  }
}

// the term sets a fused launch is compiled for (bit TERM of the mask):
// each element kernel with facet blocks is instantiated for the sets
// its forms need, and the launch takes the smallest that holds every
// block's term, so that a kernel carries only the bodies it can run
__host__ __device__ constexpr unsigned term_bit(int term) {
  return 1u << term;
}
constexpr unsigned TERMS_K7 = term_bit(TERM_NATURAL);
constexpr unsigned TERMS_OUTLET =
    TERMS_K7 | term_bit(TERM_VISCOUS) | term_bit(TERM_BACKFLOW);
constexpr unsigned TERMS_ALL = (1u << NTERMS) - 1;

// lane `lane` of a facet range whose term is known at run time only (a
// fused launch: every block of the range takes the same branch), one of
// the terms in MASK
template <typename T, unsigned MASK>
__device__ __forceinline__ void facet_lane(const FacetRange<T>& r,
                                           int64_t lane, bool jacobian) {
#define FACET_TERM_CASE(TERM)                       \
  case TERM:                                        \
    if constexpr ((MASK & term_bit(TERM)) != 0) {   \
      if (jacobian)                                 \
        facet_jacobian_lane<T, TERM>(r, lane);      \
      else                                          \
        facet_residual_lane<T, TERM>(r, lane);      \
    }                                               \
    break;
  if (lane >= (jacobian ? r.nf * NLOC : r.nf)) return;
  switch (r.term) {
    FACET_TERM_CASE(TERM_NATURAL)
    FACET_TERM_CASE(TERM_VISCOUS)
    FACET_TERM_CASE(TERM_BACKFLOW)
    FACET_TERM_CASE(TERM_WEAKP)
    FACET_TERM_CASE(TERM_NITSCHE)
    FACET_TERM_CASE(TERM_NITSCHE_CURL)
    FACET_TERM_CASE(TERM_CBC)
    FACET_TERM_CASE(TERM_DDN)
  }
#undef FACET_TERM_CASE
}

// a facet range from the C entry points' pointers: dofmap_u,
// dofmap_p, coords, the six tables phi_u, dphi_u, phi_p, gdphi, normal,
// dS and the cell sizes h, in this order
template <typename T>
FacetRange<T> facet_range(const void* u, const void* uprev, const void* p,
                          const void* const* fp, int64_t nf, int nq,
                          int term, int implicit, double c, double c2,
                          void* out) {
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
                      static_cast<const T*>(fp[8]),
                      static_cast<const T*>(fp[9])};
  r.nf = nf;
  r.nq = nq;
  r.term = term;
  r.implicit = implicit;
  r.c = (T)c;
  r.c2 = (T)c2;
  r.out = static_cast<T*>(out);
  return r;
}
