// K3 on P1 tetrahedra: the stabilized Navier-Stokes cell kernel in three
// dimensions, residual and Jacobian, with the natural-correction facet
// term (K7) on triangular facets in the same launch.
//
// The same equations as the triangles' body (ns_cell_residual.cu,
// FORM_MID: Crank-Nicolson midpoint, Galerkin terms with SUPG, PSPG and
// LSIC, tau from u_prev), written for four vertices and three velocity
// components: velocity, pressure and geometry share one P1 basis and one
// dofmap, and the cell is affine, so the geometry, the physical gradients
// and what depends on them alone (grad u, grad p, div u, the viscous
// stress) leave the point loop, and the terms that meet grad v are summed
// over the points as a 3 x 3 and a 3-vector and contracted with the
// gradients once, after the loop. The flat element layout is cfdtpu's:
// [u(b, i) row-major (b < 4, i < 3), then p(b)], 16 dofs a cell.
//
// The residual: one lane a cell, RES_CELLS a block, each lane loading its
// four vertices through the dofmap (scalar loads: a vertex's three
// velocity values are 12 or 24 bytes, no vector width), and writing ru (4,
// 3) and rp (4).
//
// The Jacobian: four lanes a cell, lane j carrying the four tangents along
// u(j, 0), u(j, 1), u(j, 2) and p(j) (Dual<T, 4>): four columns of the
// (16, 16) block. The cell's four vertices are loaded once, one (cell,
// vertex) slot a lane, and shared through shared memory; each block
// stages its JAC_CELLS blocks of 256 values in shared memory and copies
// them out as one contiguous run of 16-byte stores (256 values a cell:
// 1.4 GB in float32 at 1.37 million cells, so the stores are the
// kernel's bytes). JAC_CELLS = 16 keeps the tile at 32 KB in float64.
//
// The facet blocks: K7, the natural correction (p n - mu (grad u_m)^T n)
// . v on triangular facets with 3D normals (ns_facet.cuh's FacetRange:
// the form's per-facet tables), each block a range of blocks after the
// cells', one lane a facet (residual, ru_f (nf, 4, 3)) or a (facet,
// column) (Jacobian, A_f (nf, 16, 16), its pressure rows zero). Only K7
// runs on tetrahedra: the host refuses the other terms.
//
// Each lane sums its points in order: two calls are bitwise equal.

#include <cstdint>

#include "element.cuh"
#include "ns_facet.cuh"

namespace {

constexpr int MAXQ = 16;       // quadrature points held in shared memory
constexpr int NV = 4;          // vertices a cell
constexpr int NL = 16;         // flat element dofs: u(4, 3) then p(4)
constexpr int RES_CELLS = 128; // residual: cells (lanes) a block
constexpr int JAC_CELLS = 16;  // Jacobian: cells a block
constexpr int JAC_ND = 4;      // tangent directions a lane
constexpr int JAC_THREADS = JAC_CELLS * NV;
constexpr int MAXF = 8;        // facet blocks a launch carries
constexpr int VERT = 10;       // a vertex as loaded: u (3), u_prev (3), p, X (3)

template <typename T>
struct TetParams {
  T rho, irho, mu, idt, eps;
  T f[3];
  T a2sq;    // (2 / dt)^2 = t2^-2
  T nu4;     // 4 nu: t3^-1 = 4 nu / h^2
  T inv6nu;  // Re_h / 3 = |u| h / (6 nu)
};

template <typename T>
TetParams<T> tet_params(const double* sc) {
  // sc: rho, mu, dt, f0, f1, f2, eps
  const double rho = sc[0], mu = sc[1], dt = sc[2];
  TetParams<T> q;
  q.rho = (T)rho;
  q.irho = (T)(1.0 / rho);
  q.mu = (T)mu;
  q.idt = (T)(1.0 / dt);
  q.f[0] = (T)sc[3];
  q.f[1] = (T)sc[4];
  q.f[2] = (T)sc[5];
  q.eps = (T)sc[6];
  q.a2sq = (T)(4.0 / (dt * dt));
  q.nu4 = (T)(4.0 * mu / rho);
  q.inv6nu = (T)(rho / (6.0 * mu));
  return q;
}

__device__ __forceinline__ float inv_sqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double inv_sqrt(double x) { return 1.0 / sqrt(x); }
__device__ __forceinline__ float norm_of(float s) {
  return s * rsqrtf(fmaxf(s, 1e-30f));
}
__device__ __forceinline__ double norm_of(double s) { return sqrt(s); }

// the reference tabulations: phi at every point, dphi once (affine)
template <typename T>
struct TetTabs {
  T phi[MAXQ * NV];
  T dphi[NV * 3];
  T qw[MAXQ];
};

template <typename T>
__device__ __forceinline__ void load_tabs(TetTabs<T>& tb, const T* phi,
                                          const T* dphi, const T* qw,
                                          int nq) {
  for (int i = threadIdx.x; i < nq * NV; i += blockDim.x) {
    tb.phi[i] = __ldg(phi + i);
    if (i < NV * 3) tb.dphi[i] = __ldg(dphi + i);
    if (i < nq) tb.qw[i] = __ldg(qw + i);
  }
}

// the physical basis gradients of a P1 tetrahedron: gu[b][g] = sum_d
// dphi[b][d] (J^-1)[d][g], J[a][d] = sum_v X[v][a] gdphi[v][d], and
// (J^-1)[d][a] = C[a][d] / det with C the cofactors of J
template <typename T>
struct TetGeom {
  T gu[NV][3];
  T adet;
};

template <typename T>
__device__ __forceinline__ void tet_geometry(const T (&X)[NV][3],
                                             const T* gd, const T* dp,
                                             TetGeom<T>& g) {
  T J[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      J[a][d] = X[0][a] * gd[d] + X[1][a] * gd[3 + d] + X[2][a] * gd[6 + d] +
                X[3][a] * gd[9 + d];
  T C[3][3];
  C[0][0] = J[1][1] * J[2][2] - J[1][2] * J[2][1];
  C[0][1] = J[1][2] * J[2][0] - J[1][0] * J[2][2];
  C[0][2] = J[1][0] * J[2][1] - J[1][1] * J[2][0];
  C[1][0] = J[0][2] * J[2][1] - J[0][1] * J[2][2];
  C[1][1] = J[0][0] * J[2][2] - J[0][2] * J[2][0];
  C[1][2] = J[0][1] * J[2][0] - J[0][0] * J[2][1];
  C[2][0] = J[0][1] * J[1][2] - J[0][2] * J[1][1];
  C[2][1] = J[0][2] * J[1][0] - J[0][0] * J[1][2];
  C[2][2] = J[0][0] * J[1][1] - J[0][1] * J[1][0];
  const T det = J[0][0] * C[0][0] + J[0][1] * C[0][1] + J[0][2] * C[0][2];
  const T idet = recip(det);
#pragma unroll
  for (int b = 0; b < NV; ++b)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      g.gu[b][a] = (dp[b * 3] * C[a][0] + dp[b * 3 + 1] * C[a][1] +
                    dp[b * 3 + 2] * C[a][2]) *
                   idet;
  g.adet = fabs(det);
}

// the cells' arguments, as the C entry point passes them
template <typename T>
struct TetIn {
  const T* __restrict__ u;
  const T* __restrict__ uprev;
  const T* __restrict__ p;
  const int* __restrict__ dofmap;
  const T* __restrict__ coords;
  const T* __restrict__ hcell;
  const T* __restrict__ phi;
  const T* __restrict__ dphi;
  const T* __restrict__ qw;
  int64_t nc;
  int nq;
};

// vertex `slot` (cell * 4 + v) as a lane loads it
template <typename T>
__device__ __forceinline__ void load_vertex(int64_t slot, const TetIn<T>& ci,
                                            T* sv) {
  const int64_t n = __ldg(ci.dofmap + slot);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sv[i] = __ldg(ci.u + n * 3 + i);
    sv[3 + i] = __ldg(ci.uprev + n * 3 + i);
    sv[7 + i] = __ldg(ci.coords + slot * 3 + i);
  }
  sv[6] = __ldg(ci.p + n);
}

template <typename T, typename N>
struct TetState {
  N ue[NV][3];
  N pe[NV];
  T upe[NV][3];
  T X[NV][3];
  T h;
};

template <typename T, typename N>
__device__ __forceinline__ void read_state(const T (*sv)[VERT], T h,
                                           TetState<T, N>& s) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.ue[v][i] = Lift<N>::of(sv[v][i]);
      s.upe[v][i] = sv[v][3 + i];
      s.X[v][i] = sv[v][7 + i];
    }
    s.pe[v] = Lift<N>::of(sv[v][6]);
  }
  s.h = h;
}

// The cell residual ru[b][i], rp[b] (the triangles' FORM_MID body in 3D).
template <typename T, typename N>
__device__ __forceinline__ void tet_body(const TetState<T, N>& s,
                                         const TetTabs<T>& tb,
                                         const TetParams<T>& prm, int nq,
                                         N (&ru)[NV][3], N (&rp)[NV]) {
  const N zero = Lift<N>::of(T(0));
  TetGeom<T> g;
  tet_geometry(s.X, tb.dphi, tb.dphi, g);
  // grad of the midpoint velocity, [i][a] = d u_i / d x_a; grad p - rho f;
  // the viscous stress mu (grad u + grad u^T)
  N gum[3][3], c[3], sv[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const N gu = s.ue[0][i] * g.gu[0][a] + s.ue[1][i] * g.gu[1][a] +
                   s.ue[2][i] * g.gu[2][a] + s.ue[3][i] * g.gu[3][a];
      const T gup = s.upe[0][i] * g.gu[0][a] + s.upe[1][i] * g.gu[1][a] +
                    s.upe[2][i] * g.gu[2][a] + s.upe[3][i] * g.gu[3][a];
      gum[i][a] = T(0.5) * (gu + gup);
    }
    c[i] = (s.pe[0] * g.gu[0][i] + s.pe[1] * g.gu[1][i] +
            s.pe[2] * g.gu[2][i] + s.pe[3] * g.gu[3][i]) -
           prm.rho * prm.f[i];
  }
  const N div = gum[0][0] + gum[1][1] + gum[2][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) sv[i][j] = prm.mu * (gum[i][j] + gum[j][i]);

  N S[3][3], P[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    P[i] = zero;
#pragma unroll
    for (int j = 0; j < 3; ++j) S[i][j] = zero;
  }
#pragma unroll
  for (int b = 0; b < NV; ++b) {
    rp[b] = zero;
#pragma unroll
    for (int i = 0; i < 3; ++i) ru[b][i] = zero;
  }
  const T ih = recip(s.h);
  const T a3 = prm.nu4 * ih * ih;
  const T a23sq = a3 * a3 + prm.a2sq;  // t2^-2 + t3^-2
  for (int q = 0; q < nq; ++q) {
    const T* ph = tb.phi + q * NV;
    const T w = tb.qw[q] * g.adet;
    N uq[3], umq[3], dudt[3];
    T upq[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      uq[i] = s.ue[0][i] * ph[0] + s.ue[1][i] * ph[1] + s.ue[2][i] * ph[2] +
              s.ue[3][i] * ph[3];
      upq[i] = s.upe[0][i] * ph[0] + s.upe[1][i] * ph[1] +
               s.upe[2][i] * ph[2] + s.upe[3][i] * ph[3];
      umq[i] = T(0.5) * (uq[i] + upq[i]);
      dudt[i] = (uq[i] - upq[i]) * prm.idt;
    }
    const N pq = s.pe[0] * ph[0] + s.pe[1] * ph[1] + s.pe[2] * ph[2] +
                 s.pe[3] * ph[3];
    // tau_SUPG = (t1^-2 + t2^-2 + t3^-2)^(-1/2) and tau_LSIC, at u_prev
    const T vn = norm_of(upq[0] * upq[0] + upq[1] * upq[1] + upq[2] * upq[2]);
    const T a1 = fmax(T(2) * vn, prm.eps) * ih;  // t1^-1
    const T tau = inv_sqrt(a1 * a1 + a23sq);
    const T vh = vn * s.h;
    const T tau_lsic = T(0.5) * vh * fmin(vh * prm.inv6nu, T(1));
    N tR[3], wm[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const N acc = dudt[i] + (gum[i][0] * umq[0] + gum[i][1] * umq[1] +
                               gum[i][2] * umq[2]);
      tR[i] = tau * (prm.rho * acc + c[i]);
      wm[i] = w * (prm.rho * (acc - prm.f[i]));
    }
    const N iso = (tau_lsic * prm.rho) * div - pq;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const N sij = i == j ? sv[i][j] + iso : sv[i][j];
        S[i][j] = S[i][j] + w * (sij + tR[i] * umq[j]);
      }
      P[i] = P[i] + (w * prm.irho) * tR[i];  // PSPG
    }
    const N wd = w * div;  // continuity
#pragma unroll
    for (int b = 0; b < NV; ++b) {
#pragma unroll
      for (int i = 0; i < 3; ++i) ru[b][i] = ru[b][i] + wm[i] * ph[b];
      rp[b] = rp[b] + wd * ph[b];
    }
  }
  // ru[b][i] += sum_j S[i][j] gu[b][j], rp[b] += sum_i P[i] gu[b][i]
#pragma unroll
  for (int b = 0; b < NV; ++b) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      ru[b][i] = ru[b][i] + (S[i][0] * g.gu[b][0] + S[i][1] * g.gu[b][1] +
                             S[i][2] * g.gu[b][2]);
    rp[b] = rp[b] + (P[0] * g.gu[b][0] + P[1] * g.gu[b][1] +
                     P[2] * g.gu[b][2]);
  }
}

// ---------------------------------------------------------------------
// K7 on triangular facets: r_u of facet f, the natural correction
// (p n - c (grad uv)^T n) . v with c = mu
template <typename T, typename N>
__device__ __forceinline__ void tet_facet_body(const FacetTabs<T>& tb,
                                               int64_t f, int nq,
                                               const T (&X)[NV][3],
                                               const N (&uv)[NV][3],
                                               const N (&pe)[NV], T c,
                                               N (&ru)[NV][3]) {
  const N zero = Lift<N>::of(T(0));
#pragma unroll
  for (int b = 0; b < NV; ++b) ru[b][0] = ru[b][1] = ru[b][2] = zero;
  for (int q = 0; q < nq; ++q) {
    const int64_t fq = f * nq + q;
    T ph[NV], pp[NV], gd[NV * 3], dp[NV * 3];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      ph[k] = __ldg(tb.phi_u + fq * NV + k);
      pp[k] = __ldg(tb.phi_p + fq * NV + k);
    }
#pragma unroll
    for (int k = 0; k < NV * 3; ++k) {
      gd[k] = __ldg(tb.gdphi + fq * (NV * 3) + k);
      dp[k] = __ldg(tb.dphi_u + fq * (NV * 3) + k);
    }
    const T n[3] = {__ldg(tb.normal + fq * 3), __ldg(tb.normal + fq * 3 + 1),
                    __ldg(tb.normal + fq * 3 + 2)};
    const T dS = __ldg(tb.dS + fq);
    TetGeom<T> g;
    tet_geometry(X, gd, dp, g);
    // G[i][a] = d uv_i / d x_a
    N G[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int a = 0; a < 3; ++a)
        G[i][a] = uv[0][i] * g.gu[0][a] + uv[1][i] * g.gu[1][a] +
                  uv[2][i] * g.gu[2][a] + uv[3][i] * g.gu[3][a];
    const N pq = pe[0] * pp[0] + pe[1] * pp[1] + pe[2] * pp[2] + pe[3] * pp[3];
    N term[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      term[i] = pq * n[i] -
                c * (G[0][i] * n[0] + G[1][i] * n[1] + G[2][i] * n[2]);
#pragma unroll
    for (int b = 0; b < NV; ++b) {
      const T w = dS * ph[b];
#pragma unroll
      for (int i = 0; i < 3; ++i) ru[b][i] = ru[b][i] + w * term[i];
    }
  }
}

// the facet's cell: X, the term's velocity uv (the midpoint, or u where
// implicit), and p
template <typename T, typename N>
__device__ __forceinline__ void load_tet_facet(const FacetIn<T>& in,
                                               int64_t f, int implicit,
                                               T (&X)[NV][3],
                                               N (&uv)[NV][3], N (&pe)[NV]) {
#pragma unroll
  for (int b = 0; b < NV; ++b) {
    const int64_t nu = __ldg(in.dofmap_u + f * NV + b);
    const int64_t np = __ldg(in.dofmap_p + f * NV + b);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T a = __ldg(in.u + nu * 3 + i);
      const T c = __ldg(in.uprev + nu * 3 + i);
      uv[b][i] = Lift<N>::of(implicit ? a : T(0.5) * (a + c));
      X[b][i] = __ldg(in.coords + (f * NV + b) * 3 + i);
    }
    pe[b] = Lift<N>::of(__ldg(in.p + np));
  }
}

template <typename T>
__device__ __forceinline__ void tet_facet_residual_lane(
    const FacetRange<T>& r, int64_t f) {
  T X[NV][3], uv[NV][3], pe[NV], ru[NV][3];
  load_tet_facet<T, T>(r.in, f, r.implicit, X, uv, pe);
  tet_facet_body<T, T>(r.tb, f, r.nq, X, uv, pe, r.c, ru);
#pragma unroll
  for (int b = 0; b < NV; ++b)
#pragma unroll
    for (int i = 0; i < 3; ++i) r.out[(f * NV + b) * 3 + i] = ru[b][i];
}

// column lane % 16 of facet lane / 16: A_f (nf, 16, 16), the pressure
// rows zero
template <typename T>
__device__ __forceinline__ void tet_facet_jacobian_lane(
    const FacetRange<T>& r, int64_t lane) {
  using N = Dual<T, 1>;
  const int64_t f = lane / NL;
  const int j = (int)(lane - f * NL);  // the column
  T X[NV][3];
  N uv[NV][3], pe[NV], ru[NV][3];
  load_tet_facet<T, N>(r.in, f, r.implicit, X, uv, pe);
  const T du = r.implicit ? T(1) : T(0.5);  // d uv / d u
#pragma unroll
  for (int b = 0; b < NV; ++b) {
#pragma unroll
    for (int i = 0; i < 3; ++i) uv[b][i].d[0] = j == 3 * b + i ? du : T(0);
    pe[b].d[0] = j == 12 + b ? T(1) : T(0);
  }
  tet_facet_body<T, N>(r.tb, f, r.nq, X, uv, pe, r.c, ru);
  T* col = r.out + f * (NL * NL) + j;
#pragma unroll
  for (int b = 0; b < NV; ++b) {
#pragma unroll
    for (int i = 0; i < 3; ++i) col[(3 * b + i) * NL] = ru[b][i].d[0];
    col[(12 + b) * NL] = T(0);
  }
}

template <typename T>
struct TetFacetRanges {
  FacetRange<T> r[MAXF];
  int64_t first[MAXF + 1];
  int n;
};

template <typename T>
__device__ __forceinline__ void tet_facet_block(const TetFacetRanges<T>& fr,
                                                int64_t b, bool jacobian) {
  int k = 0;
#pragma unroll
  for (int i = 1; i < MAXF; ++i)
    if (i < fr.n && b >= fr.first[i]) k = i;
  const int64_t lane = (b - fr.first[k]) * blockDim.x + threadIdx.x;
  // copied out of parameter space by constant indices, so that one
  // inlined body serves every range (as ns_cell_residual.cu does)
  static_assert(MAXF == 8, "one case a range");
  FacetRange<T> r;
  switch (k) {
    case 0: r = fr.r[0]; break;
    case 1: r = fr.r[1]; break;
    case 2: r = fr.r[2]; break;
    case 3: r = fr.r[3]; break;
    case 4: r = fr.r[4]; break;
    case 5: r = fr.r[5]; break;
    case 6: r = fr.r[6]; break;
    default: r = fr.r[7];
  }
  if (lane >= (jacobian ? r.nf * NL : r.nf)) return;
  if (jacobian)
    tet_facet_jacobian_lane<T>(r, lane);
  else
    tet_facet_residual_lane<T>(r, lane);
}

// ---------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void tet_residual_block(int64_t blk,
                                                   const TetIn<T>& ci,
                                                   const TetParams<T>& prm,
                                                   T* __restrict__ ru_e,
                                                   T* __restrict__ rp_e) {
  __shared__ TetTabs<T> tb;
  load_tabs(tb, ci.phi, ci.dphi, ci.qw, ci.nq);
  const int64_t c = blk * (int64_t)RES_CELLS + threadIdx.x;
  const bool active = c < ci.nc;
  T sv[NV][VERT];
  T h = T(1);
  if (active) {
#pragma unroll
    for (int v = 0; v < NV; ++v) load_vertex<T>(c * NV + v, ci, sv[v]);
    h = __ldg(ci.hcell + c);
  }
  __syncthreads();
  if (!active) return;
  TetState<T, T> s;
  read_state<T, T>(sv, h, s);
  T ru[NV][3], rp[NV];
  tet_body<T, T>(s, tb, prm, ci.nq, ru, rp);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int i = 0; i < 3; ++i) ru_e[(c * NV + v) * 3 + i] = ru[v][i];
    rp_e[c * NV + v] = rp[v];
  }
}

__device__ __forceinline__ int tet_column(int j, int k) {
  return k < 3 ? 3 * j + k : 12 + j;
}

template <typename T>
__device__ __forceinline__ void tet_jacobian_block(int64_t blk,
                                                   const TetIn<T>& ci,
                                                   const TetParams<T>& prm,
                                                   T* __restrict__ A) {
  using N = Dual<T, JAC_ND>;
  using V16 = typename Vec16<T>::type;
  __shared__ TetTabs<T> tb;
  __shared__ T s_vert[JAC_CELLS * NV][VERT];
  __shared__ __align__(16) T tile[JAC_CELLS * NL * NL];
  const int t = threadIdx.x;
  const int64_t c0 = blk * (int64_t)JAC_CELLS;
  const int64_t nc = ci.nc;
  load_tabs(tb, ci.phi, ci.dphi, ci.qw, ci.nq);
  if (c0 * NV + t < NV * nc)  // one (cell, vertex) slot a lane
    load_vertex<T>(c0 * NV + t, ci, s_vert[t]);
  const int cl = t / NV;
  const int j = t - cl * NV;
  const bool active = c0 + cl < nc;
  T h = T(1);
  if (active) h = __ldg(ci.hcell + c0 + cl);
  __syncthreads();
  if (active) {
    TetState<T, N> s;
    read_state<T, N>(s_vert + cl * NV, h, s);
#pragma unroll
    for (int k = 0; k < JAC_ND; ++k) {
      const int col = tet_column(j, k);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          s.ue[v][i].d[k] = col == 3 * v + i ? T(1) : T(0);
        s.pe[v].d[k] = col == 12 + v ? T(1) : T(0);
      }
    }
    N ru[NV][3], rp[NV];
    tet_body<T, N>(s, tb, prm, ci.nq, ru, rp);
#pragma unroll
    for (int k = 0; k < JAC_ND; ++k) {
      T* col = tile + cl * (NL * NL) + tet_column(j, k);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int i = 0; i < 3; ++i) col[(3 * v + i) * NL] = ru[v][i].d[k];
        col[(12 + v) * NL] = rp[v].d[k];
      }
    }
  }
  __syncthreads();
  // the block's cells are one contiguous run of A, 16-byte aligned
  const int64_t left = nc - c0;
  const int count = (int)(left < JAC_CELLS ? left : JAC_CELLS) * NL * NL;
  constexpr int PER = 16 / (int)sizeof(T);
  T* dst = A + c0 * (NL * NL);
  const int nvec = count / PER;
  for (int i = t; i < nvec; i += blockDim.x)
    reinterpret_cast<V16*>(dst)[i] = reinterpret_cast<const V16*>(tile)[i];
}

// the kernels, without facet blocks and with them (after the cells'
// blocks); each has a name of its own, so that a trace tells them apart
template <typename T>
__global__ void __launch_bounds__(RES_CELLS)
    ns_cell_residual_tet_kernel(const TetIn<T> ci, const TetParams<T> prm,
                                T* __restrict__ ru_e, T* __restrict__ rp_e) {
  tet_residual_block<T>(blockIdx.x, ci, prm, ru_e, rp_e);
}

template <typename T>
__global__ void __launch_bounds__(RES_CELLS)
    ns_cell_residual_tet_facet_kernel(const TetIn<T> ci,
                                      const TetParams<T> prm,
                                      T* __restrict__ ru_e,
                                      T* __restrict__ rp_e,
                                      const TetFacetRanges<T> fr,
                                      int64_t cell_blocks) {
  if (blockIdx.x >= cell_blocks) {
    tet_facet_block<T>(fr, blockIdx.x - cell_blocks, false);
    return;
  }
  tet_residual_block<T>(blockIdx.x, ci, prm, ru_e, rp_e);
}

template <typename T>
__global__ void __launch_bounds__(JAC_THREADS)
    ns_cell_jacobian_tet_kernel(const TetIn<T> ci, const TetParams<T> prm,
                                T* __restrict__ A) {
  tet_jacobian_block<T>(blockIdx.x, ci, prm, A);
}

template <typename T>
__global__ void __launch_bounds__(JAC_THREADS)
    ns_cell_jacobian_tet_facet_kernel(const TetIn<T> ci,
                                      const TetParams<T> prm,
                                      T* __restrict__ A,
                                      const TetFacetRanges<T> fr,
                                      int64_t cell_blocks) {
  if (blockIdx.x >= cell_blocks) {
    tet_facet_block<T>(fr, blockIdx.x - cell_blocks, true);
    return;
  }
  tet_jacobian_block<T>(blockIdx.x, ci, prm, A);
}

template <typename T>
int run(const void* const* cp, int64_t nc, int nq, const double* sc,
        void* out0, void* out1, int nfb, const void* const* fptr,
        const int64_t* fsize, const int* fopt, const double* fc,
        void* const* fout, int jacobian, cudaStream_t st) {
  const TetIn<T> ci{
      static_cast<const T*>(cp[0]), static_cast<const T*>(cp[1]),
      static_cast<const T*>(cp[2]), static_cast<const int*>(cp[3]),
      static_cast<const T*>(cp[4]), static_cast<const T*>(cp[5]),
      static_cast<const T*>(cp[6]), static_cast<const T*>(cp[7]),
      static_cast<const T*>(cp[8]), nc, nq};
  const TetParams<T> prm = tet_params<T>(sc);
  const int threads = jacobian ? JAC_THREADS : RES_CELLS;
  const int per = jacobian ? JAC_CELLS : RES_CELLS;
  const int64_t blocks = (nc + per - 1) / per;
  TetFacetRanges<T> fr;
  fr.n = nfb;
  int64_t b = 0;
  for (int k = 0; k < nfb; ++k) {
    fr.r[k] = facet_range<T>(cp[0], cp[1], cp[2], fptr + 10 * k,
                             fsize[2 * k], (int)fsize[2 * k + 1], fopt[2 * k],
                             fopt[2 * k + 1], fc[2 * k], fc[2 * k + 1],
                             fout[k]);
    fr.first[k] = b;
    const int64_t lanes = jacobian ? fr.r[k].nf * NL : fr.r[k].nf;
    b += (lanes + threads - 1) / threads;
  }
  fr.first[nfb] = b;
  const unsigned total = (unsigned)(blocks + b);
  T* o0 = static_cast<T*>(out0);
  T* o1 = static_cast<T*>(out1);
  if (nfb == 0) {
    if (jacobian)
      ns_cell_jacobian_tet_kernel<T><<<total, threads, 0, st>>>(ci, prm, o0);
    else
      ns_cell_residual_tet_kernel<T><<<total, threads, 0, st>>>(ci, prm, o0,
                                                                o1);
  } else if (jacobian) {
    ns_cell_jacobian_tet_facet_kernel<T>
        <<<total, threads, 0, st>>>(ci, prm, o0, fr, blocks);
  } else {
    ns_cell_residual_tet_facet_kernel<T>
        <<<total, threads, 0, st>>>(ci, prm, o0, o1, fr, blocks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The tetrahedral element kernel's entry point.
//   cp: the cells' pointers u (n, 3), u_prev, p, dofmap (nc, 4), coords
//       (nc, 4, 3), h, phi (nq, 4), dphi (nq, 4, 3), qw
//   sc: rho, mu, dt, f0, f1, f2, eps
//   out0, out1: ru_e (nc, 4, 3), rp_e (nc, 4) (residual) or A_cells (nc,
//       16, 16), null (jacobian = 1)
//   nfb facet blocks (at most MAXF), each K7 (term 0): fptr[10 k ..] its
//       dofmap_u, dofmap_p, coords, phi_u, dphi_u, phi_p, gdphi, normal,
//       dS, h; fsize[2 k ..] nf, nq; fopt[2 k ..] term, implicit; fc[2 k
//       ..] mu and an unused scalar; fout[k] its ru_f (nf, 4, 3) or A_f
//       (nf, 16, 16)
extern "C" int cfd_ns_element_tet(const void* const* cp, int64_t nc,
                                  int64_t nq, const double* sc, void* out0,
                                  void* out1, int nfb,
                                  const void* const* fptr,
                                  const int64_t* fsize, const int* fopt,
                                  const double* fc, void* const* fout,
                                  int jacobian, int is_f64, void* stream) {
  if (nq < 1 || nq > MAXQ || nfb < 0 || nfb > MAXF)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < nfb; ++k)
    if (fsize[2 * k] < 1 || fsize[2 * k + 1] < 1 ||
        fopt[2 * k] != TERM_NATURAL)
      return (int)cudaErrorInvalidValue;
  if (nc <= 0 && nfb == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return run<double>(cp, nc, (int)nq, sc, out0, out1, nfb, fptr, fsize,
                       fopt, fc, fout, jacobian, st);
  return run<float>(cp, nc, (int)nq, sc, out0, out1, nfb, fptr, fsize, fopt,
                    fc, fout, jacobian, st);
}
