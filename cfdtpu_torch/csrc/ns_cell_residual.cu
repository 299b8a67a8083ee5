// K3: the stabilized Navier-Stokes cell kernel, residual and Jacobian.
//
// Replaces the vmapped Crank-Nicolson-midpoint cell kernel of cfdtpu's
// forms/navier_stokes.py StabilizedNSForm (_make_cell_kernel), which
// serves residual() and, through jax.vmap(jax.jacfwd(.)),
// element_jacobians(): the Galerkin momentum and continuity terms plus
// SUPG, PSPG and LSIC, with tau taken from u_prev so that it stays
// frozen through the Newton linearisation. P1 triangles only (dim 2,
// degree 1, no Hessian term): velocity, pressure and geometry share
// one P1 basis and one dofmap.
//
// The physics is written once, in cell_body, a template on its number
// type N. ns_cell_residual_p1 runs it with N = T. ns_cell_jacobian_p1
// runs it with N = Dual<T, 3>: three lanes a cell, lane j carrying the
// tangents along u(j, 0), u(j, 1) and p(j), three columns of the (9, 9)
// block in cfdtpu's flat element layout [u(b, i) row-major, then p(b)].
// tau and tau_LSIC depend on u_prev alone and stay plain numbers.
//
// The residual: one lane a cell. At 70,095 cells that is 17 warps a
// multiprocessor in a single wave, so the kernel's time is the sum of
// its phases: the launch, two dependent round trips (the dofmap, then
// nine gathers through it, all in flight together), the arithmetic
// (bound by instruction issue: 863 operations a lane) and the stores.
// What the design does about the arithmetic:
//  - a P1 triangle is affine (dphi is the same at every point: the
//    host checks it once, CellTabs.create), so the geometry, the
//    physical gradients and everything that depends on them alone
//    (grad u, grad p, div u, the viscous stress) leave the point loop;
//  - the terms that meet grad v (stress, SUPG, LSIC, PSPG) are summed
//    over the points as a 2 x 2 and a 2-vector and contracted with the
//    gradients once, after the loop;
//  - per point no division is left: 1/h and 1/det are taken once a
//    cell, 1/dt, 4/dt^2, 1/rho and 1/(6 nu) on the host, tau is one
//    reciprocal square root, and in float32 |u_prev|, 1/h and 1/det
//    come from the special-function unit (2 ulp; float64 is exact).
// What it does not do: stage dofmap, coordinates and outputs through
// shared memory. Measured on an H100 (device time alone), a variant
// that loaded and stored one (cell, vertex) slot a lane at neighbouring
// addresses and exchanged them through shared memory took 5.6 us
// against 4.7 us for the strided accesses below (8-byte vectors, 12 and
// 24 bytes apart): the L1 absorbs the stride, a lane goes on as soon as
// its own loads are back instead of waiting at a barrier for its
// block's, and the staging's instructions cost more than the sectors it
// saves. Three lanes a cell sharing the points took 7.2 us (two waves
// of blocks instead of one).
// The guard max(2|u_prev|, eps) keeps tau finite at rest, as in cfdtpu.
// A lane sums its points in order: two calls are bitwise equal.
//
// The Jacobian writes 81 values a cell (23 MB at 70,095 cells): each
// block stages its 32 blocks of 81 in shared memory, a lane writing its
// three columns, and copies them out as one contiguous run of 16-byte
// stores. The three vertices of a cell are loaded once, one (cell,
// vertex) slot a lane, and shared by its lanes through shared memory.
// Three directions a lane share one evaluation of the values among
// three tangents: measured on an H100, 23.1 us alone against 32.1 us
// for one direction a lane on nine lanes a cell. Its arithmetic (the
// body three times a cell, value and three tangents) takes about as
// long as its bytes.
//
// The facet blocks ride in the same launch. The form's
// natural-correction term (K7, ns_facet.cuh) alone was a launch of its
// own, 2.6-2.9 us of device time for 0.07-0.14 us of bytes (H100 80GB
// HBM3, 700 W), once a residual and once a Jacobian build. The _facet
// kernels below run the cell blocks as above and, after them, each
// facet block of the form (up to MAXF: K7, K12, K13, K16, K17 or K18,
// ns_facet.cuh) as a range of blocks at the cells' block size: one lane
// a facet (residual) or a (facet, column) (Jacobian), which read
// nothing the cell blocks stage and write the block's own output (ru_f,
// A_f). One launch then covers a form's residual and one its Jacobian
// build, whatever its facet blocks; their few lanes run beside the
// cells' single wave. Each _facet kernel is compiled for a set of terms
// (ns_facet.cuh: K7 alone, the outlet terms K7, K12 and K13, or all),
// and a launch takes the smallest set that holds its blocks' terms: the
// BDF2 Jacobian with K7 in its launch took 27.1-27.5 us alone in a
// kernel with all eight bodies, 22.4-22.7 us with K7's alone (H100 80GB
// HBM3, 700 W).
//
// K14, the BDF2 cell body (cfdtpu's StabilizedNSFormBDF2), is the same
// body instantiated with FORM = FORM_BDF2: the time term (a0 u + a1
// u_prev + a2 u_prev2) / dt, convection, stress and continuity at u
// itself instead of the midpoint, tau still from |u_prev|; each lane
// reads the second previous velocity too (the _bdf2 kernels). Its
// operation count is K3's within a few: the midpoint's averages go, the
// time term's two products come.
//
// K15, the curl-curl (rotational) cell body (cfdtpu's
// StabilizedNSFormCurlCurl), is the body with FORM = FORM_CURL, at the
// midpoint as K3: the viscous term mu omega(u_mid) rot(v), omega = d
// u_y / dx - d u_x / dy, which is the antisymmetric 2 x 2 [[0, -mu
// omega], [mu omega, 0]] against grad v, in place of K3's stress; the
// Lamb-form convection rho (curl u_mid x u_mid) = rho omega (-u_mid,y,
// u_mid,x) in place of (grad u_mid) u_mid, in the Galerkin inertia and
// in the strong residual R alike; and -(p + rho/2 |u_mid|^2) div v on
// the diagonal. SUPG, PSPG, LSIC and tau are K3's (the _curl kernels).
// The template keeps K3's and K14's instantiations as they were: every
// difference is an `if constexpr` on FORM. Its operations: 156 a cell
// outside the loop (K3's 161, the stress's 8 replaced by omega and mu
// omega, 3) and 118 a point (K3's 117, the convection's 8 replaced by
// the cross product's 4, and |u_mid|^2 rho / 2 on the diagonal, 5).
//
// Operations of K3, counted from this file with each add, multiply, min, max,
// reciprocal and reciprocal square root as one (chip_smoke.py holds the
// same numbers): the residual, 161 a cell outside the loop (geometry
// 49, gradients 71, 1/h and the t3 term 5, the contraction 36) and 117
// a point. The Jacobian needs these values once a cell and, for each of
// a cell's three lanes, the tangent work that is not structurally zero
// (of the three tangents of u at a point only one is ever non-zero, p
// has none along u, and so on down the body): 117 outside the loop
// (gradients 18, the contraction 99) and 148 a point (u, p at the point
// 5, the strong residual and inertia 34, the isotropic part 3, S 56, P
// 12, continuity 2, the sums over the test functions 36). The dual
// numbers as written do more: every lane takes the values again and
// every tangent in full (4 operations for a sum of duals or a dual
// times a plain number, 10 for a product of duals), 398 outside the
// loop and 405 a point, and the compiler removes what it can prove zero.

#include <cstdint>

#include "element.cuh"
#include "ns_facet.cuh"

namespace {

constexpr int MAXQ = 16;        // quadrature points held in shared memory
constexpr int RES_CELLS = 128;  // residual: cells (lanes) a block
constexpr int JAC_CELLS = 32;   // Jacobian: cells a block, 3 lanes each
// facet blocks a launch carries: with FacetRange<double> 152 bytes (13
// pointers, nf, nq, term, implicit and the two scalars), the ranges, their
// nine offsets and their count are 1,296 bytes of the 4 KB of kernel
// parameters, CellIn and CellParams 216 more
constexpr int MAXF = 8;

// the cell bodies: Crank-Nicolson midpoint (K3), BDF2 (K14), curl-curl
// at the midpoint (K15)
constexpr int FORM_MID = 0;
constexpr int FORM_BDF2 = 1;
constexpr int FORM_CURL = 2;

template <typename T>
struct CellParams {
  T rho, irho, mu, idt, f0, f1, eps;
  T a2sq;        // (2 / dt)^2 = t2^-2
  T nu4;         // 4 nu: t3^-1 = 4 nu / h^2
  T inv6nu;      // Re_h / 3 = |u| h / (6 nu)
  T a0, a1, a2;  // BDF2: the time term's coefficients
};

template <typename T>
CellParams<T> make_params(double rho, double mu, double dt, double f0,
                          double f1, double eps, double a0, double a1,
                          double a2) {
  CellParams<T> q;
  q.rho = (T)rho;
  q.irho = (T)(1.0 / rho);
  q.mu = (T)mu;
  q.idt = (T)(1.0 / dt);
  q.f0 = (T)f0;
  q.f1 = (T)f1;
  q.eps = (T)eps;
  q.a2sq = (T)(4.0 / (dt * dt));
  q.nu4 = (T)(4.0 * mu / rho);
  q.inv6nu = (T)(rho / (6.0 * mu));
  q.a0 = (T)a0;
  q.a1 = (T)a1;
  q.a2 = (T)a2;
  return q;
}

__device__ __forceinline__ float inv_sqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double inv_sqrt(double x) { return 1.0 / sqrt(x); }
// |v| of a 2-vector from its square s: in float32 by the
// special-function unit (2 ulp; exact at s = 0), in float64 exactly
__device__ __forceinline__ float norm_of(float s) {
  return s * rsqrtf(fmaxf(s, 1e-30f));
}
__device__ __forceinline__ double norm_of(double s) { return sqrt(s); }

// the reference tabulations, copied to shared memory by each block
template <typename T>
struct Tabs {
  T phi[MAXQ * 3];
  T dphi[MAXQ * 6];
  T qw[MAXQ];
};

template <typename T>
__device__ __forceinline__ void load_tabs(Tabs<T>& tb, const T* phi,
                                          const T* dphi, const T* qw,
                                          int nq) {
  for (int i = threadIdx.x; i < nq * 6; i += blockDim.x) {
    tb.dphi[i] = __ldg(dphi + i);
    if (i < nq * 3) tb.phi[i] = __ldg(phi + i);
    if (i < nq) tb.qw[i] = __ldg(qw + i);
  }
}

// the cells' arguments, as the C entry points pass them
template <typename T>
struct CellIn {
  const T* __restrict__ u;
  const T* __restrict__ uprev;
  const T* __restrict__ uprev2;  // BDF2 only
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

// one vertex of one cell as a lane loads it: u, u_prev, p, X and, for
// BDF2, u_prev2
template <int FORM>
struct Vert {
  static constexpr int value = FORM == FORM_BDF2 ? 9 : 7;
};

template <typename T, int FORM>
__device__ __forceinline__ void load_vertex(int64_t lane, const CellIn<T>& ci,
                                            T* sv) {
  using V2 = typename Vec2<T>::type;
  const int64_t n = __ldg(ci.dofmap + lane);
  const V2 x = __ldg(reinterpret_cast<const V2*>(ci.coords) + lane);
  const V2 a = __ldg(reinterpret_cast<const V2*>(ci.u) + n);
  const V2 b = __ldg(reinterpret_cast<const V2*>(ci.uprev) + n);
  const T c = __ldg(ci.p + n);
  sv[0] = a.x;
  sv[1] = a.y;
  sv[2] = b.x;
  sv[3] = b.y;
  sv[4] = c;
  sv[5] = x.x;
  sv[6] = x.y;
  if constexpr (FORM == FORM_BDF2) {
    const V2 e = __ldg(reinterpret_cast<const V2*>(ci.uprev2) + n);
    sv[7] = e.x;
    sv[8] = e.y;
  }
}

template <typename T, typename N>
struct CellState {
  N ue[3][2];
  N pe[3];
  T upe[3][2];
  T up2e[3][2];  // BDF2 only
  T X[3][2];
  T h;
};

template <typename T, typename N, int FORM>
__device__ __forceinline__ void read_state(
    const T (*sv)[Vert<FORM>::value], T h, CellState<T, N>& s) {
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    s.ue[v][0] = Lift<N>::of(sv[v][0]);
    s.ue[v][1] = Lift<N>::of(sv[v][1]);
    s.upe[v][0] = sv[v][2];
    s.upe[v][1] = sv[v][3];
    s.pe[v] = Lift<N>::of(sv[v][4]);
    s.X[v][0] = sv[v][5];
    s.X[v][1] = sv[v][6];
    if constexpr (FORM == FORM_BDF2) {
      s.up2e[v][0] = sv[v][7];
      s.up2e[v][1] = sv[v][8];
    }
  }
  s.h = h;
}

// what depends on the physical gradients and the cell's dofs alone
template <typename N>
struct Grads {
  N gum[2][2];  // grad of the scheme's velocity, [i][g] = d u_i / d x_g
  N c[2];       // grad p - rho f
  N div;
  N sv[2][2];  // viscous stress mu (grad u + grad u^T); curl-curl: the
               // viscous term against grad v, [[0, -mu om], [mu om, 0]]
  N om;        // curl-curl: omega = d u_y / dx - d u_x / dy
};

// the scheme's velocity: the midpoint (u + u_prev) / 2, or (BDF2) u
template <typename T, typename N, int FORM>
__device__ __forceinline__ void gradients(const Geom<T>& g,
                                          const CellState<T, N>& s,
                                          const CellParams<T>& prm,
                                          Grads<N>& G) {
  const T f[2] = {prm.f0, prm.f1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const N gu = s.ue[0][i] * g.gu[0][a] + s.ue[1][i] * g.gu[1][a] +
                   s.ue[2][i] * g.gu[2][a];
      if constexpr (FORM == FORM_BDF2) {
        G.gum[i][a] = gu;
      } else {
        const T gup = s.upe[0][i] * g.gu[0][a] + s.upe[1][i] * g.gu[1][a] +
                      s.upe[2][i] * g.gu[2][a];
        G.gum[i][a] = T(0.5) * (gu + gup);
      }
    }
    G.c[i] = (s.pe[0] * g.gu[0][i] + s.pe[1] * g.gu[1][i] +
              s.pe[2] * g.gu[2][i]) -
             prm.rho * f[i];
  }
  G.div = G.gum[0][0] + G.gum[1][1];
  if constexpr (FORM == FORM_CURL) {
    // mu omega rot(v): rot(phi_b e_0) = -d phi_b / dy, rot(phi_b e_1) =
    // d phi_b / dx
    G.om = G.gum[1][0] - G.gum[0][1];
    const N muom = prm.mu * G.om;
    G.sv[0][0] = G.sv[1][1] = Lift<N>::of(T(0));
    G.sv[0][1] = muom * T(-1);
    G.sv[1][0] = muom;
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        G.sv[i][j] = prm.mu * (G.gum[i][j] + G.gum[j][i]);
  }
}

// What the points leave to contract with the physical gradients:
//   ru[b][i] += sum_j S[i][j] gu[b][j],  rp[b] += sum_i P[i] gu[b][i]
// with S = sum_q w (sigma + tau_lsic rho div(u) I + tau R (x) u_mid) and
// P = sum_q w tau / rho R. gu is the same at every point, so the
// contraction is taken once, after the loop.
template <typename T, typename N>
__device__ __forceinline__ void contract(const Geom<T>& g,
                                         const N (&S)[2][2],
                                         const N (&P)[2], N (&ru)[3][2],
                                         N (&rp)[3]) {
#pragma unroll
  for (int b = 0; b < 3; ++b) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ru[b][i] = ru[b][i] + (S[i][0] * g.gu[b][0] + S[i][1] * g.gu[b][1]);
    rp[b] = rp[b] + (P[0] * g.gu[b][0] + P[1] * g.gu[b][1]);
  }
}

// The cell residual ru[b][i], rp[b] as _make_cell_kernel computes it
// (BDF2: as StabilizedNSFormBDF2's does; curl-curl: as
// StabilizedNSFormCurlCurl's).
template <typename T, typename N, int FORM>
__device__ __forceinline__ void cell_body(const CellState<T, N>& s,
                                          const Tabs<T>& tb,
                                          const CellParams<T>& prm, int nq,
                                          N (&ru)[3][2], N (&rp)[3]) {
  const N zero = Lift<N>::of(T(0));
  N S[2][2], P[2];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    ru[b][0] = zero;
    ru[b][1] = zero;
    rp[b] = zero;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    S[i][0] = zero;
    S[i][1] = zero;
    P[i] = zero;
  }
  const T f[2] = {prm.f0, prm.f1};
  const T ih = recip(s.h);
  const T a3 = prm.nu4 * ih * ih;
  const T a23sq = a3 * a3 + prm.a2sq;  // t2^-2 + t3^-2
  Geom<T> g;
  Grads<N> G;
  p1_geometry(s.X, tb.dphi, tb.dphi, g);
  gradients<T, N, FORM>(g, s, prm, G);
  for (int q = 0; q < nq; ++q) {
    const T* ph = tb.phi + q * 3;
    const T w = tb.qw[q] * g.adet;

    N uq[2], umq[2], dudt[2];
    T upq[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uq[i] = s.ue[0][i] * ph[0] + s.ue[1][i] * ph[1] + s.ue[2][i] * ph[2];
      upq[i] =
          s.upe[0][i] * ph[0] + s.upe[1][i] * ph[1] + s.upe[2][i] * ph[2];
      if constexpr (FORM == FORM_BDF2) {
        const T up2q = s.up2e[0][i] * ph[0] + s.up2e[1][i] * ph[1] +
                       s.up2e[2][i] * ph[2];
        umq[i] = uq[i];
        dudt[i] = (prm.a0 * uq[i] + (prm.a1 * upq[i] + prm.a2 * up2q)) *
                  prm.idt;
      } else {
        umq[i] = T(0.5) * (uq[i] + upq[i]);
        dudt[i] = (uq[i] - upq[i]) * prm.idt;
      }
    }
    const N pq = s.pe[0] * ph[0] + s.pe[1] * ph[1] + s.pe[2] * ph[2];

    // tau_SUPG = (t1^-2 + t2^-2 + t3^-2)^(-1/2) and tau_LSIC, at u_prev
    const T vn = norm_of(upq[0] * upq[0] + upq[1] * upq[1]);
    const T a1 = fmax(T(2) * vn, prm.eps) * ih;  // t1^-1
    const T tau = inv_sqrt(a1 * a1 + a23sq);
    const T vh = vn * s.h;
    const T tau_lsic = T(0.5) * vh * fmin(vh * prm.inv6nu, T(1));

    // strong residual R and the Galerkin inertia and force
    N tR[2], wm[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      N acc;
      if constexpr (FORM == FORM_CURL) {
        // curl u x u = omega (-u_y, u_x)
        acc = dudt[i] + (i == 0 ? (G.om * umq[1]) * T(-1) : G.om * umq[0]);
      } else {
        acc = dudt[i] + (G.gum[i][0] * umq[0] + G.gum[i][1] * umq[1]);
      }
      tR[i] = tau * (prm.rho * acc + G.c[i]);
      wm[i] = w * (prm.rho * (acc - f[i]));
    }
    // stress and LSIC on the diagonal, SUPG: all meet grad v
    N iso = (tau_lsic * prm.rho) * G.div - pq;
    if constexpr (FORM == FORM_CURL)  // -rho/2 |u_mid|^2 div v
      iso = iso - (T(0.5) * prm.rho) * (umq[0] * umq[0] + umq[1] * umq[1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const N sij = i == j ? G.sv[i][j] + iso : G.sv[i][j];
        S[i][j] = S[i][j] + w * (sij + tR[i] * umq[j]);
      }
      P[i] = P[i] + (w * prm.irho) * tR[i];  // PSPG
    }
    const N wd = w * G.div;  // continuity
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      ru[b][0] = ru[b][0] + wm[0] * ph[b];
      ru[b][1] = ru[b][1] + wm[1] * ph[b];
      rp[b] = rp[b] + wd * ph[b];
    }
  }
  contract(g, S, P, ru, rp);
}

// a form's facet blocks that ride in the element kernel's launch:
// range k takes blocks first[k] .. first[k + 1] - 1 after the cells'
template <typename T>
struct FacetRanges {
  FacetRange<T> r[MAXF];
  int64_t first[MAXF + 1];
  int n;
};

// the lanes of facet block `b` (counted after the cells' blocks), whose
// terms are in MASK
template <typename T, unsigned MASK>
__device__ __forceinline__ void facet_block(const FacetRanges<T>& fr,
                                            int64_t b, bool jacobian) {
  int k = 0;
#pragma unroll
  for (int i = 1; i < MAXF; ++i)
    if (i < fr.n && b >= fr.first[i]) k = i;
  const int64_t lane = (b - fr.first[k]) * blockDim.x + threadIdx.x;
  // the range is copied out of parameter space by constant indices
  // into registers, and one facet_lane runs it: one inlined copy of the
  // terms' bodies, not one a range (`nvcc -Xptxas -v`, sm_90a: with a
  // facet_lane a case and all eight terms, the float64 K3 Jacobian with
  // its blocks spilled 192 bytes a lane and its residual 48; with the
  // copy 48 and none, as with four ranges and three terms)
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
  facet_lane<T, MASK>(r, lane, jacobian);
}

// Residual: one lane a cell, RES_CELLS cells a block; block blk of the
// cell range
template <typename T, int FORM>
__device__ __forceinline__ void cell_residual_block(
    int64_t blk, const CellIn<T>& ci, const CellParams<T>& prm,
    T* __restrict__ ru_e, T* __restrict__ rp_e) {
  using V2 = typename Vec2<T>::type;
  constexpr int VERT = Vert<FORM>::value;
  const int64_t nc = ci.nc;
  const int nq = ci.nq;
  __shared__ Tabs<T> tb;
  load_tabs(tb, ci.phi, ci.dphi, ci.qw, nq);
  const int64_t c = blk * (int64_t)RES_CELLS + threadIdx.x;
  const bool active = c < nc;
  T sv[3][VERT];
  T h = T(1);
  if (active) {
#pragma unroll
    for (int v = 0; v < 3; ++v) load_vertex<T, FORM>(c * 3 + v, ci, sv[v]);
    h = __ldg(ci.hcell + c);
  }
  __syncthreads();
  if (!active) return;
  CellState<T, T> s;
  read_state<T, T, FORM>(sv, h, s);
  T ru[3][2], rp[3];
  cell_body<T, T, FORM>(s, tb, prm, nq, ru, rp);
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    V2 o;
    o.x = ru[v][0];
    o.y = ru[v][1];
    reinterpret_cast<V2*>(ru_e)[c * 3 + v] = o;
    rp_e[c * 3 + v] = rp[v];
  }
}

// Jacobian: three lanes a cell, lane j differentiating along the three
// dofs of trial vertex j: columns u(j, 0), u(j, 1) and p(j)
constexpr int JAC_ND = 3;               // tangent directions a lane
constexpr int JAC_LPC = NLOC / JAC_ND;  // lanes a cell
constexpr int JAC_THREADS = JAC_CELLS * JAC_LPC;

__device__ __forceinline__ int jac_column(int j, int k) {
  return k < 2 ? 2 * j + k : 6 + j;
}

template <typename T, int FORM>
__device__ __forceinline__ void cell_jacobian_block(int64_t blk,
                                                    const CellIn<T>& ci,
                                                    const CellParams<T>& prm,
                                                    T* __restrict__ A) {
  using N = Dual<T, JAC_ND>;
  using V16 = typename Vec16<T>::type;
  constexpr int VERT = Vert<FORM>::value;
  const int64_t nc = ci.nc;
  const int nq = ci.nq;
  __shared__ Tabs<T> tb;
  __shared__ T s_vert[JAC_CELLS * 3][VERT];
  __shared__ __align__(16) T tile[JAC_CELLS * NLOC * NLOC];
  const int t = threadIdx.x;
  const int64_t c0 = blk * (int64_t)JAC_CELLS;
  load_tabs(tb, ci.phi, ci.dphi, ci.qw, nq);
  if (c0 * 3 + t < 3 * nc)  // one (cell, vertex) slot a lane
    load_vertex<T, FORM>(c0 * 3 + t, ci, s_vert[t]);
  const int cl = t / JAC_LPC;
  const int j = t - cl * JAC_LPC;
  const bool active = c0 + cl < nc;
  T h = T(1);
  if (active) h = __ldg(ci.hcell + c0 + cl);
  __syncthreads();
  if (active) {
    CellState<T, N> s;
    read_state<T, N, FORM>(s_vert + cl * 3, h, s);
#pragma unroll
    for (int k = 0; k < JAC_ND; ++k) {
      const int c = jac_column(j, k);
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        s.ue[v][0].d[k] = c == 2 * v ? T(1) : T(0);
        s.ue[v][1].d[k] = c == 2 * v + 1 ? T(1) : T(0);
        s.pe[v].d[k] = c == 6 + v ? T(1) : T(0);
      }
    }
    N ru[3][2], rp[3];
    cell_body<T, N, FORM>(s, tb, prm, nq, ru, rp);
#pragma unroll
    for (int k = 0; k < JAC_ND; ++k) {
      T* col = tile + cl * (NLOC * NLOC) + jac_column(j, k);
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        col[(v * 2) * NLOC] = ru[v][0].d[k];
        col[(v * 2 + 1) * NLOC] = ru[v][1].d[k];
        col[(6 + v) * NLOC] = rp[v].d[k];
      }
    }
  }
  __syncthreads();
  // the block's cells are one contiguous run of A; 32 cells of 81
  // values keep each block's run 16-byte aligned
  const int64_t left = nc - c0;
  const int count = (int)(left < JAC_CELLS ? left : JAC_CELLS) * NLOC * NLOC;
  constexpr int PER = 16 / (int)sizeof(T);
  T* dst = A + c0 * (NLOC * NLOC);
  const int nvec = count / PER;
  for (int i = t; i < nvec; i += blockDim.x)
    reinterpret_cast<V16*>(dst)[i] = reinterpret_cast<const V16*>(tile)[i];
  for (int i = nvec * PER + t; i < count; i += blockDim.x) dst[i] = tile[i];
}

// The kernels: the residual and the Jacobian, Crank-Nicolson (K3),
// BDF2 (K14) and curl-curl (K15), without facet blocks and with them
// (after the cell blocks; for a set of terms, MASK). Each has a name of
// its own, so that a trace tells them apart.
#define CELL_KERNELS(NAME, FORM)                                             \
  template <typename T>                                                      \
  __global__ void __launch_bounds__(RES_CELLS)                               \
      ns_cell_residual_##NAME##_kernel(const CellIn<T> ci,                   \
                                       const CellParams<T> prm,              \
                                       T* __restrict__ ru_e,                 \
                                       T* __restrict__ rp_e) {               \
    cell_residual_block<T, FORM>(blockIdx.x, ci, prm, ru_e, rp_e);           \
  }                                                                          \
  template <typename T, unsigned MASK>                                      \
  __global__ void __launch_bounds__(RES_CELLS)                               \
      ns_cell_residual_##NAME##_facet_kernel(                                \
          const CellIn<T> ci, const CellParams<T> prm, T* __restrict__ ru_e, \
          T* __restrict__ rp_e, const FacetRanges<T> fr,                     \
          int64_t cell_blocks) {                                             \
    if (blockIdx.x >= cell_blocks) {                                         \
      facet_block<T, MASK>(fr, blockIdx.x - cell_blocks, false);             \
      return;                                                                \
    }                                                                        \
    cell_residual_block<T, FORM>(blockIdx.x, ci, prm, ru_e, rp_e);           \
  }                                                                          \
  template <typename T>                                                      \
  __global__ void __launch_bounds__(JAC_THREADS)                             \
      ns_cell_jacobian_##NAME##_kernel(const CellIn<T> ci,                   \
                                       const CellParams<T> prm,              \
                                       T* __restrict__ A) {                  \
    cell_jacobian_block<T, FORM>(blockIdx.x, ci, prm, A);                    \
  }                                                                          \
  template <typename T, unsigned MASK>                                      \
  __global__ void __launch_bounds__(JAC_THREADS)                             \
      ns_cell_jacobian_##NAME##_facet_kernel(                                \
          const CellIn<T> ci, const CellParams<T> prm, T* __restrict__ A,    \
          const FacetRanges<T> fr, int64_t cell_blocks) {                    \
    if (blockIdx.x >= cell_blocks) {                                         \
      facet_block<T, MASK>(fr, blockIdx.x - cell_blocks, true);              \
      return;                                                                \
    }                                                                        \
    cell_jacobian_block<T, FORM>(blockIdx.x, ci, prm, A);                    \
  }

CELL_KERNELS(p1, FORM_MID)
CELL_KERNELS(bdf2_p1, FORM_BDF2)
CELL_KERNELS(curl_p1, FORM_CURL)

// the facet ranges' block offsets at `threads` lanes a block
template <typename T>
int64_t place_ranges(FacetRanges<T>& fr, bool jacobian, int threads) {
  int64_t b = 0;
  for (int k = 0; k < fr.n; ++k) {
    fr.first[k] = b;
    const int64_t lanes = jacobian ? fr.r[k].nf * NLOC : fr.r[k].nf;
    b += (lanes + threads - 1) / threads;
  }
  fr.first[fr.n] = b;
  return b;
}

template <typename T>
int launch(const CellIn<T>& ci, const CellParams<T>& prm, int form,
           void* out0, void* out1, FacetRanges<T>& fr, bool jacobian,
           cudaStream_t st) {
  T* o0 = static_cast<T*>(out0);
  T* o1 = static_cast<T*>(out1);
  const int threads = jacobian ? JAC_THREADS : RES_CELLS;
  const int per = jacobian ? JAC_CELLS : RES_CELLS;
  const int64_t blocks = (ci.nc + per - 1) / per;
  const unsigned total =
      (unsigned)(blocks + (fr.n > 0 ? place_ranges(fr, jacobian, threads)
                                    : 0));
  unsigned used = 0;  // the blocks' terms
  for (int k = 0; k < fr.n; ++k) used |= term_bit(fr.r[k].term);
#define CELL_LAUNCH(NAME)                                                   \
  if (jacobian)                                                             \
    ns_cell_jacobian_##NAME##_kernel<T><<<total, threads, 0, st>>>(ci, prm,  \
                                                                   o0);     \
  else                                                                      \
    ns_cell_residual_##NAME##_kernel<T><<<total, threads, 0, st>>>(         \
        ci, prm, o0, o1);
#define FACET_LAUNCH(NAME, MASK)                                            \
  if (jacobian)                                                             \
    ns_cell_jacobian_##NAME##_facet_kernel<T, MASK>                         \
        <<<total, threads, 0, st>>>(ci, prm, o0, fr, blocks);               \
  else                                                                      \
    ns_cell_residual_##NAME##_facet_kernel<T, MASK>                         \
        <<<total, threads, 0, st>>>(ci, prm, o0, o1, fr, blocks);
  // the term sets: K7 alone (paths A and F), K7, K12 and K13 (DFG
  // 2D-1's outlets; K3 only) and all of them
  const bool k7 = (used & ~TERMS_K7) == 0;
  const bool outlet = (used & ~TERMS_OUTLET) == 0;
  if (fr.n == 0) {
    if (form == FORM_BDF2) {
      CELL_LAUNCH(bdf2_p1)
    } else if (form == FORM_CURL) {
      CELL_LAUNCH(curl_p1)
    } else {
      CELL_LAUNCH(p1)
    }
  } else if (form == FORM_BDF2) {
    if (k7) {
      FACET_LAUNCH(bdf2_p1, TERMS_K7)
    } else {
      FACET_LAUNCH(bdf2_p1, TERMS_ALL)
    }
  } else if (form == FORM_CURL) {
    FACET_LAUNCH(curl_p1, TERMS_ALL)
  } else if (k7) {
    FACET_LAUNCH(p1, TERMS_K7)
  } else if (outlet) {
    FACET_LAUNCH(p1, TERMS_OUTLET)
  } else {
    FACET_LAUNCH(p1, TERMS_ALL)
  }
#undef FACET_LAUNCH
#undef CELL_LAUNCH
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* const* cp, int64_t nc, int nq, const double* sc,
        int form, void* out0, void* out1, int nfb, const void* const* fptr,
        const int64_t* fsize, const int* fopt, const double* fc,
        void* const* fout, int jacobian, cudaStream_t st) {
  const CellIn<T> ci{
      static_cast<const T*>(cp[0]), static_cast<const T*>(cp[1]),
      static_cast<const T*>(cp[2]), static_cast<const T*>(cp[3]),
      static_cast<const int*>(cp[4]), static_cast<const T*>(cp[5]),
      static_cast<const T*>(cp[6]), static_cast<const T*>(cp[7]),
      static_cast<const T*>(cp[8]), static_cast<const T*>(cp[9]), nc, nq};
  const CellParams<T> prm =
      make_params<T>(sc[0], sc[1], sc[2], sc[3], sc[4], sc[5], sc[6], sc[7],
                     sc[8]);
  FacetRanges<T> fr;
  fr.n = nfb;
  for (int k = 0; k < nfb; ++k)
    fr.r[k] = facet_range<T>(cp[0], cp[1], cp[3], fptr + 10 * k,
                             fsize[2 * k], (int)fsize[2 * k + 1],
                             fopt[2 * k], fopt[2 * k + 1], fc[2 * k],
                             fc[2 * k + 1], fout[k]);
  return launch<T>(ci, prm, form, out0, out1, fr, jacobian != 0, st);
}

}  // namespace

// The element kernels' one entry point.
//   cp: the cells' pointers u, u_prev, u_prev2 (BDF2; else unused), p,
//       dofmap, coords, h, phi, dphi, qw
//   sc: rho, mu, dt, f0, f1, eps, a0, a1, a2 (BDF2's coefficients)
//   form: 0 the Crank-Nicolson body (K3), 1 the BDF2 body (K14), 2 the
//       curl-curl body (K15)
//   out0, out1: ru_e, rp_e (residual) or A_cells, null (jacobian = 1)
//   nfb facet blocks (at most MAXF), each: fptr[10 k ..] its dofmap_u,
//       dofmap_p, coords, phi_u, dphi_u, phi_p, gdphi, normal, dS, h;
//       fsize[2 k ..] nf, nq; fopt[2 k ..] term, implicit; fc[2 k ..]
//       its scalars c, c2 (ns_facet.cuh); fout[k] its ru_f or A_f
extern "C" int cfd_ns_element_p1(const void* const* cp, int64_t nc,
                                 int64_t nq, const double* sc, int form,
                                 void* out0, void* out1, int nfb,
                                 const void* const* fptr,
                                 const int64_t* fsize, const int* fopt,
                                 const double* fc, void* const* fout,
                                 int jacobian, int is_f64, void* stream) {
  if (nq < 1 || nq > MAXQ || nfb < 0 || nfb > MAXF || form < FORM_MID ||
      form > FORM_CURL)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < nfb; ++k)
    if (fsize[2 * k] < 1 || fsize[2 * k + 1] < 1 || fopt[2 * k] < 0 ||
        fopt[2 * k] >= NTERMS)
      return (int)cudaErrorInvalidValue;
  if (nc <= 0 && nfb == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return run<double>(cp, nc, (int)nq, sc, form, out0, out1, nfb, fptr,
                       fsize, fopt, fc, fout, jacobian, st);
  return run<float>(cp, nc, (int)nq, sc, form, out0, out1, nfb, fptr, fsize,
                    fopt, fc, fout, jacobian, st);
}
