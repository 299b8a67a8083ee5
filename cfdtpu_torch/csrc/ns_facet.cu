// The facet-term kernels, residual and Jacobian, each launched alone:
//
//  K7  ns_facet_natural_p1: the natural correction,
//        r_u[b][i] = sum_q dS phi_u[b] (p n_i - mu sum_j d(uv)_j/dx_i n_j)
//      (cfdtpu's forms/facet_terms.py natural_correction);
//  K12 ns_facet_viscous_p1: the outlet viscous traction,
//        r_u[b][i] = sign sum_q dS phi_u[b] (2 mu eps(uv) n)_i
//      (viscous_traction);
//  K13 ns_facet_backflow_p1: the backflow stabilisation,
//        r_u[b][i] = -beta rho sum_q dS phi_u[b] (u_prev.n)_- uv_i,
//      (a)_- = (a - |a|) / 2 taken at u_prev (backflow);
//  K16 ns_facet_weakp_p1: the weak pressure,
//        r_u[b][i] = c sum_q dS phi_u[b] n_i, c = scale pbar
//      (weak_pressure); it reads no state, so its Jacobian is zero;
//  K17 ns_facet_nitsche_p1 and ns_facet_nitsche_curl_p1: symmetric
//      Nitsche enforcement of u_T = 0,
//        -(2 mu eps(uv) n).v_T - (2 mu eps(v) n).u_T + (beta mu / h) u_T.v_T
//      (nitsche_tangential) and, in the curl form,
//        -mu (curl uv x n).v_T - mu (curl v x n).u_T + (beta mu / h) u_T.v_T
//      (nitsche_tangential_curl), h the size of the cell behind the
//      facet; one body, the form a template flag;
//  K18 ns_facet_cbc_p1 and ns_facet_ddn_p1: the convective outlet
//        r_u[b][i] = -1/2 sum_q dS phi_u[b] (u_prev.n) uv_i
//      (cbc) and the directional do-nothing outlet, K13's body with
//      -1/2 in place of -beta rho: min(a, 0) = (a - |a|) / 2 exactly in
//      floating point (directional_do_nothing),
//
// on the P1 triangle behind each facet, at the term's velocity uv: the
// Crank-Nicolson midpoint (u + u_prev) / 2, or u itself (`implicit`,
// the BDF2 solver's). They replace the vmapped facet kernels of cfdtpu,
// as StabilizedNSForm maps them over a facet block in _block_residual
// and, through jax.vmap(jax.jacfwd(_flat_facet_kernel(.))), in
// element_jacobians. The dofmap gathers of u, u_prev and p are fused,
// as in K3.
//
// Each body is a template on its number type, like K3's: the residual
// runs it on plain numbers, one lane a facet; the Jacobian on Dual<T,
// 1>, nine lanes a facet, lane j writing column j of the (9, 9) block
// in the flat element layout [u(b, i) row-major, then p(b)], whose three
// pressure rows are zero. K13's and K18's kink is in u_prev, a constant
// of the derivative, so no dual meets |.|. Every term is linear in u
// and p.
//
// Bound: launch latency. A mesh of 70,095 cells has 755 boundary
// facets, the DFG 2D-1 outlet at res 0.0025 has 55 and the DFG inlet
// and outlet at res_scale 0.3 120 and 43; a kernel moves
// 0.01-0.35 MB and runs in the time of an empty launch. So the form
// does not launch them: the bodies live in ns_facet.cuh, and the
// element kernel's launch runs each facet block as a range of blocks
// after the cells' (csrc/ns_cell_residual.cu). The kernels here are the
// terms' own entry points, which the reaction force of
// scenarios/dfg_1.py and the kernel phase of chip_smoke.py call.
//
// Operations, counted from ns_facet.cuh with each add, multiply, abs
// and reciprocal as one (chip_smoke.py holds the same numbers): per
// facet 12 (the midpoint, 2 a dof; none when implicit), per point K7
// 103 (counted with K3's), K12 93 and K13 45 (K12: the geometry 46, the
// gradient 20, the term 12, the sums over the test functions 15; K13:
// (u_prev.n)_- 18, the term 12, the sums 15), K16 17 (the term 2, the
// sums 15), K17 170 in the sigma form (the geometry 46, the gradient
// 20, u and u_T at the point 17, the stress and its tangential part 15,
// the consistency and penalty 8, the symmetry 49, the sums 15) and 136
// in the curl form (the geometry 46, the gradient 20, u and u_T 17,
// curl u x n and its tangential part 6, the consistency and penalty
// 10, the symmetry 22, the sums 15), with 2 a facet more for beta mu /
// h, K18 42 (CBC: u_prev.n 15) and 45 (DDN, as K13).

#include <cstdint>

#include "ns_facet.cuh"

namespace {

#define FACET_KERNELS(NAME, TERM)                                          \
  template <typename T>                                                    \
  __global__ void NAME##_p1_kernel(const FacetRange<T> r) {                \
    const int64_t f = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;      \
    if (f < r.nf) facet_residual_lane<T, TERM>(r, f);                      \
  }                                                                        \
  template <typename T>                                                    \
  __global__ void NAME##_jac_p1_kernel(const FacetRange<T> r) {            \
    const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;   \
    if (lane < r.nf * NLOC) facet_jacobian_lane<T, TERM>(r, lane);         \
  }

// distinct names, so that a trace tells the terms apart
FACET_KERNELS(ns_facet_natural, TERM_NATURAL)
FACET_KERNELS(ns_facet_viscous, TERM_VISCOUS)
FACET_KERNELS(ns_facet_backflow, TERM_BACKFLOW)
FACET_KERNELS(ns_facet_weakp, TERM_WEAKP)
FACET_KERNELS(ns_facet_nitsche, TERM_NITSCHE)
FACET_KERNELS(ns_facet_nitsche_curl, TERM_NITSCHE_CURL)
FACET_KERNELS(ns_facet_cbc, TERM_CBC)
FACET_KERNELS(ns_facet_ddn, TERM_DDN)

template <typename T>
int launch(const FacetRange<T>& r, int jacobian, cudaStream_t st) {
  const int threads = 128;
  const int64_t lanes = jacobian ? r.nf * NLOC : r.nf;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
#define FACET_LAUNCH(NAME)                                          \
  if (jacobian)                                                     \
    NAME##_jac_p1_kernel<T><<<blocks, threads, 0, st>>>(r);         \
  else                                                              \
    NAME##_p1_kernel<T><<<blocks, threads, 0, st>>>(r);
  switch (r.term) {
    case TERM_NATURAL:
      FACET_LAUNCH(ns_facet_natural)
      break;
    case TERM_VISCOUS:
      FACET_LAUNCH(ns_facet_viscous)
      break;
    case TERM_BACKFLOW:
      FACET_LAUNCH(ns_facet_backflow)
      break;
    case TERM_WEAKP:
      FACET_LAUNCH(ns_facet_weakp)
      break;
    case TERM_NITSCHE:
      FACET_LAUNCH(ns_facet_nitsche)
      break;
    case TERM_NITSCHE_CURL:
      FACET_LAUNCH(ns_facet_nitsche_curl)
      break;
    case TERM_CBC:
      FACET_LAUNCH(ns_facet_cbc)
      break;
    default:
      FACET_LAUNCH(ns_facet_ddn)
  }
#undef FACET_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// term: one of the TERM_ codes (ns_facet.cuh); implicit: the velocity
// u, else the midpoint; c, c2: the term's scalars (FacetRange); h: the
// cell sizes (nf,), read by Nitsche only; jacobian = 0: out is ru_f
// (nf, 3, 2); 1: out is A_f (nf, 9, 9)
extern "C" int cfd_ns_facet_p1(
    int term, int implicit, const void* u, const void* uprev, const void* p,
    const void* dofmap_u, const void* dofmap_p, const void* coords,
    const void* phi_u, const void* dphi_u, const void* phi_p,
    const void* gdphi, const void* normal, const void* dS, const void* h,
    int64_t nf, int64_t nq, double c, double c2, int jacobian, void* out,
    int is_f64, void* stream) {
  if (term < 0 || term >= NTERMS || nq < 1) return (int)cudaErrorInvalidValue;
  if (nf <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* fp[10] = {dofmap_u, dofmap_p, coords, phi_u, dphi_u,
                        phi_p,    gdphi,    normal, dS,    h};
  if (is_f64)
    return launch<double>(facet_range<double>(u, uprev, p, fp, nf, (int)nq,
                                              term, implicit, c, c2, out),
                          jacobian, st);
  return launch<float>(facet_range<float>(u, uprev, p, fp, nf, (int)nq, term,
                                          implicit, c, c2, out),
                       jacobian, st);
}
