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
//      (a)_- = (a - |a|) / 2 taken at u_prev (backflow),
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
// pressure rows are zero. K13's kink is in u_prev, a constant of the
// derivative, so no dual meets |.|.
//
// Bound: launch latency. A mesh of 70,095 cells has 755 boundary
// facets and the DFG 2D-1 outlet at res 0.0025 has 55; a kernel moves
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
// (u_prev.n)_- 18, the term 12, the sums 15).

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

// distinct names, so that a trace tells the three terms apart
FACET_KERNELS(ns_facet_natural, TERM_NATURAL)
FACET_KERNELS(ns_facet_viscous, TERM_VISCOUS)
FACET_KERNELS(ns_facet_backflow, TERM_BACKFLOW)

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
  if (r.term == TERM_NATURAL) {
    FACET_LAUNCH(ns_facet_natural)
  } else if (r.term == TERM_VISCOUS) {
    FACET_LAUNCH(ns_facet_viscous)
  } else {
    FACET_LAUNCH(ns_facet_backflow)
  }
#undef FACET_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// term: TERM_NATURAL, TERM_VISCOUS or TERM_BACKFLOW (ns_facet.cuh);
// implicit: the velocity u, else the midpoint; c: mu, sign mu or
// -beta rho; jacobian = 0: out is ru_f (nf, 3, 2); 1: out is A_f
// (nf, 9, 9)
extern "C" int cfd_ns_facet_p1(
    int term, int implicit, const void* u, const void* uprev, const void* p,
    const void* dofmap_u, const void* dofmap_p, const void* coords,
    const void* phi_u, const void* dphi_u, const void* phi_p,
    const void* gdphi, const void* normal, const void* dS, int64_t nf,
    int64_t nq, double c, int jacobian, void* out, int is_f64,
    void* stream) {
  if (term < 0 || term >= NTERMS || nq < 1) return (int)cudaErrorInvalidValue;
  if (nf <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* fp[9] = {dofmap_u, dofmap_p, coords, phi_u, dphi_u,
                       phi_p,    gdphi,    normal, dS};
  if (is_f64)
    return launch<double>(facet_range<double>(u, uprev, p, fp, nf, (int)nq,
                                              term, implicit, c, out),
                          jacobian, st);
  return launch<float>(facet_range<float>(u, uprev, p, fp, nf, (int)nq, term,
                                          implicit, c, out),
                       jacobian, st);
}
