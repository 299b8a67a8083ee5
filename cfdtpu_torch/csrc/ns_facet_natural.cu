// K7 ns_facet_natural_p1: the natural-correction facet term, residual
// and Jacobian.
//
// Replaces the vmapped facet kernel of cfdtpu's forms/facet_terms.py
// natural_correction (with midpoint_velocity), as StabilizedNSForm maps
// it over the exterior facets in _block_residual and, through
// jax.vmap(jax.jacfwd(_flat_facet_kernel(.))), in element_jacobians:
//   r_u[b][i] = sum_q dS phi_u[b] (p n_i - mu sum_j d(u_mid)_j/dx_i n_j)
// at the Crank-Nicolson midpoint u_mid = (u + u_prev) / 2, on the P1
// triangle behind each facet. The dofmap gathers of u, u_prev and p are
// fused, as in K3.
//
// The body is a template on its number type, like K3's: the residual
// runs it on plain numbers, one lane a facet; the Jacobian runs it on
// Dual<T, 1>, nine lanes a facet, lane j writing column j of the (9, 9)
// block in the flat element layout [u(b, i) row-major, then p(b)], whose
// three pressure rows are zero (the term has no continuity part).
//
// Bound: launch latency. A mesh of 70,095 cells has 755 boundary
// facets; the kernel moves some 0.1 MB (residual) or 0.35 MB (Jacobian)
// and runs in the time of an empty launch. So the form does not launch
// it: the bodies live in ns_facet_natural.cuh, and K3's launch runs them
// as a second range of blocks (csrc/ns_cell_residual.cu). The kernels
// here are K7's own entry points, which the reaction force of
// scenarios/dfg_1.py calls.

#include <cstdint>

#include "ns_facet_natural.cuh"

namespace {

template <typename T>
__global__ void ns_facet_natural_p1_kernel(FacetIn<T> in, FacetTabs<T> tb,
                                           int64_t nf, int nq, T mu,
                                           T* __restrict__ ru_f) {
  const int64_t f = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (f >= nf) return;
  facet_residual_lane(in, tb, f, nq, mu, ru_f);
}

template <typename T>
__global__ void ns_facet_natural_jac_p1_kernel(FacetIn<T> in,
                                               FacetTabs<T> tb, int64_t nf,
                                               int nq, T mu,
                                               T* __restrict__ A) {
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= nf * NLOC) return;
  facet_jacobian_lane(in, tb, lane, nq, mu, A);
}

template <typename T>
int launch(const void* u, const void* uprev, const void* p,
           const void* dofmap_u, const void* dofmap_p, const void* coords,
           const void* phi_u, const void* dphi_u, const void* phi_p,
           const void* gdphi, const void* normal, const void* dS, int64_t nf,
           int nq, double mu, int jacobian, void* out, cudaStream_t st) {
  const FacetIn<T> in = facet_in<T>(u, uprev, p, dofmap_u, dofmap_p, coords);
  const FacetTabs<T> tb = facet_tabs<T>(phi_u, dphi_u, phi_p, gdphi, normal,
                                        dS);
  const int threads = 128;
  const int64_t lanes = jacobian ? nf * NLOC : nf;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  if (jacobian)
    ns_facet_natural_jac_p1_kernel<T><<<blocks, threads, 0, st>>>(
        in, tb, nf, nq, (T)mu, static_cast<T*>(out));
  else
    ns_facet_natural_p1_kernel<T><<<blocks, threads, 0, st>>>(
        in, tb, nf, nq, (T)mu, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// jacobian = 0: out is ru_f (nf, 3, 2); 1: out is A_f (nf, 9, 9)
extern "C" int cfd_ns_facet_natural_p1(
    const void* u, const void* uprev, const void* p, const void* dofmap_u,
    const void* dofmap_p, const void* coords, const void* phi_u,
    const void* dphi_u, const void* phi_p, const void* gdphi,
    const void* normal, const void* dS, int64_t nf, int64_t nq, double mu,
    int jacobian, void* out, int is_f64, void* stream) {
  if (nf <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch<double>(u, uprev, p, dofmap_u, dofmap_p, coords, phi_u,
                          dphi_u, phi_p, gdphi, normal, dS, nf, (int)nq, mu,
                          jacobian, out, st);
  return launch<float>(u, uprev, p, dofmap_u, dofmap_p, coords, phi_u, dphi_u,
                       phi_p, gdphi, normal, dS, nf, (int)nq, mu, jacobian,
                       out, st);
}
