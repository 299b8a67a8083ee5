"""Hand-written CUDA kernels of the Newton-Krylov step and their wrappers.

K1 sup_spmv            supernode-ELL SpMV with fused epilogues; with its
                       prolong option it reads a V-cycle's coarse-grid
                       correction in its gather (K8 folded in); its
                       cheby mode ends in a Chebyshev step
   cheby_update        that step alone, elementwise, after an operator
                       that is not one K1 launch
   bsr_spmv            K1's node-block mode: the assembled 4 x 4 node
                       blocks of tetrahedra in block-CSR order, with
                       K1's epilogues (NodeBSR's layout at d = 3)
K2 ell_sum             deterministic sorted-segment gather-reduce (CSR scatter)
K3 ns_cell_residual_p1 fused stabilized-NS cell residual, P1 triangles,
   ns_cell_jacobian_p1 and its exact element Jacobian (the same cell body
                       on forward-mode dual numbers); each takes the
                       form's facet blocks, whose K7, K12 or K13 bodies
                       then run in the same launch
K4 selfp_triple        SELFP triple products Apu diag(Auu)^-1 Aup
K5 patch_spmv          in-patch scalar ELL SpMV (the gather microbenchmark)
K6 ras_apply           restricted additive Schwarz window apply (owned rows)
K7 ns_facet_natural_p1 natural-correction facet term, P1 triangles,
   ns_facet_natural_jac_p1 and its element Jacobian, at the midpoint or
                       (implicit, BDF2's) at u
K8 amg_prolong         AMG coarse-grid correction base + xc[agg]
K9 krylov_cgs          GMRES Gram-Schmidt step (CGS, CGS2), the active rows,
                       one launch; in FGMRES it ends in the Givens update;
                       its normalisation (j = -1) takes an elementwise
                       scale: a power-iteration step (la/chebyshev.py)
   krylov_lsq          gmres_fixed's small least-squares solve and Z^T y,
                       and (krylov_lsq_tri) FGMRES's triangle and x + Z^T y
K10 block_jacobi       node-block Jacobi z = blockdiag(inv) v (d = 1: a
                       diagonal scale);
    block_jacobi_inv   the (d x d) inverses of the diagonal velocity
                       blocks with the Dirichlet identity rows
K11 amg_gcr2           the K-cycle's GCR(2) step, two launches
K12 ns_facet_viscous_p1 the outlet viscous traction facet term, P1
    ns_facet_viscous_jac_p1 triangles, and its element Jacobian
K13 ns_facet_backflow_p1 the backflow stabilisation facet term, P1
    ns_facet_backflow_jac_p1 triangles, and its element Jacobian
K14 ns_cell_residual_bdf2_p1 K3's cell body under BDF2 (the time term
    ns_cell_jacobian_bdf2_p1 over u, u_prev, u_prev2; the rest at u),
                       residual and Jacobian, with the form's facet
                       blocks in its launch as K3 takes them
K15 ns_cell_residual_curl_p1 K3's cell body in the curl-curl form
    ns_cell_jacobian_curl_p1 (viscous term mu curl u . curl v, Lamb-form
                       convection), residual and Jacobian, with the
                       form's facet blocks in its launch
K16 ns_facet_weakp_p1  the weak pressure facet term (its Jacobian is zero)
K17 ns_facet_nitsche_p1 symmetric Nitsche u_T = 0, sigma form, and
    ns_facet_nitsche_curl_p1 curl form, with their element Jacobians
K18 ns_facet_cbc_p1    the convective outlet and the directional
    ns_facet_ddn_p1    do-nothing outlet (K13's body at -1/2), with
                       their element Jacobians

Every wrapper takes its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors (or raises); each call of a
wrapper that launches adds one to its counter, `COUNTERS[name].n` (a
counter of cfdtpu_torch.utils.trace, always on). A
fused variant or option also counts under its own name:
`sup_spmv_prolong` (K1 with the coarse-grid correction), `sup_spmv_cheby`
(K1's cheby mode), `krylov_cgs_scaled` (K9's scaled normalisation),
`ns_cell_residual_p1_facet` and
`ns_cell_jacobian_p1_facet` (K3 with facet blocks; `..._bdf2_p1_facet`
K14's, `..._curl_p1_facet` K15's), each a subset of its kernel's
count; a facet term that runs in an element kernel's launch counts
under its kernel's name with `_fused` (`ns_facet_viscous_p1_fused`:
launches that carried a K12 block);
the fused variants' device kernels carry the same names
(`sup_spmv_prolong_kernel`, ...), so a trace matches them as a
name contains them (the two options run in their kernel's device
kernel, and a trace counts them under it).
Inside a CUDA graph
(la/schur.py captures each preconditioner application) a wrapper runs
once, at capture, and adds one then: the graph's replays launch the
captured kernels and count nothing. The device kernels of a replay are
read from torch.profiler's trace.
"""

from __future__ import annotations

# the counters are the trace module's (utils/trace.py), re-exported here
from ..utils.trace import COUNTERS, counts, reset_counts  # noqa: F401
from ..utils.trace import Counter as LaunchCounter  # noqa: F401
