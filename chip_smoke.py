#!/usr/bin/env python3
"""Chip smoke test of cfdtpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py [--report PATH] [--path-m-only]

Run from the root of a checkout. Phases, each raising on failure
(--path-m-only: 1, 2 and 19 alone):

1. the card: nvidia-smi name and power limit, torch and CUDA versions;
   no CUDA is an error.
2. build: one nvcc per cfdtpu_torch/csrc/*.cu, all started together,
   linked into cfdtpu_torch/_build/libcfdtpu_kernels.so.
3. kernels: at the DFG 2D-1 res_scale=0.3 slice (106,275 DOF, float32)
   every kernel (K1 sup_spmv, K2 ell_sum, K3 ns_cell_residual_p1 and
   ns_cell_jacobian_p1, K4 selfp_triple, K5 patch_spmv, K6 ras_apply,
   K7 ns_facet_natural_p1 and ns_facet_natural_jac_p1, K8 amg_prolong,
   K9 krylov_cgs and krylov_lsq, K10 block_jacobi and block_jacobi_inv,
   K11 amg_gcr2; K12, K13, K14 and K7's implicit mode at paths E's and
   F's shapes, items 9 and 10; K15-K18 at paths G's, H's and I's,
   items 11 and 12) is held against its plain PyTorch
   version at each of
   its call sites on the paths below — including K1's cheby mode at the
   SELFP AMG's L0 and BlockAMG's L1 (the first step from w b through
   K1's input scale, a step with d stored, the first post-smoothing step
   reading x + P xc, a last step with the W-cycle's add) and cheby_update
   at the S stage, K9's scaled normalisation at the power iteration
   (SELFP L0, the u-block), K10 on the u-block (inverses, apply) and at
   the S stage (v / d_p), K11's two launches at SELFP L1 and BlockAMG L1,
   the rasamg_sup block-AMG levels (K1 at width 16), K1's epilogue
   options at their solver sites (row mask, input scale, residual from
   any vector), block transfers and facet-residual scatter (K2), the RAS
   windows (K6), K8 at every AMG level with both bases, K1 with the
   coarse-grid correction in its gather (K8 folded in) at every level of
   both hierarchies (mode jacobi from the bases x and s*b, and on
   BlockAMG's finest level the RAS smoother's residual with x-hat
   stored), K3 with the facet block in its launch (K7's bodies; residual
   and Jacobian), K9's step at
   the FGMRES sites (CGS2 with the Givens tail, j = 0, 9, 19, its state
   restored before each compared call) and the S-stage sites (CGS, j = 0,
   4), K9's least squares (m = 5, 20) and its triangular mode (j = 5,
   20), and the gather_micro shapes (K5, beside K1 at width 1):
   ||kernel - plain||_inf <= 1e-5 ||plain||_inf (float32: the sums run
   in another order), and called twice, bitwise equal; a fused site is
   also compared bit for bit with the launches it replaces on the same
   inputs (K8 then K1; K3 and K7 apart), whose device time is printed
   beside its own. Each site is
   timed (median device time of 25 CUDA-event-timed calls, host
   dispatch excluded) warm and cold (a 128 MiB buffer written before
   each call, outside its events, so the L2 holds none of its inputs):
   the kernel, its plain version (5 calls, after the one-launch phases:
   timing it between the traces left the profiler dropping records) and
   its library yardstick, one
   PyTorch call computing the same function that the port never calls
   (K1: torch.sparse_bsr_tensor @ x over the same blocks, CSR over
   the same entries where the blocks are not square or 1 x 1, and
   with the correction in its gather that product plus
   torch.index_select of xc; K2:
   index_add_; K5: a CSR sparse product; K6: torch.bmm of the owned
   inverse rows with pre-gathered windows, the gather left out; K8:
   torch.index_select of xc, the gather without the add; K9: the whole
   Gram-Schmidt step from cuBLAS, two GEMVs a pass (torch.mv and
   torch.addmv), then the norm and the scaled store (not the Givens
   tail), torch.linalg.solve_ex of the normal equations, and
   torch.linalg.solve_triangular with torch.addmv for the triangular
   mode; K1's cheby mode: K1's product plus the update in torch ops; K9's
   scaled normalisation: torch.linalg.vector_norm and a divide; K10:
   torch.linalg.inv of the masked blocks, torch.bmm of the inverses with
   v, torch.div; K11: the same step from torch.dot and torch.add calls;
   K3, K3+K7, K4, K7 and cheby_update: none); and the kernel's and the
   yardstick's
   device time alone
   (utils/cudatime.device_ms: torch.profiler's trace of 20 warm calls,
   without the launch that the event-timed times carry; a trace that
   comes back empty is taken again, a second later, up to 5 times, here
   and in every phase that traces). Each site
   prints its bound: the bytes it must move and the operations it does
   (the *_bytes functions, the K3_OPS and K7_OPS counts), over 3.35 TB/s
   and 67 TFLOP/s, the larger of the two, and its share of the cold
   time. An empty kernel, launched the same way, is timed first as the
   floor of the small sites. The same checks run in float64 at
   res_scale 1.0 with 1e-12, untimed.
   Then, under torch.profiler, each operator apply the solver calls
   (NodeBSR.apply_element_matrices, apply_sub_block, apply_p_coupled,
   AMG._matvec (both hierarchies), and with their epilogues the
   outer matvec, Auu, Aup, Apu and App of la/schur.py) must issue one
   device kernel, K1; the SELFP Schur action two (no mean removal: DFG
   pins no pressure); the near-true one three beside its V-cycle's; one
   replayed preconditioner application of rasamg_sup (here) and of amg_p
   (after its slice) one cudaGraphLaunch and no kernel launch, bitwise
   equal to the eager application (phase_graph), its closure launching
   131 and 134 port kernels, K1 with the correction in its gather among
   them and no K8, and a trace of it at most 146 and 149 device kernels
   (PR 7's 177 and 169 less the K8 launches folded into K1; K10 one
   kernel where the einsum was one); each K9 step at the FGMRES
   site (with its Givens tail) and at the S stage one device kernel, and
   each triangular solve one; K1 in its cheby mode, each K11 launch,
   each K10 apply, cheby_update and K9's scaled normalisation one device
   kernel each;
   one form.residual call must issue 5 device kernels, K3 with the
   facet block in its launch, K2 three times and the add, and one
   form.element_jacobians call exactly one, K3's Jacobian with the facet
   block's (no vmap or jacfwd work). The device kernels of both calls
   are printed beside those of the same calls made with the plain facet
   term and the plain vmap(jacfwd) Jacobians, which is what the form
   dispatched before K7 and the Jacobian kernels existed.
4. determinism: two float32 form.residual calls on one state are
   bitwise equal, and so are two element_jacobians + assemble results,
   two assemble_wss results, two element-block apply_element_matrices
   and apply_sub_block results, and the replayed preconditioner
   application and the eager one of the same closure (rasamg_sup and
   amg_p; again after the slice phases, on the graphs of their last
   pc_lag rebuild).
5. path A, the rasamg_sup slice (the configuration bench.py runs):
   Scenario.solve drives 14 float32 steps from rest (Schur/rasamg_sup,
   pc_inner_u=0, pc_inner_p=5, RAS windows of 32 with overlap 4, chord
   Newton, pc_lag_steps=4, stats_every=4, ksp_restart=20, dt=0.05),
   steps 1-6 warm-up and 7-10 measured, with the launch counters reset
   just before; steps 11-14 run under torch.profiler (each port
   kernel's calls and device ms, the largest other device activities,
   the host's kernel launches, graph launches, cudaMemcpyAsync calls and
   waits (synchronisations and blocking copies), per KSP iteration too,
   the waits and FGMRES's discarded lookahead iterations per solve, the
   card's idle share). Every step must
   converge with a finite state, no linear solve may hit ksp_max_it, K1
   (and K1 with the correction in its gather), K2, K3 with the facet
   block (both entry points), K4, K6 and K9 (both) must have launched in
   steps 1-10 (a kernel inside the preconditioner's CUDA graph counts at
   capture), K8 and K7 no time there nor in the window (folded), and the
   window may take at most 30 host launches (kernel and graph) per KSP
   iteration.
6. path C: rasamg_sup with bench.py's settings and the whole AMG cycle
   family (pc_amg_wcycle, pc_amg_kcycle, pc_amg_cheby=2): 8 float32
   steps from rest, then 4 under torch.profiler, path A's checks, K1's
   cheby mode, K9's scaled normalisation and K11 launched; then one
   preconditioner application of its settings (phase_graph): one
   cudaGraphLaunch and no kernel launch, bitwise equal to the eager
   application; its port kernels (the wrappers' launches in one eager
   call) and a replay's traced device kernels printed by kernel (a
   trace may drop records, never add one), and no device kernel
   outside the port's but of the kinds path A's graph holds (the
   coarsest GEMVs, the Schur combination's copy and add).
7. the amg_p slice (the solver's default inner method): 8 float32 steps
   from rest, steps 5-8 measured, the same checks for K1-K4, K9 and K10.
8. path D: the inner methods gmres (pc_inner_u 6, pc_inner_p at its
   default of 30) at 38,607 DOF, chebyshev_p at 4,461 and chebyshev at
   1,626 DOF (sizes where each converges within ksp_max_it, on the card
   and in cfdtpu; PATH_D), PATH_D_STEPS float32 steps each from rest
   with the amg_p slice's chord Newton, then PATH_D_PROFILE under
   torch.profiler, the same checks (K10, and
   cheby_update, K1's cheby mode and K9's scaled normalisation where the
   method runs them), and phase_graph against amg_p's graph.
9. path E: DFG 2D-1 steady (DFG2D1Steady at res 0.0025, 121,515 DOF)
   with the dfg_2d_1 solver (the viscous traction K12 and the backflow
   K13 on the outlet, two facet blocks in K3's launch; Newton to rtol
   1e-10) in float64 with path A's settings: first its kernel sites
   (K12, K13 alone at a state with backflow on part of the outlet, K3
   with both blocks beside the three launches apart; timed in float64,
   checked again in float32) and its form's device kernels (residual 7,
   Jacobian 1), then 4 steps from rest and 5-6 under torch.profiler,
   each step's c_D and c_L printed; K12 and K13 must have run inside
   K3's launches (their `_fused` counts) and never alone.
10. path F: stabilized_schur_bdf2 on path A's mesh and settings in
   float32 (K14, with K7's implicit mode in its launch): its sites
   (timed in float32, checked in float64), its form's device kernels
   (residual 5, Jacobian 1), steps 1-3 (BDF1, then BDF2) and step 4
   under torch.profiler, ending on BDF2's coefficients.
11. paths G and H: pipe_cylinder_pressurebc (the DFG geometry driven
   by weak pressures, p_inlet 0.15, p_outlet 0) at res_scale 0.3
   (106,275 DOF), float32, no pressure dof pinned (asserted): G under
   stabilized_schur_pressurebc (K15 with K16 and K17's curl form at
   both ends in its launch) with the solver's default inner method,
   amg_p (under rasamg_sup this form's linear solves stop at ksp_max_it
   from 38,607 DOF up, in cfdtpu as in the port); H under
   stabilized_schur_pressure_backflow with R_resistance 1.0 and
   RASAMG_KW (K3 with five blocks: K16, K17, K16 at 0.5 p_c, K12, K13).
   Each: its kernel sites (every block's term alone, K15 alone on G,
   the element kernel with every block beside the launches apart;
   timed in float32, checked in float64 too), its form's device kernels
   (one element launch a residual and a Jacobian build), PATH_GH_STEPS
   steps from rest and one under torch.profiler (Newton/KSP a step and,
   on H, p_c a step), every residual and Jacobian build of the steps
   one element launch with the blocks in it (asserted).
12. path I: stabilized_schur_vascularbc_cbc and _ddn (K18 in K15's
   launch) on DFG 2D-1 at res_scale 0.3 (106,275 DOF), float32, amg_p
   (under rasamg_sup this form's linear solves stop at ksp_max_it there,
   as on path G): their kernel sites, then PATH_I_STEPS steps each from
   rest.
13. parity: float64 at res_scale 1.0, 2 steps (gmres: 1) through the
   kernels on the card and as many through the plain versions (which
   the wrappers take only for CPU tensors, so that run is on the host),
   for rasamg_sup, amg_p, path C's configuration and gmres, with the
   four CLI runs (15) going meanwhile: equal Newton and KSP counts
   per step, and equal to PARITY_COUNTS (the counts every earlier tree
   gave; path C's and gmres's from cfdtpu on the CPU), u, p, c_D, c_L
   and dp within 1e-9 relative; path E's solver at res 0.02 (2,058
   DOF), 2 steps, card against host: counts equal to cfdtpu's
   (PARITY_E_COUNTS), u, p and every step's c_D and c_L within 1e-9;
   and paths G's and H's solvers at res_scale 2.0 (2,520 DOF) under
   RASAMG_KW, and G's under amg_p (path G's SLICE_KW), 2 steps, card
   against host: counts equal to cfdtpu's (PARITY_GH_COUNTS), u, p and
   each step's p_c within 1e-9.
14. path B: `python -m cfdtpu_torch.scripts.gather_micro --device cuda`
   exits 0 with every K5 result within 1e-5 relative of its plain
   version; it launches K5.
15. CLI, four processes started together before the parity runs and
   waited for after them: `python -m cfdtpu_torch simulate ... --device
   cuda` exits 0 and
   writes simulation_params.txt, norms.txt and v.pvd, with the default
   inner method and with the rasamg_sup flags; the rasamg_sup run
   once more without --device, which must take the card; and
   `--simulation dfg_2d_1 --solver dfg_2d_1` at res 0.02 in float64,
   which must print its `DFG Metrics:` line every step.

16. path J: validate_ghia's lid-driven cavity march
   (stabilized_schur_bdf2, K14) at Re 100 (nx 64, 12,675 DOF) in
   float32 and Re 400 (nx 96, 28,227 DOF) in float64 (in float32 its
   Newton stalls near the steady state), up to its CASES steps: each step's
   wall time, Newton and KSP counts, peak memory, and max|u - u_Ghia|
   and its rms at Ghia's 17 points, the largest under GHIA_MAX_ERR
   (0.055) at both.
17. path K: DFG 2D-2 (PipeCylinder2D2Simulation, 78,348 DOF, 108
   obstacle facets) with validate_dfg2d2's settings, 20 steps with a
   checkpoint at the end, then resumed from it to 40: bdforces.txt
   holds 40 finite rows, contiguous indices, strictly increasing times,
   the first 20 unchanged by the resumed leg, and no force row reached
   the host between two flushes; its rows are printed beside the JAX
   package's TPU series on the same mesh and dt (not a gate).
18. path L: StenosisSimulation at its defaults (30,789 DOF) under
   stabilized_schur_pressurebc, float32, 3 steps: ffr.txt with an FFR
   in (0, 1), u finite, mean u_x > 0; then
   StenosisWithTree2DPressureSimulation at res 0.15 (72,219 DOF), dt
   0.001 (at 0.005 its first step stalls), 2 steps: the reynolds VTU
   written and its largest local Re printed.
   Their float64 parity (13) at small sizes: J at nx 8, K at res_scale
   3.0 (every force row), the stenosis at res 0.6 (the FFR), card
   against host within 1e-9; and three more CLI runs (15):
   lid_driven2D under stabilized_schur_bdf2 (benchmark_100.csv) and
   the stenosis (ffr.txt) with and without --device.
19. path M: DFG 3D-1Z on P1 tetrahedra (DFG3DBenchmark at res_scale 0.6
   in 22 layers: 1,367,718 cells, 59,442 boundary facets, 972,072 DOF,
   float32, the benchmark cell's amg_p settings): the tetrahedral K3
   with K7 in its launch (ns_cell_*_tet_facet_kernel; residual and
   Jacobian) against the plain cell kernel (PATH_M_CHUNK cells a call)
   and the plain facet kernel, K1's node-block mode on the solver's own
   layout (bsr_spmv on the 4 x 4 node blocks: the outer operator with
   and without its row mask, Auu with its mask, Apu in S's residual
   with the scale, the p column) and, beside each, K1 on the 16 x 16
   supernode blocks of g = 4 that it replaces (NodeBSR at supernode_g
   4, the same sites and the plain velocity view), within 1e-5 and
   bitwise on repeat, timed as in 3 (the
   tetrahedral body's bound is its bytes alone: its operations are not
   counted); the same in float64 at res_scale 2.0 in 4 layers within
   1e-12, untimed; form.residual and form.element_jacobians one element
   launch each (phase_one_launch_form); then PATH_M_STEPS steps of
   Scenario.solve from rest with the counters reset just before and one
   under torch.profiler, as path A's checks: every element launch
   tetrahedral (`ns_cell_*_p1_tet`) with the natural block in it, K7
   never alone, bsr_spmv launched, c_D, c_L and dp after the last step
   printed.

The second-to-last line is {"kernels": [...]} (per kernel at its
headline site: launches on its path (A-I, M), max_abs_err, the cold ms,
plain_ms and library_ms, bound_ms and bound_by, the warm ms, the
device time alone, and its calls and device ms in the profiled window;
a folded kernel's launches are its own, 0 on its path, and
`launches_fused` those that carried its body), the last {"ok": true,
"device": {...}}.
"""

import argparse
import gc
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DT = 0.05
# the solver's default inner method (the first ported slice)
SLICE_KW = dict(pc_inner_method="amg_p", pc_inner_u=6, pc_inner_p=10,
                snes_lag_jacobian=True, pc_lag_steps=4, ksp_restart=20)
# the configuration bench.py runs (bench.py:64-74, 119)
RASAMG_KW = dict(pc_inner_method="rasamg_sup", pc_inner_u=0, pc_inner_p=5,
                 pc_ras_size=32, snes_lag_jacobian=True, pc_lag_steps=4,
                 ksp_restart=20)
RASAMG_FLAGS = ["--pc_inner_method", "rasamg_sup", "--pc_inner_u", "0",
                "--pc_inner_p", "5", "--pc_ras_size", "32",
                "--snes_lag_jacobian", "True", "--pc_lag_steps", "4",
                "--stats_every", "4", "--ksp_restart", "20"]
# the element kernels the slices launch: K3 with the facet block in its
# launch (K7's bodies), residual and Jacobian
ELEMENT_KERNELS = ("ns_cell_residual_p1", "ns_cell_residual_p1_facet",
                   "ns_cell_jacobian_p1", "ns_cell_jacobian_p1_facet")
# K1 with the V-cycles' coarse-grid correction in its gather (K8 folded)
PC_KERNELS = ("sup_spmv_prolong", "krylov_cgs", "krylov_lsq")
PATH_A_KERNELS = ("sup_spmv", "ell_sum", "selfp_triple", "ras_apply",
                  *ELEMENT_KERNELS, *PC_KERNELS)
AMG_P_KERNELS = ("sup_spmv", "ell_sum", "selfp_triple", *ELEMENT_KERNELS,
                 *PC_KERNELS, "block_jacobi", "block_jacobi_inv")
# path C: bench.py's configuration with the AMG cycle family on both
# hierarchies: the K-cycle where the cycle may be nonlinear (the preonly
# u stage, the SELFP AMG under the S sweeps), the W-cycle (inside the
# near-true S, where the K-cycle is forced off, and beside it), and
# Chebyshev smoothing of degree 2 on every level but the RAS one
PATH_C_KW = dict(RASAMG_KW, pc_amg_wcycle=True, pc_amg_kcycle=True,
                 pc_amg_cheby=2)
PATH_C_KERNELS = (*PATH_A_KERNELS, "sup_spmv_cheby", "krylov_cgs_scaled",
                  "amg_gcr2")
# path D: the non-AMG inner methods, with the amg_p slice's chord Newton
# (pc_inner_p at its default: 30 without AMG), each at a size where its
# PATH_D_STEPS + PATH_D_PROFILE steps converge with no solve at
# ksp_max_it on the card in float32 and in float64 and where cfdtpu
# converges on the CPU (PERF.md, PR 9): at 106,275 DOF gmres's first
# solve stagnates at ksp_max_it in cfdtpu as on the card (logged by
# tests/test_torch_gmres_parity.py); chebyshev_p reaches the limit from
# 9,861 DOF up, chebyshev from 2,520 DOF up (at step 5, after the first
# rebuild), as cfdtpu does; name: (res_scale, solver options, required
# kernels)
_LAG = dict(snes_lag_jacobian=True, pc_lag_steps=4, ksp_restart=20)
PATH_D = {
    "gmres": (0.5, dict(pc_inner_method="gmres", pc_inner_u=6, **_LAG),
              ("sup_spmv", "krylov_cgs", "krylov_lsq", "block_jacobi",
               "block_jacobi_inv", "ell_sum", *ELEMENT_KERNELS)),
    "chebyshev_p": (1.5, dict(pc_inner_method="chebyshev_p", pc_inner_u=6,
                              **_LAG),
                    ("sup_spmv", "krylov_cgs", "krylov_lsq", "block_jacobi",
                     "block_jacobi_inv", "cheby_update",
                     "krylov_cgs_scaled")),
    "chebyshev": (2.5, dict(pc_inner_method="chebyshev", pc_inner_u=6,
                            **_LAG),
                  ("sup_spmv", "sup_spmv_cheby", "block_jacobi",
                   "cheby_update", "krylov_cgs_scaled")),
}
# path E: DFG 2D-1 steady with its own solver (dfg_2d_1: no natural
# correction, K12 and K13 on the outlet in K3's launch, Newton rtol
# 1e-10), float64 (float32 cannot resolve those tolerances), RASAMG_KW,
# at res 0.0025 (40,505 nodes, 121,515 DOF, 55 outlet facets): steps
# from rest, then steps under torch.profiler
PATH_E_RES = 0.0025
PATH_E_STEPS = 4
PATH_E_PROFILE = 2
PATH_E_KERNELS = ("sup_spmv", "ell_sum", "selfp_triple", "ras_apply",
                  *ELEMENT_KERNELS, *PC_KERNELS,
                  "ns_facet_viscous_p1_fused", "ns_facet_viscous_jac_p1_fused",
                  "ns_facet_backflow_p1_fused",
                  "ns_facet_backflow_jac_p1_fused")
# path E's float64 card run held against the host's plain versions: at
# res 0.02 (2,058 DOF), where the host's run takes seconds (at res
# 0.0025 its chord Newton to rtol 1e-10 would take many minutes)
PARITY_E_RES = 0.02
PARITY_E_STEPS = 2
PARITY_E_COUNTS = [(18, 55), (35, 108)]  # cfdtpu's on the CPU
# path F: stabilized_schur_bdf2 (K14 with the natural correction at u,
# K7's implicit mode, in its launch) at res_scale 0.3, float32,
# RASAMG_KW: step 1 BDF1, steps 2-4 BDF2, step 4 under torch.profiler
PATH_F_STEPS = 3
PATH_F_PROFILE = 1
PATH_F_KERNELS = ("sup_spmv", "ell_sum", "selfp_triple", "ras_apply",
                  "ns_cell_residual_bdf2_p1", "ns_cell_residual_bdf2_p1_facet",
                  "ns_cell_jacobian_bdf2_p1", "ns_cell_jacobian_bdf2_p1_facet",
                  "ns_facet_natural_p1_fused",
                  "ns_facet_natural_jac_p1_fused", *PC_KERNELS)
# path G: pipe_cylinder_pressurebc (the DFG geometry driven by weak
# pressures) under stabilized_schur_pressurebc (the curl-curl form, K15,
# with four blocks in its launch: K16 at the inlet and the outlet, K17's
# curl form at both), at res_scale 0.3 (106,275 DOF), float32, p_inlet
# 0.15, p_outlet 0, with the solver's default inner method (amg_p,
# SLICE_KW): under rasamg_sup every linear solve of this form stops at
# ksp_max_it from 38,607 DOF up (res_scale 0.5; at 26,940 it converges),
# in cfdtpu on the CPU as in the port (PERF.md, section 6); path H: the same
# scenario under stabilized_schur_pressure_backflow (R_resistance 1.0:
# K3 with five blocks, K16 and K17's sigma form at the inlet, K16 at 0.5
# p_c, K12 and K13 at the outlet; p_c from the outlet flux of u_prev
# after each step), float32, RASAMG_KW. Each: steps from rest, then
# steps under torch.profiler.
PIPE_KW = dict(p_inlet=0.15, p_outlet=0.0)
PATH_GH = {"G": ("stabilized_schur_pressurebc", SLICE_KW),
           "H": ("stabilized_schur_pressure_backflow",
                 dict(RASAMG_KW, R_resistance=1.0))}
PATH_GH_STEPS = 3
PATH_GH_PROFILE = 1
CURL_KERNELS = ("ns_cell_residual_curl_p1", "ns_cell_residual_curl_p1_facet",
                "ns_cell_jacobian_curl_p1", "ns_cell_jacobian_curl_p1_facet")
PATH_GH_KERNELS = {
    "G": ("sup_spmv", "ell_sum", "selfp_triple", *CURL_KERNELS, *PC_KERNELS,
          "block_jacobi", "block_jacobi_inv", "ns_facet_weakp_p1_fused",
          "ns_facet_weakp_jac_p1_fused",
          "ns_facet_nitsche_curl_p1_fused",
          "ns_facet_nitsche_curl_jac_p1_fused"),
    "H": ("sup_spmv", "ell_sum", "selfp_triple", "ras_apply",
          *ELEMENT_KERNELS, *PC_KERNELS, "ns_facet_weakp_p1_fused",
          "ns_facet_weakp_jac_p1_fused", "ns_facet_nitsche_p1_fused",
          "ns_facet_nitsche_jac_p1_fused", "ns_facet_viscous_p1_fused",
          "ns_facet_backflow_p1_fused")}
# G's and H's solvers in float64 on the card against the host's plain
# versions at res_scale 2.0 (2,520 DOF), 2 steps: both under RASAMG_KW,
# and G under path G's SLICE_KW too; cfdtpu's counts on the CPU
PARITY_GH = {"G": ("stabilized_schur_pressurebc", RASAMG_KW),
             "G amg_p": ("stabilized_schur_pressurebc", SLICE_KW),
             "H": PATH_GH["H"]}
PARITY_GH_RES = 2.0
PARITY_GH_STEPS = 2
PARITY_GH_COUNTS = {"G": [(2, 10), (3, 14)], "G amg_p": [(2, 9), (3, 12)],
                    "H": [(3, 15), (3, 13)]}
# path I: the convective and the directional do-nothing outlets (K18, in
# K15's launch) under stabilized_schur_vascularbc_cbc and _ddn on the
# DFG 2D-1 channel (its parabolic inlet, v_max 0.3) at path A's width,
# res_scale 0.3 (106,275 DOF, 43 outlet facets), float32, steps from
# rest under amg_p (SLICE_KW, the solvers' default: under rasamg_sup
# every linear solve of the curl-curl form stops at ksp_max_it at this
# width, as on path G)
PATH_I = {"cbc": "stabilized_schur_vascularbc_cbc",
          "ddn": "stabilized_schur_vascularbc_ddn"}
PATH_I_RES = 0.3
PATH_I_STEPS = 2
PATH_I_KERNELS = ("ell_sum", *CURL_KERNELS)
# K7's implicit mode (a flag of K7's launch) in the kernels line: its
# launches are K7's on path F, where every natural correction is at u,
# and it is folded into K14's launch: (counter, folded into)
K7_IMPLICIT = "ns_facet_natural_implicit_p1"
# paths J, K and L: the 2D scenarios against their oracles at the widths
# users run. J: validate_ghia's march (stabilized_schur_bdf2 at its
# defaults, amg_p) at Re 100 (nx 64, 12,675 DOF) in float32 and Re 400
# (nx 96, 28,227 DOF) in float64, up to CASES' steps, its largest
# deviation from Ghia's Table I under GHIA_MAX_ERR, the bound the JAX
# package holds itself to (tests/test_solver.py::test_ghia_re400_profile).
# In float32 the Re 400 march stalls in Newton near the steady state
# (under amg_p and under rasamg_sup: PERF.md, section 6)
PATH_J = ((100, "float32"), (400, "float64"))
GHIA_MAX_ERR = 0.055
PATH_J_KERNELS = ("sup_spmv", "ell_sum", "selfp_triple", "block_jacobi",
                  "block_jacobi_inv", "krylov_cgs", "sup_spmv_prolong",
                  "ns_cell_residual_bdf2_p1", "ns_cell_jacobian_bdf2_p1")
# K: DFG 2D-2 (PipeCylinder2D2Simulation) at res_scale 0.35 (78,348 DOF)
# with validate_dfg2d2's settings, PATH_K_LEG steps with a checkpoint at
# the end, then resumed from it to twice that
PATH_K_RES = 0.35
PATH_K_DT = 0.0025
PATH_K_LEG = 20
PATH_K_KERNELS = ("sup_spmv", "ell_sum", "selfp_triple", "ras_apply",
                  "ns_cell_residual_p1_facet", "ns_cell_jacobian_p1_facet",
                  "krylov_cgs", "krylov_lsq", "sup_spmv_prolong")
# the JAX package's TPU series on the same mesh and dt, printed beside
# the first rows (not a gate)
PATH_K_TPU_SERIES = "validation_runs/results_dfg2d2_0.35/bdforces.txt"
# L: StenosisSimulation at its defaults (res 0.15, 30,789 DOF, severe,
# 75 and 10 mmHg) under stabilized_schur_pressurebc (amg_p), dt 0.005,
# 3 steps; then StenosisWithTree2DPressureSimulation at res 0.15 (72,219
# DOF), dt 0.001, 2 steps (at dt 0.005 the tree's first step from rest
# stalls, every linear solve at ksp_max_it, in float32 and float64, at
# res 0.15 and 0.3: PERF.md, section 6): (tag, class name, dt, steps)
PATH_L = (("stenosis", "StenosisSimulation", 0.005, 3),
          ("tree", "StenosisWithTree2DPressureSimulation", 0.001, 2))
PATH_L_KERNELS = ("sup_spmv", "ell_sum", "selfp_triple", "block_jacobi",
                  "block_jacobi_inv", "krylov_cgs",
                  "ns_cell_residual_curl_p1_facet",
                  "ns_cell_jacobian_curl_p1_facet",
                  "ns_facet_weakp_p1_fused", "ns_facet_nitsche_curl_p1_fused")
# path M: DFG 3D-1Z on P1 tetrahedra (scenarios/dfg_3d.py) at the
# benchmark cell's size and settings (res_scale 0.6 in 22 layers:
# 243,018 nodes, 1,367,718 cells, 972,072 DOF; float32; amg_p, for
# rasamg_sup's block-AMG V-cycle stalls on the 3D velocity block), its
# float64 check at res_scale 2.0 in 4 layers (4,924 nodes); the plain
# versions run PATH_M_CHUNK cells a call (vmap(jacfwd) over all 1.37
# million cells at once would hold ~15 GB a float32 intermediate)
PATH_M = dict(res_scale=0.6, layers=22)
PATH_M_F64 = dict(res_scale=2.0, layers=4)
PATH_M_KW = dict(pc_inner_method="amg_p", pc_inner_u=6, pc_inner_p=5,
                 pc_ras_size=32, snes_lag_jacobian=True, pc_lag_steps=4,
                 ksp_restart=20)
PATH_M_STEPS = 4
PATH_M_PROFILE = 1
PATH_M_CHUNK = 65536
PATH_M_KERNELS = ("sup_spmv", "bsr_spmv", "ell_sum", "selfp_triple",
                  "block_jacobi", "block_jacobi_inv", "krylov_cgs",
                  "krylov_lsq",
                  *ELEMENT_KERNELS, "ns_cell_residual_p1_tet",
                  "ns_cell_jacobian_p1_tet", "ns_facet_natural_p1_fused",
                  "ns_facet_natural_jac_p1_fused")
# counters whose device kernels go by another name: the tetrahedral
# element kernels (csrc/ns_cell_tet.cu, ns_cell_*_tet[_facet]_kernel)
DEVICE_NAME = {"ns_cell_residual_p1_tet": "ns_cell_residual_tet",
               "ns_cell_jacobian_p1_tet": "ns_cell_jacobian_tet"}
# their float64 parity, card against host: J at nx 8, Re 100, 3 steps;
# K at res_scale 3.0 (1,158 DOF), 2 steps; L's stenosis at res 0.6
# (2,571 DOF; at res 1.0 the outlet is one facet between two wall nodes
# and no flow starts), 2 steps
PARITY_J = dict(re=100, nx=8, n_steps=3)
PARITY_K_RES = 3.0
PARITY_L_RES = 0.6
COUNTER_OF = {K7_IMPLICIT: ("ns_facet_natural_p1",
                            "ns_cell_residual_bdf2_p1_facet"),
              "ns_facet_natural_implicit_jac_p1": (
                  "ns_facet_natural_jac_p1",
                  "ns_cell_jacobian_bdf2_p1_facet")}
# folded into another kernel's launch on the slices: held at their
# kernel-phase sites, launched alone no time on paths A, C-F and amg_p
# (a facet term's launches in an element kernel count as `_fused`)
FOLDED = {"amg_prolong": "sup_spmv_prolong",
          "ns_facet_natural_p1": "ns_cell_residual_p1_facet",
          "ns_facet_natural_jac_p1": "ns_cell_jacobian_p1_facet",
          "ns_facet_viscous_p1": "ns_cell_residual_p1_facet",
          "ns_facet_viscous_jac_p1": "ns_cell_jacobian_p1_facet",
          "ns_facet_backflow_p1": "ns_cell_residual_p1_facet",
          "ns_facet_backflow_jac_p1": "ns_cell_jacobian_p1_facet",
          "ns_facet_weakp_p1": "ns_cell_residual_curl_p1_facet",
          "ns_facet_weakp_jac_p1": "ns_cell_jacobian_curl_p1_facet",
          "ns_facet_nitsche_curl_p1": "ns_cell_residual_curl_p1_facet",
          "ns_facet_nitsche_curl_jac_p1": "ns_cell_jacobian_curl_p1_facet",
          "ns_facet_nitsche_p1": "ns_cell_residual_p1_facet",
          "ns_facet_nitsche_jac_p1": "ns_cell_jacobian_p1_facet",
          "ns_facet_cbc_p1": "ns_cell_residual_curl_p1_facet",
          "ns_facet_cbc_jac_p1": "ns_cell_jacobian_curl_p1_facet",
          "ns_facet_ddn_p1": "ns_cell_residual_curl_p1_facet",
          "ns_facet_ddn_jac_p1": "ns_cell_jacobian_curl_p1_facet"}
# one preconditioner application on paths A and amg_p: the port's kernel
# launches (the wrappers' counts) and the device kernels in all (PR 7's
# 177 and 169 less the 31 and 20 K8 launches folded into K1 in PR 8;
# amg_p's node-block Jacobi one kernel, K10, where it was one einsum
# kernel), which a trace of the graph shows at most
GRAPH_KERNELS = {"rasamg_sup": (131, 146), "amg_p": (134, 149)}
PARITY_COUNTS = {"rasamg_sup": [(11, 52), (36, 161)],
                 "amg_p": [(11, 44), (36, 145)],
                 # cfdtpu on the CPU, float64, res 1.0, 2 steps (gmres:
                 # its first step, (11, 180), (36, 575) over two)
                 "path_c": [(11, 53), (36, 151)],
                 "gmres": [(11, 180)]}
# parity runs of fewer steps than 2: gmres's host run took 65-116 s of
# the command's time for 2 steps on an H100's host, its first step a
# quarter of the KSP iterations (and its c_L at step 2, a near
# cancellation, is held to 5e-9 by tests/test_torch_gmres_parity.py)
PARITY_STEPS = {"gmres": 1}
MAX_HOST_LAUNCHES_PER_KSP = 30
# counters that are subsets of another's (a fused variant or an option)
SUBSET_COUNTERS = ("sup_spmv_prolong", "sup_spmv_cheby", "krylov_cgs_scaled",
                   "ns_cell_residual_p1_facet", "ns_cell_jacobian_p1_facet",
                   "ns_cell_residual_bdf2_p1_facet",
                   "ns_cell_jacobian_bdf2_p1_facet",
                   "ns_cell_residual_curl_p1_facet",
                   "ns_cell_jacobian_curl_p1_facet",
                   "ns_cell_residual_p1_tet", "ns_cell_jacobian_p1_tet",
                   *(f"ns_facet_{t}{j}_p1_fused"
                     for t in ("natural", "viscous", "backflow", "weakp",
                               "nitsche", "nitsche_curl", "cbc", "ddn")
                     for j in ("", "_jac")))
# path D: steps per method from rest, then steps under torch.profiler
# (step 5, the one profiled, runs 3 Newton iterations where step 4 runs
# 13-15: its trace is the smaller, and the phase the shorter)
PATH_D_STEPS = 4
PATH_D_PROFILE = 1
# name: (source, replaced TPU/XLA op, headline site, path that launches it)
SOURCES = {
    "sup_spmv": ("cfdtpu_torch/csrc/sup_spmv.cu",
                 "cfdtpu/la/nodebsr.py:258", "K1 full operator", "A"),
    "ell_sum": ("cfdtpu_torch/csrc/ell_sum.cu",
                "cfdtpu/utils/geometry.py:134", "K2 assembly", "A"),
    "ns_cell_residual_p1": ("cfdtpu_torch/csrc/ns_cell_residual.cu",
                            "cfdtpu/forms/navier_stokes.py:190",
                            "K3 cell residual", "A"),
    "ns_cell_jacobian_p1": ("cfdtpu_torch/csrc/ns_cell_residual.cu",
                            "cfdtpu/forms/navier_stokes.py:384",
                            "K3 cell jacobian", "A"),
    "selfp_triple": ("cfdtpu_torch/csrc/selfp_triple.cu",
                     "cfdtpu/la/nodebsr.py:386", "K4 selfp triples", "A"),
    "patch_spmv": ("cfdtpu_torch/csrc/patch_spmv.cu",
                   "scripts/gather_micro.py:55", "K5 patch P=8192 K=8",
                   "B"),
    "ras_apply": ("cfdtpu_torch/csrc/ras_apply.cu", "cfdtpu/la/ras.py:149",
                  "K6 ras apply", "A"),
    "ns_facet_natural_p1": ("cfdtpu_torch/csrc/ns_facet.cu",
                            "cfdtpu/forms/facet_terms.py:52",
                            "K7 facet residual", "A"),
    "ns_facet_natural_jac_p1": ("cfdtpu_torch/csrc/ns_facet.cu",
                                "cfdtpu/forms/navier_stokes.py:369",
                                "K7 facet jacobian", "A"),
    "amg_prolong": ("cfdtpu_torch/csrc/amg_prolong.cu",
                    "cfdtpu/la/amg.py:173", "K8 block-amg L0 base x", "A"),
    "sup_spmv_prolong": ("cfdtpu_torch/csrc/sup_spmv.cu",
                         "cfdtpu/la/amg.py:706",
                         "K1+K8 block-amg L0 residual + xhat base x", "A"),
    "ns_cell_residual_p1_facet": ("cfdtpu_torch/csrc/ns_cell_residual.cu",
                                  "cfdtpu/forms/navier_stokes.py:190",
                                  "K3+K7 residual", "A"),
    "ns_cell_jacobian_p1_facet": ("cfdtpu_torch/csrc/ns_cell_residual.cu",
                                  "cfdtpu/forms/navier_stokes.py:384",
                                  "K3+K7 jacobian", "A"),
    "krylov_cgs": ("cfdtpu_torch/csrc/krylov.cu", "cfdtpu/la/gmres.py:192",
                   "K9 cgs2+givens fgmres j=19", "A"),
    "krylov_lsq": ("cfdtpu_torch/csrc/krylov.cu", "cfdtpu/la/gmres.py:78",
                   "K9 lsq m=5", "A"),
    "sup_spmv_cheby": ("cfdtpu_torch/csrc/sup_spmv.cu",
                       "cfdtpu/la/chebyshev.py:76",
                       "K1 cheby amg L0 step + d stored", "C"),
    "cheby_update": ("cfdtpu_torch/csrc/sup_spmv.cu",
                     "cfdtpu/la/chebyshev.py:76", "cheby_update S stage",
                     "D"),
    "krylov_cgs_scaled": ("cfdtpu_torch/csrc/krylov.cu",
                          "cfdtpu/la/chebyshev.py:45",
                          "K9 scaled norm power step SELFP L0", "C"),
    "block_jacobi": ("cfdtpu_torch/csrc/block_jacobi.cu",
                     "cfdtpu/la/nodebsr.py:187", "K10 u-block apply", "D"),
    "block_jacobi_inv": ("cfdtpu_torch/csrc/block_jacobi.cu",
                         "cfdtpu/la/nodebsr.py:183", "K10 u-block inverses",
                         "D"),
    "amg_gcr2": ("cfdtpu_torch/csrc/amg_gcr2.cu", "cfdtpu/la/amg.py:27",
                 "K11 second BlockAMG L1", "C"),
    "ns_facet_viscous_p1": ("cfdtpu_torch/csrc/ns_facet.cu",
                            "cfdtpu/forms/facet_terms.py:110",
                            "K12 viscous residual viscous_out (E)", "E"),
    "ns_facet_viscous_jac_p1": ("cfdtpu_torch/csrc/ns_facet.cu",
                                "cfdtpu/forms/navier_stokes.py:369",
                                "K12 viscous jacobian viscous_out (E)", "E"),
    "ns_facet_backflow_p1": ("cfdtpu_torch/csrc/ns_facet.cu",
                             "cfdtpu/forms/facet_terms.py:169",
                             "K13 backflow residual backflow_out (E)", "E"),
    "ns_facet_backflow_jac_p1": (
        "cfdtpu_torch/csrc/ns_facet.cu", "cfdtpu/forms/navier_stokes.py:369",
        "K13 backflow jacobian backflow_out (E)", "E"),
    "ns_cell_residual_bdf2_p1": ("cfdtpu_torch/csrc/ns_cell_residual.cu",
                                 "cfdtpu/forms/navier_stokes.py:611",
                                 "K14 cell residual", "F"),
    "ns_cell_jacobian_bdf2_p1": ("cfdtpu_torch/csrc/ns_cell_residual.cu",
                                 "cfdtpu/forms/navier_stokes.py:384",
                                 "K14 cell jacobian", "F"),
    "ns_facet_natural_implicit_p1": (
        "cfdtpu_torch/csrc/ns_facet.cu", "cfdtpu/forms/facet_terms.py:52",
        "K7 implicit facet residual natural_correction (F)", "F"),
    "ns_facet_natural_implicit_jac_p1": (
        "cfdtpu_torch/csrc/ns_facet.cu", "cfdtpu/forms/navier_stokes.py:369",
        "K7 implicit facet jacobian natural_correction (F)", "F"),
    "ns_cell_residual_bdf2_p1_facet": (
        "cfdtpu_torch/csrc/ns_cell_residual.cu",
        "cfdtpu/forms/navier_stokes.py:611", "K14+K7i residual", "F"),
    "ns_cell_jacobian_bdf2_p1_facet": (
        "cfdtpu_torch/csrc/ns_cell_residual.cu",
        "cfdtpu/forms/navier_stokes.py:384", "K14+K7i jacobian", "F"),
    "ns_cell_residual_curl_p1": ("cfdtpu_torch/csrc/ns_cell_residual.cu",
                                 "cfdtpu/forms/navier_stokes.py:695",
                                 "K15 cell residual", "G"),
    "ns_cell_jacobian_curl_p1": ("cfdtpu_torch/csrc/ns_cell_residual.cu",
                                 "cfdtpu/forms/navier_stokes.py:384",
                                 "K15 cell jacobian", "G"),
    "ns_cell_residual_curl_p1_facet": (
        "cfdtpu_torch/csrc/ns_cell_residual.cu",
        "cfdtpu/forms/navier_stokes.py:695", "K15+K16+K17c residual", "G"),
    "ns_cell_jacobian_curl_p1_facet": (
        "cfdtpu_torch/csrc/ns_cell_residual.cu",
        "cfdtpu/forms/navier_stokes.py:384", "K15+K16+K17c jacobian", "G"),
    "ns_facet_weakp_p1": ("cfdtpu_torch/csrc/ns_facet.cu",
                          "cfdtpu/forms/facet_terms.py:97",
                          "K16 weak pressure residual weak_pressure_in (G)",
                          "G"),
    "ns_facet_weakp_jac_p1": (
        "cfdtpu_torch/csrc/ns_facet.cu", "cfdtpu/forms/navier_stokes.py:369",
        "K16 weak pressure jacobian weak_pressure_in (G)", "G"),
    "ns_facet_nitsche_curl_p1": ("cfdtpu_torch/csrc/ns_facet.cu",
                                 "cfdtpu/forms/facet_terms.py:229",
                                 "K17c nitsche curl residual nitsche_in (G)",
                                 "G"),
    "ns_facet_nitsche_curl_jac_p1": (
        "cfdtpu_torch/csrc/ns_facet.cu", "cfdtpu/forms/navier_stokes.py:369",
        "K17c nitsche curl jacobian nitsche_in (G)", "G"),
    "ns_facet_nitsche_p1": ("cfdtpu_torch/csrc/ns_facet.cu",
                            "cfdtpu/forms/facet_terms.py:126",
                            "K17 nitsche residual nitsche_in (H)", "H"),
    "ns_facet_nitsche_jac_p1": ("cfdtpu_torch/csrc/ns_facet.cu",
                                "cfdtpu/forms/navier_stokes.py:369",
                                "K17 nitsche jacobian nitsche_in (H)", "H"),
    "ns_facet_cbc_p1": ("cfdtpu_torch/csrc/ns_facet.cu",
                        "cfdtpu/forms/facet_terms.py:191",
                        "K18 cbc residual cbc_out (I)", "I"),
    "ns_facet_cbc_jac_p1": ("cfdtpu_torch/csrc/ns_facet.cu",
                            "cfdtpu/forms/navier_stokes.py:369",
                            "K18 cbc jacobian cbc_out (I)", "I"),
    "ns_facet_ddn_p1": ("cfdtpu_torch/csrc/ns_facet.cu",
                        "cfdtpu/forms/facet_terms.py:208",
                        "K18 ddn residual ddn_out (I)", "I"),
    "ns_facet_ddn_jac_p1": ("cfdtpu_torch/csrc/ns_facet.cu",
                            "cfdtpu/forms/navier_stokes.py:369",
                            "K18 ddn jacobian ddn_out (I)", "I"),
    "ns_cell_residual_p1_tet": ("cfdtpu_torch/csrc/ns_cell_tet.cu",
                                "cfdtpu/forms/navier_stokes.py:190",
                                "K3+K7 tet residual", "M"),
    "ns_cell_jacobian_p1_tet": ("cfdtpu_torch/csrc/ns_cell_tet.cu",
                                "cfdtpu/forms/navier_stokes.py:384",
                                "K3+K7 tet jacobian", "M"),
    "bsr_spmv": ("cfdtpu_torch/csrc/bsr_spmv.cu",
                 "cfdtpu/la/nodebsr.py:258", "K1 3D node blocks outer",
                 "M"),
}
PATHS = {"A": "rasamg_sup slice (Scenario.solve, 106,275 DOF)",
         "B": "python -m cfdtpu_torch.scripts.gather_micro",
         "C": "rasamg_sup with W + K + Chebyshev (Scenario.solve, 106,275 "
              "DOF)",
         "D": "gmres at 38,607 DOF, chebyshev_p at 4,461 and chebyshev at "
              "1,626 (Scenario.solve)",
         "E": "dfg_2d_1 on DFG2D1Steady (Scenario.solve, 121,515 DOF, "
              "float64)",
         "F": "stabilized_schur_bdf2 on DFG 2D-1 (Scenario.solve, 106,275 "
              "DOF)",
         "G": "stabilized_schur_pressurebc on pipe_cylinder_pressurebc "
              "(Scenario.solve, 106,275 DOF)",
         "H": "stabilized_schur_pressure_backflow on "
              "pipe_cylinder_pressurebc (Scenario.solve, 106,275 DOF)",
         "I": "stabilized_schur_vascularbc_cbc and _ddn on DFG 2D-1 "
              "(Scenario.solve, 106,275 DOF, amg_p)",
         "J": "validate_ghia's lid-driven cavity march "
              "(stabilized_schur_bdf2, 12,675 and 28,227 DOF)",
         "K": "PipeCylinder2D2Simulation (DFG 2D-2, 78,348 DOF) across a "
              "checkpoint and resume",
         "L": "StenosisSimulation (30,789 DOF) and "
              "StenosisWithTree2DPressureSimulation under "
              "stabilized_schur_pressurebc",
         "M": "DFG3DBenchmark, DFG 3D-1Z on P1 tetrahedra (Scenario.solve, "
              "972,072 DOF, amg_p)"}


def log(*a):
    print(*a, flush=True)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


# torch.profiler loses whole traces for a while now and then (a burst of
# empty traces in a full run on an H100, through the end of the
# kernel phase and the first one-launch call): a helper that comes back
# with nothing is asked again, a second apart, a few times
TRACE_TRIES = 5
# spin kernels queued after the call in a one-launch trace
TRACE_PAD = 4
PROFILER_RETRIES = {"device_ms": 0, "launches": 0}


def traced_ms(fn):
    """utils/cudatime.device_ms, asked again while it returns None."""
    from cfdtpu_torch.utils.cudatime import device_ms

    for i in range(TRACE_TRIES):
        ms = device_ms(fn)
        if ms is not None or i == TRACE_TRIES - 1:
            return ms
        PROFILER_RETRIES["device_ms"] += 1
        time.sleep(1.0)


def traced_launches(fn, pad=0):
    """utils/cudatime.launches, asked again while its fullest trace holds
    no device activity (every call traced here issues some)."""
    from cfdtpu_torch.utils.cudatime import launches

    for i in range(TRACE_TRIES):
        calls, names = launches(fn, pad=pad)
        if names or i == TRACE_TRIES - 1:
            return calls, names
        PROFILER_RETRIES["launches"] += 1
        time.sleep(1.0)


def traced_kernels(fn):
    return traced_launches(fn)[1]


# ----------------------------------------------------------------------
def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)}")
    return smi


def phase_build():
    from cfdtpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(force=True)
    _build.library()
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}, one process per "
        f"source: {time.perf_counter() - t0:.2f} s -> {_build.LIB_PATH}")


# ----------------------------------------------------------------------
def developed_state(torch, np, s, seed):
    """A developed-looking state: the inlet profile everywhere plus a
    small perturbation, made with numpy from `seed`."""
    y = s.V.dof_coords[:, 1]
    rng = np.random.default_rng(seed)
    prof = np.stack([1.2 * y * (0.41 - y) / 0.41 ** 2, 0 * y], axis=1)
    n_u, n_p = s.V.num_dofs, s.Q.num_dofs
    return (s.tensor(prof + 0.01 * rng.standard_normal((n_u, 2))),
            s.tensor(prof + 0.01 * rng.standard_normal((n_u, 2))),
            s.tensor(0.01 * rng.standard_normal(n_p)))


def bc_mask_u(torch, np, s):
    m = np.zeros(s.V.num_dofs * 2, dtype=bool)
    for d0 in range(2):
        m[s.bc_dofs_u.astype(np.int64) * 2 + d0] = True
    return torch.as_tensor(m, device=s.device)


def k1_yardstick(torch, A, cols):
    """K1's yardstick: torch.sparse_bsr_tensor(...) @ x over the same
    blocks (the padded slots point at one extra zero block column),
    or, for the views with blocks that are not square and for 1 x 1
    blocks, which BSR products refuse, torch.sparse_csr_tensor(...) @
    x over the same entries."""
    ns, Kg, R, C = A.shape

    def lib():
        dev = A.device
        xd = torch.ones((ns + 1) * C, dtype=A.dtype, device=dev)
        if R == C > 1:
            mat = torch.sparse_bsr_tensor(
                torch.arange(0, ns * Kg + 1, Kg, device=dev),
                cols.reshape(-1).long(),
                A.reshape(ns * Kg, R, C).contiguous(),
                size=(ns * R, (ns + 1) * C))
        else:
            ccol = (cols.long()[:, None, :, None] * C
                    + torch.arange(C, device=dev)).expand(ns, R, Kg, C)
            mat = torch.sparse_csr_tensor(
                torch.arange(0, ns * R * Kg * C + 1, Kg * C, device=dev),
                ccol.reshape(-1),
                A.permute(0, 2, 1, 3).reshape(-1).contiguous(),
                size=(ns * R, (ns + 1) * C))
        return lambda: mat @ xd
    return lib


def bsr_yardstick(torch, nb, coo):
    """K1's node-block mode's yardstick: torch.sparse_bsr_tensor(...) @ x
    over the same 4 x 4 blocks (x node by node)."""
    def lib():
        n = nb.n_nodes
        mat = torch.sparse_bsr_tensor(nb._bsr_rowptr.long(),
                                      nb._bsr_cols.long(), coo,
                                      size=(4 * n, 4 * n))
        xd = torch.ones(4 * n, dtype=coo.dtype, device=coo.device)
        return lambda: mat @ xd
    return lib


def kernel_sites(torch, np, sc, seed=0):
    """One dict per kernel call site at the shapes the two paths give
    each kernel: name, label, kern and plain (the kernel's wrapper and
    its plain version on the same inputs), bytes and flops (what the call
    must move and compute, from its shapes: the *_BYTES functions below),
    and lib, one PyTorch call computing the same function (the library
    yardstick; None where no single call does), which the port never
    calls. `sc` runs the rasamg_sup solver, whose node-BSR holds both the
    SELFP AMG and the velocity BlockAMG with its RAS windows."""
    from cfdtpu_torch.kernels.amg_prolong import (amg_prolong,
                                                  amg_prolong_plain)
    from cfdtpu_torch.kernels.ell_sum import ell_plan, ell_sum, ell_sum_plain
    from cfdtpu_torch.kernels.krylov import (Givens, krylov_cgs,
                                             krylov_cgs_plain, krylov_lsq,
                                             krylov_lsq_plain,
                                             krylov_lsq_tri,
                                             krylov_lsq_tri_plain, tiny)
    from cfdtpu_torch.kernels.ns_cell_residual import (
        ns_cell_jacobian_p1, ns_cell_jacobian_plain, ns_cell_residual_p1,
        ns_cell_residual_plain)
    from cfdtpu_torch.kernels.ns_facet import (
        ns_facet_natural_jac_p1, ns_facet_natural_jac_plain,
        ns_facet_natural_p1, ns_facet_natural_plain)
    from cfdtpu_torch.kernels.patch_spmv import patch_spmv, patch_spmv_plain
    from cfdtpu_torch.kernels.ras_apply import (ras_apply, ras_apply_plain,
                                                ras_plan, ras_windows)
    from cfdtpu_torch.kernels.selfp_triple import (selfp_triple,
                                                   selfp_triple_plain)
    from cfdtpu_torch.kernels.sup_spmv import sup_spmv, sup_spmv_plain
    from cfdtpu_torch.scripts import gather_micro

    s = sc.solver
    f, nb = s.form, s._nodebsr
    amg = nb.sp_amg()
    rng = np.random.default_rng(seed + 1)
    u, up, p = developed_state(torch, np, s, seed)
    prm = s.params()
    A_cells, A_blocks = f.element_jacobians(u, p, (up,), prm)
    vals = nb.assemble(A_cells, A_blocks)
    sp = nb.sp_vals(vals)
    levels, _ = amg.build(sp)
    ras = nb.uu_ras(s.pc_ras_size, s.pc_ras_overlap)
    bamg = nb.uu_amg(fine_smoother=ras)
    blevels, _, ras_inv = bamg.build(nb.uu_vals(vals, bc_mask_u(torch, np,
                                                                  s)))
    n_bad = int((~torch.isfinite(ras_inv)).reshape(ras.n_sub, -1)
                .any(dim=1).sum())
    log(f"[kernels] RAS: {ras.n_sub} windows of m={ras.m} (s={ras.s}, "
        f"o={ras.o}), owned rows kept {tuple(ras_inv.shape)}, "
        f"n_cand={ras._n_cand}, {len(ras._dst)} placed values; windows "
        f"with a non-finite inverse: {n_bad}")
    require(n_bad == 0, f"{n_bad} RAS window inverses are not finite")
    log(f"[kernels] BlockAMG levels (nodes): "
        f"{[m.n for m, _ in bamg.sup]}; layouts (ns, Kg, g*d, g*d): "
        f"{[tuple(lv[0].shape) for lv in blevels]}")
    rand = (lambda *shape: s.tensor(rng.standard_normal(shape)))

    sites = []

    def add(name, label, kern, plain, nbytes, flops, lib=None, reset=None,
            pair=None):
        """pair: for a fused site, the launches it replaces on the same
        inputs (compared bit for bit and timed beside it)."""
        sites.append(dict(name=name, label=label, kern=kern, plain=plain,
                          bytes=nbytes, flops=flops, lib=lib, reset=reset,
                          pair=pair))

    def k1_library(A, cols):
        return k1_yardstick(torch, A, cols)

    def k1(label, A, cols, x, n_out, **kw):
        """A K1 site: kernel and plain version on the same flat operands,
        the library yardstick of k1_library."""
        ns, Kg, R, C = A.shape
        add("sup_spmv", label, lambda: sup_spmv(A, cols, x, n_out, **kw),
            lambda: sup_spmv_plain(A, cols, x, n_out, **kw),
            k1_bytes(A, x, n_out, kw), 2 * ns * Kg * R * C,
            k1_library(A, cols))

    cols = nb._sup.sup_cols
    gd = nb.g * nb.dim
    n_u, n_p = nb.n_u_flat, nb.n_nodes
    v = rand(n_u + n_p)
    vu, vp = v[:n_u], v[n_u:]
    S = vals["sup"]
    k1("K1 full operator", S, cols, v, n_u + n_p, x_split=(n_u, gd),
       y_split=(n_u, gd))
    k1("K1 uu", S[:, :, :gd, :gd], cols, vu, n_u)
    k1("K1 up", S[:, :, :gd, gd:], cols, vp, n_u)
    k1("K1 pu", S[:, :, gd:, :gd], cols, vu, n_p)
    k1("K1 pp", S[:, :, gd:, gd:], cols, vp, n_p)
    k1("K1 p-coupled", S[:, :, :, gd:], cols, vp, n_u + n_p,
       y_split=(n_u, gd))

    # K1's epilogue options at their solver sites (la/schur.py,
    # solvers/stabilized_schur.py): the row masks, the input scale and
    # the residual from another vector
    mask_u = bc_mask_u(torch, np, s)
    mask_p = torch.zeros(n_p, dtype=torch.bool, device=s.device)
    mask_p[torch.as_tensor(s.bc_dofs_p.astype(np.int64),
                           device=s.device)] = True
    scale_u = torch.where(mask_u, 0.0, 1.0 / (1.0 + rand(n_u).abs()))
    bp = rand(n_p)
    k1("K1 outer matvec + mask", S, cols, v, n_u + n_p, x_split=(n_u, gd),
       y_split=(n_u, gd), mask=torch.cat([mask_u, mask_p]), mask_value=v)
    k1("K1 uu + mask (Auu)", S[:, :, :gd, :gd], cols, vu, n_u, mask=mask_u,
       mask_value=vu)
    k1("K1 up + zero mask (Aup)", S[:, :, :gd, gd:], cols, vp, n_u,
       mask=mask_u)
    k1("K1 pu residual (r_p - Apu z_u)", S[:, :, gd:, :gd], cols, vu, n_p,
       mode="residual", b=bp)
    k1("K1 pu residual + scale + mask (S)", S[:, :, gd:, :gd], cols, vu,
       n_p, mode="residual", b=bp, scale=scale_u, mask=mask_p,
       mask_value=vp)

    def k1_levels(tag, lvls, sup, omega):
        for k, (ev, d, sc, _) in enumerate(lvls):
            m = d.shape[0]
            x, b = rand(m), rand(m)
            for mode in ("y", "residual", "jacobi"):
                k1(f"K1 {tag} L{k} {mode} {tuple(ev.shape)}", ev,
                   sup[k][0].sup_cols, x, m, mode=mode, b=b, d=d,
                   omega=omega)
            k1(f"K1 {tag} L{k} residual + scale {tuple(ev.shape)}", ev,
               sup[k][0].sup_cols, b, m, mode="residual", b=b, scale=sc)

    k1_levels("amg", levels, amg.sup, amg.omega)
    k1_levels("block-amg", blevels, bamg.sup, bamg.omega)

    def k8_levels(tag, h, lvls, w):
        """K8 at every level of hierarchy h (values of width w), with the
        iterate as base and with the first pre-smooth's s * b."""
        for k, lvl in enumerate(h.levels):
            sc = lvls[k][2]
            xc, x = rand(lvl.n_coarse * w), rand(lvl.n * w)
            for base, scale in (("x", None), ("s*b", sc)):
                a = (xc, lvl.agg, w, x, scale)
                add("amg_prolong", f"K8 {tag} L{k} base {base}",
                    lambda a=a: amg_prolong(*a),
                    lambda a=a: amg_prolong_plain(*a),
                    nbytes(xc, lvl.agg, x, scale) + nbytes(x),
                    x.numel() * (1 if scale is None else 2),
                    lambda a=a: lambda: torch.index_select(
                        a[0].reshape(-1, a[2]), 0, a[1]))

    k8_levels("amg", amg, levels, 1)
    k8_levels("block-amg", bamg, blevels, bamg.d)

    def k1_prolong_levels(tag, h, lvls, w):
        """K1 with the coarse-grid correction read in its gather (K8
        folded in) at every level of hierarchy h: the first post-smooth
        (mode jacobi) from the base x (n_smooth >= 2) and s * b
        (n_smooth = 1), and on BlockAMG's finest level the RAS smoother's
        residual with xhat stored. Beside each, the pair it replaces (K8,
        then K1 on K8's output); yardstick K1's library call and
        torch.index_select of xc (the gather of K8's)."""
        for k, lvl in enumerate(h.levels):
            ev, d, sc, _ = lvls[k]
            cols_k = h.sup[k][0].sup_cols
            m = d.shape[0]
            xc, x, b = rand(lvl.n_coarse * w), rand(m), rand(m)
            cases = [("jacobi", "x", x, None), ("jacobi", "s*b", b, sc)]
            if w > 1 and k == 0:
                cases.append(("residual + xhat", "x", x, None))
            for mode_l, base_l, base, scale in cases:
                mode = mode_l.split()[0]
                kw = dict(mode=mode, b=b, d=d, omega=h.omega)
                pro = (xc, lvl.agg, w)
                store = mode_l.endswith("xhat")
                xk, xp = (torch.empty_like(base) if store else None
                          for _ in range(2))

                def kern(a=(ev, cols_k, base, m, kw, scale, pro, xk)):
                    A, c, x0, n, kw, sc_, pro_, xh = a
                    y = sup_spmv(A, c, x0, n, scale=sc_, prolong=pro_,
                                 xhat_out=xh, **kw)
                    return y if xh is None else (y, xh)

                def plain(a=(ev, cols_k, base, m, kw, scale, pro, xp)):
                    A, c, x0, n, kw, sc_, pro_, xh = a
                    y = sup_spmv_plain(A, c, x0, n, scale=sc_, prolong=pro_,
                                       xhat_out=xh, **kw)
                    return y if xh is None else (y, xh)

                def pair(a=(ev, cols_k, base, m, kw, scale, pro, store)):
                    A, c, x0, n, kw, sc_, pro_, st = a
                    xh = amg_prolong(*pro_, x0, sc_)
                    y = sup_spmv(A, c, xh, n, **kw)
                    return (y, xh) if st else y

                def lib(a=(ev, cols_k, xc, lvl.agg, w)):
                    mat = k1_library(a[0], a[1])()
                    return lambda: (mat(), torch.index_select(
                        a[2].reshape(-1, a[4]), 0, a[3]))

                ns_, Kg_, R_, C_ = ev.shape
                add("sup_spmv_prolong",
                    f"K1+K8 {tag} L{k} {mode_l} base {base_l}", kern, plain,
                    k1_bytes(ev, base, m, dict(kw, scale=scale))
                    + nbytes(xc, lvl.agg, xk),
                    2 * ns_ * Kg_ * R_ * C_ + m * (1 if scale is None else 2),
                    lib, pair=pair)

    k1_prolong_levels("amg", amg, levels, 1)
    k1_prolong_levels("block-amg", bamg, blevels, bamg.d)

    new_sites(torch, np, s, add, k1_library, rand, amg, levels, bamg,
              blevels, vals)

    def k9_cgs(tag, n, rows, j, reorth, tail):
        """krylov_cgs at step j of a basis of `rows` rows of length n (an
        orthonormal one, from numpy's QR), with FGMRES's Givens tail on a
        cycle state of restart rows - 1 (random rotations and g, which
        reset() restores before each compared call: the tail updates g[j]
        in place). Yardstick: the same step from cuBLAS GEMVs, two a pass
        (h = V u, u - V^T h), then the norm and the scaled store."""
        q, _ = np.linalg.qr(rng.standard_normal((n, rows)))
        Vk, w = s.tensor(q.T.copy()), rand(n)
        Vp = Vk.clone()
        hk, hp = (torch.zeros(rows, dtype=s.dtype, device=s.device)
                  for _ in range(2))
        m = rows - 1
        G0, Gk, Gp = (Givens(m, 1e-30, s.device) if tail else None
                      for _ in range(3))
        if tail:
            th = torch.as_tensor(rng.uniform(0.0, 2.0 * np.pi, m),
                                 device=s.device)
            G0.cs.copy_(torch.cos(th))
            G0.sn.copy_(torch.sin(th))
            G0.g.copy_(torch.as_tensor(rng.standard_normal(m + 1)))
            G0.R.zero_()
            G0.stat.zero_()

        def reset():
            for G in (Gk, Gp):
                for key in ("R", "cs", "sn", "g", "stat"):
                    getattr(G, key).copy_(getattr(G0, key))

        def run(fn, V, h, G):
            fn(V, w, j, h, reorth, G)
            out = (V[j + 1], h[: j + 2])
            if G is not None:
                out += (G.R[j], G.cs[j:j + 1], G.sn[j:j + 1],
                        G.g[j:j + 2], G.stat[j + 1])
            return out

        def lib():
            Va = Vk[: j + 1]
            dst = torch.empty_like(w)
            t = tiny(s.dtype)

            def step():
                u = w
                for _ in range(2 if reorth else 1):
                    u = torch.addmv(u, Va.T, torch.mv(Va, u), alpha=-1.0)
                nrm = torch.linalg.vector_norm(u)
                torch.div(u, nrm.clamp(min=t), out=dst)
            return step

        sz = Vk.element_size()
        passes = 2 if reorth else 1
        # the tail: cs and sn below j and g[j] read; R's row, cs, sn,
        # two of g and stat's row written (float64)
        tail_bytes = (2 * j + 1 + (m + 1) + 6) * 8 if tail else 0
        add("krylov_cgs", f"K9 {tag} j={j}",
            lambda: run(krylov_cgs, Vk, hk, Gk),
            lambda: run(krylov_cgs_plain, Vp, hp, Gp),
            ((j + 1) * n + 2 * n + j + 2) * sz + tail_bytes,
            passes * 4 * (j + 1) * n + 3 * n + (6 * j + 10) * tail, lib,
            reset if tail else None)

    for j in (0, 9, 19):
        k9_cgs("cgs2+givens fgmres", n_u + n_p, 21, j, True, True)
    for j in (0, 4):
        k9_cgs("cgs s-stage", n_p, 6, j, False, False)

    # the triangular mode at the end of an FGMRES cycle (restart 20)
    nf = n_u + n_p
    for j in (5, 20):
        m = 20
        Rn = np.zeros((m, m + 1))
        Rn[:, :m] = (np.triu(rng.standard_normal((m, m)))
                     + 4.0 * np.eye(m)).T
        f64 = dict(dtype=torch.float64, device=s.device)
        ta = (torch.as_tensor(Rn, **f64),
              torch.as_tensor(rng.standard_normal(m + 1), **f64),
              rand(m, nf), rand(nf), j)

        def lib(a=ta):
            R, g, Z, x, j = a
            U, gj, Zj = R[:j, :j].T.contiguous(), g[:j, None], Z[:j]
            return lambda: torch.addmv(x, Zj.T, torch.linalg.solve_triangular(
                U, gj, upper=True)[:, 0].to(Z.dtype))

        add("krylov_lsq", f"K9 lsq tri j={j}",
            lambda a=ta: krylov_lsq_tri(*a),
            lambda a=ta: krylov_lsq_tri_plain(*a),
            nbytes(ta[2][:j], ta[3]) + nbytes(ta[3]) + (j * j + j) * 8,
            2 * j * nf + j * j, lib)

    for m in (5, 20):
        Hn = (np.triu(rng.standard_normal((m + 1, m)), -1)
              + 4.0 * np.eye(m + 1, m))
        la = (s.tensor(Hn), s.tensor([1.3]), rand(m, n_p))

        def lib(Hn=Hn, m=m):
            Hd = torch.as_tensor(Hn, device=s.device)
            HtH = Hd.T @ Hd
            reg = max(float(torch.trace(HtH)) / m, tiny(s.dtype)) * 1e-12
            Mr = HtH + reg * torch.eye(m, dtype=Hd.dtype, device=s.device)
            rhs = Hd[0] * 1.3
            return lambda: torch.linalg.solve_ex(Mr, rhs)

        add("krylov_lsq", f"K9 lsq m={m}", lambda a=la: krylov_lsq(*a),
            lambda a=la: krylov_lsq_plain(*a), nbytes(*la) + nbytes(la[2][0]),
            2 * m * n_p + 2 * m * m * (m + 1) + m ** 3, lib)

    def k2(label, scat, shape):
        """A K2 site; yardstick zeros.index_add_(0, dst, src) with dst
        the scatter's destination of each source row."""
        src = rand(scat.n_in, *shape)
        rp, pos, K = scat.row_ptr, scat.pos, scat.K
        F = int(np.prod(shape)) if shape else 1
        cnt = (rp[1:] - rp[:-1]).long()
        log(f"[kernels] {label}: src {tuple(src.shape)} -> {scat.n_out} "
            f"rows, mean {scat.n_in / max(scat.n_out, 1):.2f} and largest "
            f"{K} contributions, (lanes per output, loads per round) "
            f"{ell_plan(scat.n_out, F, scat.n_in, K)}")

        def lib():
            dst = torch.empty(scat.n_in, dtype=torch.long, device=src.device)
            dst[pos.long()] = torch.repeat_interleave(
                torch.arange(scat.n_out, device=src.device), cnt)
            buf = torch.zeros((scat.n_out,) + tuple(shape), dtype=src.dtype,
                              device=src.device)
            return lambda: buf.index_add_(0, dst, src)

        add("ell_sum", label, lambda: ell_sum(src, rp, pos, K),
            lambda: ell_sum_plain(src, rp, pos, K),
            k2_bytes(src, rp, pos), scat.n_in * F, lib)

    k2("K2 residual u", f._scatter_u, (2,))
    k2("K2 residual p", f._scatter_p, ())
    k2("K2 facet residual u", f._facet_blocks[0]["scatter_u"], (2,))
    k2("K2 assembly", nb._assemble_scatter, (9,))
    k2("K2 selfp", nb._sp_scatter, ())
    for k, lvl in enumerate(amg.levels):
        k2(f"K2 amg restrict L{k}", lvl._restrict, ())
        k2(f"K2 amg coarsen L{k}", lvl._coarsen, ())
    for k, lvl in enumerate(bamg.levels):
        k2(f"K2 block restrict L{k}", lvl._restrict, (bamg.d,))
        k2(f"K2 block coarsen L{k}", lvl._coarsen, (bamg.d, bamg.d))

    args = (u, up, p, f.dofmap_u, f.dofmap_p, f.cell_coords, f.cell_h,
            f.tabs, prm["rho"], prm["mu"], prm["dt"], prm["f"], f.eps)
    ru_e, rp_e = ns_cell_residual_p1(*args)
    add("ns_cell_residual_p1", "K3 cell residual",
        lambda: ns_cell_residual_p1(*args),
        lambda: ns_cell_residual_plain(*args),
        k3_bytes(args[:8], (ru_e, rp_e)), k3_ops(f, K3_OPS))
    add("ns_cell_jacobian_p1", "K3 cell jacobian",
        lambda: ns_cell_jacobian_p1(*args),
        lambda: ns_cell_jacobian_plain(*args),
        k3_bytes(args[:8], (A_cells,)),
        k3_ops(f, K3_OPS) + 3 * k3_ops(f, K3_JAC_TANGENT_OPS))
    fb = f._facet_blocks[0]
    fargs = f._fused_args(fb, u, p, (up,), prm)
    nf, nqf = fb["tabs"]["dS"].shape
    k7_res, k7_jac = (facet_bytes(fargs, "natural", False, jac)
                      for jac in (False, True))
    add("ns_facet_natural_p1", "K7 facet residual",
        lambda: ns_facet_natural_p1(*fargs),
        lambda: ns_facet_natural_plain(*fargs),
        k7_res[0], nf * (K7_OPS[0] + nqf * K7_OPS[1]))
    add("ns_facet_natural_jac_p1", "K7 facet jacobian",
        lambda: ns_facet_natural_jac_p1(*fargs),
        lambda: ns_facet_natural_jac_plain(*fargs),
        k7_jac[0], 9 * nf * (K7_JAC_OPS[0] + nqf * K7_JAC_OPS[1]))
    # K3 with the facet block in its launch (K7's bodies after the cells'
    # blocks), as the form calls it; beside it the two launches it
    # replaces. Its bytes: K3's and K7's, less the facet dofs' u, u_prev
    # and p, which K3's count of u, u_prev and p holds already
    facet = [f._kernel_block(fb, prm)]
    add("ns_cell_residual_p1_facet", "K3+K7 residual",
        lambda: ns_cell_residual_p1(*args, facets=facet),
        lambda: (*ns_cell_residual_plain(*args),
                 ns_facet_natural_plain(*fargs)),
        k3_bytes(args[:8], (ru_e, rp_e)) + k7_res[0] - k7_res[1],
        k3_ops(f, K3_OPS) + nf * (K7_OPS[0] + nqf * K7_OPS[1]),
        pair=lambda: (*ns_cell_residual_p1(*args),
                      ns_facet_natural_p1(*fargs)))
    add("ns_cell_jacobian_p1_facet", "K3+K7 jacobian",
        lambda: ns_cell_jacobian_p1(*args, facets=facet),
        lambda: (ns_cell_jacobian_plain(*args),
                 ns_facet_natural_jac_plain(*fargs)),
        k3_bytes(args[:8], (A_cells,)) + k7_jac[0] - k7_jac[1],
        k3_ops(f, K3_OPS) + 3 * k3_ops(f, K3_JAC_TANGENT_OPS)
        + 9 * nf * (K7_JAC_OPS[0] + nqf * K7_JAC_OPS[1]),
        pair=lambda: (ns_cell_jacobian_p1(*args),
                      ns_facet_natural_jac_p1(*fargs)))
    inv = rand(nb.n_nodes, nb.dim)
    coo_v = vals["coo"]
    sargs = (coo_v, nb._sp_e1, nb._sp_e2, nb._sp_K, inv)
    add("selfp_triple", "K4 selfp triples", lambda: selfp_triple(*sargs),
        lambda: selfp_triple_plain(*sargs), k4_bytes(*sargs),
        3 * nb.dim * nb._sp_e1.shape[0])

    for P, K in gather_micro.PATCH_SHAPES:
        xp, vp, ip = (t.to(s.dtype) if t.is_floating_point() else t
                      for t in gather_micro.patch_inputs(P, K, s.device))

        def lib(xp=xp, vp=vp, ip=ip):
            Pp, L, Kp = vp.shape
            col = (torch.arange(Pp, device=ip.device)[:, None, None] * L
                   + ip.long()).reshape(-1)
            csr = torch.sparse_csr_tensor(
                torch.arange(0, Pp * L * Kp + 1, Kp, device=ip.device), col,
                vp.reshape(-1), size=(Pp * L, Pp * L))
            xf = xp.reshape(-1)
            return lambda: csr @ xf

        add("patch_spmv", f"K5 patch P={P} K={K}",
            lambda a=(xp, vp, ip): patch_spmv(*a),
            lambda a=(xp, vp, ip): patch_spmv_plain(*a),
            sum(t.numel() * t.element_size() for t in (xp, vp, ip))
            + xp.numel() * xp.element_size(), 2 * vp.numel(), lib)
        k1(f"K1 width 1 patch P={P} K={K}",
           *gather_micro.k1_operands(xp, vp, ip), xp.numel())

    rx, rb = rand(nb.n_u_flat), rand(nb.n_u_flat)
    rargs = (ras_inv, rx, ras.s, ras.o, ras.d)
    plan = ras_plan(rx.shape[0], ras.s * ras.d, ras.m,
                    ras_inv.element_size(), ras_inv.data_ptr(),
                    torch.cuda.get_device_properties(
                        rx.device).multi_processor_count)
    log(f"[kernels] K6 plan (rows per block, blocks, bulk copies): {plan}")

    def lib():
        xw = ras_windows(rx, ras.n_sub, ras.s, ras.o,
                         ras.d).contiguous()[:, :, None]
        return lambda: torch.bmm(ras_inv, xw)

    for label, base in (("K6 ras apply", None), ("K6 ras apply + x", rb)):
        add("ras_apply", label,
            lambda b=base: ras_apply(*rargs, base=b),
            lambda b=base: ras_apply_plain(*rargs, base=b),
            k6_bytes(ras_inv, rx, base), 2 * ras_inv.numel(), lib)
    return sites


def new_sites(torch, np, s, add, k1_library, rand, amg, levels, bamg,
              blevels, vals):
    """The sites of the AMG cycle family and the non-AMG inner methods:
    K1's cheby mode at the SELFP AMG's L0 and BlockAMG's L1 (the first
    step from x0 = w b, read through K1's input scale; a later step with
    d stored; the first post-smoothing step reading x + P xc in its
    gather; a last step with the W-cycle's add), cheby_update at the S
    stage, K9's scaled normalisation at the power iteration (the SELFP
    AMG's L0 and the u-block), K10 on the u-block (its inverses and its
    apply) and at the S stage (v / d_p), and K11's two launches at the
    coarse levels the K-cycle runs on (SELFP L1, BlockAMG L1), where the
    hierarchy has them. Yardsticks: K1's library product plus the update
    in torch ops; torch.linalg.vector_norm and a divide (K9);
    torch.linalg.inv and torch.bmm (K10's inverses and apply), torch.div
    (v / d_p); the same GCR(2) step from torch.dot and torch.add calls
    (K11; its coefficients read once beforehand, outside the timing)."""
    from cfdtpu_torch.kernels.amg_gcr2 import (gcr2_first, gcr2_first_plain,
                                               gcr2_second,
                                               gcr2_second_plain)
    from cfdtpu_torch.kernels.block_jacobi import (block_jacobi,
                                                   block_jacobi_inv,
                                                   block_jacobi_inv_plain,
                                                   block_jacobi_plain)
    from cfdtpu_torch.kernels.krylov import (krylov_cgs, krylov_cgs_plain,
                                             tiny)
    from cfdtpu_torch.kernels.sup_spmv import (cheby_update,
                                               cheby_update_plain, sup_spmv,
                                               sup_spmv_plain)
    from cfdtpu_torch.la.chebyshev import (cheby_coeffs, cheby_scale,
                                           estimate_lambda_max)

    nb = s._nodebsr
    sz = vals["sup"].element_size()
    (a1, c1), (a2, c2) = cheby_coeffs(3, 0.25)
    for tag, h, lvls, k in (("amg", amg, levels, 0),
                            ("block-amg", bamg, blevels, 1)):
        if k >= len(h.levels):
            continue
        ev, d, _, _ = lvls[k]
        n = d.shape[0]
        cols = h.sup[k][0].sup_cols
        inv = 1.0 / d
        lam = estimate_lambda_max(lambda v, k=k, ev=ev, h=h:
                                  h._matvec(k, ev, v), inv)
        w = cheby_scale(inv, lam, 0.25)
        x, b, dp, ad = rand(n), rand(n), rand(n), rand(n)
        pro = (rand(h.levels[k].n_coarse * h.width), h.levels[k].agg,
               h.width)
        cases = [
            ("from w*b", dict(x=b, scale=w, cheb=(w, None, a1, c1))),
            ("step + d stored", dict(x=x, cheb=(w, dp, a2, c2),
                                     d_out=True)),
            ("post reads x + P xc", dict(x=x, cheb=(w, None, 0.0, 1.0),
                                         prolong=pro, d_out=True)),
            ("last step + W add", dict(x=x, cheb=(w, dp, a2, c2), add=ad)),
        ]
        for label, c in cases:
            c = dict(c)
            x0 = c.pop("x")
            store = c.pop("d_out", False)
            dk, dpl = (torch.empty_like(b) if store else None
                       for _ in range(2))
            kw = dict(mode="cheby", b=b, **c)

            def kern(a=(ev, cols, x0, n, kw, dk)):
                y = sup_spmv(*a[:4], d_out=a[5], **a[4])
                return y if a[5] is None else (y, a[5])

            def plain(a=(ev, cols, x0, n, kw, dpl)):
                y = sup_spmv_plain(*a[:4], d_out=a[5], **a[4])
                return y if a[5] is None else (y, a[5])

            def lib(a=(ev, cols, x0, b, w, dp, c["cheb"])):
                mat = k1_library(a[0], a[1])()
                _, _, x_, b_, w_, dp_, (_, _, ca, cc) = a
                n_ = x_.shape[0]
                return lambda: torch.add(x_, torch.add(
                    torch.mul(dp_, ca), torch.mul(w_, b_ - mat()[:n_]),
                    alpha=cc))

            ns_, Kg_, R_, C_ = ev.shape
            extra = nbytes(b, w, c["cheb"][1], c.get("add"), dk)
            if "prolong" in c:
                extra += nbytes(pro[0], pro[1])
            add("sup_spmv_cheby", f"K1 cheby {tag} L{k} {label}", kern,
                plain, k1_bytes(ev, x0, n, dict(scale=c.get("scale")))
                + extra, 2 * ns_ * Kg_ * R_ * C_ + 7 * n, lib)

    # cheby_update at the S stage (the SELFP S is two K1 launches)
    n_p, n_u = nb.n_nodes, nb.n_u_flat
    ua = tuple(rand(n_p) for _ in range(5))
    du, dpu = (torch.empty_like(ua[0]) for _ in range(2))
    add("cheby_update", "cheby_update S stage",
        lambda: (cheby_update(*ua, a2, c2, du), du),
        lambda: (cheby_update_plain(*ua, a2, c2, dpu), dpu),
        nbytes(*ua) + 2 * n_p * sz, 6 * n_p)

    # K9's scaled normalisation: one power-iteration step
    for tag, n in (("SELFP L0", levels[0][1].shape[0]), ("u-block", n_u)):
        wv, sv = rand(n), rand(n).abs()
        Vk, Vp = (torch.empty((1, n), dtype=s.dtype, device=s.device)
                  for _ in range(2))
        hk, hp = (torch.empty(1, dtype=s.dtype, device=s.device)
                  for _ in range(2))

        def lib(wv=wv, sv=sv):
            dst, t = torch.empty_like(wv), tiny(wv.dtype)

            def step():
                u = sv * wv
                torch.div(u, torch.linalg.vector_norm(u).clamp(min=t),
                          out=dst)
            return step

        add("krylov_cgs_scaled", f"K9 scaled norm power step {tag}",
            lambda a=(Vk, wv, hk, sv): (krylov_cgs(a[0], a[1], -1, a[2],
                                                   False, scale=a[3]),
                                        a[0], a[2])[1:],
            lambda a=(Vp, wv, hp, sv): (krylov_cgs_plain(
                a[0], a[1], -1, a[2], False, scale=a[3]), a[0], a[2])[1:],
            nbytes(wv, sv, Vk, hk), 3 * n, lib)

    # K10: the u-block's inverses and apply, the S stage's v / d_p
    mask_u = bc_mask_u(torch, np, s)
    coo = vals["coo"]
    iargs = (coo, nb._diag_pos, mask_u, nb.dim)
    db = coo[nb._diag_pos][:, :nb.dim, :nb.dim].contiguous()
    add("block_jacobi_inv", "K10 u-block inverses",
        lambda: block_jacobi_inv(*iargs),
        lambda: block_jacobi_inv_plain(*iargs),
        nbytes(db, nb._diag_pos, mask_u) + nbytes(db), 14 * nb.n_nodes,
        lambda: lambda: torch.linalg.inv(db))
    binv = block_jacobi_inv(*iargs)
    vu = rand(n_u)
    add("block_jacobi", "K10 u-block apply",
        lambda: block_jacobi(binv, vu), lambda: block_jacobi_plain(binv, vu),
        nbytes(binv, vu) + nbytes(vu), 2 * nb.dim * n_u,
        lambda: lambda: torch.bmm(binv, vu.reshape(-1, nb.dim, 1)))
    dpv, vp = (1.0 + rand(n_p).abs()).reshape(-1, 1, 1), rand(n_p)
    add("block_jacobi", "K10 S stage v / d_p",
        lambda: block_jacobi(dpv, vp, True),
        lambda: block_jacobi_plain(dpv, vp, True),
        nbytes(dpv, vp) + nbytes(vp), n_p,
        lambda: lambda: torch.div(vp, dpv.reshape(-1)))

    # K11 where the K-cycle runs: coarse levels k = 1 < the coarsest
    for tag, h in (("SELFP", amg), ("BlockAMG", bamg)):
        if len(h.levels) < 2:
            continue
        n = h.coo[1][2] * h.width
        q1, b, q2, z1, z2 = (rand(n) for _ in range(5))
        r, coef = gcr2_first(q1, b)
        rp, cp = gcr2_first_plain(q1, b)
        a1f, q1q1 = float(coef[1]), float(coef[0])
        bf = float(torch.dot(q1, q2)) / q1q1
        qq = q2 - bf * q1
        a2f = float(torch.dot(qq, r)) / max(float(torch.dot(qq, qq)),
                                            tiny(s.dtype))

        def lib1(q1=q1, b=b, a1f=a1f):
            return lambda: (torch.dot(q1, q1), torch.dot(q1, b),
                            torch.add(b, q1, alpha=-a1f))

        def lib2(a=(q1, q2, z1, z2, r, bf, a1f, a2f)):
            q1_, q2_, z1_, z2_, r_, bf_, a1_, a2_ = a

            def step():
                torch.dot(q1_, q2_)
                q = torch.add(q2_, q1_, alpha=-bf_)
                torch.dot(q, q)
                torch.dot(q, r_)
                zz = torch.add(z2_, z1_, alpha=-bf_)
                return torch.add(torch.mul(z1_, a1_), zz, alpha=a2_)
            return step

        add("amg_gcr2", f"K11 first {tag} L1",
            lambda a=(q1, b): gcr2_first(*a),
            lambda a=(q1, b): gcr2_first_plain(*a),
            nbytes(q1, b, r, coef), 6 * n, lib1)
        add("amg_gcr2", f"K11 second {tag} L1",
            lambda a=(q1, q2, z1, z2, r, coef): gcr2_second(*a),
            lambda a=(q1, q2, z1, z2, rp, cp): gcr2_second_plain(*a),
            nbytes(q1, q2, z1, z2, r, coef) + nbytes(z1), 13 * n, lib2)


HBM_TBPS = 3.35  # an H100 SXM's device memory, TB/s (data sheet)
FP32_TFLOPS = 67.0  # its float32 rate outside the tensor cores (data sheet)
# Operations (outside the point loop, per quadrature point), counted
# from the sources with each add, multiply, reciprocal, reciprocal
# square root, min and max as one. K3 (csrc/ns_cell_residual.cu, whose
# header itemises both counts): the residual per cell; the Jacobian
# needs the same values once a cell plus, for each of its three lanes
# (three tangents each), the tangent operations whose result is not
# structurally zero. The dual numbers as written do more (398 and 405 a
# lane, values included): that is the implementation's count, not the
# function's, and is not what the bound is made of. K7
# (csrc/ns_facet.cu): per facet, and per column of a facet
# (nine lanes a facet, one tangent each; on dual numbers of n tangents
# a sum of duals or a dual times a plain number is 1 + n and a product
# of duals 1 + 3n).
K3_OPS = (161, 117)
K3_JAC_TANGENT_OPS = (117, 148)
K7_OPS = (12, 103)
K7_JAC_OPS = (12, 154)
# K12 and K13 (csrc/ns_facet.cu, whose header itemises the residuals'):
# per facet, and per column of a facet on dual numbers of one tangent
K12_OPS = (12, 93)
K12_JAC_OPS = (12, 137)
K13_OPS = (12, 45)
K13_JAC_OPS = (12, 70)
# K15 (csrc/ns_cell_residual.cu's header): K3's counts with the curl
# body's differences, the residual's outside the loop and a point; its
# Jacobian's tangent work as K3's less the stress's 8 and plus omega's
# 3 outside the loop, less the convection's 4 and plus |u_mid|^2's 6 a
# point. K16-K18 (csrc/ns_facet.cu's header): per facet and per point;
# the Jacobians per column, every operation after the geometry (46) on
# a value and its one tangent; K16's Jacobian is zero and needs none.
K15_OPS = (156, 118)
K15_JAC_TANGENT_OPS = (112, 150)
K16_OPS = (12, 17)
K16_JAC_OPS = (0, 0)
K17_OPS = (14, 170)
K17_JAC_OPS = (14, 294)
K17C_OPS = (14, 136)
K17C_JAC_OPS = (14, 226)
K18_CBC_OPS = (12, 42)
K18_CBC_JAC_OPS = (12, 67)
K18_DDN_OPS = K13_OPS
K18_DDN_JAC_OPS = K13_JAC_OPS


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def k1_bytes(A, x, n_out, kw):
    """K1_BYTES, the bytes one K1 call must move: the values of the view
    (ns*Kg*R*C), the column indices (ns*Kg int32), the gathered vector x
    and the output y once each, plus b (residual, jacobi) and d (jacobi)
    read by the epilogue, and the input scale (x's length), the row mask
    (a byte a row) and the mask values where the call takes them."""
    ns, Kg, R, C = A.shape
    sz = A.element_size()
    epi = {"y": 0, "residual": 1, "jacobi": 2}[kw.get("mode", "y")]
    return (ns * Kg * R * C * sz + ns * Kg * 4 + x.numel() * sz
            + (1 + epi) * n_out * sz
            + nbytes(kw.get("scale"), kw.get("mask"), kw.get("mask_value")))


def bsr_bytes(nb, coo, x, n_out, nv, kw):
    """K1's node-block mode: the nv values a block of the view (its rows
    times its columns; a row read is 16 bytes, so a view's sectors may
    hold more), the block columns (int32), the row pointer (int32, n +
    1), x and y once each, plus b (residual) and the scale, row mask and
    mask values where the call takes them. The outer operator's count is
    the node-block sparsity's bytes spmv_roofline divides by."""
    sz = coo.element_size()
    epi = {"y": 0, "residual": 1}[kw.get("mode", "y")]
    return (nb.n_blocks * (nv * sz + 4) + (nb.n_nodes + 1) * 4
            + x.numel() * sz + (1 + epi) * n_out * sz
            + nbytes(kw.get("scale"), kw.get("mask"), kw.get("mask_value")))


def k2_bytes(src, row_ptr, pos):
    """K2: every source row once (pos lists each once), the CSR offsets
    and positions, and the output."""
    n_out = row_ptr.shape[0] - 1
    return (nbytes(src, row_ptr, pos)
            + n_out * (src.numel() // max(src.shape[0], 1))
            * src.element_size())


def k3_bytes(inputs, outputs):
    """K3: u, u_prev, p, the dofmap (V and Q share it on the P1 path,
    and the kernels read it once), cell coordinates and sizes, the basis
    tables, and the outputs once each."""
    u, up, p, dmu, _, coords, h, tabs = inputs
    return nbytes(u, up, p, dmu, coords, h, tabs.qw, tabs.phi_u,
                  tabs.dphi_u, *outputs)


def k3_ops(form, ops):
    return form.cell_h.shape[0] * (ops[0] + form.tabs.qw.shape[0] * ops[1])


# what a facet term's function reads besides its output: (the per-facet
# tables, the block's arrays and the values gathered for each of a
# facet's three dofs at the midpoint and at u for its residual; the
# arrays and values for its Jacobian). Every term is linear in u and p,
# so a Jacobian reads no value but backflow's u_prev.
FACET_TABLES = ("phi_u", "dphi_u", "phi_p", "gdphi", "normal", "dS")
FACET_READS = {
    "natural": (FACET_TABLES, ("dofmap_u", "dofmap_p", "coords"), (5, 3),
                ("coords",), 0),
    "viscous": (("phi_u", "dphi_u", "gdphi", "normal", "dS"),
                ("dofmap_u", "coords"), (4, 2), ("coords",), 0),
    "backflow": (("phi_u", "normal", "dS"), ("dofmap_u",), (4, 4),
                 ("dofmap_u",), 2),
    "weakp": (("phi_u", "normal", "dS"), (), (0, 0), (), 0),
    "nitsche": (("phi_u", "dphi_u", "gdphi", "normal", "dS", "h"),
                ("dofmap_u", "coords"), (4, 2), ("coords",), 0),
    "nitsche_curl": (("phi_u", "dphi_u", "gdphi", "normal", "dS", "h"),
                     ("dofmap_u", "coords"), (4, 2), ("coords",), 0),
    "cbc": (("phi_u", "normal", "dS"), ("dofmap_u",), (4, 4), ("dofmap_u",),
            2),
    "ddn": (("phi_u", "normal", "dS"), ("dofmap_u",), (4, 4), ("dofmap_u",),
            2),
}


def facet_bytes(fargs, term, implicit, jacobian):
    """(bytes, gathered): what a facet term alone must move, its tables,
    arrays and gathered values (FACET_READS) and its output (ru_f or
    A_f) once each; `gathered`, the bytes of those values, which an
    element kernel that carries the block reads with the cells'
    vectors."""
    u, _, _, dmu, dmp, coords, tabs = fargs[:7]
    keys, arrays, vals, jarrays, jvals = FACET_READS[term]
    have = {"dofmap_u": dmu, "dofmap_p": dmp, "coords": coords}
    nf, sz = dmu.shape[0], u.element_size()
    gathered = nf * 3 * (jvals if jacobian else vals[bool(implicit)]) * sz
    return (nbytes(*(have[a] for a in (jarrays if jacobian else arrays)),
                   *(tabs[k] for k in keys))
            + gathered + nf * (81 if jacobian else 6) * sz, gathered)


def k4_bytes(vals, e1, e2, kcol, inv):
    """K4: the 2d values of each node block that the product reads (row d
    and column d, not the uu part), the three index arrays, the inverse
    diagonal and the output."""
    d = inv.shape[1]
    return (vals.shape[0] * 2 * d * vals.element_size()
            + nbytes(e1, e2, kcol, inv) + e1.shape[0] * vals.element_size())


def k6_bytes(inv, x, base):
    """K6: the owned inverse rows, x, the output and (mode 1) base."""
    return nbytes(inv, x, base) + nbytes(x)


def bound_ms(n_bytes, flops):
    """(least time in ms, "bytes" or "operations"): bytes at HBM_TBPS,
    operations at FP32_TFLOPS, the larger of the two."""
    tb = n_bytes / (HBM_TBPS * 1e12) * 1e3
    to = flops / (FP32_TFLOPS * 1e12) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def flat_outputs(out):
    return out if isinstance(out, tuple) else (out,)


def backflow_state(torch, np, s, seed, dtype):
    """A developed state with backflow: the inlet profile less 0.1 (so
    u_prev.n < 0 near the outlet's walls) plus noise, for u, u_prev and
    u_prev2; p small; made with numpy from `seed`, in `dtype`."""
    y = s.V.dof_coords[:, 1]
    rng = np.random.default_rng(seed)
    prof = np.stack([1.2 * y * (0.41 - y) / 0.41 ** 2 - 0.1, 0 * y], axis=1)
    n_u, n_p = s.V.num_dofs, s.Q.num_dofs
    out = [s.tensor(prof + 0.02 * rng.standard_normal((n_u, 2)))
           for _ in range(3)]
    out.append(s.tensor(0.1 * rng.standard_normal(n_p)))
    return tuple(t.to(dtype).contiguous() for t in out)


# each facet term's label in the kernel phase, and its operations
# (residual, Jacobian) per facet and per point
TERM_SITE = {"viscous": ("K12 viscous", K12_OPS, K12_JAC_OPS),
             "backflow": ("K13 backflow", K13_OPS, K13_JAC_OPS),
             "natural": ("K7 implicit facet", K7_OPS, K7_JAC_OPS),
             "weakp": ("K16 weak pressure", K16_OPS, K16_JAC_OPS),
             "nitsche": ("K17 nitsche", K17_OPS, K17_JAC_OPS),
             "nitsche_curl": ("K17c nitsche curl", K17C_OPS, K17C_JAC_OPS),
             "cbc": ("K18 cbc", K18_CBC_OPS, K18_CBC_JAC_OPS),
             "ddn": ("K18 ddn", K18_DDN_OPS, K18_DDN_JAC_OPS)}


def variant_sites(torch, np, s, dtype, tag):
    """The sites of the solver variants' kernels at the solver's shapes,
    in `dtype`: each facet block's term alone (residual and Jacobian;
    a term on two blocks, at each) and the element kernel with every
    block in its launch beside the launches it replaces. `tag`: E (the
    dfg_2d_1 solver: K12, K13, K3 with both), F (BDF2: K7's implicit
    mode, K14 alone and with it), G (stabilized_schur_pressurebc: K16 and
    K17's curl form on the inlet and the outlet, K15 alone and with the
    four), H (stabilized_schur_pressure_backflow: K16, K17, K12 and K13,
    K3 with the five), I (vascularbc_cbc or _ddn: K18, K15 with it). The
    state has reverse flow on part of the outlet (backflow_state)."""
    from cfdtpu_torch.forms import StabilizedNSFormCurlCurl
    from cfdtpu_torch.kernels import ns_cell_residual as k3
    from cfdtpu_torch.kernels.ns_facet import (FacetBlock, facet_call,
                                               facet_jac_plain, facet_plain)

    sites = []

    def add(name, label, kern, plain, n_bytes, flops, pair=None):
        sites.append(dict(name=name, label=label, kern=kern, plain=plain,
                          bytes=n_bytes, flops=flops, lib=None, reset=None,
                          pair=pair))

    f, prm = s.form, s.params()
    bdf2 = f.N_AUX == 2
    curl = isinstance(f, StabilizedNSFormCurlCurl)
    if bdf2:
        s._bdf = (1.5, -2.0, 0.5)
        prm = s.params()
    cast = (lambda t: t.to(dtype).contiguous())
    u, up, up2, p = backflow_state(torch, np, s, 21, dtype)
    tabs = type(f.tabs)(**{k: (cast(v) if torch.is_tensor(v) else v)
                           for k, v in vars(f.tabs).items()})
    eps = float(np.finfo(str(dtype)[6:]).resolution)
    cell = (f.dofmap_u, f.dofmap_p, cast(f.cell_coords), cast(f.cell_h),
            tabs, prm["rho"], prm["mu"], prm["dt"], prm["f"], eps)
    names = [b["name"] for b in f._facet_blocks]
    blocks = [FacetBlock(b["term"], b["dofmap_u32"], b["dofmap_p32"],
                         cast(b["coords"]),
                         {k: cast(v) for k, v in b["tabs"].items()},
                         b["term"].scalars(prm)) for b in f._facet_blocks]
    alone, f_bytes, f_flops, shared = [], [0, 0], [0, 0], [0, 0]
    for name, b in zip(names, blocks):
        fargs = (u, up, p, *b.args())
        term = b.term
        nf, nqf = b.tabs["dS"].shape
        label, ops, jops = TERM_SITE[term.term]
        kname = term.counter(False)
        if term.implicit and term.term == "natural":
            kname = K7_IMPLICIT
        (nb_r, g_r), (nb_j, g_j) = (
            facet_bytes(fargs, term.term, term.implicit, jac)
            for jac in (False, True))
        fl_r, fl_j = (nf * (ops[0] + nqf * ops[1]),
                      9 * nf * (jops[0] + nqf * jops[1]))
        for jac, nm, nb_, fl_ in ((False, kname, nb_r, fl_r),
                                  (True, kname.replace("_p1", "_jac_p1"),
                                   nb_j, fl_j)):
            add(nm, f"{label} {'jacobian' if jac else 'residual'} {name} "
                f"({tag})",
                lambda jac=jac, b=b, fa=fargs: facet_call(
                    b.term, b.scalars, jac, *fa),
                lambda jac=jac, b=b, fa=fargs: (
                    facet_jac_plain if jac else facet_plain)(
                        b.term, b.scalars, *fa), nb_, fl_)
        alone.append((b, fargs))
        f_bytes = [f_bytes[0] + nb_r, f_bytes[1] + nb_j]
        f_flops = [f_flops[0] + fl_r, f_flops[1] + fl_j]
        shared = [shared[0] + g_r, shared[1] + g_j]
    ops, jops = ((K15_OPS, K15_JAC_TANGENT_OPS) if curl
                 else (K3_OPS, K3_JAC_TANGENT_OPS))
    if bdf2:
        args = (u, up, up2, p, *cell, (prm["bdf_a0"], prm["bdf_a1"],
                                       prm["bdf_a2"]))
        res, jac = k3.ns_cell_residual_bdf2_p1, k3.ns_cell_jacobian_bdf2_p1
        res_plain = k3.ns_cell_residual_bdf2_plain
        jac_plain = k3.ns_cell_jacobian_bdf2_plain
        cells = (u, up, p, *cell[:5])
        ru_e, rp_e = res(*args)
        nb_res = k3_bytes(cells, (ru_e, rp_e)) + nbytes(up2)
        nb_jac = (k3_bytes(cells, ()) + nbytes(up2)
                  + ru_e.shape[0] * 81 * u.element_size())
        cell_sites = ("ns_cell_residual_bdf2_p1", "ns_cell_jacobian_bdf2_p1",
                      "K14")
        fused = ("ns_cell_residual_bdf2_p1_facet",
                 "ns_cell_jacobian_bdf2_p1_facet", "K14+K7i")
    else:
        args = (u, up, p, *cell)
        if curl:
            res, jac = k3.ns_cell_residual_curl_p1, k3.ns_cell_jacobian_curl_p1
            res_plain = k3.ns_cell_residual_curl_plain
            jac_plain = k3.ns_cell_jacobian_curl_plain
            key = "curl_p1"
        else:
            res, jac = k3.ns_cell_residual_p1, k3.ns_cell_jacobian_p1
            res_plain = k3.ns_cell_residual_plain
            jac_plain = k3.ns_cell_jacobian_plain
            key = "p1"
        ru_e, rp_e = res(*args)
        nb_res = k3_bytes(args[:8], (ru_e, rp_e))
        nb_jac = (k3_bytes(args[:8], ())
                  + ru_e.shape[0] * 81 * u.element_size())
        cell_sites = (f"ns_cell_residual_{key}", f"ns_cell_jacobian_{key}",
                      "K15")
        fused = (f"ns_cell_residual_{key}_facet",
                 f"ns_cell_jacobian_{key}_facet",
                 {"E": "K3+K12+K13", "G": "K15+K16+K17c",
                  "H": "K3+K16+K17+K12+K13"}.get(
                      tag, f"K15+{TERM_SITE[blocks[0].term.term][0]}"))
    if bdf2 or tag == "G":
        # the cell body alone (K14, K15; K3's is path A's site)
        add(cell_sites[0], f"{cell_sites[2]} cell residual",
            lambda: res(*args), lambda: res_plain(*args), nb_res,
            k3_ops(f, ops))
        add(cell_sites[1], f"{cell_sites[2]} cell jacobian",
            lambda: jac(*args), lambda: jac_plain(*args), nb_jac,
            k3_ops(f, ops) + 3 * k3_ops(f, jops))

    def apart(jacobian):
        cells_out = (jac if jacobian else res)(*args)
        cells_out = (cells_out if isinstance(cells_out, tuple)
                     else (cells_out,))
        return cells_out + tuple(facet_call(b.term, b.scalars, jacobian, *fa)
                                 for b, fa in alone)

    def plain(jacobian):
        cells_out = (jac_plain if jacobian else res_plain)(*args)
        cells_out = (cells_out if isinstance(cells_out, tuple)
                     else (cells_out,))
        fp = facet_jac_plain if jacobian else facet_plain
        return cells_out + tuple(fp(b.term, b.scalars, *fa)
                                 for b, fa in alone)

    add(fused[0], f"{fused[2]} residual",
        lambda: res(*args, facets=blocks), lambda: plain(False),
        nb_res + f_bytes[0] - shared[0], k3_ops(f, ops) + f_flops[0],
        pair=lambda: apart(False))
    add(fused[1], f"{fused[2]} jacobian",
        lambda: jac(*args, facets=blocks), lambda: plain(True),
        nb_jac + f_bytes[1] - shared[1],
        k3_ops(f, ops) + 3 * k3_ops(f, jops) + f_flops[1],
        pair=lambda: apart(True))
    log(f"[kernels {tag}] {dtype}: {len(blocks)} facet blocks "
        f"{[(n, b.term.term, b.tabs['dS'].shape[0])
            for n, b in zip(names, blocks)]}, "
        f"{blocks[0].tabs['dS'].shape[1]} points a facet")
    if tag in ("E", "H", "I"):
        # the outlet facets under reverse flow at this state: K13 and
        # K18 compare no zeros
        ob = blocks[-1]
        upq = torch.einsum("fqb,fbi->fqi", ob.tabs["phi_u"],
                           up[ob.dofmap_u.long()])
        n_back = int((torch.einsum("fqi,fqi->fq", upq, ob.tabs["normal"])
                      < 0).any(dim=1).sum())
        nf = ob.tabs["dS"].shape[0]
        log(f"[kernels {tag}] {n_back} of the {nf} outlet facets under "
            f"backflow (u_prev.n < 0 at a point)")
        require(0 < n_back < nf, "no facet under backflow: K13 and K18 "
                                 "would compare zeros")
    return sites


def tet_state(torch, np, s, seed, dtype):
    """A developed-looking state on the DFG 3D channel: the inflow
    profile 16 U_m y z (H - y)(H - z) / H^4 everywhere plus noise, for u
    and u_prev, p small; made with numpy from `seed`, in `dtype`."""
    from cfdtpu_torch.geom.dfg3d import H

    y, z = s.V.dof_coords[:, 1], s.V.dof_coords[:, 2]
    rng = np.random.default_rng(seed)
    prof = np.zeros((len(y), 3))
    prof[:, 0] = 16 * 0.45 * y * z * (H - y) * (H - z) / H ** 4
    n_u, n_p = s.V.num_dofs, s.Q.num_dofs
    out = [s.tensor(prof + 0.02 * rng.standard_normal((n_u, 3)))
           for _ in range(2)]
    out.append(s.tensor(0.1 * rng.standard_normal(n_p)))
    return tuple(t.to(dtype).contiguous() for t in out)


def tet_sites(torch, np, s, dtype):
    """The sites of path M, the tetrahedral path, in `dtype`: K3+K7 on
    tetrahedra (csrc/ns_cell_tet.cu; residual and Jacobian, the
    natural-correction block in the launch; K7 has no launch of its own
    on tetrahedra) against the plain cell kernel, PATH_M_CHUNK cells a
    call, then the plain facet kernel; K1 on the 3D operator's 16 x 16
    supernode blocks of a NodeBSR asked for g = 4 (the outer operator
    and its 12 x 12 velocity view, each with and without its row mask,
    Apu in S's residual, the p column); and K1's node-block mode on the
    solver's own layout at the same sites (bsr_bytes). Bytes: k3_bytes with
    every output, plus the facet block's maps, coordinates and tables
    (FACET_READS' natural term); the tetrahedral body's operations are
    not counted, so its bound is that of its bytes."""
    from cfdtpu_torch.kernels.ns_cell_residual import (
        ns_cell_jacobian_p1, ns_cell_jacobian_plain, ns_cell_residual_p1,
        ns_cell_residual_plain)
    from cfdtpu_torch.kernels.bsr_spmv import WIDTH, bsr_spmv, bsr_spmv_plain
    from cfdtpu_torch.kernels.ns_facet import facet_jac_plain, facet_plain
    from cfdtpu_torch.kernels.sup_spmv import sup_spmv, sup_spmv_plain
    from cfdtpu_torch.la.nodebsr import NodeBSR

    f, nb = s.form, s._nodebsr
    u, up, p = tet_state(torch, np, s, 31, dtype)
    prm = s.params()
    blocks = [f._kernel_block(b, prm) for b in f._facet_blocks]
    require(f.tabs.tet and len(blocks) == 1
            and blocks[0].term.term == "natural",
            f"path M: the form is not the tetrahedral one with one natural "
            f"block: {[b.term.term for b in blocks]}")
    args = (u, up, p, f.dofmap_u, f.dofmap_p, f.cell_coords, f.cell_h,
            f.tabs, prm["rho"], prm["mu"], prm["dt"], prm["f"], f.eps)
    nc = f.dofmap_u.shape[0]

    def chunks(plain):
        """plain(*args) over PATH_M_CHUNK cells a call, concatenated."""
        parts = []
        for i in range(0, nc, PATH_M_CHUNK):
            j = slice(i, i + PATH_M_CHUNK)
            out = plain(*args[:3], args[3][j], args[4][j], args[5][j],
                        args[6][j], *args[7:])
            parts.append(out if isinstance(out, tuple) else (out,))
        return tuple(torch.cat(ts) for ts in zip(*parts))

    def facets(plain):
        return tuple(plain(b.term, b.scalars, u, up, p, *b.args())
                     for b in blocks)

    b0 = blocks[0]
    tables, arrays, _, jarrays, _ = FACET_READS["natural"]
    have = {"dofmap_u": b0.dofmap_u, "dofmap_p": b0.dofmap_p,
            "coords": b0.coords}
    ftab = nbytes(*(b0.tabs[k] for k in tables))
    sites = []
    res = ns_cell_residual_p1(*args, facets=blocks)
    jac = ns_cell_jacobian_p1(*args, facets=blocks)
    for label, kern, plain, fplain, outs, reads in (
            ("K3+K7 tet residual", ns_cell_residual_p1,
             ns_cell_residual_plain, facet_plain, res, arrays),
            ("K3+K7 tet jacobian", ns_cell_jacobian_p1,
             ns_cell_jacobian_plain, facet_jac_plain, jac, jarrays)):
        sites.append(dict(
            name=kern.__name__ + "_tet", label=label,
            kern=lambda k=kern: k(*args, facets=blocks),
            plain=lambda pl=plain, fp=fplain: chunks(pl) + facets(fp),
            bytes=(k3_bytes(args[:8], outs)
                   + nbytes(*(have[a] for a in reads)) + ftab),
            flops=0, lib=None, reset=None, pair=None))
    del res, jac
    A_el = f.element_jacobians(u, p, (up,), prm)
    vals = nb.assemble(*A_el)
    require(nb.g == 1 and set(vals) == {"coo"},
            f"path M: the solver's layout is g {nb.g}, not the node blocks")
    # the supernode layout the node blocks replace, asked for
    nb4 = NodeBSR(f, supernode_g=4)
    vals4 = nb4.assemble(*A_el)
    del A_el
    S, cols = vals4["sup"], nb4._sup.sup_cols
    gd = nb4.g * nb4.dim
    n_u, n_p = nb.n_u_flat, nb.n_nodes
    require((nb4.g, nb4.dim, gd) == (4, 3, 12)
            and tuple(S.shape[2:]) == (16, 16),
            f"path M: supernode blocks {tuple(S.shape)}, g {nb4.g}, d "
            f"{nb4.dim}: not 16 x 16 over 4 x 4 node blocks")
    rng = np.random.default_rng(37)
    v = torch.as_tensor(rng.standard_normal(n_u + n_p), dtype=dtype,
                        device=s.device)
    vu, vp = v[:n_u], v[n_u:]
    mask_u = torch.as_tensor(rng.random(n_u) < 0.05, device=s.device)
    mask_p = torch.zeros(n_p, dtype=torch.bool, device=s.device)
    mask = torch.cat([mask_u, mask_p])
    scale_u = torch.as_tensor(rng.random(n_u), dtype=dtype,
                              device=s.device)
    b_p = torch.as_tensor(rng.standard_normal(n_p), dtype=dtype,
                          device=s.device)
    s_kw = dict(mode="residual", b=b_p, scale=scale_u)
    for label, A, x, n_out, kw in (
            ("K1 3D outer", S, v, n_u + n_p,
             dict(x_split=(n_u, gd), y_split=(n_u, gd))),
            ("K1 3D outer + mask", S, v, n_u + n_p,
             dict(x_split=(n_u, gd), y_split=(n_u, gd), mask=mask,
                  mask_value=v)),
            ("K1 3D uu", S[:, :, :gd, :gd], vu, n_u, {}),
            ("K1 3D uu + mask (Auu)", S[:, :, :gd, :gd], vu, n_u,
             dict(mask=mask_u, mask_value=vu)),
            ("K1 3D Apu scaled (S)", S[:, :, gd:, :gd], vu, n_p, s_kw),
            ("K1 3D p column", S[:, :, :, gd:], vp, n_u + n_p,
             dict(y_split=(n_u, gd)))):
        ns_, Kg, R, C = A.shape
        sites.append(dict(
            name="sup_spmv", label=label,
            kern=lambda a=(A, cols, x, n_out, kw): sup_spmv(*a[:4], **a[4]),
            plain=lambda a=(A, cols, x, n_out, kw): sup_spmv_plain(*a[:4],
                                                                   **a[4]),
            bytes=k1_bytes(A, x, n_out, kw), flops=2 * ns_ * Kg * R * C,
            lib=k1_yardstick(torch, A, cols), reset=None, pair=None))
    # K1's node-block mode on the solver's own layout, the same sites
    coo = vals["coo"]
    bsr = (coo, nb._bsr_rowptr, nb._bsr_cols)
    for label, x, rows, xcols, kw in (
            ("K1 3D node blocks outer", v, "all", "all", {}),
            ("K1 3D node blocks outer + mask", v, "all", "all",
             dict(mask=mask, mask_value=v)),
            ("K1 3D node blocks Auu + mask", vu, "u", "u",
             dict(mask=mask_u, mask_value=vu)),
            ("K1 3D node blocks Apu scaled (S)", vu, "p", "u", s_kw),
            ("K1 3D node blocks p column", vp, "all", "p", {})):
        n_out = n_p * WIDTH[rows]
        nv = WIDTH[rows] * WIDTH[xcols]
        sites.append(dict(
            name="bsr_spmv", label=label,
            kern=lambda a=(*bsr, x, rows, xcols, kw): bsr_spmv(*a[:6],
                                                               **a[6]),
            plain=lambda a=(*bsr, x, rows, xcols, kw): bsr_spmv_plain(
                *a[:6], **a[6]),
            bytes=bsr_bytes(nb, coo, x, n_out, nv, kw),
            flops=2 * nb.n_blocks * nv,
            lib=(bsr_yardstick(torch, nb, coo) if rows == xcols == "all"
                 else None), reset=None, pair=None))
    log(f"[kernels M] {nc} cells, {b0.dofmap_u.shape[0]} boundary facets, "
        f"{n_u + n_p} DOF, supernode blocks {tuple(S.shape)} ({dtype})")
    return sites


def phase_path_m(torch, np, tmp):
    """Path M, DFG 3D-1Z on P1 tetrahedra: its kernel sites (tet_sites)
    timed in float32 at the cell's size and checked in float64 at
    PATH_M_F64, its form's device kernels (one element launch a
    residual and a Jacobian build), then PATH_M_STEPS steps of
    Scenario.solve from rest with the counters reset just before and
    PATH_M_PROFILE under torch.profiler: every element launch
    tetrahedral with the natural block in it, K7 never alone; c_D, c_L
    and dp after the last step (not a gate: from rest, far from the
    steady state)."""
    from cfdtpu_torch.scenarios.dfg_3d import DFG3DBenchmark

    def scenario(dtype, size):
        t0 = time.perf_counter()
        sc = DFG3DBenchmark("stabilized_schur", dt=DT, T=1.0, dtype=dtype,
                            device="cuda", stats_every=4, output_every=100,
                            **size, **PATH_M_KW)
        log(f"[setup] path M: {size} {dtype} amg_p on cuda: "
            f"{time.perf_counter() - t0:.1f} s")
        return sc

    sc = scenario("float32", PATH_M)
    s = sc.solver
    require(s.V.num_global_dofs + s.Q.num_global_dofs == 972072,
            f"path M: {s.V.num_global_dofs + s.Q.num_global_dofs} DOF, "
            "not 972,072")
    rows, plains = phase_kernels(
        torch, np, sc, 1e-5, timed=True,
        sites=tet_sites(torch, np, s, torch.float32))
    one_launch = phase_one_launch_form(torch, np, sc, "M")
    phase_plain_times(rows, plains)
    del plains
    sc64 = scenario("float64", PATH_M_F64)
    phase_kernels(torch, np, sc64, 1e-12, timed=False,
                  sites=tet_sites(torch, np, sc64.solver, torch.float64))
    del sc64
    launches, res = phase_slice(
        torch, np, sc, os.path.join(tmp, "slice_m"), "path M", PATH_M_STEPS,
        PATH_M_KERNELS, profile_steps=PATH_M_PROFILE)
    for kind in ("residual", "jacobian"):
        name = f"ns_cell_{kind}_p1"
        jac = "_jac" if kind == "jacobian" else ""
        require(launches[name] == launches[name + "_tet"]
                == launches[name + "_facet"]
                == launches[f"ns_facet_natural{jac}_p1_fused"] > 0,
                f"path M: {kind} launches not all tetrahedral with the "
                f"natural block in them: {launches}")
    return rows, one_launch, launches, res


def phase_kernels(torch, np, sc, tol, timed, sites=None):
    """Compare every kernel site with its plain version, and with a
    second call of itself (bitwise). With `timed`, time the kernel and
    the library yardstick with a warm L2 and with the L2 flushed before
    each call (cuda_ms(flush_l2=True)), and their device time alone;
    returns ({site: row dict}, {site: plain version}): the plain
    versions are timed later (phase_plain_times). `sites` defaults to
    kernel_sites(sc)."""
    from cfdtpu_torch.utils.cudatime import cuda_ms

    def both(fn):
        if not timed or fn is None:
            return None, None
        return cuda_ms(fn), cuda_ms(fn, flush_l2=True)

    def dev(fn):
        return None if not timed or fn is None else traced_ms(fn)

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f}"

    rows, plains = {}, {}
    for st in (kernel_sites(torch, np, sc) if sites is None else sites):
        label, kern, plain = st["label"], st["kern"], st["plain"]
        plains[label] = plain
        # a kernel that updates a state in place starts each compared call
        # from the same state (the timed calls need not)
        reset = st["reset"] or (lambda: None)
        # copies: a kernel that writes in place returns views
        reset()
        got = tuple(t.clone() for t in flat_outputs(kern()))
        reset()
        ref = flat_outputs(plain())
        torch.cuda.synchronize()
        err = 0.0
        for g, r in zip(got, ref):
            require(g.shape == r.shape and g.dtype == r.dtype,
                    f"{label}: shape/dtype {g.shape} {r.shape}")
            e = float((g - r).abs().max())
            scale = float(r.abs().max())
            require(e <= tol * scale,
                    f"{label}: |kernel - plain|_inf {e:.3e} > "
                    f"{tol:g} * {scale:.3e}")
            err = max(err, e)
        reset()
        again = flat_outputs(kern())
        require(all(torch.equal(g, a) for g, a in zip(got, again)),
                f"{label}: two calls are not bitwise equal")
        row = dict(name=st["name"], max_abs_err=err, bytes=st["bytes"],
                   flops=st["flops"])
        pair = st["pair"]
        if pair is not None:  # a fused site: the launches it replaces
            apart = flat_outputs(pair())
            row["equals_pair"] = all(torch.equal(g, a)
                                     for g, a in zip(got, apart))
            row["pair_max_abs_err"] = max(float((g - a).abs().max())
                                          for g, a in zip(got, apart))
            row["pair_device_ms"] = dev(pair)
        row["bound_ms"], row["bound_by"] = bound_ms(st["bytes"], st["flops"])
        row["warm_ms"], row["ms"] = both(kern)
        row["device_ms"] = dev(kern)
        lib, note = None, ""
        if timed and st["lib"] is not None:
            try:
                lib = st["lib"]()
                lib()
                torch.cuda.synchronize()
            except (RuntimeError, NotImplementedError, TypeError) as e:
                lib, note = None, f"  library: none ({str(e)[:80]})"
        row["library_warm_ms"], row["library_ms"] = both(lib)
        row["library_device_ms"] = dev(lib)
        rows[label] = row
        if timed:
            share = row["bound_ms"] / row["ms"]
            tbps = st["bytes"] / (row["ms"] * 1e-3) / 1e12
            lib_s = ("none" if row["library_ms"] is None else
                     f"{row['library_warm_ms']:.4f}/{row['library_ms']:.4f}"
                     f" (device {fmt(row['library_device_ms'])})")
            dev_pct = (None if not row["device_ms"] else
                       100 * row["bound_ms"] / row["device_ms"])
            dev_share = ("" if dev_pct is None else
                         f", bound = {dev_pct:.1f}% of it")
            if pair is not None:
                dev_share += (f"; the launches it replaces: device "
                              f"{fmt(row['pair_device_ms'])}, bitwise "
                              f"equal {row['equals_pair']} (max diff "
                              f"{row['pair_max_abs_err']:.2e})")
            log(f"[kernels] {label:44s} err {err:.2e} kernel warm/cold "
                f"{row['warm_ms']:.4f}/{row['ms']:.4f} ms (device "
                f"{fmt(row['device_ms'])}{dev_share})  library "
                f"{lib_s}  bound {row['bound_ms']:.4f} ({row['bound_by']}: "
                f"{st['bytes'] / 1e6:.3f} MB, {st['flops'] / 1e6:.2f} "
                f"MFLOP) = {100 * share:.1f}% of cold, {tbps:.3f} TB/s; "
                f"bitwise repeatable{note}")
        else:
            eq = ("" if pair is None else
                  f"; bitwise equal to the launches it replaces "
                  f"{row['equals_pair']} (max diff "
                  f"{row['pair_max_abs_err']:.2e})")
            log(f"[kernels] {label:44s} max_abs_err {err:.3e}; bitwise "
                f"repeatable{eq}")
    return rows, plains


PLAIN_CALLS = 5  # timed calls of a plain version (up to ~40 ms each)


def phase_plain_times(rows, plains):
    """The plain versions' times, warm and cold (cuda_ms), after every
    phase that reads a profiler trace but the slices': on an H100,
    timing them between the kernel phase's traces (25 calls each,
    the vmap(jacfwd) Jacobians among them) left torch.profiler dropping
    nearly every record from the K3+K7 Jacobian site on, run after run,
    with 77 GB of the card free; without them no trace was lost."""
    from cfdtpu_torch.utils.cudatime import cuda_ms

    for label, plain in plains.items():
        row = rows[label]
        row["plain_warm_ms"] = cuda_ms(plain, n=PLAIN_CALLS, warmup=1)
        row["plain_ms"] = cuda_ms(plain, n=PLAIN_CALLS, warmup=1,
                                  flush_l2=True)
        log(f"[plain] {label:44s} warm/cold {row['plain_warm_ms']:.4f}/"
            f"{row['plain_ms']:.4f} ms, {row['plain_ms'] / row['ms']:.1f}x "
            f"the kernel's cold time")


def phase_one_launch(torch, np, sc):
    """Each operator apply the solver calls is one device kernel: K1,
    with no fill, copy or concatenation around it; each K9 Gram-Schmidt
    step (FGMRES's CGS2 with its Givens tail, the S stage's CGS) and each
    triangular solve one device kernel; form.residual issues 5 device
    kernels, K3 with the facet block in its launch, K2 three times and
    the add; form.element_jacobians one, K3's Jacobian with the facet
    block's (torch.profiler)."""
    from cfdtpu_torch.kernels.krylov import (Givens, krylov_cgs,
                                             krylov_lsq_tri)
    from cfdtpu_torch.kernels.ns_cell_residual import ns_cell_jacobian_plain
    from cfdtpu_torch.kernels.ns_facet import (
        ns_facet_natural_jac_plain, ns_facet_natural_plain)
    s = sc.solver
    f, nb = s.form, s._nodebsr
    u, up, p = developed_state(torch, np, s, 3)
    prm = s.params()
    vals = nb.assemble(*f.element_jacobians(u, p, (up,), prm))
    amg, bamg = nb.sp_amg(), nb.uu_amg(
        fine_smoother=nb.uu_ras(s.pc_ras_size, s.pc_ras_overlap))
    lv, _ = amg.build(nb.sp_vals(vals))
    blv, _, _ = bamg.build(nb.uu_vals(vals, bc_mask_u(torch, np, s)))
    rng = np.random.default_rng(5)
    rand = (lambda n: s.tensor(rng.standard_normal(n)))
    n_u, n_p = nb.n_u_flat, nb.n_nodes
    v, vm, vb = rand(n_u + n_p), rand(lv[0][1].shape[0]), rand(n_u)
    calls = {
        "NodeBSR.apply_element_matrices":
            lambda: nb.apply_element_matrices(vals, (), v),
        "NodeBSR.apply_sub_block uu":
            lambda: nb.apply_sub_block(vals, (), v[:n_u], "uu"),
        "NodeBSR.apply_p_coupled":
            lambda: nb.apply_p_coupled(vals, v[n_u:]),
        "AMG._matvec L0 jacobi":
            lambda: amg._matvec(0, lv[0][0], vm, mode="jacobi", b=vm,
                                d=lv[0][1]),
        "BlockAMG._matvec L0 residual":
            lambda: bamg._matvec(0, blv[0][0], vb, mode="residual", b=vb),
    }
    # K1's cheby mode on a level, as the Chebyshev smoothers call it
    wv = 1.0 / lv[0][1]
    calls["AMG._matvec L0 cheby (d stored)"] = (
        lambda: amg._matvec(0, lv[0][0], vm, mode="cheby", b=vm,
                            cheb=(wv, None, 0.5, 1.5),
                            d_out=torch.empty_like(vm)))
    out = {}
    for label, fn in calls.items():
        names = traced_kernels(fn)
        log(f"[one launch] {label}: device activities {names}")
        require(len(names) == 1 and "sup_spmv" in names[0],
                f"{label} issued {names}, not one K1 kernel")
        out[label] = names

    # the other kernels of the cycle family and the inner methods
    from cfdtpu_torch.kernels.amg_gcr2 import gcr2_first, gcr2_second
    from cfdtpu_torch.kernels.block_jacobi import block_jacobi
    from cfdtpu_torch.kernels.sup_spmv import cheby_update

    q = [rand(vm.shape[0]) for _ in range(5)]
    r1, coef = gcr2_first(q[0], q[1])
    binv = nb.uu_block_jacobi(vals, bc_mask_u(torch, np, s))
    V1 = torch.empty((1, n_p), dtype=s.dtype, device=s.device)
    h1 = torch.empty(1, dtype=s.dtype, device=s.device)
    vp = v[n_u:].contiguous()
    dpv = vp.abs().reshape(-1, 1, 1) + 1.0
    others = {
        "amg_gcr2 first": (lambda: gcr2_first(q[0], q[1]),
                            "amg_gcr2_first"),
        "amg_gcr2 second": (lambda: gcr2_second(q[0], q[2], q[3], q[4], r1,
                                                coef), "gcr2_second"),
        "block_jacobi u-block": (lambda: binv(vb), "block_jacobi"),
        "block_jacobi v / d_p": (lambda: block_jacobi(dpv, vp, True),
                                 "block_jacobi"),
        "cheby_update": (lambda: cheby_update(vp, vp, vp, vp, None, 0.5,
                                              1.5), "cheby_update"),
        "krylov_cgs scaled normalisation": (
            lambda: krylov_cgs(V1, vp, -1, h1, False, scale=vp),
            "krylov_cgs"),
    }
    for label, (fn, key) in others.items():
        names = traced_kernels(fn)
        log(f"[one launch] {label}: device activities {names}")
        require(len(names) == 1 and key in names[0],
                f"{label} issued {names}, not one {key} kernel")
        out[label] = names

    # K9 at its sites: FGMRES (restart 20, j = 19, the Givens tail; the
    # triangular solve at j = 20) and the S stage (j = 4)
    G = Givens(20, 0.0, s.device)
    G.cs.fill_(0.6)
    G.sn.fill_(0.8)
    G.g.fill_(1.0)
    G.R.copy_(torch.eye(20, 21, dtype=torch.float64, device=s.device))
    Vf, Vs = (torch.nn.functional.normalize(rand(r * n).reshape(r, n),
                                            dim=1)
              for r, n in ((21, n_u + n_p), (6, n_p)))
    wf, ws, hf, hs = rand(n_u + n_p), rand(n_p), rand(21), rand(6)
    Zf = rand(20 * (n_u + n_p)).reshape(20, -1)
    k9 = {
        "krylov_cgs CGS2 + Givens (FGMRES j=19)":
            (lambda: krylov_cgs(Vf, wf, 19, hf, True, G), "krylov_cgs"),
        "krylov_cgs CGS (S stage j=4)":
            (lambda: krylov_cgs(Vs, ws, 4, hs, False), "krylov_cgs"),
        "krylov_lsq_tri (FGMRES j=20)":
            (lambda: krylov_lsq_tri(G.R, G.g, Zf, wf, 20), "krylov_lsq"),
    }
    for label, (fn, key) in k9.items():
        names = traced_kernels(fn)
        log(f"[one launch] {label}: device activities {names}")
        require(len(names) == 1 and key in names[0],
                f"{label} issued {names}, not one K9 kernel")
        out[label] = names

    def count(names, key):
        return sum(key + "_kernel" in n for n in names)

    # the element layer: device kernels per call, beside those of the
    # plain facet term and the plain vmap(jacfwd) Jacobians on the card
    cargs = (u, up, p, f.dofmap_u, f.dofmap_p, f.cell_coords, f.cell_h,
             f.tabs, prm["rho"], prm["mu"], prm["dt"], prm["f"], f.eps)
    fargs = f._fused_args(f._facet_blocks[0], u, p, (up,), prm)
    res = traced_kernels(lambda: f.residual(u, p, (up,), prm))
    jac = traced_kernels(lambda: f.element_jacobians(u, p, (up,), prm))
    plain = {
        "facet residual": traced_kernels(
            lambda: ns_facet_natural_plain(*fargs)),
        "cell jacobians": traced_kernels(
            lambda: ns_cell_jacobian_plain(*cargs)),
        "facet jacobians": traced_kernels(
            lambda: ns_facet_natural_jac_plain(*fargs)),
    }
    n_plain = {k: len(v) for k, v in plain.items()}
    res_before = len(res) + n_plain["facet residual"]
    jac_before = n_plain["cell jacobians"] + n_plain["facet jacobians"]
    log(f"[one launch] form.residual: {len(res)} device kernels {res} (6 "
        f"with K7 a launch of its own); with the plain facet term "
        f"({n_plain['facet residual']} kernels) beside K3: {res_before}")
    log(f"[one launch] form.element_jacobians: {len(jac)} device kernels "
        f"{jac} (2 with K7 apart); as plain vmap(jacfwd) of the cell kernel "
        f"({n_plain['cell jacobians']}) and of the facet kernel "
        f"({n_plain['facet jacobians']}): {jac_before}")
    require(len(res) == 5 and count(res, "ns_cell_residual_p1_facet") == 1
            and count(res, "ell_sum") == 3,
            f"form.residual issued {res}, not 5 device kernels: K3 with "
            "the facet block once, K2 three times and the add")
    require(len(jac) == 1 and count(jac, "ns_cell_jacobian_p1_facet") == 1,
            f"form.element_jacobians issued {jac}, not one K3 Jacobian "
            "launch with the facet block")
    out["form.residual"] = {"kernels": res, "with_plain_facet": res_before}
    out["form.element_jacobians"] = {"kernels": jac, "plain": jac_before}
    return out


def phase_one_launch_form(torch, np, sc, tag):
    """Launches per form.residual and per form.element_jacobians call on
    a new path's form: the element kernel once with every facet block in
    its launch and K2 twice for the cells and once per block (the
    wrappers' counts, asserted); the device kernels of a trace, which
    holds those and one add per block: the trace (padded, cudatime.
    launches) is taken again, up to TRACE_TRIES times a second apart,
    until one holds
    them all, as a trace may lose records, never gain one (on an H100
    traces of the residual's 7 lost 1 and 5, and every trace of the BDF2
    Jacobian its one kernel, in two unpadded runs); the fullest must
    hold the element kernel once and no more than the rest."""
    from cfdtpu_torch import kernels

    s = sc.solver
    f = s.form
    tet = f.tabs.tet
    if tet:  # path M: the tetrahedral kernels, named ns_cell_*_tet_*
        u, up, p = tet_state(torch, np, s, 23, s.dtype)
        up2 = up
    else:
        u, up, up2, p = backflow_state(torch, np, s, 23, s.dtype)
    aux = (up, up2)[:f.N_AUX]
    prm = s.params()
    key = {"StabilizedNSFormBDF2": "bdf2_p1",
           "StabilizedNSFormCurlCurl": "curl_p1"}.get(type(f).__name__, "p1")
    dkey = "tet" if tet else key
    nblk = len(f._facet_blocks)
    want_res = {f"ns_cell_residual_{key}": 1,
                f"ns_cell_residual_{key}_facet": 1, "ell_sum": 2 + nblk}
    want_jac = {f"ns_cell_jacobian_{key}": 1,
                f"ns_cell_jacobian_{key}_facet": 1}
    if tet:
        want_res["ns_cell_residual_p1_tet"] = 1
        want_jac["ns_cell_jacobian_p1_tet"] = 1
    counted = {}
    for name, fn, want in (
            ("residual", lambda: f.residual(u, p, aux, prm), want_res),
            ("element_jacobians",
             lambda: f.element_jacobians(u, p, aux, prm), want_jac)):
        kernels.reset_counts()
        fn()
        got = {k: n for k, n in kernels.counts().items() if n
               and not k.endswith("_fused")}
        counted[name] = got
        require(got == want, f"{tag}: form.{name} launched {got}, not "
                             f"{want}")

    def trace(fn, full):
        best, tries = [], 0
        while tries < TRACE_TRIES and len(best) < full:
            if tries:
                time.sleep(1.0)
            names = traced_launches(fn, pad=TRACE_PAD)[1]
            best = names if len(names) > len(best) else best
            tries += 1
        PROFILER_RETRIES["launches"] += tries - 1
        return best, tries

    n_res = 3 + 2 * nblk
    res, tries_res = trace(lambda: f.residual(u, p, aux, prm), n_res)
    jac, tries_jac = trace(lambda: f.element_jacobians(u, p, aux, prm), 1)
    log(f"[one launch {tag}] form.residual ({nblk} facet blocks "
        f"{[b['name'] for b in f._facet_blocks]}): port launches "
        f"{counted['residual']}, {len(res)} of {n_res} device kernels in "
        f"the fullest of {tries_res} traces {res}; "
        f"form.element_jacobians: {counted['element_jacobians']}, "
        f"{len(jac)} of 1 in {tries_jac} {jac}")
    kinds = (f"ns_cell_residual_{dkey}_facet_kernel", "ell_sum_kernel",
             "CUDAFunctor_add")
    require(len(res) <= n_res
            and all(any(k in n for k in kinds) for n in res),
            f"{tag}: form.residual's trace holds {res}: more than one "
            f"element kernel, {2 + nblk} sums and {nblk} adds")
    require(sum(kinds[0] in n for n in res) == 1,
            f"{tag}: no trace of form.residual held its element kernel "
            f"once: {res}")
    require(len(jac) == 1
            and f"ns_cell_jacobian_{dkey}_facet_kernel" in jac[0],
            f"{tag}: form.element_jacobians' traces hold {jac}, not its "
            "element kernel once")
    return {"residual": res, "element_jacobians": jac, "facet_blocks": nblk,
            "residual_full": len(res) == n_res, "traces_residual": tries_res,
            "traces_jacobian": tries_jac, "port_launches": counted}


def pc_state(torch, np, sc, seed):
    """The solver's rasamg_sup Schur preconditioner, built
    (build_schur_state) at a developed state with the solver's own
    settings, on the card."""
    from cfdtpu_torch.la.schur import build_schur_state

    s = sc.solver
    f, nb = s.form, s._nodebsr
    u, up, p = developed_state(torch, np, s, seed)
    vals = nb.assemble(*f.element_jacobians(u, p, (up,), s.params()))
    mask_u = bc_mask_u(torch, np, s)
    mask_p = torch.zeros(nb.n_nodes, dtype=torch.bool, device=s.device)
    mask_p[torch.as_tensor(s.bc_dofs_p.astype(np.int64),
                           device=s.device)] = True
    kw = dict(m_u=s.pc_inner_u, m_p=5, full=True, bc_mask_p=mask_p,
              inner_method="rasamg_sup",
              ras_opts=(s.pc_ras_size, s.pc_ras_overlap))
    return build_schur_state(nb, vals, mask_u, False, **kw), kw, vals, \
        mask_u, mask_p


def replay_vs_eager(torch, np, s, pc, seed):
    """One replay of a captured application against the eager
    application of the same closure on the same input: bitwise."""
    v = s.tensor(np.random.default_rng(seed).standard_normal(
        s._nodebsr.n_u_flat + s._nodebsr.n_nodes))
    got = pc(v).clone()
    ref = pc.eager(v)
    torch.cuda.synchronize()
    return bool(torch.equal(got, ref)), bool(torch.isfinite(got).all())


def phase_pc_launches(torch, np, sc):
    """The preconditioner application's launches (torch.profiler): the
    sub-block actions of la/schur.py with their epilogues and the outer
    matvec one K1 kernel each, the SELFP Schur action two, the near-true
    one three beside its V-cycle's (the whole application: phase_graph)."""
    from cfdtpu_torch.la.schur import _near_true_schur, _sub_ops, _uu_amg

    s = sc.solver
    nb = s._nodebsr
    st, kw, vals, mask_u, mask_p = pc_state(torch, np, sc, 11)
    rng = np.random.default_rng(12)
    n_u, n_p = nb.n_u_flat, nb.n_nodes
    v = s.tensor(rng.standard_normal(n_u + n_p))
    vu, vp = v[:n_u].contiguous(), v[n_u:].contiguous()
    Auu, Aup, Apu, App, S = _sub_ops(nb, st["A"], mask_u, mask_p, False,
                                     1.0 / st["d_u"])
    mask = torch.cat([mask_u, mask_p])
    ops = {
        "outer matvec where(bc, v, A v)": lambda: nb.apply_element_matrices(
            vals, (), v, mask=mask, mask_value=v),
        "Auu": lambda: Auu(vu), "Aup": lambda: Aup(vp),
        "Apu": lambda: Apu(vu), "App": lambda: App(vp),
        "r_p - Apu z_u": lambda: Apu(vu, mode="residual", b=vp),
    }
    out = {}
    for label, fn in ops.items():
        names = traced_kernels(fn)
        log(f"[pc launches] {label}: device activities {names}")
        require(len(names) == 1 and "sup_spmv" in names[0],
                f"{label} issued {names}, not one K1 kernel")
        out[label] = names
    names = traced_kernels(lambda: S(vp))
    log(f"[pc launches] SELFP S (no mean removal): {names}")
    require(len(names) == 2 and all("sup_spmv" in n for n in names),
            f"the SELFP S issued {names}, not two K1 kernels")
    out["SELFP S"] = names
    uu_amg = _uu_amg(nb, "rasamg_sup", kw["ras_opts"])
    ntS = _near_true_schur(uu_amg, st["uu_built"], Aup, Apu, App, mask_u,
                           mask_p, False)
    w = Aup(vp)
    vc = traced_kernels(lambda: uu_amg.v_cycle(st["uu_built"], w))
    names = traced_kernels(lambda: ntS(vp))
    k1 = sum("sup_spmv" in n for n in names)
    log(f"[pc launches] near-true S: {len(names)} device kernels, its "
        f"V-cycle {len(vc)}; {names}")
    require(len(names) == 3 + len(vc)
            and k1 == 3 + sum("sup_spmv" in n for n in vc),
            f"the near-true S issued {len(names)} device kernels, not 3 K1 "
            f"beside its V-cycle's {len(vc)}")
    out["near-true S"] = {"kernels": len(names), "v_cycle": len(vc)}
    return out


def port_kernel(name):
    """True for a device kernel of the port (its name holds a counter's)."""
    from cfdtpu_torch.kernels import COUNTERS

    return any(k in name for k in COUNTERS)


def phase_graph(torch, np, sc, tag, baseline=None, want=None):
    """One preconditioner application of the scenario's own settings
    (Solver._pc_kw), built at a developed state: a CapturedPrecond whose
    replay is one cudaGraphLaunch and no kernel launch, bitwise equal to
    the eager application. Its port kernels are the wrappers' launches
    in one eager call (what a capture records); a trace of a replay may
    show fewer (torch.profiler drops records), never more. The traced
    device kernels are counted by kernel; those that are not the port's
    (the coarsest solves' GEMV, the Schur combination's copy and add,
    gmres_fixed's buffer fills) must be of the kinds the `baseline`
    graph (path A or amg_p) holds already. With `want` (paths A and
    amg_p: GRAPH_KERNELS), the closure launches exactly want[0] port
    kernels, K1 with the correction in its gather among them and no K8,
    and neither trace holds more than want[1] device kernels."""
    from cfdtpu_torch.la.schur import (CapturedPrecond, build_schur_state,
                                       make_schur_precond_from_state)

    s = sc.solver
    f, nb = s.form, s._nodebsr
    u, up, p = developed_state(torch, np, s, 21)
    vals = nb.assemble(*f.element_jacobians(u, p, (up,), s.params()))
    kw = dict(s._pc_kw)
    mask_u = bc_mask_u(torch, np, s)
    state = build_schur_state(nb, vals, mask_u, False, **kw)
    pc = make_schur_precond_from_state(nb, state, mask_u, False, **kw)
    require(isinstance(pc, CapturedPrecond), f"{tag}: no captured graph")
    same, finite = replay_vs_eager(torch, np, s, pc, 22)
    v = s.tensor(np.random.default_rng(23).standard_normal(
        nb.n_u_flat + nb.n_nodes))

    # copies and fills are not kernels here; a graph turns a small copy
    # (gmres_fixed's Z[j] = z, a few thousand values) into a memcpy
    # kernel node that the eager trace shows as a Memcpy activity
    def kernel(n):
        return not n.startswith(("Memcpy", "Memset")) and "memcpy" not in n

    # the port's kernels of one eager application, exactly: the wrappers'
    # launches (each one device kernel; the fused variants' and options'
    # counters are subsets of their kernel's)
    from cfdtpu_torch import kernels as kmod

    before = kmod.counts()
    pc.eager(v)
    delta = {k: n - before[k] for k, n in kmod.counts().items()}
    exact = sum(n for k, n in delta.items() if k not in SUBSET_COUNTERS)
    # the traces' counts, for the record: torch.profiler drops device
    # records of a trace of 100-400 kernels, of a replay's and of the
    # eager application's alike (up to 5 and 19 of them, PR 9's runs),
    # and never adds one
    calls, names = traced_launches(lambda: pc(v))
    dk = [n for n in names if kernel(n)]
    ek = [n for n in traced_launches(lambda: pc.eager(v))[1] if kernel(n)]
    pk = [n for n in dk if port_kernel(n)]
    pe = [n for n in ek if port_kernel(n)]

    def by_name(names):
        out = {}
        for n in names:
            key = (n.replace("void ", "").replace("(anonymous namespace)::",
                                                  "")
                   .split("<")[0].split("(")[0][:48])
            out[key] = out.get(key, 0) + 1
        return out

    by_kernel, by_kernel_eager = by_name(dk), by_name(ek)
    differs = {k: by_kernel_eager.get(k, 0)
               for k in set(by_kernel) | set(by_kernel_eager)
               if by_kernel_eager.get(k, 0) != by_kernel.get(k, 0)}
    other = sorted({n[:60] for n in dk if not port_kernel(n)})
    log(f"[graph {tag}] one replayed application: host {calls}; the port's "
        f"device kernels {exact} (the closure's launches); a trace of the "
        f"replay {len(dk)} device kernels, {len(pk)} the port's, of the "
        f"eager application {len(ek)} and {len(pe)}; replay bitwise equal "
        f"to eager: {same}; traced by kernel {by_kernel}; where the eager "
        f"trace differs: {differs}")
    require(calls["graph"] == 1 and calls["kernel"] == 0,
            f"{tag}: a replayed application made {calls}, not one "
            "cudaGraphLaunch and no kernel launch")
    require(len(pk) <= exact,
            f"{tag}: {len(pk)} of the port's device kernels in a trace of "
            f"the graph, more than the {exact} its closure launches")
    require(same and finite, f"{tag}: replay and eager application differ "
                             f"(finite {finite})")
    if want is not None:
        fused, k8 = delta["sup_spmv_prolong"], delta["amg_prolong"]
        require(k8 == 0 and fused > 0,
                f"{tag}: {k8} K8 launches and {fused} fused K1 launches in "
                "one application")
        require(exact == want[0], f"{tag}: {exact} port kernel launches in "
                                  f"one application, not {want[0]}")
        require(max(len(dk), len(ek)) <= want[1],
                f"{tag}: {len(dk)} device kernels in a trace of the graph, "
                f"{len(ek)} of the eager application, more than {want[1]}")
    if baseline is not None:
        extra = sorted(set(other) - set(baseline))
        require(not extra, f"{tag}: device kernels outside the port's "
                           f"that the baseline graph has not: {extra}")
    return {"host": calls, "graph_device_kernels": len(dk),
            "eager_device_kernels": len(ek), "graph_port_kernels": len(pk),
            "eager_port_kernels": len(pe), "eager_port_launches": exact,
            "eager_launches_by_counter": {k: n for k, n in delta.items()
                                          if n},
            "by_kernel": by_kernel,
            "eager_differs": differs,
            "other_kernels": other, "replay_equals_eager": same}


def phase_determinism(torch, np, sc, trials=5):
    """Two float32 residual calls on one state must be bitwise equal, and
    two element_jacobians + assemble results too. For the record, also
    how often the facet term's former atomic index_add reproduced
    itself."""
    s = sc.solver
    f = s.form
    u, up, p = developed_state(torch, np, s, 7)
    prm = s.params()
    a = f.residual(u, p, (up,), prm)
    b = f.residual(u, p, (up,), prm)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    block = f._facet_blocks[0]
    _, ru_f = f._block_residual(block, u, p, (up,), prm)
    ru_c = a[0] - block["scatter_u"](ru_f.reshape(-1, 2).contiguous())
    dm = block["dofmap_u"].reshape(-1)

    def old():
        return ru_c.index_add(0, dm, ru_f.reshape(-1, 2))

    ref = old()
    old_same = sum(torch.equal(old(), ref) for _ in range(trials))
    nb = s._nodebsr
    va, vb = (nb.assemble(*f.element_jacobians(u, p, (up,), prm))
              for _ in range(2))
    same_jac = all(torch.equal(va[k], vb[k]) for k in va)
    # C1: the wall shear stress, a K2 sum (once an atomic index_add)
    saved = (s.u_sol, s.p_sol)
    if s._wss is None:
        s.initStressForm()
    s.u_sol, s.p_sol = u, p
    wss = []
    for _ in range(2):
        s.assemble_wss()
        wss.append(s.shear_stress)
    s.u_sol, s.p_sol = saved
    same_wss = bool(torch.equal(*wss))
    # C2: the element-block operator, K2 sums per block
    A = f.element_jacobians(u, p, (up,), prm)
    v = s.tensor(np.random.default_rng(8).standard_normal(f.n_flat))
    vu, vpp = v[: f.n_u_flat], v[f.n_u_flat:]
    ebo = {"apply_element_matrices": lambda: f.apply_element_matrices(*A,
                                                                      v)}
    for which, x in (("uu", vu), ("up", vpp), ("pu", vu), ("pp", vpp)):
        ebo[f"apply_sub_block {which}"] = (
            lambda which=which, x=x: f.apply_sub_block(*A, x, which))
    same_ebo = {k: bool(torch.equal(fn(), fn())) for k, fn in ebo.items()}
    log(f"[determinism] float32 form.residual twice: bitwise equal "
        f"{same}; element_jacobians + assemble twice: bitwise equal "
        f"{same_jac}; assemble_wss twice: {same_wss}; element-block "
        f"operator twice: {same_ebo}; the former facet index_add "
        f"reproduced itself in {old_same}/{trials} trials")
    require(same, "form.residual is not bitwise repeatable")
    require(same_jac, "element_jacobians + assemble is not bitwise "
                      "repeatable")
    require(same_wss, "assemble_wss is not bitwise repeatable")
    require(all(same_ebo.values()),
            f"the element-block operator is not bitwise repeatable: "
            f"{same_ebo}")
    return {"residual_bitwise_equal": same,
            "jacobians_bitwise_equal": same_jac,
            "wss_bitwise_equal": same_wss,
            "element_block_bitwise_equal": same_ebo,
            "index_add_repeats": f"{old_same}/{trials}"}


def phase_replay_after_rebuild(torch, np, sc, tag):
    """After a slice: the solver's one graph (its PrecondSlot's, refitted
    at every pc_lag rebuild and carried in its op_state), replayed on the
    last rebuild's values against the eager application of its closure,
    bitwise."""
    from cfdtpu_torch.la.schur import CapturedPrecond

    s = sc.solver
    pc = s._op_state["M"]
    require(isinstance(pc, CapturedPrecond), f"{tag}: no captured graph")
    same, finite = replay_vs_eager(torch, np, s, pc, 14)
    log(f"[determinism] {tag}: the graph of the last pc_lag rebuild, "
        f"replay bitwise equal to eager: {same}")
    require(same and finite, f"{tag}: replay after a rebuild differs from "
                             f"eager (finite {finite})")
    return same


# ----------------------------------------------------------------------
def run_steps(sc, out_dir, steps, on_step=None):
    """Drive the scenario's time loop (Scenario.solve) for `steps`
    steps; returns per-step [(newton, ksp, ksp_max, wall_s, converged)].
    Step 1's wall time includes the loop's output set-up. on_step(i) is
    called after step i, once the card is idle, outside the step's
    wall time."""
    import torch

    s = sc.solver
    rec = []
    last = [time.perf_counter()]

    def after_step(t):
        torch.cuda.synchronize() if s.device.type == "cuda" else None
        now = time.perf_counter()
        st = s.step_stats
        rec.append((st["newton_iters"], st["ksp_iters"], st["ksp_max"],
                    now - last[0], st["converged"],
                    getattr(s, "cd", None), getattr(s, "cl", None),
                    getattr(s, "p_c", None)))
        if on_step is not None:
            on_step(len(rec))
        last[0] = time.perf_counter()

    sc.T = (steps - 0.5) * sc.dt  # t accumulates in floats: stop between
    sc.solve(out_dir, afterStepCallback=after_step)
    require(len(rec) == steps, f"ran {len(rec)} steps, wanted {steps}")
    return rec


class StepProfile:
    """torch.profiler over the steps after `start` (from on_step(start)
    to on_step(stop)): each port kernel's calls and device time (matched
    by the names in COUNTERS, or their DEVICE_NAME, that its name holds:
    a fused variant's calls count under its kernel too), the other device activities'
    (the largest by name), the host's kernel and graph launches,
    cudaMemcpyAsync calls and waits (utils/cudatime.host_calls), FGMRES's
    discarded lookahead iterations, and the share of the window's wall
    time in which the card was idle."""

    def __init__(self, start, stop):
        self.start, self.stop = start, stop
        self.prof = None
        self.t0 = 0.0
        self.discarded0 = 0
        self.result = None

    def __call__(self, i):
        from torch.profiler import ProfilerActivity, profile

        from cfdtpu_torch.la.gmres import DISCARDED

        if i == self.start:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
            self.discarded0 = DISCARDED.n
        elif i == self.stop:
            wall = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
            self.result = self._read(wall)
            self.result["discarded"] = DISCARDED.n - self.discarded0

    def _read(self, wall):
        from torch.autograd import DeviceType

        from cfdtpu_torch.kernels import COUNTERS
        from cfdtpu_torch.utils.cudatime import host_calls

        events = self.prof.events()
        api = host_calls(events)
        dev = [(e.time_range.start, e.time_range.end, e.name)
               for e in events if e.device_type == DeviceType.CUDA]
        kernels = {name: [0, 0.0] for name in COUNTERS}
        other = {}
        for a, b, n in dev:
            # every counter whose name the kernel's holds: a fused
            # variant counts under its kernel's name and its own
            slots = [kernels[k] for k in COUNTERS
                     if DEVICE_NAME.get(k, k) in n] or [
                other.setdefault(n[:60], [0, 0.0])]
            for slot in slots:
                slot[0] += 1
                slot[1] += (b - a) / 1e3
        busy, end = 0.0, float("-inf")  # union of the device intervals
        for a, b, _ in sorted(dev):
            if b > end:
                busy += b - max(a, end)
                end = b
        top = sorted(other.items(), key=lambda kv: -kv[1][1])[:8]
        return {"steps": f"{self.start + 1}-{self.stop}",
                "profiled_wall_s": wall,
                "kernels": {k: {"calls": c, "device_ms": t}
                            for k, (c, t) in kernels.items()},
                "other_calls": sum(c for c, _ in other.values()),
                "other_device_ms": sum(t for _, t in other.values()),
                "other_largest": {k: {"calls": c, "device_ms": t}
                                  for k, (c, t) in top},
                "device_busy_ms": busy / 1e3,
                "device_activities": len(dev),
                "device_kernels": sum(not n.startswith(("Memcpy", "Memset"))
                                      for _, _, n in dev),
                "kernel_launches": api["kernel"],
                "graph_launches": api["graph"],
                "cudaMemcpyAsync": api["memcpy"],
                "host_waits": api["wait"],
                "idle_share": 1.0 - busy / 1e6 / wall}


def phase_slice(torch, np, sc, out_dir, tag, steps, required,
                profile_steps=0):
    """Drive `steps` steps from rest with the launch counters reset just
    before; the last 4 (one pc_lag_steps period) are measured. With
    profile_steps, that many more steps follow under StepProfile."""
    from cfdtpu_torch import kernels

    s = sc.solver
    gc.collect()  # free an earlier phase's scenario before the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    kernels.reset_counts()
    launches = {}
    prof = StepProfile(steps, steps + profile_steps)

    def on_step(i):
        if i == steps:
            launches.update(kernels.counts())
        if profile_steps:
            prof(i)

    rec = run_steps(sc, out_dir, steps + profile_steps, on_step)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ndof = s.V.num_global_dofs + s.Q.num_global_dofs
    for i, (n, k, kmax, w, _, cd, cl, p_c) in enumerate(rec, 1):
        forces = "" if cd is None else f" c_D {cd:.10f} c_L {cl:.10f}"
        forces += "" if p_c is None else f" p_c after the step {p_c!r}"
        log(f"[{tag}] step {i}: newton {n} ksp {k} (max per solve {kmax}) "
            f"wall {w:.4f} s{forces}")
    win = rec[max(steps - 4, 0):steps]
    wall = sum(r[3] for r in win)
    sps = len(win) / wall
    ksp = sum(r[1] for r in win)
    funcs = functionals(sc)
    log(f"[{tag}] {ndof} DOF {str(s.dtype)[6:]}: {sps:.4f} steps/s over "
        f"steps {steps - len(win) + 1}-{steps}; {sum(r[0] for r in win)} "
        f"Newton and {ksp} KSP there, {1e3 * wall / ksp:.2f} ms per KSP "
        f"iteration; {funcs} at step {len(rec)}; peak memory "
        f"{peak / 2**20:.1f} MiB (allocated at the start "
        f"{start_bytes / 2**20:.1f}); launches in steps 1-{steps} "
        f"{launches}")
    if profile_steps:
        res = prof.result
        ksp_w = sum(r[1] for r in rec[steps:])
        newton_w = sum(r[0] for r in rec[steps:])
        res["ksp"] = ksp_w
        res["newton"] = newton_w
        res["host_launches_per_ksp"] = (res["kernel_launches"]
                                        + res["graph_launches"]) / ksp_w
        res["device_kernels_per_ksp"] = res["device_kernels"] / ksp_w
        res["host_waits_per_ksp"] = res["host_waits"] / ksp_w
        res["host_waits_per_solve"] = res["host_waits"] / newton_w
        res["discarded_per_solve"] = res["discarded"] / newton_w
        log(f"[{tag}] torch.profiler over steps {res['steps']} "
            f"(Newton/KSP {newton_w}/{ksp_w}): wall "
            f"{res['profiled_wall_s']:.4f} s, device busy "
            f"{res['device_busy_ms']:.4f} ms in "
            f"{res['device_activities']} activities "
            f"({res['device_kernels']} kernels), idle share "
            f"{res['idle_share']:.4f}; host kernel launches "
            f"{res['kernel_launches']}, cudaGraphLaunch "
            f"{res['graph_launches']}, cudaMemcpyAsync "
            f"{res['cudaMemcpyAsync']}, host waits {res['host_waits']}; "
            f"per KSP iteration: host launches (kernel + graph, captures "
            f"included) {res['host_launches_per_ksp']:.2f}, device kernels "
            f"{res['device_kernels_per_ksp']:.2f}, host waits "
            f"{res['host_waits_per_ksp']:.2f}; per solve (Newton "
            f"iteration): host waits {res['host_waits_per_solve']:.2f}, "
            f"discarded lookahead iterations {res['discarded']} "
            f"({res['discarded_per_solve']:.2f} a solve); peak memory "
            f"{peak / 2**20:.1f} MiB")
        for name, kv in res["kernels"].items():
            log(f"[{tag}] window kernel {name}: {kv['calls']} calls, "
                f"{kv['device_ms']:.4f} device ms")
        log(f"[{tag}] window other device activities: "
            f"{res['other_calls']} calls, {res['other_device_ms']:.4f} ms; "
            f"largest {res['other_largest']}")
    require(all(r[4] for r in rec), "a step did not converge")
    u = s.u_sol.cpu().numpy()
    p = s.p_sol.cpu().numpy()
    require(np.isfinite(u).all() and np.isfinite(p).all(),
            "non-finite state")
    kmax_allowed = s.newton_params.ksp_maxiter
    require(all(r[2] < kmax_allowed for r in rec), "a solve hit ksp_max_it")
    for name in required:
        require(launches[name] > 0,
                f"kernel {name} never launched on the {tag} path")
    for name, into in FOLDED.items():
        require(launches[name] == 0,
                f"kernel {name} launched {launches[name]} times on the "
                f"{tag} path: it is folded into {into}")
        if profile_steps:
            calls = prof.result["kernels"][name]["calls"]
            require(calls == 0, f"kernel {name} ran {calls} times in the "
                                f"{tag} window: it is folded into {into}")
    if profile_steps:
        require(prof.result["host_launches_per_ksp"]
                <= MAX_HOST_LAUNCHES_PER_KSP,
                f"{prof.result['host_launches_per_ksp']:.2f} host launches "
                f"per KSP iteration in the window, more than "
                f"{MAX_HOST_LAUNCHES_PER_KSP}")
    return launches, {"ndof": ndof, "steps_per_s": sps, "peak_bytes": peak,
                      "start_bytes": start_bytes,
                      "ms_per_ksp": 1e3 * wall / ksp,
                      "steps": rec, **funcs, "profile": prof.result}


def functionals(sc):
    """c_D, c_L (the line integral and the reaction force) and dp of a
    DFG1Benchmark; the traction c_D and c_L that the dfg_2d_1 solver
    keeps of its last step."""
    if hasattr(sc, "force_coefficients"):  # DFG 3D (path M)
        cd, cl = sc.force_coefficients()
        return {"c_D": cd, "c_L": cl, "dp": sc.pressure_difference()}
    if not hasattr(sc, "compute_drag_lift"):
        s = sc.solver
        if hasattr(s, "cd"):
            return {"c_D": s.cd, "c_L": s.cl}
        # pipe_cylinder_pressurebc: the outlet flux of u_sol and, under a
        # resistance outlet, p_c
        q = float(s.form.facet_flux(s.u_sol, s.form._facet_blocks[-1]
                                    ["name"]))
        return {"outlet_flux": q, "p_c": getattr(s, "p_c", None)}
    fd, fl = sc.compute_drag_lift()
    fdr, flr = sc.compute_drag_lift(method="reaction")
    return {"c_D": 500 * fd, "c_L": 500 * fl, "c_D_reaction": 500 * fdr,
            "c_L_reaction": 500 * flr, "dp": sc.compute_pressure_diff()}


def phase_parity(torch, np, tmp, kw, tag):
    """float64 res 1.0: kernels on the card vs plain versions (CPU)."""
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    res = {}
    for dev in ("cuda", "cpu"):
        sc = DFG1Benchmark("stabilized_schur", dt=DT, T=1.0, res_scale=1.0,
                           dtype="float64", device=dev, stats_every=1,
                           output_every=100, **kw)
        t0 = time.perf_counter()
        rec = run_steps(sc, os.path.join(tmp, f"parity_{tag}_{dev}"),
                        PARITY_STEPS.get(tag, 2))
        s = sc.solver
        fd, fl = sc.compute_drag_lift()
        res[dev] = {
            "counts": [(r[0], r[1]) for r in rec],
            "u": s.u_sol.cpu().numpy(), "p": s.p_sol.cpu().numpy(),
            "f": np.array([fd, fl, sc.compute_pressure_diff()]),
        }
        log(f"[parity {tag}] {dev}: counts {res[dev]['counts']} "
            f"({time.perf_counter() - t0:.1f} s)")
    a, b = res["cuda"], res["cpu"]
    require(a["counts"] == b["counts"],
            f"{tag}: iteration counts differ: {a['counts']} vs "
            f"{b['counts']}")
    require(a["counts"] == PARITY_COUNTS[tag],
            f"{tag}: counts {a['counts']}, every earlier tree gave "
            f"{PARITY_COUNTS[tag]}")
    log(f"[parity {tag}] c_D, c_L, dp on the card {a['f'].tolist()!r}, on "
        f"the host {b['f'].tolist()!r}")
    out = {"counts": a["counts"], "f_cuda": a["f"].tolist(),
           "f_cpu": b["f"].tolist()}
    for key in ("u", "p"):
        rel = np.linalg.norm(a[key] - b[key]) / np.linalg.norm(b[key])
        log(f"[parity {tag}] {key} relative difference {rel:.3e}")
        require(rel <= 1e-9, f"{tag}: {key} differs by {rel:.3e}")
        out[key] = rel
    relf = np.abs(a["f"] - b["f"]) / np.abs(b["f"])
    log(f"[parity {tag}] c_D, c_L, dp relative differences {relf}")
    require((relf <= 1e-9).all(), f"{tag}: functionals differ: {relf}")
    out["c_D_c_L_dp"] = relf.tolist()
    return out


def phase_parity_e(torch, np, tmp):
    """Path E's float64 card run against the host's plain versions, at
    PARITY_E_RES: equal Newton and KSP counts per step (cfdtpu's), u, p
    and every step's c_D and c_L within 1e-9 relative."""
    from cfdtpu_torch.scenarios.dfg_2d_1 import DFG2D1Steady

    res = {}
    for dev in ("cuda", "cpu"):
        sc = DFG2D1Steady("dfg_2d_1", dt=DT, T=1.0, res=PARITY_E_RES,
                          dtype="float64", device=dev, stats_every=1,
                          output_every=100, **RASAMG_KW)
        t0 = time.perf_counter()
        rec = run_steps(sc, os.path.join(tmp, f"parity_e_{dev}"),
                        PARITY_E_STEPS)
        s = sc.solver
        res[dev] = {"counts": [(r[0], r[1]) for r in rec],
                    "u": s.u_sol.cpu().numpy(), "p": s.p_sol.cpu().numpy(),
                    "f": np.array([(r[5], r[6]) for r in rec])}
        log(f"[parity E] {dev}: counts {res[dev]['counts']} "
            f"({time.perf_counter() - t0:.1f} s)")
    a, b = res["cuda"], res["cpu"]
    require(a["counts"] == b["counts"] == PARITY_E_COUNTS,
            f"path E parity: counts {a['counts']} (card), {b['counts']} "
            f"(host), cfdtpu's {PARITY_E_COUNTS}")
    out = {"counts": a["counts"], "c_D_c_L_cuda": a["f"].tolist(),
           "c_D_c_L_cpu": b["f"].tolist()}
    for key in ("u", "p"):
        rel = np.linalg.norm(a[key] - b[key]) / np.linalg.norm(b[key])
        log(f"[parity E] {key} relative difference {rel:.3e}")
        require(rel <= 1e-9, f"path E parity: {key} differs by {rel:.3e}")
        out[key] = rel
    relf = np.abs(a["f"] - b["f"]) / np.abs(b["f"])
    log(f"[parity E] c_D, c_L per step on the card {a['f'].tolist()}, "
        f"relative differences {relf.tolist()}")
    require((relf <= 1e-9).all(), f"path E parity: c_D, c_L differ {relf}")
    out["c_D_c_L"] = relf.tolist()
    return out


def phase_parity_gh(torch, np, tmp):
    """PARITY_GH in float64 on the card against the host's plain
    versions at PARITY_GH_RES: equal Newton and KSP counts per step
    (cfdtpu's, PARITY_GH_COUNTS), u, p and each step's p_c within 1e-9
    relative."""
    from cfdtpu_torch.scenarios.pipe_cylinder_pressurebc import (
        PipeCylinderPressureBC)

    out = {}
    for tag, (solver, kw) in PARITY_GH.items():
        res = {}
        for dev in ("cuda", "cpu"):
            sc = PipeCylinderPressureBC(
                solver, dt=DT, T=1.0, res_scale=PARITY_GH_RES,
                dtype="float64", device=dev, stats_every=1,
                output_every=100, **PIPE_KW, **kw)
            t0 = time.perf_counter()
            rec = run_steps(sc, os.path.join(
                tmp, f"parity_{tag.replace(' ', '_')}_{dev}"),
                            PARITY_GH_STEPS)
            s = sc.solver
            res[dev] = {"counts": [(r[0], r[1]) for r in rec],
                        "u": s.u_sol.cpu().numpy(),
                        "p": s.p_sol.cpu().numpy(),
                        "p_c": np.array([r[7] or 0.0 for r in rec])}
            log(f"[parity {tag}] {dev}: counts {res[dev]['counts']} p_c "
                f"{res[dev]['p_c'].tolist()} "
                f"({time.perf_counter() - t0:.1f} s)")
        a, b = res["cuda"], res["cpu"]
        require(a["counts"] == b["counts"] == PARITY_GH_COUNTS[tag],
                f"path {tag} parity: counts {a['counts']} (card), "
                f"{b['counts']} (host), cfdtpu's {PARITY_GH_COUNTS[tag]}")
        o = {"counts": a["counts"], "p_c_cuda": a["p_c"].tolist(),
             "p_c_cpu": b["p_c"].tolist()}
        for key in ("u", "p"):
            rel = np.linalg.norm(a[key] - b[key]) / np.linalg.norm(b[key])
            log(f"[parity {tag}] {key} relative difference {rel:.3e}")
            require(rel <= 1e-9, f"path {tag} parity: {key} differs by "
                                 f"{rel:.3e}")
            o[key] = rel
        dp = float(np.abs(a["p_c"] - b["p_c"]).max())
        scale = float(np.abs(b["p_c"]).max())
        require(dp <= 1e-9 * max(scale, 1e-300) or scale == 0 == dp,
                f"path {tag} parity: p_c differs by {dp:.3e}")
        o["p_c"] = dp
        out[tag] = o
    return out


def launched(kernels, names, tag):
    got = kernels.counts()
    for name in names:
        require(got[name] > 0, f"kernel {name} never launched on {tag}")
    return {k: v for k, v in got.items() if v}


def phase_path_j(torch, np):
    """Path J: validate_ghia's solve_case on the card at PATH_J, each
    step's wall time (the card idle at its end), Newton and KSP counts,
    peak memory, and the deviation from Ghia's profile at the 17
    published points, under GHIA_MAX_ERR."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.scripts.validate_ghia import CASES, solve_case

    out, launches = {}, {}
    for re, dtype in PATH_J:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        walls = []
        last = [time.perf_counter()]

        def on_step(i):
            torch.cuda.synchronize()
            now = time.perf_counter()
            walls.append(now - last[0])
            last[0] = now

        res = solve_case(re, quiet=False, device="cuda", dtype=dtype,
                         on_step=on_step)
        peak = torch.cuda.max_memory_allocated()
        s = res["scenario"].solver
        ndof = s.V.num_global_dofs + s.Q.num_global_dofs
        for i, ((n, k), w) in enumerate(zip(res["counts"], walls), 1):
            log(f"[path J Re {re}] step {i}: newton {n} ksp {k} wall "
                f"{w:.4f} s")
        log(f"[path J Re {re}] nx {res['nx']}, {ndof} DOF {dtype}: "
            f"{res['steps']} of {CASES[re][2]} steps, "
            f"{res['wall_s'] / res['steps']:.4f} s a step, Newton "
            f"{sum(c[0] for c in res['counts'])} KSP "
            f"{sum(c[1] for c in res['counts'])} in all; max|u - u_Ghia| "
            f"{res['max_err']:.6f}, rms {res['rms_err']:.6f} at the 17 "
            f"points; peak memory {peak / 2**20:.1f} MiB")
        require(np.isfinite(res["u"]).all(), f"Re {re}: non-finite profile")
        require(res["max_err"] < GHIA_MAX_ERR,
                f"Re {re}: max|u - u_Ghia| {res['max_err']:.4f} is not "
                f"under {GHIA_MAX_ERR}")
        launches[re] = launched(kernels, PATH_J_KERNELS, f"path J Re {re}")
        out[re] = {k: v for k, v in res.items() if k != "scenario"}
        out[re].update(ndof=ndof, peak_bytes=peak, walls=walls,
                       u=res["u"].tolist())
        del res, s
    return launches, out


def phase_path_k(torch, np, tmp):
    """Path K: DFG 2D-2 at PATH_K_RES, PATH_K_LEG steps with a
    checkpoint at their end, then a second scenario resumed from it to
    2 PATH_K_LEG. bdforces.txt must hold one finite row a step with
    contiguous indices and strictly increasing times, the first leg's
    rows unchanged; the recorder reads no force to the host before a
    flush (each step callback sees the rows of the last flush only)."""
    from cfdtpu_torch import kernels
    from cfdtpu_torch.scenarios.pipe_cylinder import (
        PipeCylinder2D2Simulation)
    from cfdtpu_torch.scripts.validate_dfg2d2 import DFG2D2_KW

    out_dir = os.path.join(tmp, "path_k")
    ckpt = os.path.join(out_dir, "checkpoint.npz")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    legs = []
    for leg in (1, 2):
        t0 = time.perf_counter()
        sc = PipeCylinder2D2Simulation(
            "stabilized_schur", dt=PATH_K_DT,
            T=(leg * PATH_K_LEG - 0.5) * PATH_K_DT, res_scale=PATH_K_RES,
            device="cuda", output_every=10 ** 6,
            resume_from=ckpt if leg == 2 else None,
            **dict(DFG2D2_KW, checkpoint_every=PATH_K_LEG))
        s = sc.solver
        ndof = s.V.num_global_dofs + s.Q.num_global_dofs
        setup = time.perf_counter() - t0
        seen, stats = [], []

        def after(t, sc=sc, seen=seen, stats=stats):
            seen.append(len(sc._force_rows))
            st = sc.solver.last_stats
            if not st.get("skipped"):
                stats.append((len(seen) + (leg - 1) * PATH_K_LEG,
                              st["newton_iters"], st["ksp_iters"],
                              st["converged"]))

        t0 = time.perf_counter()
        sc.solve(out_dir, afterStepCallback=after)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows = np.loadtxt(os.path.join(out_dir, "bdforces.txt"), ndmin=2)
        legs.append({"ndof": ndof, "setup_s": setup, "wall_s": wall,
                     "stats": stats, "seen": seen, "rows": rows})
        log(f"[path K leg {leg}] {ndof} DOF float32, obstacle facets "
            f"{len(sc.mesh.tagged_facets(sc.obstacle_marker))}: set-up "
            f"{setup:.1f} s, {len(seen)} steps in {wall:.2f} s "
            f"({wall / len(seen):.4f} s a step, outputs and the "
            f"checkpoint included); Newton/KSP at the fetched steps "
            f"{[(i, n, k) for i, n, k, _ in stats]}")
        require(all(c for *_, c in stats), f"path K leg {leg}: a step did "
                                           f"not converge: {stats}")
        before = (leg - 1) * PATH_K_LEG
        require(seen == [before] * PATH_K_LEG,
                f"path K leg {leg}: force rows reached the host before a "
                f"flush: {seen}")
        del sc, s
    peak = torch.cuda.max_memory_allocated()
    rows, first = legs[1]["rows"], legs[0]["rows"]
    n = 2 * PATH_K_LEG
    require(rows.shape == (n, 4), f"path K: bdforces.txt {rows.shape}")
    require(list(rows[:, 0]) == list(range(n)),
            f"path K: indices {rows[:, 0]}")
    require(np.all(np.diff(rows[:, 1]) > 0), "path K: times not increasing")
    require(np.isfinite(rows).all(), "path K: non-finite forces")
    require(np.array_equal(rows[:PATH_K_LEG], first),
            "path K: the resumed leg changed the first leg's rows")
    launches = launched(kernels, PATH_K_KERNELS, "path K")
    tpu = os.path.join(HERE, PATH_K_TPU_SERIES)
    ref = np.loadtxt(tpu, ndmin=2)[:n] if os.path.exists(tpu) else None
    for i in range(n):
        beside = ("" if ref is None else
                  f" | JAX package on TPU: c_D {ref[i, 2]:.8e} "
                  f"c_L {ref[i, 3]:.8e}")
        log(f"[path K] row {i}: t {rows[i, 1]:.6f} c_D {rows[i, 2]:.8e} "
            f"c_L {rows[i, 3]:.8e}{beside}")
    log(f"[path K] {n} rows across the resume, peak memory "
        f"{peak / 2**20:.1f} MiB; launches {launches}")
    for leg in legs:
        leg["rows"] = leg["rows"].tolist()
    return launches, {"legs": legs, "peak_bytes": peak,
                      "tpu_rows": None if ref is None else ref.tolist()}


def read_ffr(path):
    with open(os.path.join(path, "ffr.txt")) as fh:
        txt = fh.read()
    require("FFR" in txt, f"ffr.txt without FFR: {txt}")
    return float(txt.split("FFR = p_distal / p_proximal:")[1].split()[0])


def phase_path_l(torch, np, tmp):
    """Path L: the stenosis (FFR) and the stenosis with its 2D tree (the
    local Reynolds field) on the card, float32, through phase_slice."""
    from cfdtpu_torch.scenarios import stenosis
    from cfdtpu_torch.scenarios import stenosis_with_tree_2d_pressure as tree

    out = {}
    launches = {}
    for tag, name, dt, steps in PATH_L:
        cls = getattr(stenosis if tag == "stenosis" else tree, name)
        t0 = time.perf_counter()
        sc = cls("stabilized_schur_pressurebc", dt=dt, T=1.0,
                 device="cuda", output_every=100)
        s = sc.solver
        ft = sc.mesh.facet_tags
        tags = {int(t): int((ft == t).sum()) for t in np.unique(ft)}
        log(f"[setup] path L {tag}: res 0.15 float32, dt {dt}, on cuda: "
            f"{time.perf_counter() - t0:.1f} s; facets by tag {tags}; "
            f"pressure pinned {s.pin_pressure}")
        require(not s.pin_pressure, f"path L {tag}: a pressure dof pinned")
        d = os.path.join(tmp, f"path_l_{tag}")
        launches[tag], res = phase_slice(torch, np, sc, d, f"path L {tag}",
                                         steps, PATH_L_KERNELS)
        u = s.u_sol.cpu().numpy()
        res["ffr"] = read_ffr(d)
        res["mean_u_x"] = float(u[:, 0].mean())
        if tag == "stenosis":
            # tests/test_hemodynamic.py's checks, and an FFR in (0, 1)
            require(res["mean_u_x"] > 0, f"path L: mean u_x "
                                         f"{res['mean_u_x']} <= 0")
            require(0 < res["ffr"] < 1, f"path L: FFR {res['ffr']}")
        else:
            require(os.path.exists(os.path.join(d, "reynolds_000000.vtu")),
                    "path L: the reynolds VTU was not written")
            res["max_local_re"] = float(sc.reynolds.max())
            require(np.isfinite(sc.reynolds).all(), "non-finite Reynolds")
        log(f"[path L {tag}] FFR {res['ffr']!r}, mean u_x "
            f"{res['mean_u_x']:.6f} mm/s"
            + (f", max local Re {res['max_local_re']:.4f}"
               if tag == "tree" else ""))
        out[tag] = res
        del sc, s
    return launches, out


def phase_parity_jkl(torch, np, tmp):
    """Paths J, K and L's float64 card runs against the host's plain
    versions: equal Newton and KSP counts a step, u and p (J: and the
    Ghia deviation; K: every force row; L: the FFR) within 1e-9
    relative."""
    from cfdtpu_torch.scenarios.pipe_cylinder import (
        PipeCylinder2D2Simulation)
    from cfdtpu_torch.scenarios.stenosis import StenosisSimulation
    from cfdtpu_torch.scripts.validate_dfg2d2 import DFG2D2_KW
    from cfdtpu_torch.scripts.validate_ghia import solve_case

    def run_j(dev):
        r = solve_case(quiet=True, device=dev, dtype="float64", **PARITY_J)
        s = r["scenario"].solver
        return {"counts": r["counts"], "u": s.u_sol.cpu().numpy(),
                "p": s.p_sol.cpu().numpy(), "f": np.array([r["max_err"]])}

    def run_k(dev):
        sc = PipeCylinder2D2Simulation(
            "stabilized_schur", dt=PATH_K_DT, T=1.0, res_scale=PARITY_K_RES,
            dtype="float64", device=dev, output_every=100,
            **dict(DFG2D2_KW, checkpoint_every=0, stats_every=1))
        d = os.path.join(tmp, f"parity_k_{dev}")
        rec = run_steps(sc, d, 2)
        s = sc.solver
        # the recorder's rows at full precision (bdforces.txt keeps 9
        # digits)
        return {"counts": [(r[0], r[1]) for r in rec],
                "u": s.u_sol.cpu().numpy(), "p": s.p_sol.cpu().numpy(),
                "f": np.asarray(sc._force_rows)[:, 2:].ravel()}

    def run_l(dev):
        sc = StenosisSimulation("stabilized_schur_pressurebc",
                                dt=PATH_L[0][2], T=1.0, res=PARITY_L_RES,
                                dtype="float64", device=dev,
                                output_every=100)
        d = os.path.join(tmp, f"parity_l_{dev}")
        rec = run_steps(sc, d, 2)
        s = sc.solver
        return {"counts": [(r[0], r[1]) for r in rec],
                "u": s.u_sol.cpu().numpy(), "p": s.p_sol.cpu().numpy(),
                "f": np.array([sc._compute_ffr(d)])}

    out = {}
    for tag, fn in (("J", run_j), ("K", run_k), ("L", run_l)):
        res = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res[dev] = fn(dev)
            log(f"[parity {tag}] {dev}: counts {res[dev]['counts']} "
                f"functionals {res[dev]['f'].tolist()!r} "
                f"({time.perf_counter() - t0:.1f} s)")
        a, b = res["cuda"], res["cpu"]
        require(a["counts"] == b["counts"],
                f"path {tag} parity: counts {a['counts']} (card), "
                f"{b['counts']} (host)")
        o = {"counts": a["counts"], "f_cuda": a["f"].tolist(),
             "f_cpu": b["f"].tolist()}
        for key in ("u", "p"):
            rel = np.linalg.norm(a[key] - b[key]) / np.linalg.norm(b[key])
            log(f"[parity {tag}] {key} relative difference {rel:.3e}")
            require(rel <= 1e-9, f"path {tag} parity: {key} differs by "
                                 f"{rel:.3e}")
            o[key] = rel
        relf = float((np.abs(a["f"] - b["f"]) / np.abs(b["f"])).max())
        log(f"[parity {tag}] functionals relative difference {relf:.3e}")
        require(relf <= 1e-9, f"path {tag} parity: functionals differ by "
                              f"{relf:.3e}")
        o["f"] = relf
        out[tag] = o
    return out


def phase_gather_micro():
    """Path B: the gather_micro entry point, as a user runs it."""
    cmd = [sys.executable, "-m", "cfdtpu_torch.scripts.gather_micro",
           "--device", "cuda"]
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=600)
    tail = (res.stdout + res.stderr)[-3000:]
    require(res.returncode == 0, f"gather_micro exited {res.returncode}:\n"
                                 f"{tail}")
    for ln in res.stdout.splitlines()[:-1]:
        log(f"[gather_micro] {ln}")
    got = json.loads(res.stdout.strip().splitlines()[-1])["gather_micro"]
    for r in got["patch_spmv"]:
        require(r["ok"] and r["rel_err"] <= 1e-5,
                f"gather_micro K5 at P={r['P']} K={r['K']}: rel err "
                f"{r['rel_err']:.3e}")
    require(got["launches"]["patch_spmv"] > 0,
            "gather_micro did not launch K5")
    log(f"[gather_micro] ok in {time.perf_counter() - t0:.1f} s; launches "
        f"{got['launches']}")
    return got


def start_cli(tmp, name, flags=(), device="cuda", simulation="dfg_1",
              solver="stabilized_schur", size=("--res_scale", "1.0"),
              want=None, times=("0.1", "0.05"), files=()):
    """Start the CLI as a user runs it (T and dt `times`: two steps),
    its output to files; device None leaves out --device, and the run
    must then take the card by default. `want`: a line the run must
    print every step (dfg_2d_1's `DFG Metrics:`); `files`: what the run
    directory must hold beside the common outputs. finish_cli waits for
    it and checks it."""
    out = os.path.join(tmp, f"cli_{name}")
    os.makedirs(out, exist_ok=True)
    dev = [] if device is None else ["--device", device]
    cmd = [sys.executable, "-m", "cfdtpu_torch", "simulate",
           "--simulation", simulation, "--solver", solver,
           "--T", times[0], "--dt", times[1], *size,
           *dev, "--output_dir", out, *flags]
    env = dict(os.environ, PYTHONPATH=HERE)
    logs = [open(os.path.join(out, k), "w+") for k in ("stdout", "stderr")]
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=logs[0],
                            stderr=logs[1], text=True)
    return dict(name=name, proc=proc, logs=logs, out=out,
                simulation=simulation, want=want, files=files,
                t0=time.perf_counter())


def finish_cli(run, timeout=600):
    """Wait for a CLI run (start_cli): exit 0, its run directory and
    files, the card, and the `want` line every step."""
    name, proc = run["name"], run["proc"]
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    outs = []
    for fh in run["logs"]:
        fh.seek(0)
        outs.append(fh.read())
    stdout, stderr = outs
    tail = (stdout + stderr)[-3000:]
    require(proc.returncode == 0,
            f"CLI {name} exited {proc.returncode}:\n{tail}")
    runs = glob.glob(os.path.join(run["out"], run["simulation"], "*"))
    require(len(runs) == 1, f"CLI run directory missing: {runs}")
    for fname in ("simulation_params.txt", "norms.txt", "v.pvd",
                  *run["files"]):
        require(os.path.exists(os.path.join(runs[0], fname)),
                f"CLI {name} did not write {fname}")
    require("'device': 'cuda'" in stdout,
            f"CLI {name} did not run on the card:\n{tail}")
    want = run["want"]
    if want is not None:
        n_want = sum(want in ln for ln in stdout.splitlines())
        require(n_want == 2, f"CLI {name} printed {n_want} lines with "
                             f"{want!r}, not one a step:\n{tail}")
    log(f"[cli {name}] ok in {time.perf_counter() - run['t0']:.1f} s: "
        + " | ".join(ln.strip() for ln in stdout.splitlines()
                     if ln.strip().startswith(("Solver converged", "Drag",
                                               "Lift", "Pressure",
                                               "DFG Metrics", "FFR ="))))


def phase_parity_and_cli(torch, np, tmp, lap):
    """The parity runs (phase_parity, phase_parity_e, phase_parity_gh,
    phase_parity_jkl) with the seven CLI runs going at the same time,
    each a process of its own on the card: the default inner method, the
    rasamg_sup flags with and without --device, dfg_2d_1 at
    PARITY_E_RES in float64, lid_driven2D under stabilized_schur_bdf2
    (benchmark_100.csv), and the stenosis under
    stabilized_schur_pressurebc (ffr.txt) with and without --device.
    Every CLI process is waited for (killed first if a parity run
    failed)."""
    lid = dict(simulation="lid_driven2D", solver="stabilized_schur_bdf2",
               size=("--nx", "32", "--mu", "0.01"), times=("1.0", "0.5"),
               files=("benchmark_100.csv",))
    sten = dict(simulation="stenosis", solver="stabilized_schur_pressurebc",
                size=("--res", "0.3"), times=("0.01", "0.005"),
                files=("ffr.txt",))
    clis = [start_cli(tmp, "amg_p"),
            start_cli(tmp, "rasamg_sup", RASAMG_FLAGS),
            start_cli(tmp, "rasamg_sup_default_device", RASAMG_FLAGS,
                      device=None),
            start_cli(tmp, "dfg_2d_1", simulation="dfg_2d_1",
                      solver="dfg_2d_1",
                      size=("--res", str(PARITY_E_RES), "--dtype",
                            "float64"), want="DFG Metrics:"),
            start_cli(tmp, "lid_driven2D", **lid),
            start_cli(tmp, "stenosis", **sten),
            start_cli(tmp, "stenosis_default_device", device=None, **sten)]
    parity = {}
    try:
        for tag, kw in (("rasamg_sup", RASAMG_KW), ("amg_p", SLICE_KW),
                        ("path_c", PATH_C_KW),
                        ("gmres", PATH_D["gmres"][1])):
            parity[tag] = phase_parity(torch, np, tmp, kw, tag)
            lap(f"parity {tag}")
        parity["path_e"] = phase_parity_e(torch, np, tmp)
        lap("parity path E")
        parity["paths_gh"] = phase_parity_gh(torch, np, tmp)
        lap("parity paths G and H")
        parity["paths_jkl"] = phase_parity_jkl(torch, np, tmp)
        lap("parity paths J, K and L")
        for run in clis:
            finish_cli(run)
        lap("CLI (the wait after the parity runs)")
    finally:
        for run in clis:
            if run["proc"].poll() is None:
                run["proc"].kill()
                run["proc"].wait()
            for fh in run["logs"]:
                fh.close()
    return parity


# ----------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=None,
                    help="also write every measured number to this JSON")
    ap.add_argument("--path-m-only", action="store_true",
                    help="run phases 1, 2 and 19 alone (DFG 3D-1Z on P1 "
                         "tetrahedra)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import cfdtpu_torch  # noqa: F401  (fails outside a checkout)
    from cfdtpu_torch.scenarios.dfg_1 import DFG1Benchmark

    t_start = time.perf_counter()
    phase_s = {}
    t_lap = [t_start]

    def lap(label):
        now = time.perf_counter()
        phase_s[label] = now - t_lap[0]
        log(f"[time] {label}: {phase_s[label]:.1f} s")
        t_lap[0] = now

    smi = phase_card(torch)
    phase_build()
    lap("build")

    def scenario(res_scale, dtype, stats_every, kw):
        t0 = time.perf_counter()
        sc = DFG1Benchmark("stabilized_schur", dt=DT, T=1.0,
                           res_scale=res_scale, dtype=dtype, device="cuda",
                           stats_every=stats_every, output_every=100, **kw)
        log(f"[setup] res_scale {res_scale} {dtype} "
            f"{kw['pc_inner_method']} scenario on cuda: "
            f"{time.perf_counter() - t0:.1f} s")
        return sc

    from cfdtpu_torch.utils.cudatime import empty_ms

    floor_ms = empty_ms()
    log(f"[kernels] empty kernel through the library's C interface: "
        f"{floor_ms:.4f} ms (the floor of a small site)")
    if args.path_m_only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            rows, one_launch, launches_m, slice_m = phase_path_m(torch, np,
                                                                 tmp)
        lap("path M")
        return finish(args, torch, smi, floor_ms, rows, {"M": launches_m},
                      {"M": slice_m["profile"]["kernels"]},
                      {"slice_path_m": slice_m,
                       "one_launch": {"path M": one_launch},
                       "phase_s": phase_s}, t_start)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sc = scenario(0.3, "float32", 4, RASAMG_KW)
        rows, plains = phase_kernels(torch, np, sc, 1e-5, timed=True)
        lap("kernels float32")
        one_launch = phase_one_launch(torch, np, sc)
        one_launch["preconditioner"] = phase_pc_launches(torch, np, sc)
        graphs = {"rasamg_sup": phase_graph(
            torch, np, sc, "rasamg_sup", want=GRAPH_KERNELS["rasamg_sup"])}
        lap("one launch")
        phase_plain_times(rows, plains)
        del plains  # their inputs, before the slices' peak memory
        lap("plain times")
        sc64 = scenario(1.0, "float64", 1, RASAMG_KW)
        phase_kernels(torch, np, sc64, 1e-12, timed=False)
        del sc64
        lap("kernels float64")
        determinism = phase_determinism(torch, np, sc)
        lap("determinism")

        launches_a, slice_a = phase_slice(
            torch, np, sc, os.path.join(tmp, "slice_a"), "rasamg_sup", 10,
            PATH_A_KERNELS, profile_steps=4)
        determinism["replay_after_rebuild"] = {
            "rasamg_sup": phase_replay_after_rebuild(torch, np, sc,
                                                     "rasamg_sup")}
        del sc
        lap("path A")
        base_a = graphs["rasamg_sup"]["other_kernels"]
        sc_c = scenario(0.3, "float32", 4, PATH_C_KW)
        launches_c, slice_c = phase_slice(
            torch, np, sc_c, os.path.join(tmp, "slice_c"), "path C", 8,
            PATH_C_KERNELS, profile_steps=4)
        graphs["path C"] = phase_graph(torch, np, sc_c, "path C", base_a)
        del sc_c
        lap("path C")
        sc_p = scenario(0.3, "float32", 4, SLICE_KW)
        launches_p, slice_p = phase_slice(
            torch, np, sc_p, os.path.join(tmp, "slice_amg_p"), "amg_p", 8,
            AMG_P_KERNELS)
        determinism["replay_after_rebuild"]["amg_p"] = (
            phase_replay_after_rebuild(torch, np, sc_p, "amg_p"))
        graphs["amg_p"] = phase_graph(torch, np, sc_p, "amg_p",
                                      want=GRAPH_KERNELS["amg_p"])
        base_p = graphs["amg_p"]["other_kernels"]
        del sc_p
        lap("amg_p")
        launches_d, slices_d = {}, {}
        for method, (res, kw, required) in PATH_D.items():
            sc_d = scenario(res, "float32", 4, kw)
            got, slices_d[method] = phase_slice(
                torch, np, sc_d, os.path.join(tmp, f"slice_{method}"),
                f"path D {method}", PATH_D_STEPS, required,
                profile_steps=PATH_D_PROFILE)
            for name, n in got.items():
                launches_d[name] = launches_d.get(name, 0) + n
            graphs[f"path D {method}"] = phase_graph(
                torch, np, sc_d, f"path D {method}", base_p)
            del sc_d
            lap(f"path D {method}")
        # path E: DFG 2D-1 steady with the dfg_2d_1 solver, float64
        from cfdtpu_torch.scenarios.dfg_2d_1 import DFG2D1Steady

        t0 = time.perf_counter()
        sc_e = DFG2D1Steady("dfg_2d_1", dt=DT, T=1.0, res=PATH_E_RES,
                            dtype="float64", device="cuda", stats_every=1,
                            output_every=100, **RASAMG_KW)
        log(f"[setup] path E: res {PATH_E_RES} float64 dfg_2d_1 on cuda: "
            f"{time.perf_counter() - t0:.1f} s")
        rows_e, plains_e = phase_kernels(
            torch, np, sc_e, 1e-12, timed=True,
            sites=variant_sites(torch, np, sc_e.solver, torch.float64, "E"))
        phase_kernels(torch, np, sc_e, 1e-5, timed=False,
                      sites=variant_sites(torch, np, sc_e.solver,
                                          torch.float32, "E"))
        one_launch["path E"] = phase_one_launch_form(torch, np, sc_e, "E")
        phase_plain_times(rows_e, plains_e)
        rows.update(rows_e)
        del plains_e
        launches_e, slice_e = phase_slice(
            torch, np, sc_e, os.path.join(tmp, "slice_e"), "path E",
            PATH_E_STEPS, PATH_E_KERNELS, profile_steps=PATH_E_PROFILE)
        del sc_e
        lap("path E")
        # path F: stabilized_schur_bdf2, float32
        t0 = time.perf_counter()
        sc_f = DFG1Benchmark("stabilized_schur_bdf2", dt=DT, T=1.0,
                             res_scale=0.3, dtype="float32", device="cuda",
                             stats_every=4, output_every=100, **RASAMG_KW)
        log(f"[setup] path F: res_scale 0.3 float32 stabilized_schur_bdf2 "
            f"on cuda: {time.perf_counter() - t0:.1f} s")
        rows_f, plains_f = phase_kernels(
            torch, np, sc_f, 1e-5, timed=True,
            sites=variant_sites(torch, np, sc_f.solver, torch.float32, "F"))
        phase_kernels(torch, np, sc_f, 1e-12, timed=False,
                      sites=variant_sites(torch, np, sc_f.solver,
                                          torch.float64, "F"))
        one_launch["path F"] = phase_one_launch_form(torch, np, sc_f, "F")
        phase_plain_times(rows_f, plains_f)
        rows.update(rows_f)
        del plains_f
        launches_f, slice_f = phase_slice(
            torch, np, sc_f, os.path.join(tmp, "slice_f"), "path F",
            PATH_F_STEPS, PATH_F_KERNELS, profile_steps=PATH_F_PROFILE)
        bdf = [sc_f.solver._bdf]
        require(sc_f.solver.step_count == PATH_F_STEPS + PATH_F_PROFILE
                and bdf == [(1.5, -2.0, 0.5)],
                f"path F ended on coefficients {bdf}, not BDF2's")
        del sc_f
        lap("path F")
        # paths G and H: pipe_cylinder_pressurebc under the weak-pressure
        # solvers, float32 at 106,275 DOF (sites timed in float32, checked
        # in float64 too)
        from cfdtpu_torch.scenarios.pipe_cylinder_pressurebc import (
            PipeCylinderPressureBC)

        launches_gh, slices_gh = {}, {}
        for tag, (solver, kw) in PATH_GH.items():
            t0 = time.perf_counter()
            sc_g = PipeCylinderPressureBC(
                solver, dt=DT, T=1.0, res_scale=0.3, dtype="float32",
                device="cuda", stats_every=4, output_every=100, **PIPE_KW,
                **kw)
            sg = sc_g.solver
            log(f"[setup] path {tag}: res_scale 0.3 float32 {solver} "
                f"({kw['pc_inner_method']}) on "
                f"cuda: {time.perf_counter() - t0:.1f} s; facet blocks "
                f"{[(b['name'], b['term'].term, len(b['dofmap_u']))
                    for b in sg.form._facet_blocks]}"
                f"; pressure pinned {sg.pin_pressure}")
            require(not sg.pin_pressure and len(sg.bc_dofs_p) == 0,
                    f"path {tag}: a pressure dof is pinned")
            rows_g, plains_g = phase_kernels(
                torch, np, sc_g, 1e-5, timed=True,
                sites=variant_sites(torch, np, sg, torch.float32, tag))
            phase_kernels(torch, np, sc_g, 1e-12, timed=False,
                          sites=variant_sites(torch, np, sg, torch.float64,
                                              tag))
            one_launch[f"path {tag}"] = phase_one_launch_form(
                torch, np, sc_g, tag)
            phase_plain_times(rows_g, plains_g)
            rows.update(rows_g)
            del plains_g
            launches_gh[tag], slices_gh[tag] = phase_slice(
                torch, np, sc_g, os.path.join(tmp, f"slice_{tag}"),
                f"path {tag}", PATH_GH_STEPS, PATH_GH_KERNELS[tag],
                profile_steps=PATH_GH_PROFILE)
            key = "curl_p1" if tag == "G" else "p1"
            lg = launches_gh[tag]
            # every residual and every Jacobian build one element launch
            # with the blocks in it
            for kind in ("residual", "jacobian"):
                require(lg[f"ns_cell_{kind}_{key}"]
                        == lg[f"ns_cell_{kind}_{key}_facet"] > 0,
                        f"path {tag}: {kind} launches without the facet "
                        f"blocks: {lg}")
            del sc_g, sg
            lap(f"path {tag}")
        # path I: K18 under the curl-curl form on DFG 2D-1's channel
        launches_i = {}
        for mode, solver in PATH_I.items():
            t0 = time.perf_counter()
            sc_i = DFG1Benchmark(solver, dt=DT, T=1.0, res_scale=PATH_I_RES,
                                 dtype="float32", device="cuda", v_max=0.3,
                                 stats_every=1, output_every=100,
                                 **SLICE_KW)
            log(f"[setup] path I {mode}: res_scale {PATH_I_RES} float32 "
                f"{solver} (amg_p) on cuda: "
                f"{time.perf_counter() - t0:.1f} s")
            rows_i, plains_i = phase_kernels(
                torch, np, sc_i, 1e-5, timed=True,
                sites=variant_sites(torch, np, sc_i.solver, torch.float32,
                                    "I"))
            phase_kernels(torch, np, sc_i, 1e-12, timed=False,
                          sites=variant_sites(torch, np, sc_i.solver,
                                              torch.float64, "I"))
            phase_plain_times(rows_i, plains_i)
            rows.update(rows_i)
            del plains_i
            got, _ = phase_slice(
                torch, np, sc_i, os.path.join(tmp, f"slice_i_{mode}"),
                f"path I {mode}", PATH_I_STEPS,
                (*PATH_I_KERNELS, f"ns_facet_{mode}_p1_fused",
                 f"ns_facet_{mode}_jac_p1_fused"))
            for name, n in got.items():
                launches_i[name] = launches_i.get(name, 0) + n
            del sc_i
            lap(f"path I {mode}")
        # paths J, K and L: the 2D scenarios against their oracles
        launches_j, path_j = phase_path_j(torch, np)
        lap("path J")
        launches_k, path_k = phase_path_k(torch, np, tmp)
        lap("path K")
        launches_l, path_l = phase_path_l(torch, np, tmp)
        lap("path L")
        rows_m, one_launch["path M"], launches_m, slice_m = phase_path_m(
            torch, np, tmp)
        rows.update(rows_m)
        lap("path M")
        gm = phase_gather_micro()
        lap("path B")
        parity = phase_parity_and_cli(torch, np, tmp, lap)

    launches = {"A": launches_a, "B": gm["launches"], "C": launches_c,
                "D": launches_d, "E": launches_e, "F": launches_f,
                "G": launches_gh["G"], "H": launches_gh["H"],
                "I": launches_i, "M": launches_m}
    # each kernel's calls in the profiled window of its path (path D:
    # the three methods' windows)
    windows = {"A": slice_a["profile"]["kernels"],
               "B": slice_a["profile"]["kernels"],
               "C": slice_c["profile"]["kernels"], "D": {},
               "E": slice_e["profile"]["kernels"],
               "F": slice_f["profile"]["kernels"],
               "G": slices_gh["G"]["profile"]["kernels"],
               "H": slices_gh["H"]["profile"]["kernels"], "I": {},
               "M": slice_m["profile"]["kernels"]}
    for res in slices_d.values():
        for name, kv in (res["profile"] or {"kernels": {}})["kernels"].items():
            acc = windows["D"].setdefault(name, {"calls": 0,
                                                 "device_ms": 0.0})
            acc["calls"] += kv["calls"]
            acc["device_ms"] += kv["device_ms"]
    return finish(args, torch, smi, floor_ms, rows, launches, windows, {
        "slice_rasamg_sup": slice_a, "slice_amg_p": slice_p,
        "launches_amg_p": launches_p, "slice_path_c": slice_c,
        "slices_path_d": slices_d, "slice_path_e": slice_e,
        "slice_path_f": slice_f, "slices_paths_gh": slices_gh,
        "slice_path_m": slice_m, "path_j": path_j, "path_k": path_k,
        "path_l": path_l,
        "launches_jkl": {"J": launches_j, "K": launches_k, "L": launches_l},
        "graphs": graphs, "parity": parity, "determinism": determinism,
        "gather_micro": gm, "one_launch": one_launch,
        "phase_s": phase_s}, t_start)


def finish(args, torch, smi, floor_ms, rows, launches, windows, report,
           t_start):
    """The kernels line (a SOURCES entry for each kernel whose path ran)
    and the ok line; with --report, every number to that JSON."""
    entries = []
    for name, (src, replaces, site, path) in SOURCES.items():
        if path not in launches:
            continue
        r = rows[site]
        window = windows[path]
        counter, into = COUNTER_OF.get(name, (name, FOLDED.get(name)))
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "site": site, "path": PATHS[path],
            "launches": launches[path][counter],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "warm_ms": r["warm_ms"], "device_ms": r["device_ms"],
            "window_calls": window.get(name, {}).get("calls", 0),
            "window_device_ms": window.get(name, {}).get("device_ms", 0.0),
        })
        if "equals_pair" in r:
            entries[-1].update(equals_pair=r["equals_pair"],
                               pair_device_ms=r["pair_device_ms"])
        if into is not None:
            # the element launches that carried its body
            entries[-1].update(
                folded_into=into,
                launches_fused=launches[path].get(counter + "_fused", 0))
    log(f"[done] chip_smoke command time "
        f"{time.perf_counter() - t_start:.1f} s; empty profiler traces "
        f"taken again: {PROFILER_RETRIES}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as fh:
            json.dump({"card": smi, "empty_kernel_ms": floor_ms,
                       "sites": rows, **report, "launches": launches,
                       "profiler_retries": PROFILER_RETRIES,
                       "kernels": entries}, fh, indent=1, default=str)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
