"""Schur-complement fieldsplit preconditioner (SELFP-style).

The counterpart of cfdtpu/la/schur.py. Full (LDU) application for rhs
(r_u, r_p):
    z_u1 = Auu^-1 r_u
    r_s  = r_p - A_pu z_u1
    z_p  = S^-1 r_s
    z_u  = z_u1 - Auu^-1 (A_up z_p)

inner_method picks the velocity stage Auu^-1, the Schur operator S and
its solve:
    gmres       gmres_fixed(Auu, M = node-block Jacobi, m_u);
                gmres_fixed(S, M = v / d_p, m_p)
    chebyshev_p gmres_fixed(Auu, M = node-block Jacobi, m_u);
                chebyshev_fixed(S, m_p) on [0.06, 1] lambda_max(D_p^-1 S)
    chebyshev   chebyshev_fixed(Auu, m_u) and chebyshev_fixed(S, m_p),
                lambda_u and lambda_p power-iterated at build
                (la/chebyshev.py)
and the AMG family, whose S stage is gmres_fixed(S, M = SELFP-AMG cycle,
m_p):
    amg_p       gmres_fixed(Auu, M = node-block Jacobi, m_u)
    amg_up      gmres_fixed(Auu, M = block-AMG V-cycle, m_u)
    ras_up      gmres_fixed(Auu, M = RAS, m_u)
    rasamg_up   gmres_fixed(Auu, M = block-AMG V-cycle with a RAS fine
                smoother, m_u)
    amg_sup, rasamg_sup
                as amg_up / rasamg_up, and S becomes the near-true Schur
                operator App - Apu V(Aup) with one block-AMG V-cycle V
                in place of diag(Auu)^-1
With a block-AMG V-cycle available and m_u == 0, the velocity stage is
preonly: one V-cycle, no Krylov wrap. Otherwise S is the SELFP action
App - Apu diag(Auu)^-1 Aup, applied with the fused p-column pass
(apply_p_coupled). The AMG hierarchy of the S sweeps runs on the
explicit SELFP matrix Sp (NodeBSR.sp_vals), built for the AMG family
only.

build_schur_state computes the numeric state once (it can be carried
across time steps, pc_lag_steps); make_schur_precond_from_state only
builds closures, and make_schur_precond does both. Every other
inner_method raises NotImplementedError.

Each operator apply is one K1 launch: cfdtpu's masks and vector updates
around it (la/schur.py:45-87, 287-300, 350-357) are K1's epilogue
options (kernels/sup_spmv.py): the identity Dirichlet rows of Auu and
the zero rows of Aup as its row mask, diag(Auu)^-1 (zero at Dirichlet
rows) and the Dirichlet 0/1 mask of z as its input scale, and
App v - Apu z and r_p - Apu z_u as its residual mode. The vector work
of the inner methods is a kernel too: the node-block Jacobi apply and
the S stage's v / d_p are K10 (d = 2 and d = 1), a Chebyshev step on
Auu is K1's cheby mode (with the Dirichlet rows as its identity rows),
and on S, two launches, the elementwise cheby_update after them.

On CUDA one application is one CUDA graph (CapturedPrecond), cfdtpu's
jitted preconditioner: captured at its first call and replayed for
every later call. On the CPU the same closure runs eagerly. A solver
keeps its applications in a PrecondSlot for its whole life, as cfdtpu
jits the application once and passes each new state in: the closure
reads only the tensors of the state it was made from, the vectors made
from them (_precond_vectors) and the static masks, so every later build
is copied into those tensors in place and the same closure, and the
same graph, applies it.
"""

from __future__ import annotations

import torch

from ..kernels.block_jacobi import block_jacobi
from ..utils.trace import count, span
from .chebyshev import chebyshev_fixed, cheby_scale, estimate_lambda_max
from .gmres import gmres_fixed

_UU_AMG_METHODS = ("amg_up", "amg_sup", "rasamg_up", "rasamg_sup")
_AMG_P_METHODS = ("amg_p", "amg_up", "ras_up", "rasamg_up", "amg_sup",
                  "rasamg_sup")
SUPPORTED_INNER = ("gmres", "chebyshev", "chebyshev_p", *_AMG_P_METHODS)
# the inner methods' Chebyshev interval [CHEB_FRAC, 1] * lambda_max
CHEB_FRAC = 0.06


def _check_method(inner_method: str) -> None:
    if inner_method not in SUPPORTED_INNER:
        raise NotImplementedError(
            f"pc_inner_method={inner_method!r} is not ported; "
            f"supported: {SUPPORTED_INNER}"
        )


def _safe(d):
    scale = torch.max(torch.abs(d))
    floor = 1e-12 * scale
    return torch.where(
        torch.abs(d) < floor, torch.where(d < 0, -floor, floor), d
    )


def _p_rows(bc_mask_p, v_p) -> dict:
    """K1's row mask for the identity pressure-Dirichlet rows of S."""
    return {} if bc_mask_p is None else {"mask": bc_mask_p,
                                         "mask_value": v_p}


def _scale_u(bc_mask_u, inv_d_u):
    """diag(Auu)^-1 with the Dirichlet rows zeroed: cfdtpu's
    inv_d_u * where(bc_mask_u, 0, w) as K1's input scale."""
    return torch.where(bc_mask_u, 0.0, inv_d_u)


def _sub_ops(form, A, bc_mask_u, bc_mask_p, pin_pressure, inv_d_u=None,
             scale_u=None):
    """The four sub-block actions and the SELFP Schur action S; each
    operator apply is one K1 launch (Apu takes K1's epilogue options).
    scale_u (_scale_u) is made from inv_d_u where it is not given."""
    if scale_u is None:
        scale_u = _scale_u(bc_mask_u, inv_d_u)

    def Auu(v, **epi):  # where(bc_mask_u, v, Auu v)
        if epi.get("mode") == "cheby":  # the mask: identity rows
            return form.apply_sub_block(A, (), v, "uu", mask=bc_mask_u,
                                        **epi)
        return form.apply_sub_block(A, (), v, "uu", mask=bc_mask_u,
                                    mask_value=v)

    def Aup(v_p):  # where(bc_mask_u, 0, Aup v)
        return form.apply_sub_block(A, (), v_p, "up", mask=bc_mask_u)

    def Apu(v_u, **epi):
        return form.apply_sub_block(A, (), v_u, "pu", **epi)

    def App(v_p):
        return form.apply_sub_block(A, (), v_p, "pp")

    def S(v_p):
        """SELFP Schur action: (Aup v, App v) in one pass, then
        App v - Apu diag(Auu)^-1 Aup v with the Dirichlet rows of both
        blocks in the second: two launches before the mean removal."""
        w, y_pp = form.apply_p_coupled(A, v_p)
        y = Apu(w, mode="residual", b=y_pp, scale=scale_u,
                **_p_rows(bc_mask_p, v_p))
        if pin_pressure:
            y = y - torch.mean(y)
        return y

    return Auu, Aup, Apu, App, S


def _near_true_schur(uu_amg, uu_built, Aup, Apu, App, bc_mask_u, bc_mask_p,
                     pin_pressure):
    """The *_sup methods' Schur action (cfdtpu/la/schur.py:287-300)."""
    # cfdtpu's where(bc_mask_u, 0, z) as K1's 0/1 input scale
    keep_u = (~bc_mask_u).to(uu_built[1].dtype)

    def S(v_p):
        """Near-true Schur action App v - Apu V(Aup v). The V-cycle is
        plain (kcycle=False): it is part of a LINEAR operator swept by
        fixed GMRES. Three K1 launches beside the V-cycle: Aup, App, and
        Apu in the residual mode with b = App v."""
        w = Aup(v_p)
        z = uu_amg.v_cycle(uu_built, w, kcycle=False)
        y = Apu(z, mode="residual", b=App(v_p), scale=keep_u,
                **_p_rows(bc_mask_p, v_p))
        if pin_pressure:
            y = y - torch.mean(y)
        return y

    return S


def _uu_amg(form, inner_method, ras_opts):
    """The cached block-AMG hierarchy of the velocity block, with the
    RAS fine smoother for the rasamg_* methods."""
    ras = (form.uu_ras(*ras_opts) if inner_method.startswith("rasamg")
           else None)
    return form.uu_amg(fine_smoother=ras)


def build_schur_state(form, A, bc_mask_u, pin_pressure: bool,
                      m_u: int = 8, m_p: int = 10, full: bool = True,
                      bc_mask_p=None, inner_method: str = "gmres",
                      ras_opts: tuple[int, int] = (16, 4)):
    """Numeric preconditioner state: the operator values, the velocity
    and pressure diagonals, the velocity-block AMG / RAS values of the
    *_up / *_sup methods, the SELFP-AMG level values of the AMG family,
    and the Chebyshev bounds lambda_u (chebyshev) and lambda_p
    (chebyshev, chebyshev_p), (1,) tensors on the operator's device."""
    _check_method(inner_method)
    n_u_flat = form.n_u_flat
    d_full = form.jacobian_diagonal(A, ())
    d_u = _safe(torch.where(bc_mask_u, 1.0, d_full[:n_u_flat]))
    d_p = _safe(d_full[n_u_flat:])
    inv_d_u = 1.0 / d_u
    state = {"A": A, "d_u": d_u, "d_p": d_p}
    if inner_method == "chebyshev":
        Auu = _sub_ops(form, A, bc_mask_u, bc_mask_p, pin_pressure,
                       inv_d_u)[0]
        state["lam_u"] = estimate_lambda_max(Auu, inv_d_u)
    if inner_method in _UU_AMG_METHODS:
        state["uu_built"] = _uu_amg(form, inner_method, ras_opts).build(
            form.uu_vals(A, bc_mask_u))
    if inner_method == "ras_up":
        state["ras_inv"] = form.uu_ras(*ras_opts).build(
            form.uu_vals(A, bc_mask_u))
    if inner_method in _AMG_P_METHODS:
        # aggregation-MG cycle on the EXPLICIT SELFP matrix as the inner
        # PC of the S sweeps (AMG on App alone fails: in stabilized P1-P1
        # the pressure Laplacian lives in the product term). It keeps
        # diag(Auu) under *_sup too.
        amg = form.sp_amg()
        sp = form.sp_vals(A, torch.where(bc_mask_u, 0.0, inv_d_u))
        if bc_mask_p is not None:
            # identity rows at pressure-Dirichlet dofs, matching the
            # matrix-free S
            sp = torch.where(bc_mask_p[form._sp_row], 0.0, sp)
            diag = form._sp_diag_pos
            sp[diag] = torch.where(bc_mask_p, 1.0, sp[diag])
        state["sp_built"] = amg.build(sp)
    elif inner_method in ("chebyshev", "chebyshev_p"):
        S = _sub_ops(form, A, bc_mask_u, bc_mask_p, pin_pressure,
                     inv_d_u)[4]
        state["lam_p"] = estimate_lambda_max(S, 1.0 / d_p)
    return state


class CapturedPrecond:
    """One preconditioner application as a CUDA graph (cfdtpu's jitted
    preconditioner). At the first call the eager application `eager`
    runs once on a side stream (the warm-up) and is then captured; every
    call copies v into the graph's static input, replays the graph and
    returns its static output. The side stream is torch.cuda.graph's
    capture stream, one for the process: cuBLAS keeps a workspace for
    each stream it runs on (the coarsest solves), so a new stream for
    every capture would leave one more workspace allocated each time.
    The graph reads the tensors `eager` closes over where they lie, so
    values copied into them in place (PrecondSlot's refit) reach the
    next replay.

    That output is the graph's own memory: it stays valid until the next
    call of this object, which overwrites it. fgmres stores it in Z[j]
    before its next call, so the returned tensor needs no copy there. A
    capture that fails raises; there is no eager path on CUDA."""

    def __init__(self, eager):
        self.eager = eager
        self.graph = None
        self.static_in = None
        self.static_out = None

    def capture(self, v) -> None:
        count("pc_captures")
        with span("pc.capture"):
            dev = v.device
            self.static_in = v.clone()
            graph = torch.cuda.CUDAGraph()
            ctx = torch.cuda.graph(graph)
            side = ctx.capture_stream
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.eager(self.static_in)
            torch.cuda.current_stream(dev).wait_stream(side)
            with ctx:
                self.static_out = self.eager(self.static_in)
            self.graph = graph

    def __call__(self, v):
        if self.graph is None:
            self.capture(v)
        count("pc_replays")
        with span("pc.apply"):
            self.static_in.copy_(v)
            self.graph.replay()
        return self.static_out


def _structure(tree, leaves: list):
    """The structure of a state tree (dicts by sorted key, lists, tuples,
    tensors as (shape, dtype, device), other leaves as they are), its
    tensors appended to `leaves` in the same order."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return tuple(tree.shape), tree.dtype, tree.device
    if isinstance(tree, dict):
        return dict, tuple((k, _structure(tree[k], leaves))
                           for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return type(tree), tuple(_structure(t, leaves) for t in tree)
    return tree


class PrecondSlot:
    """A solver's preconditioner applications, one for each set of
    closure arguments, each made once and refitted in place at every
    later build.

    load(form, state, ...) -> (apply, held), held the state that apply
    reads. The first load under a set of arguments takes the state, and
    the vectors made from it (_precond_vectors), as the slot's own, makes
    the closure and, on CUDA, wraps it in a CapturedPrecond (captured at
    its first call: pc_captures). A later load whose state and vectors
    have the same tree, with every tensor of the same shape, dtype and
    device, copies them into the held tensors (copy_ on the current
    stream, so the next replay reads them: pc_refits, span pc.refit) and
    returns the same application; the new state is then dropped back to
    the caching allocator. No graph is captured, no memory pool made and
    the allocator is not emptied. A load whose tree differs makes and
    captures afresh."""

    def __init__(self):
        self._held = {}  # key -> (structure, leaves, state, apply)

    def load(self, form, state, bc_mask_u, pin_pressure: bool,
             m_u: int = 8, m_p: int = 10, full: bool = True,
             bc_mask_p=None, inner_method: str = "gmres",
             ras_opts: tuple[int, int] = (16, 4)):
        _check_method(inner_method)
        ras_opts = tuple(ras_opts)
        key = (pin_pressure, m_u, m_p, full, inner_method, ras_opts,
               bc_mask_u.data_ptr(),
               None if bc_mask_p is None else bc_mask_p.data_ptr())
        tree = (state, _precond_vectors(form, state, bc_mask_u,
                                        inner_method))
        leaves = []
        structure = _structure(tree, leaves)
        held = self._held.get(key)
        if held is not None and held[0] == structure:
            count("pc_refits")
            with span("pc.refit"):
                for dst, src in zip(held[1], leaves):
                    dst.copy_(src)
            return held[3], held[2]
        apply = _precond_closure(form, *tree, bc_mask_u, pin_pressure, m_u,
                                 m_p, full, bc_mask_p, inner_method,
                                 ras_opts)
        if state["A"]["coo"].device.type == "cuda":
            apply = CapturedPrecond(apply)
        self._held[key] = (structure, leaves, state, apply)
        return apply, state


def make_schur_precond_from_state(form, state, bc_mask_u,
                                  pin_pressure: bool, m_u: int = 8,
                                  m_p: int = 10, full: bool = True,
                                  bc_mask_p=None,
                                  inner_method: str = "gmres",
                                  ras_opts: tuple[int, int] = (16, 4)):
    """v -> M v approximating J^-1 v from a prebuilt numeric state.
    Closure construction only: the state can be reused across steps.

    On CUDA the application is a new CapturedPrecond, captured at its
    first call; a solver keeps its applications in a PrecondSlot."""
    return PrecondSlot().load(form, state, bc_mask_u, pin_pressure,
                              m_u=m_u, m_p=m_p, full=full,
                              bc_mask_p=bc_mask_p,
                              inner_method=inner_method,
                              ras_opts=ras_opts)[0]


def make_schur_precond(form, A, bc_mask_u, pin_pressure: bool,
                       m_u: int = 8, m_p: int = 10, full: bool = True,
                       bc_mask_p=None, inner_method: str = "gmres",
                       ras_opts: tuple[int, int] = (16, 4)):
    """v -> M v approximating J^-1 v: build_schur_state, then
    make_schur_precond_from_state (cfdtpu/la/schur.py:362-395)."""
    kw = dict(m_u=m_u, m_p=m_p, full=full, bc_mask_p=bc_mask_p,
              inner_method=inner_method, ras_opts=ras_opts)
    state = build_schur_state(form, A, bc_mask_u, pin_pressure, **kw)
    return make_schur_precond_from_state(form, state, bc_mask_u,
                                         pin_pressure, **kw)


def _precond_vectors(form, state, bc_mask_u, inner_method):
    """The vectors an application reads beside the state, made from it
    at each build: diag(Auu)^-1 zeroed at the Dirichlet rows (_scale_u),
    the node-block Jacobi inverses (K10) where they are the velocity
    sweeps' preconditioner, and the Chebyshev scales w_u and w_p."""
    inv_d_u = 1.0 / state["d_u"]
    vec = {"scale_u": _scale_u(bc_mask_u, inv_d_u)}
    if ("ras_inv" not in state and "uu_built" not in state
            and inner_method != "chebyshev"):
        # exact (dim x dim) node-block Jacobi: stronger than the scalar
        # diagonal once convection couples the velocity components
        vec["uu_bj_inv"] = form.uu_block_jacobi_inv(state["A"], bc_mask_u)
    if inner_method == "chebyshev":
        vec["w_u"] = cheby_scale(inv_d_u, state["lam_u"], CHEB_FRAC)
    if inner_method in ("chebyshev", "chebyshev_p"):
        vec["w_p"] = cheby_scale(1.0 / state["d_p"], state["lam_p"],
                                 CHEB_FRAC)
    return vec


def _precond_closure(form, state, vec, bc_mask_u, pin_pressure, m_u, m_p,
                     full, bc_mask_p, inner_method, ras_opts):
    """The eager application of a PrecondSlot. It reads the tensors of
    `state` and `vec` (_precond_vectors) and the static masks, and makes
    no vector of its own from them, so values copied into those tensors
    reach its next call (and its graph's next replay)."""
    n_u_flat = form.n_u_flat
    A = state["A"]
    Auu, Aup, Apu, App, S = _sub_ops(form, A, bc_mask_u, bc_mask_p,
                                     pin_pressure, scale_u=vec["scale_u"])

    uu_vcycle = None
    if "uu_built" in state:
        uu_amg = _uu_amg(form, inner_method, ras_opts)
        uu_built = state["uu_built"]

        def uu_vcycle(r):
            return uu_amg.v_cycle(uu_built, r)

    if "ras_inv" in state:
        ras = form.uu_ras(*ras_opts)
        ras_inv = state["ras_inv"]

        def Mu(r):
            return ras.apply(ras_inv, r)
    elif uu_vcycle is not None:
        Mu = uu_vcycle
    elif "uu_bj_inv" in vec:
        uu_bj_inv = vec["uu_bj_inv"]

        def Mu(r):
            return block_jacobi(uu_bj_inv, r)

    if m_u == 0 and uu_vcycle is not None:
        # preonly u-stage (PETSc's fieldsplit_u preonly): one V-cycle,
        # no Krylov wrap; the outer FGMRES corrects the error
        solve_Auu = uu_vcycle
    elif inner_method == "chebyshev":
        w_u = vec["w_u"]

        def step_u(x, b, scale, dprev, a, c, d_out):
            return Auu(x, mode="cheby", b=b, scale=scale,
                       cheb=(w_u, dprev, a, c), d_out=d_out)

        def solve_Auu(r):
            return chebyshev_fixed(Auu, r, w_u, m_u, CHEB_FRAC, step=step_u)
    else:
        def solve_Auu(r):
            # single-orthogonalisation sweeps: the PC only needs an
            # approximate inverse
            return gmres_fixed(Auu, r, precond=Mu, m=m_u, reorth=False)

    if inner_method in ("amg_sup", "rasamg_sup"):
        S = _near_true_schur(uu_amg, uu_built, Aup, Apu, App,  # noqa: F811
                             bc_mask_u, bc_mask_p, pin_pressure)

    if "sp_built" in state:
        amg = form.sp_amg()
        level_vals = state["sp_built"]

        def Mp(v):
            return amg.v_cycle(level_vals, v)
    elif inner_method == "gmres":
        d_p = state["d_p"].reshape(-1, 1, 1)

        def Mp(v):  # v / d_p: K10 at d = 1, dividing
            return block_jacobi(d_p, v, True)

    if inner_method in ("chebyshev", "chebyshev_p"):
        w_p = vec["w_p"]

        def S_solve(r):
            return chebyshev_fixed(S, r, w_p, m_p, CHEB_FRAC)
    else:
        def S_solve(r):
            # m_p == 0 is preonly: one application of Mp
            return gmres_fixed(S, r, precond=Mp, m=m_p, reorth=False)

    def solve_S(r):
        if pin_pressure:
            r = r - torch.mean(r)
        z = S_solve(r)
        if pin_pressure:
            z = z - torch.mean(z)
        return z

    def precond(v):
        r_u, r_p = v[:n_u_flat], v[n_u_flat:]
        z_u = solve_Auu(r_u)
        r_s = Apu(z_u, mode="residual", b=r_p)  # r_p - Apu z_u
        z_p = solve_S(r_s)
        if full:
            # not a product: one elementwise launch after the V-cycle
            z_u = z_u - solve_Auu(Aup(z_p))
        return torch.cat([z_u, z_p])

    return precond
