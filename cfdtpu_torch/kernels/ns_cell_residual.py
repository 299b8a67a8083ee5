"""K3: the stabilized-NS cell kernel (csrc/ns_cell_residual.cu) with
its two entry points, ns_cell_residual_p1 (element residuals) and
ns_cell_jacobian_p1 (exact element Jacobians), and the plain cell
kernel they replace.

`ns_cell_kernel` is the per-cell Crank-Nicolson-midpoint residual of
cfdtpu's StabilizedNSForm (forms/navier_stokes.py _make_cell_kernel),
written for torch.func: no in-place ops and no host reads. Batched with
vmap it is the plain version of the residual; vmap(jacfwd(.)) of its
flat form is the plain version of the Jacobian, as cfdtpu's
element_jacobians takes it. On the card one CUDA cell body serves both:
on plain numbers for the residual, on forward-mode dual numbers for the
Jacobian.

The CUDA kernels cover P1 triangles only (dim 2, degree 1: velocity,
pressure and geometry share one basis, and V and Q share the dofmap).
For any other form a CUDA tensor raises; there is no fallback.

Both entry points take an optional facet block, `facet` = (dofmap_u,
dofmap_p, coords, tabs, mu): the arguments of K7 (kernels/
ns_facet_natural.py) after u, u_prev and p. Its natural-correction term
then comes from the same launch, K7's bodies in a second range of
blocks, as one more output (ru_f (nf, 3, 2), or A_f (nf, 9, 9)); the
plain versions run K3's and K7's plain versions in that order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import COUNTERS
from ._common import (check_float, check_index, check_same_device, is_f64,
                      on_cuda, require, stream_handle)
from .ns_facet_natural import _TABS as FACET_TABS
from .ns_facet_natural import _check_args as _check_facet_args
from .ns_facet_natural import (ns_facet_natural_jac_plain,
                               ns_facet_natural_plain)
from ..utils.geometry import det_and_inv

_COUNT = COUNTERS["ns_cell_residual_p1"]
_COUNT_JAC = COUNTERS["ns_cell_jacobian_p1"]
_COUNT_FACET = COUNTERS["ns_cell_residual_p1_facet"]
_COUNT_JAC_FACET = COUNTERS["ns_cell_jacobian_p1_facet"]
MAX_POINTS = 16  # quadrature points the CUDA kernels hold (MAXQ)


@dataclass
class CellTabs:
    """Reference-cell tabulations at the quadrature points (tensors on
    the form's device) plus `affine`: True when the basis gradients are
    the same at every point (a simplex with a P1 geometry), and `p1`:
    True when the CUDA kernels apply, which take the cell's geometry
    once, not once per point, and so need `affine` too."""

    qw: torch.Tensor        # (nq,)
    phi_u: torch.Tensor     # (nq, nbu)
    dphi_u: torch.Tensor    # (nq, nbu, d)
    d2phi_u: torch.Tensor | None  # (nq, nbu, d, d) for degree > 1
    phi_p: torch.Tensor     # (nq, nbp)
    dphi_p: torch.Tensor    # (nq, nbp, d)
    gdphi: torch.Tensor     # (nq, nvg, d)
    p1: bool
    affine: bool = False

    @staticmethod
    def create(qw, phi_u, dphi_u, d2phi_u, phi_p, dphi_p, gdphi,
               same_dofmap: bool, device, dtype) -> "CellTabs":
        """From numpy tabulations; decides `p1` and `affine` on the
        host, once."""
        affine = all(bool(np.all(np.asarray(a) == np.asarray(a)[:1]))
                     for a in (dphi_u, dphi_p, gdphi))
        p1 = bool(
            affine and same_dofmap and d2phi_u is None
            and np.shape(dphi_u)[1:] == (3, 2)
            and np.array_equal(phi_u, phi_p)
            and np.array_equal(dphi_u, dphi_p)
            and np.array_equal(dphi_u, gdphi)
        )

        def t(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a), dtype=dtype, device=device)

        return CellTabs(t(qw), t(phi_u), t(dphi_u), t(d2phi_u), t(phi_p),
                        t(dphi_p), t(gdphi), p1, affine)


def ns_cell_kernel(u_e, p_e, uprev_e, coords_e, h_e, tabs: CellTabs, rho,
                   mu, dt, f, eps: float):
    """Residual of one cell: (ru (nbu, d), rp (nbp,)).

    rho, mu, dt: Python floats; f: (d,) tensor. Same algebra as the jnp
    kernel, term by term."""
    dim = coords_e.shape[-1]
    nu = mu / rho
    phi_u, dphi_u, d2phi_u = tabs.phi_u, tabs.dphi_u, tabs.d2phi_u
    phi_p, dphi_p = tabs.phi_p, tabs.dphi_p
    eye = torch.eye(dim, dtype=coords_e.dtype, device=coords_e.device)

    J = torch.einsum("vg,qvd->qgd", coords_e, tabs.gdphi)
    detJ, invJ = det_and_inv(J)  # invJ (q, d, g): dxi_d/dx_g
    wdet = tabs.qw * detJ.abs()

    gu = torch.einsum("qbd,qdg->qbg", dphi_u, invJ)
    gp = torch.einsum("qbd,qdg->qbg", dphi_p, invJ)

    u_q = phi_u @ u_e  # (q, i)
    up_q = phi_u @ uprev_e
    um_q = 0.5 * (u_q + up_q)
    grad_u = torch.einsum("bi,qbg->qig", u_e, gu)
    grad_up = torch.einsum("bi,qbg->qig", uprev_e, gu)
    grad_um = 0.5 * (grad_u + grad_up)
    p_q = phi_p @ p_e
    grad_p = torch.einsum("b,qbg->qg", p_e, gp)

    div_um = torch.diagonal(grad_um, dim1=1, dim2=2).sum(-1)
    conv = torch.einsum("qig,qg->qi", grad_um, um_q)
    sig = (mu * (grad_um + grad_um.transpose(1, 2))
           - p_q[:, None, None] * eye)

    R = rho * ((u_q - up_q) / dt + conv) + grad_p - rho * f
    if d2phi_u is not None:
        Hb = torch.einsum("qbde,qdg,qeh->qbgh", d2phi_u, invJ, invJ)
        hess = torch.einsum("bi,qbgh->qigh", 0.5 * (u_e + uprev_e), Hb)
        lap = torch.einsum("qigg->qi", hess)
        graddiv = torch.einsum("qjij->qi", hess)
        R = R - mu * (lap + graddiv)

    # tau_SUPG from u_prev, so it stays constant through the Newton
    # linearisation; eps guards t1 at rest (vn = 0)
    vn = torch.sqrt(torch.sum(up_q * up_q, dim=-1))
    t1 = h_e / torch.clamp(2.0 * vn, min=eps)
    t2 = dt / 2.0
    t3 = (h_e * h_e) / (4.0 * nu)
    tau = (t1 ** -2.0 + t2 ** -2.0 + t3 ** -2.0) ** -0.5
    Re_h = vn * h_e / (2.0 * nu)
    z = torch.clamp(Re_h / 3.0, max=1.0)
    tau_lsic = vn * h_e * z / 2.0

    mass = rho * ((u_q - up_q) / dt + conv - f)
    ru = torch.einsum("q,qb,qi->bi", wdet, phi_u, mass)
    ru = ru + torch.einsum("q,qij,qbj->bi", wdet, sig, gu)
    rp = torch.einsum("q,qb->b", wdet * div_um, phi_p)
    # SUPG, LSIC, PSPG
    adv_v = torch.einsum("qbg,qg->qb", gu, um_q)
    ru = ru + torch.einsum("q,qi,qb->bi", wdet * tau, R, adv_v)
    ru = ru + torch.einsum("q,qbi->bi", wdet * tau_lsic * rho * div_um, gu)
    rp = rp + torch.einsum("q,qi,qbi->b", wdet * tau / rho, R, gp)
    return ru, rp


def ns_cell_residual_plain(u, uprev, p, dofmap_u, dofmap_p, coords, h,
                           tabs: CellTabs, rho, mu, dt, f, eps):
    """The plain version: dofmap gather + vmap of ns_cell_kernel."""
    dmu, dmp = dofmap_u.long(), dofmap_p.long()
    f_t = torch.as_tensor(f, dtype=u.dtype, device=u.device)

    def one(ue, pe, upe, ce, he):
        return ns_cell_kernel(ue, pe, upe, ce, he, tabs, rho, mu, dt, f_t,
                              eps)

    return torch.func.vmap(one)(u[dmu], p[dmp], uprev[dmu], coords, h)


def ns_cell_jacobian_plain(u, uprev, p, dofmap_u, dofmap_p, coords, h,
                           tabs: CellTabs, rho, mu, dt, f, eps):
    """The plain version of the Jacobian: vmap(jacfwd(.)) of the cell
    kernel in the flat element layout [u(b, i) row-major, then p(b)]."""
    dmu, dmp = dofmap_u.long(), dofmap_p.long()
    f_t = torch.as_tensor(f, dtype=u.dtype, device=u.device)
    nc, nbu = dmu.shape
    nud = nbu * u.shape[1]

    def fk(x, upe, ce, he):
        ru, rp = ns_cell_kernel(x[:nud].reshape(nbu, -1), x[nud:], upe, ce,
                                he, tabs, rho, mu, dt, f_t, eps)
        return torch.cat([ru.reshape(-1), rp])

    xe = torch.cat([u[dmu].reshape(nc, -1), p[dmp]], dim=1)
    return torch.func.vmap(torch.func.jacfwd(fk))(xe, uprev[dmu], coords, h)


def _check_args(name, u, uprev, p, dofmap_u, dofmap_p, coords, h, tabs):
    check_float("u", u)
    for key, t in (("uprev", uprev), ("p", p), ("coords", coords),
                   ("h", h)):
        check_float(key, t, u.dtype)
    check_index("dofmap_u", dofmap_u)
    check_index("dofmap_p", dofmap_p)
    check_same_device(("u", u), ("uprev", uprev), ("p", p),
                      ("dofmap_u", dofmap_u), ("coords", coords), ("h", h),
                      ("tabs.qw", tabs.qw))
    if not on_cuda(u):
        return False
    if not tabs.p1:
        raise NotImplementedError(
            f"{name} covers affine P1 triangles with a shared "
            "velocity/pressure basis and dofmap only"
        )
    nc = dofmap_u.shape[0]
    require(tuple(u.shape[1:]) == (2,) and tuple(uprev.shape) == u.shape,
            f"{name}: u, uprev must be (n, 2)")
    require(tuple(dofmap_u.shape) == (nc, 3), "dofmap must be (nc, 3)")
    require(tuple(coords.shape) == (nc, 3, 2) and tuple(h.shape) == (nc,),
            f"{name}: coords (nc, 3, 2), h (nc,)")
    require(tabs.qw.shape[0] <= MAX_POINTS,
            f"{name}: at most {MAX_POINTS} quadrature points")
    for key, t in (("u", u), ("uprev", uprev), ("p", p),
                   ("coords", coords), ("h", h), ("phi", tabs.phi_u),
                   ("dphi", tabs.dphi_u), ("qw", tabs.qw)):
        require(t.is_contiguous(), f"{name}: {key} must be contiguous")
        check_float(key, t, u.dtype)
    for key, t in (("u", u), ("uprev", uprev), ("coords", coords)):
        # read as 2-vectors (8 or 16 bytes)
        require(t.data_ptr() % (2 * t.element_size()) == 0,
                f"{name}: {key} must be aligned to a pair of values")
    return True


def _launch(fn_name, counters, outs, u, uprev, p, dofmap_u, coords, h,
            tabs, rho, mu, dt, f, eps, facet=None, out_f=None):
    """One launch: K3 alone, or with a facet block (its output out_f)."""
    from ._build import check, library

    f0, f1 = (float(v) for v in f)
    cell = (u.data_ptr(), uprev.data_ptr(), p.data_ptr(),
            dofmap_u.data_ptr(), coords.data_ptr(), h.data_ptr(),
            tabs.phi_u.data_ptr(), tabs.dphi_u.data_ptr(),
            tabs.qw.data_ptr(), dofmap_u.shape[0], tabs.qw.shape[0],
            float(rho), float(mu), float(dt), f0, f1, float(eps))
    with torch.cuda.device(u.device):
        if facet is None:
            rc = getattr(library(), "cfd_" + fn_name)(
                *cell, *(o.data_ptr() for o in outs), is_f64(u),
                stream_handle(u))
        else:
            fdmu, fdmp, fcoords, ftabs, fmu = facet
            nf, nqf = ftabs["dS"].shape
            rc = library().cfd_ns_cell_facet_p1(
                *cell, *(o.data_ptr() for o in outs),
                *([None] * (2 - len(outs))), fdmu.data_ptr(),
                fdmp.data_ptr(), fcoords.data_ptr(),
                *(ftabs[k].data_ptr() for k in FACET_TABS), nf, nqf,
                float(fmu), out_f.data_ptr(),
                1 if fn_name == "ns_cell_jacobian_p1" else 0, is_f64(u),
                stream_handle(u))
    for c in counters:
        c.n += 1
    check(rc, fn_name)


def _facet_on_cuda(name, u, uprev, p, facet):
    """K7's argument checks for a facet block (raises on CUDA for a block
    the kernel does not cover); True where it is on the card."""
    if len(facet) != 5:
        raise ValueError(f"{name}: facet is (dofmap_u, dofmap_p, coords, "
                         "tabs, mu)")
    return _check_facet_args(name, u, uprev, p, *facet[:4])


def ns_cell_residual_p1(u, uprev, p, dofmap_u, dofmap_p, coords, h,
                        tabs: CellTabs, rho, mu, dt, f, eps, facet=None):
    """Element residuals (ru_e (nc, nbu, d), rp_e (nc, nbp)), and with a
    facet block (module docstring) its ru_f (nf, 3, 2) too, from the
    same launch."""
    args = (u, uprev, p, dofmap_u, dofmap_p, coords, h, tabs, rho, mu, dt,
            f, eps)
    cuda = _check_args("ns_cell_residual_p1", *args[:8])
    if facet is not None:
        cuda = _facet_on_cuda("ns_cell_residual_p1", u, uprev, p,
                              facet) and cuda
    if not cuda:
        out = ns_cell_residual_plain(*args)
        if facet is None:
            return out
        return (*out, ns_facet_natural_plain(u, uprev, p, *facet))
    nc = dofmap_u.shape[0]
    ru_e = torch.empty((nc, 3, 2), dtype=u.dtype, device=u.device)
    rp_e = torch.empty((nc, 3), dtype=u.dtype, device=u.device)
    launch = (u, uprev, p, dofmap_u, coords, h, tabs, rho, mu, dt, f, eps)
    if facet is None:
        _launch("ns_cell_residual_p1", (_COUNT,), (ru_e, rp_e), *launch)
        return ru_e, rp_e
    ru_f = torch.empty((facet[0].shape[0], 3, 2), dtype=u.dtype,
                       device=u.device)
    _launch("ns_cell_residual_p1", (_COUNT, _COUNT_FACET), (ru_e, rp_e),
            *launch, facet=facet, out_f=ru_f)
    return ru_e, rp_e, ru_f


def ns_cell_jacobian_p1(u, uprev, p, dofmap_u, dofmap_p, coords, h,
                        tabs: CellTabs, rho, mu, dt, f, eps, facet=None):
    """Exact element Jacobians A_cells (nc, nloc, nloc) of the cell
    residual with respect to the cell's (u, p), in the flat element
    layout [u(b, i) row-major, then p(b)]. With a facet block (module
    docstring), (A_cells, A_f (nf, 9, 9)) from the same launch."""
    args = (u, uprev, p, dofmap_u, dofmap_p, coords, h, tabs, rho, mu, dt,
            f, eps)
    cuda = _check_args("ns_cell_jacobian_p1", *args[:8])
    if facet is not None:
        cuda = _facet_on_cuda("ns_cell_jacobian_p1", u, uprev, p,
                              facet) and cuda
    if not cuda:
        A = ns_cell_jacobian_plain(*args)
        if facet is None:
            return A
        return A, ns_facet_natural_jac_plain(u, uprev, p, *facet)
    A = torch.empty((dofmap_u.shape[0], 9, 9), dtype=u.dtype,
                    device=u.device)
    launch = (u, uprev, p, dofmap_u, coords, h, tabs, rho, mu, dt, f, eps)
    if facet is None:
        _launch("ns_cell_jacobian_p1", (_COUNT_JAC,), (A,), *launch)
        return A
    A_f = torch.empty((facet[0].shape[0], 9, 9), dtype=u.dtype,
                      device=u.device)
    _launch("ns_cell_jacobian_p1", (_COUNT_JAC, _COUNT_JAC_FACET), (A,),
            *launch, facet=facet, out_f=A_f)
    return A, A_f
