"""K3, K14 and K15: the stabilized-NS cell kernels
(csrc/ns_cell_residual.cu) with their entry points, ns_cell_residual_p1
and ns_cell_jacobian_p1 (Crank-Nicolson midpoint, K3),
ns_cell_residual_bdf2_p1 and ns_cell_jacobian_bdf2_p1 (BDF2, K14),
ns_cell_residual_curl_p1 and ns_cell_jacobian_curl_p1 (the curl-curl
form at the midpoint, K15): element residuals and exact element
Jacobians, and the plain cell kernels they replace.

`ns_cell_kernel` is the per-cell Crank-Nicolson-midpoint residual of
cfdtpu's StabilizedNSForm (forms/navier_stokes.py _make_cell_kernel),
`ns_cell_kernel_bdf2` that of StabilizedNSFormBDF2 (time term (a0 u +
a1 u_prev + a2 u_prev2) / dt, everything else at u, tau from |u_prev|),
`ns_cell_kernel_curl` that of StabilizedNSFormCurlCurl (viscous term mu
curl u . curl v, Lamb-form convection, -(p + rho/2 |u|^2) div v),
written for torch.func: no in-place ops and no host reads. Batched with
vmap each is the plain version of its residual; vmap(jacfwd(.)) of its
flat form is the plain version of its Jacobian, as cfdtpu's
element_jacobians takes it. On the card one CUDA cell body serves all
six: on plain numbers for the residuals, on forward-mode dual numbers
for the Jacobians, instantiated for each form.

The CUDA kernels cover P1 triangles (dim 2, degree 1: velocity,
pressure and geometry share one basis, and V and Q share the dofmap)
and, for K3 alone, P1 tetrahedra (csrc/ns_cell_tet.cu: the same
Crank-Nicolson-midpoint body in 3D, with K7 on triangular facets in its
launch; its launches also count as `ns_cell_residual_p1_tet` and
`ns_cell_jacobian_p1_tet`). For any other form a CUDA tensor raises;
there is no fallback.

Every entry point takes the form's facet blocks, `facets`, a sequence
of kernels/ns_facet.FacetBlock (at most MAX_FACET_BLOCKS): their
bodies (K7, K12, K13, K16-K18) then run in the same launch, each block
a range of blocks after the cells', and each adds one output (ru_f (nf,
3, 2), or A_f (nf, 9, 9)) in its order. The plain versions run the cell
kernel's and then each block's plain version, in that order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import COUNTERS
from ._common import (check_float, check_index, check_same_device, is_f64,
                      on_cuda, require, stream_handle)
from .ns_facet import (TABS as FACET_TABS, TERM_CODE,
                       check_args as check_facet_args, facet_jac_plain,
                       facet_plain)
from ..utils.geometry import det_and_inv

MAX_POINTS = 16  # quadrature points the CUDA kernels hold (MAXQ)
MAX_FACET_BLOCKS = 8  # facet blocks a launch carries (MAXF)
# the cell bodies as csrc/ns_cell_residual.cu numbers them
FORM_MID, FORM_BDF2, FORM_CURL = 0, 1, 2


@dataclass
class CellTabs:
    """Reference-cell tabulations at the quadrature points (tensors on
    the form's device) plus `affine`: True when the basis gradients are
    the same at every point (a simplex with a P1 geometry), and `p1`:
    True when the CUDA kernels apply (P1 triangles or tetrahedra), which
    take the cell's geometry once, not once per point, and so need
    `affine` too."""

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
            and np.shape(dphi_u)[1:] in ((3, 2), (4, 3))
            and np.array_equal(phi_u, phi_p)
            and np.array_equal(dphi_u, dphi_p)
            and np.array_equal(dphi_u, gdphi)
        )

        def t(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a), dtype=dtype, device=device)

        return CellTabs(t(qw), t(phi_u), t(dphi_u), t(d2phi_u), t(phi_p),
                        t(dphi_p), t(gdphi), p1, affine)

    @property
    def tet(self) -> bool:
        """P1 tetrahedra: the kernels of csrc/ns_cell_tet.cu."""
        return self.p1 and tuple(self.dphi_u.shape[1:]) == (4, 3)


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


def ns_cell_kernel_bdf2(u_e, p_e, uprev_e, uprev2_e, coords_e, h_e,
                        tabs: CellTabs, rho, mu, dt, f, eps: float, a):
    """Residual of one cell under BDF2 (cfdtpu's StabilizedNSFormBDF2):
    (ru (nbu, d), rp (nbp,)); a = (a0, a1, a2), Python floats."""
    a0, a1, a2 = a
    dim = coords_e.shape[-1]
    nu = mu / rho
    phi_u, dphi_u, d2phi_u = tabs.phi_u, tabs.dphi_u, tabs.d2phi_u
    phi_p, dphi_p = tabs.phi_p, tabs.dphi_p
    eye = torch.eye(dim, dtype=coords_e.dtype, device=coords_e.device)

    J = torch.einsum("vg,qvd->qgd", coords_e, tabs.gdphi)
    detJ, invJ = det_and_inv(J)
    wdet = tabs.qw * detJ.abs()

    gu = torch.einsum("qbd,qdg->qbg", dphi_u, invJ)
    gp = torch.einsum("qbd,qdg->qbg", dphi_p, invJ)

    u_q = phi_u @ u_e
    up_q = phi_u @ uprev_e
    up2_q = phi_u @ uprev2_e
    dudt = (a0 * u_q + a1 * up_q + a2 * up2_q) / dt
    grad_u = torch.einsum("bi,qbg->qig", u_e, gu)
    p_q = phi_p @ p_e
    grad_p = torch.einsum("b,qbg->qg", p_e, gp)

    div_u = torch.diagonal(grad_u, dim1=1, dim2=2).sum(-1)
    conv = torch.einsum("qig,qg->qi", grad_u, u_q)
    sig = (mu * (grad_u + grad_u.transpose(1, 2))
           - p_q[:, None, None] * eye)

    R = rho * (dudt + conv) + grad_p - rho * f
    if d2phi_u is not None:
        Hb = torch.einsum("qbde,qdg,qeh->qbgh", d2phi_u, invJ, invJ)
        hess = torch.einsum("bi,qbgh->qigh", u_e, Hb)
        lap = torch.einsum("qigg->qi", hess)
        graddiv = torch.einsum("qjij->qi", hess)
        R = R - mu * (lap + graddiv)

    vn = torch.sqrt(torch.sum(up_q * up_q, dim=-1))
    t1 = h_e / torch.clamp(2.0 * vn, min=eps)
    t2 = dt / 2.0
    t3 = (h_e * h_e) / (4.0 * nu)
    tau = (t1 ** -2.0 + t2 ** -2.0 + t3 ** -2.0) ** -0.5
    Re_h = vn * h_e / (2.0 * nu)
    z = torch.clamp(Re_h / 3.0, max=1.0)
    tau_lsic = vn * h_e * z / 2.0

    mass = rho * (dudt + conv - f)
    ru = torch.einsum("q,qb,qi->bi", wdet, phi_u, mass)
    ru = ru + torch.einsum("q,qij,qbj->bi", wdet, sig, gu)
    adv_v = torch.einsum("qbg,qg->qb", gu, u_q)
    ru = ru + torch.einsum("q,qi,qb->bi", wdet * tau, R, adv_v)
    ru = ru + torch.einsum("q,qbi->bi", wdet * tau_lsic * rho * div_u, gu)

    rp = torch.einsum("q,qb->b", wdet * div_u, phi_p)
    rp = rp + torch.einsum("q,qi,qbi->b", wdet * tau / rho, R, gp)
    return ru, rp


def ns_cell_kernel_curl(u_e, p_e, uprev_e, coords_e, h_e, tabs: CellTabs,
                        rho, mu, dt, f, eps: float):
    """Residual of one cell in the curl-curl (rotational) form (cfdtpu's
    StabilizedNSFormCurlCurl): (ru (nbu, d), rp (nbp,)) at the
    Crank-Nicolson midpoint, 2D (the scalar rotation omega = du_y/dx -
    du_x/dy, curl x w = (-omega w_y, omega w_x))."""
    nu = mu / rho
    phi_u, dphi_u = tabs.phi_u, tabs.dphi_u
    phi_p, dphi_p = tabs.phi_p, tabs.dphi_p
    if coords_e.shape[-1] != 2:
        raise NotImplementedError("the curl-curl cell kernel is 2D")

    J = torch.einsum("vg,qvd->qgd", coords_e, tabs.gdphi)
    detJ, invJ = det_and_inv(J)
    wdet = tabs.qw * detJ.abs()

    gu = torch.einsum("qbd,qdg->qbg", dphi_u, invJ)
    gp = torch.einsum("qbd,qdg->qbg", dphi_p, invJ)

    u_q = phi_u @ u_e
    up_q = phi_u @ uprev_e
    um_q = 0.5 * (u_q + up_q)
    grad_um = 0.5 * torch.einsum("bi,qbg->qig", u_e + uprev_e, gu)
    p_q = phi_p @ p_e
    grad_p = torch.einsum("b,qbg->qg", p_e, gp)
    div_um = torch.diagonal(grad_um, dim1=1, dim2=2).sum(-1)

    omega = grad_um[:, 1, 0] - grad_um[:, 0, 1]
    cross = torch.stack([-omega * um_q[:, 1], omega * um_q[:, 0]], dim=-1)
    # rot of the test function phi_b e_i: i = 0 -dphi_b/dy, i = 1 dphi_b/dx
    rot_v = torch.stack([-gu[:, :, 1], gu[:, :, 0]], dim=-1)
    visc = torch.einsum("q,qbi->bi", wdet * mu * omega, rot_v)
    umag2 = torch.sum(um_q * um_q, dim=-1)

    R = rho * ((u_q - up_q) / dt + cross) + grad_p - rho * f

    vn = torch.sqrt(torch.sum(up_q * up_q, dim=-1))
    t1 = h_e / torch.clamp(2.0 * vn, min=eps)
    t2 = dt / 2.0
    t3 = (h_e * h_e) / (4.0 * nu)
    tau = (t1 ** -2.0 + t2 ** -2.0 + t3 ** -2.0) ** -0.5
    Re_h = vn * h_e / (2.0 * nu)
    z = torch.clamp(Re_h / 3.0, max=1.0)
    tau_lsic = vn * h_e * z / 2.0

    mass = rho * ((u_q - up_q) / dt + cross - f)
    ru = torch.einsum("q,qb,qi->bi", wdet, phi_u, mass)
    ru = ru + visc
    # -(p + rho/2 |u_mid|^2) div(v)
    ru = ru + torch.einsum("q,qbi->bi", -wdet * (p_q + 0.5 * rho * umag2),
                           gu)
    adv_v = torch.einsum("qbg,qg->qb", gu, um_q)
    ru = ru + torch.einsum("q,qi,qb->bi", wdet * tau, R, adv_v)
    ru = ru + torch.einsum("q,qbi->bi", wdet * tau_lsic * rho * div_um, gu)

    rp = torch.einsum("q,qb->b", wdet * div_um, phi_p)
    rp = rp + torch.einsum("q,qi,qbi->b", wdet * tau / rho, R, gp)
    return ru, rp


def _plain_kernel(tabs, rho, mu, dt, f, eps, a, like, form=FORM_MID):
    """The plain cell kernel as fn(u_e, p_e, hist_e, coords_e, h_e),
    hist_e = (u_prev_e,) or (u_prev_e, u_prev2_e) (a given: BDF2)."""
    f_t = torch.as_tensor(f, dtype=like.dtype, device=like.device)
    if form == FORM_CURL:
        return lambda ue, pe, he, ce, hh: ns_cell_kernel_curl(
            ue, pe, he[0], ce, hh, tabs, rho, mu, dt, f_t, eps)
    if a is None:
        return lambda ue, pe, he, ce, hh: ns_cell_kernel(
            ue, pe, he[0], ce, hh, tabs, rho, mu, dt, f_t, eps)
    return lambda ue, pe, he, ce, hh: ns_cell_kernel_bdf2(
        ue, pe, he[0], he[1], ce, hh, tabs, rho, mu, dt, f_t, eps, a)


def _residual_plain(u, hist, p, dofmap_u, dofmap_p, coords, h, tabs, rho,
                    mu, dt, f, eps, a=None, form=FORM_MID):
    dmu, dmp = dofmap_u.long(), dofmap_p.long()
    kernel = _plain_kernel(tabs, rho, mu, dt, f, eps, a, u, form)
    return torch.func.vmap(kernel)(u[dmu], p[dmp],
                                   tuple(x[dmu] for x in hist), coords, h)


def _jacobian_plain(u, hist, p, dofmap_u, dofmap_p, coords, h, tabs, rho,
                    mu, dt, f, eps, a=None, form=FORM_MID):
    dmu, dmp = dofmap_u.long(), dofmap_p.long()
    kernel = _plain_kernel(tabs, rho, mu, dt, f, eps, a, u, form)
    nc, nbu = dmu.shape
    nud = nbu * u.shape[1]

    def fk(x, he, ce, hh):
        ru, rp = kernel(x[:nud].reshape(nbu, -1), x[nud:], he, ce, hh)
        return torch.cat([ru.reshape(-1), rp])

    xe = torch.cat([u[dmu].reshape(nc, -1), p[dmp]], dim=1)
    return torch.func.vmap(torch.func.jacfwd(fk))(
        xe, tuple(x[dmu] for x in hist), coords, h)


def ns_cell_residual_plain(u, uprev, p, dofmap_u, dofmap_p, coords, h,
                           tabs: CellTabs, rho, mu, dt, f, eps):
    """The plain version: dofmap gather + vmap of ns_cell_kernel."""
    return _residual_plain(u, (uprev,), p, dofmap_u, dofmap_p, coords, h,
                           tabs, rho, mu, dt, f, eps)


def ns_cell_jacobian_plain(u, uprev, p, dofmap_u, dofmap_p, coords, h,
                           tabs: CellTabs, rho, mu, dt, f, eps):
    """The plain version of the Jacobian: vmap(jacfwd(.)) of the cell
    kernel in the flat element layout [u(b, i) row-major, then p(b)]."""
    return _jacobian_plain(u, (uprev,), p, dofmap_u, dofmap_p, coords, h,
                           tabs, rho, mu, dt, f, eps)


def ns_cell_residual_bdf2_plain(u, uprev, uprev2, p, dofmap_u, dofmap_p,
                                coords, h, tabs: CellTabs, rho, mu, dt, f,
                                eps, a):
    """K14's plain residual: dofmap gather + vmap of ns_cell_kernel_bdf2."""
    return _residual_plain(u, (uprev, uprev2), p, dofmap_u, dofmap_p,
                           coords, h, tabs, rho, mu, dt, f, eps, a)


def ns_cell_jacobian_bdf2_plain(u, uprev, uprev2, p, dofmap_u, dofmap_p,
                                coords, h, tabs: CellTabs, rho, mu, dt, f,
                                eps, a):
    """K14's plain Jacobian: vmap(jacfwd(.)) of ns_cell_kernel_bdf2."""
    return _jacobian_plain(u, (uprev, uprev2), p, dofmap_u, dofmap_p,
                           coords, h, tabs, rho, mu, dt, f, eps, a)


def ns_cell_residual_curl_plain(u, uprev, p, dofmap_u, dofmap_p, coords, h,
                                tabs: CellTabs, rho, mu, dt, f, eps):
    """K15's plain residual: dofmap gather + vmap of ns_cell_kernel_curl."""
    return _residual_plain(u, (uprev,), p, dofmap_u, dofmap_p, coords, h,
                           tabs, rho, mu, dt, f, eps, form=FORM_CURL)


def ns_cell_jacobian_curl_plain(u, uprev, p, dofmap_u, dofmap_p, coords, h,
                                tabs: CellTabs, rho, mu, dt, f, eps):
    """K15's plain Jacobian: vmap(jacfwd(.)) of ns_cell_kernel_curl."""
    return _jacobian_plain(u, (uprev,), p, dofmap_u, dofmap_p, coords, h,
                           tabs, rho, mu, dt, f, eps, form=FORM_CURL)


def _check_args(name, u, hist, p, dofmap_u, dofmap_p, coords, h, tabs):
    check_float("u", u)
    named_hist = [(f"u_prev{k + 1 if k else ''}", t)
                  for k, t in enumerate(hist)]
    for key, t in named_hist + [("p", p), ("coords", coords), ("h", h)]:
        check_float(key, t, u.dtype)
    check_index("dofmap_u", dofmap_u)
    check_index("dofmap_p", dofmap_p)
    check_same_device(("u", u), *named_hist, ("p", p),
                      ("dofmap_u", dofmap_u), ("coords", coords), ("h", h),
                      ("tabs.qw", tabs.qw))
    if not on_cuda(u):
        return False
    if not tabs.p1:
        raise NotImplementedError(
            f"{name} covers affine P1 triangles and tetrahedra with a "
            "shared velocity/pressure basis and dofmap only"
        )
    nc = dofmap_u.shape[0]
    if tabs.tet:
        return _check_tet(name, u, hist, p, dofmap_u, coords, h, tabs,
                          named_hist)
    require(tuple(u.shape[1:]) == (2,)
            and all(tuple(t.shape) == u.shape for t in hist),
            f"{name}: u and its history must be (n, 2)")
    require(tuple(dofmap_u.shape) == (nc, 3), "dofmap must be (nc, 3)")
    require(tuple(coords.shape) == (nc, 3, 2) and tuple(h.shape) == (nc,),
            f"{name}: coords (nc, 3, 2), h (nc,)")
    require(tabs.qw.shape[0] <= MAX_POINTS,
            f"{name}: at most {MAX_POINTS} quadrature points")
    for key, t in [("u", u)] + named_hist + [
            ("p", p), ("coords", coords), ("h", h), ("phi", tabs.phi_u),
            ("dphi", tabs.dphi_u), ("qw", tabs.qw)]:
        require(t.is_contiguous(), f"{name}: {key} must be contiguous")
        check_float(key, t, u.dtype)
    for key, t in [("u", u)] + named_hist + [("coords", coords)]:
        # read as 2-vectors (8 or 16 bytes)
        require(t.data_ptr() % (2 * t.element_size()) == 0,
                f"{name}: {key} must be aligned to a pair of values")
    return True


def _check_tet(name, u, hist, p, dofmap_u, coords, h, tabs, named_hist):
    """The tetrahedral kernel's shapes: Crank-Nicolson only (K3), read
    by scalar loads (no alignment asked)."""
    nc = dofmap_u.shape[0]
    require(len(hist) == 1, f"{name}: the tetrahedral kernel is K3's "
            "Crank-Nicolson midpoint body")
    require(tuple(u.shape[1:]) == (3,) and tuple(hist[0].shape) == u.shape,
            f"{name}: u and u_prev must be (n, 3)")
    require(tuple(dofmap_u.shape) == (nc, 4), "dofmap must be (nc, 4)")
    require(tuple(coords.shape) == (nc, 4, 3) and tuple(h.shape) == (nc,),
            f"{name}: coords (nc, 4, 3), h (nc,)")
    require(tabs.qw.shape[0] <= MAX_POINTS,
            f"{name}: at most {MAX_POINTS} quadrature points")
    for key, t in [("u", u)] + named_hist + [
            ("p", p), ("coords", coords), ("h", h), ("phi", tabs.phi_u),
            ("dphi", tabs.dphi_u), ("qw", tabs.qw)]:
        require(t.is_contiguous(), f"{name}: {key} must be contiguous")
        check_float(key, t, u.dtype)
    return True


def _blocks(facets):
    """The facet blocks of a call, at most MAX_FACET_BLOCKS."""
    blocks = list(facets or ())
    if len(blocks) > MAX_FACET_BLOCKS:
        raise NotImplementedError(
            f"{len(blocks)} facet blocks: the element kernel's launch "
            f"carries at most {MAX_FACET_BLOCKS}")
    return blocks


def _ptrs(ctype, values):
    import ctypes

    return (ctype * max(len(values), 1))(*values)


def _facet_args(blocks, fouts):
    """The facet blocks as the C entry points take them: their pointers
    (10 a block), sizes (nf, nq), options (term, implicit), scalars (c,
    c2) and outputs."""
    import ctypes

    return (
        _ptrs(ctypes.c_void_p, [
            t.data_ptr() for b in blocks
            for t in (b.dofmap_u, b.dofmap_p, b.coords,
                      *(b.tabs[k] for k in FACET_TABS))]),
        _ptrs(ctypes.c_int64, [n for b in blocks
                               for n in b.tabs["dS"].shape]),
        _ptrs(ctypes.c_int, [v for b in blocks
                             for v in (TERM_CODE[b.term.term],
                                       int(b.term.implicit))]),
        _ptrs(ctypes.c_double, [c for b in blocks
                                for c in b.term.coefs(b.scalars)]),
        _ptrs(ctypes.c_void_p, [t.data_ptr() for t in fouts]))


def _element(name, form, jacobian, u, hist, p, dofmap_u, dofmap_p, coords,
             h, tabs, rho, mu, dt, f, eps, a, blocks):
    """One element-kernel call of cell body `form` (FORM_*): the cells and
    every facet block, in one launch on the card, as the plain versions
    in order on the CPU."""
    args = (u, hist, p, dofmap_u, dofmap_p, coords, h, tabs, rho, mu, dt,
            f, eps, a)
    cuda = _check_args(name, *args[:8])
    for b in blocks:
        cuda = check_facet_args(name, u, hist[0], p, *b.args()) and cuda
    if cuda and tabs.tet:
        if form != FORM_MID:
            raise NotImplementedError(
                f"{name}: on tetrahedra the CUDA kernel is K3's "
                "Crank-Nicolson midpoint body only")
        return _element_tet(name, jacobian, u, hist[0], p, dofmap_u, coords,
                            h, tabs, rho, mu, dt, f, eps, blocks)
    if not cuda:
        plain = _jacobian_plain if jacobian else _residual_plain
        fplain = facet_jac_plain if jacobian else facet_plain
        out = plain(*args, form=form)
        out = (out,) if jacobian else tuple(out)
        return out + tuple(fplain(b.term, b.scalars, u, hist[0], p,
                                  *b.args()) for b in blocks)
    import ctypes

    from ._build import check, library

    nc = dofmap_u.shape[0]
    dev, dt_ = u.device, u.dtype
    if jacobian:
        outs = (torch.empty((nc, 9, 9), dtype=dt_, device=dev),)
    else:
        outs = (torch.empty((nc, 3, 2), dtype=dt_, device=dev),
                torch.empty((nc, 3), dtype=dt_, device=dev))
    fouts = [torch.empty((b.dofmap_u.shape[0],)
                         + ((9, 9) if jacobian else (3, 2)),
                         dtype=dt_, device=dev) for b in blocks]
    uprev2 = hist[1] if len(hist) > 1 else hist[0]
    cp = _ptrs(ctypes.c_void_p, [
        t.data_ptr() for t in (u, hist[0], uprev2, p, dofmap_u, coords, h,
                               tabs.phi_u, tabs.dphi_u, tabs.qw)])
    a0, a1, a2 = a if a is not None else (0.0, 0.0, 0.0)
    f0, f1 = (float(v) for v in f)
    sc = _ptrs(ctypes.c_double, [float(rho), float(mu), float(dt), f0, f1,
                                 float(eps), float(a0), float(a1),
                                 float(a2)])
    fptr, fsize, fopt, fc, fo = _facet_args(blocks, fouts)
    with torch.cuda.device(dev):
        rc = library().cfd_ns_element_p1(
            cp, nc, tabs.qw.shape[0], sc, form,
            outs[0].data_ptr(), outs[1].data_ptr() if len(outs) > 1 else None,
            len(blocks), fptr, fsize, fopt, fc, fo, int(jacobian),
            is_f64(u), stream_handle(u))
    COUNTERS[name].n += 1
    if blocks:
        COUNTERS[name + "_facet"].n += 1
    for b in blocks:
        COUNTERS[b.term.counter(jacobian, fused=True)].n += 1
    check(rc, name)
    return outs + tuple(fouts)


def _element_tet(name, jacobian, u, uprev, p, dofmap_u, coords, h, tabs,
                 rho, mu, dt, f, eps, blocks):
    """One launch of the tetrahedral element kernel (csrc/ns_cell_tet.cu):
    the cells and every facet block (K7 only)."""
    import ctypes

    from ._build import check, library

    for b in blocks:
        if b.term.term != "natural":
            raise NotImplementedError(
                f"{name}: on tetrahedra the element kernel's launch carries "
                f"the natural correction (K7) only, not {b.term.term!r}")
    nc = dofmap_u.shape[0]
    dev, dt_ = u.device, u.dtype
    if jacobian:
        outs = (torch.empty((nc, 16, 16), dtype=dt_, device=dev),)
    else:
        outs = (torch.empty((nc, 4, 3), dtype=dt_, device=dev),
                torch.empty((nc, 4), dtype=dt_, device=dev))
    fouts = [torch.empty((b.dofmap_u.shape[0],)
                         + ((16, 16) if jacobian else (4, 3)),
                         dtype=dt_, device=dev) for b in blocks]
    cp = _ptrs(ctypes.c_void_p, [
        t.data_ptr() for t in (u, uprev, p, dofmap_u, coords, h,
                               tabs.phi_u, tabs.dphi_u, tabs.qw)])
    f0, f1, f2 = (float(v) for v in f)
    sc = _ptrs(ctypes.c_double, [float(rho), float(mu), float(dt), f0, f1,
                                 f2, float(eps)])
    fptr, fsize, fopt, fc, fo = _facet_args(blocks, fouts)
    with torch.cuda.device(dev):
        rc = library().cfd_ns_element_tet(
            cp, nc, tabs.qw.shape[0], sc, outs[0].data_ptr(),
            outs[1].data_ptr() if len(outs) > 1 else None, len(blocks),
            fptr, fsize, fopt, fc, fo, int(jacobian), is_f64(u),
            stream_handle(u))
    COUNTERS[name].n += 1
    COUNTERS[name + "_tet"].n += 1
    if blocks:
        COUNTERS[name + "_facet"].n += 1
    for b in blocks:
        COUNTERS[b.term.counter(jacobian, fused=True)].n += 1
    check(rc, name)
    return outs + tuple(fouts)


def ns_cell_residual_p1(u, uprev, p, dofmap_u, dofmap_p, coords, h,
                        tabs: CellTabs, rho, mu, dt, f, eps, facets=None):
    """Element residuals (ru_e (nc, nbu, d), rp_e (nc, nbp)) and, for
    each facet block (module docstring), its ru_f (nf, 3, 2), from one
    launch."""
    return _element("ns_cell_residual_p1", FORM_MID, False, u, (uprev,), p,
                    dofmap_u, dofmap_p, coords, h, tabs, rho, mu, dt, f, eps,
                    None, _blocks(facets))


def ns_cell_jacobian_p1(u, uprev, p, dofmap_u, dofmap_p, coords, h,
                        tabs: CellTabs, rho, mu, dt, f, eps, facets=None):
    """Exact element Jacobians A_cells (nc, nloc, nloc) of the cell
    residual with respect to the cell's (u, p), in the flat element
    layout [u(b, i) row-major, then p(b)]; with facet blocks (module
    docstring), (A_cells, A_f (nf, 9, 9) per block) from the same
    launch."""
    out = _element("ns_cell_jacobian_p1", FORM_MID, True, u, (uprev,), p,
                   dofmap_u, dofmap_p, coords, h, tabs, rho, mu, dt, f, eps,
                   None, _blocks(facets))
    return out if len(out) > 1 else out[0]


def ns_cell_residual_bdf2_p1(u, uprev, uprev2, p, dofmap_u, dofmap_p,
                             coords, h, tabs: CellTabs, rho, mu, dt, f, eps,
                             a, facets=None):
    """K14: the BDF2 element residuals (ru_e, rp_e), a = (a0, a1, a2),
    and each facet block's ru_f, from one launch."""
    return _element("ns_cell_residual_bdf2_p1", FORM_BDF2, False, u,
                    (uprev, uprev2), p, dofmap_u, dofmap_p, coords, h, tabs,
                    rho, mu, dt, f, eps, tuple(float(x) for x in a),
                    _blocks(facets))


def ns_cell_jacobian_bdf2_p1(u, uprev, uprev2, p, dofmap_u, dofmap_p,
                             coords, h, tabs: CellTabs, rho, mu, dt, f, eps,
                             a, facets=None):
    """K14: the BDF2 element Jacobians A_cells (nc, 9, 9) and each facet
    block's A_f, from one launch (A_cells alone without facet blocks)."""
    out = _element("ns_cell_jacobian_bdf2_p1", FORM_BDF2, True, u,
                   (uprev, uprev2), p, dofmap_u, dofmap_p, coords, h, tabs,
                   rho, mu, dt, f, eps, tuple(float(x) for x in a),
                   _blocks(facets))
    return out if len(out) > 1 else out[0]


def ns_cell_residual_curl_p1(u, uprev, p, dofmap_u, dofmap_p, coords, h,
                             tabs: CellTabs, rho, mu, dt, f, eps,
                             facets=None):
    """K15: the curl-curl element residuals (ru_e, rp_e) and each facet
    block's ru_f, from one launch."""
    return _element("ns_cell_residual_curl_p1", FORM_CURL, False, u,
                    (uprev,), p, dofmap_u, dofmap_p, coords, h, tabs, rho,
                    mu, dt, f, eps, None, _blocks(facets))


def ns_cell_jacobian_curl_p1(u, uprev, p, dofmap_u, dofmap_p, coords, h,
                             tabs: CellTabs, rho, mu, dt, f, eps,
                             facets=None):
    """K15: the curl-curl element Jacobians A_cells (nc, 9, 9) and each
    facet block's A_f, from one launch (A_cells alone without facet
    blocks)."""
    out = _element("ns_cell_jacobian_curl_p1", FORM_CURL, True, u,
                   (uprev,), p, dofmap_u, dofmap_p, coords, h, tabs, rho, mu,
                   dt, f, eps, None, _blocks(facets))
    return out if len(out) > 1 else out[0]
