"""K7: the natural-correction facet term (csrc/ns_facet_natural.cu) with
its two entry points, ns_facet_natural_p1 (facet residuals) and
ns_facet_natural_jac_p1 (facet Jacobians), and their plain versions.

The term is cfdtpu's forms/facet_terms.py natural_correction,
`p n.v - mu (nabla_grad u)^T n.v` at the Crank-Nicolson midpoint, as
StabilizedNSForm maps it over a facet block. The plain versions are
torch.func.vmap (and jacfwd) of the port's per-facet kernel
forms/facet_terms.py natural_correction, which serve CPU tensors.

The CUDA kernels cover P1 triangles (three velocity and three pressure
dofs on the cell behind each facet, dim 2). For any other block a CUDA
tensor raises; there is no fallback.

A facet block is passed as its tensors: `dofmap_u`, `dofmap_p` (nf, 3)
int32, `coords` (nf, 3, 2) and `tabs`, the dict of per-facet
tabulations phi_u (nf, nq, 3), dphi_u (nf, nq, 3, 2), phi_p (nf, nq, 3),
gdphi (nf, nq, 3, 2), normal (nf, nq, 2), dS (nf, nq) (and h, unused by
this term).
"""

from __future__ import annotations

import torch

from . import COUNTERS
from ._common import (check_float, check_index, check_same_device, is_f64,
                      on_cuda, require, stream_handle)

_COUNT = COUNTERS["ns_facet_natural_p1"]
_COUNT_JAC = COUNTERS["ns_facet_natural_jac_p1"]
_TABS = ("phi_u", "dphi_u", "phi_p", "gdphi", "normal", "dS")


def _facet_kernel(mu):
    # imported here: forms imports this module
    from ..forms.facet_terms import natural_correction

    kernel = natural_correction()
    prm = {"mu": mu}
    return lambda ue, pe, upe, ce, tb: kernel(ue, pe, (upe,), ce, tb, prm)


def ns_facet_natural_plain(u, uprev, p, dofmap_u, dofmap_p, coords, tabs,
                           mu):
    """The plain residual: dofmap gathers + vmap of the facet kernel."""
    dmu, dmp = dofmap_u.long(), dofmap_p.long()
    return torch.func.vmap(_facet_kernel(mu))(u[dmu], p[dmp], uprev[dmu],
                                              coords, tabs)


def ns_facet_natural_jac_plain(u, uprev, p, dofmap_u, dofmap_p, coords,
                               tabs, mu):
    """The plain Jacobian: vmap(jacfwd(.)) of the facet kernel in the
    flat element layout, its pressure rows padded with zeros."""
    dmu, dmp = dofmap_u.long(), dofmap_p.long()
    kernel = _facet_kernel(mu)
    nf, nbu = dmu.shape
    nud = nbu * u.shape[1]
    nbp = dmp.shape[1]

    def fk(x, upe, ce, tb):
        ru = kernel(x[:nud].reshape(nbu, -1), x[nud:], upe, ce, tb)
        return torch.cat([ru.reshape(-1),
                          torch.zeros((nbp,), dtype=ru.dtype,
                                      device=ru.device)])

    xe = torch.cat([u[dmu].reshape(nf, -1), p[dmp]], dim=1)
    return torch.func.vmap(torch.func.jacfwd(fk))(xe, uprev[dmu], coords,
                                                  tabs)


def _check_args(name, u, uprev, p, dofmap_u, dofmap_p, coords, tabs):
    check_float("u", u)
    check_index("dofmap_u", dofmap_u)
    check_index("dofmap_p", dofmap_p)
    floats = [("uprev", uprev), ("p", p), ("coords", coords)]
    floats += [(k, tabs[k]) for k in _TABS]
    for key, t in floats:
        check_float(key, t, u.dtype)
    check_same_device(("u", u), ("dofmap_u", dofmap_u),
                      ("dofmap_p", dofmap_p), *floats)
    if not on_cuda(u):
        return False
    nf = dofmap_u.shape[0]
    nq = tabs["dS"].shape[1]
    shapes = {"phi_u": (nf, nq, 3), "dphi_u": (nf, nq, 3, 2),
              "phi_p": (nf, nq, 3), "gdphi": (nf, nq, 3, 2),
              "normal": (nf, nq, 2), "dS": (nf, nq)}
    p1 = (tuple(dofmap_u.shape) == (nf, 3)
          and tuple(dofmap_p.shape) == (nf, 3)
          and tuple(coords.shape) == (nf, 3, 2) and u.dim() == 2
          and u.shape[1] == 2
          and all(tuple(tabs[k].shape) == v for k, v in shapes.items()))
    if not p1:
        raise NotImplementedError(
            f"{name} covers P1 triangles (3 velocity and 3 pressure dofs "
            "a cell, dim 2) only"
        )
    require(tuple(uprev.shape) == tuple(u.shape) and p.dim() == 1,
            f"{name}: uprev as u, p (n,)")
    for key, t in [("u", u)] + floats:
        require(t.is_contiguous(), f"{name}: {key} must be contiguous")
    for key, t in (("u", u), ("uprev", uprev), ("coords", coords)):
        # read as 2-vectors (8 or 16 bytes)
        require(t.data_ptr() % (2 * t.element_size()) == 0,
                f"{name}: {key} must be aligned to a pair of values")
    return True


def _launch(name, counter, jacobian, out, u, uprev, p, dofmap_u, dofmap_p,
            coords, tabs, mu):
    from ._build import check, library

    nf, nq = tabs["dS"].shape
    with torch.cuda.device(u.device):
        rc = library().cfd_ns_facet_natural_p1(
            u.data_ptr(), uprev.data_ptr(), p.data_ptr(),
            dofmap_u.data_ptr(), dofmap_p.data_ptr(), coords.data_ptr(),
            *(tabs[k].data_ptr() for k in _TABS), nf, nq, float(mu),
            jacobian, out.data_ptr(), is_f64(u), stream_handle(u),
        )
    counter.n += 1
    check(rc, name)


def ns_facet_natural_p1(u, uprev, p, dofmap_u, dofmap_p, coords, tabs, mu):
    """Facet residuals ru_f (nf, 3, 2) of the natural correction."""
    args = (u, uprev, p, dofmap_u, dofmap_p, coords, tabs)
    if not _check_args("ns_facet_natural_p1", *args):
        return ns_facet_natural_plain(*args, mu)
    ru_f = torch.empty((dofmap_u.shape[0], 3, 2), dtype=u.dtype,
                       device=u.device)
    _launch("ns_facet_natural_p1", _COUNT, 0, ru_f, *args, mu)
    return ru_f


def ns_facet_natural_jac_p1(u, uprev, p, dofmap_u, dofmap_p, coords, tabs,
                            mu):
    """Facet Jacobians A_f (nf, 9, 9) of the natural correction with
    respect to the cell's (u, p), in the flat element layout [u(b, i)
    row-major, then p(b)]; the pressure rows are zero."""
    args = (u, uprev, p, dofmap_u, dofmap_p, coords, tabs)
    if not _check_args("ns_facet_natural_jac_p1", *args):
        return ns_facet_natural_jac_plain(*args, mu)
    A_f = torch.empty((dofmap_u.shape[0], 9, 9), dtype=u.dtype,
                      device=u.device)
    _launch("ns_facet_natural_jac_p1", _COUNT_JAC, 1, A_f, *args, mu)
    return A_f
