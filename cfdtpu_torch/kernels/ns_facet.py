"""The facet-term kernels (csrc/ns_facet.cu), each with two entry
points, the facet residuals and the facet Jacobians: K7 the natural
correction (ns_facet_natural_p1, ns_facet_natural_jac_p1), K12 the
outlet viscous traction (ns_facet_viscous_p1, ns_facet_viscous_jac_p1),
K13 the backflow stabilisation (ns_facet_backflow_p1,
ns_facet_backflow_jac_p1), K16 the weak pressure (term "weakp"), K17
the symmetric Nitsche u_T = 0 in the sigma and curl forms ("nitsche",
"nitsche_curl") and K18 the convective and directional do-nothing
outlets ("cbc", "ddn"), each through facet_call; their plain versions;
and FacetTerm and FacetBlock, which describe a facet block to the
element kernels (kernels/ns_cell_residual.py), whose launch runs the
blocks' bodies.

The terms are cfdtpu's forms/facet_terms.py natural_correction,
`p n.v - mu (nabla_grad u)^T n.v`, viscous_traction, `sign (2 mu
eps(u) n).v`, backflow, `- beta rho (u_prev.n)_- (u.v)`,
weak_pressure, `scale pbar (v.n)`, nitsche_tangential and
nitsche_tangential_curl, `-(2 mu eps(u) n).v_T - (2 mu eps(v) n).u_T +
(beta mu / h) u_T.v_T` and its curl form, cbc, `- 1/2 (u_prev.n)
(u.v)`, and directional_do_nothing, `- 1/2 min(u_prev.n, 0) (u.v)`,
as StabilizedNSForm maps them over a facet block, at the
Crank-Nicolson midpoint or (`implicit`, BDF2's) at u. The plain
versions are torch.func.vmap (and jacfwd) of the port's per-facet
kernels in forms/facet_terms.py, which serve CPU tensors.

The CUDA kernels cover P1 triangles (three velocity and three pressure
dofs on the cell behind each facet, dim 2); on P1 tetrahedra K7 runs in
the tetrahedral element kernel's launch (csrc/ns_cell_tet.cu: triangular
facets, 3D normals, blocks of (nf, 4) maps and (nf, nq, 4, 3) tables)
and never alone. For any other block a CUDA tensor raises; there is no
fallback.

A facet block is passed as its tensors: `dofmap_u`, `dofmap_p` (nf, 3)
int32, `coords` (nf, 3, 2) and `tabs`, the dict of per-facet
tabulations phi_u (nf, nq, 3), dphi_u (nf, nq, 3, 2), phi_p (nf, nq, 3),
gdphi (nf, nq, 3, 2), normal (nf, nq, 2), dS (nf, nq) and h (nf,),
the size of the cell behind each facet (read by Nitsche).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import COUNTERS
from ._common import (check_float, check_index, check_same_device, is_f64,
                      on_cuda, require, stream_handle)

TABS = ("phi_u", "dphi_u", "phi_p", "gdphi", "normal", "dS", "h")
# the terms as csrc/ns_facet.cuh numbers them (each one's kernel is
# ns_facet_<term>)
TERM_CODE = {"natural": 0, "viscous": 1, "backflow": 2, "weakp": 3,
             "nitsche": 4, "nitsche_curl": 5, "cbc": 6, "ddn": 7}
# the scalars c, c2 of each term's body (csrc/ns_facet.cuh FacetRange)
# from the prm entries it reads
_COEFS = {
    "natural": lambda t, s: (s["mu"], 0.0),
    "viscous": lambda t, s: (t.sign * s["mu"], 0.0),
    "backflow": lambda t, s: (-s[t.beta_key] * s["rho"], 0.0),
    "weakp": lambda t, s: (t.scale * s[t.pressure_key], 0.0),
    "nitsche": lambda t, s: (s["mu"], s[t.beta_key] * s["mu"]),
    "nitsche_curl": lambda t, s: (s["mu"], s[t.beta_key] * s["mu"]),
    "cbc": lambda t, s: (-0.5, 0.0),
    "ddn": lambda t, s: (-0.5, 0.0),
}
# the prm keys each term reads (beta_key and pressure_key by name)
_READS = {"natural": ("mu",), "viscous": ("mu",),
          "backflow": ("rho", "beta_key"), "weakp": ("pressure_key",),
          "nitsche": ("mu", "beta_key"), "nitsche_curl": ("mu", "beta_key"),
          "cbc": (), "ddn": ()}


@dataclass(frozen=True)
class FacetTerm:
    """A facet term with a CUDA kernel and its options: `term` "natural"
    (K7), "viscous" (K12), "backflow" (K13), "weakp" (K16), "nitsche" or
    "nitsche_curl" (K17), "cbc" or "ddn" (K18); `implicit`: the term acts
    on u (BDF2), else on the midpoint (u + u_prev) / 2; `sign` of the
    viscous traction; `beta_key`, the prm key of backflow's or Nitsche's
    beta; `pressure_key` and `scale` of the weak pressure."""

    term: str
    implicit: bool = False
    sign: float = -1.0
    beta_key: str = "beta_backflow"
    pressure_key: str = ""
    scale: float = 1.0

    def __post_init__(self):
        if self.term not in TERM_CODE:
            raise NotImplementedError(f"no facet kernel for {self.term!r}")

    @property
    def kernel(self) -> str:
        """The name of the term's CUDA kernel."""
        return "ns_facet_" + self.term

    def counter(self, jacobian: bool, fused: bool = False) -> str:
        """The counter of a launch of this term: alone, or (fused) as a
        block in an element kernel's launch."""
        name = self.kernel + ("_jac" if jacobian else "") + "_p1"
        return name + ("_fused" if fused else "")

    def scalars(self, prm: dict) -> dict:
        """The prm entries the term reads, as Python floats: read at
        every call, so a value that changes between steps (a resistance
        outlet's p_c) reaches the next launch."""
        keys = [getattr(self, k) if k.endswith("_key") else k
                for k in _READS[self.term]]
        return {k: float(prm[k]) for k in keys}

    def coefs(self, scalars: dict) -> tuple[float, float]:
        """The two scalars the CUDA body takes (c, c2): mu, sign mu,
        -beta rho, scale pbar, (mu, beta mu) or -1/2."""
        c, c2 = _COEFS[self.term](self, scalars)
        return float(c), float(c2)

    def plain_kernel(self):
        """The port's per-facet kernel of this term (forms/facet_terms)."""
        # imported here: forms imports this module
        from ..forms import facet_terms as ft

        vel = ft.implicit_velocity if self.implicit else ft.midpoint_velocity
        make = {
            "natural": lambda: ft.natural_correction(vel=vel),
            "viscous": lambda: ft.viscous_traction(vel=vel, sign=self.sign),
            "backflow": lambda: ft.backflow(beta_key=self.beta_key, vel=vel),
            "weakp": lambda: ft.weak_pressure(self.pressure_key, self.scale),
            "nitsche": lambda: ft.nitsche_tangential(self.beta_key, vel=vel),
            "nitsche_curl": lambda: ft.nitsche_tangential_curl(
                self.beta_key, vel=vel),
            "cbc": lambda: ft.cbc(vel=vel),
            "ddn": lambda: ft.directional_do_nothing(vel=vel),
        }
        return make[self.term]()


@dataclass
class FacetBlock:
    """A facet block as the element kernels take it: its term, its
    tensors (int32 dofmaps) and the scalars its term reads."""

    term: FacetTerm
    dofmap_u: torch.Tensor
    dofmap_p: torch.Tensor
    coords: torch.Tensor
    tabs: dict
    scalars: dict

    def args(self):
        return (self.dofmap_u, self.dofmap_p, self.coords, self.tabs)


def facet_plain(term: FacetTerm, scalars: dict, u, uprev, p, dofmap_u,
                dofmap_p, coords, tabs):
    """The plain residual: dofmap gathers + vmap of the facet kernel."""
    kernel = term.plain_kernel()
    dmu, dmp = dofmap_u.long(), dofmap_p.long()

    def one(ue, pe, upe, ce, tb):
        return kernel(ue, pe, (upe,), ce, tb, scalars)

    return torch.func.vmap(one)(u[dmu], p[dmp], uprev[dmu], coords, tabs)


def facet_jac_plain(term: FacetTerm, scalars: dict, u, uprev, p, dofmap_u,
                    dofmap_p, coords, tabs):
    """The plain Jacobian: vmap(jacfwd(.)) of the facet kernel in the
    flat element layout, its pressure rows padded with zeros."""
    kernel = term.plain_kernel()
    dmu, dmp = dofmap_u.long(), dofmap_p.long()
    nf, nbu = dmu.shape
    nud = nbu * u.shape[1]
    nbp = dmp.shape[1]

    def fk(x, upe, ce, tb):
        ru = kernel(x[:nud].reshape(nbu, -1), x[nud:], (upe,), ce, tb,
                    scalars)
        return torch.cat([ru.reshape(-1),
                          torch.zeros((nbp,), dtype=ru.dtype,
                                      device=ru.device)])

    xe = torch.cat([u[dmu].reshape(nf, -1), p[dmp]], dim=1)
    return torch.func.vmap(torch.func.jacfwd(fk))(xe, uprev[dmu], coords,
                                                  tabs)


def check_args(name, u, uprev, p, dofmap_u, dofmap_p, coords, tabs):
    """The checks of a facet block's arguments; True where they are on
    the card (where the block must be one the kernels cover)."""
    check_float("u", u)
    check_index("dofmap_u", dofmap_u)
    check_index("dofmap_p", dofmap_p)
    floats = [("uprev", uprev), ("p", p), ("coords", coords)]
    floats += [(k, tabs[k]) for k in TABS]
    for key, t in floats:
        check_float(key, t, u.dtype)
    check_same_device(("u", u), ("dofmap_u", dofmap_u),
                      ("dofmap_p", dofmap_p), *floats)
    if not on_cuda(u):
        return False
    nf = dofmap_u.shape[0]
    nq = tabs["dS"].shape[1]
    # the cells behind the facets: triangles (d 2) or tetrahedra (d 3)
    d = u.shape[1] if u.dim() == 2 else 0
    nv = d + 1
    shapes = {"phi_u": (nf, nq, nv), "dphi_u": (nf, nq, nv, d),
              "phi_p": (nf, nq, nv), "gdphi": (nf, nq, nv, d),
              "normal": (nf, nq, d), "dS": (nf, nq), "h": (nf,)}
    p1 = (d in (2, 3) and tuple(dofmap_u.shape) == (nf, nv)
          and tuple(dofmap_p.shape) == (nf, nv)
          and tuple(coords.shape) == (nf, nv, d)
          and all(tuple(tabs[k].shape) == v for k, v in shapes.items()))
    if not p1:
        raise NotImplementedError(
            f"{name} covers the facets of P1 triangles and tetrahedra (d + "
            "1 velocity and pressure dofs a cell, dim d = 2 or 3) only"
        )
    require(tuple(uprev.shape) == tuple(u.shape) and p.dim() == 1,
            f"{name}: uprev as u, p (n,)")
    for key, t in [("u", u)] + floats:
        require(t.is_contiguous(), f"{name}: {key} must be contiguous")
    if d == 3:  # read by scalar loads (csrc/ns_cell_tet.cu)
        return True
    for key, t in (("u", u), ("uprev", uprev), ("coords", coords)):
        # read as 2-vectors (8 or 16 bytes)
        require(t.data_ptr() % (2 * t.element_size()) == 0,
                f"{name}: {key} must be aligned to a pair of values")
    return True


def facet_call(term: FacetTerm, scalars: dict, jacobian: bool, u, uprev,
               p, dofmap_u, dofmap_p, coords, tabs):
    """One facet term over one block: its kernel launched alone on the
    card, its plain version on the CPU."""
    name = term.counter(jacobian)
    args = (u, uprev, p, dofmap_u, dofmap_p, coords, tabs)
    if not check_args(name, *args):
        plain = facet_jac_plain if jacobian else facet_plain
        return plain(term, scalars, *args)
    if u.shape[1] != 2:
        raise NotImplementedError(
            f"{name} alone covers triangles' edges; on tetrahedra the "
            "natural correction runs in the element kernel's launch")
    from ._build import check, library

    nf, nq = tabs["dS"].shape
    shape = (nf, 9, 9) if jacobian else (nf, 3, 2)
    out = torch.empty(shape, dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        rc = library().cfd_ns_facet_p1(
            TERM_CODE[term.term], int(term.implicit), u.data_ptr(),
            uprev.data_ptr(), p.data_ptr(), dofmap_u.data_ptr(),
            dofmap_p.data_ptr(), coords.data_ptr(),
            *(tabs[k].data_ptr() for k in TABS), nf, nq,
            *term.coefs(scalars), int(jacobian), out.data_ptr(),
            is_f64(u), stream_handle(u))
    COUNTERS[name].n += 1
    check(rc, name)
    return out


# ---------------------------------------------------------------------
# the entry points of K7, K12 and K13
# ---------------------------------------------------------------------
def _natural(implicit):
    return FacetTerm("natural", bool(implicit))


def ns_facet_natural_plain(u, uprev, p, dofmap_u, dofmap_p, coords, tabs,
                           mu, implicit=False):
    """K7's plain residual: dofmap gathers + vmap of the facet kernel."""
    return facet_plain(_natural(implicit), {"mu": mu}, u, uprev, p,
                       dofmap_u, dofmap_p, coords, tabs)


def ns_facet_natural_jac_plain(u, uprev, p, dofmap_u, dofmap_p, coords,
                               tabs, mu, implicit=False):
    """K7's plain Jacobian: vmap(jacfwd(.)) of the facet kernel in the
    flat element layout, its pressure rows padded with zeros."""
    return facet_jac_plain(_natural(implicit), {"mu": mu}, u, uprev, p,
                           dofmap_u, dofmap_p, coords, tabs)


def ns_facet_natural_p1(u, uprev, p, dofmap_u, dofmap_p, coords, tabs, mu,
                        implicit=False):
    """Facet residuals ru_f (nf, 3, 2) of the natural correction."""
    return facet_call(_natural(implicit), {"mu": mu}, False, u, uprev, p,
                      dofmap_u, dofmap_p, coords, tabs)


def ns_facet_natural_jac_p1(u, uprev, p, dofmap_u, dofmap_p, coords, tabs,
                            mu, implicit=False):
    """Facet Jacobians A_f (nf, 9, 9) of the natural correction with
    respect to the cell's (u, p), in the flat element layout [u(b, i)
    row-major, then p(b)]; the pressure rows are zero."""
    return facet_call(_natural(implicit), {"mu": mu}, True, u, uprev, p,
                      dofmap_u, dofmap_p, coords, tabs)


def ns_facet_viscous_p1(u, uprev, p, dofmap_u, dofmap_p, coords, tabs, mu,
                        sign=-1.0, implicit=False):
    """Facet residuals ru_f (nf, 3, 2) of the viscous traction."""
    return facet_call(FacetTerm("viscous", implicit, sign=sign),
                      {"mu": mu}, False, u, uprev, p, dofmap_u, dofmap_p,
                      coords, tabs)


def ns_facet_viscous_jac_p1(u, uprev, p, dofmap_u, dofmap_p, coords, tabs,
                            mu, sign=-1.0, implicit=False):
    """Facet Jacobians A_f (nf, 9, 9) of the viscous traction, in the
    flat element layout [u(b, i) row-major, then p(b)]; the pressure rows
    and columns are zero."""
    return facet_call(FacetTerm("viscous", implicit, sign=sign),
                      {"mu": mu}, True, u, uprev, p, dofmap_u, dofmap_p,
                      coords, tabs)


def _backflow(beta, rho, implicit):
    return (FacetTerm("backflow", implicit),
            {"rho": rho, "beta_backflow": beta})


def ns_facet_backflow_p1(u, uprev, p, dofmap_u, dofmap_p, coords, tabs,
                         beta, rho, implicit=False):
    """Facet residuals ru_f (nf, 3, 2) of the backflow stabilisation."""
    return facet_call(*_backflow(beta, rho, implicit), False, u, uprev, p,
                      dofmap_u, dofmap_p, coords, tabs)


def ns_facet_backflow_jac_p1(u, uprev, p, dofmap_u, dofmap_p, coords, tabs,
                             beta, rho, implicit=False):
    """Facet Jacobians A_f (nf, 9, 9) of the backflow stabilisation; the
    pressure rows and columns are zero."""
    return facet_call(*_backflow(beta, rho, implicit), True, u, uprev, p,
                      dofmap_u, dofmap_p, coords, tabs)
