"""Solver base class.

The counterpart of cfdtpu/solvers/base.py: holds the dt/rho/mu/f
constants, the velocity/pressure spaces V/Q, the state tensors
u_sol/p_sol/u_prev/p_prev and the residuals, and the wall-shear-stress
output. State lives as torch tensors on `device` (the CUDA card unless the
caller passes device="cpu"), in `dtype` (the mesh's dtype unless
given).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable

import numpy as np
import torch

from ..assembly import FacetQuadrature
from ..elements import LagrangeElement
from ..mesh import Mesh
from ..spaces import FunctionSpace
from ..utils import SortedScatter, det_and_inv, resolve_device, torch_dtype


class SolverBase(ABC):
    def __init__(
        self,
        mesh: Mesh,
        dt: float,
        rho: float,
        mu: float,
        f,
        initial_velocity: Callable | None = None,
        device=None,
        dtype=None,
    ):
        self.mesh = mesh
        self.device = resolve_device(device)
        self.np_dtype = np.dtype(mesh.points.dtype if dtype is None
                                 else dtype)
        self.dtype = torch_dtype(self.np_dtype)
        self.dt = float(dt)
        self.rho = float(rho)
        self.mu = float(mu)
        self.f = np.asarray(f, dtype=self.np_dtype).reshape(mesh.gdim)
        self._V = None
        self._Q = None
        self.u_sol = None
        self.p_sol = None
        self.u_prev = None
        self.p_prev = None
        self.u_residual = None
        self.p_residual = None
        self.shear_stress = None
        self._wss = None

    def tensor(self, a) -> torch.Tensor:
        """A host array as a tensor in the solver's dtype and device."""
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    # -- spaces ---------------------------------------------------------
    @property
    def V(self) -> FunctionSpace:
        if self._V is None:
            raise RuntimeError("call initVelocitySpace() first")
        return self._V

    @property
    def Q(self) -> FunctionSpace:
        if self._Q is None:
            raise RuntimeError("call initPressureSpace() first")
        return self._Q

    def initVelocitySpace(self, degree: int) -> None:
        self._V = FunctionSpace(self.mesh, degree, self.mesh.gdim)
        z = torch.zeros((self._V.num_dofs, self.mesh.gdim),
                        dtype=self.dtype, device=self.device)
        self.u_sol = z
        self.u_prev = z
        self.u_residual = z

    def initPressureSpace(self, degree: int) -> None:
        self._Q = FunctionSpace(self.mesh, degree, 1)
        z = torch.zeros((self._Q.num_dofs,), dtype=self.dtype,
                        device=self.device)
        self.p_sol = z
        self.p_prev = z
        self.p_residual = z

    # -- abstract interface ------------------------------------------------
    @abstractmethod
    def setup(self, bcu, bcp, facet_tags=None, tags=None) -> None:
        ...

    @abstractmethod
    def solveStep(self) -> None:
        ...

    def l2_norm_sq(self, fn):
        """Integral of |fn|^2 (delegates to the solver's form)."""
        return self.form.l2_norm_sq(fn)

    # -- params ------------------------------------------------------------
    def base_params(self) -> dict:
        """Constants as Python floats (the CUDA kernels take them by
        value; nothing needs a device round trip)."""
        return {
            "dt": self.dt,
            "rho": self.rho,
            "mu": self.mu,
            "f": tuple(float(v) for v in self.f),
        }

    # -- wall shear stress ------------------------------------------------
    def initStressForm(self) -> None:
        """Prepare the WSS boundary data: the tangential traction
        (T - (T·n) n)/FacetArea with T = -sigma(u, p) n, assembled into a
        CG1 vector function."""
        mesh = self.mesh
        self._wss_space = FunctionSpace(mesh, 1, mesh.gdim)
        self.shear_stress = torch.zeros(
            (self._wss_space.num_dofs, mesh.gdim), dtype=self.dtype,
            device=self.device)
        all_facets = np.arange(len(mesh.facets), dtype=np.int32)
        fq = FacetQuadrature(mesh, all_facets, 2 * self.V.degree + 1)
        phi_u, dphi_u = fq.tabulate(self.V.element)
        phi_p, _ = fq.tabulate(self.Q.element)
        phi_w, _ = fq.tabulate(self._wss_space.element)
        geom = LagrangeElement.create(mesh.cell_type, 1)
        _, gdphi = fq.tabulate(geom)
        _, normal, dS = fq.geometry()
        area = fq.facet_measure()
        g = fq.group

        def idx(a):
            return torch.as_tensor(np.asarray(a).astype(np.int64),
                                   device=self.device)

        self._wss = {
            "phi_u": self.tensor(phi_u)[idx(g)],
            "dphi_u": self.tensor(dphi_u)[idx(g)],
            "phi_p": self.tensor(phi_p)[idx(g)],
            "phi_w": self.tensor(phi_w)[idx(g)],
            "gdphi": self.tensor(gdphi)[idx(g)],
            "normal": self.tensor(normal),
            "dS": self.tensor(dS),
            "inv_area": self.tensor(1.0 / area),
            "dofmap_u": idx(self.V.dofmap[fq.cells]),
            "dofmap_p": idx(self.Q.dofmap[fq.cells]),
            # deterministic facet -> node reduction (K2), as the form's
            # facet blocks sum their residual
            "scatter_w": SortedScatter(self._wss_space.dofmap[fq.cells],
                                       self._wss_space.num_dofs,
                                       device=self.device),
            "coords": self.tensor(mesh.points[mesh.cells][fq.cells]),
        }

    def assemble_wss(self) -> None:
        if self._wss is None:
            return
        w = self._wss
        u_e = self.u_sol[w["dofmap_u"]]
        p_e = self.p_sol[w["dofmap_p"]]
        n, dS = w["normal"], w["dS"]
        J = torch.einsum("fvg,fqvd->fqgd", w["coords"], w["gdphi"])
        _, invJ = det_and_inv(J)
        gu = torch.einsum("fqbd,fqdg->fqbg", w["dphi_u"], invJ)
        grad_u = torch.einsum("fbi,fqbg->fqig", u_e, gu)
        p_q = torch.einsum("fqb,fb->fq", w["phi_p"], p_e)
        # sigma = mu (grad u + grad u^T) - p I; T = -sigma n
        sig_n = (
            self.mu * (torch.einsum("fqig,fqg->fqi", grad_u, n)
                       + torch.einsum("fqgi,fqg->fqi", grad_u, n))
            - p_q[..., None] * n
        )
        T = -sig_n
        Tn = torch.einsum("fqi,fqi->fq", T, n)
        Tt = T - Tn[..., None] * n
        vals = torch.einsum("f,fq,fqb,fqi->fbi", w["inv_area"], dS,
                            w["phi_w"], Tt)
        # cfdtpu adds with .at[dofmap_w].add; K2 sums each node's facet
        # contributions in a fixed order (no atomics)
        self.shear_stress = w["scatter_w"](
            vals.reshape(-1, self.mesh.gdim).contiguous())
