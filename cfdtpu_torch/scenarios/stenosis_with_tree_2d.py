"""Stenosis coupled to a procedural 2D vascular tree.

The counterpart of cfdtpu/scenarios/stenosis_with_tree_2d.py
(a rebuild of the reference's src/scenarios/stenosis_with_tree_2d.py): the
stenosis channel (mm-g-s blood units) with a VascularTree2D attached at
the outlet (Murray's law, asymmetry, generation count; reference tree
params :58-64). When R_resistance is given, the terminal outlets use
R_effective = R_resistance - R_tree where R_tree is the analytic 2D
Poiseuille resistance of the included tree
R_tree = (3 mu alpha / 2 r0^2) sum_j 2^{-j/3} (:207-223). The domain
union is meshed natively (geom/tree_mesh2d.py; the reference uses
OCC booleans + fillets). Terminal caps are the tagged outlets.

stenosis_position is the axial position as a FRACTION of the length
(reference :55-57).
"""

from __future__ import annotations

from ..geom.tree.tree_2d import VascularTree2D
from ..geom.tree_mesh2d import generate_stenosis_tree_mesh_2d
from .stenosis import StenosisSimulation


class StenosisWithTree2DSimulation(StenosisSimulation):
    def __init__(
        self,
        solver_name,
        dt,
        T,
        f=(0, 0),
        grade="severe",
        p_inlet: float = 75.0,
        p_outlet: float = 10.0,
        *,
        rho: float = 1.060e-3,
        mu: float = 3.5e-3,
        stenosis_position: float = 0.2,
        n_generations: int = 3,
        tree_gamma: float = 3.0,
        tree_angle: float = 35.0,
        tree_length_ratio: float = 8.0,
        tree_asymmetry: float = 0.5,
        coupling_slope: float = 0.3,
        **kwargs,
    ):
        self.tree_params = dict(
            n_generations=int(n_generations),
            gamma=float(tree_gamma),
            bifurcation_angle=float(tree_angle),
            length_ratio=float(tree_length_ratio),
            asymmetry=float(tree_asymmetry),
        )
        self._tree = None

        # included-tree resistance reduces the prescribed R_resistance
        # (reference :166-184)
        R_resistance = kwargs.get("R_resistance")
        if R_resistance is not None:
            r_root = kwargs.get("radius_out", 1.2)
            probe = VascularTree2D(
                r_root=r_root, **self.tree_params
            )
            R_tree = probe.poiseuille_resistance(mu)
            R_eff = max(float(R_resistance) - R_tree, 0.0)
            print(
                f"[tree] R_tree(included)={R_tree:.4e}, "
                f"R_effective(outlets)={R_eff:.4e}"
            )
            kwargs["R_resistance"] = R_eff

        L = kwargs.get("length", kwargs.get("L", 138.0))
        kwargs["x_position_stenosis"] = float(stenosis_position) * L
        super().__init__(
            solver_name, dt, T, f, grade=grade, p_inlet=p_inlet,
            p_outlet=p_outlet, rho=rho, mu=mu, **kwargs,
        )

    @property
    def tree(self) -> VascularTree2D:
        if self._tree is None:
            o = self.mesh_options
            self._tree = VascularTree2D(
                r_root=0.9 * o["R_out"], **self.tree_params
            ).generate((o["L"], o["R_in"]), direction=0.0)
        return self._tree

    @property
    def mesh(self):
        if self._mesh is None:
            opts = {
                k: v for k, v in self.mesh_options.items()
                if k in (
                    "L", "R_in", "R_out", "res", "x_position_stenosis",
                    "severity", "slope", "tension",
                )
            }
            self._mesh = generate_stenosis_tree_mesh_2d(
                tree=self.tree,
                dtype=self._dtype,
                inlet_marker=self.inlet_marker,
                outlet_marker=self.outlet_marker,
                wall_marker=self.wall_marker,
                **opts,
            )
        return self._mesh
