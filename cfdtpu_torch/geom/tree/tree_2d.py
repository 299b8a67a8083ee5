"""Procedural 2D vascular tree (VascuSynth-inspired).

Rebuild of the reference's src/geom/tree/tree_2d.py: a binary tree built
generation by generation with the hemodynamic constraints kept — Murray's
law r_p^gamma = r_l^gamma + r_r^gamma, flow split Q_l = asymmetry * Q_p,
Poiseuille Q ~ r^3 (L ~ r) giving r_l/r_r = (a/(1-a))^{1/3} (:113-135) —
branch length = length_ratio * radius, bifurcation half-angle scaled by
the sibling radius ratio (:137-172). Exposes bifurcation_points for
fillet placement (:174-198).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class VascularTree2D:
    r_root: float = 1.2
    n_generations: int = 3
    gamma: float = 3.0
    bifurcation_angle: float = 35.0
    length_ratio: float = 8.0
    asymmetry: float = 0.5

    nodes: dict = field(default_factory=dict, repr=False)
    edges: list = field(default_factory=list, repr=False)
    terminals: list = field(default_factory=list, repr=False)
    _next_id: int = field(default=0, repr=False)

    def _new_id(self) -> int:
        nid = self._next_id
        self._next_id += 1
        return nid

    def _grow_segment(self, start_id, radius, heading_deg):
        """Append one vessel segment of length length_ratio*radius from
        an existing node along `heading_deg`; returns the new end node."""
        th = np.radians(heading_deg)
        end = self._new_id()
        self.nodes[end] = self.nodes[start_id] + (
            self.length_ratio * radius * np.array([np.cos(th), np.sin(th)])
        )
        return end

    def _murray_radii(self, r_parent: float):
        """Daughter radii under Murray's law r_p^g = r_l^g + r_r^g with
        the flow split Q_l/Q_r = a/(1-a) mapped to radii through the
        2D Poiseuille closure Q ~ r^4/L and L ~ r (so Q ~ r^3):
        r_l/r_r = (a/(1-a))^(1/3)."""
        a, g = self.asymmetry, self.gamma
        rho = (a / (1.0 - a)) ** (1.0 / 3.0)
        # substitute r_r = r_l/rho into Murray's law and solve for r_l
        r_l = r_parent / (1.0 + rho ** (-g)) ** (1.0 / g)
        return r_l, r_l / rho

    def generate(self, origin, direction: float = 0.0):
        """Build the tree from `origin` heading `direction` degrees
        (0 = +x); origin is typically the stenosis outlet center.

        Iterative frontier walk: each frontier entry is an open vessel
        end (node id, lumen radius, heading, depth); every sweep either
        splits it into two Murray daughters or, past the generation
        budget, retires it as a terminal."""
        self.nodes.clear()
        self.edges.clear()
        self.terminals.clear()
        self._next_id = 0

        root_start = self._new_id()
        self.nodes[root_start] = np.asarray(origin, dtype=float)
        root_end = self._grow_segment(root_start, self.r_root, direction)
        self.edges.append({
            "from": root_start, "to": root_end,
            "radius": self.r_root, "r_parent": self.r_root,
            "generation": 0,
        })

        frontier = [(root_end, self.r_root, direction, 1)]
        while frontier:
            node, r_p, heading, depth = frontier.pop()
            if depth > self.n_generations:
                self.terminals.append(node)
                continue
            r_l, r_r = self._murray_radii(r_p)
            # Deflection is weighted by the SIBLING's relative radius:
            # the small daughter carries little flow, so the bulk stream
            # (and the larger daughter) stays nearer the parent axis
            # while the small one swings wide.
            for r_c, sib in ((r_l, r_r), (r_r, -r_l)):
                ang = heading + self.bifurcation_angle * (sib / r_p)
                child = self._grow_segment(node, r_c, ang)
                self.edges.append({
                    "from": node, "to": child,
                    "radius": r_c, "r_parent": r_p,
                    "generation": depth,
                })
                frontier.append((child, r_c, ang, depth + 1))
        return self

    @property
    def bifurcation_points(self):
        children_of: dict = {}
        for e in self.edges:
            children_of.setdefault(e["from"], []).append(e)
        return [
            {
                "node": nid,
                "pos": self.nodes[nid],
                "r_min": min(e["radius"] for e in ch),
            }
            for nid, ch in children_of.items()
            if len(ch) >= 2
        ]

    def apply_modifications(
        self,
        vessel_loss_factor: float = 0.0,
        hyperemia_factor: float = 1.0,
        wall_severity: float = 0.0,
        wall_level_threshold: int = 0,
    ):
        """Prune / dilate / thicken the generated tree — the 2D analogue
        of VascularTree.apply_modifications (reference
        src/geom/tree/tree_model.py:26-42): vessel rarefaction removes
        the deepest terminal branches (parents losing both children
        become terminals), hyperemia dilates every lumen radius by a
        factor, wall thickening shrinks the lumen radius by (1 - s)
        for generations at or past a depth threshold."""
        if vessel_loss_factor > 0:
            n_remove = int(round(vessel_loss_factor * len(self.terminals)))
            for _ in range(n_remove):
                if len(self.terminals) <= 1:
                    break
                gen_of = {e["to"]: e["generation"] for e in self.edges}
                deepest = max(
                    self.terminals, key=lambda n: gen_of.get(n, 0)
                )
                if gen_of.get(deepest, 0) == 0:
                    break
                parent = next(
                    e["from"] for e in self.edges if e["to"] == deepest
                )
                self.edges = [e for e in self.edges if e["to"] != deepest]
                self.nodes.pop(deepest, None)
                self.terminals.remove(deepest)
                if not any(e["from"] == parent for e in self.edges):
                    self.terminals.append(parent)
        if hyperemia_factor != 1.0:
            for e in self.edges:
                e["radius"] *= hyperemia_factor
        if wall_severity > 0:
            for e in self.edges:
                if e["generation"] >= wall_level_threshold:
                    e["radius"] *= (1.0 - wall_severity)
        return self

    def poiseuille_resistance(self, mu: float) -> float:
        """Analytic 2D Poiseuille resistance of the whole tree
        (reference stenosis_with_tree_2d.py:207-223):
        R_tree = (3 mu alpha / 2 r0^2) sum_j 2^{-j/3} with alpha the
        length ratio and symmetric splitting."""
        alpha = self.length_ratio
        r0 = self.r_root
        total = sum(
            2.0 ** (-j / 3.0) for j in range(self.n_generations + 1)
        )
        return 3.0 * mu * alpha / (2.0 * r0 ** 2) * total
