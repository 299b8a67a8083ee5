"""Stenosis driven by weak pressure inlet + resistance outlet + backflow.

The counterpart of cfdtpu/scenarios/stenosis_pressure.py
(a rebuild of the reference's src/scenarios/stenosis_pressure.py): the
stenosis geometry (defaults severity 0.567, slope 0.4) solved with
stabilized_schur_pressure_backflow-style physics — weak pressure inlet
(mmHg -> cgs-mm), Nitsche tangential, resistance outlet p = R|Q| with
damping and backflow stabilization (:41-123). Requires R_resistance.
FFR written as in the base stenosis scenario (:131-147).
"""

from __future__ import annotations

from .stenosis import StenosisSimulation


class StenosisPressureSimulation(StenosisSimulation):
    def __init__(
        self,
        solver_name,
        dt,
        T,
        f=(0, 0),
        p_inlet: float = 75.0,
        *,
        R_resistance: float,
        beta_backflow: float = 0.2,
        alpha_damping: float = 0.75,
        severity: float = 0.567,
        slope: float = 0.4,
        **kwargs,
    ):
        kwargs.setdefault("severity", severity)
        kwargs.setdefault("slope", slope)
        super().__init__(
            solver_name, dt, T, f,
            p_inlet=p_inlet,
            R_resistance=R_resistance,
            beta_backflow=beta_backflow,
            alpha_damping=alpha_damping,
            **kwargs,
        )
