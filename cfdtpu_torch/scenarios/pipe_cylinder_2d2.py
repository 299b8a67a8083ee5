"""CLI-name module for the unsteady DFG 2D-2 benchmark.

`python -m cfdtpu_torch simulate --simulation pipe_cylinder_2d2 ...`:
the vortex-shedding Re = 100 configuration (u_max = 1.5) with the
per-step bdforces.txt series, as cfdtpu/scenarios/pipe_cylinder_2d2.py;
see scenarios/pipe_cylinder.py for the physics and
scripts/validate_dfg2d2.py for the comparison with the FEATFLOW series.
The steady `pipe_cylinder` module keeps resolving to the 2D-1-style
scenario.
"""

from __future__ import annotations

from .pipe_cylinder import PipeCylinder2D2Simulation


class PipeCylinder2D2(PipeCylinder2D2Simulation):
    pass
