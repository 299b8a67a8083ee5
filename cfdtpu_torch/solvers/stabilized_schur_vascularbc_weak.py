"""vascularbc without the outlet Nitsche term.

The counterpart of cfdtpu/solvers/stabilized_schur_vascularbc_weak.py:
the curl-curl form, the weak pressure and Nitsche at the inlet, the
weak resistance pressure at the outlet without Nitsche.
"""

from __future__ import annotations

from .stabilized_schur_vascularbc import Solver as VascularBCSolver


class Solver(VascularBCSolver):
    OUTLET_NITSCHE = False
