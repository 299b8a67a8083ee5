"""Lid-driven cavity reference data (a copy of cfdtpu/validation/ghia.py).

u-velocity along the vertical centerline (x = 0.5) of the lid-driven
cavity, from Ghia, Ghia & Shin, "High-Re solutions for incompressible flow
using the Navier-Stokes equations and a multigrid method", J. Comput.
Phys. 48 (1982), Table I. The reference framework ships the same published
values as CSVs (the reference's src/benchmark_data/lid_driven2D/).

Keys are Reynolds numbers; each entry is (y, u) pairs from the moving lid
(y = 1) down to the bottom wall (y = 0).
"""

import numpy as np

_Y = np.array([
    1.0000, 0.9766, 0.9688, 0.9609, 0.9531, 0.8516, 0.7344, 0.6172,
    0.5000, 0.4531, 0.2813, 0.1719, 0.1016, 0.0703, 0.0625, 0.0547,
    0.0000,
])

GHIA_U_CENTERLINE = {
    100: (_Y, np.array([
        1.00000, 0.84123, 0.78871, 0.73722, 0.68717, 0.23151, 0.00332,
        -0.13641, -0.20581, -0.21090, -0.15662, -0.10150, -0.06434,
        -0.04775, -0.04192, -0.03717, 0.00000,
    ])),
    400: (_Y, np.array([
        1.00000, 0.75837, 0.68439, 0.61756, 0.55892, 0.29093, 0.16256,
        0.02135, -0.11477, -0.17119, -0.32726, -0.24299, -0.14612,
        -0.10338, -0.09266, -0.08186, 0.00000,
    ])),
    1000: (_Y, np.array([
        1.00000, 0.65928, 0.57492, 0.51117, 0.46604, 0.33304, 0.18719,
        0.05702, -0.06080, -0.10648, -0.27805, -0.38289, -0.29730,
        -0.22220, -0.20196, -0.18109, 0.00000,
    ])),
}
