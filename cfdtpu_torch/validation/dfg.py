"""DFG flow-around-cylinder benchmark reference values.

The counterpart of cfdtpu/validation/dfg.py, pure numpy.

The published DFG 2D-1 (steady, Re = 20) reference intervals from
Schaefer & Turek, "Benchmark computations of laminar flow around a
cylinder" (1996) — the quantities the reference validates against
(BASELINE.md: c_D, c_L, dp inside the published intervals):

    c_D in [5.5700, 5.5900]
    c_L in [0.0104, 0.0110]
    dp  in [0.1172, 0.1176]   (p(0.15, 0.2) - p(0.25, 0.2))

The reference repo also ships the FEATFLOW DFG 2D-3 (unsteady) reference
time series (bdforces_q2_lv{2-6}_dt{1-4} / pointvalues_*); those files use
whitespace-separated columns `timestep time bdc horiz vert` — the loader
below reads that format when such files are provided.
"""

from __future__ import annotations

import numpy as np

DFG_2D1_INTERVALS = {
    "cd": (5.5700, 5.5900),
    "cl": (0.0104, 0.0110),
    "dp": (0.1172, 0.1176),
}


def check_dfg_2d1(cd: float, cl: float, dp: float) -> dict:
    """Classify computed functionals against the published intervals;
    returns per-quantity (value, lo, hi, inside, rel_err_to_center)."""
    out = {}
    for name, val in (("cd", cd), ("cl", cl), ("dp", dp)):
        lo, hi = DFG_2D1_INTERVALS[name]
        mid = 0.5 * (lo + hi)
        out[name] = {
            "value": val,
            "interval": (lo, hi),
            "inside": lo <= val <= hi,
            "rel_err": abs(val - mid) / abs(mid),
        }
    return out


def load_featflow_series(path: str) -> np.ndarray:
    """Read a FEATFLOW bdforces/pointvalues reference file: skips '#'/non-
    numeric headers, returns the numeric columns (n, k)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            try:
                rows.append([float(x) for x in parts])
            except ValueError:
                continue
    return np.asarray(rows)


# ---------------------------------------------------------------------------
# Shipped FEATFLOW reference data (DFG 2D-2: unsteady periodic, Re = 100)
# ---------------------------------------------------------------------------
# The reference repo consumes these as oracles
# (the reference's src/benchmark_data/pipe_cylinder/bdforces_q2_lv3_dt3:1-8);
# a subset (the bdforces series of levels 2-4 at dt index 3) ships in
# cfdtpu_torch/validation/data/pipe_cylinder, the port's own copy of
# cfdtpu's files (no reader here uses the point values). Columns:
# timestep time bdc cD cL; the series covers t in [0, 10] in the fully
# developed periodic regime.
# Published 2D-2 intervals (Schaefer & Turek 1996): c_Dmax in
# [3.22, 3.24], c_Lmax in [0.99, 1.01], Strouhal in [0.295, 0.305].

DFG_2D2_INTERVALS = {
    "cd_max": (3.2200, 3.2400),
    "cl_max": (0.9900, 1.0100),
    "strouhal": (0.2950, 0.3050),
}


def featflow_data_path(name: str) -> str:
    """Absolute path of a shipped FEATFLOW file (e.g.
    'bdforces_q2_lv3_dt3')."""
    import os

    return os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "data", "pipe_cylinder", name,
    )


def dfg_2d2_series_stats(
    t: np.ndarray, cd: np.ndarray, cl: np.ndarray,
    n_periods: int | None = None,
) -> dict:
    """Summary statistics of a DFG 2D-2 force series: cd/cl extrema and
    the lift-based Strouhal number St = f L / U_mean (L = 0.1,
    U_mean = 1.0 for 2D-2). The shedding period comes from rising lift
    zero crossings; with n_periods given, extrema and St are evaluated
    over only the LAST n shedding periods — a developed-regime window
    that excludes the impulsive-start transient our runs (and the
    FEATFLOW series' first cycles) contain."""
    t = np.asarray(t, float)
    cd = np.asarray(cd, float)
    cl = np.asarray(cl, float)
    s = np.where((cl[:-1] < 0) & (cl[1:] >= 0))[0]
    st = np.nan
    if n_periods is not None and len(s) >= n_periods + 1:
        i0 = s[-(n_periods + 1)]
        t, cd, cl = t[i0:], cd[i0:], cl[i0:]
        s = s[-(n_periods + 1):] - i0
    if len(s) >= 2:
        period = (t[s[-1]] - t[s[0]]) / (len(s) - 1)
        st = 0.1 * 1.0 / period  # f * L / U_mean
    return {
        "cd_min": float(cd.min()), "cd_max": float(cd.max()),
        "cd_mean": float(cd.mean()),
        "cl_min": float(cl.min()), "cl_max": float(cl.max()),
        "strouhal": float(st), "t_range": (float(t[0]), float(t[-1])),
        "n_crossings": int(len(s)),
    }


def check_dfg_2d2(stats: dict) -> dict:
    """Classify a 2D-2 series-stats dict against the published
    intervals (same shape as check_dfg_2d1's output)."""
    out = {}
    for name in ("cd_max", "cl_max", "strouhal"):
        lo, hi = DFG_2D2_INTERVALS[name]
        mid = 0.5 * (lo + hi)
        val = stats[name]
        out[name] = {
            "value": val,
            "interval": (lo, hi),
            "inside": lo <= val <= hi,
            "rel_err": abs(val - mid) / abs(mid),
        }
    return out


def featflow_reference_stats(
    level: int = 3, dt_idx: int = 3, n_periods: int | None = None,
) -> dict:
    """Series stats of a shipped FEATFLOW bdforces file (columns:
    timestep time bdc cD cL)."""
    d = load_featflow_series(
        featflow_data_path(f"bdforces_q2_lv{level}_dt{dt_idx}")
    )
    return dfg_2d2_series_stats(
        d[:, 1], d[:, 3], d[:, 4], n_periods=n_periods
    )
