"""cfdtpu_torch.validation against cfdtpu.validation: the Ghia table,
the port's own copies of the FEATFLOW DFG 2D-2 force series (byte for
byte), and the series statistics and interval checks, equal to
cfdtpu's at levels 2-4 and at the anchors of tests/test_dfg.py.

Comparisons are exact: the modules are the same numpy code on the same
inputs.
"""

import filecmp
import os

import numpy as np
import pytest

from cfdtpu.validation import dfg as jax_dfg
from cfdtpu.validation import ghia as jax_ghia

from cfdtpu_torch.validation import dfg, ghia

LEVELS = (2, 3, 4)


def test_ghia_table_equal():
    a, b = jax_ghia.GHIA_U_CENTERLINE, ghia.GHIA_U_CENTERLINE
    assert sorted(a) == sorted(b) == [100, 400, 1000]
    for re in a:
        for x, y in zip(a[re], b[re]):
            assert x.dtype == y.dtype and np.array_equal(x, y), re


@pytest.mark.parametrize("level", LEVELS)
def test_featflow_file_is_the_ports_own_copy(level):
    name = f"bdforces_q2_lv{level}_dt3"
    mine, theirs = dfg.featflow_data_path(name), \
        jax_dfg.featflow_data_path(name)
    assert os.path.dirname(mine) != os.path.dirname(theirs)
    assert os.sep + "cfdtpu_torch" + os.sep in mine
    assert filecmp.cmp(mine, theirs, shallow=False)


def test_no_point_value_files_shipped():
    data = os.path.dirname(dfg.featflow_data_path("x"))
    assert sorted(os.listdir(data)) == [
        f"bdforces_q2_lv{lv}_dt3" for lv in LEVELS]


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("n_periods", [None, 3, 5])
def test_featflow_stats_equal(level, n_periods):
    a = jax_dfg.featflow_reference_stats(level=level, n_periods=n_periods)
    b = dfg.featflow_reference_stats(level=level, n_periods=n_periods)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])), k
    assert jax_dfg.check_dfg_2d2(a) == dfg.check_dfg_2d2(b)


def test_series_stats_equal_on_a_synthetic_series():
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 4.0, 1601)
    cl = np.sin(2 * np.pi * 3.0 * t) + 1e-3 * rng.standard_normal(t.size)
    cd = 3.2 + 0.02 * np.cos(2 * np.pi * 0.6 * t)
    for n in (None, 2):
        assert jax_dfg.dfg_2d2_series_stats(t, cd, cl, n) == \
            dfg.dfg_2d2_series_stats(t, cd, cl, n)


def test_dfg_2d1_check_equal():
    for vals in ((5.58, 0.0107, 0.1174), (5.5, 0.02, 0.1)):
        assert jax_dfg.check_dfg_2d1(*vals) == dfg.check_dfg_2d1(*vals)
    assert jax_dfg.DFG_2D1_INTERVALS == dfg.DFG_2D1_INTERVALS
    assert jax_dfg.DFG_2D2_INTERVALS == dfg.DFG_2D2_INTERVALS


def test_featflow_anchors():
    """tests/test_dfg.py's anchors, on the port's copies: the last five
    shedding periods of each level, St inside the published band from
    level 3 up, the lv3 values, and convergence with the level."""
    stats = {lv: dfg.featflow_reference_stats(level=lv, n_periods=5)
             for lv in LEVELS}
    for lv in LEVELS:
        assert stats[lv]["t_range"][0] > 5.0
        assert stats[lv]["n_crossings"] == 6
    assert abs(stats[3]["strouhal"] - 0.3021) < 5e-4
    assert abs(stats[3]["cd_max"] - 3.1625) < 2e-3
    assert abs(stats[3]["cl_max"] - 0.9795) < 2e-3
    for lv in (3, 4):
        assert dfg.check_dfg_2d2(stats[lv])["strouhal"]["inside"]
    assert stats[2]["cd_max"] < stats[3]["cd_max"] < stats[4]["cd_max"]
    assert stats[2]["cl_max"] < stats[3]["cl_max"] < stats[4]["cl_max"]
    lo, _ = dfg.DFG_2D2_INTERVALS["cd_max"]
    assert stats[4]["cd_max"] < lo + 0.03


def test_load_featflow_series_equal():
    name = "bdforces_q2_lv2_dt3"
    a = jax_dfg.load_featflow_series(jax_dfg.featflow_data_path(name))
    b = dfg.load_featflow_series(dfg.featflow_data_path(name))
    assert a.shape == b.shape and a.shape[1] == 5
    assert np.array_equal(a, b)
