from .ghia import GHIA_U_CENTERLINE
from .dfg import DFG_2D1_INTERVALS, check_dfg_2d1, load_featflow_series

__all__ = ["GHIA_U_CENTERLINE", "DFG_2D1_INTERVALS", "check_dfg_2d1",
           "load_featflow_series"]
