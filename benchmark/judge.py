"""The comparison that decides `correct`.

The window ends in a state the program produced. The reference (plain
PyTorch and SciPy, benchmark/reference) solves three of the program's
steps again, each from the program's state before it, with exact Newton
to the rounding floor in float64: the first step of the run, from the
benchmark's own start state, which checks the program's start and the
resume path that the window's steps follow from; a window step drawn
from the seed (cell.judged_step); and the window's last step. Compared:

    first_u, first_p   step 1 of the run: the largest gap of velocity
                       and of pressure, over the field's largest value
                       in the reference
    judged_du          the drawn window step: the largest velocity gap
                       over the largest change of velocity that the
                       reference makes in that step, so a step that
                       returns its state unchanged reads 1 however
                       little the flow still changes
    last_u, last_p     the window's last step, as first_u and first_p

A number is within its limit when value <= limit; a missing or NaN
number never is.
"""

from __future__ import annotations

import math
import time

import numpy as np

NAMES = ("first_u", "first_p", "judged_du", "last_u", "last_p")


def gap(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.abs(b).max())
    return float(np.abs(a - b).max()) / scale if scale > 0 else math.inf


def step_gap(a, b, before) -> float:
    """max |a - b| / max |b - before|: the gap over the step's change."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    change = float(np.abs(b - np.asarray(before, np.float64)).max())
    return float(np.abs(a - b).max()) / change if change > 0 else math.inf


def compare(first, judged, last, ref) -> dict:
    """The compared numbers of the program's steps against the
    reference's ref (u1, p1, uJ, pJ, uN, pN); first (u1, p1), judged and
    last (u_prev, p_prev, u, p)."""
    u1, p1, uJ, _, uN, pN = ref
    return {"first_u": gap(first[0], u1), "first_p": gap(first[1], p1),
            "judged_du": step_gap(judged[2], uJ, judged[0]),
            "last_u": gap(last[2], uN), "last_p": gap(last[3], pN)}


def readings(problem, start, first, judged, last) -> tuple[dict, dict]:
    """The compared numbers and what the reference did (iterations,
    seconds). start (u0, p0); first (u1, p1) the program's step 1;
    judged and last (u_prev, p_prev, u, p) the program's drawn and last
    window steps."""
    t0 = time.perf_counter()
    u1, p1, it1 = problem.step(*start)
    uJ, pJ, itJ = problem.step(judged[0], judged[1])
    uN, pN, itN = problem.step(last[0], last[1])
    ref = (u1, p1, uJ, pJ, uN, pN)
    info = {"newton_first": it1, "newton_judged": itJ, "newton_last": itN,
            "reference_s": time.perf_counter() - t0,
            "reference_parts_s": dict(problem.seconds), "ref": ref}
    return compare(first, judged, last, ref), info


def _finite(x):
    return float(x) if x is not None and math.isfinite(x) else None


def checks(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every compared number; None where a
    number is missing or not finite."""
    return {k: {"value": _finite(values.get(k)),
                "limit": _finite(limits.get(k))} for k in NAMES}


def passed(chk: dict) -> bool:
    return all(c["value"] is not None and c["limit"] is not None
               and c["value"] <= c["limit"] for c in chk.values())
