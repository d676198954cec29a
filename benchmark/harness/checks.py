"""Comparisons that decide ``correct``, and the limits they are held to.

A cell's limits live in ``limits/<cell>.json`` as ``{name: limit}``; a
reading passes when it is at most its limit. ``compare`` returns the
readings beside their limits in the order the limits file gives them.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np


def compare(readings: Dict[str, float], limits: Dict[str, float]):
    """-> (correct, {name: {"value", "limit"}}): every limited reading is
    present, finite and at most its limit."""
    table = {}
    correct = True
    for name, limit in limits.items():
        value = readings.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        table[name] = {"value": value, "limit": limit}
    return correct, table


def compare_control(readings: Dict[str, float], limits: Dict[str, float]):
    """The control's readings through ``compare``, over the limited numbers
    the control reads (the reference in the program's place leaves the
    unmasked cells and the feed as they are, so it reads no number of
    theirs); -> (correct, table). A control that reads none of the limited
    numbers has failed."""
    if not readings:
        return False, {}
    mine = {name: limit for name, limit in limits.items() if name in readings}
    if not mine:
        return False, {}
    return compare(readings, mine)


def norm_gap(program: Dict[str, float], reference: Dict[str, float],
             keep=None):
    """(gap, leaf): the worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    the median leaf's (``keep``: the leaves that count)."""
    names = [n for n in reference if keep is None or n in keep]
    median = float(np.median([reference[n] for n in reference]))
    worst, leaf = 0.0, None
    for n in names:
        gap = abs(program[n] - reference[n]) / max(reference[n], median,
                                                   1e-30)
        if gap >= worst:
            worst, leaf = gap, n
    return worst, leaf
