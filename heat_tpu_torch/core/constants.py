"""Mathematical constants (counterpart of heat_tpu/core/constants.py)."""

import math

__all__ = ["e", "Euler", "inf", "Inf", "Infty", "Infinity", "nan", "NaN", "pi"]

e = math.e
"""Euler's number"""
Euler = e
inf = math.inf
"""IEEE 754 floating point representation of (positive) infinity"""
Inf = inf
Infty = inf
Infinity = inf
nan = math.nan
"""IEEE 754 floating point representation of Not a Number"""
NaN = nan
pi = math.pi
"""Archimedes' constant"""
