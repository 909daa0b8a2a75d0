"""The numbers that decide ``correct``: each is a reading of how far the program's output
lies from the plain reference's, held to a limit of its own (``limits/<cell>.json``)."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional


def relative_gap(got: float, ref: float) -> float:
    """|got - ref| / |ref|."""
    return abs(got - ref) / abs(ref)


def worst_leaf(got: Dict[str, float], ref: Dict[str, float], leaves: Optional[Iterable[str]] = None) -> float:
    """The largest gap between the program's norm of a leaf and the reference's, each
    measured against the reference's norm of that leaf or of the median leaf, whichever is
    larger (so that a leaf whose norm is all but zero does not read as a large share)."""
    names = list(ref if leaves is None else leaves)
    if set(got) != set(ref):
        raise ValueError(f"the program and the reference hold other leaves: {sorted(set(got) ^ set(ref))[:5]}")
    median = statistics.median(ref.values())
    return max(abs(got[n] - ref[n]) / max(ref[n], median) for n in names)


def held(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit; a number passes when it is at most its limit
    (a NaN never does)."""
    if set(numbers) != set(limits):
        raise ValueError(f"compared numbers {sorted(numbers)} and limits {sorted(limits)} differ")
    return {name: {"value": numbers[name], "limit": limits[name], "ok": bool(numbers[name] <= limits[name])}
            for name in sorted(numbers)}
