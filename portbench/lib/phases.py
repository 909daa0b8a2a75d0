"""The program's own phases and counters in a traced run: what the port's timeline plane
(``ht.profiler``, the module ``heat_tpu_torch.core.profiler``) recorded while the window's
``torch.profiler`` session ran, as its ``phases()`` returns them: for each phase its count,
host seconds and device seconds, and the counters.

The readers import nothing of the program; they read the module the run loaded. A run
without a trace, a trace with no device operation in it (no card), or a program whose
profiler keeps no phases reads as nothing recorded.
"""

import sys

PROFILER = "heat_tpu_torch.core.profiler"


def recorded(run):
    """The program's ``phases()`` after a traced run on the card, or None."""
    if run.trace is None or not run.trace.iterations or not run.trace.device:
        return None
    read = getattr(sys.modules.get(PROFILER), "phases", None)
    return read() if callable(read) else None


def span(run, name: str):
    """The totals of the phase ``name`` (``count``, ``host_s``, ``device_s``), or None where
    it was not recorded."""
    totals = (recorded(run) or {}).get("spans", {}).get(name)
    return totals if totals and totals["count"] else None


def per_iteration(run, name: str, key: str, scale: float):
    """``scale`` times the phase ``name``'s ``key`` (``host_s`` or ``device_s``) over the
    traced iterations, or None where it was not recorded."""
    totals = span(run, name)
    if totals is None or totals[key] is None:
        return None
    return scale * totals[key] / run.trace.iterations


def counter(run, name: str):
    """The counter ``name`` over the traced iterations, or None where it was not recorded."""
    value = (recorded(run) or {}).get("counters", {}).get(name)
    return None if value is None else value / run.trace.iterations
