"""entry_ms (``entry_ms.fit``): host milliseconds a fit spends in the program's ``fit.entry``
phase, from ``fit``'s entry to its first Lloyd pass (resplit, initial centers, casts, the
row layout, the kernel's choice), time in which the device has nothing of the fit queued;
over the traced fits."""

from portbench.lib import phases


def read(run):
    return phases.per_iteration(run, "fit.entry", "host_s", 1e3)
