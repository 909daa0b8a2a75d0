"""lloyd_roofline: the least time of a fit's work (``lib.work.lloyd_fit_bytes``: x read once
a pass and the labels written once, at the card's HBM bandwidth) over the device time of a
traced fit (every operation of it, as the union of their intervals). It reads the same work
whatever kernels implement the pass."""

from portbench.lib import work


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    least = work.lloyd_fit_bytes(run.config, run.work["n_iter"]) / work.HBM_BYTES_PER_S
    return 100.0 * least * run.trace.iterations / run.trace.busy_s
