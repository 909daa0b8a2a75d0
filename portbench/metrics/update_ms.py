"""update_ms (``update_ms.train``): device milliseconds a training step spends in the
program's ``step.update`` phase (the gradients set and the local optimizer's step), timed by
the program's CUDA events at the phase's edges on the step's stream; over the traced
steps."""

from portbench.lib import phases


def read(run):
    return phases.per_iteration(run, "step.update", "device_s", 1e3)
