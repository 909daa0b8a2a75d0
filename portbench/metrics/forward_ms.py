"""forward_ms (``forward_ms.train``): device milliseconds a training step spends in the
program's ``step.forward`` phase (the loss function: the model's forward and the loss),
timed by the program's CUDA events at the phase's edges on the step's stream; over the
traced steps."""

from portbench.lib import phases


def read(run):
    return phases.per_iteration(run, "step.forward", "device_s", 1e3)
