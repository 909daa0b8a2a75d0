"""launches (``launches.fit``, ``launches.train``, ...): kernels launched on the device an
iteration of the traced run (a fit, a training step; copies and fills left out)."""


def read(run):
    if run.trace is None or not run.trace.iterations or not run.trace.device:
        return None
    return run.trace.launches / run.trace.iterations
