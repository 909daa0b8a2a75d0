"""fit_s: time to solution, the whole window's seconds over the fits completed in it."""


def read(run):
    if run.trace is not None or not run.iterations:
        return None
    return run.window_s / run.iterations
