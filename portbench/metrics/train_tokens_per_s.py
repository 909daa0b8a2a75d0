"""train_tokens_per_s: source plus target tokens of every step completed in the window, over
the window's seconds."""


def read(run):
    if run.trace is not None or not run.iterations:
        return None
    return run.work["tokens"] * run.iterations / run.window_s
