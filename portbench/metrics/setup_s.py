"""setup_s: seconds from the process's first statement to the first timed call (imports,
the kernels loaded or built, inputs and weights made on the card, warm-up)."""


def read(run):
    return run.setup_s
