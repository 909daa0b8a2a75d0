"""fit_p95_s: the 95th percentile (nearest rank) of the wall time of every fit in the window,
each from its call to its return, which waits for its results on the card."""

import math


def read(run):
    if run.trace is not None or not run.walls:
        return None
    walls = sorted(run.walls)
    return walls[math.ceil(0.95 * len(walls)) - 1]
