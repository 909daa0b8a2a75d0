"""pass_issue_us (``pass_issue_us.fit``): the mean host microseconds of one of the program's
``lloyd.pass`` phases, the time the host takes to issue a Lloyd pass (the assignment kernel,
the update, the loop's where and shift), against the pass's ~0.8 ms on the device: the
traced fits' ``lloyd.pass`` seconds a fit over its passes a fit."""

from portbench.lib import phases


def read(run):
    seconds = phases.per_iteration(run, "lloyd.pass", "host_s", 1e6)
    passes = phases.per_iteration(run, "lloyd.pass", "count", 1.0)
    return None if seconds is None else seconds / passes
