"""host_reads (``host_reads.fit``): the program's ``lloyd.host_reads`` counter a fit, the
reads of the device that the Lloyd loop makes (each check of its condition and the two
results), over the traced fits."""

from portbench.lib import phases


def read(run):
    return phases.counter(run, "lloyd.host_reads")
