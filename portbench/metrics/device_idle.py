"""device_idle (``device_idle.fit``, ``device_idle.train``, ...): the share of the traced
window in which no operation ran on the device, busy time being the union of the device
operations' intervals."""


def read(run):
    if run.trace is None or not run.trace.device or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
