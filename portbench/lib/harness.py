"""One run of one cell: set-up, the measured (or the traced) window, the comparison with the
plain reference, the metrics, and the result line.

A driver (``drivers/<name>.py``) holds a class ``Driver(cell, seed, device)`` whose
construction is the cell's whole set-up (inputs, the program's objects, warm-up of every
shape the window uses), and which offers:

- ``iterate()``: one unit of the traffic (a fit, a training step), through the program's
  entry point;
- ``spans``: the names of the benchmark's own spans around the calls into the program;
- ``work()``: what the readers need besides the clock (tokens, FLOPs and bytes of an
  iteration);
- ``check(limits)``: after the window, frees the program's state, runs the plain reference
  and returns the compared numbers and how many checked outputs failed them.
"""

from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from . import compare, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "heat_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, compared whole) is JAX's,
    its libraries' or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Run:
    """What the metric readers read."""

    config: dict
    traffic: dict
    setup_s: float
    work: dict
    window_s: float = 0.0
    iterations: int = 0
    walls: List[float] = field(default_factory=list)
    trace: Optional[trace.Trace] = None


def _sync(device) -> Callable[[], None]:
    import torch

    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


def timed_window(driver, seconds: float, sync: Callable[[], None], each: bool) -> tuple:
    """Iterations back to back (a closed loop: the next starts when the last returns) until
    ``seconds`` have passed at the end of one; the window closes when the device has
    finished all of them. Returns (window seconds, iterations, wall of each iteration);
    a wall is an iteration's whole time only where ``each`` synchronises after every one."""
    walls = []
    sync()
    t0 = time.perf_counter()
    now = t0
    while now - t0 < seconds:
        t = now
        driver.iterate()
        if each:
            sync()
        now = time.perf_counter()
        walls.append(now - t)
    sync()
    return time.perf_counter() - t0, len(walls), walls


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t_start: float, log=sys.stderr) -> dict:
    """The result line of one run (a dict, ``compared`` last)."""
    import torch

    driver = cell.driver().Driver(cell, seed, device)
    sync = _sync(device)
    sync()
    record = Run(cell.config, cell.traffic, time.time() - t_start, driver.work())
    print(f"set-up {record.setup_s:.3f} s: {json.dumps(getattr(driver, 'phases', {}))}", file=log, flush=True)
    if traced:
        n = int(cell.traffic["trace_iterations"])

        def loop() -> int:
            for _ in range(n):
                driver.iterate()
            return n

        record.trace = trace.record(loop, driver.spans, sync)
        record.iterations = n
    else:
        record.window_s, record.iterations, record.walls = timed_window(
            driver, seconds, sync, bool(cell.traffic.get("sync_each", False)))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    numbers, failed = driver.check(cell.limits)
    compared = compare.held(numbers, cell.limits)
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = spec.reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    line = {
        "correct": all(c["ok"] for c in compared.values()),
        "attempted": record.iterations,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if record.trace is not None:
        dev["busy_s"] = record.trace.busy_s
        dev["window_s"] = record.trace.window_s
        line["breakdown"] = record.trace.breakdown()
    else:
        line["window_s"] = record.window_s
    line["setup_phases"] = getattr(driver, "phases", {})
    # a number that is not finite is written as a string: JSON has no NaN
    line["compared"] = {name: {"value": c["value"] if math.isfinite(c["value"]) else str(c["value"]),
                               "limit": c["limit"]} for name, c in compared.items()}
    return line
