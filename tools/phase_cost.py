"""What the program's phase hooks cost while a device trace is taken, and off.

    python3 tools/phase_cost.py --workload CELL --seed N [--turns 8]

Builds the cell as ``portbench/run.py`` does, then runs its traced window (the benchmark's
own ``lib.trace.record``: ``trace_iterations`` under ``torch.profiler``) in turns with the
program's phase hooks live and with them stubbed out (``ht.profiler.phase``, ``part`` and
``count`` replaced by no-ops), ``--turns`` pairs in one process on one card, so that the
host's speed drifts alike on both sides. Prints one JSON line: each window's idle share,
seconds a iteration, launches a iteration, largest idle gaps by what the host was doing and
(hooks live) host ms of each phase a iteration; the medians of each side and the mean of the
pairs' differences; and, first, the host nanoseconds of one ``with phase(...)`` hook off,
on, and on with a CUDA device (two events recorded), and of a phase in two parts (as a
Lloyd pass) off and on, timed before any trace is taken.

Needs a CUDA card; run it from the root of a checkout.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def hook_ns(profiler, device, n: int = 100_000) -> dict:
    """Host nanoseconds of one ``with profiler.phase(...)`` hook: off, on, and on with a
    CUDA device; and of a phase in two parts, off and on."""
    import torch

    def one(dev):
        with profiler.phase("hook.cost", dev):
            pass

    def parted(dev):
        with profiler.phase("hook.cost", dev, parts=True):
            profiler.part("hook.first")
            profiler.part("hook.second")

    out = {}
    for label, on, dev, hook in (("off", False, None, one), ("on", True, None, one),
                                 ("on_device", True, device, one), ("pass_off", False, None, parted),
                                 ("pass_on", True, None, parted)):
        (profiler.enable if on else profiler.disable)()
        reps = n if not on else n // 100  # few records: no full collection of the many they leave
        t0 = time.perf_counter()
        for _ in range(reps):
            hook(dev)
        out[label] = (time.perf_counter() - t0) / reps * 1e9
        torch.cuda.synchronize()
        profiler.reset()
    profiler.disable()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--turns", type=int, default=8)
    args = parser.parse_args(argv)

    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import profiler
    from portbench.lib import spec, trace

    if not torch.cuda.is_available():
        print("phase_cost: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ht.use_device("gpu")
    line = {"cell": args.workload, "card": torch.cuda.get_device_name(device), "hook_ns": hook_ns(profiler, device)}
    cell = spec.cell(args.workload)
    driver = cell.driver().Driver(cell, args.seed, device)
    n = int(cell.traffic["trace_iterations"])
    live = (profiler.phase, profiler.part, profiler.count)
    stubs = (lambda name, device=None, parts=False: profiler._OFF, lambda name: None, lambda name, n=1: None)

    def loop() -> int:
        for _ in range(n):
            driver.iterate()
        return n

    runs = []
    for turn in range(args.turns):
        for hooks in ((True, False) if turn % 2 else (False, True)):
            profiler.phase, profiler.part, profiler.count = live if hooks else stubs
            profiler.reset()
            t = trace.record(loop, driver.spans, torch.cuda.synchronize)
            runs.append({"hooks": hooks, "idle_pct": 100.0 * (1.0 - t.busy_s / t.window_s),
                         "window_s_per_iteration": t.window_s / n, "launches_per_iteration": t.launches / n,
                         "idle_gaps": t.breakdown(top=4)["idle_gaps"],
                         "phase_host_ms_per_iteration": {k: 1e3 * v["host_s"] / n
                                                         for k, v in profiler.phases()["spans"].items()}})
    profiler.phase, profiler.part, profiler.count = live
    line["runs"] = runs
    for key in ("idle_pct", "window_s_per_iteration", "launches_per_iteration"):
        on = [r[key] for r in runs if r["hooks"]]
        off = [r[key] for r in runs if not r["hooks"]]
        line[key] = {"median_on": statistics.median(on), "median_off": statistics.median(off),
                     "mean_pair_difference": statistics.fmean(a - b for a, b in zip(on, off))}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
