"""Where a benchmark cell's device idle time falls among the program's own phases.

    python3 tools/phase_gaps.py --workload CELL --seed N [--out DIR] [--overlay]

Builds the cell as ``portbench/run.py`` does (its driver's set-up, warm-up included), runs
its ``trace_iterations`` under ``torch.profiler`` inside a ``window`` span closed by a
synchronisation, and reduces the events with the benchmark's own reducer. Then it lays the
window's idle gaps (no device operation running) over the phases that ``ht.profiler``
recorded in the same session, on the clock both share (CLOCK_REALTIME), and names each gap
by the innermost phase the host was in at its middle, or by the benchmark's own span where
it was in none. It prints one JSON line: the idle seconds and gaps by phase, the program's
phase totals a iteration (host and device), and the device-side user annotations a
iteration by name (which the benchmark's reducer counts as launches unless they are its own
spans). ``--overlay`` also writes the device trace with the program's slices merged in
(``DIR/<cell>_overlay.json.gz``, for Perfetto).

Needs a CUDA card; run it from the root of a checkout.
"""

from __future__ import annotations

import argparse
import bisect
import gzip
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--out", default="chiprun_out/phase_gaps")
    parser.add_argument("--overlay", action="store_true")
    args = parser.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import profiler
    from portbench.lib import spec, trace

    if not torch.cuda.is_available():
        print("phase_gaps: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ht.use_device("gpu")
    cell = spec.cell(args.workload)
    driver = cell.driver().Driver(cell, args.seed, device)
    torch.cuda.synchronize()
    n = int(cell.traffic["trace_iterations"])
    profiler.disable()
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            for _ in range(n):
                driver.iterate()
            torch.cuda.synchronize()
    events = prof.events()
    spans = set(driver.spans) | {trace.WINDOW}
    reduced = trace.reduce(events, n, spans)
    base_ns = prof.profiler.kineto_results.trace_start_ns()  # the events' time_range origin
    totals = profiler.phases()
    slices = [s for s in profiler.trace_snapshot()["slices"] if s[2] in ("phase", "collective")]

    window = next(e for e in events if e.name == trace.WINDOW and e.device_type == DeviceType.CPU)
    w0, w1 = window.time_range.start, window.time_range.end
    busy = _union([(s, e) for _, s, e in reduced.device])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]

    # the program's slices on the events' axis (µs from base_ns)
    shift_us = (profiler._T0_NS - base_ns) / 1e3
    phases = sorted(((t0 + shift_us, t1 + shift_us, name) for _, _, _, name, t0, t1 in slices))
    starts = [p[0] for p in phases]
    bench_spans = [e for e in events if e.device_type == DeviceType.CPU and e.name in spans]

    def label(t: float) -> str:
        inside = [p for p in phases[: bisect.bisect_right(starts, t)] if p[1] > t]
        if inside:
            return min(inside, key=lambda p: p[1] - p[0])[2]
        outer = [s for s in bench_spans if s.time_range.start <= t < s.time_range.end]
        span = min(outer, key=lambda s: s.time_range.end - s.time_range.start).name if outer else "no span"
        return f"{span} (no phase)"

    gaps = defaultdict(lambda: [0.0, 0])
    sizes = defaultdict(list)
    for start, end in holes:
        key = label(0.5 * (start + end))
        gaps[key][0] += (end - start) / 1e6
        gaps[key][1] += 1
        sizes[key].append(round((end - start) / 1e3, 4))
    annotations = defaultdict(int)
    for e in events:
        if e.device_type == DeviceType.CUDA and getattr(e, "is_user_annotation", False):
            annotations[e.name] += 1
    outside = [p for p in phases if p[0] < w0 or p[1] > w1]
    line = {
        "cell": args.workload,
        "card": torch.cuda.get_device_name(device),
        "torch": torch.__version__,
        "iterations": n,
        "window_s": reduced.window_s,
        "busy_s": reduced.busy_s,
        "idle_pct": 100.0 * (1.0 - reduced.busy_s / reduced.window_s),
        "launches_per_iteration": reduced.launches / n,
        "idle_by_phase_s": {k: {"seconds": v[0], "gaps": v[1], "largest_ms": sorted(sizes[k])[-3:]}
                            for k, v in sorted(gaps.items(), key=lambda kv: -kv[1][0])},
        "phases_per_iteration": {
            name: {"count": t["count"] / n, "host_ms": 1e3 * t["host_s"] / n,
                   "device_ms": None if t["device_s"] is None else 1e3 * t["device_s"] / n}
            for name, t in totals["spans"].items()},
        "counters_per_iteration": {k: v / n for k, v in totals["counters"].items()},
        "device_user_annotations_per_iteration": {k: v / n for k, v in sorted(annotations.items())},
        "phase_slices_outside_window": len(outside),
        "first_phase_after_window_start_ms": (phases[0][0] - w0) / 1e3 if phases else None,
    }
    device_sum = sum(t["device_s"] or 0.0 for name, t in totals["spans"].items() if name.startswith("step."))
    if device_sum:
        line["step_phases_device_s_over_window_s"] = device_sum / reduced.window_s
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    if args.overlay:
        path = out / f"{args.workload}_torch.json"
        prof.export_chrome_trace(str(path))
        torch_trace = json.loads(path.read_text())
        path.unlink()
        mine = profiler.dump_trace(str(out / f"{args.workload}_ht.json"), base_ns=torch_trace["baseTimeNanoseconds"])
        torch_trace["traceEvents"].extend(mine["traceEvents"])
        with gzip.open(out / f"{args.workload}_overlay.json.gz", "wt") as f:
            json.dump(torch_trace, f)
        (out / f"{args.workload}_ht.json").unlink()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
