"""Read the two ends of a cell's limits at the cell's own size, on each of several seeds, in
one process: the upper ends, the compared numbers of the control (the plain reference in the
precision below the one the configuration states) and of each planted fault against the
reference; with ``--program``, the lower ends, the compared numbers of the program itself
(the cell's set-up, two iterations of its timed path, and its check, as a run makes them).

    python3 portbench/calibrate.py --workload NAME --seeds N [N ...] [--program] [--out FILE]

Each seed's readings are printed as one JSON line (and written to FILE as a list). The
benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PROGRAM_ITERATIONS = 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--program", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from portbench.lib import spec

    cell = spec.cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 2
    if args.program:
        import heat_tpu_torch as ht

        torch.set_num_threads(2)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        ht.use_device("gpu" if device.type == "cuda" else "cpu")
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.program:
            driver = cell.driver().Driver(cell, seed, device)
            for _ in range(PROGRAM_ITERATIONS):
                driver.iterate()
            numbers, failed = driver.check(cell.limits)
            del driver
            row = {"workload": cell.name, "seed": seed, "program": numbers, "failed": failed}
        else:
            row = {"workload": cell.name, "seed": seed, **cell.driver().calibrate(cell, seed, device)}
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
