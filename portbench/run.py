"""Run one cell of BENCHMARK.json once on the card and print one JSON line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds heat_tpu_torch. The cell's set-up (imports, kernel
load or build, inputs and weights made on the card from the seed, warm-up) counts from the
first statement of this file to the first timed call (``setup_s``). ``--trace 0`` measures
the window of ``--seconds`` and reports the cell's end-to-end metrics; ``--trace 1`` runs a
fixed number of the cell's iterations under ``torch.profiler`` and reports its per-layer
metrics, the device's busy and window seconds and a breakdown. Either way the run then
compares what the timed path produced with the plain reference and prints each compared
number beside its limit, last on standard error and last in the line (``compared``).

Exit codes: 0 with a result line; 2 without CUDA or with fewer cards than the cell asks
for; 1 where heat_tpu_torch cannot be imported, or where JAX, its libraries or the JAX
package were loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# every build and kernel cache at a fixed place inside the checkout, so that only a
# checkout's first run builds
_CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "nv")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench.lib import harness, spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import heat_tpu_torch as ht
    except ImportError as exc:
        print(f"portbench: heat_tpu_torch is not in this checkout ({exc})", file=sys.stderr)
        return 1
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ht.use_device("gpu")
    line = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 1
    for name, c in line["compared"].items():
        ok = isinstance(c["value"], float) and c["value"] <= c["limit"]
        print(f"compared {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
