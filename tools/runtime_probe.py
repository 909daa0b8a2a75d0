#!/usr/bin/env python3
"""Run chip_smoke.py's request-dispatch runtime phases alone on the card.

    python3 tools/runtime_probe.py [--json-out FILE] [--skip-serving]

Builds K1, fits chip_smoke's main-path KMeans model (10,000,000 x 64 f32, k = 8, from
its seed) for the ``kmeans_assign`` requests, then runs ``chip_smoke.runtime_phases``:
``[runtime_chain]``, ``[runtime_serving]`` and ``[runtime_lifecycle]``, each line beside
the card's nvidia-smi name and power limit. The quick way to iterate on the executor,
the scheduler and the profiler on the card without the rest of chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core import kernels  # noqa: E402
from heat_tpu_torch.core.kernels import _nvcc  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json-out", default=None)
    parser.add_argument("--skip-serving", action="store_true", help="run [runtime_chain] and [runtime_lifecycle] only")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("runtime_probe: needs a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ht.use_device("gpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    b = _nvcc.build(kernels.kmeans.SOURCE)
    chip_smoke.phase("build", source=kernels.kmeans.SOURCE.name, nvcc_s=f"{b['seconds']:.2f}")
    out = {"nvidia_smi": smi}
    if args.skip_serving:
        out["chain"] = chip_smoke.runtime_chain_phase(ht, dev, smi)
        out["lifecycle"] = chip_smoke.runtime_lifecycle_phase(ht, dev, smi)
    else:
        x, init, _ = chip_smoke.blobs(chip_smoke.N, chip_smoke.D, chip_smoke.K, chip_smoke.SEED, dev)
        km = ht.cluster.KMeans(n_clusters=chip_smoke.K, init=ht.array(init), max_iter=chip_smoke.MAX_ITER, tol=-1.0)
        km.fit(ht.array(x, split=0))
        del x, init
        torch.cuda.empty_cache()
        chip_smoke.phase("kmeans_fit", n=chip_smoke.N, d=chip_smoke.D, k=chip_smoke.K, n_iter=km.n_iter_)
        out.update(chip_smoke.runtime_phases(ht, dev, smi, km))
    chip_smoke.phase("runtime_probe", total_s=f"{time.perf_counter() - t0:.2f}")
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(out, indent=1, default=str))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
