#!/usr/bin/env python3
"""Trace one ``hsvd_rank`` of north-star config #4 on the card with torch.profiler.

    python3 tools/hsvd_trace.py [--json-out FILE]

Config #4 as chip_smoke.py runs it (bench.py:170-185): A = U·V, U 2048 × 10 and V
10 × 32768 f32 from a seeded generator, split=1, ``hsvd_rank(A, 10)``. After one warm-up
call it traces one call and prints, as one JSON line, the device time by kind of kernel
(chip_smoke.py's ``profile_device``: cuSOLVER's SVD kernels, cuBLAS's GEMMs, the rest),
the card's busy time and idle share in the traced wall time, the host-to-device copies
in the trace, and the seconds the profiler took to hand back its events. Run it in a
process of its own: cuSOLVER's ``gesvd`` steers its QR iteration from the host with tens
of thousands of launches and copies a call, and after a profiler session chip_smoke.py's
linear algebra phases took hundreds of seconds (PERF.md §5).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import heat_tpu_torch as ht  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json-out", default=None, help="also write the result here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("hsvd_trace: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ht.use_device("gpu")
    m, n, rank = chip_smoke.HSVD_M, chip_smoke.HSVD_N, chip_smoke.HSVD_RANK
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 2000)
    A = ht.array(torch.randn(m, rank, generator=gen, device=dev) @ torch.randn(rank, n, generator=gen, device=dev), split=1)
    ht.linalg.hsvd_rank(A, rank)  # warm-up
    t0 = time.perf_counter()
    prof = chip_smoke.profile_device(lambda: ht.linalg.hsvd_rank(A, rank), inference=False)
    prof["profiler_s"] = time.perf_counter() - t0
    prof["shape"] = [m, n, rank]
    print(json.dumps(prof), flush=True)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as fh:
            json.dump({"nvidia_smi": smi, **prof}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
