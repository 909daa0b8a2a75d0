#!/usr/bin/env python3
"""Run chip_smoke.py's dtype phases alone on the card.

    python3 tools/dtype_probe.py [--json-out FILE] [--only int_matmul dtype_sweep array_gaps]

Builds the integer products' kernels (``csrc/int_gemm.cu``, ``csrc/int_gemm_tc.cu`` and
``csrc/int_gemm_planes.cu``, at once; their ptxas registers and spills and their SASS
instruction counts printed), then runs ``chip_smoke.int_matmul_phases`` (``[int_matmul]``,
``[int_transpose_pad]``, ``[int_planes]``, ``[int_matmul_plans]``),
``chip_smoke.dtype_sweep_phase``
(``[dtype_sweep]``) and ``chip_smoke.array_gaps_phase`` (``[array_gaps]``), with their launch
counts, gates and times, each beside the card's nvidia-smi name and power limit. The quick
way to iterate on those paths without the rest of chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core import kernels  # noqa: E402
from heat_tpu_torch.core.kernels import _nvcc  # noqa: E402

PHASES = ("int_matmul", "dtype_sweep", "array_gaps")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json-out", default=None)
    parser.add_argument("--only", nargs="+", choices=PHASES, default=list(PHASES))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("dtype_probe: needs a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ht.use_device("gpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sources = (kernels.int_matmul.SOURCE, kernels.int_matmul.TC_SOURCE, kernels.int_matmul.PLANES_SOURCE)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        builds = list(pool.map(_nvcc.build, sources))
    for source, b in zip(sources, builds):
        mix = {n: chip_smoke.sass_counts(lines)["instructions"] for n, lines in chip_smoke.sass(b["path"]).items()}
        chip_smoke.phase("build", source=source.name, nvcc_s=f"{b['seconds']:.2f}",
                         ptxas=json.dumps(chip_smoke.ptxas_summary(b["log"])), sass=json.dumps(mix))
    out = {"nvidia_smi": smi}
    if "int_matmul" in args.only:
        out["int_matmul"] = chip_smoke.int_matmul_phases(ht, kernels, dev, smi)
    if "dtype_sweep" in args.only:
        out["dtype_sweep"] = chip_smoke.dtype_sweep_phase(ht, dev, smi)
    if "array_gaps" in args.only:
        out["array_gaps"] = chip_smoke.array_gaps_phase(ht, dev, smi)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(out, indent=1, default=str))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
