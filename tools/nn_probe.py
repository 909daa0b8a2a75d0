#!/usr/bin/env python3
"""Run chip_smoke.py's heat_tpu.nn phases alone on the card.

    python3 tools/nn_probe.py [--json-out FILE]

Builds the flash kernels (one nvcc for each source, all together), then runs
``chip_smoke.nn_phases``: ``[ring_attention]``, ``[ring_attention_bwd]``, ``[ulysses]``
and ``[nn_zoo]``, with their launch counts, gates and times, each line beside the card's
nvidia-smi name and power limit. The quick way to iterate on those paths without the
rest of chip_smoke.py (~1 minute of command time with the builds).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("nn_probe: needs a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ht.use_device("gpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fa = kernels.flash_attention
    t0 = time.perf_counter()
    sources = [fa.SOURCE, fa.PIPELINED_SOURCE, fa.BWD_SOURCE]
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        for src, b in zip(sources, pool.map(_nvcc.build, sources)):
            chip_smoke.phase("build", source=src.name, nvcc_s=f"{b['seconds']:.2f}",
                             ptxas=json.dumps(chip_smoke.ptxas_summary(b["log"])))
    chip_smoke.phase("build", total_s=f"{time.perf_counter() - t0:.2f}")
    out = chip_smoke.nn_phases(ht, kernels, smi, dev)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps({"nvidia_smi": smi, **out}, indent=1))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
