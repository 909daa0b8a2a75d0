#!/usr/bin/env python3
"""Run chip_smoke.py's ``[dist_forms]`` phase alone on the card.

    python3 tools/dist_forms_probe.py [--json-out FILE] [--rows N]

Runs ``chip_smoke.dist_forms_phase``: the split-axis forms of the array API (roll, tile,
pad, diagonal/diag, tril/triu, trace, vdot, the norms, cov, integer-array indexing and
assignment) at one rank on config #3's points (``--rows`` x 64 f32, 10M by default) and a
40M f32 vector, each against the port's CPU path, with its host readback, its time beside
its bytes bound and its peak device memory, beside the card's nvidia-smi name and power
limit. It builds no kernel: these forms run torch ops. The quick way to iterate on them
without the rest of chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import heat_tpu_torch as ht  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json-out", default=None)
    parser.add_argument("--rows", type=int, default=chip_smoke.N)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("dist_forms_probe: needs a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ht.use_device("gpu")
    out = chip_smoke.dist_forms_phase(ht, dev, rows=args.rows)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
