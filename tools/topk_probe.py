#!/usr/bin/env python3
"""Time the steps of the port's ``topk`` (``manipulations._ordered_topk``) on the card.

    python3 tools/topk_probe.py [--n 40000000] [--k 64] [--json-out FILE]

The input is chip_smoke.py's: ``ht.random.random`` of n float32 on the card (23-bit
floats, so a value repeats about n / 2**23 times). Each step runs alone on inputs made
beforehand, timed between CUDA events (median of 5 after 2 warm-ups), then the whole
function, ``ht.topk`` and the torch calls it is measured against. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core import manipulations  # noqa: E402
from heat_tpu_torch.core.kernels._measure import cuda_ms  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=40_000_000)
    parser.add_argument("--k", type=int, default=64)
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("topk_probe: needs a GPU", file=sys.stderr)
        return 2
    n, k = args.n, args.k
    ht.use_device("gpu")
    ht.random.seed(12345)
    x = ht.random.random((n,), split=0).larray
    top = torch.topk(x, k)
    v = top.values[k - 1 :]
    ties = (x == v).reshape(1, n)
    found = torch.nonzero(ties)

    def rest():
        top_index = top.indices.reshape(1, k)
        slots = ties.gather(-1, top_index)
        pos = torch.argsort((~slots).to(torch.uint8), dim=-1, stable=True)
        j = torch.arange(k, device=x.device).expand(1, k)
        first_ties = found[:, 1][j.clamp(max=found.shape[0] - 1)]
        fill = torch.where(j < slots.sum(-1, keepdim=True), first_ties, top_index.gather(-1, pos))
        index = torch.sort(top_index.scatter(-1, pos, fill).view(k), dim=-1).values
        order = torch.sort(x.gather(-1, index), dim=-1, descending=True, stable=True)
        return order.values, index.gather(-1, order.indices)

    def blocked(block=4096):
        """The ties' positions from the blocks of ``block`` elements that hold one: an
        any-reduction of every block, then ``nonzero`` of the few blocks found."""
        flat = ties.reshape(-1)
        whole = flat[: n - n % block].view(-1, block)
        hit = torch.nonzero(whole.any(-1)).reshape(-1)
        pos = torch.nonzero(whole.index_select(0, hit))
        tail = torch.nonzero(flat[n - n % block :]).reshape(-1) + (n - n % block)
        return torch.cat([hit[pos[:, 0]] * block + pos[:, 1], tail])

    steps = {
        "torch.topk": lambda: torch.topk(x, k),
        "x == v": lambda: x == v,
        "nonzero(ties)": lambda: torch.nonzero(ties),
        "ties by blocks of 4096": blocked,
        "the rest (slots, the swap, sorts of k)": rest,
        "_ordered_topk": lambda: manipulations._ordered_topk(x, k, True),
        "torch.sort(stable=True)": lambda: torch.sort(x, stable=True),
    }
    xd = ht.array(x, split=0)
    steps["ht.topk"] = lambda: ht.topk(xd, k)
    out = {"n": n, "k": k, "ties_of_v": int(found.shape[0]),
           "nvidia_smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                        capture_output=True, text=True).stdout.strip(),
           "device_ms": {name: cuda_ms(fn, reps=5, warmup=2) for name, fn in steps.items()}}
    line = json.dumps(out)
    print(line)
    if args.json_out:
        Path(args.json_out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
