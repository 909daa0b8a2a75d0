"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the harness's tests.

    python portbench/tests/_tiny.py CELL [--trace]

runs one tiny cell on the CPU through the harness and prints the result line, then the
top-level names of every module the process loaded."""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

from portbench.lib import spec  # noqa: E402

TINY = {
    "kmeans-lloyd": (
        {"n_samples": 3000, "n_features": 8, "n_clusters": 3, "max_iter": 5},
        {"checked": 2, "trace_iterations": 2},
    ),
    "s2s-train-4096": (
        {"d_model": 32, "nhead": 4, "num_encoder_layers": 1, "num_decoder_layers": 1, "dim_feedforward": 64,
         "vocab_size": 50},
        {"batch": 4, "src_len": 12, "tgt_len": 12, "pool": 4, "trace_iterations": 2},
    ),
}


def tiny_cell(name: str) -> spec.Cell:
    """The cell ``name`` with its configuration's and traffic's sizes cut to ``TINY``."""
    cell = spec.cell(name)
    config, traffic = TINY[name]
    cell.config = {**cell.config, **config}
    cell.traffic = {**cell.traffic, **traffic}
    return cell


def run_tiny(name: str, trace: bool = False, seed: int = 2**31 + 5, seconds: float = 0.2) -> dict:
    import torch

    import heat_tpu_torch as ht
    from portbench.lib import harness

    ht.use_device("cpu")
    return harness.run(tiny_cell(name), seed, seconds, trace, torch.device("cpu"), time.time(), log=sys.stdout)


if __name__ == "__main__":
    line = run_tiny(sys.argv[1], "--trace" in sys.argv)
    print(json.dumps(line))
    print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
