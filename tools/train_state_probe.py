#!/usr/bin/env python3
"""Run chip_smoke.py's training-state and data phases alone on the card.

    python3 tools/train_state_probe.py [--json-out FILE]

Builds the flash forward and backward kernels (one nvcc for each source, together),
times the plain data-parallel training step (best of 2 after one counted step), then runs
``chip_smoke.train_resume_phase`` (``[train_resume]``: DASO at world 1, a checkpoint and
a resume held bit for bit to uninterrupted training, corruption detection, the v1
degradation), ``daso_sync_phase`` (``[daso_sync]``) and ``io_phase`` (``[io]``), each line
beside the card's nvidia-smi name and power limit.
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
sys.path.insert(0, str(ROOT / "examples" / "nn"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import heat_tpu_torch as ht  # noqa: E402
import seq2seq_transformer_torch as s2s  # noqa: E402
from heat_tpu_torch.core import kernels  # noqa: E402
from heat_tpu_torch.core.kernels import _nvcc  # noqa: E402


def plain_step_s(dev) -> float:
    """Best of 2 wall seconds of the plain data-parallel step after a counted one."""
    torch.manual_seed(chip_smoke.SEED)
    model = s2s.Seq2Seq(vocab=chip_smoke.VOCAB, max_len=chip_smoke.TRAIN_T, d_model=512, nhead=8, layers=6,
                        dim_feedforward=2048).train()
    opt = ht.optim.DataParallelOptimizer("adam", lr=1e-4)
    ht.nn.DataParallel(model, optimizer=opt)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 4)
    batch = [ht.array(t, split=0) for t in s2s.reverse_batch(chip_smoke.TRAIN_B, chip_smoke.TRAIN_T, chip_smoke.VOCAB,
                                                              generator=gen, device=dev)]
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step(s2s.seq2seq_loss, *batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    del model, opt, batch
    torch.cuda.empty_cache()
    return min(walls[1:])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("train_state_probe: needs a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ht.use_device("gpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fa = kernels.flash_attention
    t0 = time.perf_counter()
    sources = [fa.SOURCE, fa.BWD_SOURCE]
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        for src, b in zip(sources, pool.map(_nvcc.build, sources)):
            chip_smoke.phase("build", source=src.name, nvcc_s=f"{b['seconds']:.2f}")
    chip_smoke.phase("build", total_s=f"{time.perf_counter() - t0:.2f}")
    step_s = plain_step_s(dev)
    chip_smoke.phase("train_step_time", best_of_2_s=repr(step_s), card=smi)
    out = {
        "train_resume": chip_smoke.train_resume_phase(ht, kernels, s2s, dev, smi, step_s),
        "daso_sync": chip_smoke.daso_sync_phase(ht, s2s, dev, smi),
        "io": chip_smoke.io_phase(ht, dev, smi),
    }
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps({"nvidia_smi": smi, **out}, indent=1))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
