#!/usr/bin/env python3
"""Time the port's dispatch layer in two trees, in turns, on one card.

    python3 tools/dispatch_ab.py --parent DIR [--rounds 2] [--json-out FILE]

Each measurement runs in a child process of its own, importing ``heat_tpu_torch`` from
one tree: heat_tpu's cluster benchmark (benchmarks/cb/cluster.py, as chip_smoke.py's
``[cluster_bench]``: KMeans, KMedians, KMedoids and BatchParallelKMeans, k = 4, on
``create_spherical_dataset(5000)``, data included, best of 5) and heat_tpu's 64-op
dispatch chain (benchmarks/cb/dispatch.py) at 4,096 f32 elements split 0 (the mean of
200 forces after a warm-up). Three settings: ``parent`` (the tree at DIR), ``change``
(this tree, its executor on, the default) and ``eager`` (this tree with
``HEAT_TPU_EAGER_DISPATCH=1``), run in the order parent, change, eager, eager, change,
parent, ``--rounds`` times. Prints one line a child, each with the card's nvidia-smi
name and power limit, and a JSON summary of the medians.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CHAIN_N, CHAIN_CYCLES, CHAIN_FORCES = 4096, 16, 200
BENCH_N = 5000


def child(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    import heat_tpu_torch as ht
    from heat_tpu_torch.utils.data.spherical import create_spherical_dataset

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ht.use_device("gpu")
    assert Path(ht.__file__).resolve().is_relative_to(Path(tree).resolve()), ht.__file__

    def best_s(fn, reps=5):
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return min(walls)

    bench = {
        "kmeans": lambda x: ht.cluster.KMeans(n_clusters=4, init="kmeans++", max_iter=30, random_state=1).fit(x),
        "kmedians": lambda x: ht.cluster.KMedians(n_clusters=4, init="kmedians++", max_iter=30, random_state=1).fit(x),
        "kmedoids": lambda x: ht.cluster.KMedoids(n_clusters=4, init="kmedoids++", random_state=1).fit(x),
        "batchparallel_kmeans": lambda x: ht.cluster.BatchParallelKMeans(
            n_clusters=4, init="k-means++", max_iter=30, random_state=1).fit(x),
    }
    out = {"cluster_s": {}}
    for name, fn in bench.items():
        fn(create_spherical_dataset(BENCH_N))  # warm: builds, first sightings
        out["cluster_s"][name] = best_s(lambda: fn(create_spherical_dataset(BENCH_N)))

    gen = torch.Generator(device=dev).manual_seed(0)
    x = ht.array(torch.randn(CHAIN_N, generator=gen, device=dev), split=0)
    y = ht.array(torch.randn(CHAIN_N, generator=gen, device=dev) * 0.1, split=0)

    def chain():
        z = x
        for _ in range(CHAIN_CYCLES):
            z = z + y
            z = z * 0.5
            z = z - y
            z = z + 1.0
        return z.larray

    chain()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CHAIN_FORCES):
        chain()
    torch.cuda.synchronize()
    out["chain_ms_a_force"] = 1e3 * (time.perf_counter() - t0) / CHAIN_FORCES
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="the other tree (a directory holding heat_tpu_torch/)")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--json-out", default=None)
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return 0
    if not args.parent:
        parser.error("--parent is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    settings = {
        "parent": (os.path.abspath(args.parent), {}),
        "change": (str(ROOT), {}),
        "eager": (str(ROOT), {"HEAT_TPU_EAGER_DISPATCH": "1"}),
    }
    runs = {k: [] for k in settings}
    for _ in range(args.rounds):
        for label in ("parent", "change", "eager", "eager", "change", "parent"):
            tree, extra = settings[label]
            env = dict(os.environ, **extra)
            if not extra:
                env.pop("HEAT_TPU_EAGER_DISPATCH", None)
            done = subprocess.run([sys.executable, __file__, "--child", tree], env=env, capture_output=True,
                                  text=True, check=True, cwd=tree)
            rec = json.loads(done.stdout.strip().splitlines()[-1])
            runs[label].append(rec)
            print(f"[dispatch_ab] setting={label} {json.dumps(rec)} card={smi!r}", flush=True)
    summary = {
        label: {
            "chain_ms_a_force_median": statistics.median(r["chain_ms_a_force"] for r in recs),
            "cluster_s_median": {n: statistics.median(r["cluster_s"][n] for r in recs) for n in recs[0]["cluster_s"]},
        }
        for label, recs in runs.items()
    }
    print(json.dumps({"nvidia_smi": smi, "summary": summary}), flush=True)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps({"nvidia_smi": smi, "runs": runs, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
