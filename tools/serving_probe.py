#!/usr/bin/env python3
"""Run chip_smoke.py's serving-plane phases alone on the card.

    python3 tools/serving_probe.py [--json-out FILE] [--only NAME ...]

Builds the flash kernels (K2 and the backward; the forward's K3 is not on these paths),
then runs ``chip_smoke.serving_phases``: ``[serving_swap]``, ``[serving_failover]``,
``[planes]``, ``[serving_cache]``, ``[serving_coldstart]`` and ``[supervised_train]``, each
line beside the card's nvidia-smi name and power limit. ``--only`` runs the named phases
(swap, failover, planes, cache, coldstart, supervised; failover and planes run after swap,
whose pool they serve). The quick way to iterate on the serving plane on the card without
the rest of chip_smoke.py. Also prints which coordination-store methods and process-group
abort calls this machine's torch offers (``[store_api]``).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
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

PHASES = ("swap", "failover", "planes", "cache", "coldstart", "supervised")


def store_api() -> dict:
    """The ``torch.distributed.Store`` methods and abort calls this torch has."""
    import torch.distributed as dist

    methods = ("add", "append", "check", "compare_set", "delete_key", "list_keys", "multi_get", "set_timeout", "wait")
    c10d = dist.distributed_c10d
    return {"torch": torch.__version__, "store": {m: hasattr(dist.Store, m) for m in methods},
            "abort_process_group": hasattr(c10d, "_abort_process_group"),
            "set_pg_timeout": hasattr(c10d, "_set_pg_timeout"),
            "get_default_store": hasattr(c10d, "_get_default_store")}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json-out", default=None)
    parser.add_argument("--only", nargs="*", choices=PHASES, default=list(PHASES))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("serving_probe: needs a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ht.use_device("gpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    chip_smoke.phase("store_api", **{k: json.dumps(v) for k, v in store_api().items()})
    t0 = time.perf_counter()
    sources = sorted({kernels.KERNELS[n].SOURCE for n in ("flash_attention_fwd", "flash_attention_bwd_d")})
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        for src, b in zip(sources, pool.map(_nvcc.build, sources)):
            chip_smoke.phase("build", source=src.name, nvcc_s=f"{b['seconds']:.2f}")
    out = {"nvidia_smi": smi}
    only = set(args.only)
    if only == set(PHASES):
        out.update(chip_smoke.serving_phases(ht, kernels, dev, smi))
    else:
        tmp = tempfile.mkdtemp(prefix="serving_probe_")
        try:
            if only & {"swap", "failover", "planes"}:
                served = chip_smoke.ServedTransformer(ht, dev)
                out["swap"], pool = chip_smoke.serving_swap_phase(ht, kernels, served, dev, smi, tmp)
                if "failover" in only:
                    out["failover"] = chip_smoke.serving_failover_phase(ht, served, pool, dev, smi)
                if "planes" in only:
                    out["planes"] = chip_smoke.planes_phase(ht, served, pool, dev, smi, tmp)
                del pool, served
                torch.cuda.empty_cache()
            if "cache" in only:
                out["cache"] = chip_smoke.serving_cache_phase(ht, dev, smi, tmp)
            if "coldstart" in only:
                out["coldstart"] = chip_smoke.serving_coldstart_phase(smi, tmp)
            if "supervised" in only:
                out["supervised_train"] = chip_smoke.supervised_train_phase(smi, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    chip_smoke.phase("serving_probe", total_s=f"{time.perf_counter() - t0:.2f}")
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(out, indent=1, default=str))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
