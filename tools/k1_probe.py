#!/usr/bin/env python3
"""Where K1's time goes on one CUDA card: the streaming floor of its access pattern, and
its phases and segments timed by building copies of its source with parts taken out.

    python3 tools/k1_probe.py [--shape N,D,K] [--stream] [--phases] [--segments] [--json-out FILE]

The shape is the main one, 10M x 64 x 8 unless ``--shape`` names another (the benchmark's
KMeans cell runs 11M x 28 x 8).

- ``--stream``: x (N, D) f32 (D a multiple of 4) read once by the routes of
  tools/k1_stream_floor.cu (every thread's cp.async into K1's padded rows, one TMA bulk copy
  a tile into unpadded rows, one bulk copy a row into K1's padded rows, plain 16-byte
  loads), each with a trivial sum and at every ring depth that fits shared memory: the
  floor K1's reads can reach.
- ``--phases``: at the shape (Gaussian blobs from a seed), K1 as built, and copies
  without its accumulation, without its assignment (each thread's label then a fixed
  pattern over the clusters, so that the accumulation sees a realistic mix), and without
  both, timed in turns: which phase holds a tile longer than its bytes take to arrive.
- ``--segments``: at the main shape and at chip_smoke.py's small edge shapes, copies of
  K1 that return after the set-up, after the tile loop, and after writing the block's
  record (before the fold): the fixed costs of one launch.

The copies are made from this checkout's ``csrc/kmeans_assign.cu`` by replacing marked
lines (the run fails if a line is missing) in a temporary directory, built with the
package's nvcc flags into the package's ``_build/``, and called through the same C entry
point. Times are medians of
CUDA-event-timed launches queued behind a sleep kernel (``_measure.queued_ms``). The card's
name and power limit come last. Fails without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from heat_tpu_torch.core.kernels import _nvcc  # noqa: E402
from heat_tpu_torch.core.kernels import kmeans as k1  # noqa: E402
from heat_tpu_torch.core.kernels._measure import queued_ms  # noqa: E402

EDGES = ((200, 64, 8), (257, 64, 8), (1500, 7, 5), (3001, 256, 8))

# marked lines of csrc/kmeans_assign.cu and what a copy puts in their place
ACCUMULATE = "            for (int j = aw; j < k; j += wa) {"
ASSIGN = "#pragma unroll 1\n                for (int rr = 0; rr < TPR; ++rr) {"
HOLDER = "                row = tid;\n                holder = true;"
LOOP = "    if (warp >= wa) {"
AFTER_LOOP = "        // each hosted block's record"
FOLD = "        if (G == 1) return;"
STOP = "    if (a.k > 0) return;\n"  # an early return the compiler cannot see through


def variants(src: str, phases: bool) -> dict:
    for line in (ACCUMULATE, ASSIGN, HOLDER, LOOP, AFTER_LOOP, FOLD):
        if line not in src:
            sys.exit(f"k1_probe: csrc/kmeans_assign.cu no longer holds {line.strip()!r}")
    no_acc = src.replace(ACCUMULATE, ACCUMULATE.replace("j < k", "j < 0"))
    no_assign = src.replace(ASSIGN, ASSIGN.replace("rr < TPR", "rr < 0")).replace(
        HOLDER, HOLDER + " label = (tid * 5 + 3) & 7;")
    if phases:
        return {"full": src, "no_accumulate": no_acc, "no_assign": no_assign,
                "neither": no_assign.replace(ACCUMULATE, ACCUMULATE.replace("j < k", "j < 0"))}
    return {"full": src, "setup_only": src.replace(LOOP, STOP + LOOP),
            "loop_no_record": src.replace(AFTER_LOOP, STOP + AFTER_LOOP),
            "record_no_fold": src.replace(FOLD, STOP + FOLD)}


def build(sources: dict) -> dict:
    # the copies' sources live in a temporary directory, each beside the headers it includes:
    # only their libraries stay, in _build/
    headers = {h.name: h.read_text() for h in k1.SOURCE.parent.glob("*.cuh")}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, text in sources.items():
            (Path(tmp) / name).mkdir()
            paths[name] = Path(tmp) / name / "kmeans_assign.cu"
            paths[name].write_text(text)
            for h, body in headers.items():
                (Path(tmp) / name / h).write_text(body)
        with ThreadPoolExecutor(max_workers=len(paths)) as pool:
            built = dict(zip(paths, pool.map(_nvcc.build, paths.values())))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, b in built.items():
        lib = ctypes.CDLL(str(b["path"]))
        lib.kmeans_assign_launch.argtypes = [i, p, p, ll, i, i, p, p, i, p, p, i, i, i, p]
        libs[name] = lib
    return libs


def data(n, d, k, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    true = 2.0 * torch.randn(k, d, generator=gen, device="cuda")
    x = torch.randn(n, d, generator=gen, device="cuda") + true[torch.randint(0, k, (n,), generator=gen, device="cuda")]
    return x, (true + 0.5 * torch.randn(k, d, generator=gen, device="cuda")).contiguous()


def launcher(lib, x, c):
    """A call of ``lib``'s K1 on x and c with the package's launch, outputs preallocated."""
    n, d = x.shape
    k = c.shape[0]
    p = k1.plan(d, k)
    blocks, _ = k1.grid_blocks(n, d, k, x.device)
    m4 = -(-(k * d + k + 1) // 4) * 4
    labels = torch.empty(n, dtype=torch.int32, device="cuda")
    scratch = torch.empty((blocks + -(-blocks // 16), m4), device="cuda")
    out = torch.empty(m4, device="cuda")
    counter = torch.zeros(1 + k1._MAX_GROUPS, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    route = k1.ROUTES.index(k1.route(p, x))

    def call():
        rc = lib.kmeans_assign_launch(0, x.data_ptr(), c.data_ptr(), n, d, k, labels.data_ptr(), scratch.data_ptr(),
                                      blocks, out.data_ptr(), counter.data_ptr(), p.threads, p.stages, route, stream)
        if rc:
            raise RuntimeError(f"k1_probe: launch failed ({rc})")
    return call  # the copies return before drawing a ticket, so the tickets stay at zero


def stream_floor(n: int, d: int, k: int) -> dict:
    if d % 4:
        sys.exit(f"k1_probe: --stream needs D a multiple of 4, got {d}")
    lib = ctypes.CDLL(str(_nvcc.build(ROOT / "tools" / "k1_stream_floor.cu")["path"]))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.run.argtypes = [i, p, ll, i, i, i, p, i, p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    d4, p4 = d // 4, k1.plan(d, k).row_stride4
    x = torch.randn(n, d, device="cuda")
    out = torch.empty(8 * sms * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    fits = lambda stages, chunks: stages * 256 * chunks * 16 <= k1._SMEM_BUDGET  # noqa: E731
    routes = [(f"cp_async_ring_{s}", 0, s, p4, sms) for s in range(3, 9) if fits(s, p4)]
    routes += [(f"tma_bulk_ring_{s}", 1, s, d4, sms) for s in range(2, 9) if fits(s, d4)]
    if p4 != d4:
        routes += [(f"tma_row_ring_{s}", 3, s, p4, sms) for s in range(2, 9) if fits(s, p4)]
    routes.append(("plain_loads", 2, 2, d4, 8 * sms))
    res = {"d4": d4, "p4": p4, "bound_ms": 4 * n * d / 3.35e12 * 1e3}
    for name, route, stages, chunks, blocks in routes:
        def call():
            rc = lib.run(route, x.data_ptr(), n, d4, chunks, stages, out.data_ptr(), blocks, stream)
            if rc:
                raise RuntimeError(f"k1_probe: stream route {name} failed ({rc})")
        ms = queued_ms(call, 20)
        res[name] = {"ms": ms, "bytes_per_s": 4 * n * d / (ms * 1e-3)}
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", default="10000000,64,8", help="N,D,K of the main shape")
    parser.add_argument("--stream", action="store_true")
    parser.add_argument("--phases", action="store_true")
    parser.add_argument("--segments", action="store_true")
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k1_probe: no CUDA card")
    torch.cuda.set_device(0)
    n_main, d_main, k_main = (int(v) for v in args.shape.split(","))
    src = (ROOT / "heat_tpu_torch/core/kernels/csrc/kmeans_assign.cu").read_text()
    report = {}
    if args.stream:
        report["stream"] = stream_floor(n_main, d_main, k_main)
        print(json.dumps({"stream": report["stream"]}), flush=True)
    if args.phases:
        libs = build(variants(src, phases=True))
        x, c = data(n_main, d_main, k_main, 0)
        calls = {name: launcher(lib, x, c) for name, lib in libs.items()}
        turns = {name: [] for name in calls}
        for order in (list(calls), list(reversed(calls))):
            for name in order:
                turns[name].append(queued_ms(calls[name], 20))
        report["phases"] = {name: {"ms_in_turns": t, "ms": sum(t) / len(t)} for name, t in turns.items()}
        print(json.dumps({"phases": report["phases"]}), flush=True)
        del x, c
    if args.segments:
        libs = build(variants(src, phases=False))
        report["segments"] = {}
        for n, d, k in EDGES + ((n_main, d_main, k_main),):
            x, c = data(n, d, k, n + d)
            row = {name: queued_ms(launcher(lib, x, c), 20 if n == n_main else 100) for name, lib in libs.items()}
            row["blocks"] = k1.grid_blocks(n, d, k, x.device)[0]
            report["segments"][f"{n}x{d}x{k}"] = row
            print(json.dumps({"segments": {f"{n}x{d}x{k}": row}}), flush=True)
            del x, c
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    report["nvidia_smi"] = smi
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(report, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
