#!/usr/bin/env python3
"""The integer and bool matrix products of this checkout against the parent's integer kernel
(IMAD), on one CUDA card.

    python3 tools/ab_int.py (--rev REV | --parent-source FILE) [--reps N] [--json-out FILE]

The parent is an ``int_gemm.cu`` whose ``int_gemm_launch`` computes integer matrix products
on integer instructions: from ``git show REV:heat_tpu_torch/core/kernels/csrc/int_gemm.cu``,
or from FILE where the checkout has no git history, as on the card's machine (a copy
written beforehand, into a directory that .gitignore lists, such as ``tree_check/``). It is
built with the package's nvcc flags into a scratch directory, beside this checkout's
sources (the package's builds), all at once, and called through its own C entry point.
The parent's kernel of the commit before the 8-bit tensor-core route takes every type; that
of the commit before the byte-plane route takes int16, int32 and int64 only. A case whose
type the parent refuses is reported as such and not timed.

The cases: the 8-bit types at 8192 (int8 and uint8 with full-range entries, bool on a
1%-dense adjacency squared, and that adjacency against a bool frontier vector, one step of
breadth-first search) and the wider types (int16 and int32 8192³ and int64 4096³ with
full-range entries, an 8192² int32 adjacency against a count vector, one step of path
counting, and full-range 8192² int64 and int16 matrices against a vector: the shapes that
``int_matmul.route`` would keep on IMAD if IMAD won them). Both results must equal the
plain version bit for bit, and the two are timed in turns, parent, this, this, parent
(median of CUDA-event-timed calls; this checkout's call includes its transpose of B, or its
splits into byte planes). Each pair is printed with its bound share
(``chip_smoke.int_bound_ms``, or the bytes for the matrix-vector steps).

The 40M int64 dot, whose kernel stays on ``int_gemm.cu``, is timed
too: the parent's and this checkout's dot kernels through their own C entry points on the
same inputs, in turns, each call queued behind a sleep kernel so that only device time
counts (``_measure.queued_ms``), and this checkout's ``int_matmul.matmul`` both ways, as
``chip_smoke.py`` times it (CUDA events around the call, host time included) and queued.
The card's name and power limit come last. Fails without a card.
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

import chip_smoke  # noqa: E402
from heat_tpu_torch.core.kernels import _nvcc  # noqa: E402
from heat_tpu_torch.core.kernels import int_matmul  # noqa: E402
from heat_tpu_torch.core.kernels._measure import cuda_ms, ptxas_summary, queued_ms  # noqa: E402

PARENT_PATH = "heat_tpu_torch/core/kernels/csrc/int_gemm.cu"
N = 8192
# name: (dtype, m = k, n of B's columns)
CASES = {"int8_8192": ("int8", N, N), "uint8_8192": ("uint8", N, N), "bool_8192": ("bool", N, N),
         "bool_matvec_8192": ("bool", N, 1), "int16_8192": ("int16", N, N), "int32_8192": ("int32", N, N),
         "int64_4096": ("int64", 4096, 4096), "int32_matvec_8192": ("int32", N, 1),
         "int64_matvec_8192": ("int64", N, 1), "int16_matvec_8192": ("int16", N, 1)}


def parent_source(args, scratch: Path) -> Path:
    """The parent's int_gemm.cu, copied into ``scratch``."""
    if args.parent_source is not None:
        text = Path(args.parent_source).read_bytes()
    else:
        text = subprocess.run(["git", "show", f"{args.rev}:{PARENT_PATH}"], cwd=ROOT, capture_output=True,
                              check=True).stdout
    path = scratch / "int_gemm_parent.cu"
    path.write_bytes(text)
    return path


def build_parent(source: Path) -> dict:
    """nvcc with the package's flags into the scratch directory beside ``source``."""
    lib = source.with_suffix(".so")
    proc = subprocess.run([_nvcc.nvcc_path(), *_nvcc.NVCC_FLAGS, "-o", str(lib), str(source)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent's int_gemm.cu:\n{proc.stdout}{proc.stderr}")
    return {"path": lib, "log": proc.stdout + proc.stderr}


class Parent:
    """The parent's integer product, through its own ``int_gemm_launch``."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.int_gemm_launch.argtypes = [i, i, p, p, p, ll, ll, ll, ll, ll, ll, p]
        lib.int_gemm_launch.restype = i
        lib.int_dot_launch.argtypes = [i, i, p, p, p, p, ll, i, p]
        lib.int_dot_launch.restype = i
        self.lib = lib

    def launch(self, a, b):
        """(the product, the launch's return code)."""
        m, k = a.shape
        n = b.shape[1]
        c = torch.empty((m, n), dtype=a.dtype, device=a.device)
        rc = self.lib.int_gemm_launch(0, int_matmul.DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), c.data_ptr(), 1, m,
                                      n, k, 0, 0, torch.cuda.current_stream().cuda_stream)
        return c, rc

    def takes(self, dtype) -> bool:
        """Whether the parent's matrix kernel takes ``dtype`` (it returns an error code if not)."""
        x = torch.zeros((1, 16), dtype=dtype, device="cuda")
        return self.launch(x, x.T.contiguous())[1] == 0

    def __call__(self, a, b):
        c, rc = self.launch(a, b)
        if rc != 0:
            raise RuntimeError(f"the parent's int_gemm_launch failed ({rc})")
        return c


def dot(lib, u, v):
    """u · v of two int64 vectors by a build's dot kernel, launched as the wrapper launches it."""
    k = u.shape[0]
    blocks = max(1, min(-(-k // (int_matmul._DOT_THREADS * 8)), 4 * int_matmul._sms(int_matmul._lib(), 0)))
    c = torch.empty(1, dtype=torch.int64, device="cuda")
    partial = torch.zeros(1, dtype=torch.int64, device="cuda")
    rc = lib.int_dot_launch(0, int_matmul.DTYPES[torch.int64], u.data_ptr(), v.data_ptr(), c.data_ptr(),
                            partial.data_ptr(), k, blocks, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int_dot_launch failed ({rc})")
    return c


def dot_case(parent: "Parent", reps: int) -> dict:
    """The 40M int64 dot: both builds' kernels in turns (device time only), and this
    checkout's wrapper timed as chip_smoke.py times it and queued."""
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 9100)
    info = torch.iinfo(torch.int64)
    n = chip_smoke.INT_DOT_N
    u = torch.randint(info.min, info.max, (n,), generator=gen, device="cuda", dtype=torch.int64)
    v = torch.randint(info.min, info.max, (n,), generator=gen, device="cuda", dtype=torch.int64)
    this = int_matmul._lib()
    ref = int_matmul.int_matmul_reference(u, v)
    equal = {"this": bool(torch.equal(int_matmul.matmul(u, v), ref)),
             "parent": bool(torch.equal(dot(parent.lib, u, v)[0], ref))}
    turns = [queued_ms(lambda: dot(parent.lib, u, v), reps), queued_ms(lambda: dot(this, u, v), reps),
             queued_ms(lambda: dot(this, u, v), reps), queued_ms(lambda: dot(parent.lib, u, v), reps)]
    bound = 1e3 * 16 * n / chip_smoke.PEAK_BYTES_PER_S
    this_ms, parent_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    return {"dtype": "int64", "shape": [n], "bit_equal": equal, "queued_turns_ms": turns, "this_ms": this_ms,
            "parent_ms": parent_ms, "bound_ms": bound, "bound_by": "bytes", "this_bound_share": bound / this_ms,
            "wrapper_ms": cuda_ms(lambda: int_matmul.matmul(u, v), reps),
            "wrapper_queued_ms": queued_ms(lambda: int_matmul.matmul(u, v), reps)}


def operands(dtype: str, m: int, n: int, seed: int):
    """A (m, m) and B (m, n) on the card: full-range int8, uint8, int16, int32 and int64 (B a
    column of counts below 1000 for the int32 matrix-vector step, A then a 1%-dense
    adjacency), a 1%-dense bool adjacency (B = A where n = m) and a 1%-dense bool frontier."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    if dtype == "bool":
        a, b = chip_smoke.int_operands("bool", m, m, m, seed, "cuda")
        if n == 1:
            b = torch.rand((m, 1), generator=gen, device="cuda") < 0.01
        return a, b
    if dtype == "int32":
        if n == 1:
            a, _ = chip_smoke.int_operands("int32", m, m, m, seed, "cuda")
            return a, torch.randint(0, 1000, (m, 1), generator=gen, device="cuda", dtype=torch.int32)
        # full range: int_operands gives int32 an adjacency, so its int64 entries are cut to int32
        return tuple(t.to(torch.int32) for t in chip_smoke.int_operands("int64", m, m, n, seed, "cuda"))
    return chip_smoke.int_operands(dtype, m, m, n, seed, "cuda")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--parent-source", default=None, help="a copy of the parent's int_gemm.cu")
    group.add_argument("--rev", default=None, help="the git revision whose int_gemm.cu is the parent's")
    parser.add_argument("--reps", type=int, default=10, help="timed calls a turn")
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_int: no CUDA card")
    torch.cuda.set_device(0)

    report = {"builds": {}, "cases": {}}
    with tempfile.TemporaryDirectory() as scratch:
        src = parent_source(args, Path(scratch))
        with ThreadPoolExecutor(max_workers=4) as pool:
            parent_build = pool.submit(build_parent, src)
            these = [pool.submit(_nvcc.build, s) for s in (int_matmul.TC_SOURCE, int_matmul.PLANES_SOURCE,
                                                           int_matmul.SOURCE)]
            pb, tb = parent_build.result(), [f.result() for f in these]
        report["builds"] = {"parent": ptxas_summary(pb["log"]), "this": [row for b in tb for row in ptxas_summary(b["log"])]}
        print(json.dumps({"builds": report["builds"]}), flush=True)
        parent = Parent(pb["path"])
        ok = True
        for i, (name, (dtype, m, n)) in enumerate(CASES.items()):
            if not parent.takes(getattr(torch, dtype)):
                report["cases"][name] = {"dtype": dtype, "parent": "refuses the type: not timed"}
                print(json.dumps({name: report["cases"][name]}), flush=True)
                continue
            a, b = operands(dtype, m, n, chip_smoke.SEED + 9300 + i)
            ref = int_matmul.int_matmul_reference(a, b)
            mine, theirs = int_matmul.matmul(a, b), parent(a, b)
            torch.cuda.synchronize()
            equal = {"this": bool(torch.equal(mine, ref)), "parent": bool(torch.equal(theirs, ref))}
            ok = ok and all(equal.values())
            turns = [cuda_ms(lambda: parent(a, b), args.reps), cuda_ms(lambda: int_matmul.matmul(a, b), args.reps),
                     cuda_ms(lambda: int_matmul.matmul(a, b), args.reps), cuda_ms(lambda: parent(a, b), args.reps)]
            if n == 1:
                bound, bound_by = 1e3 * (m * m + 2 * m) * a.element_size() / chip_smoke.PEAK_BYTES_PER_S, "bytes"
            else:
                bound, bound_by, _, _ = chip_smoke.int_bound_ms(dtype, m, m, n, itemsize=a.element_size())
            this_ms, parent_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
            row = {"dtype": dtype, "shape": [m, m, n], "route": int_matmul.route(a.dtype, 1, m, n), "bit_equal": equal, "turns_ms": turns, "this_ms": this_ms,
                   "parent_ms": parent_ms, "speedup": parent_ms / this_ms, "bound_ms": bound, "bound_by": bound_by,
                   "this_bound_share": bound / this_ms, "parent_bound_share": bound / parent_ms}
            report["cases"][name] = row
            print(json.dumps({name: row}), flush=True)
            del a, b, ref, mine, theirs
            torch.cuda.empty_cache()
        row = dot_case(parent, args.reps)
        ok = ok and all(row["bit_equal"].values())
        report["cases"]["dot_int64_40M"] = row
        print(json.dumps({"dot_int64_40M": row}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    report["nvidia_smi"] = smi
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(report, indent=1))
    print(smi, flush=True)
    if not ok:
        print("ab_int: a product differs from the plain version", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
