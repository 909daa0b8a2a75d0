#!/usr/bin/env python3
"""K1 of this checkout against K1 of another one, on one CUDA card.

    python3 tools/ab_k1.py --parent DIR [--parent DIR ...] [--config T,S ...] [--sass]
                           [--main-only] [--json-out FILE]

Each DIR holds another checkout of the repository, or only its
``heat_tpu_torch/core/kernels/csrc`` (for example the parent commit, unpacked by ``git
archive`` into a directory that .gitignore lists); it is named by its directory's name.
Every version of ``csrc/kmeans_assign.cu`` is built with the package's nvcc flags, all at
once, and called through its C entry points on the same inputs: this checkout's through
the package's wrapper, another through its own interface (the single-record one of this
checkout, or the two-kernel one that PR 1 to 6 built, which has no ``kmeans_assign_abi``).

At the benchmark's shape (11M x 28 x 8) and the main path's (10M x 64 x 8), at 10M x 10 x 8
and at 10M x 64 x 8 with x 4 bytes past a 16-byte boundary, Gaussian blobs from a seed, at
the edge shapes chip_smoke.py checks (n below one tile and one row past it,
d = 7, 10, 48, 100 and 256, k = 1 and 12, x 4 bytes past a 16-byte boundary), at edges of
the same kinds with 50,000 to 100,000 rows, and where shared memory holds one warp a role:

- labels and counts of each other version must equal this checkout's, and its sums must
  lie within (γ(h) + γ(h')) Σ|x| of this checkout's, h and h' the two orders' rounding
  depths (``kmeans.rounding_depths``, and for the two-kernel version its warp-per-row
  order: the rows of a warp slot, the warps of a block, the blocks); whether the labels
  and the packed record (sums, counts, sse) are equal bit for bit is reported beside
  (``labels_equal``, ``packed_bits_equal``): they are where both versions keep one order;
- each kernel is timed in turns with this checkout's, other, this, this, other (median of
  CUDA-event-timed launches, each queued behind a sleep kernel so that the host's time to
  launch does not count: ``_measure.queued_ms``);
- each ``--config T,S`` (assigning threads a block, ring stages) runs this
  checkout's kernel with that launch: its labels and counts must equal the default's and
  its sums lie within both orders' bounds, and it is timed in turns with the default at the
  four shapes of 10M rows or more where it fits shared memory.

``--sass`` also prints the SASS opcode mix of every K1 instance of every build (static
counts, and those of the largest loop). The card's name and power limit come last. Fails
without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from heat_tpu_torch.core.kernels import _nvcc  # noqa: E402
from heat_tpu_torch.core.kernels import kmeans as k1  # noqa: E402
from heat_tpu_torch.core.kernels._measure import ptxas_summary, queued_ms, sass, sass_counts  # noqa: E402

SOURCE = Path("heat_tpu_torch/core/kernels/csrc/kmeans_assign.cu")
U32 = 2.0**-24

# (name, n, d, k, misaligned): the benchmark's and the main path's shapes, the two copy
# routes of K1 other than bulk copies at 10M rows (d % 4 != 0, x off a 16-byte boundary),
# chip_smoke.py's edge shapes, and the same kinds of edge at 50,000 to 100,000 rows
SHAPES = (
    ("cell_11Mx28x8", 11_000_000, 28, 8, False),
    ("main_10Mx64x8", 10_000_000, 64, 8, False),
    ("d10_10Mx10x8", 10_000_000, 10, 8, False),
    ("misaligned_10Mx64x8", 10_000_000, 64, 8, True),
    ("below_one_tile", 200, 64, 8, False),
    ("one_row_past_a_tile", 257, 64, 8, False),
    ("d10_130", 130, 10, 3, False),
    ("d7_1500", 1500, 7, 5, False),
    ("k1_5000", 5000, 64, 1, False),
    ("k12_3000", 3000, 48, 12, False),
    ("d100_2000", 2000, 100, 6, False),
    ("d256_3001", 3001, 256, 8, False),
    ("misaligned_4099", 4099, 64, 8, True),
    ("d7", 100_003, 7, 5, False),
    ("d10", 100_003, 10, 3, False),
    ("d256", 50_000, 256, 8, False),
    ("k1", 100_000, 64, 1, False),
    ("misaligned_4B", 100_000, 64, 8, True),
    ("gate_d64_k350", 20_000, 64, 350, False),  # shared memory holds one warp a role
    ("gate_d256_k90", 5_000, 256, 90, False),
)


def gamma(h: int) -> float:
    return h * U32 / (1.0 - h * U32)


def blobs(n, d, k, seed, misaligned):
    """x (n, d) and centers (k, d) f32 on the card: blobs around N(0, 2²) centers, initial
    centers near them; x 4 bytes past a 16-byte boundary when ``misaligned``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    true = 2.0 * torch.randn(k, d, generator=gen, device="cuda")
    y = torch.randint(0, k, (n,), generator=gen, device="cuda")
    buf = torch.empty(n * d + int(misaligned), device="cuda")
    x = buf[int(misaligned):].view(n, d)
    x.copy_(torch.randn(n, d, generator=gen, device="cuda") + true[y])
    c = (true + 0.5 * torch.randn(k, d, generator=gen, device="cuda")).contiguous()
    return x, c


class Other:
    """Another checkout's K1, bound by the interface its library exports: 3 (this one's:
    assigning threads, stages and the copy route, planned by this checkout), 2 (the one
    launch before the TMA ring: threads and stages, planned as those checkouts planned, from
    256 threads and 3 stages down to what fits) or none (the first, two-kernel interface)."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.single = hasattr(lib, "kmeans_assign_abi")
        self.abi = lib.kmeans_assign_abi() if self.single else 1
        if self.single:
            lib.kmeans_assign_max_blocks.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
            lib.kmeans_assign_smem_bytes.argtypes = [i, i, i, i]
            lib.kmeans_assign_smem_bytes.restype = ll
            route = [i] if self.abi >= 3 else []
            lib.kmeans_assign_launch.argtypes = [i, p, p, ll, i, i, p, p, i, p, p, i, i, *route, p]
        else:
            lib.kmeans_assign_max_blocks.argtypes = [i, i, i, ctypes.POINTER(i)]
            lib.kmeans_assign_launch.argtypes = [i, p, p, ll, i, i, p, p, i, p, p]
        self.lib = lib
        self.counter = torch.zeros(1 + k1._MAX_GROUPS, dtype=torch.int32, device="cuda")

    def plan(self, d, k):
        """(threads, stages, rows a tile) of this version's launch for (d, k)."""
        if self.abi >= 3:
            p = k1.plan(d, k)
            return p.threads, p.stages, p.rows_per_tile
        threads, stages = 256, 3
        while self.lib.kmeans_assign_smem_bytes(d, k, threads, stages) > k1._SMEM_BUDGET:
            if stages > 2:
                stages -= 1
            else:
                threads //= 2
        p = k1._shape(d, k, threads, stages)
        return threads, stages, (threads if p.reg else threads // p.tpr)

    def grid(self, n, d, k):
        out = ctypes.c_int(0)
        if self.single:
            threads, stages, per = self.plan(d, k)
            rc = self.lib.kmeans_assign_max_blocks(0, d, k, threads, stages, ctypes.byref(out))
        else:
            rc = self.lib.kmeans_assign_max_blocks(0, d, k, ctypes.byref(out))
            per = 8
        assert rc == 0, rc
        return max(1, min(out.value, -(-n // per)))

    def __call__(self, x, c):
        n, d = x.shape
        k = c.shape[0]
        blocks = self.grid(n, d, k)
        m = k * d + k + 1
        labels = torch.empty(n, dtype=torch.int32, device="cuda")
        scratch = torch.empty((blocks + -(-blocks // 16), -(-m // 4) * 4) if self.single else (blocks, m), device="cuda")
        out = torch.empty(m, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        if self.single:
            threads, stages, _ = self.plan(d, k)
            route = [k1.ROUTES.index(k1.route(k1.plan(d, k), x))] if self.abi >= 3 else []
            rc = self.lib.kmeans_assign_launch(0, x.data_ptr(), c.data_ptr(), n, d, k, labels.data_ptr(),
                                               scratch.data_ptr(), blocks, out.data_ptr(), self.counter.data_ptr(),
                                               threads, stages, *route, stream)
        else:
            rc = self.lib.kmeans_assign_launch(0, x.data_ptr(), c.data_ptr(), n, d, k, labels.data_ptr(),
                                               scratch.data_ptr(), blocks, out.data_ptr(), stream)
        assert rc == 0, rc
        return labels, out

    def depth(self, n, d, k, labels):
        """h of this version's order for the sums."""
        if self.single:
            threads, stages, _ = self.plan(d, k)
            launch = k1._shape(d, k, threads, stages)
            return k1.rounding_depths(n, d, k, labels, self.grid(n, d, k), launch=launch)["h_sums"]
        blocks = self.grid(n, d, k)
        slots = blocks * 8  # row r is summed by warp r % slots; then 8 warps, then the blocks
        slot = torch.arange(n, device=labels.device) % slots
        return int(torch.bincount(slot * k + labels.long(), minlength=slots * k).max()) + 8 + blocks


def with_config(x, c, threads, stages):
    """This checkout's kernel with another launch (its labels and packed record)."""
    n, d = x.shape
    k = c.shape[0]
    lib = k1._lib()
    out = ctypes.c_int(0)
    k1._raise_on(lib, lib.kmeans_assign_max_blocks(0, d, k, threads, stages, ctypes.byref(out)), "occupancy query")
    p = k1.plan(d, k, threads, stages)
    per = p.rows_per_tile
    blocks = max(1, min(out.value, -(-n // per)))
    m = k * d + k + 1
    labels = torch.empty(n, dtype=torch.int32, device="cuda")
    scratch = torch.empty((blocks + -(-blocks // 16), -(-m // 4) * 4), device="cuda")
    packed = torch.empty(m, device="cuda")
    counter = k1._counter(0, torch.cuda.current_stream().cuda_stream, x.device)
    rc = lib.kmeans_assign_launch(0, x.data_ptr(), c.data_ptr(), n, d, k, labels.data_ptr(), scratch.data_ptr(),
                                  blocks, packed.data_ptr(), counter.data_ptr(), threads, stages,
                                  k1.ROUTES.index(k1.route(p, x)), torch.cuda.current_stream().cuda_stream)
    k1._raise_on(lib, rc, "launch")
    return labels, packed, blocks


def compare(x, c, mine, theirs, h_mine, h_theirs) -> dict:
    """Labels and counts equal; sums within both orders' bounds of each other."""
    n, d = x.shape
    k = c.shape[0]
    (l0, p0), (l1, p1) = mine, theirs
    s0, n0, e0 = k1.unpack(p0, k, d)
    s1, n1, e1 = k1.unpack(p1, k, d)
    abs64 = torch.zeros(k, d, dtype=torch.float64, device="cuda").index_add_(0, l0.long(), x.double().abs())
    err = (s0.double() - s1.double()).abs()
    tol = (gamma(h_mine) + gamma(h_theirs)) * abs64 + 1e-30
    res = {
        "labels_equal": bool(torch.equal(l0, l1)),
        "packed_bits_equal": bool(torch.equal(p0.view(torch.int32), p1.view(torch.int32))),
        "counts_equal": bool(torch.equal(n0, n1)),
        "sums_err_over_tol": float((err / tol).max()),
        "sse_rel": abs(float(e0) - float(e1)) / max(abs(float(e0)), 1e-30),
    }
    res["ok"] = res["labels_equal"] and res["counts_equal"] and res["sums_err_over_tol"] <= 1.0
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", action="append", default=[], type=Path, help="another checkout (repeats)")
    parser.add_argument("--config", action="append", default=[], help="T,S: threads and stages of a launch of this checkout to try")
    parser.add_argument("--sass", action="store_true", help="print each K1 instance's SASS opcode mix")
    parser.add_argument("--main-only", action="store_true", help="only the four shapes of 10M rows or more")
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_k1: no CUDA card")
    torch.cuda.set_device(0)

    sources = [(ROOT / SOURCE).resolve()] + [(p / SOURCE).resolve() for p in args.parent]
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        builds = list(pool.map(_nvcc.build, sources))
    report = {"builds": {}}
    for name, b in zip(["this"] + [p.name for p in args.parent], builds):
        entry = {"nvcc_s": b["seconds"], "ptxas": ptxas_summary(b["log"])}
        if args.sass:
            entry["sass"] = {}
            for inst, lines in sass(b["path"]).items():
                cnt = sass_counts(lines)
                entry["sass"][inst] = {"instructions": cnt["instructions"], "opcodes": cnt["opcodes"],
                                       "loop": {"instructions": cnt["loop"].get("instructions"),
                                                "opcodes": cnt["loop"].get("opcodes")}}
        report["builds"][name] = entry
    print(json.dumps({"builds": report["builds"]}), flush=True)
    others = {p.name: Other(b["path"]) for p, b in zip(args.parent, builds[1:])}

    rows = []
    for name, n, d, k, misaligned in SHAPES[:4] if args.main_only else SHAPES:
        x, c = blobs(n, d, k, 7 + n + d, misaligned)
        this = k1.fused_assign_update_packed(x, c)
        again = k1.fused_assign_update_packed(x, c)
        torch.cuda.synchronize()
        row = {"shape": name, "n": n, "d": d, "k": k, "misaligned": misaligned,
               "deterministic": bool(torch.equal(this[0], again[0]) and torch.equal(this[1], again[1]))}
        h_this = k1.rounding_depths(n, d, k, this[0], k1.grid_blocks(n, d, k, x.device))["h_sums"]
        row["h_sums"] = h_this
        reps = 20 if n >= 1_000_000 else 50
        for oname, other in others.items():
            theirs = other(x, c)
            row[oname] = compare(x, c, this, theirs, h_this, other.depth(n, d, k, theirs[0]))
            turns = [queued_ms(lambda: other(x, c), reps), queued_ms(lambda: k1.fused_assign_update_packed(x, c), reps),
                     queued_ms(lambda: k1.fused_assign_update_packed(x, c), reps), queued_ms(lambda: other(x, c), reps)]
            row[oname]["turns_ms"] = turns
            row[oname]["this_ms"] = (turns[1] + turns[2]) / 2
            row[oname]["other_ms"] = (turns[0] + turns[3]) / 2
        print(json.dumps(row), flush=True)
        if n >= 10_000_000:
            p = k1.plan(d, k)
            for cfg in args.config:
                t, s = (int(v) for v in cfg.split(","))
                if k1.smem_bytes(d, k, t, s) > k1._SMEM_BUDGET:
                    continue  # beyond shared memory at this shape
                lab, packed, blocks = with_config(x, c, t, s)
                h_cfg = k1.rounding_depths(n, d, k, lab, blocks, launch=k1.plan(d, k, t, s))["h_sums"]
                res = compare(x, c, this, (lab, packed), h_this, h_cfg)
                turns = [queued_ms(lambda: k1.fused_assign_update_packed(x, c), reps),
                         queued_ms(lambda: with_config(x, c, t, s), reps),
                         queued_ms(lambda: with_config(x, c, t, s), reps),
                         queued_ms(lambda: k1.fused_assign_update_packed(x, c), reps)]
                res.update(turns_ms=turns, default=[p.threads, p.stages], default_ms=(turns[0] + turns[3]) / 2,
                           config_ms=(turns[1] + turns[2]) / 2, blocks=blocks)
                row[f"config_{t}_{s}"] = res
                print(json.dumps({"shape": name, f"config_{t}_{s}": res}), flush=True)
        rows.append(row)
        del x, c, this, again
        torch.cuda.empty_cache()
    report["shapes"] = rows
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    report["nvidia_smi"] = smi
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(report, indent=1))
    print(smi, flush=True)
    bad = [r["shape"] for r in rows if not r["deterministic"]
           or any(not v["ok"] for key, v in r.items() if isinstance(v, dict) and "ok" in v)]
    if bad:
        print(f"ab_k1: disagreement at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
