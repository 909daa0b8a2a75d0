#!/usr/bin/env python3
"""The flash kernels of this checkout against those of another one, on one CUDA card.

    python3 tools/ab_flash.py --parent DIR [--parent DIR ...] [--fwd-only | --bwd-only] [--json-out FILE]

Each DIR holds another checkout of the repository, or only its
``heat_tpu_torch/core/kernels/csrc`` (for example the parent commit, unpacked by ``git
archive`` into a directory that .gitignore lists, or a variant of this checkout's
sources); it is named by its directory's name. Every version of
``csrc/flash_attention_fwd.cu`` (K2), ``csrc/flash_attention_fwd_pipelined.cu`` (K3) and,
without ``--fwd-only``, ``csrc/flash_attention_bwd.cu`` (the D pass, K4, K5) is built with
the package's nvcc flags, all at once, and called through its C entry points on the same
inputs:

- at each shape, each other version's O and LSE (K2, K3) and dQ, dK, dV (D, K4, K5) are
  compared bit for bit with this checkout's, and every version's forward is held to the
  plain version (chip_smoke.py's tolerances: ``_measure.fwd_err`` for f32, the 16-bit rule
  ``_measure.fwd16_err`` for bf16 and f16, with the share of max|O| each version needed).
  The bf16 and f16 K2, K3, K4 and K5 round P (and dS) to the input type before their
  products, as heat_tpu does, where earlier builds kept them f32: for 2-byte inputs two such
  builds differ by that rounding, so the line gives each version's distance from the plain
  versions (which round them) beside the bit comparison, and only f32 outputs are expected
  to be bit-equal across builds of the same arithmetic;
- each kernel is timed in turns with this checkout's, other, this, this, other (median
  of CUDA-event-timed launches; the D pass, shorter than its host launch, queued behind a
  sleep kernel: ``_measure.queued_ms``), beside ``scaled_dot_product_attention`` on the same
  inputs (its forward; its backward beside K4 and K5). ``--bwd-only`` times only D, K4
  and K5 (the forward that feeds them is this checkout's K2).

A first JSON line gives each build's nvcc seconds and its instances' ptxas registers and
spill bytes; then one JSON line per shape, then the card's name and power limit.
Fails without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from heat_tpu_torch.core.kernels import _nvcc  # noqa: E402
from heat_tpu_torch.core.kernels import flash_attention as fa  # noqa: E402
from heat_tpu_torch.core.kernels._measure import (cuda_ms, fwd16_err, fwd_err, k2_inputs, ptxas_summary,  # noqa: E402
                                                   queued_ms)

CSRC = Path("heat_tpu_torch/core/kernels/csrc")
FWD = ("flash_attention_fwd.cu", "flash_attention_fwd_launch")
PIPELINED = ("flash_attention_fwd_pipelined.cu", "flash_attention_fwd_pipelined_launch")
BWD = "flash_attention_bwd.cu"

# (name, bh, tq, tk, d, causal, dtype, padding): the Transformer forward's three attention
# shapes, the training step's two (the first also in bf16), bench.py's causal one in bf16 and
# f16 and its padding mask (the last T/8 keys, bench.py:248) in bf16; the backward runs at the
# step's and bench.py's causal ones
SHAPES = (
    ("encoder_self", 64, 4096, 4096, 64, False, torch.float32, False),
    ("decoder_cross", 64, 2048, 4096, 64, False, torch.float32, False),
    ("decoder_self_causal", 64, 2048, 2048, 64, True, torch.float32, False),
    ("step_self", 96, 2048, 2048, 64, False, torch.float32, False),
    ("step_self_causal", 96, 2048, 2048, 64, True, torch.float32, False),
    ("step_self_bf16", 96, 2048, 2048, 64, False, torch.bfloat16, False),
    ("bench_causal_bf16", 128, 4096, 4096, 64, True, torch.bfloat16, False),
    ("bench_causal_f16", 128, 4096, 4096, 64, True, torch.float16, False),
    ("padding_mask_bf16", 128, 4096, 4096, 64, False, torch.bfloat16, True),
)


class Version:
    """One checkout's flash libraries, bound by the package's own ``flash_attention.bind``."""

    def __init__(self, root: Path, builds: dict):
        self.fwd = {}
        for source, fn in (FWD, PIPELINED):
            self.fwd[source] = getattr(fa.bind(ctypes.CDLL(str(builds[root / CSRC / source]["path"]))), fn)
        if root / CSRC / BWD in builds:
            self.bwd = fa.bind(ctypes.CDLL(str(builds[root / CSRC / BWD]["path"])))

    def forward(self, source, q, k, v, causal, scale, bias=None):
        bh, tq, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
        rc = self.fwd[source](0, fa._DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              None if bias is None else bias.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, tq,
                              k.shape[1], d, scale, int(causal), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"{source}: launch failed ({rc})"
        return o, lse

    def d_pass(self, o, do):
        bh, tq, d = o.shape
        dd = torch.empty((bh, tq), dtype=torch.float32, device=o.device)
        rc = self.bwd.flash_attention_bwd_d_launch(0, fa._DTYPES[o.dtype], o.data_ptr(), do.data_ptr(), dd.data_ptr(),
                                                   bh * tq, d, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"D pass: launch failed ({rc})"
        return dd

    def dq(self, q, k, v, do, lse, dd, causal, scale):
        bh, tq, d = q.shape
        dq = torch.empty_like(q)
        rc = self.bwd.flash_attention_bwd_dq_launch(
            0, fa._DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), None, dq.data_ptr(), bh, tq, k.shape[1], d, scale, int(causal),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"K4: launch failed ({rc})"
        return dq

    def dkv(self, q, k, v, do, lse, dd, causal, scale):
        bh, tq, d = q.shape
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        rc = self.bwd.flash_attention_bwd_dkv_launch(
            0, fa._DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), None, dk.data_ptr(), dv.data_ptr(), bh, tq, k.shape[1], d, scale, int(causal),
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"K5: launch failed ({rc})"
        return dk, dv


def plain_err(q, k, v, causal, bias, o, lse) -> dict:
    """Worst err/tol of (o, lse) against the plain version (for bf16 and f16 with the share
    of max|O| needed), the plain version run in chunks of batch·heads."""
    chunk = max(1, (1 << 28) // (q.shape[1] * k.shape[1]))
    refs = [fa.flash_attention_reference(q[s0:s0 + chunk], k[s0:s0 + chunk], v[s0:s0 + chunk], causal, None, bias)
            for s0 in range(0, q.shape[0], chunk)]
    ro, rl = torch.cat([r[0] for r in refs]), torch.cat([r[1] for r in refs])
    if q.dtype == torch.float32:
        return {"err_over_tol": fwd_err(o, lse, ro, rl)[2]}
    _, _, worst, need = fwd16_err(o, lse, ro, rl)
    return {"err_over_tol": worst, "share_needed": need}


def bwd_share(q, k, v, o, do, lse, causal, grads) -> dict:
    """Each gradient's largest distance from the plain backward as a share of its largest
    magnitude, in chunks of batch·heads."""
    chunk = max(1, (1 << 28) // (q.shape[1] * k.shape[1]))
    err, top = [0.0] * 3, [0.0] * 3
    for s0 in range(0, q.shape[0], chunk):
        sl = slice(s0, s0 + chunk)
        ref = fa.flash_attention_bwd_reference(q[sl], k[sl], v[sl], o[sl], do[sl], lse[sl], causal)
        for i, (g, r) in enumerate(zip(grads, ref)):
            err[i] = max(err[i], float((g[sl].float() - r.float()).abs().max()))
            top[i] = max(top[i], float(r.float().abs().max()))
    return {n: e / max(t, 1e-30) for n, e, t in zip(("dq", "dk", "dv"), err, top)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, action="append", required=True,
                        help="another checkout of the repository (repeatable)")
    parser.add_argument("--fwd-only", action="store_true", help="K2 and K3 only")
    parser.add_argument("--bwd-only", action="store_true", help="D, K4 and K5 only")
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_flash: CUDA is not available", file=sys.stderr)
        return 2
    roots = {"change": ROOT, **{d.resolve().name: d.resolve() for d in args.parent}}
    others = [n for n in roots if n != "change"]
    names = (FWD[0], PIPELINED[0]) if args.fwd_only else (FWD[0], PIPELINED[0], BWD)
    sources = [r / CSRC / s for r in roots.values() for s in names]
    distinct = list({_nvcc._library_path(s.resolve()): s for s in sources}.values())  # one build per content
    with ThreadPoolExecutor(max_workers=len(distinct)) as pool:
        built = dict(zip(distinct, pool.map(_nvcc.build, distinct)))
    builds = {s: _nvcc.build(s) if s not in built else built[s] for s in sources}
    ver = {name: Version(root, builds) for name, root in roots.items()}
    print(json.dumps({"nvcc_s": {f"{n}:{s}": builds[r / CSRC / s]["seconds"] for n, r in roots.items() for s in names},
                      "ptxas": {f"{n}:{s}": ptxas_summary(builds[r / CSRC / s]["log"]) for n, r in roots.items()
                                for s in names}}), flush=True)

    def turns(fn, timer=cuda_ms) -> dict:
        """Each other version timed in turns with this checkout's: other, this, this, other."""
        out = {}
        for o in others:
            t = [timer(lambda: fn(n), reps=5, warmup=1) for n in (o, "change", "change", o)]
            out[o], out[f"change_vs_{o}"] = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        return out

    dev = torch.device("cuda", 0)
    results = []
    with torch.no_grad():
        for i, (name, bh, tq, tk, d, causal, dtype, padding) in enumerate(SHAPES):
            q, k, v = k2_inputs(bh, tq, tk, d, dtype, 10 + i, dev)
            scale = d**-0.5
            mask = (torch.arange(tk, device=dev)[None, :] < tk - tk // 8).expand(tq, tk).contiguous() if padding else None
            bias = None if mask is None else fa._as_bias(mask).contiguous()
            row = {"shape": name, "dims": [bh, tq, tk, d], "causal": causal, "dtype": str(dtype).split(".")[-1],
                   "padding_mask": padding}
            backward = not args.fwd_only and (name.startswith("step") or name.startswith("bench"))
            if args.bwd_only and not backward:
                continue
            for source, label in () if args.bwd_only else ((FWD[0], "k2"), (PIPELINED[0], "k3")):
                outs = {n: v_.forward(source, q, k, v, causal, scale, bias) for n, v_ in ver.items()}
                row[f"{label}_bits_equal"] = {o: all(torch.equal(a, b) for a, b in zip(outs[o], outs["change"]))
                                              for o in others}
                row[f"{label}_vs_plain"] = {n: plain_err(q, k, v, causal, bias, *o) for n, o in outs.items()}
                del outs
                row[f"{label}_ms"] = turns(lambda n: ver[n].forward(source, q, k, v, causal, scale, bias))
            q4, k4, v4 = (t.view(bh // 8, 8, t.shape[1], d) for t in (q, k, v))
            if not args.bwd_only:
                row["library_ms"] = cuda_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, is_causal=causal),
                    reps=5, warmup=1)
            if backward:
                o, lse = ver["change"].forward(FWD[0], q, k, v, causal, scale)
                do = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(600), device=dev).to(dtype)
                grads = {}
                for n, v_ in ver.items():
                    dd = v_.d_pass(o, do)
                    grads[n] = (dd, v_.dq(q, k, v, do, lse, dd, causal, scale), *v_.dkv(q, k, v, do, lse, dd, causal, scale))
                row["bwd_bits_equal"] = {o_: all(torch.equal(a, b) for a, b in zip(grads[o_], grads["change"]))
                                         for o_ in others}
                if dtype != torch.float32:
                    row["bwd_share_from_plain"] = {n: bwd_share(q, k, v, o, do, lse, causal, g[1:]) for n, g in grads.items()}
                dd = grads["change"][0]
                del grads
                # D is shorter than its host launch: its time with the enqueue taken out
                row["d_ms"] = turns(lambda n: ver[n].d_pass(o, do), queued_ms)
                row["k4_ms"] = turns(lambda n: ver[n].dq(q, k, v, do, lse, dd, causal, scale))
                row["k5_ms"] = turns(lambda n: ver[n].dkv(q, k, v, do, lse, dd, causal, scale))
                with torch.enable_grad():
                    leaves = [t.view(q4.shape[0], 8, t.shape[1], d).clone().requires_grad_() for t in (q, k, v)]
                    out = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=causal)
                    g4 = do.view(out.shape)
                    row["library_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(out, leaves, g4, retain_graph=True),
                                                    reps=5, warmup=1)
                    del leaves, out, g4
                del o, lse, do
            print(json.dumps(row), flush=True)
            results.append(row)
            del q, k, v, q4, k4, v4
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as fh:
            json.dump({"nvidia_smi": smi, "results": results}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
