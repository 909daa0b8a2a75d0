"""Measurement of the package's kernels on a card, shared by ``chip_smoke.py`` and the
scripts in ``tools/``: what a build holds (ptxas registers and spill bytes, the SASS of
each kernel instance and its opcode mix), CUDA-event timing, and the flash forward's test
inputs and tolerance. Nothing in the package itself calls it.
"""

from __future__ import annotations

import collections
import os
import re
import statistics
import subprocess

from . import _nvcc

__all__ = ["FWD_SHARE_16", "cuda_ms", "demangle", "fwd16_err", "fwd_err", "k2_inputs", "ptxas_summary", "queued_ms",
           "sass", "sass_counts"]

# The 16-bit rule of the flash forward: |got − ref| ≤ u·|ref| + s·max|ref| for every element of
# O, u one unit in the last place of the type (its own rounding) and s this share of the
# largest |O|, for the terms whose P rounded the other way. The bf16 and f16 K2 and K3 round P
# relative to the running maximum of each 64-key tile, as heat_tpu's kernels do relative to
# theirs, and the plain K2 relative to the whole row's; the share is the largest that
# heat_tpu's own interpret-mode kernel needs against the plain K2, 1.4488e-3 (bf16) and
# 2.187e-4 (f16) of max|O| (tests/test_torch_flash_fwd_bf16.py, which asserts this table
# equal to its own)
FWD_SHARE_16 = {"bfloat16": 1.449e-3, "float16": 2.187e-4}
_ULP_16 = {"bfloat16": 2.0**-7, "float16": 2.0**-10}

# one SASS instruction: its address, its opcode (predicate dropped, up to the first dot)
# and its operands
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T]+\s+)?([A-Z][A-Z0-9_]*)\S*\s*([^;]*);")


def _toolkit(tool: str) -> str | None:
    """A program of the CUDA toolkit beside nvcc; None without a toolkit."""
    try:
        return os.path.join(os.path.dirname(_nvcc.nvcc_path()), tool)
    except RuntimeError:
        return None


def demangle(names: list) -> list:
    """C++ names of compiled kernels, without their parameter lists, by the toolkit's
    cu++filt or the system's c++filt; the mangled names where neither runs."""
    for tool in (_toolkit("cu++filt"), "c++filt"):
        if tool is None:
            continue
        try:
            out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True, timeout=60)
        except OSError:
            continue
        lines = out.stdout.splitlines()
        if out.returncode == 0 and len(lines) == len(names):
            return [ln.replace("(int)", "").split("(")[0].replace("__nv_bfloat16", "bf16").replace("__half", "f16")
                    for ln in lines]
    return list(names)


def ptxas_summary(log: str) -> list:
    """[name, registers, spill store bytes, spill load bytes] of each kernel instance, from
    the ``-Xptxas -v`` log of a build."""
    rows = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            rows.append([m.group(1), None, None, None])
        elif rows and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            rows[-1][2:] = [int(m.group(1)), int(m.group(2))]
        elif rows and (m := re.search(r"Used (\d+) registers", ln)):
            rows[-1][1] = int(m.group(1))
    for row, name in zip(rows, demangle([r[0] for r in rows])):
        row[0] = name
    return rows


def sass(library) -> dict:
    """{kernel instance: its SASS lines} of a built library, by the toolkit's
    ``cuobjdump -sass``, names demangled. Raises when there is no cuobjdump, when it fails
    and when it lists no kernel."""
    tool = _toolkit("cuobjdump")
    if tool is None or not os.path.isfile(tool):
        raise RuntimeError(f"no cuobjdump beside nvcc to read the SASS of {library}")
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass {library} failed ({out.returncode}): {out.stderr.strip()}")
    fns, fn = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            fns[fn] = []
        elif fn is not None:
            fns[fn].append(ln)
    if not fns:
        raise RuntimeError(f"cuobjdump -sass {library} lists no kernel")
    return dict(zip(demangle(list(fns)), fns.values()))


def sass_counts(lines: list) -> dict:
    """A kernel instance's SASS lines counted: its static instructions, its tensor-core
    (HMMA) instructions, the count of each opcode, and the same for the body of its
    largest loop (from a backward branch's target to the branch: one step of a flash
    kernel's main loop)."""
    ins = [(int(m.group(1), 16), m.group(2), m.group(3)) for ln in lines if (m := _INSTR.search(ln))]
    at = {a: i for i, (a, _, _) in enumerate(ins)}
    loop = None
    for i, (a, op, rest) in enumerate(ins):
        t = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if t and int(t.group(1), 16) <= a and int(t.group(1), 16) in at:
            j = at[int(t.group(1), 16)]
            if loop is None or i - j > loop[1] - loop[0]:
                loop = (j, i)

    def mix(part: list) -> dict:
        ops = collections.Counter(op for _, op, _ in part)
        return {"instructions": len(part), "hmma": ops["HMMA"], "opcodes": dict(ops.most_common())}

    return {**mix(ins), "loop": mix(ins[loop[0]:loop[1] + 1]) if loop else {}}


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms, each run between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms with the host's enqueue time taken out: each
    run's events and kernels are queued behind a sleep kernel of about 1 ms, so the card
    runs them back to back. For calls whose kernels take less time than the host takes to
    queue them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k2_inputs(bh, tq, tk, d, dtype, seed, device):
    """q (bh, tq, d), k and v (bh, tk, d) of ``dtype``, standard normal from ``seed``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(bh, t, d, generator=gen, device=device).to(dtype) for t in (tq, tk, tk))


def fwd_err(o, lse, ro, rl) -> tuple:
    """(max |ΔO|, max |ΔLSE|, worst err/tol) of a flash forward against another one:
    f32 O within rtol = atol = 2e-4, bf16/f16 O within one rounding (2⁻⁷ relative) plus
    2e-4, LSE within 2e-4."""
    import torch

    rtol = 2e-4 if o.dtype == torch.float32 else 2.0**-7
    do = (o.float() - ro.float()).abs()
    dl = (lse - rl).abs()
    worst = max(float((do / (2e-4 + rtol * ro.float().abs())).max()), float((dl / (2e-4 + 2e-4 * rl.abs())).max()))
    return float(do.max()), float(dl.max()), worst


def fwd16_err(o, lse, ro, rl) -> tuple:
    """(max |ΔO|, max |ΔLSE|, worst err/tol, share needed) of a bf16 or f16 flash forward
    against a reference: O by the 16-bit rule (``FWD_SHARE_16``), LSE within 2e-4 (absolute
    and relative); the share needed is the largest |ΔO| − u·|ref| over max|ref|."""
    name = str(o.dtype).split(".")[-1]
    ulp, share = _ULP_16[name], FWD_SHARE_16[name]
    ref = ro.float()
    err = (o.float() - ref).abs()
    top = float(ref.abs().max())
    dl = (lse - rl).abs()
    worst = max(float((err / (ulp * ref.abs() + share * top + 1e-30)).max()),
                float((dl / (2e-4 + 2e-4 * rl.abs())).max()))
    return float(err.max()), float(dl.max()), worst, float((err - ulp * ref.abs()).max()) / max(top, 1e-30)
