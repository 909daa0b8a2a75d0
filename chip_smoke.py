#!/usr/bin/env python3
"""Drive heat_tpu_torch's main path on one CUDA card and check it end to end.

    python3 chip_smoke.py [--json-out FILE]   # KMeans.fit on 10,000,000 x 64 f32, k = 8

The sizes are fixed (N, D, K, MAX_ITER, SEED below): every run is the main path's.

Phases, one line each:
  1. the card: nvidia-smi's name and power limit, and torch's device name;
  2. build every ported kernel from the sources in this checkout (one nvcc per source,
     all started together), with the compiler's register/shared-memory summary;
  3. north-star #1: ``arange(10, split=0).sum()`` on the card is 45;
  4. each kernel against its plain PyTorch version and against float64 on the card, at
     the main path's shape and data and at ragged shapes, each also on data rounded to
     integers (where nothing rounds, so the sums must be exact), and bit-identical
     across two runs;
  5. the main path, ``KMeans.fit`` at 10M x 64, k = 8, ``max_iter=30``, ``tol=-1``,
     split=0 (the configuration of bench.py's KMeans benchmark): launch counts are zeroed
     just before it and read just after; the result is checked against the blobs' true
     centers and, on a small input, against the port's CPU path; then the fit is timed
     (best of 2 after the counted run, which is its warm-up);
  6. one JSON line listing every ported kernel with its launches on the path, its time,
     its bound on this card, its plain version's time and a library call's time;
  7. the last line, ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script then exits non-zero without the last line. It
also fails when CUDA is not available or when the heat_tpu_torch package is not beside
it. It imports nothing of JAX or heat_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# the main path: bench.py's KMeans configuration (bench.py:155-160), data from this seed
N, D, K, MAX_ITER, SEED = 10_000_000, 64, 8, 30, 0

# NVIDIA's data sheet for the H100 SXM (dense float32 outside the tensor cores, HBM3); a
# kernel's bound is taken against these, so the script refuses any other card
CARD = "H100 80GB HBM3"
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

U32, U64 = 2.0**-24, 2.0**-53  # unit roundoff of float32 and float64


def gamma(h: int, u: float = U32) -> float:
    """Higham's bound h·u / (1 − h·u) on the relative error of h roundings in a row."""
    return h * u / (1.0 - h * u)


def check(ok, message) -> None:
    """Fail the run: a check that, unlike ``assert``, ``python -O`` does not remove."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {message}")


def phase(name: str, **fields) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


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


def blobs(n: int, d: int, k: int, seed: int, device):
    """Gaussian blobs made on the device from a seeded generator: true centers ~ N(0, 2²),
    unit noise, and initial centers at the true ones plus N(0, 0.5²) noise."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    true = 2.0 * torch.randn(k, d, generator=gen, device=device)
    y = torch.randint(0, k, (n,), generator=gen, device=device)
    x = torch.randn(n, d, generator=gen, device=device)
    x += true[y]
    init = (true + 0.5 * torch.randn(k, d, generator=gen, device=device)).contiguous()
    return x, init, true


def check_k1(k1, x, c, exact: bool) -> dict:
    """K1 against its plain version and against float64 on the same card and inputs.

    Against the plain version: labels may differ only on near-ties (the two smallest d²
    within 1e-5·(|x|²+|c|²)), on at most 1e-6·n rows; counts must agree once those rows
    are moved to the kernel's label; sse within rtol 1e-5.

    Against float64 sums of the same rows grouped by the kernel's labels (a reference
    with no order of its own to speak of): each row's contribution passes through at
    most h fp32 roundings in the kernel (its warp's sequential sum, the fold of the
    block's warps, the sum over blocks), so the sums may be off by γ_h·Σ|x| and no more;
    sse adds each row's error of the quadratic expansion.

    ``exact`` data are small integers: then no product or partial sum rounds, labels and
    counts must equal the plain version's and the sums the float64 ones bit for bit, so
    a row that is dropped or added twice shows at any size. Two runs must be identical.
    """
    import torch

    n, d = x.shape
    k = c.shape[0]
    labels, packed = k1.fused_assign_update_packed(x, c)
    labels2, packed2 = k1.fused_assign_update_packed(x, c)
    torch.cuda.synchronize()
    check(torch.equal(labels, labels2) and torch.equal(packed, packed2), "K1 is not deterministic")
    sums, counts, sse = k1.unpack(packed, k, d)

    # labels, counts and sse against the plain version
    l0, _, n0, e0 = k1.fused_assign_update_reference(x, c)
    rows = torch.nonzero(labels != l0).flatten()
    check(not (exact and rows.numel()), f"{rows.numel()} labels differ from the plain version on exact data")
    if rows.numel():
        xr = x[rows].double()
        d2 = ((xr[:, None, :] - c.double()[None]) ** 2).sum(-1)
        two = torch.topk(d2, 2, dim=1, largest=False).values
        scale = (xr * xr).sum(1) + (c.double() ** 2).sum(1).max()
        check(bool(((two[:, 1] - two[:, 0]) <= 1e-5 * scale).all()), "K1 disagrees on a row that is no near-tie")
    check(rows.numel() <= 1e-6 * n, f"{rows.numel()} near-tie rows exceed 1e-6·n")
    ones = torch.ones(rows.numel(), device=x.device)
    n0 = n0.index_add(0, l0[rows], ones, alpha=-1.0).index_add(0, labels[rows], ones)
    check(torch.equal(counts, n0), "K1 counts disagree with the plain version")
    sse_rel = abs(float(sse) - float(e0)) / max(abs(float(e0)), 1e-30)
    check(sse_rel <= 1e-5, f"K1 sse disagrees with the plain version: rel err {sse_rel}")

    # sums and sse against float64, within the kernel's own rounding
    blocks, warps = k1.grid_blocks(n, d, k, x.device)
    slots = blocks * warps  # row r is summed by warp r % slots, sequentially
    fold = warps + blocks
    h_sums = int(torch.bincount(torch.arange(n, device=x.device) % slots * k + labels, minlength=slots * k).max()) + fold
    h_sse = -(-n // slots) + fold
    lab = labels.long()
    x64, c64 = x.double(), c.double()
    sums64 = torch.zeros(k, d, dtype=torch.float64, device=x.device).index_add_(0, lab, x64)
    abs64 = torch.zeros_like(sums64).index_add_(0, lab, x64.abs())
    err = (sums.double() - sums64).abs()
    tol = (gamma(h_sums) + gamma(n, U64)) * abs64 + 1e-30
    if exact:
        check(float(abs64.max()) < 2**24, "exact data: a partial sum could round")
        check(torch.equal(sums.double(), sums64), f"K1 sums are not exact on exact data: max err {float(err.max())}")
    check(bool((err <= tol).all()), f"K1 sums off float64 by {float(err.max())}, worst err/tol {float((err / tol).max())}")
    sse64 = float(torch.stack([((x64 - c64[j]) ** 2).sum(1) for j in range(k)], 1).amin(1).sum())
    # a row's d² = max(|x|²+|c|²−2x·c, 0): per lane ceil(d/32) FMAs, 5 butterfly adds, 2 more
    row_err = gamma(-(-d // 32) + 7) * float(((x64.norm(dim=1) + c64.norm(dim=1).max()) ** 2).sum())
    sse_tol = row_err + (gamma(h_sse) + gamma(n, U64)) * (sse64 + row_err)
    sse_err = abs(float(sse) - sse64)
    check(sse_err <= sse_tol, f"K1 sse off float64 by {sse_err}, tolerance {sse_tol}")
    return {
        "max_abs_err": float(err.max()),
        "sums_err_over_tol": float((err / tol).max()),
        "sse_err_over_tol": sse_err / sse_tol,
        "sse_rel_err_vs_plain": sse_rel,
        "near_tie_rows": int(rows.numel()),
        "h_sums": h_sums,
        "h_sse": h_sse,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json-out", default=None, help="also write the kernels line and the fit's numbers here")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import heat_tpu_torch as ht
        from heat_tpu_torch.core import kernels
        from heat_tpu_torch.core.kernels import _nvcc
    except ImportError as exc:
        print(f"chip_smoke: the heat_tpu_torch package is not beside this script ({exc})", file=sys.stderr)
        return 2
    k1 = kernels.kmeans
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ht.use_device("gpu")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    check(CARD in name, f"the bounds are for the {CARD}; torch names {name!r}")
    phase("card", torch_name=repr(name), count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build every kernel, one nvcc per source, all at once (as later kernels are added)
    t0 = time.perf_counter()
    sources = {kname: mod.SOURCE for kname, mod in kernels.KERNELS.items()}
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        builds = dict(zip(sources, pool.map(_nvcc.build, sources.values())))
    for kname, b in builds.items():
        ptxas = [ln.strip() for ln in b["log"].splitlines() if "registers" in ln or "spill" in ln]
        phase("build", kernel=kname, built=b["built"], nvcc_s=f"{b['seconds']:.2f}", ptxas=json.dumps(ptxas))
    phase("build", total_s=f"{time.perf_counter() - t0:.2f}")
    lib = k1._lib()
    check(
        lib.kmeans_assign_smem_bytes(D, K) == k1.smem_bytes(D, K),
        "the wrapper's shared-memory size disagrees with the kernel source",
    )

    # 3. north-star #1 on the card
    s = ht.arange(10, split=0).sum()
    check(s.larray.is_cuda and s.dtype is ht.int64 and s.item() == 45, f"north-star #1 gave {s}")
    phase("north_star_1", value=s.item(), dtype=s.dtype.__name__, device=str(s.larray.device))

    # 4. K1 against its plain version and float64 on the card, on the main path's data and
    #    on exact (rounded to integers) data, at the main path's shape and ragged ones
    x, init, true = blobs(N, D, K, SEED, dev)
    checks = {}
    for n, d, k in [(N, D, K), (130, 10, 3), (1500, 7, 5)]:
        if n == N:
            xs, cs = x, init
        else:
            gen = torch.Generator(device=dev).manual_seed(SEED + n)
            xs = torch.randn(n, d, generator=gen, device=dev)
            cs = torch.randn(k, d, generator=gen, device=dev)
        for exact in (False, True):
            data = "exact" if exact else "float"
            got = check_k1(k1, torch.round(xs), torch.round(cs), exact) if exact else check_k1(k1, xs, cs, exact)
            checks[(n, d, k, data)] = got
            phase("k1_vs_plain_and_f64", shape=f"{n}x{d}x{k}", data=data, **got, deterministic=True)
        del xs, cs
    torch.cuda.empty_cache()

    # 5. the main path: KMeans.fit at the benchmark's configuration
    X = ht.array(x, split=0)
    km = ht.cluster.KMeans(n_clusters=K, init=ht.array(init), max_iter=MAX_ITER, tol=-1.0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    km.fit(X)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(km.n_iter_ == MAX_ITER, f"the fit ran {km.n_iter_} iterations")
    check(counts["kmeans_assign"] == MAX_ITER + 1, f"launches on the main path: {counts}")
    for kname, c in counts.items():
        check(c > 0, f"kernel {kname} was not launched on the main path")
    centers = km.cluster_centers_.larray
    labels = km.labels_.larray
    check(centers.shape == (K, D) and centers.is_cuda and bool(torch.isfinite(centers).all()), "fitted centers")
    check(labels.shape == (N,) and labels.dtype == torch.int64 and labels.is_cuda, "fitted labels' shape/type")
    check(bool(((labels >= 0) & (labels < K)).all()), "a fitted label is out of range")
    inertia = km.inertia_
    per_row = inertia / N
    check(0.9 * D < per_row < 1.1 * D, f"inertia per row {per_row}, expected ~{D} for unit noise")
    center_err = float((centers - true).abs().max())
    # a cluster mean of ~n/k unit-noise rows: 6 standard errors
    check(center_err < 6.0 / (N / K) ** 0.5, f"fitted centers are {center_err} from the blobs' true centers")
    # the same fit on a small input: the kernel path on the card against the CPU path
    xs, cs, _ = blobs(4096, D, K, SEED + 1, dev)
    on_card = ht.cluster.KMeans(n_clusters=K, init=ht.array(cs), max_iter=10).fit(ht.array(xs, split=0))
    on_cpu = ht.cluster.KMeans(n_clusters=K, init=ht.array(cs.cpu(), device="cpu"), max_iter=10).fit(
        ht.array(xs.cpu(), split=0, device="cpu")
    )
    check(on_card.n_iter_ == on_cpu.n_iter_, "small fit: iterations differ between card and CPU")
    check(torch.equal(on_card.labels_.larray.cpu(), on_cpu.labels_.larray), "small fit: labels differ between card and CPU")
    torch.testing.assert_close(on_card.cluster_centers_.larray.cpu(), on_cpu.cluster_centers_.larray, rtol=0, atol=1e-4)
    phase(
        "kmeans_fit", n=N, d=D, k=K, n_iter=km.n_iter_, launches=json.dumps(counts), inertia=repr(inertia),
        center_err=center_err, small_fit_matches_cpu=True,
    )
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        km.fit(X)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    fit_s = min(walls)
    phase("kmeans_fit_time", best_of_2_s=repr(fit_s), per_iteration_ms=repr(1e3 * fit_s / (MAX_ITER + 1)))

    # 6. every ported kernel: launches on the path, time, bound, plain version's time
    ms = cuda_ms(lambda: k1.fused_assign_update_packed(x, init), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: k1.fused_assign_update_reference(x, init), reps=5, warmup=1)
    nbytes = 4 * (N * D + K * D) + 4 * N + 4 * (K * D + K + 1)  # x, centers in; labels, record out
    flops = 2 * N * K * D + 3 * N * D + 4 * N * K  # dots, |x|² and sums, d² and compare
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    flops_ms = 1e3 * flops / PEAK_FP32_FLOPS
    line = {
        "kernels": [
            {
                "name": "kmeans_assign",
                "route": "cuda",
                "source": "heat_tpu_torch/core/kernels/csrc/kmeans_assign.cu",
                "replaces": "heat_tpu/core/kernels/kmeans.py:44",
                "launches": counts["kmeans_assign"],
                "max_abs_err": checks[(N, D, K, "float")]["max_abs_err"],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, flops_ms),
                "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
                "library_ms": None,
                "library_note": "no single PyTorch call computes labels, sums, counts and sse together",
                "max_abs_err_of": "sums against float64 sums of the same rows grouped by the kernel's labels",
                "err_over_tol": checks[(N, D, K, "float")]["sums_err_over_tol"],
                "shape": [N, D, K],
                "achieved_bytes_per_s": nbytes / (ms * 1e-3),
            }
        ]
    }
    print(json.dumps(line), flush=True)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as fh:
            json.dump({"nvidia_smi": smi, **line, "fit_best_of_2_s": fit_s, "fit_walls_s": walls,
                       "inertia": inertia, "checks": {"x".join(map(str, key)): v for key, v in checks.items()}}, fh, indent=1)

    # 7. the last line
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
