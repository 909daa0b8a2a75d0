"""Clustering fits back to back: one caller runs ``ht.cluster.KMeans(...).fit(X)`` on the
same data set, the next fit when the last has returned (a closed loop of one client).

Set-up makes X (split 0) and the initial centers on the device from the seed (the
configuration's ``blobs``), then runs ``traffic["warmup"]`` fits: the first loads (or, in
a fresh checkout, builds) the assignment kernel. The window's fits are sampled from the
seed (a reservoir of ``traffic["checked"]``); once the window has closed each sampled fit's
``cluster_centers_``, ``labels_``, ``inertia_`` and ``n_iter_`` are held to the plain
reference's Lloyd fit of the same X from the same centers, and the labels and the inertia
to what the reference reads on X from the fit's own centers.
"""

from __future__ import annotations

import random
import time

import torch
from torch.profiler import record_function

from portbench.lib import inputs

SPAN = "estimator.fit"


def compare(got: dict, ref: dict, judged: dict) -> dict:
    """The compared numbers of one fit against the reference's fit (``ref``) and against the
    reference's reading of the fit's own centers and labels on X (``judged``): the largest
    center coordinate's gap from the reference fit's over its largest coordinate; the reported
    inertia's relative gap from the objective that the fit's own centers give; the largest
    excess of a row's squared distance to its label's center over its nearest
    (``assign_excess``); the difference in updates applied. Labels are judged on X rather
    than matched to the reference's one by one, and the inertia against the fit's own
    centers: a fit that has not settled by its last update moves both far under any rounding
    (PERF.md)."""
    c, rc = got["centers"].double(), ref["centers"].to(got["centers"].device).double()
    return {
        "centers_gap": float((c - rc).abs().max() / rc.abs().max()),
        "inertia_gap": abs(got["inertia"] - judged["objective"]) / abs(judged["objective"]),
        "assign_excess": judged["assign_excess"],
        "n_iter_differ": float(abs(got["n_iter"] - ref["n_iter"])),
    }


class Driver:
    spans = (SPAN,)

    def __init__(self, cell, seed: int, device):
        import heat_tpu_torch as ht
        from heat_tpu_torch.core import kernels

        t0 = time.perf_counter()
        self.cell, self.device = cell, device
        cfg, traffic = cell.config, cell.traffic
        self.x, self.init = inputs.blobs(cfg, seed, device)
        self.X = ht.array(self.x, split=0, device=device)
        self.args = dict(n_clusters=cfg["n_clusters"], init=ht.array(self.init, device=device),
                         max_iter=cfg["max_iter"], tol=cfg["tol"])
        self.KMeans = ht.cluster.KMeans
        t1 = time.perf_counter()
        kernels.reset_launch_counts()
        for _ in range(traffic["warmup"]):
            self.n_iter = self.KMeans(**self.args).fit(self.X).n_iter_
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.phases = {"inputs_s": t1 - t0, "warmup_s": time.perf_counter() - t1,
                       "kernel_launches_warmup": {k: v for k, v in kernels.launch_counts().items() if v}}
        self.rng = random.Random(inputs.sub_seed(seed, 3))
        self.done = 0
        self.sample = []  # outputs of the fits checked after the window

    def iterate(self) -> None:
        km = self.KMeans(**self.args)
        with record_function(SPAN):
            km.fit(self.X)
        out = {"centers": km.cluster_centers_.larray, "labels": km.labels_.larray, "inertia": km.inertia_,
               "n_iter": km.n_iter_}
        # a reservoir sample of the window's fits, drawn from the seed
        keep = self.cell.traffic["checked"]
        if len(self.sample) < keep:
            self.sample.append(out)
        else:
            j = self.rng.randrange(self.done + 1)
            if j < keep:
                self.sample[j] = out
        self.done += 1

    def work(self) -> dict:
        """The updates a fit applies (the warm-up fit's: every fit of the cell starts alike)."""
        return {"n_iter": self.n_iter}

    def check(self, limits: dict) -> tuple:
        """Free the program's state, fit the reference once and hold every sampled fit to
        it: (the largest of each compared number, the sampled fits that failed one)."""
        del self.X, self.args
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref_mod = self.cell.reference()
        ref = ref_mod.fit(self.x, self.init, self.cell.config)
        worst, failed = None, 0
        for out in self.sample:
            numbers = compare(out, ref, ref_mod.judge(self.x, out["centers"], out["labels"]))
            failed += any(numbers[k] > limits[k] for k in numbers)
            worst = numbers if worst is None else {k: max(worst[k], v) for k, v in numbers.items()}
        if worst is None:
            raise RuntimeError("no fit finished in the window")
        return worst, failed


def calibrate(cell, seed: int, device) -> dict:
    """The compared numbers of the control and of each planted fault against the reference,
    at the cell's size: the reference reading X rounded to bfloat16 (the control: float32
    is what the configuration states), the means taken over half of the rows, updates that
    return the centers unchanged, and one label altered where it is produced."""
    ref_mod, cfg = cell.reference(), cell.config
    x, init = inputs.blobs(cfg, seed, device)
    ref = ref_mod.fit(x, init, cfg)
    altered = dict(ref, labels=ref["labels"].clone())
    altered["labels"][0] = (altered["labels"][0] + 1) % cfg["n_clusters"]

    def held(out):
        return compare(out, ref, ref_mod.judge(x, out["centers"], out["labels"]))

    return {
        "control_bf16": held(ref_mod.fit(x, init, cfg, x_dtype=torch.bfloat16)),
        "fault_half_batch": held(ref_mod.fit(x, init, cfg, update_rows=x.shape[0] // 2)),
        "fault_unchanged": held(ref_mod.fit(x, init, cfg, frozen=True)),
        "fault_altered_answer": held(altered),
    }
