"""Each driver at a tiny size on the CPU against its plain reference: a sound run is correct,
and a run whose timed path is broken underneath is not, once for each fault the cell can
have (a step that returns its state unchanged, half of the batch left out with the mean
taken over the rest, an answer altered where it is produced: a label, a stale loss; a second
step that applies the first step's gradient again; one card, so no exchange between cards
to leave out). Then the controls: the reference in the
precision below the configuration's fails the cell's limits, the bfloat16 one at a size the
CPU holds, the TF32 one at the cell's own size on the card (it needs cuBLAS)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _tiny import run_tiny, tiny_cell
from portbench.lib import spec
from heat_tpu_torch.cluster import kmeans as km_mod
from heat_tpu_torch.optim import dp_optimizer

ROOT = Path(__file__).resolve().parent.parent.parent


def _kmeans_unchanged(monkeypatch):
    real = km_mod.KMeans._pass

    def frozen(self, xv, centers, rows, step, update=True):
        labels, new, sse = real(self, xv, centers, rows, step, update)
        return labels, (centers if update else new), sse

    monkeypatch.setattr(km_mod.KMeans, "_pass", frozen)


def _kmeans_half_batch(monkeypatch):
    real = km_mod.KMeans._pass

    def half(self, xv, centers, rows, step, update=True):
        return real(self, xv[: xv.shape[0] // 2] if update else xv, centers, rows, step, update)

    monkeypatch.setattr(km_mod.KMeans, "_pass", half)


def _kmeans_altered_answer(monkeypatch):
    real = km_mod.KMeans.fit

    def altered(self, x):
        real(self, x)
        labels = self._labels.larray
        labels[0] = (labels[0] + 1) % self.n_clusters
        return self

    monkeypatch.setattr(km_mod.KMeans, "fit", altered)


def _train_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _train_half_batch(monkeypatch):
    real = dp_optimizer.DataParallelOptimizer._reduced_step

    def half(self, loss_fn, local, weight, comm, rows=None):
        return real(self, loss_fn, tuple(t[: t.shape[0] // 2] for t in local), weight, comm, rows)

    monkeypatch.setattr(dp_optimizer.DataParallelOptimizer, "_reduced_step", half)


def _train_stale_loss(monkeypatch):
    real = dp_optimizer.DataParallelOptimizer.step
    returned = []

    def stale(self, loss_fn=None, *batch):
        loss = real(self, loss_fn, *batch)
        returned.append(loss)
        return returned[-2] if len(returned) > 1 else loss

    monkeypatch.setattr(dp_optimizer.DataParallelOptimizer, "step", stale)


def _train_stale_gradient(monkeypatch):
    real = torch.optim.Adam.step
    first = []

    def stale(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"]]
        if not first:
            first.extend(p.grad.clone() for p in params)
        elif len(first) == len(params):  # the second step applies the first step's gradient again
            for p, g in zip(params, first):
                p.grad = g.clone()
            first.append(None)
        return real(self, closure)

    monkeypatch.setattr(torch.optim.Adam, "step", stale)


FAULTS = {
    "kmeans-lloyd": [_kmeans_unchanged, _kmeans_half_batch, _kmeans_altered_answer],
    "s2s-train-4096": [_train_unchanged, _train_half_batch, _train_stale_loss, _train_stale_gradient],
}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_a_sound_run_is_correct(cell):
    line = run_tiny(cell)
    assert line["correct"] is True, line["compared"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in sorted(FAULTS.items()) for f in fs],
                         ids=lambda v: v if isinstance(v, str) else v.__name__.lstrip("_"))
def test_a_broken_run_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line = run_tiny(cell)
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("seed", [1, 2**31 + 11, 2**40 + 3])
def test_the_bfloat16_control_fails_the_kmeans_limits(seed):
    cell = tiny_cell("kmeans-lloyd")
    cell.config = {**cell.config, "n_samples": 20_000}
    readings = cell.driver().calibrate(cell, seed, torch.device("cpu"))
    for name, numbers in readings.items():
        assert any(numbers[k] > cell.limits[k] for k in numbers), (name, numbers)


@pytest.mark.card
def test_the_tf32_control_fails_the_training_limits(card):
    cell = spec.cell("s2s-train-4096")  # the cell's own size: the control reads ~3x the program there
    try:
        for seed in (1, 2, 3):
            readings = cell.driver().calibrate(cell, seed, card)
            for name, numbers in readings.items():
                if not name.startswith("reading_"):
                    assert any(numbers[k] > cell.limits[k] for k in numbers), (name, numbers)
    finally:
        torch.cuda.empty_cache()  # the runs below are processes of their own on the same card


@pytest.mark.card
@pytest.mark.parametrize("cell", ["kmeans-lloyd", "s2s-train-4096"])
def test_each_cell_runs_correct_on_the_card(card, cell):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2**31 + 77),
                           "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
