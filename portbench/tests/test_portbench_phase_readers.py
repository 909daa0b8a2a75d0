"""The six readers of the program's phases and counters (``entry_ms.fit``,
``pass_issue_us.fit``, ``host_reads.fit``, ``forward_ms.train``, ``backward_ms.train``,
``update_ms.train``) on a store filled by hand in place of the program's profiler, and
silent without a trace, without device operations in it, with an empty store, and with a
program whose profiler keeps no phases."""

import sys
import types

import pytest

from portbench.lib import phases, spec, trace
from portbench.lib.harness import Run

STORE = {
    "spans": {
        "fit.entry": {"count": 12, "host_s": 0.0066, "device_s": None},
        "lloyd.pass": {"count": 360, "host_s": 0.0432, "device_s": None},
        "lloyd.assign": {"count": 360, "host_s": 0.018, "device_s": None},
        "fit.readback": {"count": 12, "host_s": 0.3, "device_s": None},
        "step.forward": {"count": 3, "host_s": 0.09, "device_s": 0.435},
        "step.backward": {"count": 3, "host_s": 0.12, "device_s": 1.086},
        "step.update": {"count": 3, "host_s": 0.003, "device_s": 0.0036},
    },
    "counters": {"lloyd.host_reads": 24.0},
}
FIT = ("entry_ms.fit", "pass_issue_us.fit", "host_reads.fit")
TRAIN = ("forward_ms.train", "backward_ms.train", "update_ms.train")


def _program(monkeypatch, store):
    module = types.ModuleType(phases.PROFILER)
    if store is not None:
        module.phases = lambda: store
    monkeypatch.setitem(sys.modules, phases.PROFILER, module)


def _run(iterations, device=True):
    dev = [("k", 0.0, 10.0)] if device else []
    t = trace.Trace(iterations=iterations, window_s=1.0, busy_s=1e-5 if device else 0.0, device=dev)
    return Run(config={}, traffic={}, setup_s=1.0, work={}, trace=t)


def test_readers_on_a_store_filled_by_hand(monkeypatch):
    _program(monkeypatch, STORE)
    fit, step = _run(12), _run(3)
    assert spec.reader("entry_ms.fit").read(fit) == pytest.approx(0.55)  # 6.6 ms over 12 fits
    assert spec.reader("pass_issue_us.fit").read(fit) == pytest.approx(120.0)  # 43.2 ms over 360 passes
    assert spec.reader("host_reads.fit").read(fit) == pytest.approx(2.0)
    assert spec.reader("forward_ms.train").read(step) == pytest.approx(145.0)
    assert spec.reader("backward_ms.train").read(step) == pytest.approx(362.0)
    assert spec.reader("update_ms.train").read(step) == pytest.approx(1.2)


@pytest.mark.parametrize("store", [STORE, {"spans": {}, "counters": {}}, None],
                         ids=["full store", "empty store", "no phases"])
def test_readers_are_silent_where_nothing_was_recorded(monkeypatch, store):
    _program(monkeypatch, store)
    for name in FIT + TRAIN:
        read = spec.reader(name).read
        assert read(Run(config={}, traffic={}, setup_s=1.0, work={})) is None  # no trace
        assert read(_run(3, device=False)) is None  # a trace without the card
        if store is not STORE:
            assert read(_run(3)) is None


def test_device_readers_are_silent_on_host_phases(monkeypatch):
    host_only = {"spans": {n: dict(t, device_s=None) for n, t in STORE["spans"].items()}, "counters": {}}
    _program(monkeypatch, host_only)
    for name in TRAIN:
        assert spec.reader(name).read(_run(3)) is None
    assert spec.reader("host_reads.fit").read(_run(12)) is None


def test_readers_are_silent_without_the_program(monkeypatch):
    monkeypatch.delitem(sys.modules, phases.PROFILER, raising=False)
    for name in FIT + TRAIN:
        assert spec.reader(name).read(_run(3)) is None
