"""The port's communication planner against heat_tpu's: the same plan, variant and modelled
byte counts for every split pair, dtype pair and value of ``HEAT_TPU_LINALG_PLAN``, on a
three- and an eight-rank communicator; a ring or reduce-scatter plan that fails raises
instead of giving way to another plan; and the collectives at one rank.

The port's communicators here report a size without a process group (planning reads only
the size and the chunk rule), so no rank is spawned; tests/test_torch_distributed.py runs
the plans themselves on three gloo ranks.
"""

import numpy as np
import pytest
import torch

import jax

from heat_tpu.core import _executor
from heat_tpu.core import factories as jfactories
from heat_tpu.core.communication import MeshCommunication
from heat_tpu.core.linalg import comm_plan as jplan

import heat_tpu_torch as htt
from heat_tpu_torch.core.communication import TorchCommunication
from heat_tpu_torch.core.linalg import comm_plan

SPLITS = (None, 0, 1)
KNOBS = ("auto", "xla", "ring", "rs", "bogus")
DTYPES = {  # (a, b): the product's numpy promotion sets the rs and all-reduce byte counts
    "f32": (np.float32, np.float32),
    "f64_f32": (np.float64, np.float32),
    "i32_f32": (np.int32, np.float32),
    "i64": (np.int64, np.int64),
    "bool": (np.bool_, np.bool_),
}


class _Sized(TorchCommunication):
    """A communicator of ``size`` ranks seen from ``rank``, without a process group."""

    def __init__(self, size: int, rank: int = 0):
        super().__init__()
        self._size, self._rank = size, rank

    @property
    def size(self) -> int:
        return self._size

    @property
    def rank(self) -> int:
        return self._rank


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


@pytest.fixture
def knob(monkeypatch):
    """Set ``HEAT_TPU_LINALG_PLAN`` for both packages (heat_tpu memoises it)."""

    def set_(value):
        monkeypatch.setenv("HEAT_TPU_LINALG_PLAN", value)
        _executor.reload_env_knobs()

    yield set_
    monkeypatch.delenv("HEAT_TPU_LINALG_PLAN", raising=False)
    _executor.reload_env_knobs()


@pytest.fixture(scope="module")
def meshes():
    return {p: MeshCommunication(jax.devices()[:p]) for p in (3, 8)}


@pytest.mark.parametrize("size", [3, 8])
@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("knob_value", KNOBS)
def test_plan_equals_heat_tpu(meshes, knob, size, dtypes, knob_value):
    """``plan_matmul`` gives heat_tpu's Plan tuple for every (a.split, b.split) pair, on
    ragged shapes (7 × 5 @ 5 × 4 over 3 and 8 ranks)."""
    knob(knob_value)
    rng = np.random.default_rng(0)
    da, db = DTYPES[dtypes]
    a_np = (rng.standard_normal((7, 5)) * 3).astype(da)
    b_np = (rng.standard_normal((5, 4)) * 3).astype(db)
    comm = _Sized(size)
    seen = set()
    for sa in SPLITS:
        for sb in SPLITS:
            got = comm_plan.plan_matmul(htt.array(a_np, split=sa, comm=comm), htt.array(b_np, split=sb, comm=comm))
            want = jplan.plan_matmul(
                jfactories.array(a_np, split=sa, comm=meshes[size]), jfactories.array(b_np, split=sb, comm=meshes[size])
            )
            assert (None if got is None else tuple(got)) == (None if want is None else tuple(want)), (sa, sb)
            seen.add(None if got is None else got.kind)
    if dtypes == "bool":
        assert seen == {None}
    else:
        assert {"ring": {None, "ring", "xla"}, "rs": {None, "rs", "xla"}}.get(knob_value, seen) == seen
        assert None in seen and "xla" in seen


def test_knob_is_read_per_call(knob):
    a = htt.array(np.ones((6, 6), np.float32), split=0, comm=_Sized(3))
    b = htt.array(np.ones((6, 6), np.float32), split=1, comm=a.comm)
    knob("ring")
    assert comm_plan.plan_matmul(a, b).kind == "ring"
    knob("xla")
    assert comm_plan.plan_matmul(a, b).kind == "xla"
    knob("RS ")
    assert comm_plan.linalg_plan() == "rs"
    knob("nonsense")
    assert comm_plan.linalg_plan() == "auto"


def test_single_rank_plans_nothing():
    """At one rank the planner plans nothing and records nothing, as heat_tpu's does."""
    comm_plan.reset_counters()
    a = htt.array(np.ones((4, 4), np.float32), split=0)
    b = htt.array(np.ones((4, 4), np.float32), split=1)
    assert comm_plan.plan_matmul(a, b) is None
    assert htt.matmul(a, b).split == 0
    assert comm_plan.COUNTERS == {}


def _raise(*args, **kwargs):
    raise RuntimeError("collective failed")


@pytest.mark.parametrize("pair,knob_value,collective", [
    ((0, 1), "auto", "ring_shift"),
    ((0, 0), "ring", "ring_shift"),
    ((1, 1), "auto", "ring_shift"),
    ((1, 0), "rs", "reduce_scatter"),
    ((None, 0), "rs", "reduce_scatter"),
])
def test_failing_plan_raises(knob, monkeypatch, pair, knob_value, collective):
    """A ring or rs plan whose collective fails raises: no fallback to another plan, to
    gathering, or to the CPU; nothing is counted."""
    knob(knob_value)
    comm = _Sized(3)
    monkeypatch.setattr(comm, collective, _raise)
    monkeypatch.setattr(comm, "all_gather", _raise)
    monkeypatch.setattr(comm, "all_reduce", _raise)
    rng = np.random.default_rng(1)
    a = htt.array(rng.standard_normal((7, 5)).astype(np.float32), split=pair[0], comm=comm)
    b = htt.array(rng.standard_normal((5, 4)).astype(np.float32), split=pair[1], comm=comm)
    comm_plan.reset_counters()
    with pytest.raises(RuntimeError, match="collective failed"):
        htt.matmul(a, b)
    assert comm_plan.COUNTERS == {}


def test_collectives_at_one_rank():
    comm = htt.get_comm()
    t = torch.arange(12.0).reshape(3, 4)
    assert comm.ring_shift(t, 1) is t
    assert comm.ring_shift(t, 1, async_op=True).wait() is t
    assert comm.all_to_all(t, 0, 1) is t
    assert comm.reduce_scatter(t, 0) is t
    with pytest.raises(ValueError):
        comm.ring_shift(t, 1, recv_shape=(2, 4))
