"""Single-rank parity of the array API cases: the port as one rank against heat_tpu on
the test mesh's devices (tests/_torch_array_cases.py)."""

from _torch_array_cases import AT_NONE, CASES, Arrays, rtol_of, splits_of

import heat_tpu as ht

import heat_tpu_torch as htt
from heat_tpu_torch.testing import assert_record_equal, port_record, tpu_record


def cases(prefixes):
    """(name, split) of the cases whose names start with one of ``prefixes``."""
    return [(n, s) for n in CASES if n.startswith(tuple(prefixes)) for s in splits_of(n)]


def check(name, split):
    """The case's port result equals heat_tpu's: values (exact, or within the case's
    tolerance, ``rtol_of``), dtype, gshape and split (for the cases in AT_NONE, heat_tpu's
    result at split=None in values, dtype and gshape)."""
    htt.use_device("cpu")
    want = CASES[name](ht, Arrays(ht), None if name in AT_NONE else split)
    got = CASES[name](htt, Arrays(htt), split)
    want, got = (want if isinstance(want, tuple) else (want,)), (got if isinstance(got, tuple) else (got,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if name in AT_NONE:
            w = {k: v for k, v in tpu_record(w).items() if k in ("value", "dtype", "gshape")}
        assert_record_equal(port_record(g), w, rtol=rtol_of(name), what=name)
