"""Hold the port against heat_tpu on the same numpy inputs.

The tests compare each ported function with heat_tpu's: the same numpy data go into both,
and the results must agree in their global values, dtype, global shape, split and, where
both run on the same number of ranks, lshape map. This module imports neither JAX nor
heat_tpu: heat_tpu's results are read through what every DNDarray offers (``numpy()``,
``dtype.__name__``, ``gshape``, ``split``, ``comm.size`` and ``comm.lshape_map``), and
heat_tpu's array factory comes from the caller.

    from functools import partial
    import heat_tpu
    check = partial(assert_port_equal, tpu_array=heat_tpu.array)
    check(heat_tpu.matmul, ht.matmul, [a, b], [0, 1], rtol=1e-5)

Results computed on other ranks travel as records (:func:`port_record`, dicts of numpy
arrays) and are compared with :func:`assert_record_equal`.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from .interop import dndarray_from_numpy

__all__ = ["assert_port_equal", "assert_record_equal", "port_record", "tpu_record"]


def _record(value, dtype, gshape, split, lshape_map, size) -> dict:
    return {
        "value": np.asarray(value),
        "dtype": np.array(dtype),
        "gshape": np.array(gshape, dtype=np.int64),
        "split": np.array(-1 if split is None else split),
        "lshape_map": np.asarray(lshape_map, dtype=np.int64),
        "size": np.array(size),
    }


def port_record(x) -> dict:
    """A port DNDarray's global value and metadata as numpy (a plain value: the value
    alone)."""
    if not hasattr(x, "lshape_map"):
        return {"value": np.asarray(x)}
    return _record(x.numpy(), x.dtype.__name__, x.gshape, x.split, x.lshape_map().numpy(), x.comm.size)


def tpu_record(x) -> dict:
    """The same record of a heat_tpu DNDarray (or a plain value)."""
    if not hasattr(x, "gshape"):
        return {"value": np.asarray(x)}
    return _record(np.asarray(x.numpy()), x.dtype.__name__, x.gshape, x.split, x.comm.lshape_map(x.gshape, x.split), x.comm.size)


def assert_record_equal(port: dict, tpu, rtol: float = 1e-5, atol: float = 0.0, what: str = "") -> None:
    """Assert that a port record equals a heat_tpu result (or its record): values within
    ``rtol``/``atol``, and dtype, global shape, split and (on equal rank counts) lshape
    map equal."""
    want = tpu if isinstance(tpu, dict) else tpu_record(tpu)
    np.testing.assert_allclose(port["value"], want["value"], rtol=rtol, atol=atol, err_msg=f"{what} values")
    if "dtype" not in want:
        return
    for key in ("dtype", "gshape", "split"):
        if key in want:  # a record cut to the keys a comparison holds
            np.testing.assert_array_equal(port[key], want[key], err_msg=f"{what} {key}")
    if "size" in want and int(port["size"]) == int(want["size"]):
        np.testing.assert_array_equal(port["lshape_map"], want["lshape_map"], err_msg=f"{what} lshape map")


def assert_port_equal(
    tpu_fn: Callable,
    torch_fn: Callable,
    inputs: Sequence[np.ndarray],
    splits: Sequence[Optional[int]],
    *,
    tpu_array: Callable,
    rtol: float = 1e-5,
    atol: float = 0.0,
    tpu_kwargs: Optional[dict] = None,
) -> None:
    """Run ``torch_fn`` on port DNDarrays and ``tpu_fn`` on heat_tpu DNDarrays (made by
    ``tpu_array(x, split=s, **tpu_kwargs)``) of the same ``inputs`` and ``splits``, and
    assert that the results (one, or a tuple taken pairwise) agree by
    :func:`assert_record_equal`."""
    port_args = [dndarray_from_numpy(x, split=s) for x, s in zip(inputs, splits)]
    tpu_args = [tpu_array(x, split=s, **(tpu_kwargs or {})) for x, s in zip(inputs, splits)]
    got, want = torch_fn(*port_args), tpu_fn(*tpu_args)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want), f"{len(got)} results against heat_tpu's {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert_record_equal(port_record(g), w, rtol=rtol, atol=atol, what=f"result {i}")
