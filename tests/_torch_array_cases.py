"""The array API's parity cases, shared by the single-rank tests and the three-rank spawn.

Each case is ``fn(m, arr, split)``: ``m`` is the package (heat_tpu or heat_tpu_torch),
``arr(name, split)`` makes that package's DNDarray of the named input below on the
communicator under test, and ``arr.kw`` holds the keywords that put a factory on it
(``comm=`` for heat_tpu's three-device mesh). The inputs are fixed numpy arrays made from a seed. A case
returns a DNDarray or a tuple of them. The cases in ``FLOAT`` compare within ``RTOL`` (a
float result summed or interpolated in another order), those in ``TOLERANCES`` within
their own; every other case is exact (``rtol_of``). The cases in ``AT_NONE`` hold the port
on every layout to heat_tpu's result at split=None.

Imports numpy only: the worker processes of the spawn import it beside the port alone.
"""

import numpy as np

_rng = np.random.default_rng(2024)


def _with_nan_and_ties(n):
    a = _rng.integers(0, 6, n).astype(np.float32)
    a[[2, 9]] = np.nan
    a[5] = -0.0
    return a


INPUTS = {
    "a": _rng.standard_normal((7, 5)).astype(np.float32),  # 3, 3, 1 rows on three ranks
    "small": _rng.standard_normal((2, 3)).astype(np.float32),  # the third rank holds nothing
    "cube": _rng.standard_normal((4, 7, 3)).astype(np.float32),
    "ints": _rng.integers(-4, 9, (7, 5)).astype(np.int32),
    "ties": _with_nan_and_ties(17),  # ties, two NaNs and a -0.0
    "ties2d": _rng.integers(0, 3, (9, 4)).astype(np.float64),
    "long": _rng.standard_normal(40).astype(np.float32),  # 14, 14, 12
    "vec": _rng.standard_normal(7).astype(np.float32),
    "bools": _rng.standard_normal((7, 5)) > 0.3,
    "pos": _rng.integers(0, 9, 13).astype(np.int64),
}
_centers = _rng.normal(0, 8, (3, 2))
# rows with NaN at the same places (one slice), a row of NaN, and their duplicates
INPUTS["nanrows"] = np.array([[1, np.nan], [0, 1], [1, np.nan], [0, 1], [np.nan, 0], [np.nan, np.nan], [1, 0]])
INPUTS["nan7"] = np.array([1, np.nan, -2, 0, np.nan, 5, -0.0], np.float32)
INPUTS["bools7"] = np.array([True, False, True, True, False, True, False])
INPUTS["div_x"] = np.array([3, -4, 5, 0, 7, -9, 2, -128])
INPUTS["div_y"] = np.array([0, 0, 0, 0, 2, -3, 0, 5])
INPUTS["blobs"] = (_centers[_rng.integers(0, 3, 30)] + _rng.normal(0, 0.5, (30, 2))).astype(np.float32)
# a mask that selects nothing in the first three rows (the first rank's chunk)
INPUTS["mask_a"] = INPUTS["a"] > 0.4
INPUTS["mask_a"][:3] = False
INPUTS["mask_vals"] = np.arange(100, 100 + INPUTS["mask_a"].sum(), dtype=np.float32)


def _complex(shape, dtype=np.complex64):
    """Real parts in halves from -1 to 1 (ties, so the imaginary parts order them), a -0.0."""
    c = (_rng.integers(-2, 3, shape) / 2 + 1j * _rng.standard_normal(shape)).astype(dtype)
    c.flat[3] = complex(-0.0, c.flat[3].imag)
    return c


# every dtype heat_tpu computes on: the sweep's inputs (bfloat16 is made from "a" by astype)
INPUTS["cplx"] = _complex((7, 5))
INPUTS["cplx_b"] = _complex((7, 5))
INPUTS["cplx_b"].flat[[4, 11, 30]] = [complex(np.nan, 1), complex(0.5, np.nan), complex(np.nan, np.nan)]
INPUTS["cplx128"] = _complex((7, 5), np.complex128)
INPUTS["cplx_round"] = (np.round(_complex((7, 5)) * 2) / 2).astype(np.complex64)  # repeated values
INPUTS["cplx_nan"] = np.array([1 + 2j, complex(np.nan, 0), complex(1, np.nan), 1 + 1j, -1 + 5j, 1 + 2j,
                               complex(np.nan, np.nan), 0 + 1j, complex(np.nan, -3), 2 + 0j, complex(0.0, -0.0),
                               complex(-0.0, 0.0), complex(-1, np.nan)], np.complex64)
INPUTS["u8"] = _rng.integers(0, 256, (7, 5)).astype(np.uint8)
INPUTS["i8"] = _rng.integers(-128, 128, (7, 5)).astype(np.int8)
INPUTS["i16"] = _rng.integers(-2000, 2000, (7, 5)).astype(np.int16)
INPUTS["f16"] = _rng.standard_normal((7, 5)).astype(np.float16)
INPUTS["bools_t"] = np.ascontiguousarray(INPUTS["bools"].T)
# integer products that wrap: int8 rows of k = 300 (100 · 100 · 300 overflows int8), int32
# entries near 2**20 (their products overflow int32)
INPUTS["mm_i8"] = _rng.integers(60, 128, (7, 300)).astype(np.int8)
INPUTS["mm_i8t"] = _rng.integers(60, 128, (300, 5)).astype(np.int8)
INPUTS["mm_i32"] = _rng.integers(2**19, 2**21, (7, 11)).astype(np.int32)
INPUTS["mm_i32t"] = _rng.integers(2**19, 2**21, (11, 5)).astype(np.int32)
# the split-axis forms: an integer cube (exact traces) and an integer vector (exact triangles)
INPUTS["icube"] = _rng.integers(-9, 9, (4, 7, 3)).astype(np.int64)
INPUTS["ivec"] = _rng.integers(-50, 50, 8).astype(np.int32)



def _set(x, key, value):
    x[key] = value
    return x


def _drawn(m, seed, draw):
    m.random.seed(seed)
    return draw()


def _kmeans(m, x):
    km = m.cluster.KMeans(n_clusters=3, init="random", random_state=4, max_iter=6, tol=-1.0).fit(x)
    return km.cluster_centers_, km.labels_


def _f64(m, arr, s):
    """"a" in float64 (sums in another order stay within RTOL of each entry)."""
    return arr("a", s).astype(m.float64)


class Arrays:
    """``arr(name, split)``: the named input as a DNDarray of ``m`` made with ``kw``."""

    def __init__(self, m, **kw):
        self.m, self.kw = m, kw

    def __call__(self, name, split):
        return self.m.array(INPUTS[name], split=split, **self.kw)


CASES = {
    # manipulations
    "reshape": lambda m, arr, s: m.reshape(arr("a", s), (5, 7)),
    "reshape_new_split0": lambda m, arr, s: m.reshape(arr("a", s), (35,), new_split=0),
    "reshape_new_split1": lambda m, arr, s: m.reshape(arr("a", s), (5, 7), new_split=1),
    "reshape_3d": lambda m, arr, s: m.reshape(arr("cube", s), (7, 12), new_split=0),
    "reshape_small": lambda m, arr, s: m.reshape(arr("small", s), (3, 2), new_split=0),
    "flatten": lambda m, arr, s: m.flatten(arr("cube", s)),
    "concatenate0": lambda m, arr, s: m.concatenate([arr("a", s), arr("a", None), arr("a", s)], axis=0),
    "concatenate1": lambda m, arr, s: m.concatenate([arr("a", s), arr("a", None), arr("a", s)], axis=1),
    "concatenate_mixed": lambda m, arr, s: m.concatenate([arr("a", None), arr("ints", s)], axis=0),
    "hstack": lambda m, arr, s: m.hstack([arr("a", s), arr("a", s)]),
    "vstack": lambda m, arr, s: m.vstack([arr("a", s), arr("a", s)]),
    "column_stack": lambda m, arr, s: m.column_stack([arr("a", s), arr("a", s)]),
    "stack": lambda m, arr, s: m.stack([arr("a", s), arr("a", None)], axis=1),
    "resplit": lambda m, arr, s: m.resplit(arr("cube", s), 2),
    "squeeze": lambda m, arr, s: m.squeeze(m.expand_dims(arr("a", s), 1), 1),
    "expand_dims": lambda m, arr, s: m.expand_dims(arr("a", s), 0),
    "swapaxes": lambda m, arr, s: m.swapaxes(arr("cube", s), 0, 2),
    "moveaxis": lambda m, arr, s: m.moveaxis(arr("cube", s), 0, -1),
    "flip0": lambda m, arr, s: m.flip(arr("a", s), 0),
    "flip_all": lambda m, arr, s: m.flip(arr("cube", s)),
    "fliplr": lambda m, arr, s: m.fliplr(arr("a", s)),
    "rot90": lambda m, arr, s: m.rot90(arr("a", s)),
    "rot90_3": lambda m, arr, s: m.rot90(arr("a", s), 3),
    "roll": lambda m, arr, s: m.roll(arr("a", s), 2, 0),
    "roll1": lambda m, arr, s: m.roll(arr("a", s), -1, 1),
    "pad": lambda m, arr, s: m.pad(arr("a", s), ((1, 2), (0, 1))),
    "pad_small": lambda m, arr, s: m.pad(arr("small", s), 1, constant_values=3.0),
    "pad_edge": lambda m, arr, s: m.pad(arr("a", s), ((1, 2), (3, 1)), mode="edge"),
    "pad_copies_wide": lambda m, arr, s: tuple(m.pad(arr("small", s), ((4, 5), (7, 2)), mode=mode)
                                               for mode in ("reflect", "symmetric", "wrap")),
    "repeat": lambda m, arr, s: m.repeat(arr("a", s), 2, 0),
    "repeat_flat": lambda m, arr, s: m.repeat(arr("a", s), 3),
    "repeat1": lambda m, arr, s: m.repeat(arr("a", s), 2, 1),
    "tile": lambda m, arr, s: m.tile(arr("a", s), (1, 2)),
    "tile0": lambda m, arr, s: m.tile(arr("a", s), (2, 1)),
    "diagonal": lambda m, arr, s: m.diagonal(arr("cube", s), 0, 1, 2),
    "diag": lambda m, arr, s: m.diag(arr("vec", s)),
    "diag_of_matrix": lambda m, arr, s: m.diag(arr("a", s), 1),
    "split": lambda m, arr, s: tuple(m.split(arr("a", s), [2, 5], 0)),
    "hsplit": lambda m, arr, s: tuple(m.hsplit(arr("cube", s), [1, 4])),
    "broadcast_to": lambda m, arr, s: m.broadcast_to(arr("a", s), (2, 7, 5)),
    "sort0": lambda m, arr, s: m.sort(arr("a", s), axis=0),
    "sort1": lambda m, arr, s: m.sort(arr("a", s), axis=1, descending=True),
    "sort_ties": lambda m, arr, s: m.sort(arr("ties", s)),
    "sort_ties_desc": lambda m, arr, s: m.sort(arr("ties", s), descending=True),
    "sort_ties2d": lambda m, arr, s: m.sort(arr("ties2d", s), axis=0, descending=True),
    "sort_ints": lambda m, arr, s: m.sort(arr("ints", s), axis=0),
    "sort_small": lambda m, arr, s: m.sort(arr("small", s), axis=0),
    "topk": lambda m, arr, s: m.topk(arr("long", s), 5),
    "topk_small": lambda m, arr, s: m.topk(arr("long", s), 4, largest=False),
    "topk_ties": lambda m, arr, s: m.topk(arr("ties2d", s), 3, dim=0),
    "topk_2d": lambda m, arr, s: m.topk(arr("a", s), 2, dim=1),
    "unique": lambda m, arr, s: m.unique(m.floor(arr("a", s))),
    "unique_inverse": lambda m, arr, s: m.unique(arr("ints", s), return_inverse=True),
    "unique_ties": lambda m, arr, s: m.unique(arr("ties", s)),
    # statistics on the sort
    "percentile": lambda m, arr, s: m.percentile(arr("long", s), [25, 50, 99]),
    "percentile_axis0": lambda m, arr, s: m.percentile(arr("a", s), [10, 50], axis=0),
    "percentile_axis1": lambda m, arr, s: m.percentile(arr("a", s), 30, axis=1, keepdims=True),
    "percentile_nan": lambda m, arr, s: m.percentile(arr("ties", s), 50),
    "percentile_lower": lambda m, arr, s: m.percentile(arr("a", s), 40, axis=0, interpolation="lower"),
    "percentile_nearest": lambda m, arr, s: m.percentile(arr("a", s), 40, axis=0, interpolation="nearest"),
    "median": lambda m, arr, s: m.median(arr("a", s), axis=0),
    "median_all": lambda m, arr, s: m.median(arr("a", s)),
    "median_ints": lambda m, arr, s: m.median(arr("ints", s), axis=0, keepdims=True),
    # indexing
    "get_slice": lambda m, arr, s: arr("a", s)[3::2],
    "get_neg_step": lambda m, arr, s: arr("a", s)[::-2],
    "get_neg_step_col": lambda m, arr, s: arr("a", s)[5:0:-3, 1],
    "get_cols": lambda m, arr, s: arr("a", s)[:, 1:4],
    "get_cols_neg": lambda m, arr, s: arr("a", s)[:, ::-2],
    "get_ellipsis_none": lambda m, arr, s: arr("cube", s)[..., None, 1:],
    "get_none_front": lambda m, arr, s: arr("a", s)[None, 2:6],
    "get_int": lambda m, arr, s: arr("a", s)[4],
    "get_int_neg": lambda m, arr, s: arr("a", s)[-1, 2:],
    "get_int_col": lambda m, arr, s: arr("a", s)[:, 3],
    "get_scalar": lambda m, arr, s: arr("a", s)[6, 4],
    "get_mask": lambda m, arr, s: arr("a", s)[arr("mask_a", s)],
    "get_mask_cmp": lambda m, arr, s: arr("a", s)[arr("a", s) > 0.5],
    "get_int_array": lambda m, arr, s: arr("a", s)[[0, 6, 2, 2]],
    "get_int_array_col": lambda m, arr, s: arr("a", s)[:, [4, 0]],
    "get_small_empty_rank": lambda m, arr, s: arr("small", s)[1:],
    "nonzero": lambda m, arr, s: m.nonzero(arr("mask_a", s)),
    "where": lambda m, arr, s: m.where(arr("a", s) > 0, arr("a", s), 0.0),
    "where_nonzero": lambda m, arr, s: m.where(arr("bools", s)),
    # arithmetic on the split axis
    "cumsum0": lambda m, arr, s: m.cumsum(arr("ints", s), 0),
    "cumsum1": lambda m, arr, s: m.cumsum(arr("ints", s), 1),
    "cumprod0": lambda m, arr, s: m.cumprod(arr("ints", s), 0),
    "diff0": lambda m, arr, s: m.diff(arr("ints", s), axis=0),
    "diff2": lambda m, arr, s: m.diff(arr("ints", s), n=2, axis=0),
    "diff1": lambda m, arr, s: m.diff(arr("ints", s), axis=1),
    "diff_small": lambda m, arr, s: m.diff(arr("small", s), axis=0),
    "bincount": lambda m, arr, s: m.bincount(arr("pos", s)),
    "digitize": lambda m, arr, s: m.digitize(arr("a", s), m.array([-1.0, 0.0, 0.5], **arr.kw)),
    "bucketize": lambda m, arr, s: m.bucketize(arr("a", s), m.array([-1.0, 0.0, 0.5], **arr.kw)),
    "maximum": lambda m, arr, s: m.maximum(arr("a", s), arr("ints", s)),
    "all0": lambda m, arr, s: m.all(arr("bools", s), axis=0),
    "any": lambda m, arr, s: m.any(arr("bools", s)),
    "nansum": lambda m, arr, s: m.nansum(arr("ties", s)),
    "where_kw": lambda m, arr, s: m.add(arr("ints", s), 1, where=arr("bools", s)),
    # the halo convolution (a 40-sample signal: 14, 14, 12 on three ranks)
    "convolve_full": lambda m, arr, s: m.convolve(arr("long", s), m.array([0.5, -1.0, 2.0, 0.25], **arr.kw)),
    "convolve_same": lambda m, arr, s: m.convolve(arr("long", s), m.array([1.0, 2.0, 1.0], **arr.kw), mode="same"),
    "convolve_valid": lambda m, arr, s: m.convolve(arr("pos", s), m.array([1, -1, 3], **arr.kw), mode="valid"),
    # assignment
    "set_slice": lambda m, arr, s: _set(arr("a", s), slice(1, 6, 2), 7.0),
    "set_neg_step": lambda m, arr, s: _set(arr("a", s), (slice(None, None, -3), 1), -1.0),
    "set_mask": lambda m, arr, s: _set(arr("a", s), arr("mask_a", s), 0.0),
    "set_int": lambda m, arr, s: _set(arr("a", s), 4, m.arange(5, dtype=m.float32, **arr.kw)),
    "set_int_neg": lambda m, arr, s: _set(arr("ints", s), -2, 3),
    "set_block": lambda m, arr, s: _set(arr("a", s), (slice(2, 7), slice(1, 3)), arr("a", None)[0:5, 3:5]),
    "set_int_array": lambda m, arr, s: _set(arr("a", s), [0, 5], 9.0),
    "set_scalar": lambda m, arr, s: _set(arr("ints", s), (6, 4), 42),
    # random streams
    "rand": lambda m, arr, s: _drawn(m, 3, lambda: m.random.rand(5, 7, split=s, **arr.kw)),
    "rand64": lambda m, arr, s: _drawn(m, 4, lambda: m.random.rand(9, 4, dtype=m.float64, split=s, **arr.kw)),
    "randint": lambda m, arr, s: _drawn(m, 5, lambda: m.random.randint(-3, 1000, (7, 5), split=s, **arr.kw)),
    "randint64": lambda m, arr, s: _drawn(m, 6, lambda: m.random.randint(0, 10**6, (7, 5), dtype=m.int64,
                                                                         split=s, **arr.kw)),
    "randperm": lambda m, arr, s: _drawn(m, 7, lambda: m.random.randperm(23, split=s, **arr.kw)),
    "permutation": lambda m, arr, s: _drawn(m, 8, lambda: m.random.permutation(arr("a", s))),
    "second_draw": lambda m, arr, s: _drawn(m, 9, lambda: (m.random.rand(3, **arr.kw), m.random.random((4, 6), split=s,
                                                                                                    **arr.kw))[1]),
    "kmeans_random": lambda m, arr, s: _kmeans(m, arr("blobs", s)),
    # edge cases where torch's own function answers otherwise than jnp's
    "edge_sign_nan": lambda m, arr, s: (m.sign(arr("nan7", s)), m.sgn(arr("nan7", s))),
    "edge_histogram_bool": lambda m, arr, s: m.histogram(arr("bools7", s), 3)[0],
    "edge_histogram_int": lambda m, arr, s: m.histogram(arr("ints", s), 4)[0],
    "edge_unique_axis_nan": lambda m, arr, s: (*m.unique(arr("nanrows", s), axis=0, return_inverse=True),
                                               m.unique(m.transpose(arr("nanrows", s)), axis=1)),
    "edge_vector_norm_int": lambda m, arr, s: (m.vector_norm(arr("ints", s), axis=0), m.vector_norm(arr("bools", s)),
                                               m.norm(arr("ints", s))),
    "edge_trace_bool": lambda m, arr, s: m.array(m.trace(arr("bools", s)), **arr.kw),
    "edge_outer_2d": lambda m, arr, s: m.outer(arr("small", s), arr("vec", None)),
    "edge_arg_bool": lambda m, arr, s: (m.argmax(arr("bools", s), axis=0), m.argmin(arr("bools", s)),
                                        m.argmax(arr("bools", s), axis=1)),
    "edge_bincount_bool": lambda m, arr, s: m.bincount(arr("bools7", s)),
    "edge_vdot_bool": lambda m, arr, s: m.vdot(arr("bools", s), arr("bools", s)),
    "edge_int_div_zero": lambda m, arr, s: tuple(fn(arr("div_x", s), y) for fn in (m.floor_divide, m.mod, m.fmod,
                                                                                    m.remainder)
                                                 for y in (arr("div_y", s), 0)),
    # every dtype heat_tpu computes on, where the port raised or answered otherwise: bool
    # products, complex rounding, variance, ordering and norms, float16 moments, 64-bit
    # randint spans, mask assignment at any split, negative steps beside index arrays
    "edge_matmul_bool": lambda m, arr, s: (m.matmul(arr("bools", s), arr("bools_t", s)),
                                           m.dot(arr("bools", s), arr("bools_t", None))),
    "edge_dot_bool": lambda m, arr, s: m.dot(arr("bools7", s), arr("bools7", s)),
    "edge_matmul_int_wrap": lambda m, arr, s: (m.matmul(arr("mm_i8", s), arr("mm_i8t", s)),
                                               m.matmul(arr("mm_i32", s), arr("mm_i32t", s)),
                                               m.matmul(arr("mm_i8", s), arr("mm_i8t", None).astype(m.int16))),
    "edge_round_complex": lambda m, arr, s: (m.round(arr("cplx", s) * 3), m.round(arr("cplx128", s) * 7)),
    # XLA's division by 10**decimals rounds otherwise in the last bit (the real round(x, 1) is
    # held within 4 ulp in tests/test_torch_elementwise.py for the same reason)
    "edge_round_complex_decimals": lambda m, arr, s: m.round(arr("cplx128", s) * 7, 1),
    "edge_var_complex": lambda m, arr, s: (m.var(arr("cplx", s)), m.std(arr("cplx", s)),
                                           m.var(arr("cplx128", s), ddof=1)),
    "edge_sort_complex": lambda m, arr, s: (*m.sort(arr("cplx", s), axis=0), *m.sort(arr("cplx_round", s), axis=1,
                                                                                       descending=True)),
    "edge_sort_complex_nan": lambda m, arr, s: (*m.sort(arr("cplx_nan", s)), *m.sort(arr("cplx_nan", s),
                                                                                    descending=True)),
    "edge_unique_complex": lambda m, arr, s: m.unique(arr("cplx_round", s), return_inverse=True),
    "edge_unique_complex_nan": lambda m, arr, s: m.unique(arr("cplx_nan", s), return_inverse=True),
    "edge_max_complex": lambda m, arr, s: (m.max(arr("cplx", s)), m.min(arr("cplx_round", s)),
                                           m.max(arr("cplx128", s))),
    "edge_maximum_complex": lambda m, arr, s: (m.maximum(arr("cplx", s), arr("cplx_b", s)),
                                               m.minimum(arr("cplx_b", s), arr("cplx", s))),
    "edge_norm_complex": lambda m, arr, s: (m.linalg.norm(arr("cplx", s)), m.vector_norm(arr("cplx", s), axis=0),
                                            m.vector_norm(arr("cplx128", s), axis=1, ord=1)),
    "edge_moments_f16": lambda m, arr, s: (m.skew(arr("f16", s)), m.kurtosis(arr("f16", s), axis=0),
                                           m.skew(arr("f16", s), axis=1, unbiased=False)),
    "edge_randint_spans": lambda m, arr, s: tuple(
        _drawn(m, 20 + i, lambda: m.random.randint(lo, hi, (7, 5), dtype=dt, split=s, **arr.kw))
        for i, (lo, hi, dt) in enumerate([(0, 2**31, m.int64), (0, 2**40, m.int64), (0, 2**63 - 1, m.int64),
                                          (-2**63, 2**63 - 1, m.int64), (-7, 2**62 + 5, m.int64),
                                          (0, 2**31, m.int32), (-2**31, 2**31, m.int32)])),
    "edge_set_mask_values": lambda m, arr, s: _set(arr("a", s), arr("mask_a", s),
                                                   arr("mask_vals", None if s is None else 0)),
    "edge_set_mask_whole_values": lambda m, arr, s: _set(arr("a", s), arr("mask_a", s), arr("mask_vals", None)),
    "edge_set_neg_step_array": lambda m, arr, s: (_set(arr("a", s), (m.array([0, 2, 5], **arr.kw), slice(None, None, -1)),
                                                       arr("a", None)[0:3]),
                                                  _set(arr("cube", s), (slice(None, None, -2), [1, 0], slice(0, 2)), 5.0)),
    # pad's computed modes, by torch ops on the array's device
    "pad_stats": lambda m, arr, s: tuple(m.pad(arr("a", s), ((1, 2), (3, 1)), mode=mode)
                                         for mode in ("mean", "median", "maximum", "minimum", "linear_ramp", "empty")),
    "pad_stats_int": lambda m, arr, s: tuple(m.pad(arr("ints", s), ((2, 1), (0, 2)), mode=mode)
                                             for mode in ("mean", "median", "maximum", "linear_ramp")),
    # the split-axis forms: shifts longer than a chunk and negative, flat rolls of every split
    "roll_long": lambda m, arr, s: (m.roll(arr("a", s), 5, 0), m.roll(arr("a", s), -8, 0), m.roll(arr("a", s), 17)),
    "roll_flat": lambda m, arr, s: (m.roll(arr("a", s), -11), m.roll(arr("cube", s), 40), m.roll(arr("small", s), 4)),
    "roll_axes": lambda m, arr, s: (m.roll(arr("cube", s), (3, -9, 1), (0, 1, 2)), m.roll(arr("a", s), (2, 3), (0, 0)),
                                    m.roll(arr("a", s), 4, (0, 1)), m.roll(arr("small", s), -3, 0)),
    # pads wider than a chunk and than the axis in each copy mode; computed modes with an empty rank
    "pad_copies_a": lambda m, arr, s: tuple(m.pad(arr("a", s), ((4, 9), (2, 6)), mode=mode)
                                            for mode in ("edge", "reflect", "symmetric", "wrap")),
    "pad_copies_cube": lambda m, arr, s: tuple(m.pad(arr("icube", s), ((0, 5), (8, 1), (2, 2)), mode=mode)
                                               for mode in ("edge", "reflect", "symmetric", "wrap")),
    "pad_stats_small": lambda m, arr, s: tuple(m.pad(arr("small", s), ((2, 3), (1, 2)), mode=mode)
                                               for mode in ("mean", "median", "maximum", "minimum", "linear_ramp",
                                                            "empty")),
    "pad_stats_cube": lambda m, arr, s: tuple(m.pad(arr("icube", s), ((1, 1), (2, 0), (0, 3)), mode=mode)
                                              for mode in ("mean", "median", "maximum", "minimum", "linear_ramp")),
    # tile on ragged chunks (7 rows: 3, 3, 1), more reps than ranks, a new leading axis
    "tile_ragged": lambda m, arr, s: (m.tile(arr("a", s), (3, 2)), m.tile(arr("cube", s), (2, 1, 3)),
                                      m.tile(arr("small", s), (4, 1)), m.tile(arr("a", s), (2, 1, 1))),
    # diagonals, traces and triangles with offsets across the chunk boundaries
    "diag_offsets": lambda m, arr, s: (m.diag(arr("ivec", s), 2), m.diag(arr("ivec", s), -3), m.diag(arr("vec", s), 9)),
    "diagonal_offsets": lambda m, arr, s: (m.diagonal(arr("a", s), 2), m.diagonal(arr("a", s), -4),
                                           m.diagonal(arr("icube", s), 1, 0, 1), m.diagonal(arr("icube", s), -2, 2, 1),
                                           m.diag(arr("ints", s), -5)),
    "trace_offsets": lambda m, arr, s: (m.array([m.trace(arr("ints", s), k) for k in (0, 2, -4, 9)], **arr.kw),
                                        m.trace(arr("icube", s), 1, 1, 2), m.trace(arr("icube", s), -1, 0, 1),
                                        m.array(m.trace(arr("bools", s), -2), **arr.kw)),
    "tri_offsets": lambda m, arr, s: (m.tril(arr("a", s), 2), m.tril(arr("a", s), -3), m.triu(arr("a", s), 4),
                                      m.triu(arr("a", s), -1), m.tril(arr("icube", s), 1), m.triu(arr("icube", s), -2)),
    "tri_vec": lambda m, arr, s: (m.tril(arr("ivec", s), 1), m.triu(arr("ivec", s), -2), m.tril(arr("ivec", s), -9),
                                  m.triu(arr("ivec", s), 3)),
    "vdot_layouts": lambda m, arr, s: (m.vdot(arr("ints", s), arr("ints", None)), m.vdot(arr("ints", s), arr("ints", 1)),
                                       m.vdot(arr("bools", s), arr("bools", 0)),
                                       m.vdot(arr("icube", s), m.reshape(arr("icube", None), (12, 7)))),
    "vdot_float": lambda m, arr, s: (m.vdot(arr("a", s), arr("a", 0)), m.vdot(arr("cplx", s), arr("cplx", 1))),
    # the norms of every order a split array now takes without a gather
    "norm_orders": lambda m, arr, s: (*(m.vector_norm(arr("a", s), ord=o) for o in (1, 3, np.inf, -np.inf, 0, -1)),
                                      m.vector_norm(arr("a", s), axis=0, ord=1), m.vector_norm(arr("a", s), axis=1,
                                                                                               ord=np.inf),
                                      m.vector_norm(arr("cube", s), axis=(0, 2), ord=3, keepdims=True),
                                      *(m.matrix_norm(arr("a", s), ord=o) for o in ("fro", 1, -1, np.inf, -np.inf)),
                                      m.matrix_norm(arr("cube", s), axis=(1, 2), ord=1),
                                      m.norm(arr("cube", s), axis=(2, 0), ord=-np.inf, keepdims=True),
                                      m.matrix_norm(arr("cube", s), axis=(2, 0), ord="fro"),
                                      m.norm(arr("a", s), ord=np.inf, axis=1)),
    # cov: variables split (the ring), observations split, y, rowvar False, ddof and bias
    "cov_forms": lambda m, arr, s: (m.cov(_f64(m, arr, s)), m.cov(_f64(m, arr, s), rowvar=False),
                                    m.cov(_f64(m, arr, s), m.sqrt(m.abs(_f64(m, arr, s))), ddof=3),
                                    m.cov(_f64(m, arr, s), _f64(m, arr, None), rowvar=False, bias=True),
                                    m.cov(arr("ints", s))),
    "cov_vec": lambda m, arr, s: (m.cov(arr("long", s).astype(m.float64)),
                                  m.cov(arr("long", s).astype(m.float64), arr("long", None).astype(m.float64), ddof=0)),
    # integer keys with negatives and duplicates, beside and on the split axis
    "get_int_keys": lambda m, arr, s: (arr("a", s)[[-1, 2, 2, -7, 5]], arr("a", s)[:, [-1, 0, 0]],
                                       arr("a", s)[[1, -2], [3, -1]], arr("a", s)[[[0, 6], [-1, 3]]],
                                       arr("icube", s)[[2, -1], :, [0, 2]], arr("icube", s)[:, [6, -7, 6]],
                                       arr("a", s)[[0, 3], 1:4], arr("icube", s)[1:, [4, 4], ::-1],
                                       arr("a", s)[arr("bools", s)[:, 0]]),
    # (a key written twice gets one value here: torch leaves which of two values a duplicate
    # keeps undefined on CUDA; the last write wins on the CPU, tests/test_torch_distributed.py's
    # test_duplicate_keys_keep_the_last_write)
    "set_int_keys": lambda m, arr, s: (_set(arr("a", s), [-1, 2, 2, -7], 5.0),
                                       _set(arr("a", s), (slice(None), [-1, 0, 0]), arr("a", None)[:, 0:1]),
                                       _set(arr("icube", s), ([2, -1, 2], slice(None), [0, 2, 0]), 99),
                                       _set(arr("icube", s), (slice(1, None), [4, -3], slice(None, None, -1)), -5),
                                       _set(arr("a", s), ([1, -2], [3, -1]), arr("a", None)[0, 0:2])),
    # the dtype sweep: common operations over every input type, and their sums (heat_tpu's
    # sums of uint8 are uint64, which neither package has)
    **{f"dtype_{name}": (lambda name: lambda m, arr, s: _sweep(m, arr, s, name))(name)
       for name in ("bools", "u8", "i8", "i16", "f16", "bf16", "cplx", "cplx128")},
    **{f"dtype_sums_{name}": (lambda name: lambda m, arr, s: _sums(m, arr, s, name))(name)
       for name in ("bools", "i8", "i16", "f16", "bf16", "cplx", "cplx128")},
}


def _typed(m, arr, name, split):
    """The sweep's input ``name`` (``bf16``: "a" as bfloat16)."""
    return arr("a", split).astype(m.bfloat16) if name == "bf16" else arr(name, split)


def _sweep(m, arr, s, name):
    """Operations every dtype meets: reshape, concatenate, transpose, slicing, a mask, sort
    along the split axis, max, sum and cumsum along an axis, elementwise arithmetic and
    comparisons, where, astype."""
    x = _typed(m, arr, name, s)
    y = _typed(m, arr, name, None)
    out = [m.reshape(x, (5, 7)), m.concatenate([x, y], axis=0), m.transpose(x), x[1:6:2], x[::-1, 1],
           x[arr("mask_a", s)], m.equal(x, y), x == y, x != m.flip(y, 0), m.where(arr("mask_a", s), x, y),
           x.astype(m.float32), *m.sort(x, axis=0)]
    if name != "bools":
        out += [x + y, x * y, x - m.flip(y, 0), m.maximum(x, m.flip(y, 1))]
    if name not in ("cplx", "cplx128"):  # the complex max and min are edge_max_complex's
        out += [abs(x), x < m.flip(y, 0), m.max(x, axis=0), m.min(x)]
    return tuple(out)


def _sums(m, arr, s, name):
    """The sums of the sweep's input along each axis, its cumulative sum (not of float16
    and bfloat16: see tests/test_torch_dtypes.py) and a complex input's modulus."""
    x = _typed(m, arr, name, s)
    out = [m.sum(x, axis=1), m.sum(x, axis=0)]
    if name not in ("f16", "bf16"):
        out.append(m.cumsum(x, 0))
    if name in ("cplx", "cplx128"):  # |x| by another hypot: within a rounding
        out.append(abs(x))
    return tuple(out)

FLOAT = {"convolve_full", "convolve_same", "kmeans_random", "cumsum1", "percentile", "percentile_axis0", "percentile_axis1", "median", "median_all", "median_ints",
         "percentile_nan", "edge_vector_norm_int", "edge_var_complex", "edge_norm_complex", "edge_moments_f16", "edge_round_complex_decimals",
         "pad_stats", "dtype_sums_cplx", "dtype_sums_cplx128", "vdot_float", "norm_orders", "cov_forms", "cov_vec",
         "pad_stats_small"}
RTOL = 1e-6
# cases held within a wider tolerance than RTOL, with the reason: the float16 moments are
# float32 sums in another order, and kurtosis' unbiased correction subtracts 3(n - 1) from
# (n + 1)·g2, which multiplies their relative error by about n
TOLERANCES = {"edge_moments_f16": 1e-4}
# heat_tpu's result at split=None stands for every layout where its split result differs
# from its own one-device answer (ROADMAP Queue 3, "The reference's own differences"): the
# max and min of a split complex array raise in XLA, its variance is wrong there, and the
# inverse of unique gives its NaN elements other indices. Values, dtype and global shape
# are compared.
AT_NONE = {"edge_var_complex", "edge_max_complex", "edge_unique_complex_nan"}


def rtol_of(name):
    """The relative tolerance a case is held to (0: exact)."""
    return TOLERANCES.get(name, RTOL if name in FLOAT else 0)


def splits_of(name):
    """The splits a case runs at (some inputs are 1-D)."""
    return (None, 0) if name in ("diag", "sort_ties", "sort_ties_desc", "topk", "topk_small", "unique_ties",
                                 "percentile", "percentile_nan", "bincount", "nansum", "randperm",
                                 "convolve_full", "convolve_same", "convolve_valid",
                                 "kmeans_random", "edge_sign_nan", "edge_histogram_bool", "edge_bincount_bool",
                                 "edge_int_div_zero", "edge_dot_bool", "edge_sort_complex_nan",
                                 "edge_unique_complex_nan", "diag_offsets", "tri_vec", "cov_vec") else (None, 0, 1)
