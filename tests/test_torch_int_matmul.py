"""The integer and bool product (heat_tpu_torch/core/kernels/int_matmul.py) against
heat_tpu's ``matmul``, ``dot`` and ``vdot``, the port as one rank: every integer type and
bool, mixed pairs through promotion, 1-D, 2-D and batched operands, contractions long
enough to wrap int8 and int32 (and int64), every split pair. XLA's integer dot wraps
modulo 2^bits and its bool dot is the OR of ANDs; the port's results are exact and equal
to heat_tpu's. On the CPU the products take the kernel's plain version; the kernel itself
runs in chip_smoke.py's ``[int_matmul]`` phase, bit for bit against that version."""

import ast

import numpy as np
import pytest
import torch

import heat_tpu as ht

import heat_tpu_torch as htt
from heat_tpu_torch.core.kernels import int_matmul
from heat_tpu_torch.testing import assert_record_equal, port_record

TYPES = ["bool", "uint8", "int8", "int16", "int32", "int64"]
PAIRS = [(sa, sb) for sa in (None, 0, 1) for sb in (None, 0, 1)]


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


def _ints(dtype: str, shape, seed: int) -> np.ndarray:
    """Entries that make the products wrap: near 100 for 8 and 16 bits (k = 300 overflows
    int8 and int16 sums), near 2**20 for int32, near 2**40 for int64; bool at random."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.standard_normal(shape) > 0.7
    lo, hi = {"uint8": (150, 256), "int8": (-128, 128), "int16": (-3000, 3000), "int32": (2**19, 2**21),
              "int64": (2**39, 2**41)}[dtype]
    return rng.integers(lo, hi, shape).astype(dtype)


def _k(dtype: str) -> int:
    return 300 if dtype in ("bool", "uint8", "int8", "int16") else 40


def _same(got, want):
    assert_record_equal(port_record(got), want, rtol=0)


@pytest.mark.parametrize("pair", PAIRS, ids=str)
@pytest.mark.parametrize("dtype", TYPES)
def test_matmul_every_type_and_split(dtype, pair):
    """(7, k) · (k, 5) at every split pair: exactly heat_tpu's product, wrapped."""
    a, b = _ints(dtype, (7, _k(dtype)), 1), _ints(dtype, (_k(dtype), 5), 2)
    sa, sb = pair
    _same(htt.matmul(htt.array(a, split=sa), htt.array(b, split=sb)), ht.matmul(ht.array(a, split=sa), ht.array(b, split=sb)))
    if dtype != "bool":  # the sums really wrap: the exact product leaves the type
        exact = a.astype(object) @ b.astype(object)
        assert any(int(v) != int(w) for v, w in zip(exact.ravel(), htt.matmul(htt.array(a), htt.array(b)).numpy().ravel()))


@pytest.mark.parametrize("pair", [("int8", "int16"), ("uint8", "int8"), ("int32", "uint8"), ("bool", "int8"),
                                  ("int16", "int64"), ("bool", "uint8")])
def test_mixed_pairs_promote(pair):
    """Operands of two types meet in the promoted type (jnp's rules), then wrap there."""
    a, b = _ints(pair[0], (6, 300), 3), _ints(pair[1], (300, 4), 4)
    for sa, sb in ((None, None), (0, 1), (1, 0)):
        got = htt.matmul(htt.array(a, split=sa), htt.array(b, split=sb))
        want = ht.matmul(ht.array(a, split=sa), ht.array(b, split=sb))
        _same(got, want)


@pytest.mark.parametrize("dtype", ["bool", "int8", "int32", "int64"])
def test_vector_and_batched_operands(dtype):
    """1-D operands (a row, a column, the inner product), a batch against a matrix, two
    batches, broadcast batch dimensions, and dot and vdot of vectors and matrices."""
    k = _k(dtype)
    m3, m3b, m4 = _ints(dtype, (3, 7, k), 5), _ints(dtype, (3, k, 5), 6), _ints(dtype, (2, 1, 7, k), 7)
    mat, vec, vec2 = _ints(dtype, (k, 5), 8), _ints(dtype, k, 9), _ints(dtype, k, 10)
    cases = [
        (lambda m: m.matmul(m.array(vec), m.array(mat))),
        (lambda m: m.matmul(m.array(mat.T.copy()), m.array(vec))),
        (lambda m: m.matmul(m.array(vec), m.array(vec2))),
        (lambda m: m.matmul(m.array(m3, split=0), m.array(mat))),
        (lambda m: m.matmul(m.array(m3), m.array(m3b))),
        (lambda m: m.matmul(m.array(m4), m.array(m3b))),
        (lambda m: m.dot(m.array(vec, split=0), m.array(vec2, split=0))),
        (lambda m: m.dot(m.array(vec), m.array(vec2, split=0))),
        (lambda m: m.vdot(m.array(mat, split=1), m.array(mat))),
    ]
    for case in cases:
        _same(case(htt), case(ht))


def test_plain_version():
    """The plain version: torch's integer matmul wraps (int8 of 100s, k = 300, gives jnp's
    -64), and bool is the OR of ANDs."""
    a = torch.full((2, 300), 100, dtype=torch.int8)
    assert int(int_matmul.int_matmul_reference(a, a.T)[0, 0]) == -64
    rng = np.random.default_rng(11)
    x, y = rng.standard_normal((5, 40)) > 1.0, rng.standard_normal((40, 3)) > 1.0
    want = np.array([[any(x[i, j] and y[j, c] for j in range(40)) for c in range(3)] for i in range(5)])
    np.testing.assert_array_equal(int_matmul.int_matmul_reference(torch.from_numpy(x), torch.from_numpy(y)).numpy(), want)
    np.testing.assert_array_equal(int_matmul.matmul(torch.from_numpy(x), torch.from_numpy(y)).numpy(), want)


@pytest.mark.parametrize("dtype", TYPES)
def test_limb_version_equals_the_plain_version(dtype):
    """The card's plain version (float64 products of byte planes, carried byte by byte;
    torch.matmul takes no CUDA integer tensor) equals the CPU's on full-range entries,
    batched and 1-D operands included."""
    rng = np.random.default_rng(15)
    if dtype == "bool":
        a, b = rng.standard_normal((2, 6, 300)) > 0.5, rng.standard_normal((300, 4)) > 0.5
    else:
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, (2, 6, 300), dtype=np.int64).astype(dtype)
        b = rng.integers(info.min, info.max, (300, 4), dtype=np.int64).astype(dtype)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    for x, y in ((a, b), (a[0, 0], b[:, 1]), (a[1], b)):
        got, want = int_matmul._limb_matmul(x, y), int_matmul.int_matmul_reference(x, y)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 300, 5000, 70_000])
@pytest.mark.parametrize("dtype", ["bool", "uint8", "int8", "int16", "int32", "int64"])
def test_split_k_partials_wrap_to_the_same_bits(dtype, k):
    """The 1-D dot kernel splits k over its threads (a grid-stride loop over ``blocks`` of
    256, as the wrapper sizes the grid for 132 SMs), sums each thread's share in uint32
    (uint64 for int64; OR for bool) and combines the threads' partials: wrapping sums in
    any grouping give the product's bits. Replayed here in numpy's unsigned types."""
    acc = np.uint64 if dtype == "int64" else np.uint32
    a, b = _ints(dtype, (k,), 13), _ints(dtype, (k,), 14)
    threads = max(1, min(-(-k // (256 * 8)), 4 * 132)) * 256
    with np.errstate(over="ignore"):
        shares = [(a[t::threads].astype(acc) * b[t::threads].astype(acc)) for t in range(min(threads, k))]
        if dtype == "bool":
            got = np.bool_(any(s.any() for s in shares))
        else:
            partials = np.array([s.sum(dtype=acc) for s in shares], dtype=acc)
            got = partials.sum(dtype=acc).astype(dtype)
    want = int_matmul.int_matmul_reference(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got == want


def test_wrapper_checks_and_cpu_route():
    """The wrapper refuses floats, mixed types and devices other than the CPU and CUDA;
    CPU tensors take the plain version and launch nothing."""
    before = int_matmul.launches
    a = torch.ones((2, 3), dtype=torch.int32)
    np.testing.assert_array_equal(int_matmul.matmul(a, a.T).numpy(), np.full((2, 2), 3))
    assert int_matmul.launches == before
    with pytest.raises(TypeError):
        int_matmul.matmul(a.float(), a.T.float())
    with pytest.raises(TypeError):
        int_matmul.matmul(a, a.T.to(torch.int64))
    with pytest.raises(ValueError):
        int_matmul.matmul(a, a)
    with pytest.raises(ValueError):
        int_matmul.matmul(a.to("meta"), a.T.to("meta"))


def test_launch_count_under_its_lock():
    """The launch counter moves only inside ``with _count_lock`` and resets with the
    package's other kernels."""
    from heat_tpu_torch.core import kernels

    tree = ast.parse(open(int_matmul.__file__).read())
    parents = {c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}
    incs = [n for n in ast.walk(tree) if isinstance(n, ast.AugAssign) and ast.unparse(n.target) == "launches"]
    assert incs and all(isinstance(parents[n], ast.With) and ast.unparse(parents[n].items[0].context_expr)
                        == "_count_lock" for n in incs)
    assert kernels.KERNELS["int_matmul"] is int_matmul
    saved = kernels.launch_counts()
    try:
        with int_matmul._count_lock:
            int_matmul.launches += 2
        assert kernels.launch_counts()["int_matmul"] == saved["int_matmul"] + 2
        kernels.reset_launch_counts()
        assert kernels.launch_counts()["int_matmul"] == 0
    finally:
        for name, mod in kernels.KERNELS.items():
            mod.launches = saved[name]


# The tensor-core product (csrc/int_gemm_tc.cu) of bool, uint8 and int8: its route, the
# operands the wrapper gives it (k padded with zeros to 16 bytes, B as Bᵀ, batch rows) and
# the arithmetic it does on them (int32 sums that wrap, then the cut), in plain PyTorch on
# the CPU, held to heat_tpu. The kernel itself runs in chip_smoke.py's [int_matmul].
TC_TYPES = ["bool", "uint8", "int8"]


def _full_range(dtype: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.standard_normal(shape) > 0.3
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape, dtype=np.int64).astype(dtype)


def _tc_product(a: np.ndarray, b: np.ndarray) -> torch.Tensor:
    """The kernel's contract on CPU tensors: the batch operands as ``matmul`` makes them
    (``batched``), the kernel's operands by ``tc_operands`` and its sums by
    ``tc_reference``."""
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    a3, b3, a_batch, b_batch, batch_shape = int_matmul.batched(at, bt)
    ops = int_matmul.tc_operands(a3, b3, a_batch, b_batch, batch_shape.numel())
    k = at.shape[-1]
    assert ops.k_pad % 16 == 0 and ops.k_pad - 16 < k <= ops.k_pad
    assert not ops.a[:, k:].any() and not ops.bt[:, k:].any()  # the padding is zeros
    c = int_matmul.tc_reference(ops, at.dtype)
    return c.view(*batch_shape, *c.shape[-2:])


@pytest.mark.parametrize(
    "dtype,batch,m,n,want",
    [(d, 1, 1, 1, "dot") for d in TYPES]
    + [(d, b, m, n, "tensor_cores") for d in TC_TYPES for b, m, n in ((1, 7, 5), (1, 1, 9), (1, 9, 1), (3, 1, 1),
                                                                      (4, 300, 500), (1, 8192, 8192))]
    + [(d, b, m, n, "byte_planes") for d in ("int16", "int32", "int64")
       for b, m, n in ((1, 7, 5), (1, 1, 9), (1, 9, 1), (3, 1, 1), (1, 8192, 8192), (1, 8192, 1))],
    ids=str,
)
def test_route_of_each_type_and_shape(dtype, batch, m, n, want):
    """One 1-D dot takes the dot kernel whatever its type; every other product of bool,
    uint8 and int8 the int8 tensor cores (matrix-vector shapes and batches of dots too);
    every other product of int16, int32 and int64 the byte planes on the same cores, with no
    matrix-vector threshold: at n = 1 (8192² against a vector) the byte planes beat the IMAD
    kernel they replace for all three types, so no shape stays on IMAD."""
    assert int_matmul.route(getattr(torch, dtype), batch, m, n) == want


@pytest.mark.parametrize("k", [1, 15, 16, 17, 33, 300])
@pytest.mark.parametrize("dtype", TC_TYPES)
def test_tensor_core_operands_pad_k_without_changing_the_product(dtype, k):
    """k padded with zeros to the next multiple of 16 (TMA's stride rule) leaves the product
    as heat_tpu computes it: (9, k) · (k, 6), and a matrix against a vector."""
    a, b = _full_range(dtype, (9, k), 21 + k), _full_range(dtype, (k, 6), 22 + k)
    assert int_matmul.padded_k(k) == -(-k // 16) * 16
    _same(htt.array(_tc_product(a, b)), ht.matmul(ht.array(a), ht.array(b)))
    _same(htt.array(_tc_product(a, b[:, :1])), ht.matmul(ht.array(a), ht.array(b[:, :1])))


@pytest.mark.parametrize("dtype", ["int8", "uint8"])
def test_tensor_core_sums_wrap_in_int32_to_xlas_bits(dtype):
    """At k = 2^17 + 64 a block of the type's largest magnitudes sums past 2^31 (128² · k, or
    255² · k): the kernel's int32 accumulators wrap, and their low 8 bits are still heat_tpu's
    wrapped product, at m = n = 8 with the other entries full range."""
    k = 2**17 + 64
    a, b = _full_range(dtype, (8, k), 31), _full_range(dtype, (k, 8), 32)
    big = np.iinfo(dtype).min if dtype == "int8" else np.iinfo(dtype).max
    a[:4], b[:, :4] = big, big
    assert int(big) * int(big) * k > 2**31 - 1
    want = ht.matmul(ht.array(a), ht.array(b))
    _same(htt.array(_tc_product(a, b)), want)
    _same(htt.matmul(htt.array(a), htt.array(b)), want)
    block = int(big) * int(big) * k
    assert int(want.numpy()[0, 0]) == (((block + 128) % 256) - 128 if dtype == "int8" else block % 256)


@pytest.mark.parametrize("k", [1, 15, 17, 33])
@pytest.mark.parametrize("dtype", ["bool", "uint8"])
def test_bool_and_uint8_at_short_k(dtype, k):
    """bool (the OR of ANDs, as a u8 product compared with 0) and uint8 at k = 1, 15, 17
    and 33, ragged m and n, against heat_tpu, through the kernel's contract and through
    the port's matmul."""
    a, b = _full_range(dtype, (13, k), 41 + k), _full_range(dtype, (k, 11), 42 + k)
    want = ht.matmul(ht.array(a), ht.array(b))
    _same(htt.array(_tc_product(a, b)), want)
    _same(htt.matmul(htt.array(a, split=0), htt.array(b)), ht.matmul(ht.array(a, split=0), ht.array(b)))


@pytest.mark.parametrize("dtype", TC_TYPES)
def test_tensor_core_batches_and_shared_operands(dtype):
    """Batch rows of A and Bᵀ: both batched, A shared by every batch (a_rows_batch 0), B
    shared, and broadcast batch dimensions, against heat_tpu."""
    k = 37
    a3, b3 = _full_range(dtype, (3, 5, k), 51), _full_range(dtype, (3, k, 7), 52)
    a2, b2 = _full_range(dtype, (5, k), 53), _full_range(dtype, (k, 7), 54)
    a4 = _full_range(dtype, (2, 1, 5, k), 55)
    for x, y in ((a3, b3), (a2, b3), (a3, b2), (a4, b3)):
        _same(htt.array(_tc_product(x, y)), ht.matmul(ht.array(x), ht.array(y)))


@pytest.mark.parametrize("dtype", TC_TYPES)
def test_transpose_pad_reference(dtype):
    """The transpose kernel's plain version: bt[z, j, i] = b[z, i, j], zeros for k ≤ i <
    k_pad; n = 1 needs no transpose (B already is Bᵀ) and only the padding."""
    b = torch.from_numpy(_full_range(dtype, (2, 19, 6), 61))
    bt = int_matmul.transpose_pad_reference(b, 32)
    assert bt.shape == (2, 6, 32) and bt.is_contiguous() and bt.dtype == b.dtype
    assert torch.equal(bt[..., :19], b.transpose(-1, -2)) and not bt[..., 19:].any()
    col = b[:, :, :1].contiguous()
    assert torch.equal(int_matmul._transpose_pad(col, 32), int_matmul.transpose_pad_reference(col, 32))
    aligned = torch.from_numpy(_full_range(dtype, (1, 32, 1), 62))
    assert torch.equal(int_matmul._transpose_pad(aligned, 32), aligned.view(1, 1, 32))


def test_tensor_core_launch_counts_under_the_lock():
    """The tensor-core product's and the transpose's counters move only inside ``with
    _count_lock``, are the package's ``int_matmul_tc`` and ``int_transpose_pad`` kernels,
    built from int_gemm_tc.cu, and reset with the others; CPU tensors launch nothing."""
    from heat_tpu_torch.core import kernels

    tree = ast.parse(open(int_matmul.__file__).read())
    parents = {c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}
    incs = [n for n in ast.walk(tree) if isinstance(n, ast.AugAssign) and ast.unparse(n.target).endswith("launches")]
    assert {ast.unparse(n.target) for n in incs} == {"launches", "tc.launches", "transpose.launches",
                                                     "byte_planes.launches", "split_planes.launches",
                                                     "split_planes_t.launches"}
    assert all(isinstance(parents[n], ast.With) and ast.unparse(parents[n].items[0].context_expr) == "_count_lock"
               for n in incs)
    assert kernels.KERNELS["int_matmul_tc"] is int_matmul.tc
    assert kernels.KERNELS["int_transpose_pad"] is int_matmul.transpose
    assert int_matmul.tc.SOURCE == int_matmul.transpose.SOURCE == int_matmul.TC_SOURCE
    assert int_matmul.TC_SOURCE.is_file()
    saved = kernels.launch_counts()
    try:
        a = torch.ones((4, 40), dtype=torch.int8)
        int_matmul.matmul(a, a.T)
        assert kernels.launch_counts() == saved
        with int_matmul._count_lock:
            int_matmul.tc.launches += 2
            int_matmul.transpose.launches += 1
        counts = kernels.launch_counts()
        assert counts["int_matmul_tc"] == saved["int_matmul_tc"] + 2
        assert counts["int_transpose_pad"] == saved["int_transpose_pad"] + 1
        kernels.reset_launch_counts()
        assert kernels.launch_counts()["int_matmul_tc"] == kernels.launch_counts()["int_transpose_pad"] == 0
    finally:
        for name, mod in kernels.KERNELS.items():
            mod.launches = saved[name]


# The byte-plane product (csrc/int_gemm_planes.cu) of int16, int32 and int64: the operands the
# wrapper gives it (each operand's bytes as u8 planes, B's as planes of Bᵀ, k padded with zeros
# to 16) and the arithmetic it does on them (plane pairs summed by weight in int32 accumulators,
# combined modulo 2^bits; int64's low classes in chunks of k), in plain PyTorch on the CPU, held
# to heat_tpu. The kernel itself runs in chip_smoke.py's [int_matmul].
PLANE_TYPES = ["int16", "int32", "int64"]


def _plane_product(a: np.ndarray, b: np.ndarray, chunk: int = int_matmul.INT64_CHUNK) -> torch.Tensor:
    """The kernel's contract on CPU tensors: the batch operands as ``matmul`` makes them, the
    planes by ``plane_operands`` and the sums by ``plane_reference``."""
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    a3, b3, a_batch, b_batch, batch_shape = int_matmul.batched(at, bt)
    ops = int_matmul.plane_operands(a3, b3, a_batch, b_batch, batch_shape.numel())
    k = at.shape[-1]
    assert ops.a.dtype == ops.bt.dtype == torch.uint8 and ops.a.shape[0] == ops.bt.shape[0] == at.element_size()
    assert ops.k_pad % 16 == 0 and ops.k_pad - 16 < k <= ops.k_pad
    assert not ops.a[..., k:].any() and not ops.bt[..., k:].any()  # the padding is zeros
    c = int_matmul.plane_reference(ops, at.dtype, chunk)
    return c.view(*batch_shape, *c.shape[-2:])


def _plane_case_equal(a: np.ndarray, b: np.ndarray) -> None:
    want = ht.matmul(ht.array(a), ht.array(b))
    _same(htt.array(_plane_product(a, b)), want)
    plain = int_matmul.int_matmul_reference(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(_plane_product(a, b), plain.view(_plane_product(a, b).shape))


@pytest.mark.parametrize("shape", [(9, 17, 6), (5, 1, 3), (4, 16, 7), (7, 300, 5), (8, 40, 1), (1, 33, 9)], ids=str)
@pytest.mark.parametrize("dtype", PLANE_TYPES)
def test_plane_product_equals_heat_tpu(dtype, shape):
    """Full-range entries (every product and sum wraps) at ragged m, n and k, k of 1 and of
    16, a matrix against a vector and a row against a matrix: the planes' sums combined by
    weight give heat_tpu's product and the plain version's, bit for bit."""
    m, k, n = shape
    _plane_case_equal(_full_range(dtype, (m, k), 71 + k), _full_range(dtype, (k, n), 72 + k))


@pytest.mark.parametrize("dtype", PLANE_TYPES)
def test_plane_product_minus_one_block_past_2_32(dtype):
    """A block of -1 (every byte 255) at k = 2^15 + 64: class 3's sum, 4·255²·k, passes 2^32,
    which int16 and int32 may wrap and int64 takes in chunks of k; C[0, 0] = k, as heat_tpu's."""
    k = 2**15 + 64
    assert 4 * 255**2 * k > 2**32
    a, b = _full_range(dtype, (4, k), 81), _full_range(dtype, (k, 3), 82)
    a[:2], b[:, :2] = -1, -1
    _plane_case_equal(a, b)
    assert int(_plane_product(a, b)[0, 0]) == (k if dtype != "int16" else k - 2**16)


@pytest.mark.parametrize("dtype", PLANE_TYPES)
def test_plane_product_batches_and_shared_operands(dtype):
    """Batch rows of A's and Bᵀ's planes: both batched, A shared by every batch (a_rows_batch
    0), B shared, broadcast batch dimensions, and a batch against one column, against
    heat_tpu."""
    k = 37
    a3, b3 = _full_range(dtype, (3, 5, k), 91), _full_range(dtype, (3, k, 7), 92)
    a2, b2 = _full_range(dtype, (5, k), 93), _full_range(dtype, (k, 7), 94)
    a4 = _full_range(dtype, (2, 1, 5, k), 95)
    for x, y in ((a3, b3), (a2, b3), (a3, b2), (a4, b3), (a3, b3[..., :1])):
        _same(htt.array(_plane_product(x, y)), ht.matmul(ht.array(x), ht.array(y)))


@pytest.mark.parametrize("k", [16384, 16385, 20000])
def test_int64_chunks_of_k(k):
    """int64 at k = 16,384 (one chunk), 16,385 (one step past it) and 20,000, a few rows with
    full-range entries and rows of -1: heat_tpu's product. Summed as one chunk instead, the
    rows of -1 past 16,512 steps leave uint32 and the result differs."""
    a, b = _full_range("int64", (3, k), 101), _full_range("int64", (k, 2), 102)
    a[0], b[:, 0] = -1, -1
    want = ht.matmul(ht.array(a), ht.array(b))
    _same(htt.array(_plane_product(a, b)), want)
    one_chunk = _plane_product(a, b, chunk=int_matmul.padded_k(k))
    assert torch.equal(one_chunk, _plane_product(a, b)) == (k <= 16512)


def test_int64_chunk_bound_in_the_source():
    """16,512 steps of 4·255² stay below 2^32 and 16,513 do not; the chunk, the same in the
    wrapper and in int_gemm_planes.cu, is within that bound and whole tiles of 128 bytes."""
    assert 16512 * 4 * 255**2 < 2**32 <= 16513 * 4 * 255**2
    assert int_matmul.INT64_CHUNK <= 16512 and int_matmul.INT64_CHUNK % 128 == 0
    source = int_matmul.PLANES_SOURCE.read_text()
    assert f"constexpr int kChunkK = {int_matmul.INT64_CHUNK};" in source
    assert "constexpr int kBK = 128;" in (int_matmul.PLANES_SOURCE.parent / "wgmma_int8.cuh").read_text()


@pytest.mark.parametrize("dtype", PLANE_TYPES)
def test_planes_reference(dtype):
    """The split kernels' plain version: plane p holds byte p of each entry (the little-endian
    bytes of its two's complement), zeros from k to k_pad; Bᵀ's planes are those of B's
    columns, and a one-column B needs no transpose."""
    x = _full_range(dtype, (5, 19), 111)
    planes = int_matmul.planes_reference(torch.from_numpy(x), 32)
    nbytes = x.dtype.itemsize
    assert planes.shape == (nbytes, 5, 32) and planes.dtype == torch.uint8 and not planes[..., 19:].any()
    np.testing.assert_array_equal(planes[..., :19].numpy(), np.moveaxis(x.astype(f"<{x.dtype.str[1:]}").view(np.uint8)
                                                                          .reshape(5, 19, nbytes), 2, 0))
    b = torch.from_numpy(_full_range(dtype, (2, 19, 6), 112))
    assert torch.equal(int_matmul._split_t(b, 32), int_matmul.planes_reference(b.transpose(-1, -2).reshape(12, 19), 32))
    col = b[:, :, :1].contiguous()
    assert torch.equal(int_matmul._split_t(col, 32), int_matmul.planes_reference(col.view(2, 19), 32))


def test_plane_launch_counts_under_the_lock():
    """The byte-plane product's and its splits' counters are the package's
    ``int_matmul_planes``, ``int_planes`` and ``int_planes_t`` kernels, built from
    int_gemm_planes.cu, move under the lock and reset with the others; CPU tensors launch
    nothing."""
    from heat_tpu_torch.core import kernels

    assert kernels.KERNELS["int_matmul_planes"] is int_matmul.byte_planes
    assert kernels.KERNELS["int_planes"] is int_matmul.split_planes
    assert kernels.KERNELS["int_planes_t"] is int_matmul.split_planes_t
    assert {int_matmul.byte_planes.SOURCE, int_matmul.split_planes.SOURCE, int_matmul.split_planes_t.SOURCE} == {
        int_matmul.PLANES_SOURCE}
    assert int_matmul.PLANES_SOURCE.is_file()
    saved = kernels.launch_counts()
    try:
        for dtype in (torch.int16, torch.int32, torch.int64):
            a = torch.ones((4, 40), dtype=dtype)
            int_matmul.matmul(a, a.T)
            int_matmul.matmul(a, a[0])
        assert kernels.launch_counts() == saved
        with int_matmul._count_lock:
            int_matmul.byte_planes.launches += 1
            int_matmul.split_planes.launches += 2
            int_matmul.split_planes_t.launches += 3
        counts = kernels.launch_counts()
        assert [counts[n] - saved[n] for n in ("int_matmul_planes", "int_planes", "int_planes_t")] == [1, 2, 3]
        kernels.reset_launch_counts()
        assert counts.keys() == kernels.launch_counts().keys() and not any(kernels.launch_counts().values())
    finally:
        for name, mod in kernels.KERNELS.items():
            mod.launches = saved[name]


@pytest.mark.parametrize("dtype", ["int8", "int32"])
def test_batches_past_the_grid_run_in_turns(dtype, monkeypatch):
    """A batch past MAX_BATCH (65,535, the matrix kernels' grid z) is launched in runs of at
    most that many, each run's operands and output the batch's own slices, A shared where
    it is one matrix; heat_tpu computes any batch. The launches are replayed on the CPU by
    the kernels' plain versions."""
    batches = []

    def fake(a, b, a_batch, b_batch, batch, c):
        batches.append(batch)
        c.copy_(torch.matmul(a.to(torch.int64), b.to(torch.int64)).to(c.dtype).expand(batch, *c.shape[1:]))

    monkeypatch.setattr(int_matmul, "_launch_tc" if dtype == "int8" else "_launch_planes", fake)
    batch = int_matmul.MAX_BATCH + 3
    a, b = _full_range(dtype, (batch, 2, 3), 121), _full_range(dtype, (3, 2), 122)
    a3, b3, a_batch, b_batch, batch_shape = int_matmul.batched(torch.from_numpy(a), torch.from_numpy(b))
    got = int_matmul._launch(a3, b3, a_batch, b_batch, batch_shape.numel())
    assert batches == [int_matmul.MAX_BATCH, 3]
    _same(htt.array(got), ht.matmul(ht.array(a), ht.array(b)))
    batches.clear()
    shared = int_matmul._launch(torch.from_numpy(b.T.copy()), torch.from_numpy(a).transpose(1, 2).contiguous(), 0,
                                6, batch)
    assert batches == [int_matmul.MAX_BATCH, 3]
    _same(htt.array(shared), ht.matmul(ht.array(b.T.copy()), ht.array(a.transpose(0, 2, 1).copy())))
