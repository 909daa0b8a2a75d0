"""heat_tpu_torch.random against heat_tpu.random: after the same ``seed`` the uniform
floats, integers and permutations are heat_tpu's bit for bit, at heat_tpu's one and
eight devices and at splits None, 0 and 1; the normal draws are within 4 ulp (float32) and
32 ulp (float64); the state tuple advances as heat_tpu's. The hash itself is held against
jax's Threefry-2x32 and the key derivations against jax.random's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu as ht
from heat_tpu.core.communication import MeshCommunication

import heat_tpu_torch as htt
from heat_tpu_torch.core import random as prandom
from _torch_parity import cases, check

RANDOM = cases(["rand", "second_draw", "permutation", "kmeans_random"])


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


@pytest.mark.parametrize("name,split", RANDOM, ids=[f"{n}-{s}" for n, s in RANDOM])
def test_stream_matches_heat_tpu(name, split):
    check(name, split)


DRAWS = {
    "rand": lambda m, kw: m.random.rand(4, 6, **kw),
    "rand_f64": lambda m, kw: m.random.random((3, 5), dtype=m.float64, **kw),
    "randint": lambda m, kw: m.random.randint(5, 90, (6, 4), **kw),
    "randint_i64": lambda m, kw: m.random.randint(-7, 2**30, (9,), dtype=m.int64, **kw),
    "randint_one": lambda m, kw: m.random.randint(7, **kw),
    "randperm": lambda m, kw: m.random.randperm(31, **kw),
    "scalar": lambda m, kw: m.random.rand(**kw),
}


@pytest.mark.parametrize("seed", [0, 12345, 2**33 + 7])
@pytest.mark.parametrize("devices", [1, 8])
@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draws_bit_for_bit(name, devices, seed):
    """A run of three draws equals heat_tpu's bit for bit, on one device and on eight."""
    comm = MeshCommunication(jax.devices()[:devices])
    ht.random.seed(seed)
    htt.random.seed(seed)
    for _ in range(3):
        want = DRAWS[name](ht, {"comm": comm})
        got = DRAWS[name](htt, {})
        assert got.dtype.__name__ == want.dtype.__name__ and got.gshape == want.gshape
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert htt.random.get_state() == ht.random.get_state()


@pytest.mark.parametrize("dtype,ulps", [("float32", 4), ("float64", 32)])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_normal_within_ulps(dtype, ulps, split):
    ht.random.seed(21)
    htt.random.seed(21)
    want = ht.random.randn(40, 25, dtype=getattr(ht, dtype), split=split)
    got = htt.random.randn(40, 25, dtype=getattr(htt, dtype), split=split)
    w, g = want.numpy(), got.numpy()
    assert g.dtype == w.dtype and got.split == want.split
    assert np.all(np.abs(g - w) <= ulps * np.spacing(np.abs(w)))
    got = htt.random.normal(2.0, 3.0, (5, 5))
    want = ht.random.normal(2.0, 3.0, (5, 5))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
    assert htt.random.get_state() == ht.random.get_state()


def test_state_roundtrip():
    htt.random.seed(3)
    htt.random.rand(10)
    state = htt.random.get_state()
    a = htt.random.rand(5).numpy()
    htt.random.set_state(state)
    np.testing.assert_array_equal(htt.random.rand(5).numpy(), a)
    ht.random.seed(3)
    ht.random.rand(10)
    assert ht.random.get_state() == state
    with pytest.raises(ValueError):
        htt.random.set_state(("Philox", 0, 0, 0, 0.0))


@pytest.mark.parametrize("seed", [0, 1, 99, 2**40 + 5])
def test_key_derivation_is_jax_random(seed):
    """key, fold_in and split as jax.random's (partitionable Threefry)."""
    key = jax.random.key(seed)
    assert prandom._key(seed) == tuple(int(v) for v in jax.random.key_data(key))
    for data in (0, 7, 2**32 - 1):
        want = jax.random.key_data(jax.random.fold_in(key, data))
        assert prandom._fold_in(prandom._key(seed), data) == tuple(int(v) for v in want)
    a, b = jax.random.split(key)
    assert prandom._split(prandom._key(seed)) == (
        tuple(int(v) for v in jax.random.key_data(a)), tuple(int(v) for v in jax.random.key_data(b)))


def test_threefry_on_tensors_is_jax_bits():
    """The hash on int64 lanes gives jax.random.bits of a (13, 7) draw."""
    key = jax.random.key(77)
    want = np.asarray(jax.random.bits(key, (13, 7), jnp.uint32)).astype(np.int64)
    got = prandom._bits32(prandom._key(77), (13, 7), None, htt.get_comm(), torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,fn,ulps", [(np.float32, prandom._erfinv32, 2), (np.float64, prandom._erfinv64, 32)])
def test_erfinv_is_xlas(dtype, fn, ulps):
    x = np.linspace(-1, 1, 20001).astype(dtype)[1:-1]
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = fn(torch.from_numpy(x)).numpy()
    assert np.all(np.abs(got - want) <= ulps * np.spacing(np.abs(want)))
    edges = fn(torch.tensor([-1.0, 1.0], dtype=torch.float32 if dtype == np.float32 else torch.float64))
    assert torch.isinf(edges).all()


def test_randint_refuses_wide_int64_spans():
    """Bounds past int64 raise OverflowError, as jax's argument parsing does; spans of
    2**31 and more within int64 are drawn as heat_tpu draws them (jax's uint64 arithmetic
    replayed in limbs)."""
    with pytest.raises(OverflowError):
        htt.random.randint(0, 2**63, (3,), dtype=htt.int64)
    with pytest.raises(OverflowError):
        ht.random.randint(0, 2**63, (3,), dtype=ht.int64)
    htt.random.seed(31)
    ht.random.seed(31)
    np.testing.assert_array_equal(htt.random.randint(0, 2**40, (3,), dtype=htt.int64).numpy(),
                                  ht.random.randint(0, 2**40, (3,), dtype=ht.int64).numpy())


@pytest.mark.parametrize("s", [2**31, 2**31 + 1, 2**40 - 3, 2**40, 2**53 + 1, 2**63 - 1, 2**63, (2**64) // 3 + 1,
                               3 * 2**62, 2**64 - 1, 0xDEADBEEFCAFEF00D])
def test_u64_mod_is_exact(s):
    """randint's remainder by a constant span of 2**31 or more, in 32-bit limbs, against
    Python's integers: random words, and words at and beside multiples of s, where the
    float64 quotient it starts from is least sure."""
    rng = np.random.default_rng(s % 2**32)
    xs = [int(v) for v in rng.integers(0, 2**64, 64, dtype=np.uint64)]
    for q in (1, 2, 3, (2**64 - 1) // s, rng.integers(1, max(2, (2**64 - 1) // s))):
        for d in (-2, -1, 0, 1, 2):
            xs.append((int(q) * s + d) % 2**64)
    xs += [0, 1, s - 1, 2**64 - 1, 2**63, 2**32 - 1, 2**32]
    x = (torch.tensor([v >> 32 for v in xs]), torch.tensor([v & prandom.M32 for v in xs]))
    rh, rl = prandom._u64_mod(x, s)
    assert [(h << 32) | l for h, l in zip(rh.tolist(), rl.tolist())] == [v % s for v in xs]
