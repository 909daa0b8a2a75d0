"""The split-axis forms of heat_tpu_torch's trace, triangles, vdot, norms and cov against
heat_tpu's, the port as one rank: the cases of tests/_torch_array_cases.py at splits None,
0 and 1 (their world-3 runs, and the forms' data movement, are in
tests/test_torch_distributed.py), and the D pass's plain version against heat_tpu's jnp
pre-pass."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu_torch as htt
from _torch_parity import cases, check
from heat_tpu_torch.core.kernels import flash_attention as fa

FORMS = cases(["trace_", "tri_", "vdot_", "norm_", "cov_"])


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


@pytest.mark.parametrize("name,split", FORMS, ids=[f"{n}-{s}" for n, s in FORMS])
def test_split_form_matches_heat_tpu(name, split):
    check(name, split)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d", [1, 33, 64, 100])
def test_d_pass_plain_matches_heat_tpu(dtype, d):
    """The D pass's plain version (``d_pass_reference``) and its wrapper on CPU tensors
    against heat_tpu's pre-pass of ``_flash_bwd_pallas`` (Σ_c f32(dO)·f32(O),
    flash_attention.py:592-596), on the same inputs: f32 sums of the same f32 products in
    another order, within 2·γ_d·Σ|dO∘O| a row (γ_d = d·u / (1 − d·u), u = 2⁻²⁴)."""
    rng = np.random.default_rng(d)
    o, do = (rng.standard_normal((2, 37, d)).astype(np.float32) for _ in range(2))
    to, tdo = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (o, do))
    jo, jdo = (jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype)) for t in (to, tdo))
    # heat_tpu's pre-pass, as _flash_bwd_pallas writes it inline (:592-596)
    want = np.asarray(jnp.sum(jdo.astype(jnp.float32) * jo.astype(jnp.float32), axis=-1))
    u = 2.0**-24
    tol = 2 * (d * u / (1 - d * u)) * fa.d_pass_reference(to.abs(), tdo.abs()).numpy() + 1e-30
    for got in (fa.d_pass_reference(to, tdo), fa.d_pass(to, tdo)):
        assert got.dtype == torch.float32 and got.shape == (2, 37)
        assert np.all(np.abs(got.numpy() - want) <= tol)
