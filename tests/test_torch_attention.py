"""heat_tpu_torch.nn's attention stack against heat_tpu.nn's, on the CPU.

scaled_dot_product_attention, MultiheadAttention and the Transformer family of the port
take the same numpy inputs as heat_tpu's (whose attention takes its XLA path on the
CPU), with heat_tpu's ``init`` parameters carried across by ``interop.load_jax_params``.
Tolerances: both sides compute in fp32 and differ in summation order only; 1e-4 for a
Transformer of 2+2 layers (about 30 products deep), 2e-5 for one attention.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as jht
from heat_tpu.nn.attention import scaled_dot_product_attention as jax_sdpa

import heat_tpu_torch as ht
from heat_tpu_torch.core.kernels import flash_attention as k2
from heat_tpu_torch.interop import load_jax_params
from heat_tpu_torch.nn import attention as port_attention

ATOL_ONE = dict(rtol=2e-5, atol=2e-5)
ATOL_STACK = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------- sdpa
SDPA_CASES = {
    "plain": dict(tq=9, tk=9),
    "causal": dict(tq=9, tk=9, is_causal=True),
    "causal_tq_lt_tk": dict(tq=5, tk=11, is_causal=True),
    "causal_tq_gt_tk": dict(tq=11, tk=5, is_causal=True),
    "scale": dict(tq=9, tk=7, scale=0.7),
    "bool_mask": dict(tq=9, tk=7, mask="bool"),
    "bool_mask_4d": dict(tq=9, tk=7, mask="bool4d"),
    "float_mask": dict(tq=9, tk=7, mask="float"),
    "bool_mask_causal_dead_row": dict(tq=9, tk=9, mask="dead", is_causal=True),
}


def _sdpa_inputs(tq, tk, mask=None, **_):
    b, h, d = 2, 3, 8
    q, k, v = _rand((b, h, tq, d), 1), _rand((b, h, tk, d), 2), _rand((b, h, tk, d), 3)
    rng = np.random.default_rng(4)
    m = None
    if mask == "bool":
        m = rng.random((tq, tk)) < 0.6
    elif mask == "bool4d":
        m = rng.random((b, 1, 1, tk)) < 0.6
    elif mask == "float":
        m = rng.standard_normal((tq, tk)).astype(np.float32)
    elif mask == "dead":
        m = rng.random((tq, tk)) < 0.6
        m[2] = False
    return q, k, v, m


@pytest.mark.parametrize("name", list(SDPA_CASES))
def test_sdpa_matches_heat_tpu(name):
    case = SDPA_CASES[name]
    q, k, v, m = _sdpa_inputs(**case)
    kw = dict(is_causal=case.get("is_causal", False), scale=case.get("scale"))
    want = jax_sdpa(_j(q), _j(k), _j(v), attn_mask=_j(m), **kw)
    got = ht.nn.scaled_dot_product_attention(_t(q), _t(k), _t(v), attn_mask=_t(m), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL_ONE)
    if name == "bool_mask_causal_dead_row":
        assert float(got[:, :, 2].abs().max()) == 0.0


@pytest.mark.parametrize("hkv", [1, 2, 4])
def test_sdpa_gqa_matches_heat_tpu(hkv):
    q = _rand((2, 4, 6, 8), 5)
    k, v = _rand((2, hkv, 7, 8), 6), _rand((2, hkv, 7, 8), 7)
    want = jax_sdpa(_j(q), _j(k), _j(v), enable_gqa=True)
    got = ht.nn.scaled_dot_product_attention(_t(q), _t(k), _t(v), enable_gqa=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL_ONE)


def test_sdpa_errors():
    q = torch.zeros(1, 4, 5, 8)
    with pytest.raises(ValueError, match="dropout_p"):
        ht.nn.scaled_dot_product_attention(q, q, q, dropout_p=1.5)
    with pytest.raises(ValueError, match="dropout_key"):
        ht.nn.scaled_dot_product_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(ValueError, match="Hkv"):
        ht.nn.scaled_dot_product_attention(q, torch.zeros(1, 3, 5, 8), torch.zeros(1, 3, 5, 8), enable_gqa=True)
    # ring, zigzag and Ulysses attention now run: at one rank each is the dense attention
    # (zigzag: causal, its one rank's two chunks in order); float64 is not a kernel type
    x = _t(_rand((1, 4, 6, 8), 9))
    for fn, kw in ((ht.nn.ring_attention, {}), (ht.nn.ring_attention_zigzag, {"causal": True}),
                   (ht.nn.ulysses_attention, {})):
        want = jax_sdpa(_j(x.numpy()), _j(x.numpy()), _j(x.numpy()), is_causal=bool(kw))
        np.testing.assert_allclose(fn(x, x, x).numpy(), np.asarray(want), **ATOL_ONE)
    with pytest.raises(ValueError, match="ring attention takes"):
        ht.nn.ring_attention(q.double(), q.double(), q.double())


@pytest.mark.parametrize("split", [None, 0, 1, 2, 3])
def test_sdpa_on_dndarrays_keeps_the_query_split(split):
    q, k, v, m = _sdpa_inputs(tq=9, tk=7, mask="bool")
    want = jax_sdpa(jht.array(q, split=split), jht.array(k, split=split), jht.array(v, split=split), attn_mask=_j(m))
    got = ht.nn.scaled_dot_product_attention(
        ht.array(q, split=split), ht.array(k, split=split), ht.array(v, split=split), attn_mask=_t(m)
    )
    assert isinstance(got, ht.DNDarray)
    assert got.split == want.split == split and got.gshape == want.gshape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ATOL_ONE)


# ---------------------------------------------------------------------- MHA
def _mha_pair(e=16, h=4, seed=0, **kw):
    jm = jht.nn.MultiheadAttention(e, h, **kw)
    params = jm.init(jax.random.key(seed))
    tm = ht.nn.MultiheadAttention(e, h, **kw)
    load_jax_params(tm, _np_params(params))
    return jm, params, tm


MHA_CASES = {
    "self": dict(),
    "self_causal": dict(is_causal=True),
    "bool_attn_mask": dict(attn_mask="bool"),
    "float_attn_mask": dict(attn_mask="float"),
    "key_padding_bool": dict(key_padding_mask="bool"),
    "key_padding_float": dict(key_padding_mask="float"),
    "bool_attn_mask_and_key_padding": dict(attn_mask="bool", key_padding_mask="bool"),
    "cross": dict(cross=True),
    "cross_causal": dict(cross=True, is_causal=True),
}


def _mha_masks(case, t, s, b=3):
    rng = np.random.default_rng(9)
    am = kpm = None
    if case.get("attn_mask") == "bool":
        am = rng.random((t, s)) < 0.3  # torch MHA: True = do NOT attend
    elif case.get("attn_mask") == "float":
        am = rng.standard_normal((t, s)).astype(np.float32)
    if case.get("key_padding_mask") == "bool":
        kpm = np.zeros((b, s), bool)
        kpm[:, -2:] = True  # True = ignore that key
        kpm[1, 0] = True
    elif case.get("key_padding_mask") == "float":
        kpm = rng.standard_normal((b, s)).astype(np.float32)
    return am, kpm


@pytest.mark.parametrize("name", list(MHA_CASES))
def test_mha_matches_heat_tpu(name):
    case = MHA_CASES[name]
    b, t, e = 3, 6, 16
    s = 9 if case.get("cross") else t
    jm, params, tm = _mha_pair(e)
    x = _rand((b, t, e), 10)
    mem = _rand((b, s, e), 11) if case.get("cross") else x
    am, kpm = _mha_masks(case, t, s, b)
    kw = dict(is_causal=case.get("is_causal", False))
    inp = (_j(x), _j(mem), _j(mem)) if case.get("cross") else _j(x)
    want = jm.apply(params, inp, attn_mask=_j(am), key_padding_mask=_j(kpm), **kw)
    got, weights = tm(_t(x), _t(mem), _t(mem), attn_mask=_t(am), key_padding_mask=_t(kpm), **kw)
    assert weights is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ATOL_ONE)


def test_mha_kdim_vdim_and_seq_first_match_heat_tpu():
    e, kd, vd = 16, 10, 12
    jm, params, tm = _mha_pair(e, 4, seed=3, kdim=kd, vdim=vd, batch_first=False)
    assert tm.in_proj_weight is None and tuple(tm.k_proj_weight.shape) == (e, kd)
    q, k, v = _rand((6, 2, e), 12), _rand((8, 2, kd), 13), _rand((8, 2, vd), 14)
    want = jm.apply(params, (_j(q), _j(k), _j(v)))
    got, _ = tm(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ATOL_ONE)


def test_mha_bool_mask_is_inverted_against_sdpa():
    """torch MHA's bool True means "do not attend": the same bool mask gives sdpa's
    result for the inverted mask."""
    _, _, tm = _mha_pair(8, 2)
    x = _t(_rand((2, 5, 8), 15))
    am = torch.from_numpy(np.random.default_rng(1).random((5, 5)) < 0.4)
    got, _ = tm(x, attn_mask=am)
    with torch.no_grad():
        q, k, v = tm._project(x, x, x)
        heads = lambda t: t.reshape(2, 5, 2, 4).transpose(1, 2)
        o = ht.nn.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=~am)
        want = torch.nn.functional.linear(o.transpose(1, 2).reshape(2, 5, 8), tm.out_proj_weight, tm.out_proj_bias)
    torch.testing.assert_close(got, want, **ATOL_ONE)


@pytest.mark.parametrize("split", [None, 0, 1, 2])
def test_mha_on_dndarrays_matches_heat_tpu(split):
    jm, params, tm = _mha_pair(16, 4, seed=5)
    x = _rand((3, 6, 16), 16)
    _, kpm = _mha_masks({"key_padding_mask": "bool"}, 6, 6)
    want = jm.apply(params, jht.array(x, split=split), key_padding_mask=_j(kpm))
    got, _ = tm(ht.array(x, split=split), key_padding_mask=_t(kpm))
    assert isinstance(got, ht.DNDarray)
    # the batch and sequence splits survive the projections, the embedding split does not
    assert got.split == want.split == (split if split in (0, 1) else None)
    assert got.gshape == want.gshape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ATOL_ONE)


def test_mha_errors():
    _, _, tm = _mha_pair(8, 2)
    x = torch.zeros(1, 3, 8)
    with pytest.raises(NotImplementedError, match="need_weights"):
        tm(x, need_weights=True)
    with pytest.raises(ValueError, match="divisible"):
        ht.nn.MultiheadAttention(10, 3)
    with pytest.raises(ValueError, match="dropout"):
        ht.nn.MultiheadAttention(8, 2, dropout=1.5)
    drop = ht.nn.MultiheadAttention(8, 2, dropout=0.1)
    assert not drop.training  # eval mode from the start, as heat_tpu's modules
    drop(x)
    drop.train()
    with pytest.raises(ValueError, match="key"):  # train-mode dropout takes heat_tpu's key
        drop(x)


# ---------------------------------------------------------------------- Transformer
TRANSFORMER_CASES = {
    "post_norm_relu_tgt_is_causal": dict(norm_first=False, activation="relu", causal="flag"),
    "post_norm_gelu_square_mask": dict(norm_first=False, activation="gelu", causal="mask"),
    "pre_norm_relu_square_mask": dict(norm_first=True, activation="relu", causal="mask"),
    "pre_norm_gelu_tgt_is_causal": dict(norm_first=True, activation="gelu", causal="flag"),
}
D_MODEL, NHEAD, DFF = 64, 4, 128


def _transformer_pair(seed=0, **kw):
    cfg = dict(d_model=D_MODEL, nhead=NHEAD, num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=DFF, **kw)
    jm = jht.nn.Transformer(**cfg)
    params = jm.init(jax.random.key(seed))
    tm = ht.nn.Transformer(**cfg)
    load_jax_params(tm, _np_params(params))
    return jm, params, tm


@pytest.mark.parametrize("name", list(TRANSFORMER_CASES))
def test_transformer_matches_heat_tpu(name):
    case = TRANSFORMER_CASES[name]
    jm, params, tm = _transformer_pair(seed=len(name), norm_first=case["norm_first"], activation=case["activation"])
    src, tgt = _rand((2, 12, D_MODEL), 20), _rand((2, 7, D_MODEL), 21)
    if case["causal"] == "flag":
        want = jm.apply(params, _j(src), _j(tgt), tgt_is_causal=True)
        got = tm(_t(src), _t(tgt), tgt_is_causal=True)
    else:
        jmask = jht.nn.Transformer.generate_square_subsequent_mask(7)
        tmask = ht.nn.Transformer.generate_square_subsequent_mask(7)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        want = jm.apply(params, _j(src), _j(tgt), tgt_mask=jmask)
        got = tm(_t(src), _t(tgt), tgt_mask=tmask)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ATOL_STACK)


def test_transformer_with_padding_masks_matches_heat_tpu():
    jm, params, tm = _transformer_pair(seed=7)
    src, tgt = _rand((3, 8, D_MODEL), 22), _rand((3, 5, D_MODEL), 23)
    spad = np.zeros((3, 8), bool)
    spad[0, -3:] = True
    tpad = np.zeros((3, 5), bool)
    tpad[2, -1] = True
    kw = dict(src_key_padding_mask=spad, memory_key_padding_mask=spad, tgt_key_padding_mask=tpad)
    want = jm.apply(params, _j(src), _j(tgt), tgt_is_causal=True, **{k: _j(v) for k, v in kw.items()})
    got = tm(_t(src), _t(tgt), tgt_is_causal=True, **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **ATOL_STACK)


@pytest.mark.parametrize("split", [0, 1])
def test_transformer_on_dndarrays_matches_heat_tpu(split):
    jm, params, tm = _transformer_pair(seed=8)
    src, tgt = _rand((2, 12, D_MODEL), 24), _rand((2, 7, D_MODEL), 25)
    want = jm.apply(params, _j(src), _j(tgt), tgt_is_causal=True)
    got = tm(ht.array(src, split=split), ht.array(tgt, split=split), tgt_is_causal=True)
    assert isinstance(got, ht.DNDarray) and got.split == split and got.gshape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL_STACK)


def test_transformer_layers_get_fresh_parameters():
    tm = ht.nn.Transformer(d_model=16, nhead=2, num_encoder_layers=3, num_decoder_layers=2, dim_feedforward=32)
    enc = tm.encoder.layers
    assert len(enc) == 3 and len(tm.decoder.layers) == 2
    assert not torch.equal(enc[0].linear1.weight, enc[1].linear1.weight)
    assert not torch.equal(enc[1].self_attn.in_proj_weight, enc[2].self_attn.in_proj_weight)
    assert not tm.training and not enc[0].training and not enc[0].norm1.training
    assert tm.encoder.norm is not None and tm.decoder.norm is not None


def test_transformer_defaults_are_the_base_model():
    """Transformer() is "Attention Is All You Need"'s base model: N = 6, d_model 512,
    d_ff 2048, 8 heads, and heat_tpu's parameter tree maps onto it key for key."""
    tm = ht.nn.Transformer()
    assert len(tm.encoder.layers) == 6 and len(tm.decoder.layers) == 6
    assert tm.encoder.layers[0].self_attn.num_heads == 8 and tm.encoder.layers[0].self_attn.head_dim == 64
    assert tuple(tm.encoder.layers[0].linear1.weight.shape) == (2048, 512)
    jshapes = jax.eval_shape(jht.nn.Transformer().init, jax.random.key(0))
    flat = {
        ".".join(str(getattr(p, "key", p)) for p in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_leaves_with_path(jshapes)
    }
    state = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert set(flat) == set(state)
    for name, shape in state.items():
        assert flat[name] == (shape[::-1] if name.endswith(("linear1.weight", "linear2.weight")) else shape), name


def test_transformer_base_sends_every_attention_to_the_kernel(monkeypatch):
    """One forward of Transformer-base with a causal target makes 18 attention calls (6
    encoder self, 6 causal decoder self, 6 cross with Tq != Tk), and K2 takes every one:
    on the card each is one launch. Here, on the CPU, the gate's device test is
    replaced by a record of what the kernel would be given."""
    calls = []

    def record(q, k, v, mask=None, scale=None):
        calls.append((tuple(q.shape), tuple(k.shape), mask is None, k2.kernel_takes(q, k, v, mask, scale)))
        return False

    monkeypatch.setattr(port_attention, "use_flash", record)
    tm = ht.nn.Transformer()
    with torch.inference_mode():
        out = tm(_t(_rand((1, 12, 512), 30)), _t(_rand((1, 5, 512), 31)), tgt_is_causal=True)
    assert tuple(out.shape) == (1, 5, 512)
    assert len(calls) == 18 and all(mask_free and takes for _, _, mask_free, takes in calls)
    shapes = [(q, k) for q, k, _, _ in calls]
    assert shapes[:6] == [((1, 8, 12, 64), (1, 8, 12, 64))] * 6
    assert shapes[6:] == [((1, 8, 5, 64), (1, 8, 5, 64)), ((1, 8, 5, 64), (1, 8, 12, 64))] * 6


def test_load_jax_params_raises_on_a_mismatch():
    jm = jht.nn.MultiheadAttention(8, 2)
    params = _np_params(jm.init(jax.random.key(0)))
    tm = ht.nn.MultiheadAttention(8, 2)
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(tm, {k: v for k, v in params.items() if k != "out_proj_bias"})
    with pytest.raises(ValueError, match="extra"):
        load_jax_params(tm, {**params, "spare": np.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tm, {**params, "out_proj_weight": np.zeros((8, 4), np.float32)})
    lin = torch.nn.Sequential(torch.nn.Linear(3, 5))
    w = np.arange(15, dtype=np.float32).reshape(3, 5)  # heat_tpu's (in, out)
    load_jax_params(lin, {"0": {"weight": w, "bias": np.zeros(5, np.float32)}})
    np.testing.assert_array_equal(lin[0].weight.detach().numpy(), w.T)


def test_transformer_errors():
    tm = ht.nn.Transformer(d_model=16, nhead=2, num_encoder_layers=1, num_decoder_layers=1, dim_feedforward=32)
    x = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="src and tgt"):
        tm(x, None)
    tm.train()
    with pytest.raises(ValueError, match="key"):  # train-mode dropout takes heat_tpu's key
        tm(x, x)
    with pytest.raises(ValueError, match="activation"):
        ht.nn.TransformerEncoderLayer(16, 2, activation="swish")
    assert port_attention._resolve_activation(torch.tanh) is torch.tanh
