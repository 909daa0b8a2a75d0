"""heat_tpu_torch.nn's module zoo, nn.functional and recurrent layers against heat_tpu.nn's,
on the CPU at one rank.

Every function of heat_tpu's ``nn/functional.py`` and every name of its ``nn/modules.py``
and ``nn/recurrent.py`` is a parametrised case: the same numpy inputs from a seed go
through heat_tpu and the port, heat_tpu's ``init`` parameters carried across by
``interop.load_jax_params``. Both compute in fp32 and differ in summation order only, so
values agree within 2e-5 (1e-4 for the convolutions and the recurrent layers, deeper
sums); keyed dropout is held bit for bit. The three-rank cases (ring, zigzag and Ulysses
attention, sequence-split dispatch, dropout on split arrays, BatchNorm and the losses on a
ragged batch) are in tests/test_torch_distributed.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as jht
import heat_tpu.nn.functional as jF

import heat_tpu_torch as ht
import heat_tpu_torch.nn.functional as tF
from heat_tpu_torch.interop import load_jax_params

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "nn"))

TOL = dict(rtol=2e-5, atol=2e-5)
TOL_DEEP = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.key(7)


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")


def _rand(shape, seed, scale=1.0, low=None):
    rng = np.random.default_rng(seed)
    if low is not None:
        return rng.uniform(low, 1 - low, shape).astype(np.float32)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _ints(shape, seed, high):
    return np.random.default_rng(seed).integers(0, high, shape)


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(t) for t in x]
    if isinstance(x, ht.DNDarray):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


class Side:
    """One framework's view of a case: its functional module, array and key."""

    def __init__(self, port: bool):
        self.port = port
        self.F = tF if port else jF
        self.key = np.asarray(jax.random.key_data(KEY)) if port else KEY

    def a(self, x):
        return torch.from_numpy(np.array(x)) if self.port else jnp.asarray(x)


X = _rand((4, 6), 1)
X3 = _rand((3, 4, 5), 2)
X4 = _rand((2, 4, 6, 6), 3)
X1D = _rand((2, 3, 11), 4)
LOGITS, LABELS = _rand((6, 5), 5), _ints(6, 6, 5)
LABELS[2] = 1  # an ignored target in the cases with ignore_index=1
W5 = _rand(5, 7, low=0.2)

# name: fn(side) -> the framework's result; the 43 names of heat_tpu's nn/functional.py
FUNCTIONAL = {
    "relu": lambda s: s.F.relu(s.a(X)),
    "leaky_relu": lambda s: s.F.leaky_relu(s.a(X), 0.2),
    "gelu": lambda s: s.F.gelu(s.a(X)),
    "gelu_tanh": lambda s: s.F.gelu(s.a(X), approximate="tanh"),
    "elu": lambda s: s.F.elu(s.a(X), 0.7),
    "sigmoid": lambda s: s.F.sigmoid(s.a(X)),
    "tanh": lambda s: s.F.tanh(s.a(X)),
    "softmax": lambda s: s.F.softmax(s.a(X3), dim=1),
    "log_softmax": lambda s: s.F.log_softmax(s.a(X3)),
    "linear": lambda s: s.F.linear(s.a(X), s.a(_rand((3, 6), 8)), s.a(_rand(3, 9))),
    "conv1d": lambda s: s.F.conv1d(s.a(X1D), s.a(_rand((4, 3, 3), 10)), s.a(_rand(4, 11)), stride=2, padding=1),
    "conv2d": lambda s: s.F.conv2d(s.a(X4), s.a(_rand((6, 2, 3, 3), 12)), s.a(_rand(6, 13)), padding=1, groups=2),
    "conv2d_same": lambda s: s.F.conv2d(s.a(X4), s.a(_rand((3, 4, 2, 3), 14)), padding="same", dilation=2),
    "max_pool1d": lambda s: s.F.max_pool1d(s.a(X1D), 3, 2, 1),
    "max_pool2d": lambda s: s.F.max_pool2d(s.a(X4), 2),
    "avg_pool1d": lambda s: s.F.avg_pool1d(s.a(X1D), 3, 2, 1),
    "avg_pool2d": lambda s: s.F.avg_pool2d(s.a(X4), 3, 2, 1),
    "dropout": lambda s: s.F.dropout(s.a(X3), 0.3, key=s.key),
    "dropout2d": lambda s: s.F.dropout2d(s.a(X4), 0.5, key=s.key),
    "batch_norm": lambda s: s.F.batch_norm(s.a(X4), None, None, s.a(_rand(4, 15)), s.a(_rand(4, 16)), training=True),
    "batch_norm_running": lambda s: s.F.batch_norm(s.a(X4), s.a(_rand(4, 17)), s.a(_rand(4, 18, low=0.3)))[0],
    "layer_norm": lambda s: s.F.layer_norm(s.a(X3), (4, 5), s.a(_rand((4, 5), 19)), s.a(_rand((4, 5), 20))),
    "group_norm": lambda s: s.F.group_norm(s.a(X4), 2, s.a(_rand(4, 21)), s.a(_rand(4, 22))),
    "flatten": lambda s: s.F.flatten(s.a(X4), 1),
    "one_hot": lambda s: s.F.one_hot(s.a(LABELS), 5),
    "nll_loss": lambda s: s.F.nll_loss(s.F.log_softmax(s.a(LOGITS), 1), s.a(LABELS), weight=s.a(W5), ignore_index=1),
    "nll_loss_none": lambda s: s.F.nll_loss(s.a(_rand((2, 5, 3), 23)), s.a(_ints((2, 3), 24, 5)), reduction="none"),
    "cross_entropy": lambda s: s.F.cross_entropy(s.a(LOGITS), s.a(LABELS), weight=s.a(W5), label_smoothing=0.2),
    "cross_entropy_sum": lambda s: s.F.cross_entropy(s.a(LOGITS), s.a(LABELS), ignore_index=1, reduction="sum"),
    "mse_loss": lambda s: s.F.mse_loss(s.a(X), s.a(_rand((4, 6), 25))),
    "l1_loss": lambda s: s.F.l1_loss(s.a(X), s.a(_rand((4, 6), 26)), reduction="sum"),
    "silu": lambda s: s.F.silu(s.a(X)),
    "mish": lambda s: s.F.mish(s.a(X)),
    "softplus": lambda s: s.F.softplus(s.a(X * 4), beta=2.0, threshold=5.0),
    "hardtanh": lambda s: s.F.hardtanh(s.a(X), -0.5, 0.5),
    "embedding": lambda s: s.F.embedding(s.a(_ints((3, 4), 27, 7)), s.a(_rand((7, 3), 28)), padding_idx=0),
    "conv_transpose2d": lambda s: s.F.conv_transpose2d(s.a(X4), s.a(_rand((4, 3, 3, 3), 29)), s.a(_rand(3, 30)),
                                                        stride=2, padding=1, output_padding=1),
    "adaptive_avg_pool2d": lambda s: s.F.adaptive_avg_pool2d(s.a(_rand((2, 3, 7, 9), 31)), (3, 4)),
    "adaptive_max_pool2d": lambda s: s.F.adaptive_max_pool2d(s.a(_rand((2, 3, 7, 9), 32)), 2),
    "pad": lambda s: s.F.pad(s.a(X4), (1, 2, 0, 1), value=0.5),
    "pad_reflect": lambda s: s.F.pad(s.a(X4), (2, 1, 1, 1), mode="reflect"),
    "normalize": lambda s: s.F.normalize(s.a(X3), p=3.0, dim=1),
    "cosine_similarity": lambda s: s.F.cosine_similarity(s.a(X3), s.a(_rand((3, 4, 5), 33)), dim=2),
    "pairwise_distance": lambda s: s.F.pairwise_distance(s.a(X), s.a(_rand((4, 6), 34)), keepdim=True),
    "binary_cross_entropy": lambda s: s.F.binary_cross_entropy(s.a(_rand((4, 6), 35, low=0.05)),
                                                                s.a((_rand((4, 6), 36) > 0).astype(np.float32)),
                                                                weight=s.a(_rand(6, 37, low=0.1))),
    "binary_cross_entropy_with_logits": lambda s: s.F.binary_cross_entropy_with_logits(
        s.a(X), s.a((_rand((4, 6), 38) > 0).astype(np.float32)), pos_weight=s.a(_rand(6, 39, low=0.1))),
    "smooth_l1_loss": lambda s: s.F.smooth_l1_loss(s.a(X), s.a(_rand((4, 6), 40)), beta=0.5),
    "smooth_l1_loss_l1": lambda s: s.F.smooth_l1_loss(s.a(X), s.a(_rand((4, 6), 41)), reduction="none", beta=0.0),
    "huber_loss": lambda s: s.F.huber_loss(s.a(X), s.a(_rand((4, 6), 42)), delta=0.7),
    "scaled_dot_product_attention": lambda s: s.F.scaled_dot_product_attention(
        s.a(_rand((2, 2, 5, 4), 43)), s.a(_rand((2, 2, 7, 4), 44)), s.a(_rand((2, 2, 7, 4), 45)), is_causal=True),
    "sdpa_dropout": lambda s: s.F.scaled_dot_product_attention(
        s.a(_rand((2, 2, 5, 4), 46)), s.a(_rand((2, 2, 5, 4), 47)), s.a(_rand((2, 2, 5, 4), 48)), dropout_p=0.4,
        dropout_key=s.key),
}
EXACT = {"dropout", "dropout2d", "one_hot", "relu", "hardtanh", "max_pool1d", "max_pool2d", "flatten", "embedding",
         "adaptive_max_pool2d", "pad", "pad_reflect"}


def test_functional_covers_heat_tpu():
    assert set(tF.__all__) == set(jF.__all__) and len(tF.__all__) == 43
    assert {n for n in FUNCTIONAL if n in jF.__all__} == set(jF.__all__)


@pytest.mark.parametrize("name", list(FUNCTIONAL))
def test_functional_matches_heat_tpu(name):
    want, got = _np(FUNCTIONAL[name](Side(False))), _np(FUNCTIONAL[name](Side(True)))
    for w, g in zip(want if isinstance(want, list) else [want], got if isinstance(got, list) else [got]):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        if name in EXACT:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **(TOL_DEEP if "conv" in name else TOL))


@pytest.mark.parametrize("split", [None, 0, 1, 2])
@pytest.mark.parametrize("name", ["relu", "softmax", "layer_norm", "dropout", "flatten", "linear3"])
def test_functional_on_dndarrays_keeps_heat_tpus_split(name, split):
    """At one rank a DNDarray's split follows heat_tpu's rule for the op."""
    fns = {
        "relu": lambda F, x, k: F.relu(x),
        "softmax": lambda F, x, k: F.softmax(x, dim=1),
        "layer_norm": lambda F, x, k: F.layer_norm(x, 5),
        "dropout": lambda F, x, k: F.dropout(x, 0.5, key=k),
        "flatten": lambda F, x, k: F.flatten(x, 1),
        "linear3": lambda F, x, k: F.linear(x, jnp.ones((2, 5)) if F is jF else torch.ones(2, 5)),
    }
    want = fns[name](jF, jht.array(X3, split=split), KEY)
    got = fns[name](tF, ht.array(X3, split=split), Side(True).key)
    assert isinstance(got, ht.DNDarray) and got.split == want.split and got.gshape == want.gshape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_dropout_refusals():
    x = torch.ones(3, 4)
    assert tF.dropout(x, 0.5, training=False) is x and tF.dropout(x, 0.0, key=(0, 1)) is x
    for fn in (tF.dropout, tF.dropout2d):
        with pytest.raises(ValueError, match="key"):
            fn(x[None, None], 0.5)
    with pytest.raises(ValueError, match="uint32"):
        tF.dropout(x, 0.5, key=(1, 2, 3))
    with pytest.raises(ValueError, match="same"):
        tF.conv2d(torch.ones(1, 1, 5, 5), torch.ones(1, 1, 3, 3), stride=2, padding="same")
    with pytest.raises(ValueError, match="pad mode"):
        tF.pad(x, (1, 1), mode="wrap")
    with pytest.raises(ValueError, match="divisible"):
        tF.group_norm(torch.ones(2, 3, 4), 2)


# ---------------------------------------------------------------------- the module zoo
def _conv_net(m):
    return m.Sequential(m.Conv2d(4, 6, 3, padding=1), m.ReLU(), m.MaxPool2d(2), m.Flatten(), m.Linear(54, 5))


# name: (the module made from a framework's nn package ``m``, its input); every name of
# heat_tpu's nn/modules.py with LOSSES
MODULES = {
    "Linear": (lambda m: m.Linear(6, 3), X),
    "Embedding": (lambda m: m.Embedding(9, 4, padding_idx=2), _ints((3, 5), 50, 9)),
    "Conv2d": (lambda m: m.Conv2d(4, 6, 3, stride=2, padding=1, groups=2), X4),
    "ConvTranspose2d": (lambda m: m.ConvTranspose2d(4, 3, 3, stride=2, padding=1, output_padding=1), X4),
    "MaxPool2d": (lambda m: m.MaxPool2d(3, 2, 1), X4),
    "AvgPool2d": (lambda m: m.AvgPool2d(2), X4),
    "AdaptiveAvgPool2d": (lambda m: m.AdaptiveAvgPool2d((2, 4)), X4),
    "AdaptiveMaxPool2d": (lambda m: m.AdaptiveMaxPool2d(3), X4),
    "Conv1d": (lambda m: m.Conv1d(3, 5, 4, stride=1, padding=2, dilation=2), X1D),
    "MaxPool1d": (lambda m: m.MaxPool1d(2), X1D),
    "AvgPool1d": (lambda m: m.AvgPool1d(3, 2, 1), X1D),
    "BatchNorm1d": (lambda m: m.BatchNorm1d(4), X3),
    "BatchNorm2d": (lambda m: m.BatchNorm2d(4), X4),
    "GroupNorm": (lambda m: m.GroupNorm(2, 4), X4),
    "InstanceNorm2d": (lambda m: m.InstanceNorm2d(4, affine=True), X4),
    "LayerNorm": (lambda m: m.LayerNorm(5), X3),
    "ReLU": (lambda m: m.ReLU(), X),
    "ReLU6": (lambda m: m.ReLU6(), X * 5),
    "LeakyReLU": (lambda m: m.LeakyReLU(0.3), X),
    "PReLU": (lambda m: m.PReLU(4, 0.1), X4),
    "GELU": (lambda m: m.GELU("tanh"), X),
    "ELU": (lambda m: m.ELU(0.5), X),
    "SiLU": (lambda m: m.SiLU(), X),
    "Mish": (lambda m: m.Mish(), X),
    "Softplus": (lambda m: m.Softplus(2.0, 3.0), X * 3),
    "Hardtanh": (lambda m: m.Hardtanh(-0.3, 0.8), X),
    "Tanh": (lambda m: m.Tanh(), X),
    "Sigmoid": (lambda m: m.Sigmoid(), X),
    "Softmax": (lambda m: m.Softmax(), X3),
    "LogSoftmax": (lambda m: m.LogSoftmax(1), X3),
    "Identity": (lambda m: m.Identity(), X),
    "Flatten": (lambda m: m.Flatten(), X4),
    "Unflatten": (lambda m: m.Unflatten(1, (2, 3)), X),
    "Dropout": (lambda m: m.Dropout(0.4), X3),
    "Dropout2d": (lambda m: m.Dropout2d(0.5), X4),
    "Remat": (lambda m: m.Remat(m.Linear(6, 4)), X),
    "remat": (lambda m: m.remat(_conv_net(m)), X4),
    "Sequential": (lambda m: m.Sequential(m.Linear(6, 8), m.GELU(), m.Dropout(0.3), m.Linear(8, 2)), X),
    "Module": (lambda m: _mnist(m), _rand((3, 1, 28, 28), 51)),
    "ModuleList": (lambda m: _Stacked(m), X),
}
TRAIN = {"Dropout", "Dropout2d", "Sequential", "Module", "BatchNorm1d", "BatchNorm2d", "remat", "ModuleList"}
LOSSES = {
    "MSELoss": (lambda m: m.MSELoss(), X, _rand((4, 6), 52)),
    "L1Loss": (lambda m: m.L1Loss("sum"), X, _rand((4, 6), 53)),
    "NLLLoss": (lambda m, w: m.NLLLoss(weight=w, ignore_index=1), _rand((6, 5), 54), LABELS),
    "CrossEntropyLoss": (lambda m, w: m.CrossEntropyLoss(weight=w, label_smoothing=0.1), LOGITS, LABELS),
    "BCELoss": (lambda m: m.BCELoss(), _rand((4, 6), 55, low=0.05), (_rand((4, 6), 56) > 0).astype(np.float32)),
    "BCEWithLogitsLoss": (lambda m, w: m.BCEWithLogitsLoss(pos_weight=w), X, (_rand((4, 6), 57) > 0).astype(np.float32)),
    "SmoothL1Loss": (lambda m: m.SmoothL1Loss(beta=0.6), X, _rand((4, 6), 58)),
    "HuberLoss": (lambda m: m.HuberLoss("none", 0.4), X, _rand((4, 6), 59)),
}


def _mnist(m):
    if m is jht.nn:
        from mnist import Net

        return Net()
    from mnist_torch import Net

    return Net()


class _Stacked:
    """A torch-style module holding a ModuleList, in the framework of ``m``."""

    def __new__(cls, m):
        class Stacked(m.Module):
            def __init__(self):
                if m is ht.nn:
                    super().__init__()
                self.blocks = m.ModuleList([m.Linear(6, 6), m.Dropout(0.5), m.Linear(6, 3)])

            def forward(self, x):
                for b in self.blocks:
                    x = b(x)
                return x

        return Stacked()


def test_zoo_covers_heat_tpu():
    assert set(ht.nn.modules.__all__) == set(jht.nn.modules.__all__) and len(ht.nn.modules.__all__) == 48
    assert set(MODULES) | set(LOSSES) == set(jht.nn.modules.__all__)
    for mod in ("attention", "recurrent", "functional"):
        assert set(getattr(ht.nn, mod).__all__) == set(getattr(jht.nn, mod).__all__)
    for mod in ("attention", "recurrent", "modules"):
        assert all(hasattr(ht.nn, name) for name in getattr(jht.nn, mod).__all__)


@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_heat_tpu(name):
    """Each module with heat_tpu's parameters: eval mode, and for the keyed and batch-
    statistics ones training mode with heat_tpu's key too (dropout masks bit for bit)."""
    build, x = MODULES[name]
    jm, tm = build(jht.nn), build(ht.nn)
    assert not tm.training  # eval mode from the start, as heat_tpu's modules
    params = jm.init(jax.random.key(len(name)))
    load_jax_params(tm, _tree(params))
    tol = TOL_DEEP if name in ("Conv2d", "ConvTranspose2d", "Conv1d", "Module", "remat") else TOL
    want = jm.apply(params, jnp.asarray(x))
    got = tm(torch.from_numpy(np.array(x)))
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol)
    if name in TRAIN:
        want = jm.apply(params, jnp.asarray(x), key=KEY, train=True)
        got = tm.train()(torch.from_numpy(np.array(x)), key=Side(True).key)
        np.testing.assert_allclose(_np(got), np.asarray(want), **tol)
        if name.startswith("BatchNorm"):
            np.testing.assert_allclose(tm.running_mean.numpy(), np.asarray(jm.running_mean), **TOL)
            np.testing.assert_allclose(tm.running_var.numpy(), np.asarray(jm.running_var), **TOL)


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_matches_heat_tpu(name):
    build, p, t = LOSSES[name]
    weighted = build.__code__.co_argcount == 2
    w = _rand(p.shape[1], 60, low=0.2)
    jl = build(jht.nn, jnp.asarray(w)) if weighted else build(jht.nn)
    tl = build(ht.nn, torch.from_numpy(w)) if weighted else build(ht.nn)
    want = jl(jnp.asarray(p), jnp.asarray(t))
    got = tl(torch.from_numpy(p), torch.from_numpy(np.array(t)))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_fresh_dropout_passes_through():
    """The module-mode repair: a freshly built Sequential(Linear, Dropout(0.5)) is in eval
    mode, as heat_tpu's, and gives heat_tpu's output (torch's own would drop half)."""
    jm = jht.nn.Sequential(jht.nn.Linear(6, 4), jht.nn.Dropout(0.5))
    params = jm.init(jax.random.key(3))
    tm = load_jax_params(ht.nn.Sequential(ht.nn.Linear(6, 4), ht.nn.Dropout(0.5)), _tree(params))
    np.testing.assert_allclose(tm(torch.from_numpy(X)).detach().numpy(), np.asarray(jm.apply(params, jnp.asarray(X))),
                               **TOL)
    assert not any(m.training for m in tm.modules())
    with pytest.raises(ValueError, match="key"):
        tm.train()(torch.from_numpy(X))


def test_remat_gradients_equal_the_unwrapped_modules():
    """Remat recomputes the forward in the backward: its gradients equal the wrapped
    module's, bit for bit."""
    torch.manual_seed(0)
    net = _conv_net(ht.nn)
    wrapped = ht.nn.Remat(net)
    x = torch.from_numpy(X4)
    grads = []
    for m in (net, wrapped):
        m.zero_grad()
        (m(x) ** 2).sum().backward()
        grads.append([p.grad.clone() for p in net.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_module_on_dndarrays_keeps_heat_tpus_split():
    """heat_tpu's Module.__call__ rule: the split survives where its axis keeps its extent."""
    for split, build in ((0, lambda m: m.Conv2d(4, 3, 3)), (1, lambda m: m.Softmax(1)), (2, lambda m: m.Linear(5, 2))):
        jm, tm = build(jht.nn), build(ht.nn)
        params = jm.init(jax.random.key(split))
        load_jax_params(tm, _tree(params))
        x = X4 if split == 0 else X3
        want = jm(jht.array(x, split=split)) if split else jm.apply(params, jht.array(x, split=split))
        if split:
            jm.params = params
            want = jm(jht.array(x, split=split))
        got = tm(ht.array(x, split=split))
        assert got.split == want.split and got.gshape == want.gshape
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL_DEEP)


def test_load_jax_params_carries_batch_norm_statistics():
    jm = jht.nn.BatchNorm2d(4)
    params = jm.init(jax.random.key(0))
    jm.apply(params, jnp.asarray(X4), train=True)  # eager: the running statistics move
    tm = load_jax_params(ht.nn.BatchNorm2d(4), _tree(params),
                         buffers={"running_mean": np.asarray(jm.running_mean), "running_var": np.asarray(jm.running_var)})
    np.testing.assert_allclose(tm(torch.from_numpy(X4)).detach().numpy(), np.asarray(jm.apply(params, jnp.asarray(X4))),
                               **TOL)
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(ht.nn.BatchNorm2d(4), {})
    with pytest.raises(ValueError, match="extra"):
        load_jax_params(ht.nn.BatchNorm2d(4), {**_tree(params), "scale": np.ones(4)})


# ---------------------------------------------------------------------- recurrent layers
RECURRENT = {
    "RNN": (lambda m: m.RNN(5, 6, num_layers=2), _rand((7, 3, 5), 61)),
    "RNN_relu_batch_first": (lambda m: m.RNN(5, 6, nonlinearity="relu", batch_first=True), _rand((3, 7, 5), 62)),
    "LSTM": (lambda m: m.LSTM(5, 6, num_layers=2), _rand((7, 3, 5), 63)),
    "LSTM_unbatched": (lambda m: m.LSTM(5, 4), _rand((7, 5), 64)),
    "GRU": (lambda m: m.GRU(5, 6, num_layers=2, batch_first=True), _rand((3, 7, 5), 65)),
    "GRU_no_bias": (lambda m: m.GRU(5, 3, bias=False), _rand((7, 2, 5), 66)),
    "RNNCell": (lambda m: m.RNNCell(5, 6, nonlinearity="relu"), _rand((3, 5), 67)),
    "LSTMCell": (lambda m: m.LSTMCell(5, 6), _rand((3, 5), 68)),
    "GRUCell": (lambda m: m.GRUCell(5, 6), _rand(5, 69)),
}


@pytest.mark.parametrize("name", list(RECURRENT))
def test_recurrent_matches_heat_tpu(name):
    build, x = RECURRENT[name]
    jm, tm = build(jht.nn), build(ht.nn)
    assert not tm.training
    params = jm.init(jax.random.key(len(name)))
    load_jax_params(tm, _tree(params))
    want, got = jm.apply(params, jnp.asarray(x)), tm(torch.from_numpy(x))
    for w, g in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(_np(got))):
        np.testing.assert_allclose(g, np.asarray(w), **TOL_DEEP)


def test_recurrent_initial_state_and_dndarray():
    jm, tm = jht.nn.LSTM(5, 6), ht.nn.LSTM(5, 6)
    params = jm.init(jax.random.key(1))
    load_jax_params(tm, _tree(params))
    x, h0, c0 = _rand((7, 3, 5), 70), _rand((1, 3, 6), 71), _rand((1, 3, 6), 72)
    want = jm.apply(params, jnp.asarray(x), initial_state=(jnp.asarray(h0), jnp.asarray(c0)))
    got = tm(ht.array(x, split=1), initial_state=(torch.from_numpy(h0), torch.from_numpy(c0)))
    assert got[0].split == 1
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL_DEEP)
    np.testing.assert_allclose(got[1][1].detach().numpy(), np.asarray(want[1][1]), **TOL_DEEP)
    for bad in (dict(bidirectional=True), dict(dropout=0.1)):
        with pytest.raises(NotImplementedError):
            ht.nn.GRU(5, 6, **bad)


# ---------------------------------------------------------------------- attention helpers
@pytest.mark.parametrize("t,p", [(8, 1), (12, 3), (16, 4), (40, 5)])
def test_zigzag_order_matches_heat_tpu(t, p):
    from heat_tpu.nn.attention import zigzag_inverse, zigzag_order

    for port, heat in ((ht.nn.zigzag_order, zigzag_order), (ht.nn.zigzag_inverse, zigzag_inverse)):
        got, want = port(t, p), heat(t, p)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="2\\*p"):
        ht.nn.zigzag_order(t + 1, p)


@pytest.mark.parametrize("norm_first", [False, True])
def test_transformer_train_mode_dropout_matches_heat_tpu(norm_first):
    """A 2 + 2-layer Transformer in training mode with dropout 0.1 and heat_tpu's key: the
    key splits as heat_tpu's (encoder/decoder, layers, blocks), every mask equals heat_tpu's,
    so the outputs agree within the stack tolerance."""
    cfg = dict(d_model=16, nhead=2, num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=32, dropout=0.1,
               norm_first=norm_first)
    jm = jht.nn.Transformer(**cfg)
    params = jm.init(jax.random.key(5))
    tm = load_jax_params(ht.nn.Transformer(**cfg), _tree(params)).train()
    src, tgt = _rand((2, 6, 16), 73), _rand((2, 5, 16), 74)
    want = jm.apply(params, jnp.asarray(src), jnp.asarray(tgt), key=KEY, train=True, tgt_is_causal=True)
    got = tm(torch.from_numpy(src), torch.from_numpy(tgt), tgt_is_causal=True, key=Side(True).key)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL_DEEP)
    with pytest.raises(ValueError, match="key"):
        tm(torch.from_numpy(src), torch.from_numpy(tgt))


def test_dropout_on_a_sequence_split_warns_and_goes_dense():
    """heat_tpu warns when dropout meets a sequence split (the ring is forfeited) and
    computes the weights densely; so does the port, with the same masks."""
    from heat_tpu.nn.attention import scaled_dot_product_attention as jsdpa

    q = _rand((2, 2, 6, 4), 80)
    with pytest.warns(UserWarning, match="ring-attention"):
        want = jsdpa(jht.array(q, split=2), jht.array(q, split=2), jht.array(q, split=2), dropout_p=0.3,
                     dropout_key=KEY)
    with pytest.warns(UserWarning, match="ring-attention"):
        got = tF.scaled_dot_product_attention(ht.array(q, split=2), ht.array(q, split=2), ht.array(q, split=2),
                                              dropout_p=0.3, dropout_key=Side(True).key)
    assert got.split == want.split == 2
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    layer = ht.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.2).train()
    with pytest.warns(UserWarning, match="ring-attention"):
        out = layer(ht.array(_rand((2, 6, 8), 81), split=1), key=Side(True).key)
    assert out.split == 1
