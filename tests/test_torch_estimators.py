"""The L7 estimators of heat_tpu_torch against heat_tpu's: the scalers
(``preprocessing``), GaussianNB (``naive_bayes``), Lasso (``regression``) and
KNeighborsClassifier (``classification``), on the same numpy inputs (the packaged
flowers and sugar tables, and seeded draws), the port as one rank against heat_tpu on
its test mesh (tests/test_torch_distributed.py runs them on three ranks, ragged).

Tolerances: float32 results within 1e-5 relative and 1e-5 of the result's largest
magnitude (sums over the samples taken in other orders), float64 within 1e-10 the same
way (Lasso's coefficients within 1e-10 of the largest), labels, counts and classes
exact; dtype, gshape and split equal."""

import h5py
import numpy as np
import pytest
import torch

import heat_tpu as ht

import heat_tpu_torch as htt
from heat_tpu_torch.testing import assert_record_equal, port_record


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


_rng = np.random.default_rng(31)
FLOWERS = np.loadtxt(htt.datasets.path("flowers.csv"), delimiter=";").astype(np.float32)
LABELS = np.loadtxt(htt.datasets.path("flowers_labels.csv")).astype(np.int64)
with h5py.File(htt.datasets.path("sugar.h5"), "r") as _f:
    SUGAR_X, SUGAR_Y = _f["x"][...], _f["y"][...]
DATA = {
    "flowers": FLOWERS,
    "f64": _rng.standard_normal((23, 6)) * np.array([1, 10, 0.1, 3, 1, 0]) + np.array([0, 5, -2, 1, 0, 7]),
    "const_col": np.hstack([_rng.standard_normal((11, 3)), np.full((11, 1), 2.5)]).astype(np.float32),
}


def same(got, want, rtol=None):
    """A port result (DNDarray, tensor or number) equals heat_tpu's within the module's
    tolerance for its type."""
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    if not hasattr(want, "gshape"):
        want = np.asarray(want)
    dt = want.dtype if isinstance(want, np.ndarray) else np.dtype(want.dtype.__name__)
    if rtol is None:
        rtol = 1e-5 if dt == np.float32 else (1e-10 if dt.kind in "fc" else 0)
    record = port_record(got) if hasattr(got, "gshape") else {"value": np.asarray(got)}
    w = np.asarray(want.numpy() if hasattr(want, "gshape") else want)
    scale = float(np.nanmax(np.abs(w[np.isfinite(w)]))) if w.size and np.isfinite(w).any() else 0.0
    assert_record_equal(record, want, rtol=rtol, atol=rtol * scale)


SCALERS = {
    "standard": ("StandardScaler", {}, ("mean_", "var_")),
    "standard_no_std": ("StandardScaler", {"with_std": False}, ("mean_",)),
    "minmax": ("MinMaxScaler", {"feature_range": (-1.0, 2.0)}, ("data_min_", "data_max_", "scale_", "min_")),
    "minmax_clip": ("MinMaxScaler", {"clip": True}, ("scale_", "min_")),
    "normalizer_l1": ("Normalizer", {"norm": "l1"}, ()),
    "normalizer_l2": ("Normalizer", {}, ()),
    "normalizer_max": ("Normalizer", {"norm": "max"}, ()),
    "maxabs": ("MaxAbsScaler", {}, ("max_abs_", "scale_")),
    "robust": ("RobustScaler", {}, ("center_", "iqr_")),
    "robust_range": ("RobustScaler", {"quantile_range": (10.0, 60.0), "with_centering": False}, ("iqr_",)),
}


LAYOUTS = [("flowers", None), ("flowers", 0), ("f64", 1), ("const_col", 0)]


@pytest.mark.parametrize("data,split", LAYOUTS)
@pytest.mark.parametrize("name", list(SCALERS))
def test_scalers(name, data, split):
    """fit, the fitted statistics, transform (of other data too, beyond the fitted range
    where clip acts), inverse_transform and fit_transform equal heat_tpu's."""
    cls, kw, attrs = SCALERS[name]
    x = DATA[data]
    other = (x[::-1] * 1.5 + 0.25).astype(x.dtype)
    got = getattr(htt.preprocessing, cls)(**kw).fit(htt.array(x, split=split))
    want = getattr(ht.preprocessing, cls)(**kw).fit(ht.array(x, split=split))
    for attr in attrs:
        same(getattr(got, attr), getattr(want, attr), rtol=1e-4 if x.dtype == np.float32 else None)
    for fn in ("transform", "inverse_transform"):
        if hasattr(want, fn):
            same(getattr(got, fn)(htt.array(other, split=split)), getattr(want, fn)(ht.array(other, split=split)),
                 rtol=1e-4 if x.dtype == np.float32 else None)
    same(getattr(htt.preprocessing, cls)(**kw).fit_transform(htt.array(x, split=split)),
         getattr(ht.preprocessing, cls)(**kw).fit_transform(ht.array(x, split=split)),
         rtol=1e-4 if x.dtype == np.float32 else None)


@pytest.mark.parametrize("cls", ["StandardScaler", "MinMaxScaler", "Normalizer", "MaxAbsScaler", "RobustScaler"])
def test_scalers_check_their_input(cls):
    """Integer data and data that is not a DNDarray raise TypeError in both; the
    arguments heat_tpu refuses raise in the port too; the estimators are transformers."""
    for m in (ht, htt):
        est = getattr(m.preprocessing, cls)()
        assert m.is_transformer(est) and m.is_estimator(est)
        with pytest.raises(TypeError):
            est.transform(m.array(np.arange(12).reshape(4, 3)))
        if cls != "Normalizer":  # stateless: its fit checks nothing
            with pytest.raises(TypeError):
                est.fit(m.array(np.arange(12).reshape(4, 3)))
        with pytest.raises(TypeError):
            est.transform(np.ones((2, 2), np.float32))
    for m in (ht, htt):
        with pytest.raises(ValueError):
            m.preprocessing.MinMaxScaler(feature_range=(1.0, 0.0))
        with pytest.raises(ValueError):
            m.preprocessing.RobustScaler(quantile_range=(80.0, 20.0))
        with pytest.raises(NotImplementedError):
            m.preprocessing.Normalizer(norm="l3")
        with pytest.raises(NotImplementedError):
            m.preprocessing.RobustScaler(unit_variance=True)


def test_scaler_without_work_returns_its_input():
    """With nothing to do, transform hands back its input itself (heat_tpu's aliasing)."""
    for m in (ht, htt):
        x = m.array(FLOWERS)
        assert m.preprocessing.StandardScaler(with_mean=False, with_std=False, copy=False).fit(x).transform(x) is x


def _nb_same(got, want, x, split):
    for attr in ("theta_", "var_", "class_count_", "class_prior_", "classes_"):
        same(getattr(got, attr), getattr(want, attr))
    assert got.epsilon_ == pytest.approx(want.epsilon_, rel=1e-12)
    X, Y = htt.array(x, split=split), ht.array(x, split=split)
    same(got.predict(X), want.predict(Y))
    same(got.predict_proba(X), want.predict_proba(Y))
    same(got.predict_log_proba(X), want.predict_log_proba(Y))


WEIGHTS = _rng.uniform(0.1, 2.0, len(LABELS))
PRIORS = np.array([0.2, 0.5, 0.3])


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("case", ["plain", "weights", "priors", "smoothing"])
def test_gaussian_nb(case, split):
    """fit, every fitted moment (float64), predict, predict_proba and predict_log_proba
    on the flowers table equal heat_tpu's."""
    kw = {"priors": htt.array(PRIORS)} if case == "priors" else ({"var_smoothing": 1e-2} if case == "smoothing" else {})
    kw_ht = {"priors": ht.array(PRIORS)} if case == "priors" else kw
    fit_kw = {"sample_weight": WEIGHTS} if case == "weights" else {}
    vs = None if split is None else 0  # the labels and weights go with the rows
    got = htt.naive_bayes.GaussianNB(**kw).fit(htt.array(FLOWERS, split=split), htt.array(LABELS, split=vs),
                                                **{k: htt.array(v, split=vs) for k, v in fit_kw.items()})
    want = ht.naive_bayes.GaussianNB(**kw_ht).fit(ht.array(FLOWERS, split=split), ht.array(LABELS, split=vs),
                                                 **{k: ht.array(v, split=vs) for k, v in fit_kw.items()})
    _nb_same(got, want, FLOWERS, split)
    assert htt.is_classifier(got) and ht.is_classifier(want)


@pytest.mark.parametrize("split", [None, 0])
def test_gaussian_nb_partial_fit(split):
    """Two batches merged by partial_fit (the pairwise update), one of them without a
    class, and fit_predict, equal heat_tpu's."""
    order = np.random.default_rng(3).permutation(len(LABELS))
    x, y = FLOWERS[order], LABELS[order]
    first = y != 2
    parts = [(x[first][:40], y[first][:40]), (x[60:], y[60:])]
    got, want = htt.naive_bayes.GaussianNB(), ht.naive_bayes.GaussianNB()
    for xb, yb in parts:
        got.partial_fit(htt.array(xb, split=split), htt.array(yb, split=split), classes=htt.array([0, 1, 2]))
        want.partial_fit(ht.array(xb, split=split), ht.array(yb, split=split), classes=ht.array([0, 1, 2]))
    _nb_same(got, want, x, split)
    same(htt.naive_bayes.GaussianNB().fit_predict(htt.array(x, split=split), htt.array(y, split=split)),
         ht.naive_bayes.GaussianNB().fit_predict(ht.array(x, split=split), ht.array(y, split=split)))


def test_gaussian_nb_errors():
    for m in (ht, htt):
        nb = m.naive_bayes.GaussianNB()
        with pytest.raises(ValueError):
            nb.fit(FLOWERS, m.array(LABELS))
        with pytest.raises(ValueError):
            nb.fit(m.array(FLOWERS[:, 0]), m.array(LABELS))
        with pytest.raises(RuntimeError):
            m.naive_bayes.GaussianNB().predict(m.array(FLOWERS))
        for priors in ([0.5, 0.5], [0.2, 0.2, 0.2], [1.5, -0.25, -0.25]):
            with pytest.raises(ValueError):
                m.naive_bayes.GaussianNB(priors=m.array(priors)).fit(m.array(FLOWERS), m.array(LABELS))


LSE = {
    "a": _rng.standard_normal((4, 5)),
    "b": _rng.uniform(-1, 2, (4, 5)),
    "inf": np.array([[-np.inf, -np.inf], [0.5, np.inf], [1.0, 2.0]]),
}


@pytest.mark.parametrize("kw", [{}, {"axis": 1}, {"axis": 0, "keepdims": True}, {"axis": 1, "b": "b"},
                                {"axis": 1, "b": "b", "return_sign": True}, {"b": "b", "keepdims": True},
                                {"axis": (0, 1), "return_sign": True}], ids=str)
@pytest.mark.parametrize("name", ["a", "inf"])
def test_logsumexp(name, kw):
    """GaussianNB.logsumexp is jax.scipy.special.logsumexp: with b, a negative sum is NaN
    unless return_sign asks for (log|sum|, sign); infinities stay as jax gives them."""
    a = LSE[name]
    b = LSE["b"][: a.shape[0], : a.shape[1]] if "b" in kw else None
    kw = {k: v for k, v in kw.items() if k != "b"}
    got = htt.naive_bayes.GaussianNB.logsumexp(torch.tensor(a), b=None if b is None else torch.tensor(b), **kw)
    want = ht.naive_bayes.GaussianNB.logsumexp(ht.array(a), b=b, **kw)
    got, want = (got, want) if kw.get("return_sign") else ((got,), (want,))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, equal_nan=True)
        assert g.shape == np.asarray(w).shape


def _sugar(split):
    x = np.hstack([np.ones((SUGAR_X.shape[0], 1), np.float32), SUGAR_X])
    return x, SUGAR_Y


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("kw", [{"lam": 0.1}, {"lam": 0.02, "max_iter": 7}, {"lam": 1.0, "tol": 1e-3}], ids=str)
def test_lasso(kw, split):
    """Coordinate descent on the sugar table with an intercept column: θ within 1e-10 of
    the largest coefficient, the sweeps run, coef_, intercept_, predict and rmse as
    heat_tpu's."""
    x, y = _sugar(split)
    got, want = htt.regression.Lasso(**kw), ht.regression.Lasso(**kw)
    got.fit(htt.array(x, split=split), htt.array(y, split=split))
    want.fit(ht.array(x, split=split), ht.array(y, split=split))
    assert got.n_iter == want.n_iter
    scale = float(np.abs(want.theta.numpy()).max())
    for attr in ("theta", "coef_", "intercept_"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert (g.gshape, g.split, g.dtype.__name__) == (w.gshape, w.split, w.dtype.__name__)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-10 * scale)
    pg, pw = got.predict(htt.array(x, split=split)), want.predict(ht.array(x, split=split))
    same(pg, pw)
    same(got.rmse(htt.array(y, split=split), pg.flatten()), want.rmse(ht.array(y, split=split), pw.flatten()))
    assert got.get_params() == want.get_params() and htt.is_regressor(got)


def test_lasso_soft_threshold_and_errors():
    rho = np.array([-0.3, -0.1, 0.0, 0.05, 0.4])
    got, want = htt.regression.Lasso(lam=0.1), ht.regression.Lasso(lam=0.1)
    same(got.soft_threshold(htt.array(rho, split=0)), want.soft_threshold(ht.array(rho, split=0)))
    assert got.soft_threshold(0.25) == pytest.approx(want.soft_threshold(0.25), abs=1e-15)
    got.lam = 0.5
    assert got.lam == 0.5 and got.soft_threshold(-0.7) == pytest.approx(-0.2)
    for m in (ht, htt):
        with pytest.raises(ValueError):
            m.regression.Lasso().fit(np.ones((3, 2)), m.array(np.ones(3)))
        with pytest.raises(RuntimeError):
            m.regression.Lasso().predict(m.array(np.ones((3, 2))))


TRAIN = (np.loadtxt(htt.datasets.path("flowers_X_train.csv"), delimiter=";").astype(np.float32),
         np.loadtxt(htt.datasets.path("flowers_y_train.csv")).astype(np.int64))
TEST = np.loadtxt(htt.datasets.path("flowers_X_test.csv"), delimiter=";").astype(np.float32)
TIES = (np.array([[0.0], [2.0], [1.0], [3.0], [-1.0], [5.0]], np.float32), np.array([1, 0, 2, 0, 1, 2]))


@pytest.mark.parametrize("splits", [(None, None), (0, 0), (0, None), (None, 0)])
@pytest.mark.parametrize("k", [1, 5])
def test_knn(k, splits):
    """fit on the flowers training split, predict the test split: heat_tpu's labels."""
    (xt, yt), (st, sq) = TRAIN, splits
    got = htt.classification.KNeighborsClassifier(k).fit(htt.array(xt, split=st), htt.array(yt, split=st))
    want = ht.classification.KNeighborsClassifier(k).fit(ht.array(xt, split=st), ht.array(yt, split=st))
    same(got.y, want.y)
    same(got.predict(htt.array(TEST, split=sq)), want.predict(ht.array(TEST, split=sq)))


@pytest.mark.parametrize("split", [None, 0])
def test_knn_ties_and_one_hot(split):
    """Equal distances go to the lowest training index and equal votes to the lowest
    class, as heat_tpu's; one-hot labels (float32) and a 2-D one-hot y."""
    x, y = TIES
    queries = np.array([[1.0], [1.5], [4.0], [0.5]], np.float32)
    for k in (2, 3, 4):
        got = htt.classification.KNeighborsClassifier(k).fit(htt.array(x, split=split), htt.array(y, split=split))
        want = ht.classification.KNeighborsClassifier(k).fit(ht.array(x, split=split), ht.array(y, split=split))
        same(got.predict(htt.array(queries, split=split)), want.predict(ht.array(queries, split=split)))
    onehot = np.eye(3, dtype=np.float32)[y]
    same(htt.classification.KNeighborsClassifier.one_hot_encoding(htt.array(y.reshape(-1, 1), split=split)),
         ht.classification.KNeighborsClassifier.one_hot_encoding(ht.array(y.reshape(-1, 1), split=split)))
    got = htt.classification.KNeighborsClassifier(3).fit(htt.array(x, split=split), htt.array(onehot, split=split))
    want = ht.classification.KNeighborsClassifier(3).fit(ht.array(x, split=split), ht.array(onehot, split=split))
    same(got.predict(htt.array(queries)), want.predict(ht.array(queries)))
    assert htt.is_classifier(got) and got.get_params()["n_neighbors"] == 3
    with pytest.raises(RuntimeError):
        htt.classification.KNeighborsClassifier().predict(htt.array(queries))


def test_lasso_reads_back_once_a_sweep(monkeypatch):
    """The sweeps stay on the device: the fit reads one value back a sweep (its
    convergence test), never one a coordinate."""
    x, y = _sugar(0)
    reads = []
    item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item", lambda t: reads.append(t.numel()) or item(t))
    est = htt.regression.Lasso(lam=0.1)
    est.fit(htt.array(x, split=0), htt.array(y, split=0))
    assert reads == [1] * est.n_iter and est.n_iter > 1
