"""One rank of tests/test_torch_distributed.py: runs the port's checks over gloo and
writes this rank's results for the parent to compare with heat_tpu.

    python _torch_dist_worker.py RANK WORLD INIT_FILE INPUTS.npz OUT_DIR

At WORLD 3 it runs every check; at WORLD 4 the sorting and selection cases alone, where
the distributed sort takes the bitonic network.

Imports torch and heat_tpu_torch only, never JAX.
"""

import collections
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core import communication  # noqa: E402
from heat_tpu_torch.core.linalg import comm_plan  # noqa: E402
from heat_tpu_torch.interop import load_jax_params  # noqa: E402
from heat_tpu_torch.testing import port_record  # noqa: E402


def run(inputs) -> dict:
    out = {}
    ht.use_device("cpu")
    comm = ht.get_comm()
    out["world"] = np.array([comm.size, comm.rank])

    s = ht.arange(10, split=0).sum()
    out["arange_sum"] = np.array(s.item())
    out["arange_sum_dtype"] = np.array(s.dtype.__name__)

    for name in ("a", "small", "ties"):
        data = inputs[name]
        for split in (None, 0, 1):
            x = ht.array(data, split=split)
            out[f"{name}_s{split}_lshape_map"] = x.lshape_map().numpy()
            out[f"{name}_s{split}_local"] = np.array(x.lshape)
            for fn in ("sum", "prod", "mean", "min", "max", "argmin", "argmax"):
                for axis in (None, 0, 1):
                    r = getattr(ht, fn)(x, axis=axis)
                    key = f"{name}_s{split}_{fn}_{axis}"
                    out[key] = r.numpy()
                    out[key + "_meta"] = np.array([r.dtype.__name__, str(r.split), str(r.gshape)])

    # min and max over the split axis with a NaN on one rank or in some columns only
    for name in ("nan_r0", "nan_r1", "nan_r2", "nan_cols"):
        x = ht.array(inputs[name], split=0)
        for fn in ("min", "max"):
            for axis in (None, 0):
                out[f"{name}_{fn}_{axis}"] = getattr(ht, fn)(x, axis=axis).numpy()

    a0, a1 = ht.array(inputs["a"], split=0), ht.array(inputs["a"], split=1)
    for op in ("add", "sub", "mul", "div", "pow"):
        r = getattr(ht, op)(a0, a1)
        out[f"binary_{op}"] = r.numpy()
        out[f"binary_{op}_meta"] = np.array([r.dtype.__name__, str(r.split)])
    r = a1.resplit(0)
    out["resplit_1_0"] = r.numpy()
    out["resplit_1_0_local"] = np.array(r.lshape)

    # the fit's one collective per iteration is comm.all_reduce of the packed record
    calls = []
    orig = communication.TorchCommunication.all_reduce

    def counting(self, tensor, op="sum"):
        calls.append(tuple(tensor.shape))
        return orig(self, tensor, op)

    communication.TorchCommunication.all_reduce = counting
    try:
        km = ht.cluster.KMeans(n_clusters=3, init=ht.array(inputs["init"]), max_iter=50)
        km.fit(ht.array(inputs["blobs"], split=0))
    finally:
        communication.TorchCommunication.all_reduce = orig
    out["km_centers"] = km.cluster_centers_.numpy()
    out["km_labels"] = km.labels_.numpy()
    out["km_n_iter"] = np.array(km.n_iter_)
    out["km_inertia"] = np.array(km.inertia_)
    out["km_allreduce_shapes"] = np.array(calls)
    out["km_predict"] = km.predict(ht.array(inputs["blobs"], split=0)).numpy()

    # multi-head attention on a batch split: each rank attends its own rows
    params = {k[len("mha_param_") :]: inputs[k] for k in inputs.files if k.startswith("mha_param_")}
    mha = load_jax_params(ht.nn.MultiheadAttention(inputs["mha_x"].shape[-1], int(inputs["mha_heads"])), params)
    x = ht.array(inputs["mha_x"], split=0)
    mem = ht.array(inputs["mha_mem"])  # whole on every rank: each takes its rows
    with torch.no_grad():
        for name, o in (
            ("self", mha(x, key_padding_mask=ht.array(inputs["mha_kpm"], split=0))[0]),
            ("cross", mha(x, mem, mem, is_causal=True)[0]),
        ):
            out[f"mha_{name}"] = o.numpy()
            out[f"mha_{name}_meta"] = np.array([str(o.split), str(o.gshape)])
            out[f"mha_{name}_local"] = np.array(o.larray.shape)
        # a sequence split of 5 over three ranks: not the ring's equal chunks, so computed whole
        o = mha(ht.array(inputs["mha_x"], split=1))[0]
        out["mha_seq_split"], out["mha_seq_split_meta"] = o.numpy(), np.array([str(o.split), str(o.gshape)])

    # one data-parallel SGD step per batch, from parameters that differ between ranks
    # until DataParallel broadcasts rank 0's
    nested = {}
    for key in inputs.files:
        if key.startswith("dp_param_"):
            m, k = key[len("dp_param_") :].split(".")
            nested.setdefault(m, {})[k] = inputs[key]
    packed = []
    orig_packed = communication.TorchCommunication.all_reduce_packed

    def counting_packed(self, tensors):
        packed.append(len(tensors))  # the step's collectives, each of every gradient and the loss
        return orig_packed(self, tensors)

    communication.TorchCommunication.all_reduce_packed = counting_packed
    try:
        for batch in (7, 2):
            mlp = load_jax_params(
                torch.nn.Sequential(collections.OrderedDict(fc1=torch.nn.Linear(4, 8), relu=torch.nn.ReLU(),
                                                            fc2=torch.nn.Linear(8, 3))),
                nested,
            )
            with torch.no_grad():
                for p in mlp.parameters():
                    p += comm.rank
            opt = ht.optim.DataParallelOptimizer("sgd", lr=float(inputs["dp_lr"]))
            ht.nn.DataParallel(mlp, optimizer=opt)
            x = ht.array(inputs[f"dp_x{batch}"], split=0)
            y = ht.array(inputs[f"dp_y{batch}"], split=0)
            packed.clear()
            loss = opt.step(lambda m, xb, yb: torch.nn.functional.cross_entropy(m(xb), yb), x, y)
            out[f"dp{batch}_loss"] = np.array(float(loss))
            out[f"dp{batch}_rows"] = np.array(x.lshape[0])
            out[f"dp{batch}_packed_calls"] = np.array(len(packed))
            for name, t in mlp.state_dict().items():
                out[f"dp{batch}_param_{name}"] = t.numpy()
    finally:
        communication.TorchCommunication.all_reduce_packed = orig_packed
    out.update(run_linalg(inputs, comm))
    out.update(run_array_api(comm))
    out.update(run_cluster(inputs))
    out.update(run_domain(inputs))
    out.update(run_nn(inputs, comm))
    out.update(run_runtime(inputs))
    out.update(run_dp_dropout(inputs))
    return out


def run_dp_dropout(inputs) -> dict:
    """One DataParallelOptimizer("sgd") step of a train-mode encoder layer (dropout 0.1, one
    key) on a batch of 7 split 3, 3, 1: every mask is drawn over the whole batch."""
    out = {}
    params = {k[len("dpdrop_param_"):]: inputs[k] for k in inputs.files if k.startswith("dpdrop_param_")}
    layer = load_jax_params(ht.nn.TransformerEncoderLayer(**DP_DROPOUT_LAYER), params).train()
    opt = ht.optim.DataParallelOptimizer("sgd", lr=float(inputs["dp_lr"]))
    ht.nn.DataParallel(layer, optimizer=opt)
    xd, yd = ht.array(inputs["dpdrop_x"], split=0), ht.array(inputs["dpdrop_y"], split=0)
    key = inputs["drop_key"]
    loss = opt.step(lambda m, xb, yb: torch.mean((m(xb, key=key) - yb) ** 2), xd, yd)
    out["nn_dpdrop_loss"], out["nn_dpdrop_rows"] = np.array(float(loss)), np.array(xd.lshape[0])
    for name, p in layer.named_parameters():
        out[f"nn_dpdrop_grad_{name}"] = p.grad.numpy()
    return out


RUNTIME_THREADS = 4


def run_runtime(inputs) -> dict:
    """Threaded requests on every rank: each thread builds a deferred chain inside its
    own ``profiler.request`` scope (the forces are local and may batch across
    threads), then takes its turn — thread 0, 1, 2, 3 on every rank — to reduce and
    scan the chain over the split axis (an ``all_reduce`` and an all-gather, issued
    inline on the calling thread in the same order on every rank)."""
    import threading

    from heat_tpu_torch.core import _executor, profiler

    out = {}
    x = ht.array(inputs["rt_x"], split=0)
    y = ht.array(inputs["rt_y"], split=0)
    profiler.enable()
    _executor.reset_executor_stats()
    turn = {"next": 0}
    cv = threading.Condition()
    start = threading.Barrier(RUNTIME_THREADS)
    results, errors = {}, []

    def request(i):
        try:
            with profiler.request(f"rt{i}"):
                c = x
                for _ in range(4):
                    c = c * float(i + 1)
                    c = c + y
                    c = c - 0.5
                start.wait(timeout=60)
                c.larray  # a local force: queued and batched across threads
                with cv:
                    assert cv.wait_for(lambda: turn["next"] == i, timeout=60), "turn never came"
                results[f"rt{i}_chain"] = c.numpy()
                results[f"rt{i}_sum0"] = ht.sum(c, axis=0).numpy()
                results[f"rt{i}_cumsum0"] = ht.cumsum((c * 2.0) + y, axis=0).numpy()
                results[f"rt{i}_max"] = np.array(ht.max(c).item())
                with cv:
                    turn["next"] += 1
                    cv.notify_all()
        except Exception as exc:  # reported through the results
            errors.append(repr(exc))
            with cv:
                turn["next"] = max(turn["next"], i + 1)
                cv.notify_all()

    threads = [threading.Thread(target=request, args=(i,)) for i in range(RUNTIME_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    out["rt_alive"] = np.array(sum(t.is_alive() for t in threads))
    out["rt_errors"] = np.array(" | ".join(errors))
    out.update(results)
    st = _executor.executor_stats()
    out["rt_stats"] = np.array([st["misses"], st["hits"], st["reexecuted"], st["eager_fallbacks"]])
    # the same chain on more inputs, after the threads (the parent holds it to the stepwise
    # float32 chain and heat_tpu's to the fused one)
    for key in sorted(k for k in inputs if k.startswith("rt_x_seed")):
        seed = key[len("rt_x_seed"):]
        xs, ys = ht.array(inputs[key], split=0), ht.array(inputs[f"rt_y_seed{seed}"], split=0)
        for i in range(RUNTIME_THREADS):
            c = xs
            for _ in range(4):
                c = c * float(i + 1)
                c = c + ys
                c = c - 0.5
            out[f"rt_seed{seed}_{i}"] = c.numpy()
    out["rt_requests"] = np.array(profiler.report()["requests_total"])
    profiler.disable()
    profiler.reset()
    return out


TRANSFORMER = dict(d_model=16, nhead=4, num_encoder_layers=1, num_decoder_layers=1, dim_feedforward=32, dropout=0.0)
DP_DROPOUT_LAYER = dict(d_model=8, nhead=2, dim_feedforward=16, dropout=0.1)  # tests/test_torch_distributed.py's


def run_nn(inputs, comm) -> dict:
    """heat_tpu.nn's distributed paths: ring, zigzag and Ulysses attention on this rank's
    sequence chunks with gradients, sdpa and MultiheadAttention on sequence-split DNDarrays
    (the ring counted by a spy), keyed dropout on split arrays, BatchNorm and the losses on
    a ragged batch split."""
    from heat_tpu_torch.nn import attention as att

    out = {}
    q, k, v, g = (torch.from_numpy(inputs[f"ring_{n}"]) for n in ("q", "k", "v", "g"))
    t = q.shape[2]
    _, _, rows = comm.chunk(tuple(q.shape), 2)
    order = torch.from_numpy(att.zigzag_order(t, comm.size).astype(np.int64))
    runs = {
        "ring": (lambda a, b, c: att.ring_attention(a, b, c, comm), False),
        "ring_causal": (lambda a, b, c: att.ring_attention(a, b, c, comm, is_causal=True), False),
        "zigzag": (lambda a, b, c: att.ring_attention_zigzag(a, b, c, comm), True),
        "ulysses": (lambda a, b, c: att.ulysses_attention(a, b, c, comm), False),
        "ulysses_causal": (lambda a, b, c: att.ulysses_attention(a, b, c, comm, is_causal=True), False),
    }
    for name, (fn, zig) in runs.items():
        lay = (lambda x: x[:, :, order]) if zig else (lambda x: x)
        local = [lay(x)[rows].clone().requires_grad_() for x in (q, k, v)]
        o = fn(*local)
        o.backward(lay(g)[rows])
        out[f"nn_{name}"] = o.detach().numpy()
        for n, x in zip("qkv", local):
            out[f"nn_{name}_d{n}"] = x.grad.numpy()

    calls = []
    ring = att.ring_attention

    def spy(*args, **kwargs):
        calls.append(1)
        return ring(*args, **kwargs)

    att.ring_attention = spy
    try:
        for tag in ("even", "ragged"):
            x4 = [inputs[f"seq_{tag}_{n}"] for n in "qkv"]
            calls.clear()
            r = ht.nn.scaled_dot_product_attention(*(ht.array(a, split=2) for a in x4), is_causal=True)
            out[f"nn_sdpa_{tag}"], out[f"nn_sdpa_{tag}_meta"] = r.numpy(), np.array([str(r.split), len(calls)])
            params = {key[len("mha_param_"):]: inputs[key] for key in inputs.files if key.startswith("mha_param_")}
            mha = load_jax_params(ht.nn.MultiheadAttention(inputs["mha_x"].shape[-1], int(inputs["mha_heads"])), params)
            calls.clear()
            with torch.no_grad():
                r = mha(ht.array(inputs[f"seq_{tag}_x"], split=1), is_causal=True)[0]
            out[f"nn_mha_{tag}"], out[f"nn_mha_{tag}_meta"] = r.numpy(), np.array([str(r.split), len(calls)])
        # a Transformer on sequence-split src (12) and tgt (9): rank-local but for the ring
        params = {key[len("tr_param_"):]: inputs[key] for key in inputs.files if key.startswith("tr_param_")}
        tr = load_jax_params(ht.nn.Transformer(**TRANSFORMER), params)
        calls.clear()
        with torch.no_grad():
            r = tr(ht.array(inputs["tr_src"], split=1), ht.array(inputs["tr_tgt"], split=1), tgt_is_causal=True)
        out["nn_transformer"], out["nn_transformer_meta"] = r.numpy(), np.array([str(r.split), len(calls)])
    finally:
        att.ring_attention = ring

    key = inputs["drop_key"]
    for split in (0, 1):
        r = ht.nn.functional.dropout(ht.array(inputs["drop_x"], split=split), 0.3, key=key)
        out[f"nn_dropout_s{split}"], out[f"nn_dropout_s{split}_split"] = r.numpy(), np.array(str(r.split))
    r = ht.nn.functional.dropout2d(ht.array(inputs["drop_x4"], split=0), 0.5, key=key)
    out["nn_dropout2d"], out["nn_dropout2d_split"] = r.numpy(), np.array(str(r.split))

    for name, shape in (("bn1", inputs["bn_x2"]), ("bn2", inputs["bn_x4"])):
        bn = (ht.nn.BatchNorm1d if name == "bn1" else ht.nn.BatchNorm2d)(shape.shape[1]).train()
        r = bn(ht.array(shape, split=0))
        out[f"nn_{name}"], out[f"nn_{name}_split"] = r.numpy(), np.array(str(r.split))
        out[f"nn_{name}_running"] = np.stack([bn.running_mean.numpy(), bn.running_var.numpy()])
    pred, target = ht.array(inputs["loss_pred"], split=0), ht.array(inputs["loss_target"], split=0)
    prob = ht.array(inputs["loss_prob"], split=0)
    logits, labels = ht.array(inputs["loss_logits"], split=0), ht.array(inputs["loss_labels"], split=0)
    w = torch.from_numpy(inputs["loss_weight"])
    F = ht.nn.functional
    for reduction in ("mean", "sum", "none"):
        losses = {
            "mse": F.mse_loss(pred, target, reduction),
            "l1": F.l1_loss(pred, target, reduction),
            "smooth_l1": F.smooth_l1_loss(pred, target, reduction, beta=0.5),
            "huber": F.huber_loss(pred, target, reduction, delta=0.7),
            "bce": F.binary_cross_entropy(prob, ht.array(inputs["loss_binary"], split=0), reduction=reduction),
            "bce_logits": F.binary_cross_entropy_with_logits(pred, ht.array(inputs["loss_binary"], split=0),
                                                            reduction=reduction),
            "nll": F.nll_loss(F.log_softmax(logits, 1), labels, weight=w, reduction=reduction),
            "ce": F.cross_entropy(logits, labels, weight=w, ignore_index=2, reduction=reduction, label_smoothing=0.1),
        }
        for n, r in losses.items():
            out[f"nn_loss_{n}_{reduction}"] = r.numpy() if isinstance(r, ht.DNDarray) else r.detach().numpy()
    return out


# the FFTs at three ranks: (function, keywords, input, split); "fx" is 7 x 6 (3, 3, 1 rows),
# "fcube" 5 x 4 x 6 (2, 2, 1 along axis 0; 2, 2, 0 along axis 1)
FFT_CASES = {
    "fft_split_axis": ("fft", dict(axis=0), "fx", 0),
    "fft_other_axis": ("fft", dict(axis=1), "fx", 0),
    "ifft_split_axis_n": ("ifft", dict(axis=1, n=9), "fx", 1),
    "rfft_split_axis": ("rfft", dict(axis=0), "fx", 0),
    "irfft_split_axis": ("irfft", dict(axis=1), "fx", 1),
    "fft2_all_axes": ("fft2", dict(), "fx", 0),
    "rfftn_all_axes": ("rfftn", dict(), "fcube", 1),
    "fftn_pencil": ("fftn", dict(axes=(0, 2)), "fcube", 0),
    "ihfftn_pencil": ("ihfftn", dict(axes=(1, 2)), "fcube", 1),
    "hfft2_pencil": ("hfft2", dict(axes=(0, 1)), "fcube", 0),
    "fftshift_split_axis": ("fftshift", dict(axes=0), "fx", 0),
    "ifftshift_all": ("ifftshift", dict(), "fcube", 1),
}
# the scalers at three ranks on the flowers table cut to 148 rows (50, 50, 48)
SCALER_FITS = {
    "standard": ("StandardScaler", {}, ("mean_", "var_")),
    "minmax": ("MinMaxScaler", {"feature_range": (-1.0, 2.0)}, ("data_min_", "data_max_", "scale_", "min_")),
    "normalizer": ("Normalizer", {"norm": "l1"}, ()),
    "maxabs": ("MaxAbsScaler", {}, ("max_abs_", "scale_")),
    "robust": ("RobustScaler", {"quantile_range": (10.0, 60.0)}, ("center_", "iqr_")),
}


def run_domain(inputs) -> dict:
    """The FFT pencils, the DCSR matrix with a rank that holds no rows, the scalers,
    GaussianNB, Lasso and KNN on ragged splits, the partition interface, and the byte
    counts of each rank's chunk."""
    out = {}
    comm = ht.get_comm()
    for key, (fn, kw, name, split) in FFT_CASES.items():
        _record(out, f"fft_{key}", getattr(ht.fft, fn)(ht.array(inputs[name], split=split), **kw))

    # DCSR: 7 x 5 (3, 3, 1 rows) and 2 x 5 (1, 1, 0), from dense data, a split DNDarray,
    # a rank's own rows (chunks of 1, 5, 1 rows) and another matrix; the union merges
    rank = comm.rank
    for name in ("sp_a", "sp_small"):
        a = inputs[name]
        mats = {"dense": ht.sparse.sparse_csr_matrix(a, split=0),
                "dndarray": ht.sparse.to_sparse(ht.array(a, split=0)),
                "whole": ht.sparse.sparse_csr_matrix(a)}
        if name == "sp_a":
            rows = [(0, 1), (1, 6), (6, 7)][rank]
            mats["is_split"] = ht.sparse.sparse_csr_matrix(a[rows[0]:rows[1]], is_split=0)
        mats["resplit"] = ht.sparse.sparse_csr_matrix(mats["whole"], split=0)
        mats["gathered"] = ht.sparse.sparse_csr_matrix(mats["dense"])
        other = ht.sparse.sparse_csr_matrix(inputs[f"{name}_b"], split=0)
        mats["add"], mats["mul"] = mats["dense"] + other, mats["dense"] * other
        mats["add_whole"] = ht.sparse.add(mats["dense"], ht.sparse.sparse_csr_matrix(inputs[f"{name}_b"]))
        mats["scalar"] = mats["dense"] * 3.0
        for key, m in mats.items():
            k = f"dcsr_{name}_{key}"
            out[f"{k}_meta"] = np.array([m.nnz, m.lnnz, m.split if m.split is not None else -1] + list(m.lshape))
            for view in ("indptr", "lindptr", "indices", "lindices", "data", "ldata"):
                out[f"{k}_{view}"] = getattr(m, view).numpy()
            if m.split is not None:
                out[f"{k}_counts_displs"] = np.array(m.counts_displs_nnz())
            _record(out, f"{k}_dense", m.todense())

    # the estimators on ragged splits
    x, y = inputs["flowers"], inputs["flowers_y"]
    X = ht.array(x, split=0)
    for key, (cls, kw, attrs) in SCALER_FITS.items():
        est = getattr(ht.preprocessing, cls)(**kw).fit(X)
        for attr in attrs:
            _record(out, f"scaler_{key}_{attr}", getattr(est, attr))
        _record(out, f"scaler_{key}_transform", est.transform(X))
    nb = ht.naive_bayes.GaussianNB().fit(X, ht.array(y, split=0), sample_weight=ht.array(inputs["flowers_w"], split=0))
    for attr in ("theta_", "var_", "class_count_", "class_prior_"):
        out[f"nb_{attr}"] = getattr(nb, attr).numpy()
    _record(out, "nb_classes", nb.classes_)
    out["nb_epsilon"] = np.array(nb.epsilon_)
    _record(out, "nb_predict", nb.predict(X))
    _record(out, "nb_proba", nb.predict_proba(X))
    lasso = ht.regression.Lasso(lam=0.1)
    lasso.fit(ht.array(inputs["sugar_x"], split=0), ht.array(inputs["sugar_y"], split=0))
    _record(out, "lasso_theta", lasso.theta)
    out["lasso_n_iter"] = np.array(lasso.n_iter)
    for st, sq in ((0, 0), (0, None), (None, 0)):
        knn = ht.classification.KNeighborsClassifier(5).fit(ht.array(x, split=st), ht.array(y, split=st))
        _record(out, f"knn_{st}_{sq}", knn.predict(ht.array(inputs["flowers_q"], split=sq)))

    # the partition interface and its round trip; the byte counts of this rank's chunk
    for split in (None, 0, 1):
        a = ht.array(inputs["fx"], split=split)
        parts = a.__partitioned__
        out[f"partitioned_{split}_meta"] = np.array(str(sorted(
            (pos, p["start"], p["shape"], p["location"], str(p["dtype"])) for pos, p in parts["partitions"].items())))
        out[f"partitioned_{split}_locals"] = np.array(str(parts["locals"]))
        _record(out, f"partitioned_{split}_round_trip", ht.from_partitioned(a))
        out[f"partitioned_{split}_bytes"] = np.array([a.nbytes, a.gnbytes, a.lnbytes])
    return out


# the clustering fits at three ranks: (estimator, its arguments); the data is heat_tpu's
# spherical dataset of 4 x 100 points (134, 134, 132 rows a rank)
CLUSTER_FITS = {
    "kmeans_pp": ("KMeans", dict(n_clusters=4, init="kmeans++", max_iter=30, random_state=1)),
    "kmedians_pp": ("KMedians", dict(n_clusters=4, init="kmedians++", max_iter=30, random_state=1)),
    "kmedoids_pp": ("KMedoids", dict(n_clusters=4, init="kmedoids++", random_state=1)),
    "kmeans_bp_init": ("KMeans", dict(n_clusters=4, init="batchparallel", max_iter=10, random_state=3)),
    "bp_kmeans": ("BatchParallelKMeans", dict(n_clusters=4, random_state=4)),
    "bp_kmedians": ("BatchParallelKMedians", dict(n_clusters=4, random_state=4)),
}
SPECTRAL = dict(n_clusters=4, n_lanczos=60)
SPECTRAL_SEED = 9


def _fit_record(out: dict, key: str, est, x) -> None:
    out[f"{key}_centers"] = est.cluster_centers_.numpy()
    out[f"{key}_labels"] = est.labels_.numpy()
    out[f"{key}_n_iter"] = np.array(est.n_iter_)
    if hasattr(est, "inertia_"):
        out[f"{key}_inertia"] = np.array(est.inertia_)
    out[f"{key}_predict"] = est.predict(x).numpy()


def run_cluster(inputs) -> dict:
    """manhattan and rbf at every split pair, the spherical dataset, every clustering
    estimator and the Laplacian, and the fits again with the whole-array gather made to
    raise and the small gathers' bytes counted."""
    out = {}
    X, Y = inputs["cd_x"], inputs["cd_y"]
    for xs in (None, 0, 1):
        for ys in (None, 0):
            _record(out, f"manhattan_{xs}_{ys}", ht.spatial.manhattan(ht.array(X, split=xs), ht.array(Y, split=ys)))
            _record(out, f"rbf_{xs}_{ys}", ht.spatial.rbf(ht.array(X, split=xs), ht.array(Y, split=ys), sigma=1.5))
        _record(out, f"manhattan_self_{xs}", ht.spatial.manhattan(ht.array(X, split=xs)))
    from heat_tpu_torch.utils.data.spherical import create_spherical_dataset

    _record(out, "spherical", create_spherical_dataset(100))
    x = ht.array(inputs["sph"], split=0)
    for name, (cls, kw) in CLUSTER_FITS.items():
        _fit_record(out, name, getattr(ht.cluster, cls)(**kw).fit(x), x)
    # KMedians from explicit centers on even-sized clusters with a NaN (the distributed sort)
    med = ht.array(inputs["med_x"], split=0)
    _fit_record(out, "kmedians_nan", ht.cluster.KMedians(n_clusters=2, init=ht.array(inputs["med_init"]),
                                                         max_iter=10).fit(med), med)
    med64 = ht.array(inputs["med_x"].astype(np.float64), split=0)
    _fit_record(out, "kmedians_nan_f64", ht.cluster.KMedians(
        n_clusters=2, init=ht.array(inputs["med_init"].astype(np.float64)), max_iter=10).fit(med64), med64)
    for definition in ("simple", "norm_sym"):
        lap = ht.graph.Laplacian(lambda a: ht.spatial.rbf(a, sigma=1.5), definition=definition, mode="eNeighbour",
                                 threshold_key="lower", threshold_value=0.2)
        _record(out, f"laplacian_{definition}", lap.construct(ht.array(inputs["cd_x"], split=0)))
    small = ht.array(inputs["sph_small"], split=0)
    ht.random.seed(SPECTRAL_SEED)
    sp = ht.cluster.Spectral(**SPECTRAL).fit(small)
    out["spectral_labels"] = sp.labels_.numpy()
    out["spectral_eigenvalues"] = sp._spectral_embedding(small)[0].numpy()

    # the fits with the whole-array gather made to raise; the small gathers' bytes counted
    def refuse(self, *args, **kwargs):
        raise RuntimeError("whole-array all_gather")

    gathered = [0, 0]
    stacked = communication.TorchCommunication.all_gather_stacked

    def counted(self, tensor):
        res = stacked(self, tensor)
        gathered[tensor.numel() > 1] += res.numel() * res.element_size()
        return res

    orig = communication.TorchCommunication.all_gather
    communication.TorchCommunication.all_gather = refuse
    communication.TorchCommunication.all_gather_stacked = counted
    try:
        fits = {name: (lambda cls=cls, kw=kw: getattr(ht.cluster, cls)(**kw).fit(x))
                for name, (cls, kw) in CLUSTER_FITS.items()}
        fits["spectral"] = lambda: ht.cluster.Spectral(**SPECTRAL).fit(small)
        for name, fn in fits.items():
            gathered[:] = [0, 0]
            try:
                fn()
                out[f"no_gather_fit_{name}"] = np.array("ok")
            except Exception as exc:
                out[f"no_gather_fit_{name}"] = np.array(f"{type(exc).__name__}: {exc}")
                continue
            out[f"no_gather_fit_{name}_bytes"] = np.array(gathered)
    finally:
        communication.TorchCommunication.all_gather = orig
        communication.TorchCommunication.all_gather_stacked = stacked
    return out


def _record(out: dict, key: str, x) -> None:
    for name, value in port_record(x).items():
        if getattr(value, "dtype", None) is not None and value.dtype.name == "bfloat16":
            value = value.astype(np.float32)  # npz keeps no bfloat16 (exact in float32)
        out[f"{key}__{name}"] = value


def run_linalg(inputs, comm) -> dict:
    """The distributed linear algebra: every plan of the planner, resplit between every
    pair of splits, the collectives with an empty rank, config #2 and hsvd_rank at small
    size, TSQR and the ring cdist."""
    out = {}
    knob = comm_plan.PLAN_KNOB
    a, b = inputs["la_a"], inputs["la_b"]
    for value in ("auto", "xla", "ring", "rs"):
        os.environ[knob] = value
        for sa in (None, 0, 1):
            for sb in (None, 0, 1):
                x, y = ht.array(a, split=sa), ht.array(b, split=sb)
                plan = comm_plan.plan_matmul(x, y)
                out[f"plan_{value}_{sa}_{sb}"] = np.array("None" if plan is None else repr(tuple(plan)))
                comm_plan.reset_counters()
                _record(out, f"mm_{value}_{sa}_{sb}", ht.matmul(x, y))
                out[f"mm_{value}_{sa}_{sb}_counted"] = np.array(repr(sorted(comm_plan.COUNTERS.items())))
    # integer and bool products under every knob: the ring, rs and general paths
    for value in ("auto", "xla", "ring", "rs"):
        os.environ[knob] = value
        for dt in ("i8", "i32", "bool"):
            for sa in (None, 0, 1):
                for sb in (None, 0, 1):
                    x, y = ht.array(inputs[f"la_{dt}_a"], split=sa), ht.array(inputs[f"la_{dt}_b"], split=sb)
                    comm_plan.reset_counters()
                    _record(out, f"imm_{value}_{dt}_{sa}_{sb}", ht.matmul(x, y))
                    out[f"imm_{value}_{dt}_{sa}_{sb}_counted"] = np.array(repr(sorted(comm_plan.COUNTERS.items())))
    os.environ.pop(knob)
    for dt in ("i64", "bool"):
        _record(out, f"idot_{dt}", ht.dot(ht.array(inputs[f"v_{dt}"], split=0), ht.array(inputs[f"v_{dt}"], split=0)))

    # a ring plan whose collective fails raises on every rank, and nothing else runs
    def failing(self, *args, **kwargs):
        raise RuntimeError("ring_shift failed")

    orig_shift = communication.TorchCommunication.ring_shift
    communication.TorchCommunication.ring_shift = failing
    try:
        ht.matmul(ht.array(a, split=0), ht.array(b, split=1))
        out["ring_failure"] = np.array("returned")
    except RuntimeError as exc:
        out["ring_failure"] = np.array(str(exc))
    finally:
        communication.TorchCommunication.ring_shift = orig_shift

    # resplit between every pair of splits of a (4, 7, 5) array: 2, 2, 0 rows on the ranks
    gathers = []
    orig_gather = communication.TorchCommunication.all_gather

    def counting_gather(self, *args, **kwargs):
        gathers.append(1)
        return orig_gather(self, *args, **kwargs)

    communication.TorchCommunication.all_gather = counting_gather
    try:
        for value in ("auto", "xla"):
            os.environ[knob] = value
            for src in (None, 0, 1, 2):
                for dst in (None, 0, 1, 2):
                    for data in ("rs_x", "rs_bool"):
                        x = ht.array(inputs[data], split=src)
                        gathers.clear()
                        x.resplit_(dst)
                        out[f"resplit_{value}_{data}_{src}_{dst}_gathers"] = np.array(len(gathers))
                        _record(out, f"resplit_{value}_{data}_{src}_{dst}", x)
    finally:
        communication.TorchCommunication.all_gather = orig_gather
        os.environ.pop(knob)

    # the collectives on their own, with rank 2 holding nothing of 4 rows
    x = ht.array(inputs["rs_x"], split=0)
    counts = comm.counts_displs_shape(x.gshape, 0)[0]
    src = (comm.rank - 1) % comm.size
    out["ring_shift_empty"] = comm.ring_shift(x.larray, 1, (counts[src],) + x.gshape[1:]).numpy()
    out["ring_shift_back"] = comm.ring_shift(x.larray, -1, (counts[(comm.rank + 1) % comm.size],) + x.gshape[1:]).numpy()
    out["a2a_empty"] = comm.all_to_all(x.larray, split_axis=2, concat_axis=0, concat_extent=4).numpy()
    for n in (4, 6):
        partial = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3) * (comm.rank + 1)
        out[f"reduce_scatter_{n}"] = comm.reduce_scatter(partial, 0).numpy()

    # config #2 at small size, ragged over three ranks (10 rows: 4, 4, 2; 11 columns: 4, 4, 3)
    comm_plan.reset_counters()
    _record(out, "config2", ht.matmul(ht.array(inputs["c2_a"], split=0), ht.array(inputs["c2_b"], split=1)))
    out["config2_counted"] = np.array(repr(sorted(comm_plan.COUNTERS.items())))
    _record(out, "matmul_batch", ht.matmul(ht.array(inputs["bt_a"], split=0), ht.array(inputs["bt_b"])))
    _record(out, "matmul_batch_contract", ht.matmul(ht.array(inputs["bt_a"], split=2), ht.array(inputs["bt_b"], split=0)))
    _record(out, "dot_split", ht.dot(ht.array(inputs["v"], split=0), ht.array(inputs["v"], split=0)))

    # hsvd_rank on ragged column blocks (31 columns: 11, 11, 9), and on the transpose split 0
    for name, split in (("hsvd_a", 1), ("hsvd_at", 0)):
        U, err = ht.linalg.hsvd_rank(ht.array(inputs[name], split=split), 3)
        _record(out, f"{name}_U", U)
        _record(out, f"{name}_err", err)
        U, sigma, V, _ = ht.linalg.hsvd_rank(ht.array(inputs[name], split=split), 3, compute_sv=True)
        _record(out, f"{name}_sv_U", U)
        _record(out, f"{name}_sv_sigma", sigma)
        _record(out, f"{name}_sv_V", V)
    U, err = ht.linalg.hsvd_rtol(ht.array(inputs["hsvd_noisy"], split=1), 1e-2)
    _record(out, "hsvd_rtol_U", U)
    _record(out, "hsvd_rtol_err", err)

    # TSQR and the SVD on it, tall-skinny split 0 (60 rows: 20 a rank, 2 panels each)
    q, r = ht.linalg.qr(ht.array(inputs["tall"], split=0))
    _record(out, "tsqr_Q", q)
    _record(out, "tsqr_R", r)
    u, s, vh = ht.linalg.svd(ht.array(inputs["tall"], split=0))
    _record(out, "tsvd_U", u)
    _record(out, "tsvd_S", s)

    # the ring cdist: Y's chunks travel the ring (8 rows: 3, 3, 2; 2 rows: 1, 1, 0)
    X = ht.array(inputs["cd_x"], split=0)
    for name in ("cd_y", "cd_y2"):
        _record(out, f"cdist_{name}", ht.spatial.cdist(X, ht.array(inputs[name], split=0)))
    _record(out, "cdist_self", ht.spatial.cdist(X))
    return out


def run_array_api(comm) -> dict:
    """The array API: every case of tests/_torch_array_cases.py, redistribute between
    arbitrary chunkings, halos, is_split with other chunks than the canonical ones,
    normal draws, and the functions that must not gather the array run with the
    whole-array all_gather made to raise."""
    from _torch_array_cases import CASES, INPUTS, Arrays, splits_of

    out = {}
    arr = Arrays(ht)
    for name, fn in CASES.items():
        for split in splits_of(name):
            try:
                res = fn(ht, arr, split)
            except Exception as exc:  # recorded: the parent reports it beside heat_tpu's result
                out[f"case_{name}_{split}_error"] = np.array(f"{type(exc).__name__}: {exc}")
                continue
            for i, r in enumerate(res if isinstance(res, tuple) else (res,)):
                _record(out, f"case_{name}_{split}_{i}", r)

    # redistribute between arbitrary count pairs, along axis 0 of (7, 3) and axis 1 of (4, 7)
    rank = comm.rank
    for k, (src, dst) in enumerate(REDISTRIBUTE_PAIRS):
        for axis, data in ((0, np.arange(21.0).reshape(7, 3)), (1, np.arange(28).reshape(4, 7))):
            lo = sum(src[:rank])
            local = torch.from_numpy(np.take(data, range(lo, lo + src[rank]), axis=axis).copy())
            out[f"redistribute_{k}_{axis}"] = comm.redistribute(local, data.shape, axis, src, dst).numpy()

    # halos of a split array with an empty rank (4 rows: 2, 2, 0) and of one of 7 rows
    for name, h in (("small", 1), ("a", 2)):
        x = ht.array(INPUTS[name], split=0)
        x.get_halo(h)
        out[f"halo_{name}_prev"] = np.array([]) if x.halo_prev is None else x.halo_prev.numpy()
        out[f"halo_{name}_next"] = np.array([]) if x.halo_next is None else x.halo_next.numpy()

    # integer keys written twice with different values, at every split: the last write wins
    for split in (None, 0, 1):
        x = ht.array(INPUTS["a"], split=split)
        x[:, [-1, 0, 0]] = ht.array(INPUTS["a"][:, 0:3])
        x[[2, -5, 2]] = ht.array(INPUTS["a"][4:7])
        _record(out, f"dup_set_{split}", x)

    # is_split with chunks of 1, 5 and 1 rows: rebalanced to the canonical 3, 3, 1
    rows = [(0, 1), (1, 6), (6, 7)][rank]
    _record(out, "is_split", ht.array(INPUTS["a"][rows[0]:rows[1]], is_split=0))

    # normal draws (held to heat_tpu's within a few ulp by the parent) and the state
    for dtype in ("float32", "float64"):
        ht.random.seed(11)
        _record(out, f"randn_{dtype}", ht.random.randn(7, 5, dtype=getattr(ht, dtype), split=0))
        out[f"randn_{dtype}_state"] = np.array(ht.random.get_state()[1:3])

    # printing: a large split array from its edge items, a small one whole
    for split in (None, 0, 1):
        out[f"print_{split}"] = np.array(str(ht.array(PRINTED, split=split)))
        out[f"print_small_{split}"] = np.array(str(ht.array(INPUTS["a"], split=split)))

    # the paths that must not gather the array, with the whole-array gather made to raise
    # and the bytes this rank receives counted: from the small gathers (all_gather_stacked,
    # under all_gather_counts and all_gather_v) one value a rank (counts) apart from the
    # rest (candidates, halos, totals, selections), and what the moves hand this rank
    # (redistribute, take, fetch, ring_shift, all_to_all, exchange: the tensor each returns
    # or, for ring_shift, receives, which holds what arrived and at most what it kept)
    def refuse(self, *args, **kwargs):
        raise RuntimeError("whole-array all_gather")

    gathered = [0, 0, 0]
    stacked = communication.TorchCommunication.all_gather_stacked
    TC = communication.TorchCommunication
    moves = {name: getattr(TC, name) for name in ("redistribute", "take", "fetch", "all_to_all", "exchange")}
    ring_shift = TC.ring_shift

    def counted(self, tensor):
        res = stacked(self, tensor)
        gathered[tensor.numel() > 1] += res.numel() * res.element_size()
        return res

    def counting(move):
        def wrapped(self, *args, **kwargs):
            res = move(self, *args, **kwargs)
            gathered[2] += res.numel() * res.element_size()
            return res
        return wrapped

    def counted_shift(self, tensor, shift=1, recv_shape=None, async_op=False):
        if self.size > 1 and shift % self.size:
            gathered[2] += int(np.prod(tensor.shape if recv_shape is None else recv_shape)) * tensor.element_size()
        return ring_shift(self, tensor, shift, recv_shape, async_op)

    orig = communication.TorchCommunication.all_gather
    communication.TorchCommunication.all_gather = refuse
    communication.TorchCommunication.all_gather_stacked = counted
    for name, move in moves.items():
        setattr(TC, name, counting(move))
    TC.ring_shift = counted_shift
    try:
        for name, fn in NO_GATHER.items():
            gathered[:] = [0, 0, 0]
            try:
                res = fn(ht, arr)
                out[f"no_gather_{name}"] = np.array("ok")
            except Exception as exc:
                out[f"no_gather_{name}"] = np.array(f"{type(exc).__name__}: {exc}")
                continue
            res = res[0] if isinstance(res, tuple) else res
            nbytes = res.size * res.larray.element_size() if isinstance(res, ht.DNDarray) else 0
            local = res.larray.numel() * res.larray.element_size() if isinstance(res, ht.DNDarray) else 0
            out[f"no_gather_{name}_bytes"] = np.array(gathered[:2] + [nbytes, gathered[2], local])
    finally:
        communication.TorchCommunication.all_gather = orig
        communication.TorchCommunication.all_gather_stacked = stacked
        for name, move in moves.items():
            setattr(TC, name, move)
        TC.ring_shift = ring_shift
    return out


def run_sort_cases() -> dict:
    """At four ranks (a power of two: the bitonic network) the array API cases that sort,
    select or redistribute, and the random streams."""
    from _torch_array_cases import CASES, Arrays, splits_of

    ht.use_device("cpu")
    out = {"world": np.array([ht.get_comm().size, ht.get_comm().rank])}
    for name in SORT_CASES:
        for split in splits_of(name):
            res = CASES[name](ht, Arrays(ht), split)
            for i, r in enumerate(res if isinstance(res, tuple) else (res,)):
                _record(out, f"case_{name}_{split}_{i}", r)
    return out


SORT_CASES = ["sort0", "sort1", "sort_ties", "sort_ties_desc", "sort_ties2d", "sort_ints", "sort_small", "topk",
              "topk_small", "topk_ties", "unique", "unique_inverse", "unique_ties", "percentile", "percentile_axis0",
              "percentile_nan", "median", "median_all", "reshape_new_split1", "concatenate1", "get_neg_step",
              "get_mask", "rand", "randint", "randperm", "permutation", "kmeans_random", "edge_sort_complex",
              "edge_sort_complex_nan", "edge_unique_complex"]

# (source counts, destination counts) over three ranks, 7 slices each
REDISTRIBUTE_PAIRS = [([3, 3, 1], [0, 7, 0]), ([0, 7, 0], [2, 2, 3]), ([1, 0, 6], [5, 2, 0]), ([7, 0, 0], [0, 0, 7])]

# the functions of the benchmark's paths, on split arrays: none may gather the array
NO_GATHER = {
    "reshape_new_split": lambda m, arr: m.reshape(arr("a", 0), (5, 7), new_split=1),
    "reshape_flat": lambda m, arr: m.reshape(arr("cube", 1), (84,), new_split=0),
    "concatenate_1_none_1": lambda m, arr: m.concatenate([arr("a", 1), arr("a", None), arr("a", 1)], axis=1),
    "resplit": lambda m, arr: m.resplit(arr("a", 0), 1),
    "sort": lambda m, arr: m.sort(arr("long", 0)),
    "sort_desc": lambda m, arr: m.sort(arr("a", 0), axis=0, descending=True),
    "topk": lambda m, arr: m.topk(arr("long", 0), 5),
    "unique": lambda m, arr: m.unique(m.floor(arr("a", 0))),
    "percentile": lambda m, arr: m.percentile(arr("long", 0), [25, 50, 99]),
    "median": lambda m, arr: m.median(arr("a", 0), axis=0),
    "slice": lambda m, arr: arr("long", 0)[3::7],
    "slice_neg": lambda m, arr: arr("a", 0)[::-2],
    "mask": lambda m, arr: arr("long", 0)[arr("long", 0) > 0.5],
    "setitem": lambda m, arr: arr("long", 0).__setitem__(slice(2, None, 3), 0.0),
    "flip": lambda m, arr: m.flip(arr("a", 0), 0),
    "cumsum": lambda m, arr: m.cumsum(arr("a", 0), 0),
    "diff": lambda m, arr: m.diff(arr("a", 0), axis=0),
    "nonzero": lambda m, arr: m.nonzero(arr("mask_a", 0)),
    "nonzero_split1": lambda m, arr: m.nonzero(arr("mask_a", 1)),
    "row_take": lambda m, arr: arr("a", 0)[[6, 0, 3]],
    "permutation": lambda m, arr: m.random.permutation(arr("a", 0)),
    "convolve": lambda m, arr: m.convolve(arr("long", 0), m.array([1.0, 2.0, 1.0]), mode="same"),
    "print": lambda m, arr: str(m.array(PRINTED, split=0)),
    "set_mask_split_value": lambda m, arr: arr("a", 1).__setitem__(arr("mask_a", 1), arr("mask_vals", 0)),
    # the split-axis forms (tests/test_torch_distributed.py bounds what each moves: MOVED)
    "roll_0": lambda m, arr: m.roll(arr("a", 0), 5, 0),
    "roll_1": lambda m, arr: m.roll(arr("a", 1), -3, 1),
    "roll_flat_0": lambda m, arr: m.roll(arr("a", 0), 11),
    "roll_flat_1": lambda m, arr: m.roll(arr("a", 1), -11),
    "tile_0": lambda m, arr: m.tile(arr("a", 0), (3, 1)),
    "tile_1": lambda m, arr: m.tile(arr("a", 1), (1, 2)),
    "pad_reflect_0": lambda m, arr: m.pad(arr("a", 0), ((4, 9), (2, 6)), mode="reflect"),
    "pad_wrap_1": lambda m, arr: m.pad(arr("a", 1), ((4, 9), (2, 6)), mode="wrap"),
    "pad_mean_0": lambda m, arr: m.pad(arr("small", 0), ((2, 3), (1, 2)), mode="mean"),
    "pad_maximum_1": lambda m, arr: m.pad(arr("a", 1), ((1, 2), (3, 1)), mode="maximum"),
    "pad_median_0": lambda m, arr: m.pad(arr("a", 0), ((1, 2), (3, 1)), mode="median"),
    "pad_linear_ramp_1": lambda m, arr: m.pad(arr("a", 1), ((1, 2), (3, 1)), mode="linear_ramp"),
    "diagonal_0": lambda m, arr: m.diagonal(arr("a", 0), 1),
    "diagonal_1": lambda m, arr: m.diagonal(arr("cube", 1), -2, 2, 1),
    "diag_0": lambda m, arr: m.diag(arr("ivec", 0), -3),
    "trace_0": lambda m, arr: m.trace(arr("ints", 0), 2),
    "trace_1": lambda m, arr: m.trace(arr("ints", 1), -1),
    "trace_batch_2": lambda m, arr: m.trace(arr("icube", 2), 1, 0, 1),
    "tril_0": lambda m, arr: m.tril(arr("a", 0), 2),
    "triu_1": lambda m, arr: m.triu(arr("a", 1), -1),
    "tril_vec_0": lambda m, arr: m.tril(arr("ivec", 0), 1),
    "vdot_0": lambda m, arr: m.vdot(arr("a", 0), arr("a", 0)),
    "vdot_0_1": lambda m, arr: m.vdot(arr("ints", 0), arr("ints", 1)),
    "vector_norm_1_0": lambda m, arr: m.vector_norm(arr("a", 0), ord=1),
    "vector_norm_inf_1": lambda m, arr: m.vector_norm(arr("a", 1), ord=np.inf),
    "matrix_norm_1_0": lambda m, arr: m.matrix_norm(arr("a", 0), ord=1),
    "matrix_norm_ninf_1": lambda m, arr: m.matrix_norm(arr("a", 1), ord=-np.inf),
    "matrix_norm_fro_1": lambda m, arr: m.matrix_norm(arr("a", 1)),
    "norm_batch_0": lambda m, arr: m.norm(arr("cube", 0), axis=(1, 2), ord=-1),
    "cov_obs_1": lambda m, arr: m.cov(arr("a", 1)),
    "cov_obs_0": lambda m, arr: m.cov(arr("a", 0), rowvar=False),
    "cov_vars_0": lambda m, arr: m.cov(arr("a", 0)),
    "cov_vars_1_y": lambda m, arr: m.cov(arr("a", 1), arr("a", 1), rowvar=False),
    "get_int_keys_0": lambda m, arr: arr("a", 0)[[1, -2], [3, -1]],
    "get_int_keys_cols_0": lambda m, arr: arr("a", 0)[:, [-1, 0, 0]],
    "get_int_keys_1": lambda m, arr: arr("cube", 1)[[2, -1], :, [0, 2]],
    "set_int_keys_0": lambda m, arr: arr("a", 0).__setitem__(([1, -2, 1], [3, -1, 3]), 7.0),
    "set_int_keys_1": lambda m, arr: arr("a", 1).__setitem__((slice(None), [-1, 0, 0]), arr("a", None)[:, 0:3]),
}

PRINTED = np.arange(40 * 50, dtype=np.float32).reshape(40, 50) / 7


SUP_STEPS = 6
SUP_DEAD_RANK = 2
SUP_DEAD_STEP = 3


def sup_step(step, state):
    """One step of the supervised run: a local update and a global sum (a collective,
    so a dead peer is met inside it)."""
    from heat_tpu_torch.core import resilience

    resilience.maybe_fault("train.step")
    w = state["w"]
    return {"w": w * 0.5 + w.sum() * 1e-3 + float(step)}


def run_supervised_case(rank: int, init_file: str, out_dir: str) -> dict:
    """Three ranks under the supervision plane; rank 2 dies at step 3 through the
    ``peer-dead`` fault (silence, then exit 43). The survivors' collective fails on the
    dead peer and surfaces as ``PeerFailed``; ``run_supervised`` tears the group down,
    re-initialises at world 2 over a new file store, restores the latest step (saved
    at world 3) through reshard-on-restore and runs to the end. Then each survivor
    restores that step again and runs the remaining steps plainly at world 2: the
    uninterrupted run the supervised one must equal."""
    from heat_tpu_torch.core import resilience, supervision

    # a survivor can block inside gloo on a survivor that already left the collective;
    # the process group's timeout (the watchdog budget) ends that wait
    os.environ["HEAT_TPU_PEER_TIMEOUT_S"] = "3"
    os.environ["HEAT_TPU_COLLECTIVE_TIMEOUT_S"] = "6"
    os.environ["HEAT_TPU_FLIGHT_DIR"] = os.path.join(out_dir, "flight")  # the abort's post-mortem
    supervision.reload_env_knobs()
    ht.get_comm().barrier()
    supervision.arm(supervision.default_coordinator(), rank=rank, nprocs=3)
    ht.get_comm().barrier()
    manager = ht.CheckpointManager(os.path.join(out_dir, "sup_ckpt"), max_to_keep=8)
    resilience.arm_fault_plan([{"site": "train.step", "kind": "peer-dead", "on_call": SUP_DEAD_STEP + 1,
                                "rank": SUP_DEAD_RANK}])
    restored = []

    def reinit(exc):
        restored.append(type(exc).__name__)
        return {"coordinator_address": f"file://{init_file}.gen2", "num_processes": 2, "process_id": rank}

    def template():
        return {"w": ht.zeros((12,), split=0)}

    out = resilience.run_supervised(sup_step, manager, template=template,
                                    state={"w": ht.array(np.arange(12.0, dtype=np.float32), split=0)},
                                    max_steps=SUP_STEPS, save_every=1, reinit=reinit)
    resilience.disarm_fault_plan()
    resumed_from = manager.latest_step
    plain = manager.restore(template(), step=SUP_DEAD_STEP - 1)
    for step in range(SUP_DEAD_STEP, SUP_STEPS):
        plain = sup_step(step, plain)
    return {
        "world_after": np.array([dist.get_world_size(), dist.get_rank()]),
        "steps_restarts": np.array([out["steps"], out["restarts"]]),
        "cause": np.array(restored),
        "latest_step": np.array(resumed_from),
        "w": out["state"]["w"].numpy(),
        "w_plain": plain["w"].numpy(),
    }


def main():
    rank, world, init_file, inputs_path, out_dir = sys.argv[1:6]
    torch.set_num_threads(1)
    # torchrun's environment, read by ht.initialize (gloo: the CPU was asked for)
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank)
    ht.use_device("cpu")
    ht.initialize(init_method=f"file://{init_file}")
    try:
        out = run(np.load(inputs_path)) if int(world) == 3 else run_sort_cases()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        if int(world) == 3:  # last: rank 2 does not come back from it
            sup = run_supervised_case(int(rank), init_file, out_dir)
            np.savez(os.path.join(out_dir, f"sup{rank}.npz"), **sup)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
