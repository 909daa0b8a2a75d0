"""One gloo rank of tests/test_torch_train_state.py: DASO at 2 nodes x 2 ranks, the
checkpoint at 4 ranks, HDF5 slabs and rank-targeted write faults.

    python tests/_torch_train_state_worker.py RANK WORLD RENDEZVOUS_FILE INPUTS.npz OUT_DIR

Each rank joins through ``ht.initialize`` (torchrun's environment, gloo: the CPU was asked
for), runs every case, and writes what the parent compares to OUT_DIR/rank{RANK}.npz.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core import checkpoint as ckpt  # noqa: E402
from heat_tpu_torch.core import diagnostics, resilience  # noqa: E402

def make_daso(inputs, **kw):
    """test_daso.py's model (Linear(8, 16), ReLU, Linear(16, 4)) from heat_tpu's seed-0
    parameters, SGD at 0.05, under DASO over a hierarchical(2) communicator."""
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(inputs[f"param_{name}"]))
    hier = ht.TorchCommunication.hierarchical(2)
    opt = ht.optim.DataParallelOptimizer("sgd", lr=0.05)
    ht.nn.DataParallelMultiGPU(model, optimizer=opt, comm=hier)
    kw.setdefault("total_epochs", 4)
    kw.setdefault("warmup_epochs", 1)
    kw.setdefault("cooldown_epochs", 1)
    return ht.optim.DASO(opt, comm=hier, **kw)


def loss_fn(model, x, y):
    return torch.nn.functional.cross_entropy(model(x), y)


def dropout_loss_fn(key):
    """loss_fn with dropout 0.1 on the hidden layer under the key ``key`` (two uint32 words)."""
    def loss(model, x, y):
        seq = model.module
        h = ht.nn.functional.dropout(seq[1](seq[0](x)), 0.1, key=key)
        return torch.nn.functional.cross_entropy(seq[2](h), y)

    return loss


def stacked(daso) -> dict:
    return {n: t.numpy().copy() for n, t in daso.stacked_params.items()}


def record_steps(out, tag, daso, steps, batch, fn=loss_fn):
    for _ in range(steps):
        loss = daso.step(fn, *batch)
        out.setdefault(f"{tag}_loss", []).append(float(loss))
        for n, v in stacked(daso).items():
            out.setdefault(f"{tag}_p_{n}", []).append(v)


def run_daso(inputs, out):
    x = ht.array(inputs["x16"], split=0)
    y = ht.array(inputs["y16"], split=0)
    hier = ht.TorchCommunication.hierarchical(2)
    out["hier"] = [hier.n_nodes, hier.node_size, hier.node, hier.local_rank, hier.node_comm.size, hier.cross_comm.size,
                   int(hier.is_hierarchical)]
    # the cadence and the phase machine, with the replicas after every step
    daso = make_daso(inputs, total_epochs=6, warmup_epochs=1, cooldown_epochs=1, max_global_skips=4)
    syncs = []
    orig = daso._global_sync
    daso._global_sync = lambda: (syncs.append(daso._batch_in_epoch), orig())[1]
    states = []

    def state():
        states.append([daso.epoch, {"warmup": 0, "cycling": 1, "cooldown": 2}[daso._phase], daso.global_skip,
                       daso.local_skip, daso.batches_to_wait])

    record_steps(out, "cad", daso, 3, (x, y))
    daso.epoch_end()
    state()
    record_steps(out, "cad", daso, 8, (x, y))
    for _ in range(4):
        daso.epoch_end()
        state()
    record_steps(out, "cad", daso, 2, (x, y))
    out["cad_syncs"] = syncs
    out["cad_states"] = states
    # de-synchronised replicas re-averaged: replica i <- i + 1
    daso = make_daso(inputs)
    daso.step(loss_fn, ht.zeros((8, 8), split=0), ht.zeros((8,), dtype=ht.int64, split=0))
    daso.stacked_params = {n: torch.arange(1, 3, dtype=torch.float32).view((2,) + (1,) * t.dim()).expand((2,) + t.shape)
                           for n, t in daso.local_optimizer._model.module.named_parameters()}
    daso._global_sync()
    out.update({f"desync_p_{n}": v for n, v in stacked(daso).items()})
    # the sub-ulp case: 1000 + j·1e-3 survives the bf16 wire
    daso.stacked_params = {n: torch.full((2,) + t.shape, 1000.0) + (torch.arange(2.0) * 1e-3).view((2,) + (1,) * t.dim())
                           for n, t in daso.local_optimizer._model.module.named_parameters()}
    daso._global_sync()
    out.update({f"subulp_p_{n}": v for n, v in stacked(daso).items()})
    # replicas diverge between syncs while cycling, and the next sync re-joins them
    daso = make_daso(inputs, warmup_epochs=0, max_global_skips=8)
    daso._batch_in_epoch = 1
    record_steps(out, "div", daso, 3, (x, y))
    daso._global_sync()
    out.update({f"divsync_p_{n}": v for n, v in stacked(daso).items()})
    out["div_consolidated"] = np.concatenate([v.numpy().ravel() for v in daso.consolidated_params().values()])
    # dropout under one key: each node's mask is drawn over its 8 rows, each rank keeps its 4
    daso = make_daso(inputs)
    record_steps(out, "drop", daso, 2, (x, y), dropout_loss_fn(inputs["drop_key"]))
    # a ragged batch (10 rows: node chunks 3, 2 | 3, 2 against the world's 3, 3, 3, 1)
    daso = make_daso(inputs)
    xr, yr = ht.array(inputs["x10"], split=0), ht.array(inputs["y10"], split=0)
    record_steps(out, "rag", daso, 2, (xr, yr))
    daso.epoch_end()
    record_steps(out, "rag", daso, 2, (xr, yr))
    # epoch_loss_logic averages the ranks' losses (0, 1, 2, 3) before the plateau test
    averaging = make_daso(inputs, warmup_epochs=0)
    averaging.epoch_loss_logic(torch.tensor(float(dist.get_rank())))
    out["loss_logic_best"] = averaging.stability.best
    try:
        daso.step(loss_fn, ht.zeros((7, 8), split=0), ht.zeros((7,), dtype=ht.int64, split=0))
        out["odd_batch"] = "no error"
    except ValueError as exc:
        out["odd_batch"] = str(exc)
    for v in list(out):
        if isinstance(out[v], list) and out[v] and isinstance(out[v][0], np.ndarray):
            out[v] = np.stack(out[v])


def ckpt_tree(inputs):
    return {
        "f32": ht.array(inputs["ck_f32"], split=0), "f64": ht.array(inputs["ck_f64"], split=1),
        "i32": ht.array(inputs["ck_i32"]), "bf16": ht.array(inputs["ck_bf"], split=0).astype(ht.bfloat16),
        "numpy": np.arange(6, dtype=np.int64).reshape(2, 3), "count": 17,
    }


def ckpt_template(splits):
    return {
        "f32": ht.zeros((7, 6), split=splits[0]), "f64": ht.zeros((5, 9), dtype=ht.float64, split=splits[1]),
        "i32": ht.zeros((11, 3), dtype=ht.int32, split=splits[2]),
        "bf16": ht.zeros((9, 4), dtype=ht.bfloat16, split=splits[3]), "numpy": np.zeros((2, 3), np.int64), "count": 0,
    }


def run_checkpoint(inputs, out, out_dir):
    path = os.path.join(out_dir, "ck4")
    ht.save_checkpoint(ckpt_tree(inputs), path)
    back = ht.load_checkpoint(ckpt_template((1, 0, 0, None)), path)
    for k in ("f32", "f64", "i32", "bf16"):
        out[f"ck_back_{k}"] = back[k].astype(ht.float64).numpy()
        out[f"ck_back_{k}_split"] = -1 if back[k].split is None else back[k].split
    out["ck_read_bytes"] = ckpt.last_restore_stats()["read_bytes"]
    out["ck_count"] = back["count"]
    # heat_tpu's checkpoint of the same tree on its 4-device mesh
    jback = ht.load_checkpoint(ckpt_template((0, 1, None, 0)), str(inputs["jax_ckpt"]))
    for k in ("f32", "f64", "i32", "bf16"):
        out[f"ck_jback_{k}"] = jback[k].astype(ht.float64).numpy()
    # a manager over 4 ranks: retention, latest, the writer's prune
    mgr = ht.CheckpointManager(os.path.join(out_dir, "run"), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"x": ht.arange(9, dtype=ht.float32, split=0) * float(s)})
    out["mgr_steps"] = mgr.all_steps()
    out["mgr_latest"] = mgr.restore({"x": ht.zeros((9,), split=0)})["x"].numpy()


def run_hdf5(out, out_dir):
    import h5py

    n = 4 * 3 + 3
    ref = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    writes, reads = [], []
    set_orig, get_orig = h5py.Dataset.__setitem__, h5py.Dataset.__getitem__

    def set_spy(self, key, value):
        writes.append([key[0].start, key[0].stop] if isinstance(key, tuple) else [-1, -1])
        return set_orig(self, key, value)

    def get_spy(self, key):
        reads.append([key[0].start, key[0].stop])
        return get_orig(self, key)

    h5py.Dataset.__setitem__, h5py.Dataset.__getitem__ = set_spy, get_spy
    try:
        for split in (0, 1, None):
            path = os.path.join(out_dir, f"slab{split}.h5")
            ht.save_hdf5(ht.array(ref, split=split), path, "data")
            if split == 0:
                out["h5_writes"] = np.array(writes)
                back = ht.load_hdf5(path, "data", split=0)
                out["h5_reads"] = np.array(reads)
                out["h5_local"] = back.larray.numpy()
        ht.save_hdf5(ht.arange(6, split=0) * 2, os.path.join(out_dir, "slab0.h5"), "b", mode="a")
    finally:
        h5py.Dataset.__setitem__, h5py.Dataset.__getitem__ = set_orig, get_orig
    npy = os.path.join(out_dir, "x.npy")
    ht.save(ht.array(ref, split=0), npy)
    out["npy_local"] = ht.load(npy, split=1).larray.numpy()
    csv = os.path.join(out_dir, "x.csv")
    ht.save_csv(ht.array(ref, split=0), csv, decimals=1)
    out["csv_local"] = ht.load_csv(csv, split=0).larray.numpy()


def run_faults(out, out_dir):
    x = {"x": ht.arange(40, dtype=ht.float32, split=0).reshape((10, 4))}
    diagnostics.reset()
    resilience.set_policy("checkpoint.chunk_write", resilience.Policy(max_attempts=2, backoff_base=0.0))
    resilience.arm_fault_plan([{"site": "checkpoint.chunk_write", "kind": "raise", "on_call": 1, "count": 10**6,
                                "rank": 2}])
    try:
        ht.save_checkpoint(x, os.path.join(out_dir, "degraded"))
        out["fault_degrade"] = "committed"
    except Exception as exc:
        out["fault_degrade"] = type(exc).__name__
    finally:
        resilience.disarm_fault_plan()
        resilience.set_policy("checkpoint.chunk_write", None)
        resilience.reset(clear_breakers=True)
    out["fault_degrade_schema"] = ckpt.read_manifest(os.path.join(out_dir, "degraded"))["schema"]
    out["fault_degrade_events"] = len([e for e in diagnostics.report()["resilience_events"] if e["kind"] == "fallback"])
    out["fault_degrade_value"] = ht.load_checkpoint({"x": ht.zeros((10, 4), split=1)},
                                                    os.path.join(out_dir, "degraded"))["x"].numpy()
    # a hard failure on rank 2 (its chunk-metadata sidecar): every rank raises, none hangs
    resilience.arm_fault_plan([{"site": "checkpoint.chunk_meta", "kind": "raise", "on_call": 1, "count": 10**6,
                                "rank": 2}])
    try:
        ht.save_checkpoint(x, os.path.join(out_dir, "failed"))
        out["fault_hard"] = "committed"
    except Exception as exc:
        out["fault_hard"] = type(exc).__name__
    finally:
        resilience.disarm_fault_plan()
        resilience.reset(clear_breakers=True)
    out["fault_hard_exists"] = int(os.path.exists(os.path.join(out_dir, "failed")))
    dist.barrier()


def main():
    rank, world, init_file, inputs_path, out_dir = sys.argv[1:6]
    torch.set_num_threads(1)
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank)
    ht.use_device("cpu")
    ht.initialize(init_method=f"file://{init_file}")
    inputs = dict(np.load(inputs_path))
    out = {}
    try:
        run_daso(inputs, out)
        run_checkpoint(inputs, out, out_dir)
        run_hdf5(out, out_dir)
        run_faults(out, out_dir)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    main()
