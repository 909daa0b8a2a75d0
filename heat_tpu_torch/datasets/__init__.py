"""Packaged sample datasets (counterpart of heat_tpu/datasets/): the flowers table (150 × 4,
three classes) as CSV and HDF5 with its labels and an 80/20 train/test split, and the
sugar regression table (442 × 10 and its target) as HDF5. The files ship with the
package, byte for byte heat_tpu's; :func:`generate` writes them again from their seed.

- ``flowers.csv`` / ``flowers.h5`` (dataset ``data``): 150 × 4 float32, ``;``-separated
- ``flowers_labels.csv``: one label per sample
- ``flowers_X_train.csv`` / ``flowers_X_test.csv``: 120 / 30 × 4
- ``flowers_y_train.csv`` / ``flowers_y_test.csv``: their labels
- ``sugar.h5``: datasets ``x`` (442 × 10 float32) and ``y`` (442 float32)
- ``flowers.nc``: written only where netCDF4 is installed
"""

import os

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SEED = 20260729


def path(name: str) -> str:
    """Absolute path of a packaged dataset file, generating the files if it is missing."""
    p = os.path.join(_DIR, name)
    if not os.path.exists(p):
        generate()
    return p


def _flowers(rng) -> tuple:
    blocks, labels = [], []
    for k, center in enumerate(((5.0, 3.4, 1.5, 0.2), (5.9, 2.8, 4.3, 1.3), (6.6, 3.0, 5.6, 2.0))):
        blocks.append(rng.normal(center, 0.3, size=(50, 4)))
        labels.append(np.full(50, k, dtype=np.int64))
    return np.vstack(blocks).astype(np.float32), np.concatenate(labels)


def tables() -> dict:
    """Every table of the files as numpy arrays, drawn from :data:`SEED` (what
    :func:`generate` writes; the HDF5 tables without needing h5py)."""
    rng = np.random.default_rng(SEED)
    data, labels = _flowers(rng)
    perm = rng.permutation(150)
    train, test = perm[:120], perm[120:]
    n, d = 442, 10
    X = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    y = (X @ w + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return {"flowers": data, "flowers_labels": labels, "flowers_X_train": data[train], "flowers_X_test": data[test],
            "flowers_y_train": labels[train], "flowers_y_test": labels[test], "sugar_x": X, "sugar_y": y}


def generate() -> None:
    """Write the sample data files (see the module docstring for the inventory)."""
    t = tables()
    np.savetxt(os.path.join(_DIR, "flowers.csv"), t["flowers"], delimiter=";", fmt="%.4f")
    np.savetxt(os.path.join(_DIR, "flowers_labels.csv"), t["flowers_labels"], fmt="%d")
    for name in ("flowers_X_train", "flowers_X_test"):
        np.savetxt(os.path.join(_DIR, f"{name}.csv"), t[name], delimiter=";", fmt="%.4f")
    for name in ("flowers_y_train", "flowers_y_test"):
        np.savetxt(os.path.join(_DIR, f"{name}.csv"), t[name], fmt="%d")
    try:
        import h5py

        with h5py.File(os.path.join(_DIR, "flowers.h5"), "w") as f:
            f.create_dataset("data", data=t["flowers"])
        with h5py.File(os.path.join(_DIR, "sugar.h5"), "w") as f:
            f.create_dataset("x", data=t["sugar_x"])
            f.create_dataset("y", data=t["sugar_y"])
    except ImportError:
        pass
    try:
        import netCDF4 as nc

        with nc.Dataset(os.path.join(_DIR, "flowers.nc"), "w") as f:
            f.createDimension("samples", t["flowers"].shape[0])
            f.createDimension("features", t["flowers"].shape[1])
            var = f.createVariable("data", np.float32, ("samples", "features"))
            var[...] = t["flowers"]
    except ImportError:
        pass
