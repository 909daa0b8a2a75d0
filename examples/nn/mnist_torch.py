"""The MNIST convolutional classifier on ``heat_tpu_torch.nn``, trained data-parallel.

The PyTorch port's counterpart of ``mnist.py``: the same ``Net`` (two 3×3 convolutions,
2×2 max-pool, channel dropout, two affine layers, log-softmax) from the port's module zoo,
whose modules start in eval mode and take heat_tpu's PRNG keys, so ``net.train()(x,
key=k)`` drops the same channels as heat_tpu's ``net.apply(params, x, key=k, train=True)``.
The batch is a split=0 DNDarray; ``DataParallel`` and ``DataParallelOptimizer("sgd")``
train the network on synthetic 28×28 classes (a template per class plus noise).

Run:  python examples/nn/mnist_torch.py [--device cpu] [--steps N]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import heat_tpu_torch as ht  # noqa: E402
import heat_tpu_torch.nn.functional as F  # noqa: E402
from heat_tpu_torch.core.devices import sanitize_device  # noqa: E402
from heat_tpu_torch.core.random import _split  # noqa: E402


class Net(ht.nn.Module):
    """heat_tpu's MNIST ``Net`` (examples/nn/mnist.py:28-50), under its parameter names."""

    def __init__(self, device=None):
        super().__init__()
        self.conv1 = ht.nn.Conv2d(1, 32, 3, 1, device=device)
        self.conv2 = ht.nn.Conv2d(32, 64, 3, 1, device=device)
        self.dropout1 = ht.nn.Dropout2d(0.25)
        self.dropout2 = ht.nn.Dropout2d(0.5)
        self.fc1 = ht.nn.Linear(9216, 128, device=device)
        self.fc2 = ht.nn.Linear(128, 10, device=device)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = self.dropout1(F.max_pool2d(x, 2))
        x = F.relu(self.fc1(F.flatten(x, 1)))
        x = self.fc2(self.dropout2(x))
        return F.log_softmax(x, dim=1)


def synthetic(n: int, seed: int = 0):
    """(x (n, 1, 28, 28) f32, y (n,) int64): a fixed template per class plus noise."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n)
    templates = rng.normal(0, 1.0, (10, 1, 28, 28)).astype(np.float32)
    return templates[y] + rng.normal(0, 0.8, (n, 1, 28, 28)).astype(np.float32), y.astype(np.int64)


def main(steps: int = 30, device=None) -> float:
    dev = sanitize_device(device).torch_device
    torch.manual_seed(0)
    net = Net(device=dev).train()
    opt = ht.optim.DataParallelOptimizer("sgd", lr=0.05)
    ht.nn.DataParallel(net, optimizer=opt)
    x, y = synthetic(2048)
    key = (0, 1)
    loss = None
    for i in range(steps):
        rows = slice((64 * i) % 2048, (64 * i) % 2048 + 64)
        batch = ht.array(x[rows], split=0, device=device), ht.array(y[rows], split=0, device=device)
        key = _split(key, 2)[0]
        loss = opt.step(lambda m, xb, yb, k=key: F.nll_loss(m(xb, key=k), yb), *batch)
    return float(loss)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None)
    parser.add_argument("--steps", type=int, default=30)
    args = parser.parse_args()
    print(f"final loss {main(args.steps, args.device):.4f}")
