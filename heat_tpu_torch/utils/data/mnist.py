"""MNIST dataset helper (counterpart of heat_tpu/utils/data/mnist.py; the reference's
heat/utils/data/mnist.py, a torchvision MNIST subclass). Gated on torchvision, as both
are; the loaded images become one split-0 DNDarray."""

from __future__ import annotations

import numpy as np

from ... import core as _core
from ...core import random as _random
from ...core.indexing import _take_rows

__all__ = ["MNISTDataset"]


class MNISTDataset:
    """Distributed MNIST (reference ``mnist.py:16``): images and labels as split-0
    DNDarrays on the default device. Needs torchvision and a local MNIST copy."""

    def __init__(self, root: str, train: bool = True, transform=None, ishuffle: bool = False, test_set: bool = False):
        try:
            from torchvision import datasets as tv_datasets
        except ImportError as e:
            raise RuntimeError("MNISTDataset requires torchvision") from e
        base = tv_datasets.MNIST(root=root, train=train, download=False)
        images = np.asarray(base.data, dtype=np.float32) / 255.0
        labels = np.asarray(base.targets, dtype=np.int64)
        self.htdata = _core.array(images, split=0)
        self.httargets = _core.array(labels, split=0)
        self.transform = transform
        self.ishuffle = ishuffle
        self.test_set = test_set

    def __len__(self) -> int:
        return self.htdata.gshape[0]

    def __getitem__(self, index):
        img = self.htdata[index]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.httargets[index]

    def _shuffle_together(self) -> None:
        # one permutation for images and labels, split kept (reference mnist.py:113)
        n = int(self.htdata.gshape[0])
        perm = _random._shuffled(_random._next_key(n), n, self.htdata.comm, self.htdata.larray.device)
        self.htdata = _take_rows(self.htdata, perm)
        self.httargets = _take_rows(self.httargets, perm)

    def Shuffle(self) -> None:
        """Shuffle images and labels together across the ranks unless this is a test set
        (reference ``mnist.py:113``)."""
        if not self.test_set:
            self._shuffle_together()

    def Ishuffle(self) -> None:
        """The reference's non-blocking shuffle (``mnist.py:121``): the same operation."""
        if not self.test_set:
            self._shuffle_together()
