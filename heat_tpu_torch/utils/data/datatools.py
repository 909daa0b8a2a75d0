"""Data loading tools (counterpart of heat_tpu/utils/data/datatools.py; the reference's
heat/utils/data/datatools.py).

A :class:`Dataset` holds aligned DNDarrays whose leading axis is the sample axis; a
:class:`DataLoader` yields minibatches of them as DNDarrays (split kept), and between
epochs re-shuffles the samples across the ranks. The shuffle is heat_tpu's: one global
permutation from ``ht.random``'s stream (so the same permutation as heat_tpu's), each
rank fetching the rows of its chunk from the ranks that hold them
(``TorchCommunication.take``), where the reference exchanges sample blocks with an
Alltoall (``datatools.py:246``).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from ...core import random as _random
from ...core.dndarray import DNDarray
from ...core.indexing import _take_rows

__all__ = ["DataLoader", "Dataset", "dataset_shuffle", "dataset_ishuffle"]


class Dataset:
    """Dataset over one or more aligned DNDarrays (reference ``datatools.py:143``, which
    wraps the rank's local chunk; here the distributed arrays themselves)."""

    def __init__(self, array: DNDarray, *arrays: DNDarray, ishuffle: bool = False, test_set: bool = False):
        self.arrays: Tuple[DNDarray, ...] = (array,) + arrays
        n = self.arrays[0].gshape[0]
        for a in self.arrays[1:]:
            if a.gshape[0] != n:
                raise ValueError("all arrays must share the leading (sample) dimension")
        self.ishuffle = ishuffle
        self.test_set = test_set

    def __len__(self) -> int:
        return self.arrays[0].gshape[0]

    def __getitem__(self, index):
        items = tuple(a[index] for a in self.arrays)
        return items[0] if len(items) == 1 else items

    def shuffle(self) -> None:
        """A uniform global permutation of the samples (reference ``dataset_shuffle``)."""
        dataset_shuffle(self)

    def Shuffle(self) -> None:
        """Shuffle across the ranks unless this is a test set (reference
        ``datatools.py:229``)."""
        if not self.test_set:
            dataset_shuffle(self)

    def Ishuffle(self) -> None:
        """The reference's non-blocking shuffle (``datatools.py:237``): the same
        permutation; its collective is issued before the call returns."""
        if not self.test_set:
            dataset_ishuffle(self)


class DataLoader:
    """Minibatch iterator over a Dataset or a DNDarray (reference ``datatools.py:16``).

    Yields batches as DNDarrays, split kept. ``drop_last`` defaults to False, as torch's
    DataLoader. The samples are re-shuffled at the start of every epoch after the first,
    unless the dataset is a test set."""

    def __init__(
        self,
        dataset=None,
        batch_size: int = 1,
        num_workers: int = 0,
        collate_fn=None,
        pin_memory: bool = False,
        drop_last: bool = False,
        timeout: float = 0,
        worker_init_fn=None,
        lcl_dataset=None,
        use_ishuffle: bool = False,
    ):
        dataset = dataset if dataset is not None else lcl_dataset
        if isinstance(dataset, DNDarray):
            dataset = Dataset(dataset)
        elif hasattr(dataset, "htdata"):
            # MNISTDataset-style wrappers (reference utils/data/mnist.py)
            arrays = (dataset.htdata,) + ((dataset.httargets,) if hasattr(dataset, "httargets") else ())
            dataset = Dataset(*arrays, test_set=getattr(dataset, "test_set", False))
        if not isinstance(dataset, Dataset):
            raise TypeError(f"dataset must be a Dataset or DNDarray, got {type(dataset)}")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.use_ishuffle = use_ishuffle
        self._first_epoch = True

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        if not self._first_epoch and not self.dataset.test_set:
            self.dataset.shuffle()
        self._first_epoch = False
        n = len(self.dataset)
        for b in range(len(self)):
            lo = b * self.batch_size
            yield self.dataset[lo : min(lo + self.batch_size, n)]


def dataset_shuffle(dataset: Dataset, attrs: Optional[List] = None) -> None:
    """Shuffle the dataset's samples across the ranks in place (reference
    ``datatools.py:246``): one permutation of ``ht.random``'s stream, heat_tpu's
    ``randperm(n)``, applied to every array."""
    n = len(dataset)
    first = dataset.arrays[0]
    perm = _random._shuffled(_random._next_key(n), n, first.comm, first.larray.device)
    dataset.arrays = tuple(_take_rows(a, perm) for a in dataset.arrays)


def dataset_ishuffle(dataset: Dataset, attrs: Optional[List] = None) -> None:
    """The reference's non-blocking shuffle (``datatools.py:301``): the same operation."""
    dataset_shuffle(dataset, attrs)
