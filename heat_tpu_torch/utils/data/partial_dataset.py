"""Out-of-core HDF5 streaming (counterpart of heat_tpu/utils/data/partial_dataset.py; the
reference's heat/utils/data/partial_dataset.py).

``PartialH5Dataset`` iterates an HDF5 dataset too large for memory in windows: a reader
thread prefetches file windows into a bounded queue while the consumer iterates them as
tensors on the device, overlapping host I/O with the device's work. Needs h5py
(:func:`heat_tpu_torch.io.supports_hdf5`), imported where a file is opened.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional

import numpy as np
import torch

from ...core import io as _io
from ...core.communication import get_comm
from ...core.devices import cpu, get_device

__all__ = ["PartialH5Dataset", "PartialH5DataLoaderIter"]


class PartialH5Dataset:
    """Iterate an HDF5 dataset in windows (reference ``partial_dataset.py:32``): the first
    window holds ``initial_load`` samples, the next ones ``load_length``; with
    ``available_memory`` (bytes) both are cut so one window fits it. A validation set is
    read in one window. Windows land on the default device (``use_gpu=False``: the
    CPU)."""

    def __init__(
        self,
        file: str,
        comm=None,
        dataset_names: str = "data",
        available_memory: Optional[int] = None,
        transforms: Optional[List] = None,
        use_gpu: bool = True,
        validate_set: bool = False,
        initial_load: int = 7000,
        load_length: int = 1000,
    ):
        if not _io.supports_hdf5():
            raise RuntimeError("PartialH5Dataset requires h5py")
        import h5py

        self.file = file
        self.comm = comm if comm is not None else get_comm()
        self.dataset_names = [dataset_names] if isinstance(dataset_names, str) else list(dataset_names)
        self.transforms = transforms
        self.load_length = int(load_length)
        self.initial_load = int(initial_load)
        self.use_gpu = use_gpu
        self.device = get_device() if use_gpu else cpu
        self.validate_set = validate_set
        with h5py.File(file, "r") as f:
            self.total_size = f[self.dataset_names[0]].shape[0]
            if available_memory is not None:
                # windows sized so that one resident window fits the budget (:66-83)
                per_sample = int(sum(
                    np.dtype(f[name].dtype).itemsize * int(np.prod(f[name].shape[1:], dtype=np.int64))
                    for name in self.dataset_names
                ))
                fit = max(1, int(available_memory) // max(1, per_sample))
                self.load_length = min(self.load_length, fit)
                self.initial_load = min(self.initial_load, fit)
        if self.validate_set:
            # read once in full, no windowing (reference :120-131)
            self.initial_load = self.total_size
            self.load_length = self.total_size

    def __len__(self) -> int:
        return self.total_size

    def Shuffle(self):
        """Not implemented for partial datasets, as in the reference
        (``partial_dataset.py:157``: windows stream in file order)."""
        return NotImplementedError

    def Ishuffle(self):
        """Not implemented for partial datasets (reference ``partial_dataset.py:166``)."""
        return NotImplementedError

    def thread_replace_converted_batches(self, window: dict, used_indices: List[int], next_start: int) -> int:
        """Refill the consumed rows ``used_indices`` of a resident ``window`` from the next
        file range (reference ``partial_dataset.py:188``), wrapping at the end of the file.
        Returns the next unread file offset."""
        import h5py

        n = len(used_indices)
        if n == 0:
            return next_start
        with h5py.File(self.file, "r") as f:
            fresh = {}
            for name in self.dataset_names:
                head = np.asarray(f[name][next_start : min(next_start + n, self.total_size)])
                if len(head) < n:  # wrap: the tail rows, then from 0
                    head = np.concatenate([head, np.asarray(f[name][: n - len(head)])])
                fresh[name] = head
        for name in self.dataset_names:
            window[name][np.asarray(used_indices[: len(fresh[name])])] = fresh[name]
        return (next_start + n) % self.total_size

    def thread_loader(self, out_queue: "queue.Queue", start: int, stop: int) -> None:
        """The background reader: puts one {name: window} dict a window, then None
        (reference ``:188``)."""
        import h5py

        with h5py.File(self.file, "r") as f:
            lo, width = start, self.initial_load
            while lo < stop:
                hi = min(lo + width, stop)
                out_queue.put({name: np.asarray(f[name][lo:hi]) for name in self.dataset_names})
                lo, width = hi, self.load_length
        out_queue.put(None)

    def __iter__(self) -> "PartialH5DataLoaderIter":
        return PartialH5DataLoaderIter(self)


class PartialH5DataLoaderIter:
    """Iterator over a :class:`PartialH5Dataset` with a prefetching reader thread
    (reference ``:224``): each window as a tensor on the dataset's device (a tuple of them
    for several dataset names), through the transforms."""

    def __init__(self, dataset: PartialH5Dataset):
        self._dataset = dataset
        self._queue: "queue.Queue" = queue.Queue(maxsize=4)
        self._thread = threading.Thread(
            target=dataset.thread_loader, args=(self._queue, 0, dataset.total_size), daemon=True
        )
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is None:
            raise StopIteration
        dev = self._dataset.device.torch_device
        chunks = {name: torch.from_numpy(np.ascontiguousarray(arr)).to(dev) for name, arr in item.items()}
        if self._dataset.transforms:
            for t in self._dataset.transforms:
                chunks = {k: t(v) for k, v in chunks.items()}
        names = self._dataset.dataset_names
        return chunks[names[0]] if len(names) == 1 else tuple(chunks[n] for n in names)
