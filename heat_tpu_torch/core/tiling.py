"""Tile decompositions (counterpart of heat_tpu/core/tiling.py): metadata over lshape maps.

``SplitTiles`` cuts every axis at the chunk boundaries of the ceil-division rule;
``SquareDiagTiles`` is the grid with square diagonal tiles behind the tiled QR, whose row
count sets the port's TSQR panels (:mod:`.linalg.qr`). The grids, tile maps and
indices equal heat_tpu's for the same shape, split and rank count. As in heat_tpu, the
item accessors read and write tiles of the global value (here a gather; setting a tile
keeps this rank's chunk of the result).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .dndarray import DNDarray

__all__ = ["SplitTiles", "SquareDiagTiles"]


def _set_global(arr: DNDarray, slices, value) -> None:
    """Write ``value`` into the tile ``slices`` of ``arr``'s global value and keep this
    rank's chunk."""
    full = arr._global().clone()
    full[slices] = torch.as_tensor(value, dtype=full.dtype, device=full.device)
    if arr.split is not None:
        _, _, chunk = arr.comm.chunk(arr.gshape, arr.split)
        full = full[chunk].contiguous()
    arr.larray = full


class SplitTiles:
    """Tiles by the ceil-division chunking along every axis (heat_tpu tiling.py:23): axis
    ``d`` is cut at the chunk boundaries the communicator gives axis ``d``, so the grid has
    ``comm.size`` slots a dimension."""

    def __init__(self, arr: DNDarray):
        self.__arr = arr
        comm = arr.comm
        dims = np.zeros((arr.ndim, comm.size), dtype=np.int64)
        for d in range(arr.ndim):
            dims[d] = comm.lshape_map(arr.gshape, d)[:, d]
        self.__tile_dims = dims
        self.__tile_ends = dims.cumsum(axis=1)
        self.__tile_locations = np.arange(comm.size, dtype=np.int64)

    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def tile_dimensions(self) -> np.ndarray:
        return self.__tile_dims

    @property
    def tile_ends_g(self) -> np.ndarray:
        return self.__tile_ends

    @property
    def tile_locations(self) -> np.ndarray:
        """Owning rank of each tile along the split axis."""
        return self.__tile_locations

    @property
    def lshape_map(self) -> np.ndarray:
        """(size, ndim) map of every rank's local shape."""
        return self.__arr.comm.lshape_map(self.__arr.gshape, self.__arr.split)

    @staticmethod
    def set_tile_locations(split: int, tile_dims: np.ndarray, arr: DNDarray) -> np.ndarray:
        """Owning rank of each tile: tile ``r`` along the split axis lives on rank ``r``;
        tiles along the other axes take the owner of their split tile."""
        size = arr.comm.size
        shape = tuple(int(np.count_nonzero(np.asarray(tile_dims)[d])) for d in range(len(tile_dims)))
        locs = np.zeros(shape, dtype=np.int64)
        if arr.split is not None:
            idx = [np.newaxis] * len(shape)
            idx[split] = slice(None)
            locs += np.arange(shape[split], dtype=np.int64)[tuple(idx)] % size
        return locs

    def get_tile_size(self, key) -> Tuple[int, ...]:
        """Extent of the tile(s) selected by ``key``."""
        return tuple(
            int((s.stop if s.stop is not None else self.__arr.gshape[d]) - (s.start or 0))
            for d, s in enumerate(self._tile_slices(key))
        )

    def _tile_slices(self, key) -> Tuple[slice, ...]:
        if not isinstance(key, tuple):
            key = (key,)
        slices = []
        for d in range(self.__arr.ndim):
            if d < len(key) and key[d] is not None and key[d] is not Ellipsis:
                t = int(key[d])
                start = 0 if t == 0 else int(self.__tile_ends[d, t - 1])
                slices.append(slice(start, int(self.__tile_ends[d, t])))
            else:
                slices.append(slice(None))
        return tuple(slices)

    def __getitem__(self, key) -> torch.Tensor:
        """The requested tile of the global value."""
        return self.__arr._global()[self._tile_slices(key)]

    def __setitem__(self, key, value) -> None:
        _set_global(self.__arr, self._tile_slices(key), value)


class SquareDiagTiles:
    """Tile grid with square tiles on the diagonal (heat_tpu tiling.py:115): each rank's
    chunk along the split axis is cut into ``tiles_per_proc`` tiles, and the cuts of the
    other axis mirror them, so diagonal tiles are square."""

    def __init__(self, arr: DNDarray, tiles_per_proc: int = 2):
        if not isinstance(arr, DNDarray):
            raise TypeError(f"arr must be a DNDarray, got {type(arr)}")
        if arr.ndim != 2:
            raise ValueError("SquareDiagTiles requires a 2-D DNDarray")
        if tiles_per_proc < 1:
            raise ValueError("tiles_per_proc must be >= 1")
        self.__arr = arr
        comm = arr.comm
        m, n = arr.gshape

        def _primary_cuts(extent_axis: int) -> List[int]:
            # each rank's chunk along the split axis, cut into tiles_per_proc pieces
            cuts: List[int] = []
            for r in range(comm.size if arr.split is not None else 1):
                _, lshape, _ = comm.chunk(arr.gshape, arr.split if arr.split is not None else extent_axis, rank=r)
                extent = lshape[extent_axis]
                base, rem = divmod(extent, tiles_per_proc)
                cuts.extend(base + (1 if t < rem else 0) for t in range(tiles_per_proc))
            cuts = [c for c in cuts if c > 0]
            return cuts or [arr.gshape[extent_axis]]

        def _mirror_cuts(primary: List[int], total: int) -> List[int]:
            # the primary cuts up to ``total``, the remainder appended
            cuts: List[int] = []
            acc = 0
            for c in primary:
                if acc >= total:
                    break
                take = min(c, total - acc)
                cuts.append(take)
                acc += take
            if acc < total:
                cuts.append(total - acc)
            return cuts

        if arr.split == 1:
            col_cuts = _primary_cuts(1)
            row_cuts = _mirror_cuts(col_cuts, m)
        else:
            row_cuts = _primary_cuts(0)
            col_cuts = _mirror_cuts(row_cuts, n)

        self.__tile_rows_per_process = [tiles_per_proc] * comm.size
        self.__row_inds = [int(v) for v in np.cumsum([0] + row_cuts)[:-1]]
        self.__col_inds = [int(v) for v in np.cumsum([0] + col_cuts)[:-1]]
        self.__row_cuts = row_cuts
        self.__col_cuts = col_cuts
        tmap = np.zeros((len(row_cuts), len(col_cuts)), dtype=np.int64)
        if arr.split == 0 or arr.split is None:
            for i in range(len(row_cuts)):
                tmap[i, :] = min(i // tiles_per_proc, comm.size - 1)
        else:
            for j in range(len(col_cuts)):
                tmap[:, j] = min(j // tiles_per_proc, comm.size - 1)
        self.__tile_map = tmap

    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def tile_columns(self) -> int:
        return len(self.__col_cuts)

    @property
    def tile_rows(self) -> int:
        return len(self.__row_cuts)

    @property
    def tile_map(self) -> np.ndarray:
        """(tile_rows, tile_columns) grid of owning ranks."""
        return self.__tile_map

    @property
    def row_indices(self) -> List[int]:
        """Global start row of each tile row."""
        return self.__row_inds

    @property
    def col_indices(self) -> List[int]:
        """Global start column of each tile column."""
        return self.__col_inds

    @property
    def tile_rows_per_process(self) -> List[int]:
        return self.__tile_rows_per_process

    @property
    def tile_columns_per_process(self) -> List[int]:
        """Tile columns on each rank: all of them under a row split, the rank's own under
        a column split."""
        size = self.__arr.comm.size
        if self.__arr.split == 1:
            owned = [0] * size
            for j in range(self.tile_columns):
                owned[int(self.__tile_map[0, j])] += 1
            return owned
        return [self.tile_columns] * size

    @property
    def lshape_map(self) -> np.ndarray:
        return self.__arr.comm.lshape_map(self.__arr.gshape, self.__arr.split)

    @property
    def last_diagonal_process(self) -> int:
        """Rank owning the last tile on the diagonal."""
        k = min(self.tile_rows, self.tile_columns) - 1
        return int(self.__tile_map[k, k])

    def _normalize_key(self, key) -> Tuple:
        if not isinstance(key, tuple):
            key = (key, slice(None))
        if len(key) == 1:
            key = (key[0], slice(None))
        return key

    def _span(self, part, inds: List[int], cuts: List[int]) -> Tuple[int, int]:
        """Global [start, stop) covered by an int or a slice of tile indices."""
        if isinstance(part, slice):
            lo, hi, step = part.indices(len(cuts))
            if step != 1 or hi <= lo:
                raise ValueError(f"tile slices must be contiguous, got {part}")
        else:
            lo, hi = int(part), int(part) + 1
        return inds[lo], inds[hi - 1] + cuts[hi - 1]

    def get_start_stop(self, key) -> Tuple[int, int, int, int]:
        """(row start, row stop, col start, col stop) of the tile(s) at ``key``."""
        rs, cs = self._slices(key)
        return rs.start, rs.stop, cs.start, cs.stop

    def local_to_global(self, key, rank: int) -> Tuple:
        """A rank-local tile key as global tile indices: the split axis's index is offset
        by the tiles of lower ranks; slices pass through."""
        i, j = self._normalize_key(key)
        if self.__arr.split == 1:
            off = int(np.sum(self.tile_columns_per_process[:rank]))
            return i, (j if isinstance(j, slice) else j + off)
        off = int(np.sum(self.__tile_rows_per_process[:rank]))
        return (i if isinstance(i, slice) else i + off), j

    def get_tile_size(self, key) -> Tuple[int, int]:
        rs, cs = self._slices(key)
        return rs.stop - rs.start, cs.stop - cs.start

    def _slices(self, key) -> Tuple[slice, slice]:
        i, j = self._normalize_key(key)
        r0, r1 = self._span(i, self.__row_inds, self.__row_cuts)
        c0, c1 = self._span(j, self.__col_inds, self.__col_cuts)
        return slice(r0, r1), slice(c0, c1)

    def __getitem__(self, key) -> torch.Tensor:
        """The (i, j) tile of the global value."""
        return self.__arr._global()[self._slices(key)]

    def __setitem__(self, key, value) -> None:
        _set_global(self.__arr, self._slices(key), value)

    local_get = __getitem__
    local_set = __setitem__

    def match_tiles(self, tiles_to_match: "SquareDiagTiles") -> None:
        """Align tilings of a Q/R pair: chunkings always agree here, so this only checks
        that both live on communicators of one size."""
        if self.__arr.comm.size != tiles_to_match.arr.comm.size:
            raise ValueError("tilings live on different communicators")
