"""Scratch that the fold and one-shot kernels keep from call to call.

A call leaves behind what the next one must find, so nothing of the
ring's size is cleared per call:

* ``winner``: int32, one word per ring cell, all -1 between calls. The
  claim pass raises the cells that accepted items reach with
  ``atomicMax``; the write pass has each raised cell's one winner copy
  its payload and put the word back to -1.
* ``status``: int64 look-back words, one per (tile, cell), all 0 between
  calls (the write pass zeroes the rows it used).
* ``counters``: int32 ``[tile counter, two frontier maxima]``, 0
  between calls (the frontier words are the one-shot's).
* ``lists``, ``list_n`` and ``aux`` are written before they are read in
  every call and hold no state.

So the table is filled once, when it is made or grown. There is one
workspace per (device, stream): calls on one stream run in the order they
were issued, so no two calls use a workspace at once, and a call on
another stream gets its own. A launch that reports an error may have
stopped between the claim and the write, so the wrapper drops the
workspace (:func:`drop`) and the next call makes a fresh one.
"""
from __future__ import annotations

import torch

_I32 = torch.int32


class Workspace:
    """The scratch tensors of one (device, stream); each grows on demand
    and is never shrunk."""

    def __init__(self, device: torch.device):
        self.device = device
        self.winner = self._make(0, -1)
        self.status = self._make(0, 0, torch.int64)
        self.counters = self._make(3, 0)
        self.lists = self._make(0)
        self.list_n = self._make(0)
        self.aux = self._make(0)

    def _make(self, n: int, fill=None, dtype=_I32) -> torch.Tensor:
        if fill is None:
            return torch.empty(max(n, 1), dtype=dtype, device=self.device)
        return torch.full((max(n, 1),), fill, dtype=dtype,
                          device=self.device)

    def reserve(self, *, table: int, tiles: int, cells: int,
                tile_items: int, tile_lists: int,
                aux: int = 0) -> "Workspace":
        """Grow to hold a ring of ``table`` cells, ``tiles`` tiles of
        ``tile_items`` items and ``tile_lists`` lists over ``cells``
        cells, and ``aux`` words."""
        if self.winner.numel() < table:
            self.winner = self._make(table, -1)
        if self.status.numel() < tiles * cells:
            self.status = self._make(tiles * cells, 0, torch.int64)
        if self.lists.numel() < 2 * tiles * tile_items:
            self.lists = self._make(2 * tiles * tile_items)
        if self.list_n.numel() < tiles * tile_lists:
            self.list_n = self._make(tiles * tile_lists)
        if self.aux.numel() < aux:
            self.aux = self._make(aux)
        return self


_SPACES: dict = {}


def _key(device: torch.device, stream: int) -> tuple:
    return (device.type, device.index, stream)


def get(device: torch.device, stream: int) -> Workspace:
    """The workspace of ``device`` and the stream with handle ``stream``."""
    key = _key(device, stream)
    if key not in _SPACES:
        _SPACES[key] = Workspace(device)
    return _SPACES[key]


def tiles(lib, m: int) -> int:
    """Tiles (blocks of each launch) of a call of ``m`` items."""
    return max(-(-m // lib.sa_fold_tile_items()), 1)


def for_call(lib, device: torch.device, stream: int, *, m: int, cells: int,
             table: int, aux: int = 0) -> Workspace:
    """The workspace of ``(device, stream)``, grown for a call of ``m``
    items over ``cells`` cells of a ring of ``table`` cells."""
    return get(device, stream).reserve(
        table=table, tiles=tiles(lib, m), cells=cells,
        tile_items=lib.sa_fold_tile_items(),
        tile_lists=lib.sa_fold_tile_lists(), aux=aux)


def drop(device: torch.device, stream: int) -> None:
    """Forget the workspace, after a launch that may have left it dirty."""
    _SPACES.pop(_key(device, stream), None)
