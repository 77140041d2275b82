"""Scratch that the kernels keep from call to call.

A call leaves behind what the next one must find, so nothing of the
ring's size is cleared per call. The fold and the one-shot keep:

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

The stats and histogram kernels (one launch each) keep:

* ``tickets``: int32, one per group of blocks and one for the final sum,
  then one count total per key, all 0 between calls (the blocks that
  take the last tickets put them back, and the last one reads and clears
  the totals).
* ``rows``: f32 block and group rows of partial sums, written before
  they are read in every call.

Their row forms (a ``[G, N]`` view) use the same two only when a row is
cut into parts: ``tickets`` holds a ticket per row (and the histogram's
``G·B`` count totals after them), 0 between calls; ``rows`` the stats'
part sums.

Past the cells shared memory holds, the fold and the one-shot take their
parted form (:func:`parted_plan`; ``csrc/parted_claim.cuh``). Its
look-back words are in ``status`` and its lists in ``lists`` /
``list_n``, over the claim's grid; it also keeps:

* ``part_zeroed``: int32 digit and part totals and tickets, then the
  one-shot's ingested items per stratum, all 0 between calls (the scan
  that reads the totals clears them, the claim its tickets, the
  one-shot's last launch its counts).
* ``part_meta``, ``part_items``, ``base`` and ``cap``: written before
  they are read in every call.

All of it grows with the items and the cells, never with their product.

A one-shot call batched over W shards keeps W of each of its arrays
(winner table, look-back words, counters, lists, new counts and the
parted form's), shard after shard, each the size of its unbatched call's
(``Shards`` in ``csrc/fold_device.cuh``); a fold call batched over W·K
folds keeps W·K of each of its own, fold after fold. What is 0 or -1
between calls stays so in every shard's and fold's.

The parted forms of the stats and the histogram (past the keys shared
memory holds; :meth:`Workspace.parted_reduce`, ``csrc/parted_reduce.cuh``)
keep the parted form's ``part_zeroed``, ``part_meta`` and ``part_items``
(entries of 8 bytes, half the fold's), the partition's look-back words
in ``status`` and its tile counter in ``counters`` (0 between calls), and
a row of sums and counts per reduce tile in ``rows`` (written before it
is read). They grow with the items and the keys, never with their
product.

So the table is filled once, when it is made or grown. There is one
workspace per (device, stream): calls on one stream run in the order they
were issued, so no two calls use a workspace at once, and a call on
another stream gets its own. A launch that reports an error may have
stopped between the claim and the write, or with a ticket taken, so the
wrapper drops the workspace (:func:`drop`) and the next call makes a
fresh one.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

_I32 = torch.int32

#: Items of one tile (``kTile`` in ``csrc/fold_device.cuh``).
TILE_ITEMS = 2048
#: The most keys of one look-back of the parted form: a block's shared
#: memory holds the small form's per-warp running counts of this many
#: (``claim_smem_words``), and a pass scans digits of at most 10 bits.
LOOKBACK_KEYS = 1024
#: Partition passes at most (``kPartMaxPasses``): 10 low bits and three
#: passes of 7 cover every int32 cell index.
MAX_PASSES = 3
#: int32 words of a partition entry: the fold's ``(item, cell, uniforms)``
#: and the stats' and histogram's ``(key, value)`` (``Entry`` in
#: ``csrc/parted_claim.cuh``).
FOLD_ENTRY_WORDS, REDUCE_ENTRY_WORDS = 4, 2


class PartedPlan(NamedTuple):
    """How the parted form splits ``cells`` cells for ``m`` items.

    A cell ``c`` is ``(c >> lo_bits, c & (2**lo_bits - 1))``: its part
    and its low bits. The live items are partitioned stably by part in
    ``passes`` LSD passes over the part id, pass ``d`` by the digit
    ``(part >> shifts[d]) % 2**bits[d]`` of ``keys[d]`` values; the claim
    then ranks each part's tiles over the low bits alone. The word counts
    are the scratch the call needs beside its lists (a tile's entries and
    counts for each of the ``claim_grid`` tiles)."""
    lo_bits: int
    parts: int
    passes: int
    bits: tuple
    shifts: tuple
    keys: tuple
    tiles: int             # item tiles, blocks of every launch but the claim
    claim_grid: int        # the claim's and the write launches' blocks
    status_words: int      # int64 look-back words
    zeroed_words: int      # int32 totals and tickets, 0 between calls
    meta_words: int        # int32 words of the claim's map, offsets, firsts
    item_words: int        # int32 words of the partition's output

    def ints(self) -> tuple:
        """The plan as the kernels take it (``PartedPlan`` in
        ``csrc/parted_claim.cuh``)."""
        pad = (0,) * (MAX_PASSES - self.passes)
        return (self.lo_bits, self.parts, self.passes, self.tiles,
                self.claim_grid, *self.bits, *pad, *self.shifts, *pad,
                *self.keys, *pad)


def parted_plan(cells: int, m: int,
                lo_keys: int = LOOKBACK_KEYS) -> PartedPlan:
    """The parted form's plan for ``cells`` cells (or keys) and ``m``
    items, with at most ``lo_keys`` low keys, a pure function of the
    three.

    The cell's bits are split into low bits and a part id as evenly as
    the look-back's LOOKBACK_KEYS allow: up to 2**20 cells half and half
    (7 + 7 bits at 15,360 cells, 9 + 9 at 262,144) in one partition pass;
    past that 10 low bits and one more pass for each further 10 bits or
    fewer of the part id. ``lo_keys`` (a power of two up to LOOKBACK_KEYS:
    the stats' parted form passes its small form's 512 strata) caps the
    low bits. Every look-back is over at most LOOKBACK_KEYS keys; the
    scratch grows with ``m + cells``, never with tiles x cells.
    """
    if cells < 2 or cells >= 2**31:
        raise ValueError(f"parted_plan: {cells} cells is not in [2, 2**31)")
    if m < 0 or m >= 2**31:
        raise ValueError(f"parted_plan: {m} items is not in [0, 2**31)")
    if lo_keys < 2 or lo_keys > LOOKBACK_KEYS or lo_keys & (lo_keys - 1):
        raise ValueError(f"parted_plan: {lo_keys} low keys is not a power "
                         f"of two in [2, {LOOKBACK_KEYS}]")
    nbits = (cells - 1).bit_length()
    lo_bits = min((nbits + 1) // 2 if nbits <= 20 else 10,
                  lo_keys.bit_length() - 1)
    parts = -(-cells >> lo_bits)
    hi_bits = max((parts - 1).bit_length(), 1)
    passes = -(-hi_bits // 10)
    bits = tuple(hi_bits // passes + (d < hi_bits % passes)
                 for d in range(passes))
    shifts = tuple(sum(bits[:d]) for d in range(passes))
    keys = tuple(2**bits[d] if d + 1 < passes else
                 ((parts - 1) >> shifts[d]) + 1 for d in range(passes))
    tiles = max(-(-m // TILE_ITEMS), 1)
    claim_grid = tiles + min(parts, m)
    nk = sum(keys)
    return PartedPlan(
        lo_bits=lo_bits, parts=parts, passes=passes, bits=bits,
        shifts=shifts, keys=keys, tiles=tiles, claim_grid=claim_grid,
        status_words=2**lo_bits * claim_grid + tiles * nk,
        zeroed_words=nk + (parts if passes > 1 else 0) + 1 + parts,
        meta_words=4 * claim_grid + nk + parts + 1,
        item_words=FOLD_ENTRY_WORDS * m * (1 if passes == 1 else 2))


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
        self.tickets = self._make(0, 0)
        self.rows = self._make(0, dtype=torch.float32)
        self.part_zeroed = self._make(0, 0)
        self.part_meta = self._make(0)
        self.part_items = self._make(0)
        self.base = self._make(0)
        self.cap = self._make(0)

    def _make(self, n: int, fill=None, dtype=_I32) -> torch.Tensor:
        if fill is None:
            return torch.empty(max(n, 1), dtype=dtype, device=self.device)
        return torch.full((max(n, 1),), fill, dtype=dtype,
                          device=self.device)

    def reserve(self, *, table: int, tiles: int, cells: int,
                tile_items: int, tile_lists: int, aux: int = 0,
                counters: int = 3) -> "Workspace":
        """Grow to hold a ring of ``table`` cells, ``tiles`` tiles of
        ``tile_items`` items and ``tile_lists`` lists over ``cells``
        cells, ``aux`` words and ``counters`` counter words."""
        if self.winner.numel() < table:
            self.winner = self._make(table, -1)
        if self.counters.numel() < counters:
            self.counters = self._make(counters, 0)
        if self.status.numel() < tiles * cells:
            self.status = self._make(tiles * cells, 0, torch.int64)
        if self.lists.numel() < 2 * tiles * tile_items:
            self.lists = self._make(2 * tiles * tile_items)
        if self.list_n.numel() < tiles * tile_lists:
            self.list_n = self._make(tiles * tile_lists)
        if self.aux.numel() < aux:
            self.aux = self._make(aux)
        return self

    def parted(self, plan: PartedPlan, *, cells: int = 0, strata: int = 0,
               shards: int = 1):
        """Grow the parted form's own scratch for ``plan`` (and the
        one-shot's: ``cells`` words of ``base`` and ``cap``, ``strata``
        zeroed words of the chunk's ingested items after the plan's), for
        each of ``shards`` shards; the plan's ints and the host array of
        shard 0's scratch pointers, as the kernels take them
        (``PartedPlan``, ``PartedSlot`` in ``csrc/parted_claim.cuh``)."""
        meta = -(-plan.meta_words // 4) * 4    # a shard's on 16 bytes
        grow = [("part_zeroed", shards * (plan.zeroed_words + strata), 0),
                ("part_meta", shards * meta, None),
                ("part_items", shards * plan.item_words, None),
                ("base", shards * cells, None), ("cap", shards * cells, None)]
        for name, n, fill in grow:
            if getattr(self, name).numel() < n:
                setattr(self, name, self._make(n, fill))
        items = self.part_items.data_ptr()
        second = items + 4 * (plan.item_words // 2) if plan.passes > 1 else 0
        ptrs = (self.part_zeroed.data_ptr(), self.part_meta.data_ptr(),
                items, second or None, self.base.data_ptr(),
                self.cap.data_ptr())
        ints = plan.ints()
        return ((ctypes.c_int * len(ints))(*ints),
                (ctypes.c_void_p * len(ptrs))(*ptrs))

    def reserve_rows(self, *, words: int, tickets: int) -> "Workspace":
        """Grow to hold ``words`` f32 words of partial-sum rows and
        ``tickets`` zeroed words (new ones are 0)."""
        if self.rows.numel() < words:
            self.rows = self._make(words, dtype=torch.float32)
        if self.tickets.numel() < tickets:
            self.tickets = self._make(tickets, 0)
        return self

    def parted_reduce(self, plan: PartedPlan, m: int, nf: int):
        """Grow the scratch of the stats' (``nf = 2``) or the histogram's
        (``nf = 1``) parted form for ``plan`` and ``m`` items: the parted
        form's zeroed words, map and two buffers of ``(key, value)``
        entries, the partition's look-back words (``status``, 0 between
        calls), its tile counter (``counters[0]``) and a row of ``nf``
        sums and the counts over the part's low keys per reduce tile
        (``rows``); the plan's ints and the host array of pointers, as
        the kernels take them (``ReduceSlot`` in
        ``csrc/parted_reduce.cuh``)."""
        per = REDUCE_ENTRY_WORDS * m              # one buffer's words
        bufs = 1 if plan.passes == 1 else 2
        grow = [("part_zeroed", plan.zeroed_words, 0, _I32),
                ("part_meta", plan.meta_words, None, _I32),
                ("part_items", bufs * per, None, _I32),
                ("status", plan.tiles * sum(plan.keys), 0, torch.int64),
                ("rows", plan.claim_grid * (nf + 1) << plan.lo_bits, None,
                 torch.float32)]
        for name, n, fill, dtype in grow:
            if getattr(self, name).numel() < n:
                setattr(self, name, self._make(n, fill, dtype))
        items = self.part_items.data_ptr()
        ptrs = (self.part_zeroed.data_ptr(), self.part_meta.data_ptr(),
                items, items + 4 * per if bufs == 2 else None, None, None,
                self.status.data_ptr(), self.counters.data_ptr(),
                self.rows.data_ptr())
        ints = plan.ints()
        return ((ctypes.c_int * len(ints))(*ints),
                (ctypes.c_void_p * len(ptrs))(*ptrs))


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
             table: int, aux: int = 0, plan: PartedPlan = None,
             shards: int = 1) -> Workspace:
    """The workspace of ``(device, stream)``, grown for a call of ``m``
    items over ``cells`` cells of a ring of ``table`` cells: the small
    form's, or with ``plan`` the parted form's; ``shards`` of each for a
    call batched over shards."""
    n = tiles(lib, m)
    if plan is not None:     # lists over the claim's grid, its words
        n, cells = plan.claim_grid, -(-plan.status_words // plan.claim_grid)
    return get(device, stream).reserve(
        table=shards * table, tiles=shards * n, cells=cells,
        tile_items=lib.sa_fold_tile_items(),
        tile_lists=lib.sa_fold_tile_lists(), aux=shards * aux,
        counters=3 * shards)


def for_reduce(lib, device: torch.device, stream: int, *, words: int,
               keys: int) -> Workspace:
    """The workspace of ``(device, stream)``, grown for a stats or
    histogram call over ``keys`` keys whose block rows take ``words``
    words."""
    return get(device, stream).reserve_rows(
        words=words, tickets=lib.sa_reduce_zeroed(keys))


def drop(device: torch.device, stream: int) -> None:
    """Forget the workspace, after a launch that may have left it dirty."""
    _SPACES.pop(_key(device, stream), None)
