"""Filter helpers (reference: clickhouse_tpu/ops/filter_ops.py).

Filters stay masked (a predicate ANDs into the block's row mask), so a
query needs the count of selected rows, which K1 computes, and, where
only the selected rows may leave the device (a streamed collect), their
indices in row order: ``compact_rows`` (K14, csrc/compact_rows.cu), the
port of the reference's ``gather_compaction_indices`` (:26) and
``compact_arrays`` (:42).  K14 reads a ``RowMask``'s parts itself (the row
bound, K1's filter terms and the bool mask), so no bool array is built
for it.

K14 takes a tile of 65,536 rows a block (2,048 tiles a 2^27-row chunk):
sixteen steps of 4,096 rows, a run of 16 rows a thread in each, a
thread's sixteen 16-byte copies of the mask in flight at once (into
shared memory, so three blocks fit an SM); a decoupled look-back over
the tiles' counts in the order blocks start; a warp's kept rows of a step
stored as consecutive slots.  A call is one launch and no other device
operation: the kernel writes the count, and its look-back words live in
a scratch kept per device and stream, zeroed once, whose words count
only under the call's epoch (a tag new a call), so nothing clears them
between calls.  Bound: bytes (the mask read once, 4 bytes written a kept
row).  On an NVIDIA H100 80GB HBM3 at 700.00 W, at Q5c's 2^27-row chunk
(0.1 % kept; bound 0.0402 ms): 0.0854 ms, the first version (tiles of
4,096 rows) 0.30 ms, torch.nonzero 0.35 ms; K1's count of the same mask
(its read alone) 0.070 ms (chip_smoke.py --k14; PERF.md).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Tuple, Union

import torch

from . import _native
from .agg_ops import RowMask, _k1_term, masked_reduce

__all__ = ["count_mask", "compact_rows", "compact_rows_bytes"]


def count_mask(mask: Union[torch.Tensor, RowMask]) -> torch.Tensor:
    """Number of selected rows (0-d int64 tensor on the mask's device).  A
    RowMask hands its parts (row bound, terms, mask) to K1 as they are."""
    if isinstance(mask, RowMask):
        return mask.count()
    return masked_reduce("sum", None, mask.to(torch.bool))


def _rows_of(mask: Union[torch.Tensor, RowMask]) -> RowMask:
    if isinstance(mask, RowMask):
        return mask
    if mask.dim() != 1:
        raise ValueError("compact_rows: the mask must be 1-d")
    return RowMask.of(mask.to(torch.bool))


def compact_rows(mask: Union[torch.Tensor, RowMask]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (idx, count): idx an int32 (capacity,) tensor whose slot j <
    count holds the row of the j-th selected row, in row order (the slots
    from count on are unspecified), count a 0-d int64 tensor on the mask's
    device.  The selection is a bool mask's set rows, or a RowMask's rows
    (below its row bound, where its mask holds and every term passes)."""
    rows = _rows_of(mask)
    if len(rows.terms) > _native.K1_MAX_TERMS:
        raise ValueError(f"compact_rows: more than {_native.K1_MAX_TERMS} "
                         f"terms")
    if rows.capacity >= 1 << 31:
        raise ValueError("compact_rows: 2^31 rows or more")
    if rows.device.type == "cpu":
        return _compact_rows_plain(rows)
    if rows.device.type != "cuda":
        raise RuntimeError(f"compact_rows: no kernel for {rows.device}")
    return _compact_rows_cuda(rows)


def compact_rows_bytes(n_rows: int, kept: int) -> int:
    """Bytes K14 moves over a bool mask: a byte a row read once, 4 bytes a
    kept row written and the count."""
    return n_rows + 4 * kept + 8


def _compact_rows_plain(rows: RowMask) -> Tuple[torch.Tensor, torch.Tensor]:
    sel = rows.tensor()
    hit = torch.nonzero(sel).squeeze(1).to(torch.int32)
    idx = torch.zeros(rows.capacity, dtype=torch.int32, device=sel.device)
    idx[:hit.shape[0]] = hit
    return idx, torch.tensor(hit.shape[0], dtype=torch.int64,
                             device=sel.device)


# K14's look-back scratch of each (device, stream): [the words, the epoch
# of its last call].  Words of an older epoch read as unpublished, so the
# scratch is zeroed only when made and when the epochs wrap.
_SCRATCH: Dict[Tuple[int, int], List] = {}
_SCRATCH_LOCK = threading.Lock()
_EPOCHS = 1 << 30


def _scratch(lib, dev, stream: int) -> Tuple[torch.Tensor, int]:
    key = (dev.index, stream)
    with _SCRATCH_LOCK:
        entry = _SCRATCH.get(key)
        if entry is None:
            entry = _SCRATCH[key] = [torch.zeros(
                lib.chtt_compact_scratch_words(), dtype=torch.int64,
                device=dev), 0]
        entry[1] += 1
        if entry[1] == _EPOCHS:
            entry[0].zero_()
            entry[1] = 1
        return entry[0], entry[1]


def _compact_rows_cuda(rows: RowMask) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = rows.device
    cap = rows.capacity
    n = max(min(rows.n_rows, cap), 0)
    idx = torch.empty(cap, dtype=torch.int32, device=dev)
    if n == 0:                            # no row: no launch
        return idx, torch.zeros((), dtype=torch.int64, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)   # K14 writes it
    mask = rows.mask
    for c in [mask] + [c for t in rows.terms for c in (t.storage, t.validity)]:
        if c is None:
            continue
        if c.dim() != 1 or c.shape[0] != cap or c.device != idx.device \
                or not c.is_contiguous() \
                or c.data_ptr() % c.element_size():
            raise ValueError("compact_rows: the mask and the terms' columns "
                             "must be contiguous, aligned 1-d tensors of "
                             "the capacity on one device")
    if mask is not None and mask.dtype != torch.bool:
        raise ValueError("compact_rows: mask must be bool")
    lib = _native.library()
    tiles = -(-n // lib.chtt_compact_tile_rows())
    stream = _native.stream_ptr(dev)
    status, epoch = _scratch(lib, dev, stream)
    args = _native.K14Args(
        mask=None if mask is None else mask.data_ptr(), out=idx.data_ptr(),
        count=count.data_ptr(), status=status.data_ptr(), n=n, tiles=tiles,
        mask_vec=int(mask is not None and mask.data_ptr() % 16 == 0),
        n_terms=len(rows.terms), epoch=epoch)
    for i, t in enumerate(rows.terms):
        args.terms[i] = _k1_term(t, 0)
    rc = lib.chtt_compact_rows(ctypes.byref(args), stream)
    _native.check(rc, "compact_rows")
    _native.count_launch("compact_rows", n)
    return idx, count
