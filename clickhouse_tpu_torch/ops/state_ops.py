"""Aggregate-state rows (K19, csrc/state_rows.cu).

An AggregateFunction column holds each row's state as a fixed-width byte
string: the state columns of the aggregate, each as its little-endian
bytes, one after another (the reference's pack_state_columns /
unpack_state_columns, clickhouse_tpu/exprs/aggregates.py:1004-1035).  On
the device such a column is a (rows, B) uint8 matrix.

``pack_state_rows`` turns state columns into that matrix (optionally into
the rows ``dst_rows`` of a given matrix: AggregatingMergeTree FINAL writes
each group's merged state at its kept row only); ``unpack_state_rows``
turns a matrix (optionally its rows ``src_rows``) back into the columns.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from . import _native

__all__ = ["pack_state_rows", "unpack_state_rows", "state_rows_bytes",
           "k19_plan", "K19_MAX_COLS", "K19_TILE_BYTES"]

K19_MAX_COLS = 16          # kMaxCols of csrc/state_rows.cu
K19_TILE_BYTES = 32768     # kTileBytes: a packed row is at most this wide
K19_WORDS = (16, 8, 4, 2, 1)   # the kernel's word widths

_ELEM = (torch.bool, torch.int8, torch.uint8, torch.int16, torch.int32,
         torch.int64, torch.float32, torch.float64)


def _row_bytes(t: torch.Tensor) -> int:
    return t.element_size() * (t.shape[1] if t.dim() == 2 else 1)


def state_rows_bytes(n: int, widths: Sequence[int],
                     index: bool = False) -> int:
    """Bytes K19 moves for n rows of state columns of `widths` bytes a row:
    each column once, the packed matrix once, and the row index."""
    return 2 * n * sum(widths) + (8 * n if index else 0)


def k19_plan(widths: Sequence[int], ptrs: Sequence[int]
             ) -> Tuple[int, List[Tuple[int, int]]]:
    """K19's word width for state columns of `widths` bytes a row and base
    addresses `ptrs` (the packed matrix's and each column's): the largest
    of 16, 8, 4, 2 and 1 that divides every width, their sum B and every
    address.  -> (w, words): words[j] = (column, word in that column's
    row) of the packed row's word j, for the B // w words of a row, the
    position a thread of the word path keeps (an indexed launch)."""
    B = sum(widths)
    w = next(w for w in K19_WORDS
             if all(x % w == 0 for x in (B, *widths, *ptrs)))
    words = [(c, k) for c, cb in enumerate(widths) for k in range(cb // w)]
    return w, words


def _check_cols(cols: Sequence[torch.Tensor], what: str) -> int:
    if not 1 <= len(cols) <= K19_MAX_COLS:
        raise ValueError(f"{what}: {len(cols)} state columns (1 to "
                         f"{K19_MAX_COLS})")
    n = cols[0].shape[0]
    for c in cols:
        if c.dtype not in _ELEM or c.dim() not in (1, 2) or c.shape[0] != n:
            raise ValueError(
                f"{what}: state column {tuple(c.shape)} {c.dtype}: want 1-d "
                f"or 2-d of {n} rows")
    width = sum(_row_bytes(c) for c in cols)
    if width > K19_TILE_BYTES:
        raise ValueError(f"{what}: {width}-byte state rows (at most "
                         f"{K19_TILE_BYTES})")
    return width


def pack_state_rows(cols: Sequence[torch.Tensor],
                    dst_rows: Optional[torch.Tensor] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(rows, B) uint8: row g holds each column's row g as its bytes,
    column after column.  With dst_rows (int64, one a column row) row g
    goes to row dst_rows[g] of `out` (a (rows_out, B) uint8 matrix, whose
    other rows stay as they are); without, out has the columns' rows."""
    width = _check_cols(cols, "pack_state_rows")
    n = cols[0].shape[0]
    dev = cols[0].device
    if dst_rows is not None:
        if out is None or dst_rows.dtype != torch.int64 \
                or dst_rows.shape != (n,):
            raise ValueError("pack_state_rows: dst_rows wants int64 (rows,) "
                             "and an out matrix")
    if out is None:
        out = torch.empty((n, width), dtype=torch.uint8, device=dev)
    if out.dtype != torch.uint8 or out.dim() != 2 or out.shape[1] != width \
            or not out.is_contiguous():
        raise ValueError(f"pack_state_rows: out {tuple(out.shape)} "
                         f"{out.dtype}: want a contiguous (rows, {width}) "
                         f"uint8 matrix")
    if dev.type == "cpu":
        return _pack_plain(cols, dst_rows, out)
    if dev.type != "cuda":
        raise RuntimeError(f"pack_state_rows: no kernel for {dev}")
    return _pack_cuda(cols, dst_rows, out, width)


def unpack_state_rows(packed: torch.Tensor,
                      layout: Sequence[Tuple[torch.dtype, int]],
                      src_rows: Optional[torch.Tensor] = None
                      ) -> List[torch.Tensor]:
    """The state columns of `packed` ((rows, B) uint8), one a (dtype,
    width) of `layout` (width 1: a 1-d column, else (rows, width)); with
    src_rows (int64) the columns' row i is packed row src_rows[i]."""
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError(f"unpack_state_rows: {tuple(packed.shape)} "
                         f"{packed.dtype}: want (rows, B) uint8")
    width = sum(torch.empty(0, dtype=d).element_size() * w
                for d, w in layout)
    if width != packed.shape[1]:
        raise ValueError(f"unpack_state_rows: the layout is {width} bytes a "
                         f"row, the matrix {packed.shape[1]}")
    if src_rows is not None and src_rows.dtype != torch.int64:
        raise ValueError("unpack_state_rows: src_rows wants int64")
    n = packed.shape[0] if src_rows is None else src_rows.shape[0]
    dev = packed.device
    cols = [torch.empty((n,) if w == 1 else (n, w), dtype=d, device=dev)
            for d, w in layout]
    _check_cols(cols, "unpack_state_rows")
    if dev.type == "cpu":
        return _unpack_plain(packed, layout, src_rows)
    if dev.type != "cuda":
        raise RuntimeError(f"unpack_state_rows: no kernel for {dev}")
    return _unpack_cuda(packed, src_rows, cols, width)


def _bytes_of(c: torch.Tensor) -> torch.Tensor:
    c = c.contiguous()
    if c.dtype == torch.bool:
        c = c.view(torch.uint8)
    w = c.shape[1] if c.dim() == 2 else 1
    return c.reshape(c.shape[0], w).view(torch.uint8)


def _pack_plain(cols, dst_rows, out) -> torch.Tensor:
    packed = torch.cat([_bytes_of(c) for c in cols], dim=1)
    if dst_rows is None:
        out.copy_(packed)
    else:
        out[dst_rows] = packed
    return out


def _unpack_plain(packed, layout, src_rows) -> List[torch.Tensor]:
    if src_rows is not None:
        packed = packed[src_rows]
    out, off = [], 0
    for d, w in layout:
        nb = torch.empty(0, dtype=d).element_size() * w
        chunk = packed[:, off:off + nb].clone(
            memory_format=torch.contiguous_format)
        off += nb
        col = chunk.view(d)
        out.append(col[:, 0] if w == 1 else col)
    return out


def _ptrs(cols: Sequence[torch.Tensor], packed: torch.Tensor):
    """The columns' pointers and row bytes for C, and K19's word width."""
    addrs = [c.data_ptr() for c in cols]
    widths = [_row_bytes(c) for c in cols]
    w, _ = k19_plan(widths, [packed.data_ptr(), *addrs])
    ptrs = (ctypes.c_void_p * len(cols))(*addrs)
    cb = (ctypes.c_int * len(cols))(*widths)
    return ptrs, cb, w


def _pack_cuda(cols, dst_rows, out, width) -> torch.Tensor:
    n = cols[0].shape[0]
    if n == 0:
        return out                       # no launch
    cols = [c.contiguous() for c in cols]
    ptrs, cb, w = _ptrs(cols, out)
    dev = out.device
    rc = _native.library().chtt_state_pack(
        ptrs, cb, len(cols), n, width, w, dst_rows is None,
        None if dst_rows is None else dst_rows.contiguous().data_ptr(),
        out.data_ptr(), _native.stream_ptr(dev))
    _native.check(rc, "state_pack")
    _native.count_launch("state_pack", n)
    return out


def _unpack_cuda(packed, src_rows, cols, width) -> List[torch.Tensor]:
    n = cols[0].shape[0]
    if n == 0:
        return cols                      # no launch
    packed = packed.contiguous()
    ptrs, cb, w = _ptrs(cols, packed)
    dev = packed.device
    rc = _native.library().chtt_state_unpack(
        packed.data_ptr(), n, width, w, src_rows is None,
        None if src_rows is None else src_rows.contiguous().data_ptr(),
        ptrs, cb, len(cols), _native.stream_ptr(dev))
    _native.check(rc, "state_unpack")
    _native.count_launch("state_unpack", n)
    return cols
