"""Sorted search (K18 ``segmented_search``, csrc/segmented_search.cu).

Reference: clickhouse_tpu/ops/search.py.  On a TPU a random 8-byte read
costs tens of nanoseconds, so the reference finds positions with sorts:
``searchsorted_via_sort`` (:31) and ``searchsorted_seg`` (:52) sort the
table and the queries together and count the table entries before each
query, and ``searchsorted`` (:77) takes that route from 2^18 queries on.
Every one of them is K18 here: each query's binary search within its own
segment of the table (``segmented_search``), or within the whole table;
a tile of sorted queries searches one stretch of the table copied into
shared memory.  The answers are the reference's:
``searchsorted_via_sort``'s observable result is ``searchsorted``'s, so
it has no entry of its own.

A CPU tensor takes the plain version (``torch.searchsorted`` over one
segment, a vectorised bisection over many); a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _native

__all__ = ["segmented_search", "searchsorted", "searchsorted_seg"]

_SIGN = -(1 << 63)                 # int64 bits of 1 << 63


def segmented_search(table: torch.Tensor, queries: torch.Tensor,
                     side: str = "left", *,
                     gid: Optional[torch.Tensor] = None,
                     starts: Optional[torch.Tensor] = None,
                     ends: Optional[torch.Tensor] = None,
                     unsigned: bool = False) -> torch.Tensor:
    """Each query's position in its segment of a sorted table (K18).

    table    -- int64 values, ascending within each segment
    queries  -- int64 values
    gid      -- int32 segment of each query (clamped to [0, len(starts)));
                the query searches table[starts[g], ends[g]).  None: one
                segment, the whole table
    side     -- "left": the first position whose value is not below the
                query; "right": the first whose value is above it (the
                segment's end where there is none)
    unsigned -- compare the int64 bits as u64 (order tokens)
    -> int64 global positions, one a query.
    """
    if side not in ("left", "right"):
        raise ValueError(f"segmented_search: side {side!r}")
    if table.dim() != 1 or queries.dim() != 1 \
            or table.dtype != torch.int64 or queries.dtype != torch.int64 \
            or table.device != queries.device:
        raise ValueError("segmented_search: 1-d int64 table and queries on "
                         "one device")
    if gid is not None:
        if starts is None or ends is None or starts.numel() == 0 \
                or gid.shape != queries.shape or gid.dtype != torch.int32 \
                or starts.dtype != torch.int64 or ends.dtype != torch.int64:
            raise ValueError("segmented_search: int32 gid a query with "
                             "int64 starts and ends")
    dev = table.device
    if dev.type == "cpu":
        return _segmented_search_plain(table, queries, side, gid, starts,
                                       ends, unsigned)
    if dev.type != "cuda":
        raise RuntimeError(f"segmented_search: no kernel for {dev}")
    return _segmented_search_cuda(table, queries, side, gid, starts, ends,
                                  unsigned)


def _segmented_search_cuda(table, queries, side, gid, starts, ends,
                           unsigned):
    n_q = queries.shape[0]
    out = torch.empty(n_q, dtype=torch.int64, device=table.device)
    if n_q == 0:
        return out
    _search_launch(table, queries, side, gid, starts, ends, unsigned, out)
    _native.count_launch("segmented_search", n_q)
    return out


def _search_launch(table, queries, side, gid, starts, ends, unsigned, out,
                   counts=None):
    """One K18 launch into `out`.  counts: None, or an int64 tensor of 3
    to which each block of 2,048 queries adds one for the branch it took
    (the shared-memory window, queries out of order, a stretch wider than
    the window): a diagnostic the main path never passes."""
    dev = table.device
    table = table.contiguous()
    # the kernel reads the queries and segment ids as 16-byte vectors
    queries = _native.aligned16(queries.contiguous())
    if gid is not None:
        gid = _native.aligned16(gid.contiguous())
        starts, ends = starts.contiguous(), ends.contiguous()
    rc = _native.library().chtt_segmented_search(
        table.data_ptr(), table.shape[0], queries.data_ptr(),
        queries.shape[0],
        gid.data_ptr() if gid is not None else None,
        starts.data_ptr() if gid is not None else None,
        ends.data_ptr() if gid is not None else None,
        starts.shape[0] if gid is not None else 0,
        int(side == "right"), int(unsigned), out.data_ptr(),
        counts.data_ptr() if counts is not None else None,
        _native.stream_ptr(dev))
    _native.check(rc, "segmented_search")


def _segmented_search_plain(table, queries, side, gid, starts, ends,
                            unsigned):
    """Plain PyTorch version of K18: torch.searchsorted over one segment
    (unsigned values with their sign bit flipped), else a vectorised
    bisection of every query at once within its segment's bounds."""
    flip = _SIGN if unsigned else 0
    t = table ^ flip if flip else table
    q = queries ^ flip if flip else queries
    if gid is None:
        return torch.searchsorted(t, q, right=side == "right")
    g = gid.to(torch.int64).clamp(0, starts.shape[0] - 1)
    lo = starts.index_select(0, g).clone()
    hi = ends.index_select(0, g).clone()
    while True:
        live = lo < hi
        if not bool(live.any()):
            return lo
        mid = lo + ((hi - lo) >> 1)
        v = t.index_select(0, torch.where(live, mid, 0))
        go = (v <= q) if side == "right" else (v < q)
        lo = torch.where(live & go, mid + 1, lo)
        hi = torch.where(live & ~go, mid, hi)


def _order_bits(x: torch.Tensor):
    """Values as int64 whose signed order is theirs (-> (bits, unsigned)):
    integers as they are (UInt64 bits compare unsigned: the caller says
    so), floats as their total-order tokens, compared unsigned."""
    if x.is_floating_point():
        from .hash_ops import sortable_bits
        return sortable_bits(x.to(torch.float64))[0], True
    return x.to(torch.int64), False


def searchsorted(a: torch.Tensor, v: torch.Tensor, side: str = "left", *,
                 unsigned: bool = False) -> torch.Tensor:
    """jnp.searchsorted(a, v, side) over one ascending array (the
    reference's searchsorted and searchsorted_via_sort): K18's
    one-segment form; int64 positions.  unsigned: int64 values holding
    UInt64 bits."""
    if a.is_floating_point() or v.is_floating_point():
        t = torch.promote_types(a.dtype, v.dtype)
        (ta, uns), (tv, _) = _order_bits(a.to(t)), _order_bits(v.to(t))
    else:
        ta, uns = a.to(torch.int64), unsigned
        tv = v.to(torch.int64)
    return segmented_search(ta.contiguous(), tv.reshape(-1).contiguous(),
                            side, unsigned=uns).reshape(v.shape)


def searchsorted_seg(seg: torch.Tensor, key: torch.Tensor,
                     qseg: torch.Tensor, qkey: torch.Tensor,
                     side: str = "left", *,
                     unsigned: bool = False) -> torch.Tensor:
    """The reference's searchsorted_seg: the global position of each
    (qseg, qkey) query in an array sorted by (seg, key) (int64).  The
    query's segment is found with K18's one-segment form (its first and
    past-last rows of seg), then its key within that segment with K18's
    segmented form (a segment a query).  unsigned: the keys are UInt64
    bits."""
    if qkey.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=qkey.device)
    seg64, qseg64 = seg.to(torch.int64), qseg.to(torch.int64)
    lo = searchsorted(seg64, qseg64, "left")
    hi = searchsorted(seg64, qseg64, "right")
    if key.is_floating_point() or qkey.is_floating_point():
        t = torch.promote_types(key.dtype, qkey.dtype)
        (tk, uns), (tq, _) = _order_bits(key.to(t)), _order_bits(qkey.to(t))
    else:
        tk, tq, uns = key.to(torch.int64), qkey.to(torch.int64), unsigned
    n = qkey.shape[0]
    ids = torch.arange(n, dtype=torch.int32, device=qkey.device)
    return segmented_search(tk.contiguous(), tq.contiguous(), side,
                            gid=ids, starts=lo.contiguous(),
                            ends=hi.contiguous(), unsigned=uns)
