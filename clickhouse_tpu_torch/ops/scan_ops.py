"""Segment bounds (K5) and segment reductions (K6) over key-sorted rows.

Reference: clickhouse_tpu/ops/scan_ops.py and the boundary lines of
clickhouse_tpu/ops/agg_ops.py group_by_sort.  On a TPU every reduction
there avoids scatter: sums are differences of prefix sums over all rows,
min/max/any an extra sort by (group, order token), and the segment starts
a sort of each group's first position.  The card scatters well, so:

  * K5 ``segment_bounds`` (csrc/segment_bounds.cu) finds the boundaries of
    the sorted packed keys, gives each sorted row its dense group id and
    writes each group's [start, end) where its boundary is found;
  * K6 ``segment_reduce`` (csrc/segment_reduce.cu) reduces each group
    directly, reading each row's value and mask through the permutation
    (the reference's Grouping.take becomes a gather inside K6).

Results follow the reference's seg_reduce_sorted: sums widen integers to
64 bits (wrapping) and floats to float64; min/max pick by order token
(-0.0 below +0.0; a positive NaN above every number, a negative NaN below);
`any` is the first masked-in row in row order; a group without a masked-in
row gives 0.  Float sums add each group's own values (in another order than
the reference's prefix differences, and on the card in an order that
varies from run to run).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _native
from .hash_ops import _f32_from_token, f64_from_token
from .sort_ops import SortKey, order_value

__all__ = ["segment_bounds", "segment_reduce", "COUNTED_OPS"]

# op -> csrc/segment_reduce.cu SegOp (a float sum is OP_FSUM)
_OPS = {"sum": 0, "min": 1, "max": 2, "any": 3, "bor": 4, "band": 5,
        "bxor": 6, "count": 7}
_FSUM = 8
_BITOPS = ("bor", "band", "bxor")
# the ops whose groups K6 also counts: a group without a masked-in row
# gives 0, which only the count tells from the identity (a sum, bor and
# bxor give their identity, 0, and keep no count)
COUNTED_OPS = ("min", "max", "any", "band", "count")
_MAX_KEYS = 4                      # key arrays K5 compares (kMaxKeys)
_SIGN = -(1 << 63)                 # int64 bits of 1 << 63
_I64_MAX = (1 << 63) - 1
# each op's identity, as int64 bits of the kernel's u64 state
_IDENTITY = {"sum": 0, "min": -1, "max": 0, "any": -1, "bor": 0, "band": -1,
             "bxor": 0}


# -- K5: segment bounds -------------------------------------------------------

def segment_bounds(keys: Sequence[torch.Tensor], n_valid: torch.Tensor,
                   cap_g: int) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """Groups of key-sorted rows.

    keys    -- the packed keys in sorted order (int32 or int64 bits, one
               length); a row starts a group where any key differs from
               the row before it
    n_valid -- 0-d int64 tensor: the rows before it are valid (the sort put
               the invalid rows last)
    K5 compares up to four arrays a row; where there are more, the group
    ids of the arrays from the fourth on (one K5 call over them alone)
    stand in for those arrays: sorted, they change exactly where one of
    those arrays changes.
    -> (gid, num_groups, starts, ends): gid (int32) the dense group id of
    each sorted row (cap_g for invalid rows), num_groups (0-d int64), and
    each group slot's [start, end) (int64, cap_g each; the valid row count
    for slots past the last group).  Groups at or past cap_g get no slot.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel.
    """
    if not keys:
        raise ValueError("segment_bounds: no key array")
    n, dev = keys[0].shape[0], keys[0].device
    for k in keys:
        if k.dim() != 1 or k.shape[0] != n or k.device != dev \
                or k.dtype not in (torch.int32, torch.int64):
            raise ValueError("segment_bounds: keys must be 1-d int32/int64 "
                             "tensors of one length on one device")
    if n >= 1 << 31:
        raise ValueError(f"segment_bounds: {n} rows (group ids are int32)")
    if len(keys) > _MAX_KEYS:
        tail = segment_bounds(keys[_MAX_KEYS - 1:], n_valid, 1)[0]
        keys = list(keys[:_MAX_KEYS - 1]) + [tail]
    if dev.type == "cpu":
        return _segment_bounds_plain(keys, n_valid, cap_g)
    if dev.type != "cuda":
        raise RuntimeError(f"segment_bounds: no kernel for {dev}")
    return _segment_bounds_cuda(keys, n_valid, cap_g)


def _segment_bounds_cuda(keys, n_valid, cap_g):
    n, dev = keys[0].shape[0], keys[0].device
    nv = n_valid.to(device=dev, dtype=torch.int64).reshape(()).contiguous()
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    num_groups = torch.zeros((), dtype=torch.int64, device=dev)
    if n == 0:
        z = torch.zeros(cap_g, dtype=torch.int64, device=dev)
        return gid, num_groups, z, z.clone()
    starts = torch.empty(cap_g, dtype=torch.int64, device=dev)
    ends = torch.empty(cap_g, dtype=torch.int64, device=dev)
    keys = [k.contiguous() for k in keys]
    lib = _native.library()
    tiles = -(-n // lib.chtt_segment_tile_rows())
    tile_count = torch.empty(tiles, dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * len(keys))(*[k.data_ptr() for k in keys])
    widths = (ctypes.c_int * len(keys))(*[k.element_size() for k in keys])
    rc = lib.chtt_segment_bounds(
        ptrs, widths, len(keys), n, nv.data_ptr(), cap_g, gid.data_ptr(),
        num_groups.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        tile_count.data_ptr(), min(-(-cap_g // 256), 4096),
        _native.stream_ptr(dev))
    _native.check(rc, "segment_bounds")
    _native.count_launch("segment_bounds", n)
    return gid, num_groups, starts, ends


def _segment_bounds_plain(keys, n_valid, cap_g):
    """Plain PyTorch version of K5 (the same results, device-agnostic)."""
    n, dev = keys[0].shape[0], keys[0].device
    nv = torch.clamp(n_valid.to(device=dev, dtype=torch.int64), 0, n)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    boundary = pos == 0
    for k in keys:
        boundary[1:] |= k[1:] != k[:-1]
    valid = pos < nv
    boundary &= valid
    g = torch.cumsum(boundary.to(torch.int64), 0) - 1
    num_groups = boundary.sum()
    gid = torch.where(valid, g, cap_g).to(torch.int32)
    # each group's first row is its start, and the end of the group before
    starts = nv.expand(cap_g + 1).clone()
    ends = nv.expand(cap_g + 1).clone()
    head = torch.where(boundary & (g < cap_g), g, cap_g)
    starts.scatter_(0, head, pos)
    prev = torch.where(boundary & (g >= 1) & (g - 1 < cap_g), g - 1, cap_g)
    ends.scatter_(0, prev, pos)
    if n:
        g_last = g.gather(0, torch.clamp(nv - 1, min=0).reshape(1))
        last = torch.where((nv > 0) & (g_last < cap_g), g_last, cap_g)
        ends.scatter_(0, last, nv.reshape(1))
    # slot cap_g took the writes of groups without a slot
    return gid, num_groups, starts[:cap_g], ends[:cap_g]


# -- K6: segment reductions ---------------------------------------------------

def segment_reduce(op: str, data: Optional[torch.Tensor],
                   mask: Optional[torch.Tensor], perm: torch.Tensor,
                   gid: torch.Tensor, cap_g: int, *,
                   unsigned: bool = False) -> torch.Tensor:
    """Per-group reduction of key-sorted rows; -> (cap_g,).

    op     -- sum | min | max | any | bor | band | bxor | count
    data   -- values in RAW row order (any storage type; a column's narrow
              storage is read as it is); None for count
    mask   -- rows to include, raw row order (bool), None = every row
    perm   -- int32: sorted position -> raw row
    gid    -- int32 dense group id of each sorted row (>= cap_g: skipped)
    unsigned -- int64 data holds UInt64 bits (min/max compare unsigned)

    sum gives int64 (wrapping) or float64, count int64, the others data's
    type; a group without a masked-in row gives 0.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel.
    """
    if op not in _OPS:
        raise ValueError(f"segment_reduce: unknown op {op!r}")
    if (data is None) != (op == "count"):
        raise ValueError(f"segment_reduce: {op} takes "
                         f"{'no' if op == 'count' else 'its'} data")
    if data is not None and op in _BITOPS and data.is_floating_point():
        raise TypeError(f"segment_reduce: {op} needs integer data")
    n, dev = gid.shape[0], gid.device
    if perm.shape != gid.shape or perm.dtype != torch.int32 \
            or gid.dtype != torch.int32:
        raise ValueError("segment_reduce: perm and gid must be int32 of one "
                         "length")
    unsigned = bool(unsigned) and data is not None \
        and data.dtype == torch.int64
    if dev.type == "cpu":
        return _segment_reduce_plain(op, data, mask, perm, gid, cap_g,
                                     unsigned)
    if dev.type != "cuda":
        raise RuntimeError(f"segment_reduce: no kernel for {dev}")
    return _segment_reduce_cuda(op, data, mask, perm, gid, cap_g, unsigned)


def _segment_reduce_cuda(op, data, mask, perm, gid, cap_g, unsigned):
    n, dev = gid.shape[0], gid.device
    for t in (data, mask, perm):
        if t is not None and (t.device != dev or t.dim() != 1):
            raise ValueError("segment_reduce: data, mask and perm must be "
                             "1-d tensors on the group ids' device")
    if mask is not None and (mask.dtype != torch.bool
                             or (data is not None
                                 and mask.shape != data.shape)):
        raise ValueError("segment_reduce: mask must be bool of the data's "
                         "shape")
    code = _FSUM if op == "sum" and data.is_floating_point() \
        else _OPS[op]
    cnt = torch.zeros(cap_g, dtype=torch.int64, device=dev) \
        if op in COUNTED_OPS else None
    acc = None if op == "count" else torch.full(
        (cap_g,), _IDENTITY[op], dtype=torch.int64, device=dev)
    if n:
        data_c = None if data is None else data.contiguous()
        mask_c = None if mask is None else mask.contiguous()
        rc = _native.library().chtt_segment_reduce(
            code, None if data_c is None else data_c.data_ptr(),
            0 if data_c is None else _native.dtype_code(data_c.dtype),
            int(unsigned), None if mask_c is None else mask_c.data_ptr(),
            perm.contiguous().data_ptr(), gid.contiguous().data_ptr(), n,
            cap_g, None if acc is None else acc.data_ptr(),
            None if cnt is None else cnt.data_ptr(), _native.stream_ptr(dev))
        _native.check(rc, "segment_reduce")
        _native.count_launch("segment_reduce", n)
    return _finish(op, acc, cnt, data, unsigned)


def _from_order_key(k: torch.Tensor, dtype, unsigned: bool) -> torch.Tensor:
    """Inverse of K6's min/max order key (sort_ops.order_value: a float's
    token, an integer's bits with the sign bit flipped where it is
    signed), as `dtype`."""
    if dtype == torch.float64:
        return f64_from_token(k)
    if dtype == torch.float32:
        return _f32_from_token(k)
    if dtype in (torch.bool, torch.uint8) or unsigned:
        return k.to(dtype)
    return (k ^ _SIGN).to(dtype)


def _finish(op, acc, cnt, data, unsigned):
    """Group values from K6's states: acc (u64 bits a group) and cnt (the
    masked-in rows a group; read for COUNTED_OPS only)."""
    if op == "count":
        return cnt
    if op == "sum":
        return acc.view(torch.float64) if data.is_floating_point() else acc
    if op not in COUNTED_OPS:                     # bor, bxor
        return acc.to(data.dtype)
    have = cnt > 0
    zero = torch.zeros((), dtype=data.dtype, device=acc.device)
    if op in ("min", "max"):
        v = _from_order_key(acc, data.dtype, unsigned)
    elif op == "any":
        rows = torch.clamp(acc, 0, max(data.shape[0] - 1, 0))
        v = data[rows] if data.shape[0] else zero.expand(acc.shape)
    else:                                         # band
        v = acc.to(data.dtype)
    return torch.where(have, v, zero)


def _segment_reduce_plain(op, data, mask, perm, gid, cap_g, unsigned):
    """Plain PyTorch version of K6 (the same states as the kernel, each
    group reduced in sorted row order)."""
    dev = gid.device
    g = gid.to(torch.int64)
    rows = perm.to(torch.int64)
    m = g < cap_g
    if mask is not None:
        m = m & mask.to(torch.bool)[rows]
    slot = torch.where(m, g, cap_g)               # slot cap_g: dropped rows
    cnt = torch.zeros(cap_g + 1, dtype=torch.int64, device=dev)
    cnt.index_add_(0, slot, torch.ones_like(slot))
    cnt = cnt[:cap_g]
    if op == "count":
        return cnt
    x = data[rows]
    if op == "sum":
        if x.is_floating_point():
            acc = torch.zeros(cap_g + 1, dtype=torch.float64, device=dev)
            acc.index_add_(0, slot, torch.where(m, x.to(torch.float64), 0.0))
            acc = acc.view(torch.int64)
        else:
            acc = torch.zeros(cap_g + 1, dtype=torch.int64, device=dev)
            acc.index_add_(0, slot, torch.where(m, x.to(torch.int64), 0))
    elif op in ("min", "max", "any"):
        # unsigned order of the u64 states as signed order: flip the sign
        key = rows if op == "any" \
            else order_value(SortKey(x, unsigned=unsigned)) ^ _SIGN
        if op == "any":
            ident, how = _I64_MAX, "amin"
        else:
            ident, how = (_I64_MAX, "amin") if op == "min" \
                else (-_I64_MAX - 1, "amax")
        acc = torch.full((cap_g + 1,), ident, dtype=torch.int64, device=dev)
        acc.scatter_reduce_(0, slot, key, how, include_self=True)
        if op != "any":
            acc = acc ^ _SIGN
    else:
        # bit ops a bit at a time: OR is a max, AND a min, XOR a parity
        x64 = x.to(torch.int64)
        acc = torch.zeros(cap_g + 1, dtype=torch.int64, device=dev)
        for b in range(64):
            bit = (x64 >> b) & 1
            if op == "bxor":
                r = torch.zeros(cap_g + 1, dtype=torch.int64, device=dev)
                r.index_add_(0, slot, torch.where(m, bit, 0))
                r = r & 1
            else:
                r = torch.full((cap_g + 1,), int(op == "band"),
                               dtype=torch.int64, device=dev)
                r.scatter_reduce_(0, slot, bit,
                                  "amax" if op == "bor" else "amin",
                                  include_self=True)
            acc = acc | (r << b)
    return _finish(op, acc[:cap_g], cnt, data, unsigned)
