"""Segment bounds (K5) and segment reductions (K6) over key-sorted rows.

Reference: clickhouse_tpu/ops/scan_ops.py and the boundary lines of
clickhouse_tpu/ops/agg_ops.py group_by_sort.  On a TPU every reduction
there avoids scatter: sums are differences of prefix sums over all rows,
min/max/any an extra sort by (group, order token), and the segment starts
a sort of each group's first position.  The card scatters well, so:

  * K5 ``segment_bounds`` (csrc/segment_bounds.cu) finds the boundaries of
    the sorted packed keys, gives each sorted row its dense group id and
    writes each group's [start, end) where its boundary is found, in one
    pass with a decoupled look-back across tiles;
  * K6 ``segment_reduce_many`` (csrc/segment_reduce.cu) reduces each
    group directly, every reduction of a GROUP BY in one launch, reading
    each row's values and masks through the permutation (the reference's
    Grouping.take becomes a gather inside K6); ``segment_reduce`` is its
    one-spec form, and ``segment_reduce_sorted`` its entry for data and
    masks already in sorted order (no permutation read).

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
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..core.dtypes import u64_to_f64
from . import _native
from .hash_ops import _f32_from_token, f64_from_token
from .sort_ops import SortKey, order_value

__all__ = ["segment_bounds", "segment_bounds_bytes", "k5_scratch_bytes",
           "segment_reduce", "segment_reduce_many", "segment_reduce_sorted",
           "fsumx_column", "spec_key", "COUNTED_OPS", "Spec",
           "K5_TILE_ROWS"]

# one reduction of segment_reduce_many: (op, data, mask, unsigned).  Op
# "fsumx" sums a float64 term formed a row at a time from columns as they
# are stored: its data is (x, y, power), x^power (power 1-4: x, x*x,
# (x*x)*x, (x*x)*(x*x), as the reference multiplies) times y where y is
# not None, and its unsigned is (x holds UInt64 bits, y holds UInt64
# bits).  K6 forms the term in registers (OP_FSUMX), so the variance
# family, the covariance and the moments sum their terms without a
# float64 column of them; the plain version takes fsumx_column's.
Spec = Tuple[str, object, Optional[torch.Tensor], object]


def fsumx_column(data, unsigned) -> torch.Tensor:
    """The float64 column of an "fsumx" spec's term (its data and
    unsigned, as Spec describes them)."""
    x, y, power = data

    def f64(t, uns):
        return u64_to_f64(t) if uns and t.dtype == torch.int64 \
            else t.to(torch.float64)
    t = a = f64(x, unsigned[0])
    if power > 1:
        a2 = a * a
        t = a2 if power == 2 else a2 * a if power == 3 else a2 * a2
    return t if y is None else t * f64(y, unsigned[1])


def spec_key(spec: Spec) -> tuple:
    """What makes two specs one reduction: the op, the identity of each
    tensor it reads, and the rest as it is."""
    op, data, mask, unsigned = spec
    if op == "fsumx":
        x, y, power = data
        return op, id(x), id(y), power, id(mask), unsigned
    return op, id(data), id(mask), unsigned


# op -> csrc/segment_reduce.cu SegOp (a float sum is OP_FSUM)
_OPS = {"sum": 0, "min": 1, "max": 2, "any": 3, "bor": 4, "band": 5,
        "bxor": 6, "count": 7, "fsumx": 9}
_FSUM = 8
_BITOPS = ("bor", "band", "bxor")
# the ops whose groups K6 also counts: a group without a masked-in row
# gives 0, which only the count tells from the identity (a sum, bor and
# bxor give their identity, 0, and keep no count)
COUNTED_OPS = ("min", "max", "any", "band", "count")
_MAX_KEYS = 4                      # key arrays K5 compares (kMaxKeys)
K5_TILE_ROWS = 4096                # rows of a K5 tile (kTile)
_SIGN = -(1 << 63)                 # int64 bits of 1 << 63
_I64_MAX = (1 << 63) - 1
# each op's identity, as int64 bits of the kernel's u64 state
_IDENTITY = {"sum": 0, "fsumx": 0, "min": -1, "max": 0, "any": -1, "bor": 0,
             "band": -1, "bxor": 0}


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


def k5_scratch_bytes(n: int) -> int:
    """Device bytes of K5's scratch for n rows (csrc/segment_bounds.cu): a
    look-back status word (8 bytes) a tile of K5_TILE_ROWS rows, counting
    up to 3 rows more for a key array's misaligned head, and the tile
    counter."""
    return (-(-(n + 3) // K5_TILE_ROWS) + 1) * 8


def segment_bounds_bytes(n: int, cap_g: int, n_keys: int) -> int:
    """Device bytes a segment_bounds call over n rows, cap_g slots and
    n_keys key arrays allocates: the group ids (4 bytes a row), starts and
    ends (16 bytes a slot), num_groups and K5's scratch; with more than
    four key arrays, also the group ids that fold the arrays past the
    third."""
    fold = 4 * n + k5_scratch_bytes(n) + 24 if n_keys > _MAX_KEYS else 0
    return 4 * n + 16 * cap_g + 8 + k5_scratch_bytes(n) + fold


def _segment_bounds_cuda(keys, n_valid, cap_g):
    """Launch K5: one memset of its look-back words, one kernel."""
    n, dev = keys[0].shape[0], keys[0].device
    nv = n_valid.to(device=dev, dtype=torch.int64).reshape(()).contiguous()
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        z = torch.zeros(cap_g, dtype=torch.int64, device=dev)
        return gid, torch.zeros((), dtype=torch.int64, device=dev), z, \
            z.clone()
    num_groups = torch.empty((), dtype=torch.int64, device=dev)
    starts = torch.empty(cap_g, dtype=torch.int64, device=dev)
    ends = torch.empty(cap_g, dtype=torch.int64, device=dev)
    keys = [k.contiguous() for k in keys]
    scratch = torch.empty(k5_scratch_bytes(n), dtype=torch.uint8, device=dev)
    ptrs = (ctypes.c_void_p * len(keys))(*[k.data_ptr() for k in keys])
    widths = (ctypes.c_int * len(keys))(*[k.element_size() for k in keys])
    rc = _native.library().chtt_segment_bounds(
        ptrs, widths, len(keys), n, nv.data_ptr(), cap_g, gid.data_ptr(),
        num_groups.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        scratch.data_ptr(), scratch.numel(), _native.stream_ptr(dev))
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
    """One per-group reduction of key-sorted rows; -> (cap_g,).  The
    one-spec form of :func:`segment_reduce_many` (which documents the
    arguments)."""
    return segment_reduce_many([(op, data, mask, unsigned)], perm, gid,
                               cap_g)[0]


def segment_reduce_many(specs: Sequence[Spec], perm: torch.Tensor,
                        gid: torch.Tensor, cap_g: int, *,
                        group_rows: Optional[torch.Tensor] = None
                        ) -> List[torch.Tensor]:
    """Per-group reductions of key-sorted rows; -> one (cap_g,) tensor a
    spec.

    specs  -- (op, data, mask, unsigned) each:
              op   -- sum | min | max | any | bor | band | bxor | count
                      | fsumx (Spec describes its data and unsigned)
              data -- values in RAW row order (any storage type; a
                      column's narrow storage is read as it is); None for
                      count
              mask -- rows to include, raw row order (bool), None = every
                      row
              unsigned -- int64 data holds UInt64 bits (min/max compare
                      unsigned)
    perm   -- int32: sorted position -> raw row
    gid    -- int32 dense group id of each sorted row (>= cap_g: skipped)
    group_rows -- (cap_g,) int64 rows of each group slot (the grouping's
              ends - starts), or None.  Where given, a spec over every row
              (mask None) takes its groups' counts from it: a count over
              every row launches nothing, and K6 keeps no count for it.

    sum gives int64 (wrapping) or float64, fsumx float64, count int64,
    the others data's type; a group without a masked-in row gives 0.

    A CPU tensor takes the plain version, a spec at a time.  A CUDA tensor
    launches K6 once for all the specs (each distinct column gathered once,
    each distinct mask read once), or once for each K6_MAX_SPECS
    reductions, K6_MAX_DATA columns or K6_MAX_MASKS masks.
    """
    if perm.shape != gid.shape or perm.dtype != torch.int32:
        raise ValueError("segment_reduce: perm and gid must be int32 of one "
                         "length")
    return _segment_reduce_entry(specs, perm, gid, cap_g, group_rows)


def segment_reduce_sorted(specs: Sequence[Spec], gid: torch.Tensor,
                          cap_g: int, *,
                          group_rows: Optional[torch.Tensor] = None
                          ) -> List[torch.Tensor]:
    """K6's sorted-order entry (the reference's seg_reduce_sorted over data
    Grouping.take already put in sorted order): :func:`segment_reduce_many`
    with each spec's data and mask in SORTED order, row i at sorted
    position i.  No permutation is read; `any` is the first masked-in row
    in sorted order.

    A CPU tensor takes the plain version; a CUDA tensor launches K6 with
    no permutation (counted as ``segment_reduce_sorted``).
    """
    return _segment_reduce_entry(specs, None, gid, cap_g, group_rows)


def _segment_reduce_entry(specs, perm, gid, cap_g, group_rows):
    specs = [_checked_spec(sp) for sp in specs]
    dev = gid.device
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise ValueError("segment_reduce: gid must be 1-d int32")
    for op, data, mask, _ in specs:
        for t in _tensors(op, data) + [mask]:
            if t is not None and t.shape[0] != gid.shape[0] \
                    and perm is None:
                raise ValueError("segment_reduce_sorted: data and masks "
                                 "must have a row a sorted position")
    if dev.type == "cpu":
        return [_segment_reduce_plain(op, data, mask, perm, gid, cap_g, uns)
                for op, data, mask, uns in specs]
    if dev.type != "cuda":
        raise RuntimeError(f"segment_reduce: no kernel for {dev}")
    return _segment_reduce_many_cuda(specs, perm, gid, cap_g, group_rows)


def _checked_spec(spec: Spec) -> Spec:
    op, data, mask, unsigned = spec
    if op not in _OPS:
        raise ValueError(f"segment_reduce: unknown op {op!r}")
    if (data is None) != (op == "count"):
        raise ValueError(f"segment_reduce: {op} takes "
                         f"{'no' if op == 'count' else 'its'} data")
    if op == "fsumx":
        x, y, power = data
        if power not in (1, 2, 3, 4):
            raise ValueError(f"segment_reduce: fsumx of power {power}")
        ux, uy = unsigned
        return op, data, mask, (bool(ux) and x.dtype == torch.int64,
                                y is not None and bool(uy)
                                and y.dtype == torch.int64)
    if data is not None and op in _BITOPS and data.is_floating_point():
        raise TypeError(f"segment_reduce: {op} needs integer data")
    unsigned = bool(unsigned) and data is not None \
        and data.dtype == torch.int64
    return op, data, mask, unsigned


@dataclasses.dataclass
class _Launch:
    """One launch of K6: its columns, its masks, the mask slot of each
    count it keeps (-1: every row), each reduction as (spec index, column
    slot or -1, mask slot or -1), and each reduction's second column slot
    (an fsumx term's y; -1: none)."""
    data: List[torch.Tensor] = dataclasses.field(default_factory=list)
    masks: List[torch.Tensor] = dataclasses.field(default_factory=list)
    counts: List[int] = dataclasses.field(default_factory=list)
    specs: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)
    second: List[int] = dataclasses.field(default_factory=list)


def _same_tensor(t: torch.Tensor):
    """What K6 reads of t: two tensors with one key are one column."""
    return t.data_ptr(), t.dtype, tuple(t.shape), t.stride()


def _is_new(ts: List[torch.Tensor], t: Optional[torch.Tensor]) -> bool:
    return t is not None and _same_tensor(t) not in [_same_tensor(u)
                                                     for u in ts]


def _slot(ts: List[torch.Tensor], t: Optional[torch.Tensor]) -> int:
    """t's slot in ts (-1 for None), appended where it is new."""
    if t is None:
        return -1
    if _is_new(ts, t):
        ts.append(t)
    return [_same_tensor(u) for u in ts].index(_same_tensor(t))


def _plan_launches(specs: Sequence[Spec], have_group_rows: bool
                   ) -> Tuple[List[_Launch], List[Tuple[int, int, int]]]:
    """K6's launches for the checked specs, and where each spec's result
    lies: (launch or -1, reduction slot or -1, count slot or -1).  A count
    spec and the ops of COUNTED_OPS need their mask's count, except over
    every row where group_rows gives it; `any` keeps a row id and reads no
    column; an fsumx term reads its one or two columns."""
    launches: List[_Launch] = []
    where = []
    for op, data, mask, _ in specs:
        reduces = op != "count"
        counted = op in COUNTED_OPS and not (mask is None and have_group_rows)
        if not reduces and not counted:
            where.append((-1, -1, -1))
            continue
        cols = _columns(op, data)
        cur = launches[-1] if launches else None

        def new_cols(launch):
            seen: List[torch.Tensor] = list(launch.data)
            n_new = 0
            for c in cols:
                if _is_new(seen, c):
                    seen.append(c)
                    n_new += 1
            return n_new
        if cur is None \
                or len(cur.specs) + reduces > _native.K6_MAX_SPECS \
                or len(cur.data) + new_cols(cur) > _native.K6_MAX_DATA \
                or len(cur.masks) + _is_new(cur.masks, mask) \
                > _native.K6_MAX_MASKS:
            cur = _Launch()
            launches.append(cur)
        slots = [_slot(cur.data, c) for c in cols] + [-1, -1]
        d, d2, m = slots[0], slots[1], _slot(cur.masks, mask)
        c = -1
        if counted:
            if m not in cur.counts:
                cur.counts.append(m)
            c = cur.counts.index(m)
        q = -1
        if reduces:
            cur.specs.append((len(where), d, m))
            cur.second.append(d2)
            q = len(cur.specs) - 1
        where.append((len(launches) - 1, q, c))
    return launches, where


def _tensors(op: str, data) -> List[torch.Tensor]:
    """The columns a reduction takes (none for count)."""
    if op == "fsumx":
        return [t for t in data[:2] if t is not None]
    return [] if data is None else [data]


def _columns(op: str, data) -> List[torch.Tensor]:
    """The columns K6 reads for a reduction (`any` keeps a row id)."""
    return [] if op == "any" else _tensors(op, data)


def _segment_reduce_many_cuda(specs, perm, gid, cap_g, group_rows):
    n, dev = gid.shape[0], gid.device
    checked = []
    for op, data, mask, uns in specs:
        cols = _tensors(op, data)
        for t in cols + [mask]:
            if t is not None and (t.device != dev or t.dim() != 1):
                raise ValueError("segment_reduce: data and masks must be "
                                 "1-d tensors on the group ids' device")
        if mask is not None and (mask.dtype != torch.bool
                                 or any(mask.shape != t.shape
                                        for t in cols)):
            raise ValueError("segment_reduce: mask must be bool of the "
                             "data's shape")
        if op == "fsumx":
            x, y, power = data
            data = (x.contiguous(), None if y is None else y.contiguous(),
                    power)
        elif data is not None:
            data = data.contiguous()
        checked.append((op, data,
                        None if mask is None else mask.contiguous(), uns))
    if group_rows is not None and (group_rows.shape != (cap_g,)
                                   or group_rows.device != dev):
        raise ValueError("segment_reduce: group_rows must be (cap_g,) on "
                         "the group ids' device")
    launches, where = _plan_launches(checked, group_rows is not None)
    if perm is not None:
        perm = _native.aligned16(perm.contiguous())
    gid = _native.aligned16(gid.contiguous())
    stream = _native.stream_ptr(dev)
    accs, cnts = [], []
    for launch in launches:
        acc = [torch.full((cap_g,), _IDENTITY[checked[i][0]],
                          dtype=torch.int64, device=dev)
               for i, _, _ in launch.specs]
        cnt = [torch.zeros(cap_g, dtype=torch.int64, device=dev)
               for _ in launch.counts]
        accs.append(acc)
        cnts.append(cnt)
        if not n:
            continue
        args = _native.K6Args(
            perm=None if perm is None else perm.data_ptr(),
            gid=gid.data_ptr(), n=n, cap_g=cap_g,
            n_specs=len(launch.specs), n_data=len(launch.data),
            n_masks=len(launch.masks), n_counts=len(launch.counts))
        for d, t in enumerate(launch.data):
            args.data[d] = t.data_ptr()
            args.dtype[d] = _native.dtype_code(t.dtype)
        for m, t in enumerate(launch.masks):
            args.mask[m] = t.data_ptr()
        for c, m in enumerate(launch.counts):
            args.count[c] = _native.K6Count(mask=m, out=cnt[c].data_ptr())
        for q, ((i, d, m), d2) in enumerate(zip(launch.specs,
                                                launch.second)):
            op, data, _, uns = checked[i]
            if op == "fsumx":
                args.spec[q] = _native.K6Spec(
                    op=_OPS[op], data=d, mask=m, uns=int(uns[0]), data2=d2,
                    pow=data[2], uns2=int(uns[1]), acc=acc[q].data_ptr())
                continue
            code = _FSUM if op == "sum" and data.is_floating_point() \
                else _OPS[op]
            args.spec[q] = _native.K6Spec(op=code, data=d, mask=m,
                                          uns=int(uns), data2=-1, pow=1,
                                          acc=acc[q].data_ptr())
        rc = _native.library().chtt_segment_reduce(ctypes.byref(args),
                                                   stream)
        _native.check(rc, "segment_reduce")
        _native.count_launch("segment_reduce" if perm is not None
                             else "segment_reduce_sorted", n)
    out = []
    for (op, data, _, uns), (li, q, c) in zip(checked, where):
        cnt = group_rows if c < 0 else cnts[li][c]
        out.append(cnt if op == "count"
                   else _finish(op, accs[li][q], cnt, data, uns))
    return out


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
    if op == "fsumx":
        return acc.view(torch.float64)
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
    group reduced in sorted row order); perm None: the sorted-order entry's
    (row i is sorted position i)."""
    dev = gid.device
    if op == "fsumx":
        op, data, unsigned = "sum", fsumx_column(data, unsigned), False
    g = gid.to(torch.int64)
    rows = torch.arange(g.shape[0], device=dev) if perm is None \
        else perm.to(torch.int64)
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
