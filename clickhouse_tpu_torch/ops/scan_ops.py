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
    masks already in sorted order (no permutation and no group id read:
    the groups come as K5's starts and ends).  A reduction's data may be a
    :class:`Term` (intDiv or modulo of a narrow column by a constant),
    which K6 forms in registers from the gathered column.

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
from .calendar_ops import magic
from .hash_ops import _f32_from_token, f64_from_token
from .sort_ops import SortKey, order_value

__all__ = ["segment_bounds", "segment_bounds_bytes", "k5_scratch_bytes",
           "segment_reduce", "segment_reduce_many", "segment_reduce_sorted",
           "fsumx_column", "spec_key", "gid_of_bounds", "bounds_of_gid",
           "Term", "COUNTED_OPS", "Spec", "K5_TILE_ROWS"]

@dataclasses.dataclass(frozen=True, eq=False)
class Term:
    """intDiv (op "div") or modulo (op "mod") of a column by an integer
    constant c, kept unbuilt: K6 gathers `source` and forms the term in
    registers.  source is a signed int8/int16/int32 column (a scanned
    column's narrow storage), c fits its type and is neither 0 nor -1, so
    the division in the storage type cannot overflow; it truncates and the
    remainder takes the dividend's sign (torch.div(rounding_mode="trunc"),
    torch.fmod, as the reference's lax.div and lax.rem); the result widens
    to `dtype`.  A K6 spec takes a Term where it takes a column; every
    other reader builds it (:meth:`build`, :meth:`index_select`).  It is
    not a tensor: the wrapper reads its source (_source)."""
    source: torch.Tensor
    op: str
    c: int
    dtype: torch.dtype

    def __post_init__(self):
        if self.op not in ("div", "mod") or self.source.dtype not in (
                torch.int8, torch.int16, torch.int32):
            raise ValueError(f"Term: {self.op} over {self.source.dtype}")
        info = torch.iinfo(self.source.dtype)
        if self.c in (0, -1) or not info.min <= self.c <= info.max:
            raise ValueError(f"Term: divisor {self.c} for "
                             f"{self.source.dtype}")

    def _narrow(self, s: torch.Tensor) -> torch.Tensor:
        """The term of source values s in their type (it fits there:
        |term| is at most |s|)."""
        return torch.div(s, self.c, rounding_mode="trunc") \
            if self.op == "div" else torch.fmod(s, self.c)

    def apply(self, s: torch.Tensor) -> torch.Tensor:
        """The term of source values s, widened."""
        return self._narrow(s).to(self.dtype)

    def build(self) -> torch.Tensor:
        return self.apply(self.source)

    def build_narrow(self) -> torch.Tensor:
        """The term in its source's type, with no widened column."""
        return self._narrow(self.source)

    def index_select(self, dim: int, index: torch.Tensor) -> torch.Tensor:
        """The term at the rows `index`: a gather of the source, then the
        term (the source's bytes gathered, not the widened column's)."""
        return self.apply(self.source.index_select(dim, index))

    def key(self) -> tuple:
        """What makes two terms one: the source as read, the op and c."""
        return _same_tensor(self.source), self.op, self.c, self.dtype


# one reduction of segment_reduce_many: (op, data, mask, unsigned).  data
# is a column or a Term.  Op "fsumx" sums a float64 term formed a row at a
# time from columns as they are stored: its data is (x, y, power), x^power
# (power 1-4: x, x*x, (x*x)*x, (x*x)*(x*x), as the reference multiplies)
# times y where y is not None, and its unsigned is (x holds UInt64 bits, y
# holds UInt64 bits).  K6 forms the term in registers (OP_FSUMX), so the
# variance family, the covariance and the moments sum their terms without
# a float64 column of them; the plain version takes fsumx_column's.
Spec = Tuple[str, object, Optional[torch.Tensor], object]


def _built(t):
    """A column, or a Term's built column (None stays None)."""
    return t.build() if isinstance(t, Term) else t


def _source(t):
    """The tensor K6 reads of a spec's column or Term (a Term's source:
    the same rows on the same device)."""
    return t.source if isinstance(t, Term) else t


def _is_float(t) -> bool:
    """A spec's column holds floats (a Term never does)."""
    return not isinstance(t, Term) and t.is_floating_point()


def fsumx_column(data, unsigned) -> torch.Tensor:
    """The float64 column of an "fsumx" spec's term (its data and
    unsigned, as Spec describes them)."""
    x, y, power = data
    x, y = _built(x), _built(y)

    def f64(t, uns):
        return u64_to_f64(t) if uns and t.dtype == torch.int64 \
            else t.to(torch.float64)
    t = a = f64(x, unsigned[0])
    if power > 1:
        a2 = a * a
        t = a2 if power == 2 else a2 * a if power == 3 else a2 * a2
    return t if y is None else t * f64(y, unsigned[1])


def _ident(t):
    """A spec argument's identity: a tensor's id, a Term's key."""
    return t.key() if isinstance(t, Term) else id(t)


def spec_key(spec: Spec) -> tuple:
    """What makes two specs one reduction: the op, the identity of each
    tensor or term it reads, and the rest as it is."""
    op, data, mask, unsigned = spec
    if op == "fsumx":
        x, y, power = data
        return op, _ident(x), _ident(y), power, id(mask), unsigned
    return op, _ident(data), id(mask), unsigned


# op -> csrc/segment_reduce.cu SegOp (a float sum is OP_FSUM)
_OPS = {"sum": 0, "min": 1, "max": 2, "any": 3, "bor": 4, "band": 5,
        "bxor": 6, "count": 7, "fsumx": 9}
_FSUM = 8
# what a reduction reads of a source (FormKind), and a Term's op (TermOp)
_INT, _KEY, _DBL = 0, 1, 2
_TERMS = {"div": 1, "mod": 2}
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

def segment_reduce(op: str, data, mask: Optional[torch.Tensor],
                   perm: torch.Tensor, gid: torch.Tensor, cap_g: int, *,
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
                      column's narrow storage is read as it is), or a
                      Term of such a column; None for count
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
    launches K6 once for all the specs (each distinct source column
    gathered once, each distinct mask read once, each Term formed in
    registers), or once for each K6_MAX_SPECS reductions, K6_MAX_DATA
    source columns, K6_MAX_FORMS forms of them or K6_MAX_MASKS masks.
    """
    if perm.shape != gid.shape or perm.dtype != torch.int32:
        raise ValueError("segment_reduce: perm and gid must be int32 of one "
                         "length")
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise ValueError("segment_reduce: gid must be 1-d int32")
    return _segment_reduce_entry(specs, perm, gid, cap_g, group_rows,
                                 None, gid.shape[0])


def segment_reduce_sorted(specs: Sequence[Spec], starts: torch.Tensor,
                          ends: torch.Tensor, n: int, *,
                          group_rows: Optional[torch.Tensor] = None
                          ) -> List[torch.Tensor]:
    """K6's sorted-order entry (the reference's seg_reduce_sorted over data
    Grouping.take already put in sorted order): :func:`segment_reduce_many`
    with each spec's data and mask in SORTED order, row i at sorted
    position i, n rows, and the groups given by their bounds: starts and
    ends, K5's (cap_g,) int64 [start, end) of each slot, the groups one
    after another from row 0 (starts does not decrease; slots past the
    last group hold the valid row count; the rows from ends[-1] on have no
    slot).  No permutation and no group id is read; `any` is the first
    masked-in row in sorted order.

    A CPU tensor takes the plain version (over gid_of_bounds' group ids,
    which raises where the bounds break that layout); a CUDA tensor
    launches K6 with no permutation (counted as ``segment_reduce_sorted``),
    which does not check the layout.
    """
    cap_g = starts.shape[0]
    for t in (starts, ends):
        if t.dim() != 1 or t.dtype != torch.int64 or t.shape[0] != cap_g \
                or t.device != starts.device:
            raise ValueError("segment_reduce_sorted: starts and ends must be "
                             "1-d int64 of one length on one device")
    return _segment_reduce_entry(specs, None, None, cap_g, group_rows,
                                 (starts, ends), int(n))


def _check_bounds(starts: torch.Tensor, ends: torch.Tensor, n: int):
    """Raise unless the bounds follow K5's layout, as the sorted-order
    entry assumes: the groups one after another from row 0 with no gap
    (starts[0] == 0, starts[g + 1] == ends[g], starts <= ends) within n
    rows.  K6 does not check it: it would credit the rows of a gap to the
    group before it."""
    if not starts.shape[0]:
        return
    if (starts[0] != 0 or (starts[1:] != ends[:-1]).any()
            or (ends < starts).any() or ends[-1] > n):
        raise ValueError("segment_reduce_sorted: the groups' bounds must "
                         "follow one another from row 0 with no gap")


def gid_of_bounds(starts: torch.Tensor, ends: torch.Tensor,
                  n: int) -> torch.Tensor:
    """The group slot of each of n sorted rows from the groups' bounds (as
    segment_reduce_sorted takes them): the last slot starting at or
    before the row, cap_g for the rows from ends[-1] on (int32)."""
    _check_bounds(starts, ends, n)
    cap_g = starts.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=starts.device)
    if not cap_g:
        return torch.zeros(n, dtype=torch.int32, device=starts.device)
    g = torch.searchsorted(starts, pos, right=True) - 1
    return torch.where(pos < ends[-1], g, cap_g).to(torch.int32)


def bounds_of_gid(gid: torch.Tensor, cap_g: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(starts, ends) of the group slots of sorted rows' ascending group ids
    (cap_g or more for the rows without a slot, which come last): K5's
    bounds of the same groups."""
    in_slot = gid < cap_g
    live = gid[in_slot].to(torch.int64)
    if not in_slot[:live.shape[0]].all() or (live[1:] < live[:-1]).any():
        raise ValueError("bounds_of_gid: group ids must ascend, the rows "
                         "without a slot last")
    counts = torch.bincount(live, minlength=cap_g)[:cap_g]
    ends = torch.cumsum(counts, 0)
    return ends - counts, ends


def _segment_reduce_entry(specs, perm, gid, cap_g, group_rows, bounds, n):
    specs = [_checked_spec(sp) for sp in specs]
    dev = gid.device if bounds is None else bounds[0].device
    for op, data, mask, _ in specs:
        for t in _tensors(op, data) + [mask]:
            if t is not None and _source(t).shape[0] != n \
                    and perm is None:
                raise ValueError("segment_reduce_sorted: data and masks "
                                 "must have a row a sorted position")
    if dev.type == "cpu":
        if bounds is not None:
            gid = gid_of_bounds(bounds[0], bounds[1], n)
        return [_segment_reduce_plain(op, data, mask, perm, gid, cap_g, uns)
                for op, data, mask, uns in specs]
    if dev.type != "cuda":
        raise RuntimeError(f"segment_reduce: no kernel for {dev}")
    return _segment_reduce_many_cuda(specs, perm, gid, cap_g, group_rows,
                                     bounds, n)


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
        return op, data, mask, (_unsigned(x, ux), _unsigned(y, uy))
    if data is not None and op in _BITOPS and _is_float(data):
        raise TypeError(f"segment_reduce: {op} needs integer data")
    return op, data, mask, _unsigned(data, unsigned)


def _unsigned(t, unsigned) -> bool:
    """Whether t holds UInt64 bits: int64 data said to (a Term is
    signed)."""
    return bool(unsigned) and isinstance(t, torch.Tensor) \
        and t.dtype == torch.int64


@dataclasses.dataclass
class _Launch:
    """One launch of K6: its source columns, the forms it reads of them
    (source slot, kind, term, c, unsigned), its masks, the mask slot of
    each count it keeps (-1: every row), each reduction as (spec index,
    form slot or -1, mask slot or -1), and each reduction's second form
    slot (an fsumx term's y; -1: none)."""
    data: List[torch.Tensor] = dataclasses.field(default_factory=list)
    forms: List[Tuple[int, int, int, int, bool]] = dataclasses.field(
        default_factory=list)
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


def _form(t, kind: int, unsigned: bool):
    """(source column, kind, term, c, unsigned) of what a reduction reads
    of t: a Term's source with its op and constant, or t as stored
    (unsigned only where it changes the key or the double)."""
    if isinstance(t, Term):
        return t.source, kind, _TERMS[t.op], t.c, False
    return t, kind, 0, 0, bool(unsigned) and kind != _INT


def _reads(op: str, data, unsigned) -> list:
    """The forms a reduction reads: its value's (an fsumx term's x and y);
    none for `any`, which keeps a row id, and for count."""
    if op in ("any", "count"):
        return []
    if op == "fsumx":
        x, y, _ = data
        return [_form(x, _DBL, unsigned[0])] + (
            [] if y is None else [_form(y, _DBL, unsigned[1])])
    kind = _KEY if op in ("min", "max") else \
        _DBL if _is_float(data) else _INT
    return [_form(data, kind, unsigned)]


def _plan_launches(specs: Sequence[Spec], have_group_rows: bool
                   ) -> Tuple[List[_Launch], List[Tuple[int, int, int]]]:
    """K6's launches for the checked specs, and where each spec's result
    lies: (launch or -1, reduction slot or -1, count slot or -1).  A count
    spec and the ops of COUNTED_OPS need their mask's count, except over
    every row where group_rows gives it.  Source columns are one where K6
    reads one tensor (a Term reads its source), forms one where they read
    one source alike (kind, term, constant)."""
    launches: List[_Launch] = []
    where = []
    for (op, data, mask, uns) in specs:
        reduces = op != "count"
        counted = op in COUNTED_OPS and not (mask is None and have_group_rows)
        if not reduces and not counted:
            where.append((-1, -1, -1))
            continue
        reads = _reads(op, data, uns)
        cur = launches[-1] if launches else None

        def grows(launch):
            """(new sources, new forms) the spec adds to launch."""
            srcs = list(launch.data)
            keys = [(_same_tensor(launch.data[f[0]]),) + tuple(f[1:])
                    for f in launch.forms]
            n_src = n_form = 0
            for src, *rest in reads:
                if _is_new(srcs, src):
                    srcs.append(src)
                    n_src += 1
                k = (_same_tensor(src),) + tuple(rest)
                if k not in keys:
                    keys.append(k)
                    n_form += 1
            return n_src, n_form
        if cur is not None:
            n_src, n_form = grows(cur)
        if cur is None \
                or len(cur.specs) + reduces > _native.K6_MAX_SPECS \
                or len(cur.data) + n_src > _native.K6_MAX_DATA \
                or len(cur.forms) + n_form > _native.K6_MAX_FORMS \
                or len(cur.masks) + _is_new(cur.masks, mask) \
                > _native.K6_MAX_MASKS:
            cur = _Launch()
            launches.append(cur)
        slots = []
        for src, *rest in reads:
            f = (_slot(cur.data, src),) + tuple(rest)
            if f not in cur.forms:
                cur.forms.append(f)
            slots.append(cur.forms.index(f))
        slots += [-1, -1]
        m = _slot(cur.masks, mask)
        c = -1
        if counted:
            if m not in cur.counts:
                cur.counts.append(m)
            c = cur.counts.index(m)
        q = -1
        if reduces:
            cur.specs.append((len(where), slots[0], m))
            cur.second.append(slots[1])
            q = len(cur.specs) - 1
        where.append((len(launches) - 1, q, c))
    return launches, where


def _tensors(op: str, data) -> list:
    """The columns or Terms a reduction takes (none for count)."""
    if op == "fsumx":
        return [t for t in data[:2] if t is not None]
    return [] if data is None else [data]


def _contiguous(t):
    if isinstance(t, Term):
        return dataclasses.replace(t, source=t.source.contiguous())
    return None if t is None else t.contiguous()


def _k6_form(slot, kind, term, c, uns) -> "_native.K6Form":
    """ChttSegForm of a planned form: a Term's divisor as the host's
    multiplier of |c| (calendar_ops.magic) and its two shifts."""
    if not term:
        return _native.K6Form(data=slot, kind=kind, uns=int(uns))
    m, l = magic(abs(c), 32)
    return _native.K6Form(data=slot, kind=kind, term=term, c=c,
                          magic=m, shift1=min(l, 1), shift2=max(l - 1, 0))


def _segment_reduce_many_cuda(specs, perm, gid, cap_g, group_rows, bounds,
                              n):
    dev = gid.device if bounds is None else bounds[0].device
    checked = []
    for op, data, mask, uns in specs:
        cols = [_source(t) for t in _tensors(op, data)]
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
            data = (_contiguous(x), _contiguous(y), power)
        else:
            data = _contiguous(data)
        checked.append((op, data, _contiguous(mask), uns))
    if group_rows is not None and (group_rows.shape != (cap_g,)
                                   or group_rows.device != dev):
        raise ValueError("segment_reduce: group_rows must be (cap_g,) on "
                         "the group ids' device")
    launches, where = _plan_launches(checked, group_rows is not None)
    if bounds is None:
        perm = _native.aligned16(perm.contiguous())
        gid = _native.aligned16(gid.contiguous())
    else:
        starts, ends = (t.contiguous() for t in bounds)
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
            n=n, cap_g=cap_g, n_specs=len(launch.specs),
            n_data=len(launch.data), n_forms=len(launch.forms),
            n_masks=len(launch.masks), n_counts=len(launch.counts))
        if bounds is None:
            args.perm, args.gid = perm.data_ptr(), gid.data_ptr()
        else:
            args.starts, args.ends = starts.data_ptr(), ends.data_ptr()
        for d, t in enumerate(launch.data):
            args.data[d] = t.data_ptr()
            args.dtype[d] = _native.dtype_code(t.dtype)
        for f, form in enumerate(launch.forms):
            args.form[f] = _k6_form(*form)
        for m, t in enumerate(launch.masks):
            args.mask[m] = t.data_ptr()
        for c, m in enumerate(launch.counts):
            args.count[c] = _native.K6Count(mask=m, out=cnt[c].data_ptr())
        for q, ((i, f, m), f2) in enumerate(zip(launch.specs,
                                                launch.second)):
            op, data, _, uns = checked[i]
            code = _FSUM if op == "sum" and _is_float(data) \
                else _OPS[op]
            args.spec[q] = _native.K6Spec(
                op=code, form=f, mask=m, form2=f2,
                pow=data[2] if op == "fsumx" else 1, acc=acc[q].data_ptr())
        rc = _native.library().chtt_segment_reduce(ctypes.byref(args),
                                                   stream)
        _native.check(rc, "segment_reduce")
        _native.count_launch("segment_reduce" if bounds is None
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
        return acc.view(torch.float64) if _is_float(data) else acc
    if op not in COUNTED_OPS:                     # bor, bxor
        return acc.to(data.dtype)
    have = cnt > 0
    zero = torch.zeros((), dtype=data.dtype, device=acc.device)
    if op in ("min", "max"):
        v = _from_order_key(acc, data.dtype, unsigned)
    elif op == "any":
        n = _source(data).shape[0]
        rows = torch.clamp(acc, 0, max(n - 1, 0))
        v = data.index_select(0, rows) if n \
            else zero.expand(acc.shape)
    else:                                         # band
        v = acc.to(data.dtype)
    return torch.where(have, v, zero)


def _segment_reduce_plain(op, data, mask, perm, gid, cap_g, unsigned):
    """Plain PyTorch version of K6 (the same states as the kernel, each
    group reduced in sorted row order); perm None: the sorted-order entry's
    (row i is sorted position i).  A Term is its built column."""
    dev = gid.device
    if op == "fsumx":
        op, data, unsigned = "sum", fsumx_column(data, unsigned), False
    data = _built(data)
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
