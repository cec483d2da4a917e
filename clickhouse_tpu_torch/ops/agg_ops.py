"""Grouping machinery: the sort, dense and trivial GROUP BY kinds, and K1.

Reference: clickhouse_tpu/ops/agg_ops.py.  Its three grouping kinds:

  * sort    -- generic (unbounded keys, min/max/any, or
               group_by_algorithm='sort'): a stable sort of the rows by
               (invalid, keys...) with K4 (``sort_ops.sort_rows``), group
               ids and segment bounds with K5, reductions with K6
               (``scan_ops``: :meth:`Grouping.reduce_many` takes every
               aggregate of a GROUP BY to one launch); groups come out in
               ascending key order, the NULL group first;
  * dense   -- provably-small key space (interval analysis): the slot is a
               mixed-radix function of the keys; counts and integer sums run
               in one pass of K2 (``mxu_segsum.dense_group_reduce``);
  * trivial -- GROUP BY (): masked whole-column reductions, K1
               (:func:`masked_reduce`).

Unsigned values ride as signed bit patterns (u16 in int32, u32 and u64 in
int64), so a reduction whose order matters for 64-bit unsigned values
(min/max) takes ``unsigned=True``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.errors import MemoryLimitExceeded
from . import _native, mxu_segsum, scan_ops, sort_ops

__all__ = ["Grouping", "RowMask", "Term", "group_by_sort", "group_by_dense",
           "dense_group_bytes", "group_trivial", "masked_reduce",
           "ReduceSpec"]

_OPS = {"sum": 0, "min": 1, "max": 2, "any": 3, "bor": 4, "band": 5,
        "bxor": 6}
# one reduction of Grouping.reduce_many: (op, data, mask, unsigned); the
# mask a bool tensor, a RowMask or None
ReduceSpec = Tuple[str, Optional[torch.Tensor], object, bool]
_BITOPS = ("bor", "band", "bxor")
_SIGN = -(1 << 63)                 # int64 bits of 1 << 63
_I64_MAX = (1 << 63) - 1


# -- K1: masked reduction ---------------------------------------------------

_CMP_FN = {"equals": torch.eq, "notEquals": torch.ne, "less": torch.lt,
           "lessOrEquals": torch.le, "greater": torch.gt,
           "greaterOrEquals": torch.ge}
_U64 = (1 << 64) - 1
# K1's term modes (csrc/masked_reduce.cu TM_*)
_TM_I32, _TM_K64, _TM_F32, _TM_F64 = range(4)
_COUNT = 7                         # OP_COUNT of csrc/masked_reduce.cu
_RUN = 16                          # rows a thread of K1 takes at a time
_NARROW_RANGE = {torch.bool: (0, 1), torch.uint8: (0, 255),
                 torch.int8: (-128, 127), torch.int16: (-32768, 32767),
                 torch.int32: (-(1 << 31), (1 << 31) - 1)}


@dataclasses.dataclass(frozen=True)
class Term:
    """One `column CMP constant` of a filter, as K1 evaluates it.

    The column's values are read from `storage` (its tensor, possibly
    narrower than its logical numpy type `logical`: core/column.py
    narrow_storage), cast to `compare` (numpy.promote_types of the column's
    and the constant's types) and compared with `constant`, the literal
    already cast to `compare` (int64 bits for uint64), exactly as
    exprs/functions.py _cmp_exec and the executor's _bool_mask do: unsigned
    64-bit values compare as unsigned, NaN compares false except under
    notEquals, and a NULL row (validity 0) never passes.
    """
    storage: torch.Tensor              # (capacity,)
    validity: Optional[torch.Tensor]   # (capacity,) uint8, or None
    logical: np.dtype
    cmp: str                           # a key of _CMP_FN
    compare: np.dtype
    constant: Union[int, float]

    def evaluate(self) -> torch.Tensor:
        """The rows that pass, in plain torch (bool (capacity,))."""
        x = self.storage.to(dt.torch_dtype_of(self.logical))
        x = dt.cast_tensor(x, self.logical, self.compare)
        c = torch.tensor(self.constant, dtype=dt.torch_dtype_of(self.compare))
        if self.compare == np.uint64:      # unsigned order of int64 bits
            x, c = x ^ _SIGN, c ^ _SIGN
        out = _CMP_FN[self.cmp](x, c)
        if self.validity is not None:
            out = out & self.validity.to(torch.bool)
        return out


def _selection(n: int, device, mask: Optional[torch.Tensor], n_rows: int,
               terms: Sequence[Term]) -> torch.Tensor:
    """Rows below n_rows where `mask` holds and every term passes."""
    sel = torch.zeros(n, dtype=torch.bool, device=device)
    sel[:max(min(n_rows, n), 0)] = True       # a fill, not an int64 index
    if mask is not None:
        sel = sel & mask.to(torch.bool)
    for t in terms:
        sel = sel & t.evaluate()
    return sel


@dataclasses.dataclass
class RowMask:
    """A block's row mask, kept as the parts K1 takes until a consumer needs
    a tensor: the rows below `n_rows` where `mask` holds (None: every row)
    and every term passes.  GROUP BY () reductions and counts hand the parts
    to K1; :meth:`tensor` builds the bool mask (plain torch) for the rest."""
    capacity: int
    device: torch.device
    n_rows: int
    terms: Tuple[Term, ...] = ()
    mask: Optional[torch.Tensor] = None
    _tensor: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def of(cls, valid: torch.Tensor) -> "RowMask":
        """The row mask that a bool tensor gives."""
        n = valid.shape[0]
        return cls(n, valid.device, n, (), valid, valid)

    def tensor(self) -> torch.Tensor:
        if self._tensor is None:
            self._tensor = _selection(self.capacity, self.device, self.mask,
                                      self.n_rows, self.terms)
        return self._tensor

    def and_mask(self, m: torch.Tensor) -> "RowMask":
        return RowMask(self.capacity, self.device, self.n_rows, self.terms,
                       m if self.mask is None else self.mask & m)

    def and_term(self, t: Term) -> "RowMask":
        return RowMask(self.capacity, self.device, self.n_rows,
                       self.terms + (t,), self.mask)

    def reduce(self, op: str, data: Optional[torch.Tensor], *,
               unsigned: bool = False) -> torch.Tensor:
        """masked_reduce over these rows (data None: their count)."""
        if data is None and self.mask is None and not self.terms:
            return torch.full((), min(self.n_rows, self.capacity),
                              dtype=torch.int64, device=self.device)
        return masked_reduce(op, data, self.mask, unsigned=unsigned,
                             n_rows=self.n_rows, terms=self.terms)

    def count(self) -> torch.Tensor:
        return self.reduce("sum", None)


def masked_reduce(op: str, data: Optional[torch.Tensor],
                  mask: Optional[torch.Tensor] = None, *,
                  unsigned: bool = False, n_rows: Optional[int] = None,
                  terms: Sequence[Term] = ()) -> torch.Tensor:
    """Reduce the selected rows of `data`: the rows below `n_rows` (all if
    None) where `mask` holds (all if None) and every term passes.

    op: sum | min | max | any | bor | band | bxor; with data None, sum
    counts the selected rows.  Returns a 0-d tensor: int64 for counts and
    integer and bool sums (wrapping mod 2^64), float64 for float sums, the
    data's dtype otherwise.  min/max/any/bit ops give 0 when no row is
    selected; `any` is the first selected row; float min/max order -0.0
    below +0.0 and propagate NaN.  `unsigned` marks int64 data that holds
    UInt64 bits.  At most _native.K1_MAX_TERMS terms.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (csrc/masked_reduce.cu).
    """
    if op not in _OPS:
        raise ValueError(f"masked_reduce: unknown op {op!r}")
    if data is None and op != "sum":
        raise ValueError(f"masked_reduce: {op} needs data")
    if data is not None and op in _BITOPS and data.is_floating_point():
        raise TypeError(f"masked_reduce: {op} needs integer data")
    if len(terms) > _native.K1_MAX_TERMS:
        raise ValueError(f"masked_reduce: more than {_native.K1_MAX_TERMS} "
                         f"terms")
    first = next((t for t in [data, mask] + [t.storage for t in terms]
                  if t is not None), None)
    if first is None:
        raise ValueError("masked_reduce: no data, mask or term to read")
    n = first.shape[0]
    n_rows = n if n_rows is None else max(0, min(int(n_rows), n))
    unsigned = bool(unsigned) and data is not None \
        and data.dtype == torch.int64
    if first.device.type == "cpu":
        return _masked_reduce_plain(op, data, mask, unsigned, n_rows, terms)
    if first.device.type != "cuda":
        raise RuntimeError(f"masked_reduce: no kernel for {first.device}")
    return _masked_reduce_cuda(op, data, mask, unsigned, n_rows, tuple(terms))


# K1's completion ticket of each (device, stream): one word, 0 between calls
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
_TICKETS_LOCK = threading.Lock()


def _ticket(dev, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    with _TICKETS_LOCK:
        if key not in _TICKETS:
            _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
        return _TICKETS[key]


def _f64_key(d: float) -> int:
    """csrc/common.cuh f64_order_key of d (after -0.0 -> +0.0)."""
    b = struct.unpack("<Q", struct.pack("<d", 0.0 if d == 0 else d))[0]
    return (~b & _U64) if b >> 63 else (b | (1 << 63))


def _key_range(cmp: str, k: int) -> Optional[Tuple[int, int]]:
    """[lo, hi] of the u64 keys x with `x CMP k` (notEquals: of x == k);
    None if there is none."""
    if cmp in ("equals", "notEquals"):
        return k, k
    if cmp == "less":
        return (0, k - 1) if k > 0 else None
    if cmp == "lessOrEquals":
        return 0, k
    if cmp == "greater":
        return (k + 1, _U64) if k < _U64 else None
    return k, _U64


def _k1_term(t: Term, head: int) -> "_native.K1Term":
    """The kernel's form of a term: `CMP constant` as a range of keys."""
    neg = t.cmp == "notEquals"
    nan_pass = 0
    xorv = 0
    if t.compare.kind == "f":
        mode = _TM_F32 if t.compare == np.float32 else _TM_F64
        nan_pass = int(neg)        # NaN != c; every other CMP is false
        c = float(t.constant)      # c NaN: x != c for every x, else none
        rng = None if math.isnan(c) else _key_range(t.cmp, _f64_key(c))
    elif t.compare == np.uint64:
        mode = _TM_K64
        rng = _key_range(t.cmp, int(t.constant) & _U64)
    else:
        xorv = 1 << 63
        rng = _key_range(t.cmp, (int(t.constant) & _U64) ^ xorv)
        mode = _TM_K64
        if t.storage.dtype in _NARROW_RANGE:
            # the values lie in the storage type's range: test in 32 bits
            mode = _TM_I32
            smin, smax = _NARROW_RANGE[t.storage.dtype]
            if rng is not None:
                lo, hi = max(rng[0] - xorv, smin), min(rng[1] - xorv, smax)
                rng = (lo, hi) if lo <= hi else None
    if rng is None:                # nothing in range: all, negated
        rng, neg = (0, _U64), not neg
    lo, span = rng[0], rng[1] - rng[0]
    if mode == _TM_I32:
        lo, span = lo & 0xFFFFFFFF, min(span, 0xFFFFFFFF)
    return _native.K1Term(
        col=t.storage.data_ptr(),
        valid=None if t.validity is None else t.validity.data_ptr(),
        lo=lo & _U64, span=span, xorv=xorv,
        dtype=_native.dtype_code(t.storage.dtype), mode=mode, neg=int(neg),
        nan_pass=nan_pass, u64src=int(t.logical == np.uint64),
        vec=_vec(t.storage, head),
        valid_vec=0 if t.validity is None else _vec(t.validity, head))


def _vec(t: torch.Tensor, head: int) -> int:
    """1 if rows head, head + 16, ... of t start on 16-byte boundaries."""
    return int((t.data_ptr() + head * t.element_size()) % 16 == 0)


def _masked_reduce_cuda(op, data, mask, unsigned, n_rows, terms):
    cols = [data, mask] + [c for t in terms for c in (t.storage, t.validity)]
    cols = [c for c in cols if c is not None]
    dev = cols[0].device
    n = cols[0].shape[0]
    for c in cols:
        if c.dim() != 1 or c.shape[0] != n or c.device != dev \
                or not c.is_contiguous():
            raise ValueError("masked_reduce: data, mask and term columns "
                             "must be contiguous 1-d tensors of one length "
                             "on one device")
        if c.data_ptr() % c.element_size():
            raise ValueError("masked_reduce: a column is not aligned to its "
                             "element size")
    if mask is not None and mask.dtype != torch.bool:
        raise ValueError("masked_reduce: mask must be bool")
    for t in terms:
        if t.validity is not None and t.validity.dtype not in (torch.uint8,
                                                               torch.bool):
            raise ValueError("masked_reduce: term validity must be uint8")
    if data is None:
        out_dtype = torch.int64
    elif op == "sum":
        out_dtype = torch.float64 if data.is_floating_point() \
            else torch.int64
    else:
        out_dtype = data.dtype
    out = torch.empty((), dtype=out_dtype, device=dev)
    # the body starts where the widest column reaches a 16-byte boundary;
    # rows before it (the head) and after the last full run are read singly
    wide = max(cols, key=lambda c: c.element_size())
    head = min((-wide.data_ptr()) % 16 // wide.element_size(), n_rows)
    runs = (n_rows - head + _RUN - 1) // _RUN + (head > 0)
    nb = _native.grid_blocks(dev, runs, per_sm=4)
    partials = torch.empty(2 * nb, dtype=torch.int64, device=dev)
    stream = _native.stream_ptr(dev)
    args = _native.K1Args(
        data=None if data is None else data.data_ptr(),
        mask=None if mask is None else mask.data_ptr(),
        out=out.data_ptr(), partials=partials.data_ptr(),
        ticket=_ticket(dev, stream).data_ptr(), n=n_rows, head=head,
        dtype=0 if data is None else _native.dtype_code(data.dtype),
        data_vec=0 if data is None else _vec(data, head),
        mask_vec=0 if mask is None else _vec(mask, head),
        uns=int(unsigned), n_terms=len(terms))
    for i, t in enumerate(terms):
        args.terms[i] = _k1_term(t, head)
    rc = _native.library().chtt_masked_reduce(
        ctypes.byref(args), _COUNT if data is None else _OPS[op], nb, stream)
    _native.check(rc, "masked_reduce")
    _native.count_launch("masked_reduce", n_rows)
    return out


def _f64_order_key(x: torch.Tensor) -> torch.Tensor:
    """Float -> int64 whose SIGNED order is the IEEE total order."""
    bits = x.to(torch.float64).view(torch.int64)
    return torch.where(bits < 0, bits ^ _I64_MAX, bits)


def _f64_order_unkey(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k < 0, k ^ _I64_MAX, k).view(torch.float64)


def _fold_bits(op: str, x: torch.Tensor, ident: int) -> torch.Tensor:
    """Bitwise OR/AND/XOR of all elements by pairwise halving."""
    fn = {"bor": torch.bitwise_or, "band": torch.bitwise_and,
          "bxor": torch.bitwise_xor}[op]
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_full((1,), ident)])
        x = fn(x[0::2], x[1::2])
    return x.reshape(()) if x.numel() else x.new_full((), ident)


def _masked_reduce_plain(op: str, data: Optional[torch.Tensor],
                         mask: Optional[torch.Tensor],
                         unsigned: bool = False, n_rows: Optional[int] = None,
                         terms: Sequence[Term] = ()) -> torch.Tensor:
    """Plain PyTorch version of K1 (same contract as masked_reduce)."""
    first = next(t for t in [data, mask] + [t.storage for t in terms]
                 if t is not None)
    dev = first.device
    n = first.shape[0]
    mask = _selection(n, dev, mask, n if n_rows is None else n_rows, terms)
    if data is None:
        return mask.sum()
    selected = mask.any()
    zero = torch.zeros((), dtype=data.dtype, device=dev)
    if op == "sum":
        if data.is_floating_point():
            acc = data.to(torch.float64)
            return torch.where(mask, acc, torch.zeros_like(acc)).sum()
        acc = data.to(torch.int64)
        return torch.where(mask, acc, torch.zeros_like(acc)).sum()
    if op == "any":
        idx = torch.argmax(mask.to(torch.uint8))
        return torch.where(selected, data[idx], zero)
    if op in ("min", "max"):
        pick = torch.amin if op == "min" else torch.amax
        ident = _I64_MAX if op == "min" else -_I64_MAX - 1
        if data.is_floating_point():
            nan = (torch.isnan(data) & mask).any()
            key = _f64_order_key(data).masked_fill(
                ~mask | torch.isnan(data), ident)
            v = _f64_order_unkey(pick(key)).to(data.dtype)
            v = torch.where(nan, torch.full_like(v, float("nan")), v)
            return torch.where(selected, v, zero)
        key = data.to(torch.int64)
        if unsigned:
            key = key ^ _SIGN
        v = pick(key.masked_fill(~mask, ident))
        if unsigned:
            v = v ^ _SIGN
        return torch.where(selected, v.to(data.dtype), zero)
    ident = -1 if op == "band" else 0
    acc = data.to(torch.int64).masked_fill(~mask, ident)
    v = _fold_bits(op, acc, ident)
    return torch.where(selected, v.to(data.dtype), zero)


# -- groupings ---------------------------------------------------------------

@dataclasses.dataclass
class Grouping:
    """Group id of each (valid) row.

    kind='sort':    rows are key-sorted; group_ids (sorted order) are
                    ascending dense ranks; perm maps a sorted position to
                    its row; starts/ends give each group slot its rows.
    kind='dense':   slot is a function of the key; rows keep their order;
                    empty slots possible (`present` mask).
    kind='trivial': single global group at slot 0; no per-row group id
                    (group_ids None), reductions take the rows as a
                    RowMask or a bool tensor.

    group_ids carry num_groups_cap for padding/invalid rows (dropped by all
    reductions).
    """
    kind: str
    group_ids: Optional[torch.Tensor]  # int32 (None: trivial)
    num_groups: torch.Tensor           # 0-d int64
    unique_keys: List[torch.Tensor]    # each (num_groups_cap,)
    num_groups_cap: int
    present: Optional[torch.Tensor] = None     # (cap_g,) bool (dense only)
    perm: Optional[torch.Tensor] = None        # int32 (sort only)
    starts: Optional[torch.Tensor] = None      # (cap_g,) int64 (sort only)
    ends: Optional[torch.Tensor] = None        # (cap_g,) int64 (sort only)
    # the rows the grouping was built with (identity-checked: a reduction
    # over exactly these rows needs no mask)
    row_valid_ref: Optional[RowMask] = None
    # the keys ordering the rows within each group (sort only)
    secondary: Tuple[sort_ops.SortKey, ...] = ()
    # K16's row-order update's slot -> group table, built once by its first
    # user (sort only): (table,), or (None,) where a group's key leaves its
    # proven range
    slot_table: Optional[tuple] = None

    def group_valid(self) -> torch.Tensor:
        if self.present is not None:
            return self.present
        return torch.arange(self.num_groups_cap, dtype=torch.int64,
                            device=self.num_groups.device) < self.num_groups

    # -- row-order plumbing --------------------------------------------------
    def take(self, raw: torch.Tensor) -> torch.Tensor:
        """Raw row order -> sorted order (reference agg_ops.py:65): one
        gather by perm.  The reference permutes by sorting by the inverse
        permutation, a TPU workaround for slow random gathers; the card
        gathers."""
        return raw.index_select(0, self.perm)

    def sorted_mask(self, mask) -> Optional[torch.Tensor]:
        """A raw-order row mask in sorted order; None for the grouping's own
        rows (every sorted row of a group)."""
        m = self._sort_mask(mask)
        return None if m is None else self.take(m)

    def reduce_sorted(self, specs: Sequence[ReduceSpec]
                      ) -> List[torch.Tensor]:
        """Reductions of data and masks already in sorted order (reference
        agg_ops.py:109), specs as :meth:`reduce_many` takes them: ONE
        scan_ops.segment_reduce_sorted call (K6's sorted-order entry),
        which takes the groups as their bounds and reads no group id."""
        return scan_ops.segment_reduce_sorted(
            specs, self.starts, self.ends, self.perm.shape[0],
            group_rows=self.ends - self.starts)

    # -- reductions ----------------------------------------------------------
    def reduce(self, op: str, data: torch.Tensor, mask, *,
               unsigned: bool = False) -> torch.Tensor:
        """Per-group reduction over the rows where `mask` (a bool tensor,
        or a RowMask for the trivial and sort groupings) holds; data and
        mask in raw row order."""
        if self.kind == "trivial":
            return self._reduce_trivial(op, data, mask, unsigned)
        if self.kind == "sort":
            return self.reduce_many([(op, data, mask, unsigned)])[0]
        return self._reduce_dense(op, data, mask)

    def count_rows(self, mask) -> torch.Tensor:
        """Rows per group (int64)."""
        if self.kind == "dense":
            return self.dense_counts(mask)
        if self.kind == "sort":
            if mask is self.row_valid_ref:
                # the grouping already segregated exactly these rows
                return self.ends - self.starts
            return self.reduce_many([("count", None, mask, False)])[0]
        return self._reduce_trivial("sum", None, mask)

    def reduce_many(self, specs: Sequence[ReduceSpec]
                    ) -> List[torch.Tensor]:
        """Several reductions, specs of (op, data, mask, unsigned) as
        :meth:`reduce` takes them, op "count" (data None) counting the rows
        where mask holds.  The sort grouping hands them all to ONE
        scan_ops.segment_reduce_many call (K6 once, with the groups' row
        counts from the bounds; a spec's data may be a scan_ops.Term,
        which K6 forms in registers); the other kinds reduce a spec at a
        time."""
        if self.kind != "sort":
            return [self.count_rows(m) if op == "count"
                    else self.reduce(op, d, m, unsigned=u)
                    for op, d, m, u in specs]
        return scan_ops.segment_reduce_many(
            [(op, d, self._sort_mask(m), u) for op, d, m, u in specs],
            self.perm, self.group_ids, self.num_groups_cap,
            group_rows=self.ends - self.starts)

    def _sort_mask(self, mask):
        """The mask K6 reads: None for the grouping's own rows (invalid rows
        have no group), else a bool (capacity,) tensor."""
        if mask is None or mask is self.row_valid_ref:
            return None
        if isinstance(mask, RowMask):
            return mask.tensor()
        return mask.to(torch.bool)

    def _reduce_trivial(self, op, data, mask, unsigned=False):
        if data is not None:
            data = data.contiguous()
        if isinstance(mask, RowMask):
            v = mask.reduce(op, data, unsigned=unsigned)
        else:
            v = masked_reduce(op, data, _mask_arg(mask, data),
                              unsigned=unsigned)
        out = torch.zeros((self.num_groups_cap,), dtype=v.dtype,
                          device=v.device)
        out[0] = v
        return out

    def _reduce_dense(self, op, data, mask):
        if op != "sum":
            raise ValueError(f"dense grouping cannot reduce '{op}'")
        if data.is_floating_point():
            raise ValueError("dense grouping sums integers only")
        cap_g = self.num_groups_cap
        ids = torch.clamp(self.group_ids, max=cap_g - 1)
        m = mask & (self.group_ids < cap_g)
        _, sums = mxu_segsum.mxu_counts_and_sums(ids, m, [(data, True)],
                                                 cap_g)
        return sums[0]

    def dense_counts(self, mask) -> torch.Tensor:
        cap_g = self.num_groups_cap
        ids = torch.clamp(self.group_ids, max=cap_g - 1)
        m = mask & (self.group_ids < cap_g)
        counts, _ = mxu_segsum.mxu_counts_and_sums(ids, m, [], cap_g)
        return counts


def _mask_arg(mask, data):
    if mask is None:
        return None
    if mask.dim() == 0:
        mask = mask.expand(data.shape)
    return mask.to(torch.bool).contiguous()


def group_by_sort(keys: Sequence[sort_ops.SortKey],
                  rows: Union[RowMask, torch.Tensor], num_groups_cap: int,
                  *, secondary: Sequence[sort_ops.SortKey] = (),
                  max_bytes: Optional[int] = None) -> Grouping:
    """Generic grouping: K4 sorts the rows stably by (invalid, keys...,
    secondary...), K5 finds the groups; unique keys are read at each
    group's first row.

    keys      -- the GROUP BY key arrays (a Nullable key as its validity,
                 then its data zeroed where NULL), with their signedness and
                 proven bounds; none: one group of every row (GROUP BY ()
                 with secondary keys)
    rows      -- the rows to group (a RowMask, or a bool mask); the others
                 belong to no group.  Where they are the first n rows, only
                 those are sorted, with no invalid flag
    secondary -- keys ordering the rows WITHIN each group (the reference's
                 group_by_sort(..., secondary=), agg_ops.py:200): packed
                 into words of their own, which K5 never compares, so they
                 never move a group's boundaries
    max_bytes -- the limit on the working set: the sort's
                 (sort_ops.sort_rows_bytes, the secondary keys' packed words
                 among its words), the key arrays, and K5's outputs and
                 scratch (scan_ops.segment_bounds_bytes)
    """
    if isinstance(rows, torch.Tensor):
        rows = RowMask.of(rows.to(torch.bool))
    cap = rows.capacity
    n = min(rows.n_rows, cap)
    scan_rows = rows.mask is None and not rows.terms and n > 0
    sorted_rows = n if scan_rows else cap
    held = scan_ops.segment_bounds_bytes(sorted_rows, num_groups_cap,
                                         len(keys) + 1) \
        + sum(sorted_rows * k.data.element_size()
              for k in list(keys) + list(secondary) if k.data.dim())
    if scan_rows:
        # a scan's rows: the first n, all valid
        def head(ks):
            return [dataclasses.replace(k, data=k.data[:n])
                    if k.data.dim() else k for k in ks]
        perm, sorted_keys = sort_ops.sort_rows(
            head(keys), None, secondary=head(secondary),
            max_bytes=max_bytes, held_bytes=held)
        n_valid = torch.full((), n, dtype=torch.int64, device=rows.device)
    else:
        perm, sorted_keys = sort_ops.sort_rows(
            keys, rows.tensor(), secondary=secondary, max_bytes=max_bytes,
            held_bytes=held)
        n_valid = rows.count()
    gid, num_groups, starts, ends = scan_ops.segment_bounds(
        sorted_keys, n_valid, num_groups_cap)
    first = perm.index_select(
        0, torch.clamp(starts, 0, max(perm.shape[0] - 1, 0)))
    unique_keys = [k.data.expand(cap).index_select(0, first) for k in keys]
    return Grouping(kind="sort", group_ids=gid, num_groups=num_groups,
                    unique_keys=unique_keys, num_groups_cap=num_groups_cap,
                    perm=perm, starts=starts, ends=ends,
                    row_valid_ref=rows, secondary=tuple(secondary))


def reversed_rows(g: Grouping, capacity: int) -> Grouping:
    """The sort grouping g over data of `capacity` rows in reverse row
    order (the data's row i is g's row capacity - 1 - i): perm mapped so,
    every row one of its rows.  A reduction that keeps one row by its
    lowest row id (`any`, argMin/argMax's merge at ties) then keeps each
    group's newest row."""
    return dataclasses.replace(
        g, perm=(capacity - 1) - g.perm,
        row_valid_ref=RowMask(capacity, g.perm.device, capacity),
        slot_table=None)


def narrow_groups(g: Grouping, slots: int) -> Grouping:
    """The sort grouping g over its first `slots` group slots, which hold
    every group (slots >= g.num_groups): the same rows, groups and order,
    fewer empty slots (an aggregate whose state is wide a slot: -State of
    uniq, 4,096 bytes a slot)."""
    gid = torch.clamp(g.group_ids, max=slots)
    return dataclasses.replace(
        g, group_ids=gid, num_groups_cap=slots, starts=g.starts[:slots],
        ends=g.ends[:slots], unique_keys=[k[:slots] for k in g.unique_keys],
        slot_table=None)


# device bytes a row of the dense grouping and its K2 pass hold at their
# peak, counted as if all were live at once: the int64 slot array and one
# key's int64 offsets beside it (16), the int32 ids (4), and the dense
# stage's row mask, its comparison and its clamped int32 ids (1 + 1 + 4,
# exec/executor.py _dense_stage1)
DENSE_ROW_BYTES = 26


def dense_group_bytes(cap: int, held_bytes: int = 0) -> int:
    """The dense grouping's working set over `cap` rows (DENSE_ROW_BYTES a
    row) and the caller's `held_bytes` (K2's summed values, masks and
    outputs)."""
    return DENSE_ROW_BYTES * cap + held_bytes


def group_by_dense(keys: Sequence[torch.Tensor],
                   dims: Sequence[Tuple[int, int]],
                   row_valid: torch.Tensor, num_groups_cap: int,
                   present: Optional[torch.Tensor] = None, *,
                   max_bytes: Optional[int] = None,
                   held_bytes: int = 0) -> Grouping:
    """Direct-array grouping: slot computed from the key.

    dims[i] = (lo_i, size_i) proven bounds per key array; the first key
    varies fastest.  `present`/num_groups are filled in by the caller from
    the dense counts.  max_bytes: raise MemoryLimitExceeded, before
    allocating, where dense_group_bytes (the slots, the ids, the dense
    stage's passes and the caller's `held_bytes`) is larger.  The slots
    are computed in place (int32 for keys of at most 32 bits, else int64),
    one key's offsets beside them.
    """
    cap = keys[0].shape[0]
    dev = keys[0].device
    total = 1
    for _, size in dims:
        total *= size
    if total > num_groups_cap:
        raise ValueError("dense grouping exceeds capacity")
    if max_bytes is not None:
        need = dense_group_bytes(cap, held_bytes)
        if need > max_bytes:
            raise MemoryLimitExceeded(
                f"grouping {cap} rows densely would need {need} bytes of "
                f"device memory ({max(max_bytes, 0)} bytes of the budget "
                f"left)")
    slot = None
    stride = 1
    # keys of at most 32 bits give int32 slots (a valid row's key lies in
    # its dims; an invalid row's slot is overwritten below)
    wide = torch.int32 if num_groups_cap < 2**31 and all(
        k.dtype in (torch.bool, torch.uint8, torch.int8, torch.int16,
                    torch.int32) for k in keys) else torch.int64
    for k, (lo, size) in zip(keys, dims):
        d = k.to(wide, copy=True).sub_(lo).clamp_(0, size - 1)
        if stride != 1:
            d.mul_(stride)
        slot = d if slot is None else slot.add_(d)
        del d
        stride *= size
    slot.masked_fill_(~row_valid, num_groups_cap)
    ids = slot.to(torch.int32)
    del slot
    uks = []
    idx = torch.arange(num_groups_cap, dtype=torch.int64, device=dev)
    stride = 1
    for k, (lo, size) in zip(keys, dims):
        uks.append(((idx // stride) % size + lo).to(k.dtype))
        stride *= size
    if present is None:
        present = torch.zeros((num_groups_cap,), dtype=torch.bool,
                              device=dev)
    return Grouping(kind="dense", group_ids=ids,
                    num_groups=present.to(torch.int64).sum(),
                    unique_keys=uks, num_groups_cap=num_groups_cap,
                    present=present)


def group_trivial(device, num_groups_cap: int = 1024) -> Grouping:
    """GROUP BY (): one global group, plain masked reductions.  No per-row
    group id; num_groups is filled in by the caller from the row count."""
    uk = torch.zeros((num_groups_cap,), dtype=torch.int32, device=device)
    return Grouping(kind="trivial", group_ids=None,
                    num_groups=torch.zeros((), dtype=torch.int64,
                                           device=device),
                    unique_keys=[uk], num_groups_cap=num_groups_cap)
