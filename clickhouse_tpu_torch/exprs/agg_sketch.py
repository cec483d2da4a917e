"""Sketch and array-valued aggregates (reference:
clickhouse_tpu/exprs/agg_sketch.py).

* ``uniq`` (uniqCombined, uniqCombined64, uniqHLL12, uniqTheta):
  HyperLogLog, :class:`HLLUniqAgg`.  Its state is (groups, m) uint8
  registers, the reference's limbs byte for byte; K16 (ops/sketch_ops.py)
  updates them from each row's hash over its arguments as stored (the
  query's grouping gives each row's group: GROUP BY (); under the sort
  grouping a slot of the keys' proven ranges, taken in row order, where
  every key has one and the slots are few, else the grouping's perm and
  group ids), merges partial states (the streamed carry) and finalizes
  them.  m follows the grouping's slots as the
  reference's _m_for_cap: 4,096 under GROUP BY () (1,024 slots), 64 at the
  sort grouping's 2^22.
* ``groupArray([N])``, ``groupUniqArray([N])`` (``groupArrayDistinct``):
  each group's first N values in row order (distinct: the first row of
  each value), an Array(T) of the group's rows gathered through the sort
  grouping's perm; with no N the width is the ``group_array_max_size``
  setting, and a wider group raises CapacityError naming it, so the
  session re-plans with the setting raised.
* ``topK(N)``: the reference's exact top-N (not ClickHouse's space-saving):
  each group's runs of equal values counted in the value-sorted rows, the
  runs sorted again by (group, -count) with K4, the first N of each group.
* ``entropy``: the Shannon entropy (bits) of each group's values, the sum
  over its runs of c log2(T / c) / T (c a run's rows, T the group's), in
  float64 with K6's sorted-order entry over the runs.

The holistic ones take the executor's holistic framework (``secondary``
sort keys and ``sorted_step``): under GROUP BY () an unmasked groupArray
reads the rows in order (K14), the rest sort their one group.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.errors import NotImplementedError_, TypeError_
from ..ops import agg_ops, filter_ops, scan_ops, sketch_ops, sort_ops
from ..ops.hash_ops import HashArg
from .aggregates import (AggregateFunction, GroupContext, _SortedValues,
                         _rows_of, _take, _take_mask, notm_key)
from .expr import ColVal, StoredColVal, TermColVal

__all__ = ["GroupArrayAgg", "GroupUniqArrayAgg", "TopKAgg", "EntropyAgg",
           "HLLUniqAgg", "hash_arg", "SIZED"]

# the aggregates whose parameter is a width (reference aggregates._SIZED)
SIZED = ("grouparray", "groupuniqarray", "grouparraydistinct", "topk")


def hash_arg(cv: ColVal) -> HashArg:
    """A column as K15 and K16 hash it: its storage (a dictionary's codes,
    a narrow column as stored, a Term formed in registers) and how its
    values become u64 bits (a float by its logical type's token)."""
    t = dt.remove_nullable(cv.dtype)
    if t.is_array or dt.is_map(t):
        raise TypeError_(f"Cannot hash a value of type {cv.dtype}")
    if isinstance(cv, TermColVal):
        return HashArg(cv.term, "int")
    data = cv.storage if isinstance(cv, StoredColVal) else cv.data
    kind = "f32" if t.np_dtype == np.float32 else \
        "f64" if t.np_dtype == np.float64 else "int"
    if kind == "int" and data.is_floating_point():
        raise TypeError_(f"Cannot hash {cv.dtype} stored as {data.dtype}")
    return HashArg(data, kind)


def _check_width(ctx: GroupContext, lens: torch.Tensor, width: int,
                 name: str) -> None:
    """A groupArray of no stated width: register that no group passes the
    group_array_max_size setting (the session re-plans with it raised)."""
    if ctx.checks is None:
        return
    from ..exec.executor import Check
    ctx.checks.append(Check(
        lens.max() if lens.numel() else torch.zeros((), dtype=torch.int64),
        width, f"{name} result exceeded group_array_max_size; raise the "
        "group_array_max_size setting", setting="group_array_max_size"))


def _prefix_matrix(values, rows_at, lens: torch.Tensor, starts: torch.Tensor,
                   width: int, dtype: torch.dtype, n: int) -> torch.Tensor:
    """mat[g, j] = the value at sorted position starts[g] + j for j <
    min(lens[g], width), else 0: (groups, width rounded up to 8), the
    positions read through rows_at (a sorted position -> its row)."""
    g = starts.shape[0]
    cols = -(-max(width, 1) // 8) * 8
    dev = starts.device
    j = torch.arange(width, dtype=torch.int64, device=dev)
    pos = torch.clamp(starts[:, None] + j[None, :], 0, max(n - 1, 0))
    live = j[None, :] < torch.clamp(lens, max=width)[:, None]
    mat = torch.zeros((g, cols), dtype=dtype, device=dev)
    if n and width:
        got = _rows_of(values, rows_at(pos.reshape(-1))).to(dtype)
        mat[:, :width] = torch.where(live, got.view(g, width),
                                     torch.zeros((), dtype=dtype, device=dev))
    return mat


class _ArrayResult(AggregateFunction):
    """An Array(T) of the argument's values a group."""
    holistic = True
    two_step = True

    def __init__(self, arg_types, max_size: Optional[int] = None):
        super().__init__(arg_types)
        t = dt.remove_nullable(arg_types[0])
        if t.is_dictionary or t.is_array or dt.is_map(t):
            raise NotImplementedError_(
                f"{self.name} of {arg_types[0]} (an Array of it) is not "
                f"ported to the CUDA engine yet")
        self.max_size = int(max_size) if max_size else None

    def result_type(self):
        return dt.Array(dt.remove_nullable(self.arg_types[0]))

    def _dtype(self) -> torch.dtype:
        return dt.remove_nullable(self.arg_types[0]).torch_dtype

    def _width(self, ctx: GroupContext) -> int:
        """The result's width: N, else the group_array_max_size setting;
        its (groups, width) matrix held against the budget."""
        s = ctx.settings
        width = self.max_size if self.max_size is not None else \
            getattr(s, "group_array_max_size", 256) if s else 256
        ctx.hold(ctx.grouping.num_groups_cap * (-(-width // 8) * 8) * 9,
                 f"{self.name}'s (groups, width) matrix")
        return width

    def _states(self, ctx: GroupContext, mat: torch.Tensor,
                lens: torch.Tensor, width: int) -> List[torch.Tensor]:
        """[the matrix, each group's length]; with no N, a Check that no
        group passes the width (the session re-plans with it raised)."""
        if self.max_size is None:
            _check_width(ctx, lens, width, self.name)
        return [mat, torch.clamp(lens, max=width).to(torch.int32)]

    def finalize(self, states):
        return states[0], None, states[1]


class GroupArrayAgg(_ArrayResult):
    """groupArray([N])(x): each group's first N values in row order.

    Its subclasses (exprs/agg_ext3.py: groupArraySorted, groupArrayLast,
    groupArraySample) take two hooks: :meth:`_order_cols` (the reference's),
    secondary keys that order each group's masked-in rows before row
    order; and :meth:`_first_row`, where in those rows the N values start
    (groupArrayLast's last N: the reference collects them newest first and
    flips each row, which takes a sort key and a transform more)."""
    name = "groupArray"

    def secondary(self, ctx, args, cond):
        """Row order within each group: the masked-in rows first (a
        masked-out flag), then the order columns; the keys alone where
        there is neither; None under an unmasked GROUP BY () without order
        columns, which reads the rows as they are."""
        mask = self._row_mask(ctx, args, cond)
        keys = notm_key(ctx, mask) + self._order_cols(ctx, args)
        return keys if keys or ctx.keys else None

    def _order_cols(self, ctx: GroupContext, args: List[ColVal]
                    ) -> List[sort_ops.SortKey]:
        """Secondary keys ordering each group's masked-in rows (before row
        order: K4 is stable)."""
        return []

    def _first_row(self, lens: torch.Tensor, width: int) -> torch.Tensor:
        """The offset, in each group's ordered masked-in rows, of the first
        value collected (the first N: 0)."""
        return torch.zeros_like(lens)

    def reductions(self, ctx, args, cond):
        return [("count", None, self._row_mask(ctx, args, cond), False)], \
            list

    def sorted_step(self, ctx, g, args, cond, states):
        lens = states[0]
        width = self._width(ctx)
        v = self._spec_value(ctx, args[0])
        off = self._first_row(lens, width)
        if g.kind == "trivial":
            idx, _ = filter_ops.compact_rows(ctx.row_valid)
            n = idx.shape[0]
            mat = _prefix_matrix(v, lambda p: idx.index_select(0, p).long(),
                                 lens, off, width, self._dtype(), n)
        else:
            mat = _prefix_matrix(
                v, lambda p: g.perm.index_select(0, p).long(), lens,
                g.starts + off, width, self._dtype(), g.perm.shape[0])
        return self._states(ctx, mat, lens, width)


class _Runs(_SortedValues):
    """The runs of equal values in each group's value-sorted masked-in rows
    (the sort grouping by (keys, masked-out flag, value)): a run starts
    where the value (as the reference compares decoded values: each NaN a
    run, -0.0 and +0.0 one) or the group changes."""

    def reductions(self, ctx, args, cond):
        return [("count", None, self._row_mask(ctx, args, cond), False)], \
            list

    def _first(self, ctx, g, args, cond):
        """(values in sorted order, run-first flags)."""
        mask = self._row_mask(ctx, args, cond)
        v = self._spec_value(ctx, args[0])
        n = g.perm.shape[0]
        vs = _take(ctx, g, v, f"{self.name}'s sorted values")
        ms = _take_mask(ctx, g, mask)
        ctx.hold(2 * n, f"{self.name}'s run flags")
        gid = g.group_ids
        first = gid < g.num_groups_cap
        if n > 1:
            first[1:] &= (vs[1:] != vs[:-1]) | (gid[1:] != gid[:-1])
        if ms is not None:
            first &= ms
        return vs, first

    def _run_counts(self, g, first, rows):
        """(run starts, their groups, their row counts): a run ends at the
        next run's start or its group's last masked-in row (rows: the
        group's masked-in rows, which sort first)."""
        n = first.shape[0]
        p = torch.nonzero(first).squeeze(1)
        gp = g.group_ids.index_select(0, p).long()
        inend = g.starts.index_select(0, gp) + rows.index_select(0, gp)
        nxt = torch.cat([p[1:], torch.full((1,), n, dtype=p.dtype,
                                           device=p.device)])
        return p, gp, torch.minimum(nxt, inend) - p


class TopKAgg(_Runs, _ArrayResult):
    """topK(N)(x): the N most frequent values of each group, most frequent
    first, ties in value order (exact: the reference's two sorts)."""
    name = "topK"

    def __init__(self, arg_types, k: int = 10):
        _ArrayResult.__init__(self, arg_types, k)

    def sorted_step(self, ctx, g, args, cond, states):
        rows = states[0]
        vs, first = self._first(ctx, g, args, cond)
        p, gp, cnt = self._run_counts(g, first, rows)
        nr = p.shape[0]
        nsel = g.reduce_sorted([("count", None, first, False)])[0]
        ctx.hold(nr * 40, "topK's runs")
        # the runs by (group, -count), stably: each group's most frequent
        # first, equal counts in value order (K4)
        perm, _ = sort_ops.sort_rows(
            [sort_ops.SortKey(gp, bounds=(0, g.num_groups_cap - 1)),
             sort_ops.SortKey(int(cnt.max()) - cnt if nr else cnt,
                              bounds=(0, int(cnt.max()) if nr else 0))],
            None, want_keys=False, max_bytes=None if ctx.max_bytes is None
            else ctx.max_bytes - ctx.shared["bytes"])
        run_vals = vs.index_select(0, p).index_select(0, perm.long())
        off = torch.cumsum(nsel, 0) - nsel
        width = self._width(ctx)
        mat = _prefix_matrix(run_vals, lambda q: q, nsel, off, width,
                             self._dtype(), nr)
        return self._states(ctx, mat, nsel, width)


class EntropyAgg(_Runs):
    """entropy(x): the Shannon entropy (bits) of each group's values, the
    sum over its runs of c log2(T / c) / T in float64 (the reference sums
    log2(T / c) / T over every row: the same terms, another order)."""
    name = "entropy"

    def result_type(self):
        return dt.Float64

    def sorted_step(self, ctx, g, args, cond, states):
        rows = states[0]
        _, first = self._first(ctx, g, args, cond)
        p, gp, cnt = self._run_counts(g, first, rows)
        nsel = g.reduce_sorted([("count", None, first, False)])[0]
        t = rows.index_select(0, gp).to(torch.float64)
        c = cnt.to(torch.float64)
        term = c * torch.log2(t / torch.clamp(c, min=1.0)) / \
            torch.clamp(t, min=1.0)
        off = torch.cumsum(nsel, 0) - nsel
        h = scan_ops.segment_reduce_sorted(
            [("sum", term, None, False)], off, off + nsel, p.shape[0])[0]
        return [h.to(torch.float64)]

    def finalize(self, states):
        return states[0], None


class GroupUniqArrayAgg(_Runs, _ArrayResult):
    """groupUniqArray([N])(x) (groupArrayDistinct): each group's distinct
    values in the order of their first rows, at most N.  The value-sorted
    rows give each value's first row (a run's head: the stable sort keeps
    row order within a run); a second sort grouping by (keys, not a head)
    puts the heads first in each group, in row order."""
    name = "groupUniqArray"

    def __init__(self, arg_types, max_size: Optional[int] = None):
        _ArrayResult.__init__(self, arg_types, max_size)

    def reductions(self, ctx, args, cond):
        return [], list

    def sorted_step(self, ctx, g, args, cond, states):
        _, first = self._first(ctx, g, args, cond)
        lens = g.reduce_sorted([("count", None, first, False)])[0]
        cap = ctx.capacity
        ctx.hold(2 * cap, f"{self.name}'s first rows")
        head = torch.zeros(cap, dtype=torch.bool, device=first.device)
        head[g.perm.index_select(0, torch.nonzero(first).squeeze(1))
             .long()] = True
        left = None if ctx.max_bytes is None \
            else ctx.max_bytes - ctx.shared["bytes"]
        g2 = agg_ops.group_by_sort(
            ctx.keys, ctx.row_valid, g.num_groups_cap,
            secondary=[sort_ops.SortKey(~head, bounds=(0, 1))],
            max_bytes=left)
        ctx.hold(8 * g2.perm.shape[0], f"{self.name}'s second grouping")
        width = self._width(ctx)
        mat = _prefix_matrix(
            self._spec_value(ctx, args[0]),
            lambda q: g2.perm.index_select(0, q).long(), lens, g2.starts,
            width, self._dtype(), g2.perm.shape[0])
        return self._states(ctx, mat, lens, width)


class HLLUniqAgg(AggregateFunction):
    """uniq and its HLL spellings: a HyperLogLog estimate of the distinct
    values (tuples) of the arguments, each -If, with one or more
    arguments.  A String argument hashes its dictionary code (the
    reference's), which counts distinct strings within one dictionary;
    states built over two dictionaries are not merged (S3).

    Step 1 reduces nothing; step 2 (sorted_step) is K16's update over the
    query's grouping (under the sort grouping its row-order entry where
    the keys' ranges give few registers: :meth:`_slot_keys`); merge is K16's
    byte max over the merged groups' partial states; finalize is K16's
    estimate."""
    name = "uniq"
    two_step = True

    # the (groups x registers) budget of _m_for_cap (reference :287)
    PAIR_BUDGET = 1 << 23
    # a stored state's register count, whatever the grouping (reference
    # :285): pinned by pin_state_layout (-State, -Merge)
    STATE_M = 4096

    def __init__(self, arg_types):
        super().__init__(arg_types)
        self._dicts: Optional[list] = None
        self.fixed_m: Optional[int] = None

    def pin_state_layout(self):
        self.fixed_m = self.STATE_M

    def result_type(self):
        return dt.UInt64

    def _m_for_cap(self, cap_g: int) -> int:
        """The register count of cap_g group slots (reference :293), or
        the pinned one."""
        if self.fixed_m is not None:
            return self.fixed_m
        m = 4096
        while m > 64 and cap_g * m > HLLUniqAgg.PAIR_BUDGET:
            m //= 2
        return m

    def reductions(self, ctx, args, cond):
        return [], list

    def _same_dictionaries(self, args: List[ColVal]) -> None:
        """The String arguments' dictionaries of every update of this
        aggregate (a streamed query's chunks) must be one: codes of two
        dictionaries are not one value space (S3)."""
        dicts = [cv.dictionary for cv in args]
        if self._dicts is None:
            self._dicts = dicts
            return
        for a, b in zip(self._dicts, dicts):
            if a is not b and not (a is not None and b is not None
                                   and len(a) == len(b)
                                   and np.array_equal(a.values, b.values)):
                raise NotImplementedError_(
                    f"{self.name} over String states of different "
                    f"dictionaries: a hash of the strings' bytes is not "
                    f"ported to the CUDA engine yet (S3)")

    def sorted_step(self, ctx, g, args, cond, states):
        mask = self._row_mask(ctx, args, cond)
        cap_g = g.num_groups_cap
        m = self._m_for_cap(cap_g)
        if ctx.mergeable:
            self._same_dictionaries(args)
        hargs = [hash_arg(cv) for cv in args]
        ctx.hold(cap_g * m, f"{self.name}'s registers")
        if g.kind == "trivial":
            rows = mask if isinstance(mask, agg_ops.RowMask) \
                else agg_ops.RowMask.of(mask)
            sel = rows.tensor() if rows.terms else rows.mask
            return [sketch_ops.hll_update(hargs, m, cap_g,
                                          n_rows=rows.n_rows, mask=sel)]
        sel = g._sort_mask(mask)
        keys = self._slot_keys(ctx, m)
        table = None if keys is None else self._slot_table(ctx, g, keys, m)
        if table is None:
            return [sketch_ops.hll_update(hargs, m, cap_g, perm=g.perm,
                                          gid=g.group_ids, mask=sel)]
        n_rows = None
        if sel is None:
            # the grouping's own rows (the perm entry's rows with a group)
            rows = g.row_valid_ref
            n_rows = rows.n_rows
            if rows.mask is not None or rows.terms:
                sel = rows.tensor()
        return [sketch_ops.hll_update_rows(hargs, m, cap_g, keys, table,
                                           n_rows=n_rows, mask=sel)]

    @staticmethod
    def _slot_keys(ctx: GroupContext, m: int
                   ) -> Optional[List[sketch_ops.SlotKey]]:
        """The GROUP BY keys as K16's row-order update reads them, or None
        where one is a float, has no proven bounds or the product of the
        spans times m passes HLL_ROWS_MAX_CELLS.  A key after a Bool key
        (a Nullable key's data, zeroed where NULL, after its validity) has
        0 in its range."""
        keys, slots, after_bool = [], m, False
        for k in ctx.keys:
            if k.bounds is None or k.data.is_floating_point():
                return None
            lo, hi = int(k.bounds[0]), int(k.bounds[1])
            if after_bool:
                lo, hi = min(lo, 0), max(hi, 0)
            if lo < -2**63 or hi >= 2**63 or hi < lo:
                return None
            slots *= hi - lo + 1
            if slots > sketch_ops.HLL_ROWS_MAX_CELLS:
                return None
            keys.append(sketch_ops.SlotKey(k.data, lo, hi - lo + 1))
            after_bool = k.data.dtype == torch.bool
        if not keys or len(keys) > sketch_ops.MAX_SLOT_KEYS:
            return None
        return keys

    def _slot_table(self, ctx: GroupContext, g: agg_ops.Grouping,
                    keys: List[sketch_ops.SlotKey], m: int):
        """g's slot -> group table (built once a grouping: one host read
        checks its groups' keys against the ranges), or None where a key
        leaves its range; the table and the update's cells and key copies
        held."""
        if g.slot_table is None:
            ctx.hold(4 * math.prod(k.span for k in keys),
                     f"{self.name}'s slot table")
            g.slot_table = (sketch_ops.hll_slot_table(
                g.unique_keys, g.num_groups, keys),)
        if g.slot_table[0] is not None:
            ctx.hold(sketch_ops.hll_rows_scratch_bytes(
                keys, m, g.num_groups.device),
                f"{self.name}'s register cells and key copies")
        return g.slot_table[0]

    def merge(self, states, g, mask):
        s = states[0]
        if g.kind == "trivial":
            m = mask.tensor() if isinstance(mask, agg_ops.RowMask) else mask
            return [sketch_ops.hll_merge(s, g.num_groups_cap, mask=m)]
        return [sketch_ops.hll_merge(s, g.num_groups_cap, starts=g.starts,
                                     ends=g.ends, perm=g.perm,
                                     mask=g._sort_mask(mask))]

    def finalize(self, states):
        return sketch_ops.hll_finalize(states[0]), None
