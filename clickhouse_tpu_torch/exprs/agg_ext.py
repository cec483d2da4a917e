"""The aggregate combinators -Array, -ForEach, -Distinct and -OrNull /
-OrDefault (reference: clickhouse_tpu/exprs/agg_ext.py, the classes
ArrayReduceAgg :262, AvgArrayAgg :322, ForEachAgg :353, DistinctAgg :420,
CountArrayAgg :467, OrNullAgg :749 and make_array_combinator :494 /
make_foreach_combinator :512; get_aggregate peels the suffixes).

An Array argument is the port's padded (rows, max_len) matrix and its
int32 lengths.  -Array reduces each row over its elements (plain torch
over the matrix) and hands the inner aggregate the row values; -ForEach
reduces element j of each group's rows, one reduction a position, all in
the query's one reduce_many (K6 under the sort grouping, K1 under GROUP BY
()); -Distinct sorts each group's rows by the value (the sort grouping
with secondary keys: K4, K5) and lets the inner aggregate see the first
row of each value only; -OrNull counts each group's rows and makes a
group without one NULL (-OrDefault keeps the inner aggregate's value).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.errors import NotImplementedError_, TypeError_
from ..ops import agg_ops, filter_ops, scan_ops
from .agg_sketch import GroupArrayAgg, _prefix_matrix
from . import aggregates as _agg
from .aggregates import (AggregateFunction, GroupContext, UniqExactAgg,
                         _and_mask, _numeric as numeric, _rows_of,
                         _SortedValues, _take, _take_mask, notm_key,
                         value_key)
from .expr import ColVal

__all__ = ["ArrayReduceAgg", "AvgArrayAgg", "CountArrayAgg", "ForEachAgg",
           "DistinctAgg", "OrNullAgg", "make_array_combinator",
           "make_foreach_combinator"]


def _live(cv: ColVal) -> torch.Tensor:
    """(rows, max_len) bool: the elements within each row's length."""
    w = cv.data.shape[1]
    return torch.arange(w, device=cv.data.device)[None, :] \
        < cv.lengths[:, None].to(torch.int64)


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.is_floating_point() else torch.int64


class ArrayReduceAgg(AggregateFunction):
    """-Array of sum, min and max: each row's elements reduced (row_op),
    the inner aggregate over those values; a row with no element (or a
    NULL array) takes no part."""

    def __init__(self, inner: AggregateFunction, arg_types, row_op: str):
        super().__init__(arg_types)
        self.inner = inner
        self.row_op = row_op
        self.name = inner.name + "Array"
        self.keeps_presence = inner.keeps_presence

    def result_type(self):
        return self.inner.result_type()

    def merge_ops(self):
        return self.inner.merge_ops()

    def _scalarize(self, ctx: GroupContext, cv: ColVal) -> ColVal:
        cv = cv.broadcast(ctx.capacity)
        data = cv.data
        acc = _acc_dtype(data)
        live = _live(cv)
        ctx.hold(data.shape[0] * data.shape[1] * 9,
                 f"{self.name}'s reduction of each row")
        if self.row_op == "sum":
            red = torch.where(live, data.to(acc), 0).sum(dim=1)
        else:
            info = torch.finfo(acc) if acc.is_floating_point \
                else torch.iinfo(acc)
            fill = float("inf") if acc.is_floating_point else info.max
            if self.row_op == "max":
                fill = -fill if acc.is_floating_point else info.min
            red = torch.where(live, data.to(acc),
                              torch.full((), fill, dtype=acc,
                                         device=data.device))
            red = red.amin(dim=1) if self.row_op == "min" \
                else red.amax(dim=1)
        nonempty = cv.lengths > 0
        valid = nonempty if cv.validity is None \
            else cv.validity.to(torch.bool) & nonempty
        inner_t = dt.array_inner(dt.remove_nullable(self.arg_types[0]))
        return ColVal(dt.make_nullable(inner_t), red, valid.to(torch.uint8))

    def reductions(self, ctx, args, cond):
        sc = self._scalarize(ctx, args[0])
        pre = ctx.premask
        if pre is not None:
            pre = _and_mask(pre, sc.validity.to(torch.bool))
        return self.inner.reductions(dataclasses.replace(ctx, premask=pre),
                                     [sc], cond)

    def finalize(self, states):
        return self.inner.finalize(states)


class AvgArrayAgg(AggregateFunction):
    """avgArray(arr): the mean of every element of the group's arrays
    (states: the elements' float64 sum and their count)."""
    name = "avgArray"

    def result_type(self):
        return dt.Float64

    def merge_ops(self):
        return [("sum", False), ("sum", False)]

    def reductions(self, ctx, args, cond):
        cv = args[0].broadcast(ctx.capacity)
        mask = self._row_mask(ctx, args, cond)
        ctx.hold(cv.data.shape[0] * (cv.data.shape[1] * 9 + 16),
                 f"{self.name}'s row sums")
        sums = torch.where(_live(cv), cv.data.to(torch.float64), 0.0) \
            .sum(dim=1)
        return [("sum", sums, mask, False),
                ("sum", cv.lengths.to(torch.int64), mask, False)], list

    def finalize(self, states):
        s, c = states
        return s / torch.clamp(c, min=1).to(torch.float64), None


class CountArrayAgg(AggregateFunction):
    """countArray(arr): the elements of the group's arrays."""
    name = "countArray"

    def result_type(self):
        return dt.UInt64

    def merge_ops(self):
        return [("sum", False)]

    def reductions(self, ctx, args, cond):
        cv = args[0].broadcast(ctx.capacity)
        mask = self._row_mask(ctx, args, cond)
        return [("sum", cv.lengths.to(torch.int64), mask, False)], list

    def finalize(self, states):
        return states[0].to(torch.int64), None


class ForEachAgg(AggregateFunction):
    """-ForEach of sum, min, max, count and avg: out[j] is the aggregate
    over element j of the group's rows that have one; the result's length
    is the group's longest array.  One reduction a position (and, for avg,
    a count a position), all in the query's reduce_many.  Its states are
    not merged (holistic: a streamed query collects its rows)."""
    holistic = True

    def __init__(self, op: str, arg_types):
        super().__init__(arg_types)
        self.op = op
        self.name = op + "ForEach"

    def result_type(self):
        inner = dt.array_inner(dt.remove_nullable(self.arg_types[0]))
        if self.op == "count":
            return dt.Array(dt.UInt64)
        if self.op == "avg":
            return dt.Array(dt.Float64)
        if self.op == "sum" and inner.np_dtype.kind in "iu":
            return dt.Array(dt.Int64 if inner.np_dtype.kind == "i"
                            else dt.UInt64)
        return dt.Array(inner)

    def merge_ops(self):
        raise TypeError_("ForEach states cannot be merged; repartition by "
                         "key instead")

    def secondary(self, ctx, args, cond):
        return []                  # any order of each group's rows

    def reductions(self, ctx, args, cond):
        cv = args[0].broadcast(ctx.capacity)
        mask = self._row_mask(ctx, args, cond)
        data, w = cv.data, cv.data.shape[1]
        live = _live(cv)
        ctx.hold(data.shape[0] * (w + 8 * min(w, 8)),
                 f"{self.name}'s positions")
        specs = []
        for j in range(w):
            m_j = _and_mask(mask, live[:, j])
            col = data[:, j].contiguous()
            if self.op == "count":
                specs.append(("count", None, m_j, False))
            elif self.op == "avg":
                specs += [("sum", col.to(torch.float64), m_j, False),
                          ("count", None, m_j, False)]
            else:
                specs.append((self.op, col, m_j, False))
        specs.append(("max", cv.lengths.to(torch.int64), mask, False))
        return specs, lambda r: self._states(r, w)

    def _states(self, r, w: int) -> List[torch.Tensor]:
        if self.op == "avg":
            cols = [s / torch.clamp(c, min=1).to(torch.float64)
                    for s, c in zip(r[0:2 * w:2], r[1:2 * w:2])]
        else:
            cols = r[:w]
        want = dt.array_inner(self.result_type()).torch_dtype
        mat = torch.stack([c.to(want) for c in cols], dim=1)
        return [mat, torch.clamp(r[-1], 0, w).to(torch.int32)]

    def finalize(self, states):
        return states[0], None, states[1]


class DistinctAgg(AggregateFunction):
    """-Distinct: the inner aggregate over the first row of each distinct
    value of the (first) argument within its group.  The sort grouping
    orders each group's rows by (masked-out flag, value) (K4, K5); the
    first row of each run of equal values is kept, its flag scattered back
    through perm, and the inner aggregate runs over that grouping with the
    flags as its condition.  Its states are not merged."""
    holistic = True
    two_step = True

    def __init__(self, inner: AggregateFunction):
        super().__init__(inner.arg_types)
        if inner.holistic or inner.two_step:
            raise NotImplementedError_(
                f"-Distinct of {inner.name} is not ported to the CUDA "
                f"engine yet")
        self.inner = inner
        self.name = inner.name + "Distinct"

    def result_type(self):
        return self.inner.result_type()

    def merge_ops(self):
        raise TypeError_("-Distinct states cannot be merged; repartition by "
                         "key instead")

    def secondary(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return notm_key(ctx, mask) + [value_key(args[0], ctx.capacity)]

    def reductions(self, ctx, args, cond):
        return [], list

    def sorted_step(self, ctx, g, args, cond, states):
        mask = self._row_mask(ctx, args, cond)
        cv = args[0].broadcast(ctx.capacity)
        v = cv.storage
        n = g.perm.shape[0]
        vs = _take(ctx, g, v, f"{self.name}'s sorted values")
        ms = _take_mask(ctx, g, mask)
        ctx.hold(2 * n + 8, f"{self.name}'s first-occurrence flags")
        gid = g.group_ids
        first = torch.ones(n, dtype=torch.bool, device=vs.device)
        if n > 1:
            first[1:] = (vs[1:] != vs[:-1]) | (gid[1:] != gid[:-1])
        if ms is not None:
            first &= ms
        keep = torch.zeros(ctx.capacity, dtype=torch.bool,
                           device=vs.device)
        keep.index_copy_(0, g.perm.to(torch.int64), first)
        ictx = dataclasses.replace(ctx, premask=None, grouping=g)
        specs, finish = self.inner.reductions(ictx, args, keep)
        return finish(g.reduce_many(specs))

    def finalize(self, states):
        return self.inner.finalize(states)


class OrNullAgg(AggregateFunction):
    """-OrNull / -OrDefault: the inner aggregate's states and the count of
    the group's rows; -OrNull gives NULL where the count is 0, -OrDefault
    the inner aggregate's value as it is."""

    def __init__(self, inner: AggregateFunction, null: bool):
        super().__init__(inner.arg_types)
        self.inner = inner
        self.null = null
        self.name = inner.name + ("OrNull" if null else "OrDefault")
        self.holistic = inner.holistic
        self.two_step = inner.two_step
        self.respect_nulls = inner.respect_nulls

    def result_type(self):
        t = self.inner.result_type()
        return dt.make_nullable(t) if self.null else t

    def merge_ops(self):
        return self.inner.merge_ops() + [("sum", False)]

    def merge_specs(self, states, mask):
        return self.inner.merge_specs(states[:-1], mask) \
            + [("sum", states[-1], mask, False)]

    def merge(self, states, g, mask):
        if _agg._custom_merge(self.inner):
            return self.inner.merge(states[:-1], g, mask) \
                + [g.reduce("sum", states[-1], mask)]
        return g.reduce_many(self.merge_specs(states, mask))

    def secondary(self, ctx, args, cond):
        return self.inner.secondary(ctx, args, cond)

    def reductions(self, ctx, args, cond):
        specs, finish = self.inner.reductions(ctx, args, cond)
        k = len(specs)
        return specs + [("count", None, self._row_mask(ctx, args, cond),
                         False)], lambda r: finish(r[:k]) + [r[k]]

    def sorted_step(self, ctx, g, args, cond, states):
        return self.inner.sorted_step(ctx, g, args, cond, states[:-1]) \
            + [states[-1]]

    def finalize(self, states):
        out = self.inner.finalize(states[:-1])
        data, validity = out[0], out[1]
        if self.null:
            seen = states[-1] > 0
            validity = seen.to(torch.uint8) if validity is None \
                else (validity.to(torch.bool) & seen).to(torch.uint8)
        return (data, validity) + tuple(out[2:])


_ARRAY_OPS = ("sum", "min", "max")
_FOREACH_OPS = ("sum", "min", "max", "count", "avg")


def _array_arg(arg_types) -> Optional[dt.DType]:
    """The element type of an Array first argument, or None."""
    if not arg_types or not dt.remove_nullable(arg_types[0]).is_array:
        return None
    inner = dt.array_inner(dt.remove_nullable(arg_types[0]))
    return None if inner.is_dictionary else inner


def make_array_combinator(base_name: str, inner_cls, arg_types
                          ) -> Optional[AggregateFunction]:
    """The -Array aggregate of base_name, or None where it does not
    apply."""
    inner_t = _array_arg(arg_types)
    if inner_t is None:
        return None
    if base_name == "avg":
        return AvgArrayAgg(arg_types)
    if base_name == "count":
        return CountArrayAgg(arg_types)
    if base_name not in _ARRAY_OPS:
        return None
    return ArrayReduceAgg(inner_cls([dt.make_nullable(inner_t)]), arg_types,
                          base_name)


def make_foreach_combinator(base_name: str, arg_types
                            ) -> Optional[AggregateFunction]:
    if base_name not in _FOREACH_OPS or _array_arg(arg_types) is None:
        return None
    return ForEachAgg(base_name, arg_types)


# -- the aggregate tail of agg_ext.py ------------------------------------------
# deltaSum :146, quantileExactWeighted :207 (and its spellings), uniqUpTo
# :555, groupArrayMovingSum / groupArrayMovingAvg :705, :744.  Helpers that
# agg_ext2.py ... agg_ext4.py share are here too.

_INF = 1 << 62          # the reference's "no event yet" time (agg_ext2.py:26)
_SIGN = -(1 << 63)      # int64 bits of 1 << 63


def f64_of(cv: ColVal, t: torch.Tensor) -> torch.Tensor:
    """A column's values (t: its storage, in any row order) as float64,
    UInt64 bits as their unsigned value."""
    if dt.remove_nullable(cv.dtype).np_dtype == np.uint64 \
            and t.dtype == torch.int64:
        return dt.u64_to_f64(t)
    return t.to(torch.float64)


def group_starts(g: agg_ops.Grouping) -> torch.Tensor:
    """bool, a sorted row each: True where a group starts (K17's
    boundary flags; the rows past the last group start one more)."""
    gid = g.group_ids
    b = torch.ones(gid.shape[0], dtype=torch.bool, device=gid.device)
    if gid.shape[0] > 1:
        b[1:] = gid[1:] != gid[:-1]
    return b


class Rows:
    """An aggregate's rows as its sorted step reads them.  Under the sort
    grouping g: in g's sorted order (each column gathered once by perm for
    the GROUP BY, ctx.built), a row's group g.group_ids, reductions by
    K6's sorted-order entry.  Under GROUP BY () (the trivial grouping): in
    raw row order, one group, reductions by K1."""

    def __init__(self, ctx: GroupContext, g: agg_ops.Grouping, mask,
                 what: str):
        self.ctx, self.g, self.what = ctx, g, what
        self.sort = g.kind == "sort"
        if self.sort:
            self.n = g.perm.shape[0]
            ms = _take_mask(ctx, g, mask)
            self.gid = torch.clamp(g.group_ids, max=g.num_groups_cap - 1) \
                .to(torch.int64)
            self.mask = ms if ms is not None \
                else g.group_ids < g.num_groups_cap
        else:
            self.n = ctx.capacity
            self.mask = mask.tensor() if isinstance(mask, agg_ops.RowMask) \
                else mask

    def col(self, cv: ColVal) -> torch.Tensor:
        """A column's values (as stored, a term formed) in this order."""
        t = AggregateFunction._spec_value(self.ctx, cv)
        if self.sort:
            return _take(self.ctx, self.g, t, f"{self.what}'s sorted rows")
        return t if isinstance(t, torch.Tensor) else t.build()

    def group(self, v: torch.Tensor) -> torch.Tensor:
        """A per-group value at each row."""
        if self.sort:
            return v.index_select(0, self.gid)
        return v[:1].expand(self.n)

    def reduce(self, specs) -> List[torch.Tensor]:
        """Reductions of columns in this order (one K6 launch, or K1 a
        spec)."""
        if self.sort:
            return self.g.reduce_sorted(specs)
        return self.g.reduce_many(specs)


class DeltaSumAgg(AggregateFunction):
    """deltaSum(x): the sum of the rises between consecutive masked-in rows
    of each group, in row order (ClickHouse's AggregateFunctionDeltaSum).
    The rows in row order within each group (the keys' stable sort; under
    GROUP BY () the rows as they are); each row's previous masked-in row is
    K17's `last` scan of the row index over the masked-in rows, read one
    row back (the reference's forward fill); the rises summed by K6's
    sorted entry.  A UInt64 compares unsigned."""
    name = "deltaSum"
    holistic = True
    two_step = True

    def __init__(self, arg_types):
        super().__init__(arg_types)
        numeric(self, 0)

    def result_type(self):
        base = dt.remove_nullable(self.arg_types[0])
        if base.np_dtype.kind == "f":
            return dt.Float64
        return dt.Int64 if base.np_dtype.kind == "i" else dt.UInt64

    def secondary(self, ctx, args, cond):
        # row order: the keys alone (K4 is stable); under GROUP BY () the
        # rows as they are
        return [] if ctx.keys else None

    def reductions(self, ctx, args, cond):
        return [], list

    def sorted_step(self, ctx, g, args, cond, states):
        mask = self._row_mask(ctx, args, cond)
        r = Rows(ctx, g, mask, self.name)
        ctx.hold(r.n * 26, f"{self.name}'s previous rows")
        v = r.col(args[0])
        t = dt.remove_nullable(self.arg_types[0]).np_dtype
        v = v.to(torch.float64) if t.kind == "f" else v.to(torch.int64)
        m = r.mask
        bnd = group_starts(g) if r.sort else None
        last = scan_ops.segmented_scan("last", None, bnd, m)
        prev = torch.zeros_like(last)
        ok = torch.zeros_like(m)
        if r.n > 1:
            prev[1:] = last[:-1]
            ok[1:] = m[1:] & m.index_select(0, prev[1:])
            if bnd is not None:
                ok[1:] &= ~bnd[1:]
        pv = v.index_select(0, prev)
        a, b = (v ^ _SIGN, pv ^ _SIGN) if t == np.uint64 else (v, pv)
        rise = ok & (a > b)
        d = torch.where(rise, v - pv, torch.zeros((), dtype=v.dtype,
                                                  device=v.device))
        return r.reduce([("sum", d, m, False)])

    def finalize(self, states):
        return states[0], None


class QuantileExactWeightedAgg(_SortedValues):
    """quantileExactWeighted(q)(x, w) (and its spellings, the reference's
    exprs/aggregates.py:814-816, :843-846, :872-875): in each group's
    value-sorted masked-in rows, the first whose running weight reaches
    q * total - 1e-12 (the reference's rule; with integer weights
    ClickHouse's ceil(q * total)).  The running weight is K17's sum over
    the groups, the total K6's sorted sum; the rows below the level are
    counted by K6's sorted entry, and the value is read at starts[g] + that
    count.  A group without a masked-in row gives 0 (NaN for a float).
    quantilesExactWeighted(q1, ...) gives an Array of each weighted level
    (the reference ignores the weights there: A3)."""
    name = "quantileExactWeighted"

    def __init__(self, arg_types, q: float = 0.5, qs=None):
        super().__init__(arg_types)
        t = dt.remove_nullable(arg_types[0])
        if t.is_dictionary or t.is_array or dt.is_map(t):
            raise TypeError_(f"Illegal type {arg_types[0]} of argument of "
                             f"aggregate function {self.name}")
        if len(arg_types) != 2:
            raise TypeError_(f"{self.name} takes a value and a weight")
        numeric(self, 1)
        self.q = float(q)
        self.qs = [float(x) for x in qs] if qs is not None else None

    def result_type(self):
        base = dt.remove_nullable(self.arg_types[0])
        return dt.Array(base) if self.qs is not None else base

    def reductions(self, ctx, args, cond):
        return [("count", None, self._row_mask(ctx, args, cond), False)], \
            list

    def sorted_step(self, ctx, g, args, cond, states):
        lens = states[0]
        mask = self._row_mask(ctx, args, cond)
        n = g.perm.shape[0]
        ctx.hold(n * 26, f"{self.name}'s running weights")
        ms = _take_mask(ctx, g, mask)
        w = f64_of(args[1], _take(ctx, g, self._spec_value(ctx, args[1]),
                                  f"{self.name}'s weights"))
        if ms is not None:
            w = torch.where(ms, w, 0.0)
        total = g.reduce_sorted([("sum", w, ms, False)])[0]
        run = scan_ops.segmented_scan("sum", w, group_starts(g))
        gid = torch.clamp(g.group_ids, max=g.num_groups_cap - 1).long()
        tot = total.index_select(0, gid)
        levels = self.qs if self.qs is not None else [self.q]
        specs = []
        for q in levels:
            below = run < q * tot - 1e-12
            specs.append(("count", None,
                          below if ms is None else below & ms, False))
        offs = g.reduce_sorted(specs)
        v = self._spec_value(ctx, args[0])
        last = max(n - 1, 0)
        top = torch.clamp(lens - 1, min=0)
        picks = []
        for off in offs:
            pos = torch.clamp(g.starts + torch.minimum(off, top), 0, last)
            val = self._logical(_rows_of(v, g.perm.index_select(0, pos)
                                         .long()))
            empty = float("nan") if val.is_floating_point() else 0
            picks.append(torch.where(lens > 0, val,
                                     torch.full_like(val, empty)))
        if self.qs is None:
            return picks
        k = len(picks)
        mat = torch.zeros((lens.shape[0], -(-k // 8) * 8),
                          dtype=picks[0].dtype, device=lens.device)
        mat[:, :k] = torch.stack(picks, dim=1)
        return [mat, torch.full(lens.shape, k, dtype=torch.int32,
                                device=lens.device)]

    def finalize(self, states):
        if self.qs is not None:
            return states[0], None, states[1]
        return states[0], None


class MedianExactWeightedAgg(QuantileExactWeightedAgg):
    name = "medianExactWeighted"

    def __init__(self, arg_types):
        super().__init__(arg_types, q=0.5)


class UniqUpToAgg(UniqExactAgg):
    """uniqUpTo(N)(x): the exact distinct count (uniqExact's, K6's sorted
    entry over the value-sorted rows) up to N, else N + 1."""
    name = "uniqUpTo"

    def __init__(self, arg_types, n: int = 5):
        super().__init__(arg_types)
        self.n = int(n)

    def finalize(self, states):
        return torch.clamp(states[0], max=self.n + 1), None


class GroupArrayMovingSumAgg(GroupArrayAgg):
    """groupArrayMovingSum([N])(x): each group's running sums in row order,
    an Array as long as the group (the group_array_max_size setting's
    width).  The sums are K17's sum scan over the groups' masked-in rows
    (integers in int64, exact and wrapping as ClickHouse's; floats in
    float64); with a window N, ClickHouse's sum of the last N values, the
    scan's difference N rows apart, as ClickHouse's own moving sum takes
    it.  The reference drops N and sums integers in float64 (a pinned
    divergence).  groupArrayMovingAvg: with N the window's sum / N
    (ClickHouse's); without, the running sum / (j + 1), the reference's."""
    name = "groupArrayMovingSum"
    moving_avg = False

    def __init__(self, arg_types, window: Optional[int] = None):
        super().__init__(arg_types)
        numeric(self, 0)
        self.window = int(window) if window else None

    def result_type(self):
        base = dt.remove_nullable(self.arg_types[0])
        if self.moving_avg or base.np_dtype.kind == "f":
            return dt.Array(dt.Float64)
        return dt.Array(dt.Int64 if base.np_dtype.kind == "i"
                        else dt.UInt64)

    def sorted_step(self, ctx, g, args, cond, states):
        lens = states[0]
        width = self._width(ctx)
        v = self._spec_value(ctx, args[0])
        cap_g = lens.shape[0]
        if g.kind == "trivial":
            idx, _ = filter_ops.compact_rows(ctx.row_valid)
            vs = _rows_of(v, idx.long())
            starts = torch.zeros(cap_g, dtype=torch.int64, device=idx.device)
            bnd = None
        else:
            vs = _take(ctx, g, v, f"{self.name}'s values in sorted order")
            starts, bnd = g.starts, group_starts(g)
        n = vs.shape[0]
        ctx.hold(n * 8 + cap_g * width * 24, f"{self.name}'s running sums")
        fl = dt.remove_nullable(self.arg_types[0]).np_dtype.kind == "f"
        vs = vs.to(torch.float64) if fl else vs.to(torch.int64)
        run = scan_ops.segmented_scan("sum", vs, bnd)
        mat = _prefix_matrix(run, lambda p: p, lens, starts, width,
                             run.dtype, n)
        j = torch.arange(mat.shape[1], device=mat.device)
        live = j[None, :] < torch.clamp(lens, max=width)[:, None]
        if self.window is not None and width > self.window:
            # the sum N rows back, which the window no longer holds
            w = self.window
            sub = torch.zeros_like(mat)
            sub[:, w:width] = mat[:, :width - w]
            mat = torch.where(live, mat - sub, torch.zeros_like(mat))
        if self.moving_avg:
            u64 = dt.remove_nullable(self.arg_types[0]).np_dtype == np.uint64
            mat = dt.u64_to_f64(mat) if u64 else mat.to(torch.float64)
            div = float(self.window) if self.window is not None \
                else (j + 1).to(torch.float64)[None, :]
            mat = torch.where(live, mat / div, 0.0)
        return self._states(ctx, mat, lens, width)


class GroupArrayMovingAvgAgg(GroupArrayMovingSumAgg):
    name = "groupArrayMovingAvg"
    moving_avg = True
