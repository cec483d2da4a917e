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

import torch

from ..core import dtypes as dt
from ..core.errors import NotImplementedError_, TypeError_
from ..ops import agg_ops, sort_ops
from .aggregates import (AggregateFunction, GroupContext, _and_mask,
                         _custom_merge, _take, _take_mask)
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
        out = []
        if mask is not ctx.row_valid:
            m = mask.tensor() if isinstance(mask, agg_ops.RowMask) else mask
            out.append(sort_ops.SortKey(
                ctx.built("notm", (m,), lambda: ~m, m.shape[0],
                          "masked-out flags"), bounds=(0, 1)))
        cv = args[0].broadcast(ctx.capacity)
        b = cv.bounds if cv.dictionary is None else None
        out.append(sort_ops.SortKey(cv.storage, unsigned=dt.remove_nullable(
            cv.dtype).np_dtype.kind == "u" and cv.storage.dtype
            == torch.int64, bounds=b))
        return out

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
        if _custom_merge(self.inner):
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
