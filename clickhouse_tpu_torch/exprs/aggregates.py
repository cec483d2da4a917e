"""Aggregate functions (reference: clickhouse_tpu/exprs/aggregates.py).

Each function defines reductions (the per-group reductions its states
need, and how the states follow from their results), update (rows ->
per-group states, through Grouping.reduce_many) and finalize.  Every
reduction goes through Grouping.reduce_many (ops/agg_ops.py), which runs
K1 for GROUP BY (), K2 for dense groupings and K6 for the sort grouping
(K6 reads a scanned column's narrow storage itself; the states come back
in the column's logical type); the executor hands every aggregate's
reductions to one reduce_many call, so a sort GROUP BY launches K6 once
for all of its sum-family aggregates (variance, covariance, moments,
avgWeighted and groupBit* are sets of sums and bit reductions).

Every aggregate that is not holistic merges its partial states (``merge``,
the reference's AggregateFunction.merge): the states of several partial
groupings, concatenated, reduced over the grouping of their keys with the
op of each state (``merge_ops``) in one Grouping.reduce_many call.  The
streamed aggregation (exec/streaming.py) merges each chunk's states into
its carry so.  A min, max, any, argMin/argMax or groupBitAnd state keeps,
when the grouping asks for mergeable states (GroupContext.mergeable), the
count of the rows it saw as its last state, so a partial group that a -If
condition or a NULL left with no such row takes no part in the merge.
What a state holds is fixed by the aggregate and `mergeable` alone, so
every chunk of a streamed query gives the same states.  -State packs the
mergeable states into an AggregateFunction column's rows and -Merge
unpacks and merges them (the state layer below get_aggregate's registry;
K19, ops/state_ops.py); the -Array, -ForEach, -Distinct and -OrNull/
-OrDefault combinators are in agg_ext.py.

Two-step aggregates run a second step after reduce_many (`sorted_step`):
argMin/argMax take the rows at their group's best order value; the
holistic ones (uniqExact, quantileExact and their spellings) need each
group's rows in an order of their own, which the sort grouping gives when
it is sorted with their `secondary` keys (agg_ops.group_by_sort), and
reduce what Grouping.take puts in sorted order with K6's sorted-order
entry (Grouping.reduce_sorted).

Ported: the reference's base registry (_register_base), each with the -If
combinator: count, sum (sumKahan), sumWithOverflow, avg, avgWeighted, min,
max, any (anyLast, anyHeavy, first_value, last_value) and any RESPECT
NULLS, the variance family, covariance and correlation, skewness and
kurtosis, argMin/argMax, groupBitAnd/Or/Xor, uniqExact (countDistinct,
groupBitmap, uniqThetaSketch), and quantileExact/median with their exact
spellings, `quantiles(...)` giving an Array (the High, Exclusive and
Inclusive spellings by ClickHouse's rules, not the reference's), and the
sketches of agg_sketch.py (uniq and its HLL spellings, groupArray,
groupUniqArray, topK, entropy), and the tail of agg_ext.py ... agg_ext4.py
(the weighted quantiles, uniqUpTo, the moving and ordered groupArrays,
deltaSum, windowFunnel, retention, the decayed, interval and cross-tab
statistics and the rest whose result is not a Tuple).  sum/count/avg of
integers may take the dense grouping; the rest take the sort grouping (or
K1 under GROUP BY ()).  min/max (and argMin/argMax's order) of a String
compare its dictionary ranks.  The names whose result is a Tuple
(TUPLE_AGGREGATES) and every other unknown name raise the reference's
typed errors (UnknownFunction / NotImplementedError_).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.errors import (AnalysisError, MemoryLimitExceeded,
                           NotImplementedError_, TypeError_, UnknownFunction)
from ..ops import agg_ops, scan_ops, sort_ops
from .expr import ColVal, StoredColVal, TermColVal

__all__ = ["AggregateFunction", "get_aggregate", "is_aggregate_name",
           "AGGREGATES", "REFERENCE_AGGREGATES", "GroupContext"]

# the states of an aggregate from its reductions' results
Finish = Callable[[List[torch.Tensor]], List[torch.Tensor]]


@dataclasses.dataclass
class GroupContext:
    """Everything an aggregate needs to produce per-group states."""
    # the block's rows: a bool mask, or (GROUP BY ()) the RowMask whose
    # parts K1 takes as they are
    row_valid: Union[torch.Tensor, agg_ops.RowMask]
    grouping: Optional[agg_ops.Grouping]
    premask: Union[torch.Tensor, agg_ops.RowMask, None] = None
    # the GROUP BY keys as sort keys (none under GROUP BY ()): a holistic
    # aggregate's own sort grouping sorts by them first
    keys: Sequence[sort_ops.SortKey] = ()
    # device bytes the aggregates' working set may take (None: no limit),
    # and what is taken so far with the columns built for the aggregates
    # (one dict for every aggregate of the GROUP BY: a column is built
    # once, by the first aggregate that needs it)
    max_bytes: Optional[int] = None
    shared: Dict = dataclasses.field(default_factory=lambda: {"bytes": 0})
    # the states will be merged (a streamed chunk's): the aggregates that
    # keep presence add the count of their rows as the last state
    mergeable: bool = False
    # the executor's capacity checks and the query's settings (groupArray's
    # width: group_array_max_size)
    checks: Optional[list] = None
    settings: Optional[object] = None

    @property
    def capacity(self) -> int:
        return _capacity(self.row_valid)

    def hold(self, nbytes: int, what: str) -> None:
        """Count nbytes more of the aggregates' working set, raising
        MemoryLimitExceeded, before they are allocated, where the total
        passes max_bytes."""
        total = self.shared["bytes"] + int(nbytes)
        if self.max_bytes is not None and total > self.max_bytes:
            raise MemoryLimitExceeded(
                f"{what} would need {total} bytes of device memory for the "
                f"aggregates ({max(self.max_bytes, 0)} bytes of the budget "
                f"left)")
        self.shared["bytes"] = total

    def built(self, tag: str, srcs: Tuple[torch.Tensor, ...],
              make: Callable[[], torch.Tensor], nbytes: int,
              what: str) -> torch.Tensor:
        """The column `tag` of the tensors `srcs`, built once for the GROUP
        BY by make() after holding its nbytes."""
        key = (tag,) + tuple(id(t) for t in srcs)
        hit = self.shared.get(key)
        if hit is None or any(a is not b for a, b in zip(hit[0], srcs)):
            self.hold(nbytes, what)
            hit = self.shared[key] = (srcs, make())
        return hit[1]


def _capacity(rows) -> int:
    return rows.capacity if isinstance(rows, agg_ops.RowMask) \
        else rows.shape[0]


def _arg_valid(cv: Optional[ColVal], capacity: int):
    if cv is None or cv.validity is None:
        return None
    v = cv.validity.to(torch.bool)
    if v.dim() == 0:
        v = v.expand(capacity)
    return v


def compose_row_mask(row_valid, args: List[ColVal],
                     cond: Optional[torch.Tensor]):
    """rows an aggregate consumes: valid & arg validities & -If condition.

    `row_valid` is a bool tensor or a RowMask; the result is of the same
    kind, and is `row_valid` itself when nothing narrows it."""
    cap = _capacity(row_valid)
    m = None
    for a in args:
        av = _arg_valid(a, cap)
        if av is not None:
            m = av if m is None else m & av
    if cond is not None:
        m = cond if m is None else m & cond
    if m is None:
        return row_valid
    if isinstance(row_valid, agg_ops.RowMask):
        return row_valid.and_mask(m)
    return row_valid & m


class AggregateFunction:
    """Base class: update (rows -> per-group states) and finalize."""

    name: str = ""
    holistic: bool = False
    sum_only: bool = False      # True: all reductions are sums (dense-able)
    # a second step after Grouping.reduce_many (sorted_step)
    two_step: bool = False
    # any ... RESPECT NULLS: the executor keeps NULL rows in the row mask
    respect_nulls: bool = False
    # a mergeable state ends with the count of rows the aggregate saw
    # (_presence): min, max, any, argMin/argMax and groupBitAnd, whose
    # state over no row is not the merge's identity
    keeps_presence: bool = False

    def __init__(self, arg_types: List[dt.DType]):
        self.arg_types = arg_types

    def merge_ops(self) -> List[Tuple[str, bool]]:
        """Each state's merge: (op, unsigned), op a Grouping.reduce op;
        the presence count, where one is kept, is not listed."""
        raise NotImplementedError_(
            f"merging states of {self.name} is not ported to the CUDA "
            f"engine yet")

    def merge(self, states: List[torch.Tensor], g: agg_ops.Grouping,
              mask) -> List[torch.Tensor]:
        """Partial states of several groupings, concatenated (raw order
        of g), merged over g's groups; mask: the partial groups that
        exist.  One reduce_many call (K6 once under the sort grouping)."""
        return g.reduce_many(self.merge_specs(states, mask))

    def merge_specs(self, states: List[torch.Tensor], mask
                    ) -> List[agg_ops.ReduceSpec]:
        """The reductions of :meth:`merge`, in state order (the streamed
        carry hands every aggregate's to one reduce_many)."""
        seen = self._seen(states, mask)
        specs = [(op, st, mask if op in _SUM_LIKE else seen, u)
                 for (op, u), st in zip(self.merge_ops(), states)]
        if self.keeps_presence:
            specs.append(("sum", states[-1], mask, False))
        return specs

    def _seen(self, states: List[torch.Tensor], mask):
        """The partial groups whose states hold a row of the aggregate."""
        return _and_mask(mask, states[-1] > 0) if self.keeps_presence \
            else mask

    def _presence(self, ctx: GroupContext, mask, specs, finish: Finish):
        """(specs, finish) with the count of `mask`'s rows appended as the
        last state where the states will be merged."""
        if not (self.keeps_presence and ctx.mergeable):
            return specs, finish
        k = len(specs)
        return specs + [("count", None, mask, False)], \
            lambda r: finish(r[:k]) + [r[k]]

    def result_type(self) -> dt.DType:
        raise NotImplementedError

    def reductions(self, ctx: GroupContext, args: List[ColVal],
                   cond: Optional[torch.Tensor]
                   ) -> Tuple[List[agg_ops.ReduceSpec], Finish]:
        """-> (specs, finish): the (op, data, mask, unsigned) reductions
        Grouping.reduce_many must run, and the function turning their
        results (in spec order) into this aggregate's states."""
        raise NotImplementedError

    def update(self, ctx: GroupContext, args: List[ColVal],
               cond: Optional[torch.Tensor]) -> List[torch.Tensor]:
        specs, finish = self.reductions(ctx, args, cond)
        return finish(ctx.grouping.reduce_many(specs))

    def pin_state_layout(self) -> None:
        """Make the state's layout independent of the grouping (before it
        is stored as a value: -State, -Merge); uniq pins its register
        count."""

    def finalize(self, states):
        """-> (data, validity or None[, lengths]), each (num_groups_cap,)
        (an Array result: a (num_groups_cap, max_len) matrix and int32
        lengths)."""
        raise NotImplementedError

    def secondary(self, ctx: GroupContext, args: List[ColVal],
                  cond: Optional[torch.Tensor]
                  ) -> List[sort_ops.SortKey]:
        """A holistic aggregate's order of the rows within each group: the
        secondary keys of its sort grouping."""
        raise NotImplementedError

    def sorted_step(self, ctx: GroupContext, g: agg_ops.Grouping,
                    args: List[ColVal], cond: Optional[torch.Tensor],
                    states: List[torch.Tensor]) -> List[torch.Tensor]:
        """A two-step aggregate's states from its reductions' (`states`)
        over `g`: the query's grouping (a sort grouping sorted with this
        aggregate's secondary keys where it is holistic, else the trivial
        one for GROUP BY ())."""
        raise NotImplementedError

    def _row_mask(self, ctx: GroupContext, args: List[ColVal],
                  cond: Optional[torch.Tensor]):
        if ctx.premask is not None:
            return ctx.premask
        return compose_row_mask(ctx.row_valid, args, cond)

    @staticmethod
    def _value(ctx: GroupContext, cv: ColVal) -> torch.Tensor:
        """The argument's values, raw row order: the column as stored
        (K6, K1 and K2 widen as they read), except a term under the dense
        grouping, which is built."""
        cv = cv.broadcast(ctx.capacity)
        return cv.storage if ctx.grouping.kind in ("sort", "trivial") \
            or isinstance(cv, StoredColVal) else cv.data

    @staticmethod
    def _spec_value(ctx: GroupContext, cv: ColVal):
        """A reduction spec's data: :meth:`_value`, but under the sort
        grouping an intDiv/modulo of a stored column as its scan_ops.Term,
        which K6 forms in registers from the gathered storage.  A sorted
        step gathers it with _rows_of, never as a tensor."""
        if ctx.grouping.kind == "sort":
            b = cv.broadcast(ctx.capacity)
            if isinstance(b, TermColVal):
                return b.term
        return AggregateFunction._value(ctx, cv)

    def _logical(self, s: torch.Tensor) -> torch.Tensor:
        """A min/max/any state in the argument's logical type (K6 gives it
        in the storage's); dictionary codes and ranks stay as they are."""
        want = dt.remove_nullable(self.arg_types[0]).torch_dtype
        return s if s.dtype == want or self.arg_types[0].is_dictionary \
            else s.to(want)


_SUM_LIKE = ("sum", "bor", "bxor")


def _and_mask(mask, m: torch.Tensor):
    """mask (a bool tensor or a RowMask) AND m."""
    if isinstance(mask, agg_ops.RowMask):
        return mask.and_mask(m)
    return mask & m


class CountAgg(AggregateFunction):
    name = "count"
    sum_only = True

    def result_type(self):
        return dt.UInt64

    def merge_ops(self):
        return [("sum", False)]

    def reductions(self, ctx, args, cond):
        return [("count", None, self._row_mask(ctx, args, cond), False)], \
            list

    def finalize(self, states):
        return states[0].to(torch.int64), None


def _sum_state_dtype(t: dt.DType) -> torch.dtype:
    """Sum state tensor type: float64 for floats, else 64-bit integer bits
    (UInt64 sums ride in int64 like every u64)."""
    return torch.float64 if dt.is_float(dt.remove_nullable(t)) \
        else torch.int64


class SumAgg(AggregateFunction):
    name = "sum"

    @property
    def sum_only(self):
        return not dt.is_float(dt.remove_nullable(self.arg_types[0]))

    def result_type(self):
        t0 = dt.remove_nullable(self.arg_types[0])
        if dt.is_decimal(t0):
            return dt.Decimal(38, t0.decimal_scale)
        if dt.is_float(t0):
            return dt.Float64
        return dt.UInt64 if t0.np_dtype.kind == "u" else dt.Int64

    def merge_ops(self):
        return [("sum", False)]

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        want = _sum_state_dtype(self.arg_types[0])
        return [("sum", self._spec_value(ctx, args[0]), mask, False)], \
            lambda r: [r[0].to(want)]

    def finalize(self, states):
        return states[0], None


class MinMaxAgg(AggregateFunction):
    op = "min"
    keeps_presence = True

    def __init__(self, arg_types):
        super().__init__(arg_types)
        self._dict_order: Optional[torch.Tensor] = None

    def result_type(self):
        return dt.remove_nullable(self.arg_types[0])

    def _prep(self, ctx, cv: ColVal):
        """Dictionary (string) args aggregate lexicographic ranks, mapped
        back to codes in finalize."""
        if cv.dictionary is not None and len(cv.dictionary):
            v = self._value(ctx, cv)
            vals = cv.dictionary.values.astype(str)
            order = np.argsort(vals, kind="stable")
            rank = np.empty(len(vals), np.int64)
            rank[order] = np.arange(len(vals))
            self._dict_order = torch.from_numpy(order.astype(np.int32)) \
                .to(v.device)
            return torch.from_numpy(rank).to(v.device)[v.clamp(min=0).long()]
        return self._spec_value(ctx, cv)

    def _unsigned(self) -> bool:
        return dt.remove_nullable(self.arg_types[0]).np_dtype == \
            np.dtype("uint64") and not self.arg_types[0].is_dictionary

    def merge_ops(self):
        return [(self.op, self._unsigned())]

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        v = self._prep(ctx, args[0])
        return self._presence(
            ctx, mask, [(self.op, v, mask, self._unsigned())],
            lambda r: [self._logical(r[0])])

    def finalize(self, states):
        s = states[0]
        if self._dict_order is not None:
            n = self._dict_order.shape[0]
            s = self._dict_order[s.clamp(0, n - 1).long()]
        return s, None


class MinAgg(MinMaxAgg):
    name, op = "min", "min"


class MaxAgg(MinMaxAgg):
    name, op = "max", "max"


class AvgAgg(AggregateFunction):
    name = "avg"

    @property
    def sum_only(self):
        return not dt.is_float(dt.remove_nullable(self.arg_types[0]))

    def result_type(self):
        return dt.Float64

    def _unsigned(self):
        return dt.remove_nullable(self.arg_types[0]).np_dtype.kind == "u"

    def merge_ops(self):
        return [("sum", False), ("sum", False)]

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return [("sum", self._spec_value(ctx, args[0]), mask, False),
                ("count", None, mask, False)], self._states

    def _states(self, r):
        s, c = r
        s = dt.u64_to_f64(s) if self._unsigned() and not s.is_floating_point() \
            else s.to(torch.float64)
        return [s, c]

    def finalize(self, states):
        s, c = states
        s = dt.u64_to_f64(s) if self._unsigned() and not s.is_floating_point() \
            else s.to(torch.float64)
        safe = torch.clamp(c, min=1)
        out = s / safe.to(torch.float64)
        t0 = dt.remove_nullable(self.arg_types[0])
        if dt.is_decimal(t0):
            out = out / float(10 ** t0.decimal_scale)
        return out, None


class AnyAgg(AggregateFunction):
    name = "any"
    keeps_presence = True

    def result_type(self):
        return self.arg_types[0]

    def merge_ops(self):
        return [("any", False)]

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return self._presence(
            ctx, mask, [("any", self._spec_value(ctx, args[0]), mask, False)],
            lambda r: [self._logical(r[0])])

    def finalize(self, states):
        return states[0], None


class AnyRespectNullsAgg(AggregateFunction):
    """any/first_value/last_value ... RESPECT NULLS: a row of the group with
    NULL a value like any other, so any(x) RESPECT NULLS over [NULL, 1] is
    NULL (ClickHouse's AggregateFunctionAnyRespectNulls).  Both states take
    the same row, the first masked-in one: its value and its validity (a
    group's row count where the argument has no validity)."""
    name = "any_respect_nulls"
    keeps_presence = True
    respect_nulls = True

    def result_type(self):
        return self.arg_types[0]

    def merge_ops(self):
        return [("any", False), ("any", False)]

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        specs = [("any", self._spec_value(ctx, args[0]), mask, False)]
        av = _arg_valid(args[0], ctx.capacity)
        if av is None:
            specs.append(("count", None, mask, False))
            return self._presence(
                ctx, mask, specs,
                lambda r: [self._logical(r[0]), (r[1] > 0).to(torch.uint8)])
        specs.append(("any", av, mask, False))
        return self._presence(ctx, mask, specs,
                              lambda r: [self._logical(r[0]), r[1]])

    def _row_mask(self, ctx, args, cond):
        if ctx.premask is not None:
            return ctx.premask
        return compose_row_mask(ctx.row_valid, [], cond)

    def finalize(self, states):
        return states[0], states[1].to(torch.uint8)


def _numeric(agg: AggregateFunction, *which: int) -> None:
    """A statistic takes numbers: raise TypeError_ for another argument, or
    for one of `which` not given."""
    if which and max(which) >= len(agg.arg_types):
        raise TypeError_(f"Aggregate function {agg.name} takes "
                         f"{max(which) + 1} arguments, got "
                         f"{len(agg.arg_types)}")
    for i in which:
        t = dt.remove_nullable(agg.arg_types[i])
        if t.is_dictionary or t.is_array or dt.is_map(t) \
                or t.np_dtype.kind not in "iufb":
            raise TypeError_(f"Illegal type {agg.arg_types[i]} of argument "
                             f"of aggregate function {agg.name}")


def _u64(cv: ColVal, data: torch.Tensor) -> bool:
    """data holds UInt64 bits."""
    return dt.remove_nullable(cv.dtype).np_dtype == np.uint64 \
        and data.dtype == torch.int64


def _f64_sum(ctx: GroupContext, mask, cv: ColVal, power: int = 1,
             times: Optional[ColVal] = None) -> agg_ops.ReduceSpec:
    """The reduction summing, over `mask`, the argument's value in float64
    raised to `power` (x*x, (x*x)*x, (x*x)*(x*x), as the reference
    multiplies), times `times`' value where given.  Under the sort
    grouping an fsumx spec (scan_ops.Spec), whose term K6 forms in
    registers from the columns as stored; else a sum of its float64
    column, built once for the GROUP BY and held against the aggregates'
    budget (ctx.hold)."""
    x = AggregateFunction._spec_value(ctx, cv)
    y = None if times is None else AggregateFunction._spec_value(ctx, times)
    term = (x, y, power)
    unsigned = (_u64(cv, x), y is not None and _u64(times, y))
    if ctx.grouping.kind == "sort":
        return "fsumx", term, mask, unsigned
    col = ctx.built(f"f64^{power}", (x,) if y is None else (x, y),
                    lambda: scan_ops.fsumx_column(term, unsigned),
                    8 * x.shape[0], f"a float64 column of {cv.dtype}")
    return "sum", col, mask, False


class SumSquaresMixin(AggregateFunction):
    """The variance family's states: [sum, sum of squares, count], summed
    in float64 (over the sort grouping in the same K6 launch as the
    query's other aggregates)."""

    def __init__(self, arg_types):
        super().__init__(arg_types)
        _numeric(self, 0)

    def result_type(self):
        return dt.Float64

    def merge_ops(self):
        return [("sum", False)] * 3

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return [_f64_sum(ctx, mask, args[0]), _f64_sum(ctx, mask, args[0], 2),
                ("count", None, mask, False)], list

    def _moments(self, states):
        s, s2, c = states
        cf = torch.clamp(c, min=1).to(torch.float64)
        mean = s / cf
        var = s2 / cf - mean * mean
        return torch.clamp(var, min=0.0), c.to(torch.float64)


class VarPopAgg(SumSquaresMixin):
    name = "varPop"

    def finalize(self, states):
        return self._moments(states)[0], None


class VarSampAgg(SumSquaresMixin):
    name = "varSamp"

    def finalize(self, states):
        var, c = self._moments(states)
        return var * (c / torch.clamp(c - 1.0, min=1.0)), None


class StddevPopAgg(VarPopAgg):
    name = "stddevPop"

    def finalize(self, states):
        return torch.sqrt(self._moments(states)[0]), None


class StddevSampAgg(VarSampAgg):
    name = "stddevSamp"

    def finalize(self, states):
        return torch.sqrt(VarSampAgg.finalize(self, states)[0]), None


def _rows_of(t, rows: torch.Tensor) -> torch.Tensor:
    """A spec value (AggregateFunction._spec_value) at raw rows `rows`: a
    scan_ops.Term gathers its narrow source and forms the term there
    (Term.index_select), a tensor gathers itself: the one tensor method a
    sorted step calls on a Term."""
    return t.index_select(0, rows)


def _take(ctx: GroupContext, g: agg_ops.Grouping, t,
          what: str) -> torch.Tensor:
    """A spec value (raw row order) in g's sorted order (_rows_of by
    g.perm, as Grouping.take), gathered once for the GROUP BY and held
    against the aggregates' budget."""
    return ctx.built("take", (t, g.perm), lambda: _rows_of(t, g.perm),
                     g.perm.shape[0] * t.dtype.itemsize, what)


def _take_mask(ctx: GroupContext, g: agg_ops.Grouping,
               mask) -> Optional[torch.Tensor]:
    """A row mask in g's sorted order (Grouping.sorted_mask), gathered once
    for the GROUP BY; None for the grouping's own rows."""
    if mask is None or mask is g.row_valid_ref:
        return None
    return ctx.built("take", (mask, g.perm), lambda: g.sorted_mask(mask),
                     g.perm.shape[0], "a row mask in sorted order")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """Values compared as the reference compares order tokens: floats by
    their bits (-0.0 and +0.0 two values, equal NaNs one), others as
    they are."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


class ArgMinMaxAgg(AggregateFunction):
    """argMin(val, ord) / argMax: val at the row of the smallest (largest)
    ord, by order value (floats: -0.0 below +0.0, a positive NaN above
    every number); of the rows at that value, the lowest row id.  A String
    ord compares its dictionary ranks (ClickHouse's string order; the
    reference compares codes).

    Step 1 (reduce_many): the best ord a group.  Step 2 (sorted_step): the
    rows at it, in sorted order, and the smallest row id among them (K6's
    sorted-order entry over the grouping's perm); under GROUP BY () the
    first such row (K1's `any`)."""
    minimize = True
    two_step = True
    keeps_presence = True

    def result_type(self):
        return dt.remove_nullable(self.arg_types[0])

    def _order(self, ctx, cv: ColVal) -> Tuple[object, bool]:
        """ord as K6/K1 compare it (a spec value: _spec_value's Term for an
        intDiv/modulo under the sort grouping), and whether it is UInt64
        bits."""
        if cv.dictionary is not None and len(cv.dictionary):
            v = self._value(ctx, cv)
            def make():
                vals = cv.dictionary.values.astype(str)
                rank = np.empty(len(vals), np.int64)
                rank[np.argsort(vals, kind="stable")] = np.arange(len(vals))
                return torch.from_numpy(rank).to(v.device)[
                    v.clamp(min=0).long()]
            return ctx.built("rank", (v,), make, 8 * v.shape[0],
                             "dictionary ranks"), False
        v = self._spec_value(ctx, cv)
        if ctx.grouping.kind == "trivial" and v.is_floating_point():
            # K1's float min/max propagate NaN; the order is the token's
            return ctx.built("token", (v,), lambda: sort_ops.order_value(
                sort_ops.SortKey(v)), 8 * v.shape[0], "order tokens"), True
        unsigned = dt.remove_nullable(cv.dtype).np_dtype == np.uint64 \
            and v.dtype == torch.int64
        return v, unsigned

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        o, uns = self._order(ctx, args[1])
        return self._presence(
            ctx, mask, [("min" if self.minimize else "max", o, mask, uns)],
            list)

    def merge_ops(self):
        # a mergeable order state is an int64 in signed order (_order_state)
        return [("min" if self.minimize else "max", False), ("any", False)]

    def merge(self, states, g, mask):
        """The best order value of the merged group, then the value of
        its first partial (in g's raw order) at that value: the earliest
        chunk's, whose row ids are the lowest."""
        best, val = states[0], states[1]
        seen = self._seen(states, mask)
        (op, _), _ = self.merge_ops()
        b = g.reduce(op, best, seen)
        if g.kind == "trivial":
            v = g.reduce("any", val, _and_mask(seen, _bits(best)
                                               == _bits(b)[0]))
        else:
            gid = torch.clamp(g.group_ids, max=g.num_groups_cap - 1)
            at_best = _bits(g.take(best)) == _bits(b).index_select(0, gid)
            ms = g.sorted_mask(seen)
            if ms is not None:
                at_best &= ms
            rows, cnt = g.reduce_sorted([("min", g.perm, at_best, False),
                                         ("count", None, at_best, False)])
            v = val.index_select(0, rows.to(torch.int64).clamp_(
                0, val.shape[0] - 1))
            v = torch.where(cnt > 0, v, torch.zeros((), dtype=v.dtype,
                                                    device=v.device))
        return [b, v, g.reduce("sum", states[-1], mask)]

    def sorted_step(self, ctx, g, args, cond, states):
        """-> [order state, value state] (+ the presence count).  A
        mergeable order state is the order token with its top bit flipped
        (_order_state), so the merge compares every order state signed and
        a stored state holds the reference's token."""
        mask = self._row_mask(ctx, args, cond)
        o, uns = self._order(ctx, args[1])
        first = states[0]
        if ctx.mergeable:
            first = _order_state(first, uns, self.arg_types[1])
        best = _bits(states[0])
        v = self._spec_value(ctx, args[0])
        if g.kind == "perrow":           # a row a group: its own value
            return [first, self._logical(g.reduce("any", v, mask))] \
                + states[1:]
        if g.kind == "trivial":
            ctx.hold(o.shape[0], f"{self.name}'s rows at the best value")
            at_best = _bits(o) == best[0]
            at = mask.and_mask(at_best) if isinstance(mask, agg_ops.RowMask) \
                else mask & at_best
            return [first, self._logical(g.reduce("any", v, at))] \
                + states[1:]
        os_ = _take(ctx, g, o, f"{self.name}'s order in sorted order")
        ms = _take_mask(ctx, g, mask)
        ctx.hold(g.perm.shape[0] * (best.element_size() + 1),
                 f"{self.name}'s rows at the best value")
        gid = torch.clamp(g.group_ids, max=g.num_groups_cap - 1)
        at_best = _bits(os_) == best.index_select(0, gid)
        if ms is not None:
            at_best &= ms
        rows, cnt = g.reduce_sorted([("min", g.perm, at_best, False),
                                     ("count", None, at_best, False)])
        val = _rows_of(v, rows.to(torch.int64))
        val = torch.where(cnt > 0, val, torch.zeros((), dtype=val.dtype,
                                                    device=val.device))
        return [first, self._logical(val)] + states[1:]

    def finalize(self, states):
        return states[1], None


class ArgMinAgg(ArgMinMaxAgg):
    name, minimize = "argMin", True


class ArgMaxAgg(ArgMinMaxAgg):
    name, minimize = "argMax", False


def notm_key(ctx: GroupContext, mask) -> List[sort_ops.SortKey]:
    """[the masked-out flag as a secondary key] where an aggregate's rows
    are not the grouping's own (its masked-in rows then sort first in each
    group), else []."""
    if mask is ctx.row_valid:
        return []
    m = mask.tensor() if isinstance(mask, agg_ops.RowMask) else mask
    return [sort_ops.SortKey(ctx.built("notm", (m,), lambda: ~m, m.shape[0],
                                       "masked-out flags"), bounds=(0, 1))]


def value_key(cv: ColVal, capacity: int) -> sort_ops.SortKey:
    """A column as a secondary key: its storage (_value's, as stored),
    unsigned where it holds UInt64 bits, with its proven bounds (floats by
    their token: -0.0 below +0.0, NaNs last)."""
    v = cv.broadcast(capacity).storage
    unsigned = dt.remove_nullable(cv.dtype).np_dtype == np.uint64 \
        and v.dtype == torch.int64
    b = cv.bounds if cv.dictionary is None else None
    return sort_ops.SortKey(v, unsigned=unsigned, bounds=b)


class _SortedValues(AggregateFunction):
    """A holistic aggregate over its argument's values in order within
    each group: the sort grouping by (keys, masked-out flag, value), so
    each group's masked-in rows come first, in value order (floats by
    token: -0.0 below +0.0, NaNs last)."""
    holistic = True
    two_step = True

    def secondary(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return notm_key(ctx, mask) + [value_key(args[0], ctx.capacity)]


class UniqExactAgg(_SortedValues):
    """Exact distinct count: in each group's value-sorted masked-in rows,
    the rows whose decoded value differs from the row before (as the
    reference compares them: NaN rows count one each, -0.0 and +0.0 once
    together; a String by its dictionary code), counted with K6's
    sorted-order entry."""
    name = "uniqExact"

    def __init__(self, arg_types):
        super().__init__(arg_types)
        if len(arg_types) != 1:
            # ClickHouse counts distinct tuples; the reference reads the
            # first argument alone (exprs/aggregates.py:450)
            raise NotImplementedError_(
                f"uniqExact of {len(arg_types)} arguments (distinct tuples) "
                f"is not ported to the CUDA engine yet")

    def result_type(self):
        return dt.UInt64

    def reductions(self, ctx, args, cond):
        return [], list

    def sorted_step(self, ctx, g, args, cond, states):
        mask = self._row_mask(ctx, args, cond)
        v = self._spec_value(ctx, args[0])
        n = g.perm.shape[0]
        vs = _take(ctx, g, v, "uniqExact's sorted values")
        ms = _take_mask(ctx, g, mask)
        ctx.hold(2 * n, "uniqExact's first-occurrence flags")
        gid = g.group_ids
        first = torch.ones(n, dtype=torch.bool, device=vs.device)
        if n > 1:
            first[1:] = (vs[1:] != vs[:-1]) | (gid[1:] != gid[:-1])
        if ms is not None:
            first &= ms
        return g.reduce_sorted([("count", None, first, False)])

    def finalize(self, states):
        return states[0], None


class QuantileExactAgg(_SortedValues):
    """quantileExact(q)(x): in each group's value-sorted masked-in rows,
    the one at floor(q * (len - 1)), read at starts[g] + that offset (the
    reference compacts the masked-in values first: its sort carries the
    mask as a payload; here the masked-out rows sort after them).  A group
    without a masked-in row gives 0, or NaN for floats (ClickHouse's
    QuantileExact; the reference reads a neighbouring group's value).
    With `qs` (quantiles(q1, ...)(x)) an Array of each level.

    `rule` picks the value: "low" is the reference's floor(q * (len - 1));
    the subclasses take ClickHouse's rules of their spellings, which the
    reference serves with this one."""
    name = "quantileExact"
    rule = "low"

    def __init__(self, arg_types, q: float = 0.5, qs=None):
        super().__init__(arg_types)
        self.q = q
        self.qs = list(qs) if qs is not None else None
        t = dt.remove_nullable(arg_types[0])
        if t.is_dictionary or t.is_array:
            raise TypeError_(f"Illegal type {arg_types[0]} of argument of "
                             f"aggregate function {self.name}")

    def result_type(self):
        base = dt.Float64 if self.rule in _INTERPOLATING \
            else dt.remove_nullable(self.arg_types[0])
        return dt.Array(base) if self.qs is not None else base

    def _pick(self, g, v, lens, q):
        """Each group's value at level q (lens: its masked-in rows)."""
        last = max(g.perm.shape[0] - 1, 0)
        top = torch.clamp(lens - 1, min=0)
        nf = lens.to(torch.float64)

        def at(off):
            pos = torch.clamp(g.starts + torch.minimum(
                torch.clamp(off, min=0), top), 0, last)
            return _rows_of(v, g.perm.index_select(0, pos).long())
        if self.rule not in _INTERPOLATING:
            off = torch.floor(q * (nf - 1.0)) if self.rule == "low" \
                else torch.floor(nf / 2) if q == 0.5 \
                else torch.floor(q * nf) if q < 1 else nf - 1.0
            val = self._logical(at(off.to(torch.int64)))
            empty = float("nan") if val.is_floating_point() else 0
            return torch.where(lens > 0, val, torch.full_like(val, empty))
        # ClickHouse's QuantileExactExclusive / Inclusive: h is the level's
        # 1-based rank; between ranks floor(h) and floor(h) + 1, linearly
        h = q * (nf + 1.0) if self.rule == "exclusive" \
            else q * (nf - 1.0) + 1.0
        k = torch.floor(h).to(torch.int64)
        inside = (k >= 1) & (k < lens)
        lo = torch.where(k >= lens, top, k - 1)
        frac = torch.where(inside, h - k.to(torch.float64), 0.0)
        unsigned = dt.remove_nullable(self.arg_types[0]).np_dtype \
            == np.uint64 and v.dtype == torch.int64

        def f64(t):
            return dt.u64_to_f64(t) if unsigned else t.to(torch.float64)
        a = f64(at(lo))
        val = a + frac * (f64(at(lo + 1)) - a)
        return torch.where(lens > 0, val, torch.full_like(val, float("nan")))

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return [("count", None, mask, False)], list

    def sorted_step(self, ctx, g, args, cond, states):
        lens = states[0]
        v = self._spec_value(ctx, args[0])
        picks = [self._pick(g, v, lens, q)
                 for q in (self.qs if self.qs is not None else [self.q])]
        if self.qs is None:
            return picks
        k = len(picks)
        width = -(-k // 8) * 8
        mat = torch.zeros((lens.shape[0], width), dtype=picks[0].dtype,
                          device=lens.device)
        mat[:, :k] = torch.stack(picks, dim=1)
        return [mat, torch.full(lens.shape, k, dtype=torch.int32,
                                device=lens.device)]

    def finalize(self, states):
        if self.qs is not None:
            return states[0], None, states[1]
        return states[0], None


# the rules that interpolate between two ranks (a Float64 result)
_INTERPOLATING = ("exclusive", "inclusive")


class QuantileExactHighAgg(QuantileExactAgg):
    """quantileExactHigh: ClickHouse's QuantileExactHigh, the upper
    median at level 0.5 (floor(len / 2)), else floor(q * len) (len - 1 at
    q >= 1)."""
    name, rule = "quantileExactHigh", "high"


class QuantileExactExclusiveAgg(QuantileExactAgg):
    """quantileExactExclusive: ClickHouse's QuantileExactExclusive (Excel
    PERCENTILE.EXC, R-6): rank h = q * (len + 1), linear between the
    values about it, a Float64; levels 0 and 1 are refused."""
    name, rule = "quantileExactExclusive", "exclusive"

    def __init__(self, arg_types, q: float = 0.5, qs=None):
        super().__init__(arg_types, q, qs)
        for level in (self.qs if self.qs is not None else [q]):
            if level in (0.0, 1.0):
                raise AnalysisError(
                    f"{self.name} cannot interpolate for the levels 0 "
                    f"and 1")


class QuantileExactInclusiveAgg(QuantileExactAgg):
    """quantileExactInclusive (and quantileInterpolated, whose name asks
    for linear interpolation): ClickHouse's QuantileExactInclusive (Excel
    PERCENTILE.INC, R-7): rank h = q * (len - 1) + 1, linear between the
    values about it, a Float64."""
    name, rule = "quantileExactInclusive", "inclusive"


class MedianAgg(QuantileExactAgg):
    name = "median"

    def __init__(self, arg_types):
        super().__init__(arg_types, q=0.5)


class MedianExactHighAgg(QuantileExactHighAgg):
    name = "medianExactHigh"

    def __init__(self, arg_types):
        super().__init__(arg_types, q=0.5)


class CovarAgg(AggregateFunction):
    """covarPop/covarSamp(x, y): [sum xy, sum x, sum y, n] in float64."""
    sample = False

    def __init__(self, arg_types):
        super().__init__(arg_types)
        _numeric(self, 0, 1)

    def result_type(self):
        return dt.Float64

    def merge_ops(self):
        return [("sum", False)] * 4

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return [_f64_sum(ctx, mask, args[0], times=args[1]),
                _f64_sum(ctx, mask, args[0]), _f64_sum(ctx, mask, args[1]),
                ("count", None, mask, False)], list

    def finalize(self, states):
        sxy, sx, sy, n = states
        nf = n.to(torch.float64)
        safe = torch.clamp(nf, min=1.0)
        cov = sxy / safe - (sx / safe) * (sy / safe)
        if self.sample:
            cov = torch.where(n > 1, cov * nf / (nf - 1.0),
                              torch.full_like(cov, float("nan")))
        return cov, None


class CovarPopAgg(CovarAgg):
    name, sample = "covarPop", False


class CovarSampAgg(CovarAgg):
    name, sample = "covarSamp", True


class CorrAgg(AggregateFunction):
    """corr(x, y): [sum xy, sum x, sum y, sum x^2, sum y^2, n] in
    float64."""
    name = "corr"

    def __init__(self, arg_types):
        super().__init__(arg_types)
        _numeric(self, 0, 1)

    def result_type(self):
        return dt.Float64

    def merge_ops(self):
        return [("sum", False)] * 6

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return [_f64_sum(ctx, mask, args[0], times=args[1]),
                _f64_sum(ctx, mask, args[0]), _f64_sum(ctx, mask, args[1]),
                _f64_sum(ctx, mask, args[0], 2),
                _f64_sum(ctx, mask, args[1], 2),
                ("count", None, mask, False)], list

    def finalize(self, states):
        sxy, sx, sy, sxx, syy, n = states
        nf = torch.clamp(n.to(torch.float64), min=1.0)
        num = sxy - sx * sy / nf
        den = torch.sqrt(torch.clamp(sxx - sx * sx / nf, min=0.0)
                         * torch.clamp(syy - sy * sy / nf, min=0.0))
        return torch.where(den > 0, num / den,
                           torch.full_like(num, float("nan"))), None


class MomentsAgg(AggregateFunction):
    """skewness/kurtosis: [sum x, x^2, x^3, x^4, n] in float64."""

    def __init__(self, arg_types):
        super().__init__(arg_types)
        _numeric(self, 0)

    def result_type(self):
        return dt.Float64

    def merge_ops(self):
        return [("sum", False)] * 5

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return [_f64_sum(ctx, mask, args[0], p) for p in (1, 2, 3, 4)] \
            + [("count", None, mask, False)], list

    def _central(self, states):
        s1, s2, s3, s4, n = states
        nf = torch.clamp(n.to(torch.float64), min=1.0)
        m = s1 / nf
        m2 = s2 / nf - m * m
        m3 = s3 / nf - 3 * m * s2 / nf + 2 * m ** 3
        m4 = s4 / nf - 4 * m * s3 / nf + 6 * m * m * s2 / nf - 3 * m ** 4
        var_samp = torch.where(n > 1, m2 * nf / (nf - 1.0),
                               torch.full_like(m2, float("nan")))
        return torch.clamp(m2, min=0.0), m3, m4, var_samp


def _nan_unless(ok: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, v, torch.full_like(v, float("nan")))


class SkewPopAgg(MomentsAgg):
    name = "skewPop"

    def finalize(self, states):
        m2, m3, _, _ = self._central(states)
        return _nan_unless(m2 > 0, m3 / m2 ** 1.5), None


class SkewSampAgg(MomentsAgg):
    name = "skewSamp"

    def finalize(self, states):
        _, m3, _, vs = self._central(states)
        return _nan_unless(vs > 0, m3 / vs ** 1.5), None


class KurtPopAgg(MomentsAgg):
    name = "kurtPop"

    def finalize(self, states):
        m2, _, m4, _ = self._central(states)
        return _nan_unless(m2 > 0, m4 / (m2 * m2)), None


class KurtSampAgg(MomentsAgg):
    name = "kurtSamp"

    def finalize(self, states):
        _, _, m4, vs = self._central(states)
        return _nan_unless(vs > 0, m4 / (vs * vs)), None


class AvgWeightedAgg(AggregateFunction):
    """avgWeighted(x, w): [sum x*w, sum w] in float64."""
    name = "avgWeighted"

    def __init__(self, arg_types):
        super().__init__(arg_types)
        _numeric(self, 0, 1)

    def result_type(self):
        return dt.Float64

    def merge_ops(self):
        return [("sum", False)] * 2

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return [_f64_sum(ctx, mask, args[0], times=args[1]),
                _f64_sum(ctx, mask, args[1])], list

    def finalize(self, states):
        s, w = states
        return _nan_unless(w != 0, s / w), None


class SumWithOverflowAgg(SumAgg):
    """sum in the argument's own type, wrapping (ClickHouse's
    sumWithOverflow)."""
    name = "sumWithOverflow"

    def result_type(self):
        return dt.remove_nullable(self.arg_types[0])

    def finalize(self, states):
        t = dt.remove_nullable(self.arg_types[0])
        src = np.float64 if states[0].is_floating_point() \
            else np.uint64 if t.np_dtype == np.uint64 else np.int64
        return dt.cast_tensor(states[0], src, t.np_dtype), None


class GroupBitAgg(AggregateFunction):
    """groupBitAnd/Or/Xor over an integer argument: K6's (K1's) band, bor
    and bxor of the values' bits, in the argument's type."""
    bit_op = "bor"

    @property
    def keeps_presence(self) -> bool:
        return self.bit_op == "band"

    def result_type(self):
        t0 = dt.remove_nullable(self.arg_types[0])
        if not dt.is_integer(t0):
            raise TypeError_(f"{self.name} requires an integer argument")
        return t0

    def merge_ops(self):
        return [(self.bit_op, False)]

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return self._presence(
            ctx, mask,
            [(self.bit_op, self._spec_value(ctx, args[0]), mask, False)],
            list)

    def finalize(self, states):
        t = dt.remove_nullable(self.arg_types[0]).np_dtype
        s = states[0]
        src = np.uint64 if t == np.uint64 else \
            np.dtype(f"int{8 * s.element_size()}") if s.dtype != torch.uint8 \
            else np.uint8
        return dt.cast_tensor(s, src, t), None


class GroupBitAndAgg(GroupBitAgg):
    name, bit_op = "groupBitAnd", "band"


class GroupBitOrAgg(GroupBitAgg):
    name, bit_op = "groupBitOr", "bor"


class GroupBitXorAgg(GroupBitAgg):
    name, bit_op = "groupBitXor", "bxor"


def _register_base() -> Dict[str, type]:
    """The reference's _register_base (exprs/aggregates.py:743-884), less
    the names whose result is a Tuple (TUPLE_AGGREGATES: the port has no
    Tuple value yet).  quantilesExactWeighted takes the weighted class (the
    reference serves it with the unweighted one: A3)."""
    from . import agg_ext as ax, agg_ext2 as ax2, agg_ext3 as ax3
    from . import agg_ext4 as ax4
    from . import agg_sketch as sk
    base: Dict[str, type] = {}
    for _cls in [CountAgg, SumAgg, MinAgg, MaxAgg, AvgAgg, AnyAgg, VarPopAgg,
                 VarSampAgg, StddevPopAgg, StddevSampAgg, ArgMinAgg,
                 ArgMaxAgg, UniqExactAgg, MedianAgg, CovarPopAgg,
                 CovarSampAgg, CorrAgg, SkewPopAgg, SkewSampAgg, KurtPopAgg,
                 KurtSampAgg, AvgWeightedAgg, SumWithOverflowAgg,
                 GroupBitAndAgg, GroupBitOrAgg, GroupBitXorAgg,
                 sk.GroupArrayAgg, sk.GroupUniqArrayAgg, sk.TopKAgg,
                 sk.EntropyAgg, sk.HLLUniqAgg]:
        base[_cls.name.lower()] = _cls
    for alias, cls in {
            "uniqcombined": sk.HLLUniqAgg, "uniqcombined64": sk.HLLUniqAgg,
            "uniqhll12": sk.HLLUniqAgg, "uniqtheta": sk.HLLUniqAgg,
            "grouparraydistinct": sk.GroupUniqArrayAgg,
            "anylast": AnyAgg, "anyheavy": AnyAgg, "any_value": AnyAgg,
            "first_value": AnyAgg, "last_value": AnyAgg,
            "any_respect_nulls": AnyRespectNullsAgg,
            "anylast_respect_nulls": AnyRespectNullsAgg,
            "first_value_respect_nulls": AnyRespectNullsAgg,
            "last_value_respect_nulls": AnyRespectNullsAgg,
            "countdistinct": UniqExactAgg, "uniqthetasketch": UniqExactAgg,
            "groupbitmap": UniqExactAgg,
            "var_pop": VarPopAgg, "var_samp": VarSampAgg,
            "stddev_pop": StddevPopAgg, "stddev_samp": StddevSampAgg,
            "varpopstable": VarPopAgg, "varsampstable": VarSampAgg,
            "stddevpopstable": StddevPopAgg,
            "stddevsampstable": StddevSampAgg,
            "covar_pop": CovarPopAgg, "covar_samp": CovarSampAgg,
            "covarpopstable": CovarPopAgg, "covarsampstable": CovarSampAgg,
            "corrstable": CorrAgg, "sumkahan": SumAgg}.items():
        base[alias] = cls
    # the quantile and median spellings the sort path serves exactly; those
    # whose ClickHouse rule is not the reference's take their own class
    for name in _QUANTILE_NAMES:
        base[name] = _QUANTILE_RULES.get(name.replace("quantiles", "quantile"),
                                         QuantileExactAgg)
    for name in _MEDIAN_NAMES:
        base[name] = MedianExactHighAgg if name == "medianexacthigh" \
            else MedianAgg
    # the aggregate tail of agg_ext.py ... agg_ext4.py
    for _cls in [ax.DeltaSumAgg, ax.QuantileExactWeightedAgg, ax.UniqUpToAgg,
                 ax.GroupArrayMovingSumAgg, ax.GroupArrayMovingAvgAgg,
                 ax2.WindowFunnelAgg, ax2.SequenceMatchAgg, ax2.RetentionAgg,
                 ax2.RankCorrAgg, ax2.BoundingRatioAgg,
                 ax3.GroupArraySortedAgg, ax3.GroupArrayLastAgg,
                 ax3.GroupArraySampleAgg, ax3.SingleValueOrNullAgg,
                 ax3.ExponentialMovingAverageAgg,
                 ax3.ExponentialTimeDecayedSumAgg,
                 ax3.ExponentialTimeDecayedCountAgg,
                 ax3.ExponentialTimeDecayedAvgAgg,
                 ax3.ExponentialTimeDecayedMaxAgg, ax3.IntervalLengthSumAgg,
                 ax3.MaxIntersectionsAgg, ax3.MaxIntersectionsPositionAgg,
                 ax3.CramersVAgg, ax3.CramersVBiasCorrectedAgg,
                 ax3.TheilsUAgg, ax3.ContingencyAgg, ax4.TopKWeightedAgg,
                 ax4.DeltaSumTimestampAgg, ax4.NothingAgg, ax4.AggThrowAgg]:
        base[_cls.name.lower()] = _cls
    # the weighted quantile spellings (reference :814-816, :843-846,
    # :872-875): the exact weighted rule; the Interpolated ones mirror the
    # reference's (A5), the TDigest, Timing and BFloat16 ones are
    # approximate in ClickHouse, so the exact answer stands
    for name in _WEIGHTED_NAMES:
        base[name] = ax.MedianExactWeightedAgg if name.startswith("median") \
            else ax.QuantileExactWeightedAgg
    return base


_WEIGHTED_NAMES = (
    "quantileinterpolatedweighted", "quantiletimingweighted",
    "quantiletdigestweighted", "quantilebfloat16weighted",
    "quantilesexactweighted", "medianexactweighted",
    "medianinterpolatedweighted", "mediantimingweighted",
    "mediantdigestweighted")
# the reference's names whose result is a Tuple: they wait for the Tuple
# column type (each raises UnknownFunction naming it)
TUPLE_AGGREGATES = frozenset({
    "summap", "minmap", "maxmap", "summappedarrays", "minmappedarrays",
    "maxmappedarrays", "sumcount", "simplelinearregression",
    "stochasticlinearregression", "studentttest", "welchttest", "meanztest",
    "mannwhitneyutest", "kolmogorovsmirnovtest", "analysisofvariance",
    "anova"})
# the parameters of the tail: sizes (the reference's _SIZED), a window, a
# count, or the parameters as a list (param_ctor)
_TAIL_SIZED = ("topkweighted", "grouparraysorted", "grouparraylast",
               "grouparraysample")
_PARAM_LIST = ("windowfunnel", "sequencematch", "exponentialmovingaverage",
               "exponentialtimedecayedsum", "exponentialtimedecayedcount",
               "exponentialtimedecayedavg", "exponentialtimedecayedmax",
               "aggthrow")


_QUANTILE_RULES = {"quantileexacthigh": QuantileExactHighAgg,
                   "quantileexactexclusive": QuantileExactExclusiveAgg,
                   "quantileexactinclusive": QuantileExactInclusiveAgg,
                   "quantileinterpolated": QuantileExactInclusiveAgg}


_QUANTILE_NAMES = (
    "quantile", "quantileexact", "quantileexactlow", "quantileexacthigh",
    "quantileexactexclusive", "quantileexactinclusive", "quantiletdigest",
    "quantiledeterministic", "quantiletiming", "quantilebfloat16",
    "quantilegk", "quantiledd", "quantileinterpolated", "quantiles",
    "quantilesexact", "quantilesexactlow", "quantilesexacthigh",
    "quantilesexactexclusive", "quantilesexactinclusive",
    "quantilesbfloat16", "quantilesdeterministic", "quantilesinterpolated",
    "quantilesgk", "quantilestiming", "quantilestdigest", "quantilesdd")
_MEDIAN_NAMES = ("medianexact", "medianexactlow", "medianexacthigh",
                 "mediantdigest", "mediantiming", "medianbfloat16",
                 "mediandeterministic", "mediandd")
# the spellings whose result is an Array of every level (reference :925)
_MULTI_Q = frozenset(n for n in _QUANTILE_NAMES if n.startswith("quantiles"))

_BASE: Dict[str, type] = _register_base()
AGGREGATES = _BASE


# Every aggregate name the reference registers (lower case, its
# AGGREGATES once all of its modules are loaded; a test holds the copy to
# that registry).  The analyzer treats each as an aggregate call, so an
# unported one reaches get_aggregate and raises there, naming it.
REFERENCE_AGGREGATES = frozenset({
    "aggthrow", "analysisofvariance", "anova", "any", "any_respect_nulls",
    "any_value", "anyheavy", "anylast", "anylast_respect_nulls", "argmax",
    "argmin", "avg", "avgweighted", "boundingratio", "contingency", "corr",
    "corrstable", "count", "countdistinct", "covar_pop", "covar_samp",
    "covarpop", "covarpopstable", "covarsamp", "covarsampstable", "cramersv",
    "cramersvbiascorrected", "deltasum", "deltasumtimestamp", "entropy",
    "exponentialmovingaverage", "exponentialtimedecayedavg",
    "exponentialtimedecayedcount", "exponentialtimedecayedmax",
    "exponentialtimedecayedsum", "first_value", "first_value_respect_nulls",
    "grouparray", "grouparraydistinct", "grouparraylast",
    "grouparraymovingavg", "grouparraymovingsum", "grouparraysample",
    "grouparraysorted", "groupbitand", "groupbitmap", "groupbitor",
    "groupbitxor", "groupuniqarray", "intervallengthsum",
    "kolmogorovsmirnovtest", "kurtpop", "kurtsamp", "last_value",
    "last_value_respect_nulls", "mannwhitneyutest", "max", "maxintersections",
    "maxintersectionsposition", "maxmap", "maxmappedarrays", "meanztest",
    "median", "medianbfloat16", "mediandd", "mediandeterministic",
    "medianexact", "medianexacthigh", "medianexactlow", "medianexactweighted",
    "medianinterpolatedweighted", "mediantdigest", "mediantdigestweighted",
    "mediantiming", "mediantimingweighted", "min", "minmap",
    "minmappedarrays", "nothing", "quantile", "quantilebfloat16",
    "quantilebfloat16weighted", "quantiledd", "quantiledeterministic",
    "quantileexact", "quantileexactexclusive", "quantileexacthigh",
    "quantileexactinclusive", "quantileexactlow", "quantileexactweighted",
    "quantilegk", "quantileinterpolated", "quantileinterpolatedweighted",
    "quantiles", "quantilesbfloat16", "quantilesdd", "quantilesdeterministic",
    "quantilesexact", "quantilesexactexclusive", "quantilesexacthigh",
    "quantilesexactinclusive", "quantilesexactlow", "quantilesexactweighted",
    "quantilesgk", "quantilesinterpolated", "quantilestdigest",
    "quantilestiming", "quantiletdigest", "quantiletdigestweighted",
    "quantiletiming", "quantiletimingweighted", "rankcorr", "retention",
    "sequencematch", "simplelinearregression", "singlevalueornull", "skewpop",
    "skewsamp", "stddev_pop", "stddev_samp", "stddevpop", "stddevpopstable",
    "stddevsamp", "stddevsampstable", "stochasticlinearregression",
    "studentttest", "sum", "sumcount", "sumkahan", "summap",
    "summappedarrays", "sumwithoverflow", "theilsu", "topk", "topkweighted",
    "uniq", "uniqcombined", "uniqcombined64", "uniqexact", "uniqhll12",
    "uniqtheta", "uniqthetasketch", "uniqupto", "var_pop", "var_samp",
    "varpop", "varpopstable", "varsamp", "varsampstable", "welchttest",
    "windowfunnel"})

_COMBINATORS = ("if", "state", "merge", "array", "foreach", "distinct",
                "ornull", "ordefault")


def is_aggregate_name(name: str) -> bool:
    """Whether the analyzer should treat `name` as an aggregate call: a
    name of the reference's registry, after its combinator suffixes are
    stripped as the reference strips them (-If, -State and -Merge always;
    the others where what remains is an aggregate's name)."""
    base = name.lower()
    changed = True
    while changed and base not in REFERENCE_AGGREGATES:
        changed = False
        for suf in _COMBINATORS:
            if base.endswith(suf) and len(base) > len(suf) \
                    and (suf in ("if", "state", "merge")
                         or base[:-len(suf)] in REFERENCE_AGGREGATES):
                base = base[:-len(suf)]
                changed = True
                break
    return base in REFERENCE_AGGREGATES


# -- -State / -Merge -----------------------------------------------------------
# A state stored as a value (an AggregateFunction column, ClickHouse's
# ColumnAggregateFunction) is the aggregate's mergeable state columns packed
# byte-wise into a fixed-width row: the reference's layout (its state_spec,
# exprs/aggregates.py:966-997, which traces update() for it; here each
# class's layout is declared by _reference_layout), and for the aggregates
# that keep presence (min, max, any, argMin/argMax, groupBitAnd) their
# int64 row count after it (M1: a state that saw no row takes no part in a
# merge; the reference's holds 0, which a merge takes as a value).  K19
# (ops/state_ops.py) packs and unpacks the rows.

_I32, _I64, _U8, _U64, _F64 = (np.dtype(x) for x in (
    "int32", "int64", "uint8", "uint64", "float64"))
_SIGN = -(1 << 63)


def _arg_np(t: dt.DType) -> np.dtype:
    return np.dtype(dt.remove_nullable(t).np_dtype)


def _reference_layout(inst: AggregateFunction) -> List[Tuple[np.dtype, int]]:
    """The reference's state columns of `inst`: [(numpy dtype, width)]."""
    from . import agg_sketch as sk
    if isinstance(inst, sk.HLLUniqAgg):
        # the reference's m / 8 u64 limbs of register bytes, as bytes
        return [(_U8, inst.STATE_M)]
    if isinstance(inst, CountAgg):
        return [(_I64, 1)]
    if isinstance(inst, SumAgg):
        k = _arg_np(inst.arg_types[0]).kind
        return [(_F64 if k == "f" else _U64 if k == "u" else _I64, 1)]
    if isinstance(inst, (MinMaxAgg, AnyAgg, GroupBitAgg)):
        return [(_arg_np(inst.arg_types[0]), 1)]
    if isinstance(inst, AnyRespectNullsAgg):
        return [(_arg_np(inst.arg_types[0]), 1), (_I32, 1)]
    if isinstance(inst, AvgAgg):
        return [(_F64, 1), (_I64, 1)]
    if isinstance(inst, SumSquaresMixin):
        return [(_F64, 1)] * 2 + [(_I64, 1)]
    if isinstance(inst, CovarAgg):
        return [(_F64, 1)] * 3 + [(_I64, 1)]
    if isinstance(inst, CorrAgg):
        return [(_F64, 1)] * 5 + [(_I64, 1)]
    if isinstance(inst, MomentsAgg):
        return [(_F64, 1)] * 4 + [(_I64, 1)]
    if isinstance(inst, AvgWeightedAgg):
        return [(_F64, 1)] * 2
    if isinstance(inst, ArgMinMaxAgg):
        # the order as the reference's u64 order token, then the value
        return [(_U64, 1), (_arg_np(inst.arg_types[0]), 1)]
    raise NotImplementedError_(
        f"states of {inst.name} are not ported to the CUDA engine yet")


def state_spec(inst: AggregateFunction) -> List[Tuple[np.dtype, int]]:
    """[(numpy dtype, width)]: the stored state's columns, in order (the
    reference's, then the presence count where one is kept)."""
    return _reference_layout(inst) \
        + ([(_I64, 1)] if inst.keeps_presence else [])


def state_width_bytes(spec) -> int:
    return sum(d.itemsize * w for d, w in spec)


def _layout_torch(d: np.dtype) -> torch.dtype:
    """The tensor type holding a stored state column of numpy type d
    (unsigned types as the signed type of their width: the same bytes)."""
    if d.kind == "f":
        return torch.float32 if d.itemsize == 4 else torch.float64
    return {1: torch.uint8 if d.kind in "ub" else torch.int8,
            2: torch.int16, 4: torch.int32, 8: torch.int64}[d.itemsize]


def _to_layout(s: torch.Tensor, d: np.dtype) -> torch.Tensor:
    want = _layout_torch(d)
    if s.dtype == torch.bool:
        s = s.to(torch.uint8)
    return s if s.dtype == want else s.to(want)


def _from_layout(c: torch.Tensor, d: np.dtype) -> torch.Tensor:
    """A stored column as the port's state: UInt16/UInt32 widened to their
    logical tensor type without sign, the rest as they are."""
    if d.kind != "u" or d.itemsize in (1, 8):
        return c
    want = dt.from_numpy_dtype(d).torch_dtype
    return c.to(want) & ((1 << (8 * d.itemsize)) - 1)


def _order_state(first: torch.Tensor, unsigned: bool,
                 t: dt.DType) -> torch.Tensor:
    """argMin/argMax's mergeable order state: its order token (the
    reference's order_token, ascending) with the top bit flipped, an int64
    whose signed order is the order, whatever the argument's type."""
    if first.is_floating_point():
        from ..ops.hash_ops import sortable_bits
        return sortable_bits(first)[0] ^ _SIGN
    if unsigned:                 # UInt64 bits or a float's token
        return first ^ _SIGN
    first = first.to(torch.int64)
    return first ^ _SIGN if _arg_np(t).kind in "ub" else first


def state_columns(inst: AggregateFunction, states: List[torch.Tensor]
                  ) -> List[torch.Tensor]:
    """Mergeable states (GroupContext.mergeable) as the stored columns."""
    cols = [_to_layout(s, d) for (d, _), s in zip(state_spec(inst), states)]
    if isinstance(inst, ArgMinMaxAgg):
        tok = states[0] ^ _SIGN
        cols[0] = tok if inst.minimize else ~tok
    return cols


def merge_states(inst: AggregateFunction, cols: List[torch.Tensor]
                 ) -> List[torch.Tensor]:
    """Stored columns as the mergeable states inst.merge takes."""
    out = [_from_layout(c, d) for (d, _), c in zip(state_spec(inst), cols)]
    if isinstance(inst, ArgMinMaxAgg):
        tok = cols[0] if inst.minimize else ~cols[0]
        out[0] = tok ^ _SIGN
    return out


def pack_states(inst: AggregateFunction, states: List[torch.Tensor],
                dst_rows: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mergeable states -> the (rows, B) uint8 state rows (K19's pack; with
    dst_rows, state row g written at row dst_rows[g] of out)."""
    from ..ops import state_ops
    return state_ops.pack_state_rows(state_columns(inst, states),
                                     dst_rows=dst_rows, out=out)


def unpack_states(inst: AggregateFunction, packed: torch.Tensor,
                  src_rows: Optional[torch.Tensor] = None
                  ) -> List[torch.Tensor]:
    """(rows, B) uint8 state rows -> inst's mergeable states (K19's
    unpack).  Rows of another width than the layout's raise TypeError_."""
    from ..ops import state_ops
    spec = state_spec(inst)
    width = state_width_bytes(spec)
    if packed.dim() != 2 or packed.shape[1] != width:
        got = packed.shape[1] if packed.dim() == 2 else packed.shape
        raise TypeError_(
            f"a state of {inst.name} is {width} bytes in the CUDA engine's "
            f"layout ({', '.join(f'{w} x {d}' for d, w in spec)}); got "
            f"{got}")
    cols = state_ops.unpack_state_rows(
        packed, [(_layout_torch(d), w) for d, w in spec], src_rows)
    return merge_states(inst, cols)


def _merging(ctx: GroupContext) -> GroupContext:
    return ctx if ctx.mergeable else dataclasses.replace(ctx, mergeable=True)


def _custom_merge(inst: AggregateFunction) -> bool:
    """inst merges with a step of its own (argMin/argMax, uniq), not one
    reduce_many of merge_specs."""
    return type(inst).merge is not AggregateFunction.merge


def merge_keeps_a_row(inst: AggregateFunction) -> bool:
    """Whether inst's merge can keep one partial by its row id, so that
    the order of the partials decides its result: an `any` among its
    merges (any, anyLast, any RESPECT NULLS), or a merge step of its own
    (argMin/argMax keep the lowest row id at ties)."""
    return _custom_merge(inst) or any(op == "any"
                                      for op, _ in inst.merge_ops())


class StateAgg(AggregateFunction):
    """-State: the inner aggregate's mergeable states, packed into state
    rows (K19) in place of its value."""

    def __init__(self, inner: AggregateFunction, params=()):
        super().__init__(list(inner.arg_types))
        inner.pin_state_layout()
        self.inner = inner
        self.name = inner.name + "State"
        self.two_step = inner.two_step
        self.respect_nulls = inner.respect_nulls
        self.keeps_presence = inner.keeps_presence
        self.spec = state_spec(inner)
        self._params = tuple(params or ())

    def result_type(self):
        return dt.AggregateState(self.inner.name, self.inner.arg_types,
                                 self._params)

    def merge_ops(self):
        return self.inner.merge_ops()

    def merge(self, states, g, mask):
        return self.inner.merge(states, g, mask)

    def merge_specs(self, states, mask):
        return self.inner.merge_specs(states, mask)

    def reductions(self, ctx, args, cond):
        ctx.hold(ctx.grouping.num_groups_cap * state_width_bytes(self.spec),
                 f"{self.name}'s packed states")
        return self.inner.reductions(_merging(ctx), args, cond)

    def sorted_step(self, ctx, g, args, cond, states):
        return self.inner.sorted_step(_merging(ctx), g, args, cond, states)

    def finalize(self, states):
        return pack_states(self.inner, states), None


class MergeAgg(AggregateFunction):
    """-Merge: rows carry packed states of the inner aggregate; K19
    unpacks them and the inner aggregate's merge combines them by group
    (one reduce_many with the query's other aggregates, K6 or K1; argMin/
    argMax and uniq merge in a step of their own, uniq on K16)."""

    def __init__(self, inner: AggregateFunction, spec,
                 arg_types: List[dt.DType]):
        super().__init__(arg_types)
        inner.pin_state_layout()
        self.inner = inner
        self.spec = spec
        self.name = inner.name + "Merge"
        self.keeps_presence = inner.keeps_presence
        self.two_step = _custom_merge(inner)

    def result_type(self):
        return self.inner.result_type()

    def merge_ops(self):
        return self.inner.merge_ops()

    def merge(self, states, g, mask):
        return self.inner.merge(states, g, mask)

    def merge_specs(self, states, mask):
        return self.inner.merge_specs(states, mask)

    def _unpacked(self, ctx: GroupContext, args: List[ColVal]):
        packed = args[0].broadcast(ctx.capacity).data
        ctx.hold(packed.shape[0] * state_width_bytes(self.spec),
                 f"{self.name}'s unpacked states")
        return unpack_states(self.inner, packed)

    def reductions(self, ctx, args, cond):
        if self.two_step:
            return [], list
        mask = self._row_mask(ctx, args, cond)
        return self.inner.merge_specs(self._unpacked(ctx, args), mask), list

    def sorted_step(self, ctx, g, args, cond, states):
        mask = self._row_mask(ctx, args, cond)
        return self.inner.merge(self._unpacked(ctx, args), g, mask)

    def finalize(self, states):
        return self.inner.finalize(states)


def _state_inner(st: dt.DType) -> AggregateFunction:
    """The aggregate whose states an AggregateFunction(...) type holds,
    its layout pinned."""
    fn_name, arg_names, sparams = st.agg_state
    inner, _ = get_aggregate(fn_name,
                             [dt.parse_type_name(a) for a in arg_names],
                             list(sparams) if sparams else None)
    _check_mergeable(inner, fn_name)
    inner.pin_state_layout()
    return inner


def make_merge_for_dtype(state_dtype: dt.DType) -> MergeAgg:
    """The -Merge aggregate of an AggregateFunction(...) column type
    (AggregatingMergeTree FINAL, finalizeAggregation, runningAccumulate)."""
    inner = _state_inner(dt.remove_nullable(state_dtype))
    return MergeAgg(inner, state_spec(inner), [state_dtype])


def _check_mergeable(inst: AggregateFunction, name: str) -> None:
    """The reference's refusal of a state it cannot merge (TypeError_);
    uniqExact's, which the reference merges by adding distinct counts
    (not ClickHouse's answer), is not ported."""
    if isinstance(inst, UniqExactAgg):
        raise NotImplementedError_(
            f"'{name}': states of uniqExact are not ported to the CUDA "
            f"engine yet")
    if _custom_merge(inst):
        return
    try:
        inst.merge_ops()
    except NotImplementedError_:
        raise TypeError_(f"{inst.name} states cannot be merged; "
                         f"repartition by key instead") from None
    state_spec(inst)         # a mergeable state with no stored layout yet


_COMBINATOR_SUFFIXES = ("array", "foreach", "distinct")


def get_aggregate(name: str, arg_types: List[dt.DType],
                  params: Optional[list] = None
                  ) -> Tuple[AggregateFunction, bool]:
    """-> (instance, has_if_combinator).  Raises UnknownFunction.  The
    parameters are the reference's: a quantile's level (quantileGK's
    leading accuracy dropped), every level of a `quantiles` spelling.

    Combinator suffixes peel right to left as the reference's get_aggregate
    (exprs/aggregates.py:1119-1230) peels them: -If, -State or -Merge, one
    of -Array, -ForEach, -Distinct, and -OrNull / -OrDefault."""
    lname = name.lower()
    has_if, mode, comb, orfill = False, None, None, None
    while lname not in _BASE:
        if lname.endswith("if") and len(lname) > 2:
            has_if = True
            lname = lname[:-2]
        elif lname.endswith("state") and mode is None and len(lname) > 5:
            mode, lname = "state", lname[:-5]
        elif lname.endswith("merge") and mode is None and len(lname) > 5:
            mode, lname = "merge", lname[:-5]
        elif comb is None and any(lname.endswith(c) and lname[:-len(c)]
                                  in _BASE for c in _COMBINATOR_SUFFIXES):
            comb = next(c for c in _COMBINATOR_SUFFIXES
                        if lname.endswith(c) and lname[:-len(c)] in _BASE)
            lname = lname[:-len(comb)]
        elif lname.endswith("ornull") and lname[:-6] in _BASE:
            orfill, lname = "ornull", lname[:-6]
        elif lname.endswith("ordefault") and lname[:-9] in _BASE:
            orfill, lname = "ordefault", lname[:-9]
        else:
            break
    if has_if:
        arg_types = arg_types[:-1]  # last arg is the condition
    if lname not in _BASE:
        if lname in TUPLE_AGGREGATES:
            raise UnknownFunction(
                f"Aggregate function '{name}' returns a Tuple, which the "
                f"CUDA engine has no column for yet")
        if is_aggregate_name(name):
            raise UnknownFunction(
                f"Aggregate function '{name}' is not ported to the CUDA "
                f"engine yet")
        raise UnknownFunction(f"Unknown aggregate function '{name}'")
    if (comb is not None or orfill is not None) and mode is not None:
        raise NotImplementedError_(
            f"'{name}': -{(comb or orfill).capitalize()} under -{mode} is "
            f"not ported to the CUDA engine yet")
    if comb is not None or orfill is not None:
        return _combinator(name, lname, comb, orfill, arg_types,
                           params), has_if
    if mode == "merge":
        st = dt.remove_nullable(arg_types[0]) if arg_types else None
        if st is None or not dt.is_agg_state(st):
            raise TypeError_(
                f"{name} requires an AggregateFunction(...) argument, got "
                f"{arg_types[0] if arg_types else 'none'}")
        fn_name = st.agg_state[0]
        if fn_name.lower() != lname:
            raise TypeError_(f"{name} cannot merge a state of '{fn_name}'")
        inner = _state_inner(st)
        return MergeAgg(inner, state_spec(inner), list(arg_types)), has_if
    inst = _base_instance(lname, arg_types, params)
    if mode == "state":
        _check_mergeable(inst, name)
        for t in arg_types:
            if dt.remove_nullable(t).is_dictionary:
                raise NotImplementedError_(
                    f"{name}: -State over String/dictionary arguments is "
                    "not supported yet")
        inst = StateAgg(inst, params)
    return inst, has_if


def _base_instance(lname: str, arg_types, params) -> AggregateFunction:
    cls = _BASE[lname]
    if lname in ("quantilegk", "quantilesgk") and params:
        params = params[1:]
    if lname in _MULTI_Q:
        qs = [float(p) for p in params] if params else [0.5]
        return cls(arg_types, qs=qs)
    if lname in _QUANTILE_NAMES:
        q = float(params[0]) if params else 0.5
        return cls(arg_types, q)
    from .agg_sketch import SIZED
    if lname in SIZED or lname in _TAIL_SIZED:
        size = int(params[0]) if params else None
        return cls(arg_types, size or 10) if lname in ("topk", "topkweighted") \
            else cls(arg_types, size)
    if lname == "quantilesexactweighted":
        return cls(arg_types, qs=[float(p) for p in params] if params
                   else [0.5])
    if lname in _WEIGHTED_NAMES and not lname.startswith("median") \
            or lname == "quantileexactweighted":
        return cls(arg_types, float(params[0]) if params else 0.5)
    if lname == "uniqupto":
        return cls(arg_types, int(params[0]) if params else 5)
    if lname in ("grouparraymovingsum", "grouparraymovingavg"):
        return cls(arg_types, int(params[0]) if params else None)
    if lname in _PARAM_LIST:
        return cls(arg_types, params)
    return cls(arg_types)


def _combinator(name, lname, comb, orfill, arg_types, params
                ) -> AggregateFunction:
    """-Array, -ForEach, -Distinct, each under -OrNull/-OrDefault or not
    (exprs/agg_ext.py)."""
    from . import agg_ext as ax
    if comb is None:
        return ax.OrNullAgg(_base_instance(lname, arg_types, params),
                            orfill == "ornull")
    if comb in ("array", "foreach") and arg_types:
        t = dt.remove_nullable(arg_types[0])
        if t.is_array and dt.array_inner(t).is_dictionary:
            raise NotImplementedError_(
                f"{name} over {arg_types[0]}: Array(String) columns are not "
                f"ported to the CUDA engine yet")
    if comb == "array":
        inst = ax.make_array_combinator(lname, _BASE[lname], arg_types)
    elif comb == "foreach":
        inst = ax.make_foreach_combinator(lname, arg_types)
    else:
        inst = ax.DistinctAgg(_base_instance(lname, arg_types, params))
    if inst is None:
        raise NotImplementedError_(
            f"Combinator '-{comb.capitalize()}' does not apply to "
            f"'{lname}' with these argument types")
    if orfill is not None:
        inst = ax.OrNullAgg(inst, orfill == "ornull")
    return inst
