"""Aggregate functions (reference: clickhouse_tpu/exprs/aggregates.py).

Each function defines update (rows -> per-group states) and finalize;
every reduction goes through Grouping.reduce (ops/agg_ops.py), which runs
K1 for GROUP BY (), K2 for dense groupings and K6 for the sort grouping
(K6 reads a scanned column's narrow storage itself; the states come back
in the column's logical type).  Merging partial states (-State/-Merge,
two-stage aggregation) is not ported.

Ported: count, sum, avg, min, max and any, each with the -If combinator,
under every grouping kind: sum/count/avg of integers may take the dense
grouping; min, max, any and float sums take the sort grouping (or K1 under
GROUP BY ()).  min/max of a String compare its dictionary ranks.
Every other aggregate name and combinator raises the reference's typed
errors (UnknownFunction / NotImplementedError_).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.errors import NotImplementedError_, UnknownFunction
from ..ops import agg_ops
from .expr import ColVal

__all__ = ["AggregateFunction", "get_aggregate", "is_aggregate_name",
           "AGGREGATES", "GroupContext"]


@dataclasses.dataclass
class GroupContext:
    """Everything an aggregate needs to produce per-group states."""
    # the block's rows: a bool mask, or (GROUP BY ()) the RowMask whose
    # parts K1 takes as they are
    row_valid: Union[torch.Tensor, agg_ops.RowMask]
    grouping: agg_ops.Grouping
    premask: Union[torch.Tensor, agg_ops.RowMask, None] = None

    @property
    def capacity(self) -> int:
        return _capacity(self.row_valid)


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


def _u64_to_f64(v: torch.Tensor) -> torch.Tensor:
    """UInt64 bits (int64 tensor) -> float64 of the unsigned value."""
    f = v.to(torch.float64)
    return torch.where(v < 0, f + 18446744073709551616.0, f)


class AggregateFunction:
    """Base class: update (rows -> per-group states) and finalize."""

    name: str = ""
    holistic: bool = False
    sum_only: bool = False      # True: all reductions are sums (dense-able)

    def __init__(self, arg_types: List[dt.DType]):
        self.arg_types = arg_types

    def result_type(self) -> dt.DType:
        raise NotImplementedError

    def update(self, ctx: GroupContext, args: List[ColVal],
               cond: Optional[torch.Tensor]) -> List[torch.Tensor]:
        raise NotImplementedError

    def finalize(self, states):
        """-> (data, validity or None), each (num_groups_cap,)."""
        raise NotImplementedError

    def _row_mask(self, ctx: GroupContext, args: List[ColVal],
                  cond: Optional[torch.Tensor]):
        if ctx.premask is not None:
            return ctx.premask
        return compose_row_mask(ctx.row_valid, args, cond)

    @staticmethod
    def _value(ctx: GroupContext, cv: ColVal) -> torch.Tensor:
        """The argument's values, raw row order: under the sort grouping
        the column as stored (K6 widens as it reads), else its data."""
        cv = cv.broadcast(ctx.capacity)
        return cv.storage if ctx.grouping.kind == "sort" else cv.data

    def _logical(self, s: torch.Tensor) -> torch.Tensor:
        """A min/max/any state in the argument's logical type (K6 gives it
        in the storage's); dictionary codes and ranks stay as they are."""
        want = dt.remove_nullable(self.arg_types[0]).torch_dtype
        return s if s.dtype == want or self.arg_types[0].is_dictionary \
            else s.to(want)


class CountAgg(AggregateFunction):
    name = "count"
    sum_only = True

    def result_type(self):
        return dt.UInt64

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return [ctx.grouping.count_rows(mask)]

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

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        v = self._value(ctx, args[0])
        s = ctx.grouping.reduce("sum", v, mask)
        return [s.to(_sum_state_dtype(self.arg_types[0]))]

    def finalize(self, states):
        return states[0], None


class MinMaxAgg(AggregateFunction):
    op = "min"

    def __init__(self, arg_types):
        super().__init__(arg_types)
        self._dict_order: Optional[torch.Tensor] = None

    def result_type(self):
        return dt.remove_nullable(self.arg_types[0])

    def _prep(self, ctx, cv: ColVal):
        """Dictionary (string) args aggregate lexicographic ranks, mapped
        back to codes in finalize."""
        v = self._value(ctx, cv)
        if cv.dictionary is not None and len(cv.dictionary):
            vals = cv.dictionary.values.astype(str)
            order = np.argsort(vals, kind="stable")
            rank = np.empty(len(vals), np.int64)
            rank[order] = np.arange(len(vals))
            self._dict_order = torch.from_numpy(order.astype(np.int32)) \
                .to(v.device)
            return torch.from_numpy(rank).to(v.device)[v.clamp(min=0).long()]
        return v

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        v = self._prep(ctx, args[0])
        unsigned = dt.remove_nullable(self.arg_types[0]).np_dtype == \
            np.dtype("uint64") and args[0].dictionary is None
        return [self._logical(
            ctx.grouping.reduce(self.op, v, mask, unsigned=unsigned))]

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

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        v = self._value(ctx, args[0])
        s = ctx.grouping.reduce("sum", v, mask)
        c = ctx.grouping.count_rows(mask)
        s = _u64_to_f64(s) if self._unsigned() and not s.is_floating_point() \
            else s.to(torch.float64)
        return [s, c]

    def finalize(self, states):
        s, c = states
        s = _u64_to_f64(s) if self._unsigned() and not s.is_floating_point() \
            else s.to(torch.float64)
        safe = torch.clamp(c, min=1)
        out = s / safe.to(torch.float64)
        t0 = dt.remove_nullable(self.arg_types[0])
        if dt.is_decimal(t0):
            out = out / float(10 ** t0.decimal_scale)
        return out, None


class AnyAgg(AggregateFunction):
    name = "any"

    def result_type(self):
        return self.arg_types[0]

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return [self._logical(
            ctx.grouping.reduce("any", self._value(ctx, args[0]), mask))]

    def finalize(self, states):
        return states[0], None


def _register_base() -> Dict[str, type]:
    base: Dict[str, type] = {}
    for _cls in [CountAgg, SumAgg, MinAgg, MaxAgg, AvgAgg, AnyAgg]:
        base[_cls.name.lower()] = _cls
    base["any_value"] = AnyAgg
    base["first_value"] = AnyAgg
    return base


_BASE: Dict[str, type] = _register_base()
AGGREGATES = _BASE


# combinators get_aggregate knows and refuses as not ported
_UNPORTED_COMBINATORS = ("state", "merge", "array", "foreach", "distinct",
                         "ornull", "ordefault")


def is_aggregate_name(name: str) -> bool:
    """Whether the analyzer should treat `name` as an aggregate call:
    the ported ones, -If, and the unported combinators of a ported
    aggregate (get_aggregate then raises NotImplementedError_ naming
    them)."""
    base = name.lower()
    if base in _BASE:
        return True
    if base.endswith("if") and base[:-2] in _BASE:
        return True
    return any(base.endswith(suf) and is_aggregate_name(base[:-len(suf)])
               for suf in _UNPORTED_COMBINATORS)


def get_aggregate(name: str, arg_types: List[dt.DType],
                  params: Optional[list] = None
                  ) -> Tuple[AggregateFunction, bool]:
    """-> (instance, has_if_combinator).  Raises UnknownFunction."""
    lname = name.lower()
    has_if = False
    if lname not in _BASE and lname.endswith("if") and len(lname) > 2:
        has_if = True
        lname = lname[:-2]
        arg_types = arg_types[:-1]  # last arg is the condition
    if lname not in _BASE:
        for suf in _UNPORTED_COMBINATORS:
            if lname.endswith(suf) and is_aggregate_name(lname[:-len(suf)]):
                raise NotImplementedError_(
                    f"Combinator -{suf} ('{name}') is not ported to the "
                    f"CUDA engine yet")
        raise UnknownFunction(f"Unknown aggregate function '{name}'")
    return _BASE[lname](arg_types), has_if
