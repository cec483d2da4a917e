"""Aggregate functions (reference: clickhouse_tpu/exprs/aggregates.py).

Each function defines reductions (the per-group reductions its states
need, and how the states follow from their results), update (rows ->
per-group states, through Grouping.reduce_many) and finalize.  Every
reduction goes through Grouping.reduce_many (ops/agg_ops.py), which runs
K1 for GROUP BY (), K2 for dense groupings and K6 for the sort grouping
(K6 reads a scanned column's narrow storage itself; the states come back
in the column's logical type); the executor hands every aggregate's
reductions to one reduce_many call, so a sort GROUP BY launches K6 once.
Merging partial states (-State/-Merge, two-stage aggregation) is not
ported.

Ported: count, sum, avg, min, max and any, each with the -If combinator,
under every grouping kind: sum/count/avg of integers may take the dense
grouping; min, max, any and float sums take the sort grouping (or K1 under
GROUP BY ()).  min/max of a String compare its dictionary ranks.
Every other aggregate name and combinator raises the reference's typed
errors (UnknownFunction / NotImplementedError_).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.errors import NotImplementedError_, UnknownFunction
from ..ops import agg_ops
from .expr import ColVal

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


class AggregateFunction:
    """Base class: update (rows -> per-group states) and finalize."""

    name: str = ""
    holistic: bool = False
    sum_only: bool = False      # True: all reductions are sums (dense-able)

    def __init__(self, arg_types: List[dt.DType]):
        self.arg_types = arg_types

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
        and GROUP BY () the column as stored (K6 and K1 widen as they
        read), else its data."""
        cv = cv.broadcast(ctx.capacity)
        return cv.storage if ctx.grouping.kind in ("sort", "trivial") \
            else cv.data

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

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        want = _sum_state_dtype(self.arg_types[0])
        return [("sum", self._value(ctx, args[0]), mask, False)], \
            lambda r: [r[0].to(want)]

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

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        v = self._prep(ctx, args[0])
        unsigned = dt.remove_nullable(self.arg_types[0]).np_dtype == \
            np.dtype("uint64") and args[0].dictionary is None
        return [(self.op, v, mask, unsigned)], \
            lambda r: [self._logical(r[0])]

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

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return [("sum", self._value(ctx, args[0]), mask, False),
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

    def result_type(self):
        return self.arg_types[0]

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return [("any", self._value(ctx, args[0]), mask, False)], \
            lambda r: [self._logical(r[0])]

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

# combinators get_aggregate knows and refuses as not ported
_UNPORTED_COMBINATORS = ("state", "merge", "array", "foreach", "distinct",
                         "ornull", "ordefault")
_COMBINATORS = ("if",) + _UNPORTED_COMBINATORS


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
        if is_aggregate_name(lname):
            raise UnknownFunction(
                f"Aggregate function '{name}' is not ported to the CUDA "
                f"engine yet")
        raise UnknownFunction(f"Unknown aggregate function '{name}'")
    return _BASE[lname](arg_types), has_if
