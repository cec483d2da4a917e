"""Aggregate batch 4 (reference: clickhouse_tpu/exprs/agg_ext4.py):
topKWeighted, deltaSumTimestamp, nothing and aggThrow.

topKWeighted takes topK's runs (exprs/agg_sketch.py: the rows sorted by
(keys, masked-out flag, value), a run a value) and sums each run's
weights with K6's sorted entry over the runs' bounds; the runs sort again
by (group, -weight) with K4.  deltaSumTimestamp reads each group's
masked-in rows in time order (the sort grouping's secondary keys) and
sums its rises with K6's sorted entry.
"""
from __future__ import annotations

import torch

from ..core import dtypes as dt
from ..core.errors import ExecutionError, TypeError_
from ..ops import scan_ops, sort_ops
from .agg_ext import f64_of, group_starts
from .agg_sketch import TopKAgg, _prefix_matrix
from .aggregates import (AggregateFunction, _numeric as numeric, _take,
                         _take_mask, notm_key, value_key)

__all__ = ["TopKWeightedAgg", "DeltaSumTimestampAgg", "NothingAgg",
           "AggThrowAgg"]


class TopKWeightedAgg(TopKAgg):
    """topKWeighted(N)(x, w): each group's N values of largest weight sum,
    heaviest first, equal sums in value order (exact; ClickHouse's
    space-saving sketch approximates it).  Weights as int64 (the
    reference's)."""
    name = "topKWeighted"

    def __init__(self, arg_types, k: int = 10):
        super().__init__(arg_types, k)
        if len(arg_types) != 2:
            raise TypeError_(f"{self.name} takes a value and a weight")
        numeric(self, 1)

    def sorted_step(self, ctx, g, args, cond, states):
        rows = states[0]
        vs, first = self._first(ctx, g, args, cond)
        p, gp, cnt = self._run_counts(g, first, rows)
        nr = p.shape[0]
        n = first.shape[0]
        mask = self._row_mask(ctx, args, cond)
        ms = _take_mask(ctx, g, mask)
        ctx.hold(n * 8 + nr * 48, f"{self.name}'s runs")
        w = _take(ctx, g, self._spec_value(ctx, args[1]),
                  f"{self.name}'s weights").to(torch.int64)
        nsel = g.reduce_sorted([("count", None, first, False)])[0]
        if nr:
            # each run's weights: the runs' bounds from row 0 with no gap
            # (a run's masked-out tail and the rows before the first run
            # are masked out), the last run ending at its own end
            rs = p.clone()
            rs[0] = 0
            re_ = torch.cat([p[1:], p[-1:] + cnt[-1:]])
            wsum = scan_ops.segment_reduce_sorted(
                [("sum", w, ms, False)], rs, re_, n)[0]
            lo, hi = int(wsum.min()), int(wsum.max())
            key = hi - wsum
            perm, _ = sort_ops.sort_rows(
                [sort_ops.SortKey(gp, bounds=(0, g.num_groups_cap - 1)),
                 sort_ops.SortKey(key, bounds=(0, hi - lo))],
                None, want_keys=False, max_bytes=None if ctx.max_bytes is None
                else ctx.max_bytes - ctx.shared["bytes"])
            run_vals = vs.index_select(0, p).index_select(0, perm.long())
        else:
            run_vals = vs[:0]
        off = scan_ops.segmented_scan("sum", nsel, None) - nsel
        width = self._width(ctx)
        mat = _prefix_matrix(run_vals, lambda q: q, nsel, off, width,
                             self._dtype(), nr)
        return self._states(ctx, mat, nsel, width)


class DeltaSumTimestampAgg(AggregateFunction):
    """deltaSumTimestamp(value, timestamp): the sum of the rises between
    each group's consecutive masked-in rows in timestamp order (equal
    timestamps in row order), in float64 (the reference's result type).
    The sort grouping by (keys, masked-out flag, timestamp); K6's sorted
    entry sums the rises."""
    name = "deltaSumTimestamp"
    holistic = True
    two_step = True

    def __init__(self, arg_types):
        super().__init__(arg_types)
        if len(arg_types) != 2:
            raise TypeError_(f"{self.name} takes a value and a timestamp")
        numeric(self, 0, 1)

    def result_type(self):
        return dt.Float64

    def secondary(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return notm_key(ctx, mask) + [value_key(args[1], ctx.capacity)]

    def reductions(self, ctx, args, cond):
        return [], list

    def sorted_step(self, ctx, g, args, cond, states):
        mask = self._row_mask(ctx, args, cond)
        n = g.perm.shape[0]
        ctx.hold(n * 18, f"{self.name}'s rises")
        ms = _take_mask(ctx, g, mask)
        x = f64_of(args[0], _take(ctx, g, self._spec_value(ctx, args[0]),
                                  f"{self.name}'s values"))
        live = ms if ms is not None else g.group_ids < g.num_groups_cap
        same = torch.zeros(n, dtype=torch.bool, device=x.device)
        d = torch.zeros_like(x)
        if n > 1:
            same[1:] = live[1:] & live[:-1] & ~group_starts(g)[1:]
            d[1:] = torch.clamp(x[1:] - x[:-1], min=0.0)
            d = torch.where(same, d, torch.zeros_like(d))
        return g.reduce_sorted([("sum", d, ms, False)])

    def finalize(self, states):
        return states[0], None


class NothingAgg(AggregateFunction):
    """nothing(...): NULL for every group (Nullable(Nothing))."""
    name = "nothing"

    def result_type(self):
        return dt.make_nullable(dt.Nothing)

    def merge_ops(self):
        return [("sum", False)]

    def reductions(self, ctx, args, cond):
        return [("count", None, self._row_mask(ctx, args, cond), False)], \
            list

    def finalize(self, states):
        z = torch.zeros(states[0].shape, dtype=torch.int8,
                        device=states[0].device)
        return z, torch.zeros(states[0].shape, dtype=torch.uint8,
                              device=states[0].device)


class AggThrowAgg(AggregateFunction):
    """aggThrow(p): the reference's fault-injection helper, which raises
    when it is made for any p > 0 (deterministic where ClickHouse draws
    with probability p); with p = 0 its rows' count as a UInt8."""
    name = "aggThrow"

    def __init__(self, arg_types, params=None):
        super().__init__(arg_types)
        p = float(params[0]) if params else 1.0
        if p > 0:
            raise ExecutionError("Aggregate function aggThrow has thrown "
                                 "exception successfully")

    def result_type(self):
        return dt.UInt8

    def merge_ops(self):
        return [("sum", False)]

    def reductions(self, ctx, args, cond):
        return [("count", None, self._row_mask(ctx, args, cond), False)], \
            lambda r: [r[0]]

    def finalize(self, states):
        return states[0].to(torch.uint8), None
