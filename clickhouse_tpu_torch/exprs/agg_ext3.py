"""Aggregate batch 3 (reference: clickhouse_tpu/exprs/agg_ext3.py): the
ordered and sampled collectors, singleValueOrNull, the time-decayed
means, intervalLengthSum, maxIntersections and the contingency-table
associations.

The collectors are groupArray through its hooks (exprs/agg_sketch.py):
groupArraySorted orders each group's masked-in rows by value, groupArrayLast
collects the last N in row order, groupArraySample the first N by the
reference's hash token of the row's position.  The rest read each group's
rows in the order their sort grouping gives (K4, K5), scan them with K17
(a running max, a running depth) and reduce them with K6's sorted entry.
The contingency family counts its cells (runs of equal (a, b)) in the
(keys, a, b) order and its b marginals over a second grouping of the cells
alone, read through that grouping's perm: no column goes back to row
order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.errors import TypeError_
from ..ops import agg_ops, scan_ops, sort_ops
from .agg_ext import Rows, f64_of, group_starts
from .agg_sketch import GroupArrayAgg
from .aggregates import (AggregateFunction, _and_mask, _numeric as numeric,
                         _SortedValues, _take, _take_mask, notm_key,
                         value_key)
from .expr import ColVal

__all__ = ["GroupArraySortedAgg", "GroupArrayLastAgg", "GroupArraySampleAgg",
           "SingleValueOrNullAgg", "ExponentialMovingAverageAgg",
           "ExponentialTimeDecayedSumAgg", "ExponentialTimeDecayedCountAgg",
           "ExponentialTimeDecayedAvgAgg", "ExponentialTimeDecayedMaxAgg",
           "IntervalLengthSumAgg", "MaxIntersectionsAgg",
           "MaxIntersectionsPositionAgg", "CramersVAgg",
           "CramersVBiasCorrectedAgg", "TheilsUAgg", "ContingencyAgg"]

# 0x9E3779B97F4A7C15 as int64 bits (reference agg_ext3.py:590)
_GOLDEN = -7046029254386353131
_TOKEN_MASK = (1 << 62) - 1


# -- ordered / sampled collectors (reference :526-591) -------------------------

class GroupArraySortedAgg(GroupArrayAgg):
    """groupArraySorted(N)(x): each group's N smallest values, ascending
    (floats by token: -0.0 below +0.0, NaNs last)."""
    name = "groupArraySorted"

    def _order_cols(self, ctx, args):
        return [value_key(args[0], ctx.capacity)]


class GroupArrayLastAgg(GroupArrayAgg):
    """groupArrayLast(N)(x): each group's last N values, in row order: the
    masked-in rows in row order from offset len - N (the reference sorts
    by descending row id and flips each collected row: the same values)."""
    name = "groupArrayLast"

    def _first_row(self, lens, width):
        return torch.clamp(lens - width, min=0)


class GroupArraySampleAgg(GroupArrayAgg):
    """groupArraySample(N[, seed])(x): each group's first N masked-in rows
    by the reference's token (row position * 0x9E3779B97F4A7C15) &
    (2^62 - 1) over the block's rows, in token order: the reference's
    deterministic sample, bit for bit (its seed is ignored, as there)."""
    name = "groupArraySample"

    def _order_cols(self, ctx, args):
        cap = ctx.capacity

        def make():
            pos = torch.arange(cap, dtype=torch.int64,
                               device=args[0].broadcast(cap).storage.device)
            return (pos * _GOLDEN) & _TOKEN_MASK
        tok = ctx.built("sample_token", (), make, 8 * cap,
                        f"{self.name}'s tokens")
        return [sort_ops.SortKey(tok, bounds=(0, _TOKEN_MASK))]


# -- singleValueOrNull (reference :526) -----------------------------------------

class SingleValueOrNullAgg(AggregateFunction):
    """singleValueOrNull(x): the group's value where every masked-in row
    holds the same one, else NULL: its min, max and row count (K6, K1),
    NULL unless min == max (a String compares its dictionary codes).  The
    states merge (min, max and sums) with the presence of each partial."""
    name = "singleValueOrNull"

    def result_type(self):
        return dt.make_nullable(dt.remove_nullable(self.arg_types[0]))

    def _unsigned(self) -> bool:
        """UInt64 bits, which min and max compare unsigned."""
        return dt.remove_nullable(self.arg_types[0]).np_dtype == np.uint64 \
            and not self.arg_types[0].is_dictionary

    def merge_ops(self):
        u = self._unsigned()
        return [("min", u), ("max", u), ("sum", False)]

    def merge_specs(self, states, mask):
        seen = _and_mask(mask, states[2] > 0)
        u = self._unsigned()
        return [("min", states[0], seen, u), ("max", states[1], seen, u),
                ("sum", states[2], mask, False)]

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        v = self._spec_value(ctx, args[0])
        u = self._unsigned()
        return [("min", v, mask, u), ("max", v, mask, u),
                ("count", None, mask, False)], \
            lambda r: [self._logical(r[0]), self._logical(r[1]), r[2]]

    def finalize(self, states):
        mn, mx, cnt = states
        return mn, ((mn == mx) & (cnt > 0)).to(torch.uint8)


# -- the exponentially time-decayed family (reference :48-145) ---------------

class _TimeDecayed(AggregateFunction):
    """The weight of a row: base^(-(t_max - t) / λ), t_max the group's
    latest masked-in time (e, or 2 for exponentialMovingAverage's
    half-life).  Step 1: t_max (K6, K1); step 2: the weighted sums (or the
    weighted max) over the query's own grouping, in any row order (K6's
    sorted entry, K1 under GROUP BY ()).  Not mergeable (the reference's
    rescale on merge is not linear): holistic."""
    holistic = True
    two_step = True
    base_e = True

    def __init__(self, arg_types, params=None):
        super().__init__(arg_types)
        numeric(self, *range(len(arg_types)))
        self.decay = float(params[0]) if params else 1.0

    def result_type(self):
        return dt.Float64

    def secondary(self, ctx, args, cond):
        return None          # the query's own grouping, in any row order

    def reductions(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        t = args[-1]
        unsigned = dt.remove_nullable(t.dtype).np_dtype == np.uint64
        return [("max", self._spec_value(ctx, t), mask, unsigned)], list

    def _weights(self, ctx, g, args, cond, states):
        mask = self._row_mask(ctx, args, cond)
        r = Rows(ctx, g, mask, self.name)
        ctx.hold(r.n * 33, f"{self.name}'s weights")
        t = f64_of(args[-1], r.col(args[-1]))
        tmax = f64_of(args[-1], states[0])
        dtm = (r.group(tmax) - t) / max(self.decay, 1e-300)
        w = torch.where(r.mask, torch.exp(-dtm) if self.base_e
                        else torch.exp2(-dtm), 0.0)
        return r, w

    @staticmethod
    def _vals(r: Rows, args) -> torch.Tensor:
        return f64_of(args[0], r.col(args[0]))

    def finalize(self, states):
        return states[0], None


class _DecayedMean(_TimeDecayed):
    def sorted_step(self, ctx, g, args, cond, states):
        r, w = self._weights(ctx, g, args, cond, states)
        sv, sw = r.reduce([("sum", self._vals(r, args) * w, r.mask,
                            False), ("sum", w, r.mask, False)])
        return [sv / torch.clamp(sw, min=1e-300)]


class ExponentialMovingAverageAgg(_DecayedMean):
    """exponentialMovingAverage(halflife)(value, time): the weights halve
    each `halflife` before the group's latest time."""
    name = "exponentialMovingAverage"
    base_e = False


class ExponentialTimeDecayedAvgAgg(_DecayedMean):
    name = "exponentialTimeDecayedAvg"


class ExponentialTimeDecayedSumAgg(_TimeDecayed):
    name = "exponentialTimeDecayedSum"

    def sorted_step(self, ctx, g, args, cond, states):
        r, w = self._weights(ctx, g, args, cond, states)
        return r.reduce([("sum", self._vals(r, args) * w, r.mask,
                          False)])


class ExponentialTimeDecayedCountAgg(_TimeDecayed):
    """exponentialTimeDecayedCount(λ)(time): the sum of the weights."""
    name = "exponentialTimeDecayedCount"

    def sorted_step(self, ctx, g, args, cond, states):
        r, w = self._weights(ctx, g, args, cond, states)
        return r.reduce([("sum", w, r.mask, False)])


class ExponentialTimeDecayedMaxAgg(_TimeDecayed):
    name = "exponentialTimeDecayedMax"

    def sorted_step(self, ctx, g, args, cond, states):
        r, w = self._weights(ctx, g, args, cond, states)
        vw = torch.where(r.mask, self._vals(r, args) * w,
                         float("-inf"))
        return r.reduce([("max", vw, r.mask, False)])


# -- interval aggregates (reference :156-290) ----------------------------------

def _ints_or_f64(cv: ColVal, t: torch.Tensor) -> torch.Tensor:
    """int64 for an integer column (exact), float64 for a float one."""
    return t.to(torch.float64) if t.is_floating_point() \
        else t.to(torch.int64)


class IntervalLengthSumAgg(_SortedValues):
    """intervalLengthSum(start, end): the length of the union of each
    group's [start, end) intervals.  The sort grouping by (keys, masked-out
    flag, start); K17's running max of the ends before each row (the
    segmented scan, read a row back); a row adds max(0, end - max(start,
    that max)), summed by K6's sorted entry.  Integers in int64 (exact; the
    reference's float64 agrees below 2^53)."""
    name = "intervalLengthSum"

    def __init__(self, arg_types):
        super().__init__(arg_types)
        numeric(self, 0, 1)

    def result_type(self):
        base = dt.remove_nullable(self.arg_types[0])
        return dt.Float64 if base.np_dtype.kind == "f" else dt.UInt64

    def reductions(self, ctx, args, cond):
        return [], list

    def sorted_step(self, ctx, g, args, cond, states):
        mask = self._row_mask(ctx, args, cond)
        n = g.perm.shape[0]
        ctx.hold(n * 34, f"{self.name}'s sweep")
        ms = _take_mask(ctx, g, mask)
        s = _ints_or_f64(args[0], _take(ctx, g, self._spec_value(
            ctx, args[0]), f"{self.name}'s starts"))
        e = _ints_or_f64(args[1], _take(ctx, g, self._spec_value(
            ctx, args[1]), f"{self.name}'s ends"))
        if s.dtype != e.dtype:
            s, e = s.to(torch.float64), e.to(torch.float64)
        bnd = group_starts(g)
        run = scan_ops.segmented_scan("max", e, bnd, ms)
        low = float("-inf") if e.is_floating_point() \
            else torch.iinfo(torch.int64).min
        prev = torch.full_like(run, low)
        if n > 1:
            prev[1:] = torch.where(bnd[1:], prev[1:], run[:-1])
        contrib = torch.clamp(e - torch.maximum(s, prev), min=0)
        if ms is not None:
            contrib = torch.where(ms, contrib, torch.zeros_like(contrib))
        return g.reduce_sorted([("sum", contrib, ms, False)])

    def finalize(self, states):
        return states[0], None


class MaxIntersectionsAgg(AggregateFunction):
    """maxIntersections(start, end): the most intervals of each group open
    at once.  Each row is two events, +1 at its start and -1 at its end;
    the 2n events are grouped by (keys, masked-out flag, position, +1 after
    -1 at one position: half-open intervals) with K4 and K5 (the keys'
    groups, one slot a group as the query's own grouping numbers them);
    K17's sum scan gives the depth after each event, K6's sorted entry its
    maximum and (maxIntersectionsPosition) the position of the first event
    at it (K6's `any`, the first masked-in row in sorted order)."""
    name = "maxIntersections"
    holistic = True
    two_step = True
    want_position = False

    def __init__(self, arg_types):
        super().__init__(arg_types)
        numeric(self, 0, 1)

    def result_type(self):
        return dt.Float64 if self.want_position else dt.UInt64

    def secondary(self, ctx, args, cond):
        return None          # the query's own grouping, in any row order

    def reductions(self, ctx, args, cond):
        return [], list

    def sorted_step(self, ctx, g, args, cond, states):
        mask = self._row_mask(ctx, args, cond)
        cap = ctx.capacity
        valid = ctx.row_valid.tensor() \
            if isinstance(ctx.row_valid, agg_ops.RowMask) else ctx.row_valid
        m = mask.tensor() if isinstance(mask, agg_ops.RowMask) else mask
        s = _ints_or_f64(args[0], args[0].broadcast(cap).data)
        e = _ints_or_f64(args[1], args[1].broadcast(cap).data)
        if s.dtype != e.dtype:
            s, e = s.to(torch.float64), e.to(torch.float64)
        ctx.hold(2 * cap * (26 + sum(k.data.element_size()
                                     for k in ctx.keys)),
                 f"{self.name}'s events")
        keys2 = [sort_ops.SortKey(torch.cat([k.data, k.data]), k.unsigned,
                                  k.bounds) for k in ctx.keys]
        pos = torch.cat([s, e])
        start = torch.cat([torch.ones(cap, dtype=torch.bool, device=s.device),
                           torch.zeros(cap, dtype=torch.bool,
                                       device=s.device)])
        m2 = torch.cat([m, m])
        sec = [] if mask is ctx.row_valid \
            else [sort_ops.SortKey(~m2, bounds=(0, 1))]
        sec += [sort_ops.SortKey(pos), sort_ops.SortKey(start, bounds=(0, 1))]
        left = None if ctx.max_bytes is None \
            else ctx.max_bytes - ctx.shared["bytes"]
        g2 = agg_ops.group_by_sort(keys2, torch.cat([valid, valid]),
                                   g.num_groups_cap, secondary=sec,
                                   max_bytes=left)
        perm = g2.perm.long()
        ms = m2.index_select(0, perm)
        d = torch.where(ms, torch.where(start.index_select(0, perm), 1, -1),
                        0).to(torch.int64)
        depth = scan_ops.segmented_scan("sum", d, group_starts(g2))
        best = g2.reduce_sorted([("max", depth, ms, False)])[0]
        best = torch.clamp(best, min=0)
        if not self.want_position:
            return [best]
        gid = torch.clamp(g2.group_ids, max=g2.num_groups_cap - 1).long()
        at = ms & (depth == best.index_select(0, gid))
        p = pos.index_select(0, perm).to(torch.float64)
        return g2.reduce_sorted([("any", p, at, False)])

    def finalize(self, states):
        return states[0], None


class MaxIntersectionsPositionAgg(MaxIntersectionsAgg):
    name = "maxIntersectionsPosition"
    want_position = True


# -- the contingency-table family (reference :399-524) -----------------------

class _CrossTab(AggregateFunction):
    """cramersV / cramersVBiasCorrected / theilsU / contingency(a, b): each
    group's counts n_a, n_b and n_ab (CrossTab.h), the reference's sums
    taken a cell (a run of equal (a, b)) at a time in place of a row at a
    time: S = sum n_ab^2 / (n_a n_b), H(a) = sum n_a log(T / n_a) / T over
    the a values, H(a|b) = sum n_ab log(n_b / n_ab) / T, R and C the
    distinct a and b.  The sort grouping by (keys, masked-out flag, a, b)
    gives the cells and the a runs in order (their heads by K17's run
    counts); a second grouping of the cells by (group, b) (K4, K5 over the
    cells alone) sums n_b (K6) and reads each cell's n_ab and n_a through
    its perm; every sum is K6's sorted entry over each group's cells."""
    holistic = True
    two_step = True

    def __init__(self, arg_types):
        super().__init__(arg_types)
        if len(arg_types) != 2:
            raise TypeError_(f"{self.name} takes two arguments")
        for t in arg_types:
            t = dt.remove_nullable(t)
            if t.is_array or dt.is_map(t):
                raise TypeError_(f"Illegal type {t} of argument of "
                                 f"aggregate function {self.name}")

    def result_type(self):
        return dt.Float64

    def secondary(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return notm_key(ctx, mask) + [value_key(args[0], ctx.capacity),
                                      value_key(args[1], ctx.capacity)]

    def reductions(self, ctx, args, cond):
        return [("count", None, self._row_mask(ctx, args, cond), False)], \
            list

    def sorted_step(self, ctx, g, args, cond, states):
        T = states[0]
        mask = self._row_mask(ctx, args, cond)
        n = g.perm.shape[0]
        cap_g = g.num_groups_cap
        ctx.hold(n * 40, f"{self.name}'s runs")
        ms = _take_mask(ctx, g, mask)
        a = _take(ctx, g, args[0].broadcast(ctx.capacity).storage,
                  f"{self.name}'s first argument")
        b = _take(ctx, g, args[1].broadcast(ctx.capacity).storage,
                  f"{self.name}'s second argument")
        bnd = group_starts(g)
        first_a = bnd.clone()
        if n > 1:
            first_a[1:] |= a[1:] != a[:-1]
        first_ab = first_a.clone()
        if n > 1:
            first_ab[1:] |= b[1:] != b[:-1]
        if ms is not None:
            first_a &= ms
            first_ab &= ms
        else:
            live = g.group_ids < cap_g
            first_a &= live
            first_ab &= live
        gid = g.group_ids.to(torch.int64)
        inend = g.starts + T
        # the cells (runs of (a, b)) and the a runs: heads, groups, rows
        cells = torch.nonzero(first_ab).squeeze(1)
        heads_a = torch.nonzero(first_a).squeeze(1)
        nc, na = cells.shape[0], heads_a.shape[0]
        ctx.hold((nc + na) * 64, f"{self.name}'s cells")

        def run_rows(p):
            gp = gid.index_select(0, p)
            nxt = torch.cat([p[1:], torch.full((1,), n, dtype=p.dtype,
                                               device=p.device)])
            return gp, torch.minimum(nxt, inend.index_select(0, gp)) - p
        if nc == 0:
            z = torch.zeros(cap_g, dtype=torch.float64, device=T.device)
            return [T.to(torch.float64), z, z, z, z, z]
        gc, n_ab = run_rows(cells)
        ga, n_a_run = run_rows(heads_a)
        # each cell's a run: the a heads at or before it (K17's count)
        rank_a = scan_ops.segmented_scan("sum", first_a, None)
        n_a = n_a_run.index_select(0, rank_a.index_select(0, cells) - 1) \
            .to(torch.float64)
        n_ab = n_ab.to(torch.float64)
        bc = b.index_select(0, cells)
        # the cells by (group, b): n_b of each (group, b), each cell's n_ab
        # and n_a read through the cells' perm
        g2 = agg_ops.group_by_sort(
            [sort_ops.SortKey(gc, bounds=(0, cap_g - 1)),
             sort_ops.SortKey(bc, unsigned=value_key(
                 args[1], 1).unsigned)],
            torch.ones(nc, dtype=torch.bool, device=cells.device), max(nc, 1))
        n_b_pair = g2.reduce_many([("sum", n_ab, None, False)])[0]
        p2 = g2.perm.long()
        gid2 = torch.clamp(g2.group_ids, max=max(nc, 1) - 1).long()
        nab2 = n_ab.index_select(0, p2)
        na2 = n_a.index_select(0, p2)
        nb2 = n_b_pair.index_select(0, gid2)
        gc2 = gc.index_select(0, p2)
        t2 = T.index_select(0, gc2).to(torch.float64)
        tf = torch.clamp(t2, min=1.0)
        chi = nab2 * nab2 / torch.clamp(na2 * nb2, min=1.0)
        hab = nab2 * torch.log(torch.clamp(nb2 / torch.clamp(nab2, min=1.0),
                                           min=1e-300)) / tf
        pair_first = group_starts(g2)
        # each group's cells lie one after another in both orders
        cnt_c = g.reduce_sorted([("count", None, first_ab, False),
                                 ("count", None, first_a, False)])
        c_end = scan_ops.segmented_scan("sum", cnt_c[0], None)
        c_start = c_end - cnt_c[0]
        s_chi, h_ab, C = scan_ops.segment_reduce_sorted(
            [("sum", chi, None, False), ("sum", hab, None, False),
             ("count", None, pair_first, False)], c_start, c_end, nc)
        a_end = scan_ops.segmented_scan("sum", cnt_c[1], None)
        ta = T.index_select(0, ga).to(torch.float64)
        naf = n_a_run.to(torch.float64)
        ha_terms = naf * torch.log(torch.clamp(
            ta / torch.clamp(naf, min=1.0), min=1e-300)) \
            / torch.clamp(ta, min=1.0)
        h_a = scan_ops.segment_reduce_sorted(
            [("sum", ha_terms, None, False)], a_end - cnt_c[1], a_end, na)[0]
        return [T.to(torch.float64), s_chi, cnt_c[1].to(torch.float64),
                C.to(torch.float64), h_a, h_ab]

    @staticmethod
    def _chi2(states):
        T, s_chi = states[0], states[1]
        return T * torch.clamp(s_chi - 1.0, min=0.0)

    def finalize(self, states):
        return self._result(states), None


class CramersVAgg(_CrossTab):
    name = "cramersV"

    def _result(self, states):
        T, _, R, C, _, _ = states
        k = torch.clamp(torch.minimum(R, C) - 1.0, min=1.0)
        return torch.sqrt(self._chi2(states) / torch.clamp(T * k,
                                                           min=1e-300))


class CramersVBiasCorrectedAgg(_CrossTab):
    name = "cramersVBiasCorrected"

    def _result(self, states):
        T, _, R, C, _, _ = states
        chi2 = self._chi2(states)
        tm1 = torch.clamp(T - 1.0, min=1.0)
        phi2 = torch.clamp(chi2 / torch.clamp(T, min=1.0)
                           - (R - 1.0) * (C - 1.0) / tm1, min=0.0)
        rc = R - (R - 1.0) ** 2 / tm1
        cc = C - (C - 1.0) ** 2 / tm1
        k = torch.clamp(torch.minimum(rc, cc) - 1.0, min=1e-300)
        return torch.sqrt(phi2 / k)


class TheilsUAgg(_CrossTab):
    """theilsU(a, b): the uncertainty coefficient U(a|b)."""
    name = "theilsU"

    def _result(self, states):
        h_a, h_ab = states[4], states[5]
        return torch.where(h_a > 1e-300, (h_a - h_ab) / h_a,
                           torch.zeros_like(h_a))


class ContingencyAgg(_CrossTab):
    name = "contingency"

    def _result(self, states):
        chi2 = self._chi2(states)
        return torch.sqrt(chi2 / torch.clamp(chi2 + states[0], min=1e-300))
