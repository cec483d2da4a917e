"""Plan executor: runs the logical plan on device tensors (reference:
clickhouse_tpu/exec/executor.py).

Operators exchange *masked blocks* (full-capacity columns + a row validity
mask), so Filter is an AND and rows move only where an operator needs it
(aggregate, top-k).  Plans run eagerly, one torch operation or kernel at a
time; the first host synchronisation is ``materialize``.

The row mask stays in parts (``agg_ops.RowMask``: the scan's row count, a
Filter's ``column CMP literal`` terms over numeric columns, and a bool mask
for every other predicate) until a consumer needs a tensor.  GROUP BY ()
reductions and counts hand the parts to K1, which reads each term's column
in its narrow storage: ``SELECT count() FROM t WHERE x > c`` is one pass.
The route is chosen by the predicate's form alone.

Ported nodes: OneRow (SELECT without FROM), Numbers (numbers()), Scan,
Filter, Project, Aggregate (GROUP BY (), dense and sort GROUP BY, WITH
TOTALS), BlockSource (the streamed aggregation's merged groups), Sort (top-k for a LIMIT up to 4,096 rows, else a full stable
sort; LIMIT 0 launches nothing), Limit, LimitBy, Distinct and Join (INNER,
LEFT, RIGHT as the analyzer's swapped LEFT, SEMI, ANTI, ANY and CROSS,
with USING, residual ON predicates and NULL keys; ASOF raises).  Every
other node, and every path of these nodes that is not ported, raises
``NotImplementedError_`` naming it.

DISTINCT and LIMIT BY group the rows with the sort grouping (K4, K5):
DISTINCT emits one row a group in ascending key order, LIMIT BY keeps the
rows of each group whose rank among the group's valid rows (in stream
order: the sort is stable) falls in [offset, offset + n).  WITH TOTALS
aggregates every row of the Aggregate's input as one global group (K1)
beside the grouped result; the totals block rides on the context through
the projections above, and the session materializes it into
``Result.totals``.

A join keeps the probe (left) side's rows in place where each probe row
takes at most one build row (``_join_propagate``: K7's direct-address
table for unique keys in a small proven range, else K8's hash table), and
expands the matches otherwise (the build side grouped with K4 and K5, K8's
probe, K9's expansion): output rows probe-major, build rows in key-sorted
order, as the reference's.

A GROUP BY whose groups may outnumber their slots (the sort grouping, at
most ``max_groups``) registers a capacity check; ``materialize`` reads the
group count there (its first host read) and raises ``CapacityError`` with
the count needed, which the session's autotuner retries with more slots.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import dtypes as dt
from ..core.block import Block
from ..core.column import Dictionary, pad_to
from ..core.errors import (AnalysisError, CapacityError, ExecutionError,
                           MemoryLimitExceeded, NotImplementedError_)
from ..core.settings import Settings
from ..exprs import aggregates as agg_reg
from ..exprs.expr import (DEVICE_KEY, BoundCall, BoundColumn, BoundLiteral,
                          ColVal, StoredColVal, TermColVal, _literal_colval,
                          colval_from_column, evaluate, storage_np)
from ..ops import (_native, agg_ops, filter_ops, join_ops, scan_ops,
                   search, sort_ops)
from ..plan import logical as L

__all__ = ["ExecBlock", "ExecContext", "execute_plan", "materialize"]


@dataclasses.dataclass
class ExecBlock:
    """A masked block: full-capacity columns + row mask."""
    cols: Dict[str, ColVal]        # field id -> ColVal
    rows: agg_ops.RowMask          # kept in parts until a tensor is needed
    capacity: int

    @property
    def valid(self) -> torch.Tensor:
        """The row mask as a bool (capacity,) tensor (built once)."""
        return self.rows.tensor()

    def env(self) -> Dict[str, ColVal]:
        env = dict(self.cols)
        env[DEVICE_KEY] = ColVal(dt.UInt8, torch.empty(
            0, dtype=torch.uint8, device=self.rows.device))
        return env


@dataclasses.dataclass
class Check:
    """A capacity to test at materialize: `value` (a device scalar) must
    not exceed `limit`; `setting` bounds the capacity (the session's
    autotuner retries with it raised)."""
    value: Any
    limit: int
    message: str
    setting: Optional[str] = None


class ExecContext:
    def __init__(self, table_blocks: Dict[Tuple[str, str], Block],
                 settings: Settings, device):
        self.table_blocks = table_blocks
        self.settings = settings
        self.device = torch.device(device)
        self.checks: List[Check] = []
        self.profile: Dict[str, int] = {}
        # interval-analysis facts: field id -> (lo, hi), filled at scans from
        # part minmax stats and propagated through projections
        self.field_bounds: Dict[str, Tuple[int, int]] = {}
        # device bytes a sort, a join or a dictionary's chars may take
        # (the governor's budget less its estimate); None: no limit
        self.memory_headroom: Optional[int] = None
        # WITH TOTALS: the one-row totals block, carried through the
        # projections above the Aggregate (None: no totals)
        self.totals_block: Optional[ExecBlock] = None
        # blocks the streaming program injects (BlockSourceNode key ->
        # ExecBlock: the merged groups of every chunk)
        self.injected: Dict[str, ExecBlock] = {}
        # the aggregates' states will be merged (a streamed chunk's)
        self.merge_states = False

    def count(self, name: str, value: int = 1):
        self.profile[name] = self.profile.get(name, 0) + value


# -- helpers -----------------------------------------------------------------

def _bool_mask(cv: ColVal, capacity: int) -> torch.Tensor:
    """Predicate ColVal -> bool mask (NULL -> False)."""
    cv = cv.broadcast(capacity)
    m = cv.data != 0
    if cv.validity is not None:
        m = m & cv.validity.to(torch.bool)
    return m


# comparison -> the same comparison with its arguments swapped
_CMP_SWAPPED = {"equals": "equals", "notEquals": "notEquals",
                "less": "greater", "greater": "less",
                "lessOrEquals": "greaterOrEquals",
                "greaterOrEquals": "lessOrEquals"}
_PLAIN_NUMERIC = {"Int8", "Int16", "Int32", "Int64", "UInt8", "UInt16",
                  "UInt32", "UInt64", "Float32", "Float64"}


def _conjuncts(expr) -> list:
    """The operands of a (nested) AND; [expr] for any other predicate."""
    if isinstance(expr, BoundCall) and expr.name == "and":
        return [c for a in expr.args for c in _conjuncts(a)]
    return [expr]


def _filter_term(expr, env: Dict[str, ColVal],
                 capacity: int) -> Optional[agg_ops.Term]:
    """`column CMP literal` over a plain numeric column as a K1 term (the
    literal cast as _cmp_exec casts it), or None for any other form."""
    if not isinstance(expr, BoundCall) or expr.name not in _CMP_SWAPPED \
            or len(expr.args) != 2:
        return None
    a, b = expr.args
    cmp = expr.name
    if isinstance(a, BoundLiteral) and isinstance(b, BoundColumn):
        a, b, cmp = b, a, _CMP_SWAPPED[cmp]
    if not isinstance(a, BoundColumn) or not isinstance(b, BoundLiteral) \
            or b.value is None or b.dtype.nullable \
            or b.dtype.name not in _PLAIN_NUMERIC:
        return None
    cv = env.get(a.name)
    if cv is None or cv.dictionary is not None or cv.is_const \
            or dt.remove_nullable(cv.dtype).name not in _PLAIN_NUMERIC:
        return None
    col = cv.storage
    if col.dim() != 1 or col.shape[0] != capacity or (
            cv.validity is not None and cv.validity.shape != col.shape):
        return None
    logical = dt.remove_nullable(cv.dtype).np_dtype
    compare = np.promote_types(logical, b.dtype.np_dtype)
    lit = _literal_colval(b, torch.device("cpu"))
    constant = dt.cast_tensor(lit.data, b.dtype.np_dtype, compare).item()
    return agg_ops.Term(col, cv.validity, logical, cmp, compare, constant)


def _gather_colval(cv: ColVal, idx: torch.Tensor, capacity: int) -> ColVal:
    """The column's rows at idx (a column stored narrow stays narrow; an
    Array's rows with their lengths)."""
    cv = cv.broadcast(capacity)
    validity = cv.validity[idx] if cv.validity is not None else None
    if isinstance(cv, StoredColVal):
        return StoredColVal(cv.dtype, cv.storage[idx], validity)
    lengths = cv.lengths[idx] if cv.lengths is not None else None
    return ColVal(cv.dtype, cv.data[idx], validity, cv.dictionary,
                  lengths=lengths)


def _arange(n: int, device, dtype=torch.int64) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=device)


# -- node execution ----------------------------------------------------------

def execute_plan(node: L.PlanNode, ctx: ExecContext) -> ExecBlock:
    fn = _DISPATCH.get(type(node))
    if fn is None:
        raise NotImplementedError_(
            f"{type(node).__name__} is not ported to the CUDA engine yet")
    return fn(node, ctx)


def _exec_scan(node: L.ScanNode, ctx: ExecContext) -> ExecBlock:
    if node.final:
        raise NotImplementedError_(
            "SELECT ... FINAL is not ported to the CUDA engine yet")
    blk = ctx.table_blocks[(node.database, node.table)]
    cols = {}
    for f, storage_name in zip(node.schema, node.column_names):
        cols[f.id] = colval_from_column(blk[storage_name])
    cap = blk.capacity
    if node.column_stats:
        ctx.field_bounds.update(node.column_stats)
    n = int(blk.num_rows)
    ctx.count("rows_scanned", n)
    return ExecBlock(cols, agg_ops.RowMask(cap, ctx.device, n), cap)


def _exec_filter(node: L.FilterNode, ctx: ExecContext) -> ExecBlock:
    """AND the predicate into the row mask: each `column CMP literal`
    conjunct as a K1 term (up to K1's limit), the rest as a bool mask."""
    child = execute_plan(node.child, ctx)
    env = child.env()
    rows = child.rows
    for conj in _conjuncts(node.predicate):
        term = _filter_term(conj, env, child.capacity) \
            if len(rows.terms) < _native.K1_MAX_TERMS else None
        if term is not None:
            rows = rows.and_term(term)
        else:
            pred = evaluate(conj, env, ctx.memory_headroom)
            rows = rows.and_mask(_bool_mask(pred, child.capacity))
    return ExecBlock(child.cols, rows, child.capacity)


def _exec_project(node: L.ProjectNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    from ..plan import ranges
    env = child.env()
    for name, cv0 in env.items():   # expose interval analysis to functions
        if cv0.bounds is None and name in ctx.field_bounds:
            cv0.bounds = ctx.field_bounds[name]
    cols = {}
    for f, e in zip(node.schema, node.exprs):
        cv = evaluate(e, env, ctx.memory_headroom)
        cols[f.id] = cv.broadcast(child.capacity)
        b = ranges.infer_bounds(e, ctx.field_bounds)
        if b is not None:
            ctx.field_bounds[f.id] = b
    if ctx.totals_block is not None:
        t = ctx.totals_block
        tcols = {}
        for f, e in zip(node.schema, node.exprs):
            try:
                tcols[f.id] = evaluate(e, t.env(), ctx.memory_headroom
                                       ).broadcast(t.capacity)
            except (AnalysisError, NotImplementedError_):
                # as the reference: an expression the totals row cannot
                # evaluate shows its type's zero
                tcols[f.id] = ColVal(f.dtype, torch.zeros(
                    t.capacity, dtype=f.dtype.torch_dtype, device=ctx.device))
        ctx.totals_block = ExecBlock(tcols, t.rows, t.capacity)
    return ExecBlock(cols, child.rows, child.capacity)


def _key_bounds(cv: ColVal, expr, ctx: ExecContext):
    """Proven (lo, hi) of a grouping key: a String's dictionary codes, an
    integer's interval analysis; None otherwise."""
    from ..plan import ranges
    if cv.dtype.is_dictionary:
        d = cv.dictionary
        return (0, max(len(d) - 1, 0)) if d is not None else None
    if cv.dtype.np_dtype.kind in ("i", "u", "b"):
        return ranges.infer_bounds(expr, ctx.field_bounds)
    return None


def _not_array_key(e, schema: List[L.Field], what: str) -> None:
    """Raise NotImplementedError_ naming an Array key `e` (a bound
    expression over `schema`) of GROUP BY, DISTINCT, LIMIT BY or ORDER BY
    (ClickHouse compares arrays element-wise; the port sorts only scalar
    keys)."""
    dtype = e.dtype
    if dtype.is_array:
        name = next((f.display for f in schema
                     if f.id == getattr(e, "name", None)), "an expression")
        raise NotImplementedError_(
            f"{what} over the {dtype} key {name} is not ported to the "
            f"CUDA engine yet")


def _sort_keys(cv: ColVal, b) -> List[sort_ops.SortKey]:
    """One grouping key (broadcast to the block) as sort keys: a Nullable
    key gives its validity and then its data zeroed where NULL; integer
    keys carry their proven bounds b (narrowed to int32 where they fit)
    and UInt64 keys their unsignedness; String keys are dictionary codes,
    floats sort by token."""
    fits32 = b is not None and -2**31 <= b[0] and b[1] < 2**31
    # a column stored as int32 whose bounds fit is read as stored, and a
    # term of a narrow column formed in its source's type: no widened copy
    if fits32 and isinstance(cv, TermColVal):
        data = cv.term.build_narrow().to(torch.int32)
    else:
        data = cv.storage if fits32 and cv.storage.dtype == torch.int32 \
            else cv.data
    out = []
    if cv.validity is not None:
        v = cv.validity.to(torch.bool)
        data = torch.where(v, data, torch.zeros_like(data))
        out.append(sort_ops.SortKey(v, bounds=(0, 1)))
    # narrow 64-bit keys to i32 when bounds prove they fit
    if fits32 and not data.is_floating_point() \
            and data.element_size() == 8:
        data = data.to(torch.int32)
    unsigned = data.dtype == torch.int64 and not cv.dtype.is_dictionary \
        and dt.remove_nullable(cv.dtype).np_dtype == np.uint64
    out.append(sort_ops.SortKey(data, unsigned=unsigned, bounds=b))
    return out


def _agg_key_arrays(node: L.AggregateNode, child: ExecBlock,
                    ctx: ExecContext):
    """-> (key_cvs, key_arrays, dense_dims or None, global_agg); key_arrays
    are each key's sort keys (_sort_keys)."""
    from ..ops.mxu_segsum import MAX_DENSE_GROUPS
    settings = ctx.settings
    cap = child.capacity
    key_cvs = [evaluate(e, child.env(), ctx.memory_headroom)
               for _, e in node.keys]
    if not key_cvs:
        return key_cvs, [], None, True
    arrays: List[sort_ops.SortKey] = []
    dims: List = []
    dense_ok = True
    total = 1
    for (f, e), cv in zip(node.keys, key_cvs):
        cv = cv.broadcast(cap)
        _not_array_key(e, node.child.schema, "GROUP BY")
        b = _key_bounds(cv, e, ctx)
        keys = _sort_keys(cv, b)
        arrays.extend(keys)
        if len(keys) == 2:             # a Nullable key's validity first
            dims.append((0, 2))
            total *= 2
        if b is None:
            dense_ok = False
            dims.append(None)
        else:
            size = b[1] - b[0] + 1
            dims.append((b[0], size))
            total *= size
    if not dense_ok or total <= 0 \
            or total > min(settings.max_groups, MAX_DENSE_GROUPS) \
            or settings.group_by_algorithm == "sort":
        dims = None
    return key_cvs, arrays, dims, False


def _exec_aggregate(node: L.AggregateNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    key_cvs, key_arrays, dims, global_agg = _agg_key_arrays(
        node, child, ctx)
    holistic = any(a.fn.holistic for a in node.aggregates)
    if holistic or not all(a.fn.sum_only for a in node.aggregates):
        dims = None          # dense grouping serves sum-family aggregates
    if node.with_totals and not global_agg:
        ctx.totals_block = _aggregate_totals(node, child, ctx)
    return _aggregate_local(node, child, key_cvs, key_arrays, dims,
                            global_agg, ctx)


def _stage1(node: L.AggregateNode, child: ExecBlock,
            key_arrays: List[sort_ops.SortKey], dims, cap_g: int,
            ctx: ExecContext, global_agg: bool = False):
    """Local grouping + per-aggregate partial states."""
    cap = child.capacity
    from ..plan import ranges
    # GROUP BY () hands the row mask's parts to K1 and the sort grouping
    # to K4 (a scan's rows are sorted with no mask); the dense grouping
    # takes it as a tensor
    rows = child.valid if dims is not None else child.rows
    gctx = agg_reg.GroupContext(row_valid=rows, grouping=None,
                                keys=key_arrays,
                                max_bytes=ctx.memory_headroom,
                                mergeable=ctx.merge_states,
                                checks=ctx.checks, settings=ctx.settings)
    per_agg_inputs = []
    for item in node.aggregates:
        arg_cvs = []
        for a in item.args:
            cv = evaluate(a, child.env(), ctx.memory_headroom).broadcast(cap)
            if cv.bounds is None:
                cv.bounds = ranges.infer_bounds(a, ctx.field_bounds)
            arg_cvs.append(cv)
        cond = None
        if item.cond is not None:
            cond = _bool_mask(evaluate(item.cond, child.env(),
                                      ctx.memory_headroom), cap)
        # RESPECT NULLS takes NULL rows as values: its row mask leaves the
        # argument validities out (reference exec/executor.py:576-582)
        premask = agg_reg.compose_row_mask(
            rows, [] if item.fn.respect_nulls else arg_cvs, cond)
        sec = item.fn.secondary(dataclasses.replace(gctx, premask=premask),
                                arg_cvs, cond) if item.fn.holistic else None
        per_agg_inputs.append((item, arg_cvs, cond, premask, sec))

    if global_agg:
        # GROUP BY (): masked reductions (K1), never a sort
        grouping = agg_ops.group_trivial(ctx.device, cap_g)
    elif dims is not None:
        # provably-small key space: direct-array grouping (K2)
        grouping = agg_ops.group_by_dense(
            [k.data for k in key_arrays], dims, rows, cap_g,
            max_bytes=ctx.memory_headroom,
            held_bytes=_dense_held_bytes(per_agg_inputs, cap, cap_g))
    else:
        # the generic path: a stable sort by the keys (K4, K5), then K6; the
        # first holistic aggregate's secondary keys order each group's rows
        # as it needs them, so its sort is the grouping's own
        first_sec = next((x[4] for x in per_agg_inputs if x[4] is not None),
                         ())
        grouping = agg_ops.group_by_sort(key_arrays, rows, cap_g,
                                         secondary=first_sec,
                                         max_bytes=ctx.memory_headroom)
        # the grouping's perm and group ids stay while the aggregates run
        gctx.hold(8 * grouping.perm.shape[0], "the sort grouping")
    gctx.grouping = grouping

    if grouping.kind == "dense":
        group_counts, states_per_agg = _dense_stage1(
            grouping, child, gctx,
            [(item, arg_cvs, cond)
             for item, arg_cvs, cond, _, _ in per_agg_inputs])
        grouping.present = group_counts > 0
        grouping.num_groups = grouping.present.to(torch.int64).sum()
        return grouping, group_counts, states_per_agg

    group_counts = grouping.count_rows(rows)
    if global_agg:
        grouping.num_groups = (group_counts[0] > 0).to(torch.int64)
    # every aggregate's reductions in one reduce_many call (K6 launched
    # once under the sort grouping, the same reduction asked twice reduced
    # once); a count over exactly the block's rows is the group count
    plans, specs, index = [], [], {}
    for item, arg_cvs, cond, premask, _ in per_agg_inputs:
        if isinstance(item.fn, agg_reg.CountAgg) and premask is rows:
            plans.append((item, arg_cvs, None, []))
            continue
        s, finish = item.fn.reductions(
            dataclasses.replace(gctx, premask=premask), arg_cvs, cond)
        slots = []
        for spec in s:
            key = scan_ops.spec_key(spec)
            if key not in index:
                index[key] = len(specs)
                specs.append(spec)
            slots.append(index[key])
        plans.append((item, arg_cvs, finish, slots))
    results = grouping.reduce_many(specs) if specs else []
    states_per_agg = []
    sorted_groupings = [grouping] if grouping.kind == "sort" else []
    for (item, arg_cvs, finish, slots), (_, _, cond, premask, sec) in zip(
            plans, per_agg_inputs):
        states = [group_counts] if finish is None \
            else finish([results[i] for i in slots])
        if item.fn.two_step:
            actx = dataclasses.replace(gctx, premask=premask)
            g = grouping if sec is None \
                else _holistic_grouping(sorted_groupings, sec, actx, cap_g)
            states = item.fn.sorted_step(actx, g, arg_cvs, cond, states)
        states_per_agg.append((item, arg_cvs, states))
    return grouping, group_counts, states_per_agg


def _same_keys(a, b) -> bool:
    return len(a) == len(b) and all(
        x.data is y.data and x.unsigned == y.unsigned and x.bounds == y.bounds
        for x, y in zip(a, b))


def _holistic_grouping(groupings, sec, gctx, cap_g):
    """The sort grouping by (keys, sec): one of `groupings` sorted with
    the same secondary keys, else a new one (K4, K5; its working set held
    against what the aggregates leave of the budget, and its perm and
    group ids counted while the aggregates run)."""
    for g in groupings:
        if _same_keys(g.secondary, sec):
            return g
    left = None if gctx.max_bytes is None \
        else gctx.max_bytes - gctx.shared["bytes"]
    g = agg_ops.group_by_sort(gctx.keys, gctx.row_valid, cap_g,
                              secondary=sec, max_bytes=left)
    gctx.hold(8 * g.perm.shape[0], "a holistic aggregate's sort grouping")
    groupings.append(g)
    return g


def _dense_held_bytes(per_agg_inputs, cap: int, cap_g: int) -> int:
    """What K2's pass holds beside the dense grouping: each aggregate's
    summed value at its logical width and a row mask (a byte a row), and
    its int64 outputs (a count and a sum of cap_g slots each)."""
    held = 8 * cap_g
    for item, arg_cvs, _, _, _ in per_agg_inputs:
        held += cap + 16 * cap_g
        if isinstance(item.fn, (agg_reg.SumAgg, agg_reg.AvgAgg)):
            held += cap * dt.remove_nullable(arg_cvs[0].dtype).itemsize
    return held


def _dense_stage1(grouping, child: ExecBlock, gctx, per_agg_inputs):
    """All dense (sum-family) aggregates batched into ONE pass of K2."""
    from ..ops import mxu_segsum
    cap_g = grouping.num_groups_cap
    base = child.valid & (grouping.group_ids < cap_g)
    ids = torch.clamp(grouping.group_ids, max=cap_g - 1)

    count_masks: List = [None]           # [0] = the group row counts
    sum_specs: List = []
    plan = []                            # per agg: list of ('c'|'s', index)
    for item, arg_cvs, cond in per_agg_inputs:
        fn = item.fn
        mask = fn._row_mask(gctx, arg_cvs, cond)
        mask = None if mask is child.valid else mask
        if isinstance(fn, agg_reg.CountAgg):
            plan.append([("c", len(count_masks))])
            count_masks.append(mask)
        elif isinstance(fn, (agg_reg.SumAgg, agg_reg.AvgAgg)):
            v = fn._value(gctx, arg_cvs[0])
            sum_specs.append((v, True, arg_cvs[0].bounds, mask))
            steps = [("s", len(sum_specs) - 1)]
            if isinstance(fn, agg_reg.AvgAgg):
                steps.append(("c", len(count_masks)))
                count_masks.append(mask)
            plan.append(steps)
        else:
            raise NotImplementedError_(
                f"dense aggregation of {fn.name} is not ported")

    counts, sums = mxu_segsum.mxu_group_reduce(
        ids, base, count_masks, sum_specs, cap_g)

    states_per_agg = []
    for (item, arg_cvs, cond), steps in zip(per_agg_inputs, plan):
        states = [counts[ref] if kind == "c" else sums[ref]
                  for kind, ref in steps]
        states_per_agg.append((item, arg_cvs, states))
    return counts[0], states_per_agg


def _finalize(node: L.AggregateNode, key_cvs, unique_keys, num_groups,
              group_counts, states_per_agg, cap_g, global_agg,
              ctx: ExecContext, group_valid=None) -> ExecBlock:
    cols: Dict[str, ColVal] = {}
    ki = 0
    for (f, _), cv in zip(node.keys, key_cvs):
        if cv.validity is not None:
            uk_validity = unique_keys[ki].to(torch.uint8)
            ki += 1
        else:
            uk_validity = None
        uk = unique_keys[ki]
        ki += 1
        want = dt.remove_nullable(f.dtype).torch_dtype
        if not f.dtype.is_dictionary and uk.dtype != want \
                and not uk.is_floating_point():
            uk = uk.to(want)         # widen keys narrowed for grouping
        cols[f.id] = ColVal(f.dtype, uk, uk_validity, cv.dictionary)
    for item, arg_cvs, states in states_per_agg:
        out = item.fn.finalize(states)
        data, validity = out[0], out[1]
        lengths = out[2] if len(out) > 2 else None
        if not isinstance(item.fn, agg_reg.CountAgg):
            have = group_counts > 0
            data = torch.where(have[:, None] if data.dim() == 2 else have,
                               data, torch.zeros_like(data))
            if lengths is not None:
                lengths = torch.where(have, lengths,
                                      torch.zeros_like(lengths))
        dict_ = arg_cvs[0].dictionary if (item.args
                                          and item.field.dtype.is_dictionary) \
            else None
        cols[item.field.id] = ColVal(item.field.dtype, data, validity, dict_,
                                     lengths=lengths)
    if group_valid is None:
        if global_agg:
            num_groups = torch.clamp(num_groups, min=1)
        group_valid = _arange(cap_g, ctx.device) < num_groups
    return ExecBlock(cols, agg_ops.RowMask.of(group_valid), cap_g)


def _agg_capacity(child: ExecBlock, dims, global_agg: bool,
                  s: Settings) -> int:
    if global_agg:
        return 1024
    if dims is not None:
        total = 1
        for d in dims:
            total *= d[1]
        return pad_to(total)
    return pad_to(min(child.capacity, s.max_groups))


def _aggregate_local(node: L.AggregateNode, child: ExecBlock, key_cvs,
                     key_arrays, dims, global_agg: bool,
                     ctx: ExecContext) -> ExecBlock:
    s = ctx.settings
    cap_g = _agg_capacity(child, dims, global_agg, s)
    grouping, group_counts, states_per_agg = _stage1(
        node, child, key_arrays, dims, cap_g, ctx, global_agg)
    if not global_agg and dims is None:
        ctx.checks.append(Check(grouping.num_groups, cap_g,
                                "GROUP BY cardinality exceeded max_groups; "
                                "raise the max_groups setting",
                                setting="max_groups"))
    return _finalize(node, key_cvs, grouping.unique_keys,
                     grouping.num_groups, group_counts, states_per_agg,
                     cap_g, global_agg, ctx,
                     group_valid=None if global_agg
                     else grouping.group_valid())


def _aggregate_totals(node: L.AggregateNode, child: ExecBlock,
                      ctx: ExecContext) -> ExecBlock:
    """WITH TOTALS: the aggregates over every row of the Aggregate's input
    (before HAVING) as one global group (K1); the key columns hold their
    type's default, 0 or '' (ClickHouse's TotalsHavingTransform)."""
    tnode = dataclasses.replace(node, keys=[], with_totals=False,
                                schema=[a.field for a in node.aggregates])
    tot = _aggregate_local(tnode, child, [], [], None, True, ctx)
    for f, _ in node.keys:
        t = dt.remove_nullable(f.dtype)
        if f.dtype.is_dictionary:
            tot.cols[f.id] = ColVal(f.dtype, torch.zeros(
                tot.capacity, dtype=torch.int32, device=ctx.device),
                dictionary=Dictionary(np.asarray([""], dtype=object)))
        else:
            tot.cols[f.id] = ColVal(f.dtype, torch.zeros(
                tot.capacity, dtype=t.torch_dtype, device=ctx.device))
    return tot


def _token_for_sort(cv: ColVal, item: L.SortItem,
                    capacity: int) -> torch.Tensor:
    cv = cv.broadcast(capacity)
    rank = None
    dev = cv.data.device
    if cv.dtype.is_dictionary:
        d = cv.dictionary
        if d is not None and len(d):
            vals = d.values.astype(str)
            order = np.argsort(vals, kind="stable")
            r = np.empty(len(vals), np.int64)
            r[order] = np.arange(len(vals))
            rank = torch.from_numpy(r).to(dev)[cv.data.clamp(min=0).long()]
        else:
            rank = torch.zeros(cv.data.shape, dtype=torch.int64, device=dev)
    return sort_ops.order_token(
        cv.data, descending=item.descending, validity=cv.validity,
        nulls_last=item.nulls_last, rank=rank,
        unsigned=dt.is_unsigned(dt.remove_nullable(cv.dtype)))


def _exec_sort(node: L.SortNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    if any(i.fill is not None for i in node.items):
        raise NotImplementedError_(
            "ORDER BY ... WITH FILL is not ported to the CUDA engine yet")
    return _sort_block(node, child, ctx)


def _sort_block(node: L.SortNode, child: ExecBlock, ctx: ExecContext
                ) -> ExecBlock:
    cap = child.capacity
    for it in node.items:
        _not_array_key(it.expr, node.child.schema, "ORDER BY")
    n_valid = filter_ops.count_mask(child.rows)

    s = ctx.settings
    # tokens are built only on the path that reads them: eager torch, unlike
    # the reference's jit, would compute an unused token
    if (node.limit_hint is not None and len(node.items) == 1
            and node.limit_hint <= s.limit_pushdown_threshold
            and node.limit_hint < cap):
        k = int(node.limit_hint)
        out_cap = pad_to(k)
        if k == 0:
            # LIMIT 0: no row, and no kernel
            cols = {fid: _gather_colval(cv, torch.zeros(
                out_cap, dtype=torch.int64, device=ctx.device), cap)
                for fid, cv in child.cols.items()}
            return ExecBlock(cols, agg_ops.RowMask.of(torch.zeros(
                out_cap, dtype=torch.bool, device=ctx.device)), out_cap)
        it0 = node.items[0]
        cv0 = evaluate(it0.expr, child.env(),
                       ctx.memory_headroom).broadcast(cap)
        if k > sort_ops.MAX_TOPK:
            # above K3's k: the first k rows of the full stable sort, the
            # same rows by (invalid, token, row id)
            idx = sort_ops.sort_permutation(
                [_token_for_sort(cv0, it0, cap)], child.valid,
                max_bytes=ctx.memory_headroom)[:k]
        else:
            key32 = sort_ops.topk_key32(cv0, it0.descending)
            if key32 is not None and cap >= (1 << 16):
                idx = sort_ops.topk_permutation32(key32, child.valid, k)
            else:
                idx = sort_ops.topk_permutation(
                    _token_for_sort(cv0, it0, cap), child.valid, k)
        idx_full = torch.zeros((out_cap,), dtype=torch.int64,
                               device=ctx.device)
        idx_full[:k] = idx
        cols = {fid: _gather_colval(cv, idx_full, cap)
                for fid, cv in child.cols.items()}
        valid = _arange(out_cap, ctx.device) < torch.clamp(n_valid, max=k)
        return ExecBlock(cols, agg_ops.RowMask.of(valid), out_cap)

    # no top-k: the full stable multi-key sort (K4)
    tokens = [_token_for_sort(evaluate(i.expr, child.env(),
                                       ctx.memory_headroom), i, cap)
              for i in node.items]
    perm = sort_ops.sort_permutation(tokens, child.valid,
                                     max_bytes=ctx.memory_headroom)
    cols = {fid: _gather_colval(cv, perm, cap)
            for fid, cv in child.cols.items()}
    valid = _arange(cap, ctx.device) < n_valid
    return ExecBlock(cols, agg_ops.RowMask.of(valid), cap)


def _exec_limit(node: L.LimitNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    rank = torch.cumsum(child.valid.to(torch.int64), 0) - 1
    keep = child.valid & (rank >= node.offset)
    if node.limit >= 0:
        keep = keep & (rank < node.offset + node.limit)
    return ExecBlock(child.cols, agg_ops.RowMask.of(keep), child.capacity)


def _group_rows(child: ExecBlock, keys, ctx: ExecContext, what: str,
                secondary=(), max_bytes="headroom"):
    """The sort grouping (K4, K5) of the block's rows by keys, (ColVal,
    bound expression) pairs, at most max_groups slots (a capacity check
    the session's autotuner retries); secondary: SortKeys ordering the
    rows within a group; max_bytes: the limit on the sort's working set
    (default what the governor's estimate leaves).  -> (grouping,
    slots)."""
    cap = child.capacity
    sort_keys: List[sort_ops.SortKey] = []
    for cv, e in keys:
        cv = cv.broadcast(cap)
        sort_keys.extend(_sort_keys(cv, _key_bounds(cv, e, ctx)))
    if not sort_keys and not secondary:
        # one group of every row, in row order
        sort_keys = [sort_ops.SortKey(torch.zeros(
            cap, dtype=torch.bool, device=ctx.device), bounds=(0, 0))]
    cap_g = pad_to(min(cap, ctx.settings.max_groups))
    g = agg_ops.group_by_sort(
        sort_keys, child.rows, cap_g, secondary=secondary,
        max_bytes=ctx.memory_headroom if max_bytes == "headroom"
        else max_bytes)
    ctx.checks.append(Check(g.num_groups, cap_g,
                            f"{what} cardinality exceeded max_groups; raise "
                            f"the max_groups setting", setting="max_groups"))
    return g, cap_g


def _exec_limit_by(node: L.LimitByNode, ctx: ExecContext) -> ExecBlock:
    """LIMIT n [OFFSET m] BY keys: the sort grouping (K4, K5) ranks each
    valid row among its group's valid rows in stream order (the sort is
    stable); the rows ranked in [m, m + n) keep their place."""
    child = execute_plan(node.child, ctx)
    cap = child.capacity
    env = child.env()
    for e in node.keys:
        _not_array_key(e, node.child.schema, "LIMIT BY")
    g, cap_g = _group_rows(child, [(evaluate(e, env, ctx.memory_headroom), e)
                                   for e in node.keys],
                           ctx, "LIMIT BY")
    # a group's valid rows are the sorted positions [starts, ends): the
    # rank of position i is i - starts[gid] (int32: K5 takes fewer than
    # 2^31 rows)
    gid = g.group_ids
    start = g.starts.to(torch.int32).index_select(
        0, torch.clamp(gid, max=cap_g - 1))
    rank = _arange(gid.shape[0], ctx.device, torch.int32) - start
    keep_sorted = (gid < cap_g) & (rank >= node.offset) \
        & (rank < node.offset + node.n)
    # back to row order: a scatter through the permutation
    keep = torch.zeros(cap, dtype=torch.bool, device=ctx.device).scatter_(
        0, g.perm.long(), keep_sorted)
    return ExecBlock(child.cols, child.rows.and_mask(keep), cap)


def _exec_distinct(node: L.DistinctNode, ctx: ExecContext) -> ExecBlock:
    """SELECT DISTINCT: the sort grouping (K4, K5) over every output
    column; one row a group, at its first row, in ascending key order."""
    child = execute_plan(node.child, ctx)
    cap = child.capacity
    for f in node.schema:
        _not_array_key(BoundColumn(f.id, f.dtype), node.schema, "DISTINCT")
    cvs = [child.cols[f.id].broadcast(cap) for f in node.schema]
    g, cap_g = _group_rows(child, [(cv, BoundColumn(f.id, f.dtype))
                                   for f, cv in zip(node.schema, cvs)],
                           ctx, "DISTINCT")
    first = g.perm.index_select(
        0, torch.clamp(g.starts, 0, max(g.perm.shape[0] - 1, 0))).long()
    cols = {f.id: _gather_colval(cv, first, cap)
            for f, cv in zip(node.schema, cvs)}
    return ExecBlock(cols, agg_ops.RowMask.of(g.group_valid()), cap_g)


def _exec_blocksource(node: L.BlockSourceNode, ctx: ExecContext
                      ) -> ExecBlock:
    """The block the streaming program injected (its merged groups)."""
    return ctx.injected[node.key]


def _exec_onerow(node: L.OneRowNode, ctx: ExecContext) -> ExecBlock:
    """SELECT without FROM: one row of a zero column."""
    cap = 1024
    f = node.schema[0]
    cols = {f.id: ColVal(f.dtype, torch.zeros(
        cap, dtype=f.dtype.torch_dtype, device=ctx.device))}
    return ExecBlock(cols, agg_ops.RowMask(cap, ctx.device, 1), cap)


def _exec_numbers(node: L.NumbersNode, ctx: ExecContext) -> ExecBlock:
    """numbers(start, count): UInt64 as int64 bits, its bounds proven."""
    cap = pad_to(node.count)
    f = node.schema[0]
    start = node.start - (1 << 64) if node.start >= 1 << 63 else node.start
    data = _arange(cap, ctx.device) + start
    b = (node.start, node.start + max(node.count - 1, 0))
    ctx.field_bounds[f.id] = b
    return ExecBlock({f.id: ColVal(f.dtype, data, bounds=b)},
                     agg_ops.RowMask(cap, ctx.device, node.count), cap)


# -- joins -------------------------------------------------------------------

def _unify_join_keys(lk: ColVal, rk: ColVal, lcap: int, rcap: int,
                     bounds=None):
    """Common representation of one join key pair (dictionary unification
    for strings, numpy's supertype cast otherwise).  bounds: the proven
    (lo, hi) over both sides' integer keys, or None; where both keys are
    8-byte integers within int32 they come back as int32 (the reference
    narrows them so), read from a column's int32 storage without a copy.
    -> (left keys, right keys, left validity, right validity)."""
    lk = lk.broadcast(lcap)
    rk = rk.broadcast(rcap)
    if lk.dtype.is_dictionary and rk.dtype.is_dictionary:
        from ..exprs.functions import _string_codes_common
        la, ra, _merged = _string_codes_common(lk, rk)
        return la, ra, lk.validity, rk.validity
    lt, rt = storage_np(lk), storage_np(rk)
    ct = np.promote_types(lt, rt)
    if ct.kind in ("i", "u") and ct.itemsize == 8 and bounds is not None \
            and -2**31 <= bounds[0] and bounds[1] < 2**31:
        return _int32_key(lk, lt), _int32_key(rk, rt), lk.validity, \
            rk.validity
    return dt.cast_tensor(lk.data, lt, ct), dt.cast_tensor(rk.data, rt, ct), \
        lk.validity, rk.validity


def _int32_key(cv: ColVal, logical) -> torch.Tensor:
    """An integer key proven within int32, as int32 (its storage itself
    where that is int32)."""
    st = cv.storage
    if st.dtype == torch.int32:
        return st
    if st.dtype in (torch.int8, torch.int16, torch.uint8):
        return st.to(torch.int32)
    return dt.cast_tensor(cv.data, logical, np.int32)


def _colval_words(cv: ColVal, capacity: int, bounds=None):
    """Decompose a ColVal into 32-bit words + a reassembler (the build
    columns' words that the N:1 join carries to its probe rows).
    -> (words, rebuild, narrow): rebuild(words) gives the column's data;
    narrow says the data is its one word's value (the column is then kept
    as that int32 word, read as stored); None for types without words."""
    cv = cv.broadcast(capacity)
    logical = storage_np(cv)
    kind = logical.kind
    itemsize = logical.itemsize
    words: List[torch.Tensor] = []
    narrow = False
    fits = bounds is not None and -2**31 <= bounds[0] and bounds[1] < 2**31
    if kind in ("i", "u", "b") and (itemsize <= 4 or fits):
        if isinstance(cv, StoredColVal) and cv.storage.dtype in (
                torch.int8, torch.uint8, torch.int16, torch.int32):
            # the stored values themselves: no widened column is built
            words.append(cv.storage.to(torch.int32))
        else:
            words.append(dt.cast_tensor(cv.data, logical, np.int32))
        # the word holds the value itself unless it wrapped (UInt32)
        narrow = fits or logical != np.uint32

        def rebuild(ws, lt=logical):
            return dt.cast_tensor(ws[0], np.int32, lt)
    elif kind in ("i", "u"):
        data = cv.data.to(torch.int64)
        words.append((data & 0xFFFFFFFF).to(torch.int32))          # lo
        words.append((data >> 32).to(torch.int32))                 # hi

        def rebuild(ws, lt=logical):
            lo = ws[0].to(torch.int64) & 0xFFFFFFFF
            return ((ws[1].to(torch.int64) << 32) | lo).to(
                dt.torch_dtype_of(lt))
    elif logical == np.float32:
        words.append(cv.data.to(torch.float32).contiguous().view(
            torch.int32))

        def rebuild(ws):
            return ws[0].contiguous().view(torch.float32)
    elif logical == np.float64:
        from ..ops.hash_ops import f64_from_token, f64_token
        bits = f64_token(cv.data)
        words.append((bits & 0xFFFFFFFF).to(torch.int32))
        words.append((bits >> 32).to(torch.int32))

        def rebuild(ws):
            lo = ws[0].to(torch.int64) & 0xFFFFFFFF
            return f64_from_token((ws[1].to(torch.int64) << 32) | lo)
    else:
        return None
    if cv.validity is not None:
        words.append(cv.validity.to(torch.int32))
    return words, rebuild, narrow


def _propagate_ok(node: L.JoinNode, right: ExecBlock) -> bool:
    """Can this join run on the propagate (no-expansion) path?"""
    if node.kind == "cross":
        return False
    if node.strictness in ("semi", "anti", "any", "asof"):
        ok_kinds = True
    elif node.strictness == "all" and node.kind in ("inner", "left") \
            and node.build_unique:
        ok_kinds = True
    else:
        return False
    left_ids = {f.id for f in node.left.schema}
    for f in node.schema:
        if f.id in left_ids:
            continue
        if not node.reads(f.id):
            continue
        if right.cols.get(f.id) is None:
            return False
    return ok_kinds


def _dense_words(node: L.JoinNode, per_field, build_words, ctx):
    """The direct-address path's output words (the reference's dense
    eligibility: one unique integer key in a proven range of at most
    join_dense_table_entries slots, each payload word with a sentinel
    outside its proven range, at most join_dense_gather_max_words
    gathers), as (entries, (lo, hi)); None where it does not apply.  Each
    word entry carries its proven range, from which K7 sizes its slot.  Two
    departures, both to the hash path: a UInt32 payload whose values pass
    2^31 (its wrapped word may equal the sentinel, which the reference
    does not check), and more than K7_MAX_ENTRIES words (K7's limit a
    call)."""
    from ..plan import ranges
    s = ctx.settings
    rb = ranges.infer_bounds(node.right_keys[0], ctx.field_bounds)
    if rb is None or rb[1] - rb[0] + 1 > s.join_dense_table_entries:
        return None
    key_field = node.right_keys[0].name \
        if isinstance(node.right_keys[0], BoundColumn) else None
    entries = []
    n_gathers = 0
    wi = 0
    for f, cvb, n_data, _rebuild, narrow in per_field:
        fb = ctx.field_bounds.get(f.id)
        n_words = n_data + (1 if cvb.validity is not None else 0)
        fws = build_words[wi:wi + n_words]
        wi += n_words
        is_key = f.id == key_field and n_data == 1
        if _rebuild is None:              # an Array: row id and lengths
            for w, (lo_, hi_) in zip(fws, narrow):
                entries.append(("word", w, lo_ - 1, (lo_, hi_)))
                n_gathers += 1
            continue
        for j, w in enumerate(fws):
            if is_key:                    # value == probe key: free
                entries.append(("key",) if j < n_data else ("keyvalid",))
            elif j >= n_data:             # validity word in {0, 1}
                entries.append(("word", w, 2, (0, 1)))
                n_gathers += 1
            elif n_data == 1 and fb is not None and narrow:
                # (a word that wrapped, a UInt32 above 2^31, could equal
                # a sentinel taken from its value's bounds)
                lo_, hi_ = int(fb[0]), int(fb[1])
                if lo_ > -(2 ** 31) + 1:
                    entries.append(("word", w, lo_ - 1, (lo_, hi_)))
                elif hi_ < 2 ** 31 - 2:
                    entries.append(("word", w, hi_ + 1, (lo_, hi_)))
                else:
                    return None           # no sentinel available
                n_gathers += 1
            else:
                return None               # unbounded / multi-word
    if n_gathers > s.join_dense_gather_max_words \
            or len(entries) > _native.K7_MAX_ENTRIES:
        return None
    return entries, rb


def _check_join_bytes(ctx: ExecContext, need: int, n_probe: int) -> None:
    """Hold a join's working set against what the governor's estimate
    leaves of the budget, before the join allocates any of it (the
    estimate counts one 8-byte intermediate a row of the join's schema,
    not the kernels' flags, words, tables and slots)."""
    left = ctx.memory_headroom
    if left is not None and need > left:
        raise MemoryLimitExceeded(
            f"joining {n_probe} probe rows would need {need} bytes of device "
            f"memory ({max(left, 0)} bytes of the budget left)")


def _join_propagate(node: L.JoinNode, left: ExecBlock, right: ExecBlock,
                    lkeys, rkeys, probe_ok, build_ok,
                    ctx: ExecContext) -> ExecBlock:
    """Propagate-join execution: the output keeps the probe rows in place
    (capacity = the probe side's)."""
    s = ctx.settings
    lcap, rcap = left.capacity, right.capacity
    left_ids = {f.id for f in node.left.schema}
    # only the right-side columns read above the join are carried
    right_fields = [f for f in node.schema
                    if f.id not in left_ids and node.reads(f.id)]
    # (field, cv, n_data_words, rebuild, narrow); an Array's rebuild is
    # None: its words are its build row id and its lengths, each in
    # [0, hi] (the proven ranges K7 sizes their slots by)
    per_field = []
    build_words: List[torch.Tensor] = []
    for f in right_fields:
        cv = right.cols[f.id]
        if cv.dtype.is_array:
            cvb = cv.broadcast(rcap)
            lens = cvb.lengths if cvb.lengths is not None else torch.full(
                (rcap,), cvb.data.shape[-1], dtype=torch.int32,
                device=cvb.data.device)
            per_field.append((f, cvb, 2, None,
                              ((0, rcap - 1), (0, cvb.data.shape[-1]))))
            build_words.extend([_arange(rcap, cvb.data.device, torch.int32),
                                lens.to(torch.int32)])
            continue
        dec = _colval_words(cv, rcap, bounds=ctx.field_bounds.get(f.id))
        if dec is None:
            raise NotImplementedError_(
                f"JOIN payload columns of type {cv.dtype} are not ported to "
                f"the CUDA engine yet")
        words, rebuild, narrow = dec
        cvb = cv.broadcast(rcap)
        n_data = len(words) - (1 if cvb.validity is not None else 0)
        per_field.append((f, cvb, n_data, rebuild, narrow))
        build_words.extend(words)

    # Dense direct-address fast path (K7): unique build keys in a small
    # proven range turn the join into one table scatter and one gather a
    # probe row per payload word
    pr = None
    if (len(rkeys) == 1 and s.join_dense_gather
            and (node.build_unique or node.strictness in ("semi", "anti"))
            and not rkeys[0].is_floating_point()
            and rkeys[0].dtype != torch.bool
            and not node.right_keys[0].dtype.is_dictionary):
        dense = _dense_words(node, per_field, build_words, ctx)
        if dense is not None:
            entries, rb = dense
            # K7's match flags, output words and table
            _check_join_bytes(ctx, lcap * (1 + 4 * len(entries))
                              + (rb[1] - rb[0] + 1)
                              * join_ops.dense_slot_layout(entries)[1], lcap)
            ctx.count("DenseGatherJoins")
            pr = join_ops.dense_gather_join(rkeys[0], build_ok, lkeys[0],
                                            probe_ok, entries, rb[0], rb[1])
            # the table's layout trusts the proven ranges: K7 tests them
            ctx.checks.append(Check(pr.out_of_range, 0,
                                    "a JOIN build row lies outside its "
                                    "proven value range"))
    if pr is None:
        _check_join_bytes(ctx, join_ops.hash_join_bytes(
            rcap, lcap, len(build_words)), lcap)
        pr = join_ops.propagate_join(rkeys, build_ok, lkeys, probe_ok,
                                     build_words)

    if node.strictness in ("semi", "anti"):
        keep = pr.matched if node.strictness == "semi" else ~pr.matched
        return ExecBlock(left.cols, left.rows.and_mask(keep), lcap)

    left_outer = node.kind == "left"
    mmask = pr.matched
    cols: Dict[str, ColVal] = {f.id: left.cols[f.id] for f in node.schema
                               if f.id in left_ids and node.reads(f.id)}
    wi = 0
    for f, cv, nw, rebuild, narrow in per_field:
        has_v = cv.validity is not None
        ws = pr.words[wi:wi + nw]
        wi += nw + (1 if has_v else 0)
        if rebuild is None:
            # an Array: its matrix rows by the build row id, and its
            # lengths (an unmatched row is the empty array, [])
            data = cv.data.index_select(0, ws[0].to(torch.int64).clamp_(
                0, rcap - 1))
            data = torch.where(mmask[:, None], data, torch.zeros(
                (), dtype=data.dtype, device=data.device))
            lengths = torch.where(mmask, ws[1], torch.zeros(
                (), dtype=torch.int32, device=data.device))
            cols[f.id] = ColVal(cv.dtype, data, None, lengths=lengths)
            continue
        validity = (pr.words[wi - 1] & 1).to(torch.uint8) if has_v else None
        if left_outer:
            data = rebuild(ws)
            if s.join_use_nulls or cv.dtype.nullable:
                v = validity if validity is not None \
                    else torch.ones(data.shape, dtype=torch.uint8,
                                    device=data.device)
                validity = torch.where(mmask, v, 0).to(torch.uint8)
            else:
                data = torch.where(mmask, data, _default_scalar(cv))
            cols[f.id] = ColVal(cv.dtype, data, validity, cv.dictionary)
        elif narrow and not cv.dtype.is_dictionary:
            # the kernels wrote 0 where unmatched: the word as stored
            cols[f.id] = StoredColVal(cv.dtype, ws[0], validity)
        else:
            data = rebuild(ws)
            data = torch.where(mmask, data, torch.zeros((), dtype=data.dtype,
                                                        device=data.device))
            cols[f.id] = ColVal(cv.dtype, data, validity, cv.dictionary)

    rows = left.rows if left_outer else left.rows.and_mask(mmask)
    out = ExecBlock(cols, rows, lcap)
    if node.residual is not None:
        pred = evaluate(node.residual, out.env(), ctx.memory_headroom)
        out = ExecBlock(out.cols, out.rows.and_mask(_bool_mask(pred, lcap)),
                        lcap)
    return out


def _exec_join(node: L.JoinNode, ctx: ExecContext) -> ExecBlock:
    if node.strictness == "asof":
        raise NotImplementedError_(
            "ASOF JOIN is not ported to the CUDA engine yet")
    left = execute_plan(node.left, ctx)
    right = execute_plan(node.right, ctx)
    lcap, rcap = left.capacity, right.capacity
    s = ctx.settings
    dev = ctx.device

    if node.kind == "cross":
        lkeys = [torch.zeros(lcap, dtype=torch.int32, device=dev)]
        rkeys = [torch.zeros(rcap, dtype=torch.int32, device=dev)]
        lvs, rvs = [], []
    else:
        from ..plan import ranges
        lkey_cvs = [evaluate(e, left.env(), ctx.memory_headroom)
                    for e in node.left_keys]
        rkey_cvs = [evaluate(e, right.env(), ctx.memory_headroom)
                    for e in node.right_keys]
        lkeys, rkeys, lvs, rvs = [], [], [], []
        for le, re_, lk_cv, rk_cv in zip(node.left_keys, node.right_keys,
                                         lkey_cvs, rkey_cvs):
            lb = ranges.infer_bounds(le, ctx.field_bounds)
            rb = ranges.infer_bounds(re_, ctx.field_bounds)
            both = None if lb is None or rb is None \
                else (min(lb[0], rb[0]), max(lb[1], rb[1]))
            la, ra, lv, rv = _unify_join_keys(lk_cv, rk_cv, lcap, rcap, both)
            lkeys.append(la)
            rkeys.append(ra)
            if lv is not None:     # NULL keys never match
                lvs.append(lv.to(torch.bool))
            if rv is not None:
                rvs.append(rv.to(torch.bool))
    build_ok = right.valid
    for v in rvs:
        build_ok = build_ok & v

    if _propagate_ok(node, right):
        # the probe rows past the scan's row count need no mask: the
        # output's row mask drops them
        probe_ok = None
        if left.rows.mask is not None or left.rows.terms or lvs:
            probe_ok = left.valid
            for v in lvs:
                probe_ok = probe_ok & v
        return _join_propagate(node, left, right, lkeys, rkeys,
                               probe_ok, build_ok, ctx)

    # a scan's probe rows (no mask, no terms) go to K8 and K9 as their row
    # count: K9 gives the rows past it no slot, and no row mask is built
    counted = left.rows.mask is None and not left.rows.terms
    probe_ok = None if counted else left.valid
    for v in lvs:
        probe_ok = v if probe_ok is None else probe_ok & v
    cap_g = pad_to(min(rcap, s.max_join_build_rows))
    semi = node.strictness in ("semi", "anti")
    if node.kind == "cross":
        # every row meets every row: the product of the two sides' rows
        # (their row bounds, or, above 2^24, their counts read back; the
        # reference caps the capacity at 2^24 rows, a CapacityError no
        # setting raises: a streamed cross join's chunk yields more)
        n_out = min(lcap, left.rows.n_rows) * min(rcap, right.rows.n_rows)
        if n_out > 1 << 24:
            n_out = int(filter_ops.count_mask(left.rows)) \
                * int(filter_ops.count_mask(right.rows))
        out_cap = pad_to(n_out)
    elif s.max_joined_rows > 0:
        out_cap = pad_to(s.max_joined_rows)
    else:
        out_cap = pad_to(lcap + rcap)
    # K8's table over the groups and its probe (two words), and K9's slots
    # and status words (the grouping holds its own check)
    _check_join_bytes(ctx, join_ops.hash_join_bytes(cap_g, lcap, 2) + (
        0 if semi else join_ops.expand_matches_bytes(lcap, out_cap)), lcap)
    table = join_ops.build_join_table(rkeys, build_ok, cap_g,
                                      max_bytes=ctx.memory_headroom)
    pr = join_ops.probe_join_table(table, lkeys, probe_ok)

    if semi:
        keep = pr.matched if node.strictness == "semi" else ~pr.matched
        return ExecBlock(left.cols, left.rows.and_mask(keep), lcap)

    left_outer = node.kind == "left"
    any_join = node.strictness == "any"
    p_idx, b_pos, mmask, out_count = join_ops.expand_matches(
        pr, None if counted else left.valid, out_cap, left=left_outer,
        any_join=any_join, n_rows=left.rows.n_rows)
    ctx.checks.append(Check(out_count, out_cap,
                            "JOIN result exceeded the output capacity; raise "
                            "the max_joined_rows setting",
                            setting="max_joined_rows"))

    # b_pos addresses the key-sorted build order: each build column is
    # gathered through row_order once (build-sized), then once a slot
    order = table.row_order
    if order.numel() == 0:
        order = torch.zeros(1, dtype=torch.int32, device=dev)
    b_idx = torch.clamp(b_pos, 0, order.shape[0] - 1)
    cols: Dict[str, ColVal] = {}
    left_ids = {f.id for f in node.left.schema}
    for f in node.schema:
        if not node.reads(f.id):
            continue                 # nothing above the join reads it
        if f.id in left_ids:
            cols[f.id] = _gather_colval(left.cols[f.id], p_idx, lcap)
            continue
        cv = right.cols[f.id].broadcast(rcap)
        stored = isinstance(cv, StoredColVal)      # gathered as stored
        data = (cv.storage if stored else cv.data).index_select(
            0, order).index_select(0, b_idx)
        validity = None if cv.validity is None else \
            cv.validity.index_select(0, order).index_select(0, b_idx)
        if cv.dtype.is_array:
            # an Array: its rows and their lengths (unmatched: [])
            lengths = torch.full((rcap,), data.shape[-1], dtype=torch.int32,
                                 device=dev) if cv.lengths is None \
                else cv.lengths
            lengths = lengths.index_select(0, order).index_select(0, b_idx)
            if left_outer:
                data = torch.where(mmask[:, None], data, torch.zeros(
                    (), dtype=data.dtype, device=dev))
                lengths = torch.where(mmask, lengths, torch.zeros(
                    (), dtype=lengths.dtype, device=dev))
            cols[f.id] = ColVal(cv.dtype, data, validity, lengths=lengths)
            continue
        if left_outer:
            # join_use_nulls=0 semantics: unmatched -> default value
            if s.join_use_nulls or cv.dtype.nullable:
                v = validity if validity is not None \
                    else torch.ones(data.shape, dtype=torch.uint8,
                                    device=dev)
                validity = torch.where(mmask, v, 0).to(torch.uint8)
            else:
                data = torch.where(mmask, data, torch.zeros(
                    (), dtype=data.dtype, device=dev) if stored
                    else _default_scalar(cv))
        cols[f.id] = StoredColVal(cv.dtype, data, validity) if stored \
            else ColVal(cv.dtype, data, validity, cv.dictionary)

    # the match flags are False past out_count: an INNER or CROSS join's
    # rows are its matched slots
    valid = _arange(out_cap, dev, torch.int32) < out_count \
        if node.kind == "left" else mmask
    out = ExecBlock(cols, agg_ops.RowMask.of(valid), out_cap)
    if node.residual is not None:
        pred = evaluate(node.residual, out.env(), ctx.memory_headroom)
        out = ExecBlock(out.cols,
                        out.rows.and_mask(_bool_mask(pred, out_cap)),
                        out_cap)
    return out


def _default_scalar(cv: ColVal) -> torch.Tensor:
    """A LEFT join's value for an unmatched row (join_use_nulls=0): 0, or
    '' for a String, added to its dictionary where it is missing."""
    dev = cv.data.device
    if cv.dtype.is_dictionary:
        d = cv.dictionary
        if d is not None:
            code = d.lookup("")
            if code < 0:
                code = d.append("")
            return torch.tensor(code, dtype=cv.data.dtype, device=dev)
    return torch.zeros((), dtype=cv.data.dtype, device=dev)


# -- window functions --------------------------------------------------------

def _hold_bytes(ctx: ExecContext, need: int, what: str) -> Optional[int]:
    """Hold an operator's working set (beyond what the governor's estimate
    counts) against what the estimate leaves of the budget, before the
    operator allocates it.  -> what is left for its sort grouping (None:
    no limit)."""
    left = ctx.memory_headroom
    if left is None:
        return None
    if need > left:
        raise MemoryLimitExceeded(
            f"{what} would need {need} bytes of device memory "
            f"({max(left, 0)} bytes of the budget left)")
    return left - need


def _window_order_key(cv: ColVal, si: L.SortItem, ctx: ExecContext,
                      cap: int) -> sort_ops.SortKey:
    """A window's ORDER BY item as a secondary sort key: a non-NULL
    integer with proven bounds within int32 as its int32 values (less
    their upper bound where DESC: K4 sorts its narrow passes), anything
    else as its order token (NULLS FIRST/LAST, DESC, strings by rank,
    floats; u64 bits, its range read from the device)."""
    cv = cv.broadcast(cap)
    t = dt.remove_nullable(cv.dtype)
    if cv.validity is None and not cv.dtype.is_dictionary \
            and t.np_dtype.kind in ("i", "u") and t.np_dtype != np.uint64:
        b = _key_bounds(cv, si.expr, ctx)
        if b is not None and -2**31 <= b[0] and b[1] < 2**31 \
                and b[1] - b[0] < 2**31:
            k = _sort_keys(cv, b)[0]
            if not si.descending:
                return k
            return sort_ops.SortKey(
                (b[1] - k.data.to(torch.int32)).to(torch.int32),
                bounds=(0, b[1] - b[0]))
    return sort_ops.SortKey(_token_for_sort(cv, si, cap), unsigned=True)


def _boundary(gid: torch.Tensor) -> torch.Tensor:
    """True at each sorted row that starts a group (row 0 included)."""
    pb = torch.ones(gid.shape[0], dtype=torch.bool, device=gid.device)
    if gid.shape[0] > 1:
        torch.ne(gid[1:], gid[:-1], out=pb[1:])
    return pb


class _WindowSort:
    """One window's partitions: the sort grouping (K4, K5) by the
    PARTITION BY keys with the ORDER BY keys as secondaries, and what the
    window's calls share over it (the reference sorts for every call;
    calls over one PARTITION BY and ORDER BY share one sort here).  Rows
    are in sorted order: a partition's rows are consecutive, valid rows
    first (an invalid row has no group), each partition ordered."""

    def __init__(self, item: L.WindowItem, child: ExecBlock, schema,
                 ctx: ExecContext, max_bytes: Optional[int]):
        cap = child.capacity
        env = child.env()
        self.item, self.cap = item, cap
        for e in item.partition_by:
            _not_array_key(e, schema, "PARTITION BY")
        for si in item.order_by:
            _not_array_key(si.expr, schema, "a window's ORDER BY")
        self.order_cvs = [evaluate(si.expr, env, ctx.memory_headroom
                                   ).broadcast(cap) for si in item.order_by]
        okeys = [_window_order_key(cv, si, ctx, cap)
                 for cv, si in zip(self.order_cvs, item.order_by)]
        pkeys = [(evaluate(e, env, ctx.memory_headroom), e)
                 for e in item.partition_by]
        g, cap_g = _group_rows(child, pkeys, ctx, "window PARTITION BY",
                               secondary=okeys, max_bytes=max_bytes)
        self.g, self.cap_g, self.okeys = g, cap_g, okeys
        self.n = g.perm.shape[0]
        self.perm = g.perm.long()
        gid = g.group_ids
        self.valid_s = gid < cap_g
        self.gidc = torch.clamp(gid, max=cap_g - 1)
        self.pb = _boundary(gid)
        self._cache: Dict[str, torch.Tensor] = {}
        # the frames (repr((mode, lo, hi))) two or more calls share
        self.shared_frames: set = set()

    def _lazy(self, name, build):
        if name not in self._cache:
            self._cache[name] = build()
        return self._cache[name]

    @property
    def s_row(self) -> torch.Tensor:
        """Each sorted row's partition's first row (int64)."""
        return self._lazy("s_row", lambda: self.g.starts.index_select(
            0, self.gidc))

    @property
    def e_row(self) -> torch.Tensor:
        """Each sorted row's partition's last row (int64)."""
        return self._lazy("e_row", lambda: self.g.ends.index_select(
            0, self.gidc) - 1)

    @property
    def tie_b(self) -> torch.Tensor:
        """True where a sorted row starts its peer group (its partition
        starts, or an ORDER BY key differs from the row before)."""
        def build():
            tie = self.pb.clone()
            for k in self.okeys:
                ts = k.data.expand(self.cap).index_select(0, self.g.perm)
                tie[1:] |= ts[1:] != ts[:-1]
            return tie
        return self._lazy("tie_b", build)

    @property
    def tie_first(self) -> torch.Tensor:
        """Each row's peer group's first row: K17's "first" of the row
        index over the peer groups."""
        return self._lazy("tie_first", lambda: scan_ops.segmented_scan(
            "first", None, self.tie_b))

    @property
    def tie_last(self) -> torch.Tensor:
        """Each row's peer group's last row: K17's reverse "first"."""
        return self._lazy("tie_last", lambda: scan_ops.segmented_scan(
            "first", None, self.tie_b, reverse=True))

    def range_edge(self, off: int, side: str) -> torch.Tensor:
        """Sorted index of the first (side left) / last (right) row of the
        partition whose ORDER BY value lies within `off` of the row's: K18
        over the sorted ORDER BY tokens, each row's query its value
        shifted by off (saturated at its logical type's bounds) within
        its own partition's rows."""
        si = self.item.order_by[0]
        cvs = _gather_colval(self.order_cvs[0], self.perm, self.cap)
        n = self.n
        tok = self._lazy("order_token", lambda: _token_for_sort(cvs, si, n))
        delta = off if not si.descending else -off
        data = cvs.data
        logical = dt.remove_nullable(cvs.dtype).np_dtype
        if logical.kind == "b":
            raise NotImplementedError_(
                "a RANGE offset frame over a Bool ORDER BY is not ported to "
                "the CUDA engine yet")
        if logical == np.uint64:
            # unsigned saturation over the u64 bits (signed after a flip)
            u = data ^ _I64_SIGN
            if delta >= 0:
                top = _as_i64((((1 << 64) - 1 - delta) ^ (1 << 63)))
                sh = torch.where(u > top, torch.full_like(data, -1),
                                 data + delta)
            else:
                low = _as_i64((-delta) ^ (1 << 63))
                sh = torch.where(u < low, torch.zeros_like(data),
                                 data + delta)
        elif logical.kind in ("i", "u"):
            info = np.iinfo(logical)
            x = data.to(torch.int64)
            if delta >= 0:
                sh = torch.where(x > int(info.max) - delta,
                                 torch.full_like(x, int(info.max)), x + delta)
            else:
                sh = torch.where(x < int(info.min) - delta,
                                 torch.full_like(x, int(info.min)), x + delta)
        else:
            sh = data + delta
        qtok = _token_for_sort(ColVal(cvs.dtype, sh, cvs.validity,
                                      cvs.dictionary), si, n)
        del sh
        pos = search.segmented_search(tok, qtok, side, gid=self.gidc,
                                      starts=self.g.starts, ends=self.g.ends,
                                      unsigned=True)
        return pos if side == "left" else pos - 1


_I64_SIGN = -(1 << 63)


def _as_i64(v: int) -> int:
    """A u64 value as its int64 bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _sorted_values(cv: ColVal, perm: torch.Tensor, cap: int) -> torch.Tensor:
    """A window argument's values in sorted order: a column stored narrow
    gathered as stored, a Term's source gathered and formed."""
    cv = cv.broadcast(cap)
    if isinstance(cv, TermColVal):
        return cv.term.index_select(0, perm)
    src = cv.storage if isinstance(cv, StoredColVal) else cv.data
    return src.index_select(0, perm)


def _frame_of(item: L.WindowItem):
    """(mode, lo, hi) of a call's frame: None unbounded, 0 the current
    row, a signed offset."""
    if item.frame == "full":
        return "rows", None, None
    if item.frame == "running":
        return "range", None, 0
    return item.frame


# device bytes a sorted row of one window holds while its calls run, at
# most: the permutation as int64, the clamped group ids, the partitions'
# first and last rows, the peer groups' first and last rows (int64 each),
# the partition, peer and validity flags
_WINDOW_SORT_ROW_BYTES = 48


def _window_bytes(item: L.WindowItem, n: int, cap: int) -> int:
    """Device bytes one window call holds beside its window's shared
    arrays (_WINDOW_SORT_ROW_BYTES) and sort, at most: a numbering or an
    offset (row_number, rank, dense_rank, lag, lead) three int64 arrays a
    sorted row, a frame's bounds, values, scans and gathers eight, four
    more for a RANGE offset frame's tokens and K18's results; and the
    result in row order with its validity (9 bytes a row)."""
    mode, lo, hi = _frame_of(item)
    arrays = 3 if item.fn in ("row_number", "rank", "dense_rank", "lag",
                              "lead") else 8
    if mode == "range" and (lo not in (None, 0) or hi not in (None, 0)):
        arrays += 4
    return 8 * arrays * n + 9 * cap + scan_ops.segmented_scan_bytes(n)


def _frame_bounds(ws: _WindowSort, mode, lo, hi):
    """Each sorted row's frame [lo_idx, hi_idx] clipped to its partition,
    and whether it holds a row."""
    n = ws.n
    i_arr = _arange(n, ws.perm.device)
    s_row, e_row = ws.s_row, ws.e_row
    if mode == "rows":
        lo0 = s_row if lo is None else i_arr + lo
        hi0 = e_row if hi is None else i_arr + hi
    else:
        lo0 = s_row if lo is None else (
            ws.tie_first if lo == 0 else ws.range_edge(lo, "left"))
        hi0 = e_row if hi is None else (
            ws.tie_last if hi == 0 else ws.range_edge(hi, "right"))
    nonempty = (lo0 <= hi0) & (lo0 <= e_row) & (hi0 >= s_row)
    lo_idx = torch.clamp(torch.maximum(lo0, s_row), 0, n - 1)
    hi_idx = torch.clamp(torch.minimum(hi0, e_row), 0, n - 1)
    return nonempty, lo_idx, hi_idx


def _window_extreme(fn: str, v_s: torch.Tensor, argmask, unsigned: bool,
                    lo_idx, hi_idx, width: int) -> torch.Tensor:
    """min/max over frames whose both edges move: a sparse range-min
    table (level k holds the extreme of the 2^k rows from each row), each
    frame covered by two overlapping power-of-two spans of its level.
    Built level by level with two levels held at a time (the reference
    stacks every level: exec/executor.py:1166-1203); plain torch."""
    is_bool = v_s.dtype == torch.bool
    base = v_s.to(torch.int64) if is_bool else v_s
    if unsigned:
        base = base ^ _I64_SIGN           # u64 order as int64 order
    if base.is_floating_point():
        ident = float("inf") if fn == "min" else float("-inf")
    else:
        info = torch.iinfo(base.dtype)
        ident = info.max if fn == "min" else info.min
    op = torch.minimum if fn == "min" else torch.maximum
    level = base if argmask is None else torch.where(
        argmask, base, torch.full_like(base, ident))
    n = level.shape[0]
    length = torch.clamp(hi_idx - lo_idx + 1, min=1)
    levels = max(1, int(width).bit_length())
    kk = torch.clamp(torch.floor(torch.log2(length.to(torch.float64))).to(
        torch.int64), 0, levels - 1)
    out = torch.zeros_like(base)
    for k in range(levels):
        if k:
            step = 1 << (k - 1)
            shifted = torch.full_like(level, ident)
            shifted[:max(n - step, 0)] = level[step:]
            level = op(level, shifted)
            del shifted
        a1 = level.index_select(0, lo_idx)
        a2 = level.index_select(0, torch.maximum(hi_idx - (1 << k) + 1,
                                                 lo_idx))
        out = torch.where(kk == k, op(a1, a2), out)
    if unsigned:
        out = out ^ _I64_SIGN
    return out.to(torch.bool) if is_bool else out


def _window_frame_agg(item: L.WindowItem, fn: str, ws: _WindowSort,
                      cv0: Optional[ColVal], v_s, argmask):
    """Aggregate window functions over a frame, in sorted order (the
    reference's _window_frame_agg, exec/executor.py:1033; ClickHouse's
    WindowTransform).  Every row's frame [lo, hi] is found at once: ROWS
    offsets by arithmetic, peers by K17's peer bounds, RANGE offsets by
    K18; sums and counts are K17 prefix sums differenced at the frame's
    edges, min and max K17 running or suffix scans, or the sparse table
    where both edges move.  argmask: the sorted rows whose argument is
    not NULL (None: every row).  -> (values, validity, dictionary)."""
    mode, lo, hi = _frame_of(item)
    if mode == "range" and (lo not in (None, 0) or hi not in (None, 0)):
        if len(item.order_by) != 1:
            raise ExecutionError("RANGE OFFSET frames require exactly one "
                                 "ORDER BY expression")
        if ws.order_cvs[0].dtype.is_dictionary:
            raise ExecutionError("RANGE OFFSET frames require a numeric "
                                 "ORDER BY expression")
    # calls of the window over one frame share its bounds (Qw3's sum and
    # count: one pair of K18 searches); a frame of one call is not kept
    frame = repr((mode, lo, hi))
    if frame in ws.shared_frames:
        nonempty, lo_idx, hi_idx = ws._lazy(
            f"frame {frame}", lambda: _frame_bounds(ws, mode, lo, hi))
    else:
        nonempty, lo_idx, hi_idx = _frame_bounds(ws, mode, lo, hi)
    # a ROWS frame that ends (starts) at the row itself reads a running
    # (suffix) scan at the row: no gather
    hi_is_row = mode == "rows" and hi == 0
    lo_is_row = mode == "rows" and lo == 0

    def frame_sum(data, mask):
        pre = scan_ops.segmented_scan("sum", data, ws.pb, mask)
        at_hi = pre if hi_is_row else pre.index_select(0, hi_idx)
        zero = torch.zeros((), dtype=pre.dtype, device=pre.device)
        if lo is None:
            return torch.where(nonempty, at_hi, zero)
        prev = torch.where(lo_idx > ws.s_row, pre.index_select(
            0, torch.clamp(lo_idx - 1, min=0)), zero)
        return torch.where(nonempty, at_hi - prev, zero)

    if argmask is None:
        # every row of a frame counts: its length
        fcnt = torch.where(nonempty, hi_idx - lo_idx + 1,
                           torch.zeros_like(lo_idx))
    else:
        fcnt = frame_sum(argmask, None)
    if fn == "count":
        return fcnt, None, None

    if fn in ("sum", "avg"):
        st = dt.remove_nullable(item.field.dtype).torch_dtype
        acc = v_s.to(torch.float64) if fn == "avg" or st.is_floating_point \
            else v_s
        out_s = frame_sum(acc, argmask)
        if fn == "avg":
            out_s = torch.where(
                fcnt > 0, out_s / torch.clamp(fcnt, min=1).to(torch.float64),
                torch.full((), float("nan"), dtype=torch.float64,
                           device=out_s.device))
        return out_s, None, None

    dict_ = cv0.dictionary
    unsigned = not cv0.dtype.is_dictionary \
        and dt.remove_nullable(cv0.dtype).np_dtype == np.uint64
    if fn in ("min", "max"):
        if lo is None:
            pre = scan_ops.segmented_scan(fn, v_s, ws.pb, argmask,
                                          unsigned=unsigned)
            out_s = pre if hi_is_row else pre.index_select(0, hi_idx)
        elif hi is None:
            suf = scan_ops.segmented_scan(fn, v_s, ws.pb, argmask,
                                          reverse=True, unsigned=unsigned)
            out_s = suf if lo_is_row else suf.index_select(0, lo_idx)
        else:
            width = hi - lo + 1 if mode == "rows" else ws.n
            out_s = _window_extreme(fn, v_s, argmask, unsigned, lo_idx,
                                    hi_idx, width)
        out_s = torch.where(nonempty & (fcnt > 0), out_s,
                            torch.zeros((), dtype=out_s.dtype,
                                        device=out_s.device))
        return out_s, None, dict_

    # any, first_value, last_value
    if fn == "any":
        # the first non-NULL value in the frame (AggregateFunctionAny)
        if argmask is None:
            idx0, ok = lo_idx, nonempty
        else:
            nxt = scan_ops.segmented_scan("min", None, ws.pb, argmask,
                                          reverse=True)
            at = nxt.index_select(0, lo_idx)
            idx0 = torch.clamp(at, 0, ws.n - 1)
            ok = nonempty & (at <= hi_idx)
    else:
        idx0 = lo_idx if fn == "first_value" else hi_idx
        ok = nonempty
        if argmask is not None:
            ok = ok & argmask.index_select(0, idx0)
    out_s = torch.where(ok, v_s.index_select(0, idx0),
                        torch.zeros((), dtype=v_s.dtype, device=v_s.device))
    validity = ok.to(torch.uint8) \
        if argmask is not None or item.field.dtype.nullable else None
    return out_s, validity, dict_


def _window_call(item: L.WindowItem, ws: _WindowSort, child: ExecBlock,
                 ctx: ExecContext):
    """One window call's values in sorted order -> (values, validity,
    dictionary)."""
    fn = item.fn
    n = ws.n
    dev = ws.perm.device
    cv0 = v_s = argmask = None
    if item.args:
        cv0 = evaluate(item.args[0], child.env(), ctx.memory_headroom
                       ).broadcast(child.capacity)
        if fn not in ("row_number", "rank", "dense_rank", "count"):
            v_s = _sorted_values(cv0, ws.perm, child.capacity)
        if cv0.validity is not None:
            argmask = cv0.validity.to(torch.bool).index_select(0, ws.perm)
    if fn == "row_number":
        return _arange(n, dev) - ws.s_row + 1, None, None
    if fn == "rank":
        return ws.tie_first - ws.s_row + 1, None, None
    if fn == "dense_rank":
        return scan_ops.segmented_scan("sum", ws.tie_b, ws.pb), None, None
    if fn in ("lag", "lead"):
        shift = item.shift if fn == "lag" else -item.shift
        idx = _arange(n, dev) - shift
        idx_c = torch.clamp(idx, 0, max(n - 1, 0))
        ok = (idx >= 0) & (idx < n) & ws.valid_s \
            & (ws.gidc.index_select(0, idx_c) == ws.gidc)
        out_s = torch.where(ok, v_s.index_select(0, idx_c),
                            torch.zeros((), dtype=v_s.dtype, device=dev))
        return out_s, ok.to(torch.uint8), cv0.dictionary
    if fn in ("count", "sum", "avg", "min", "max", "any", "first_value",
              "last_value"):
        return _window_frame_agg(item, fn, ws, cv0, v_s, argmask)
    raise NotImplementedError_(f"window function '{fn}'")


def _window_key(item: L.WindowItem) -> str:
    """The calls of one window (PARTITION BY and ORDER BY alike) share its
    sort."""
    return repr((item.partition_by, [(si.expr, si.descending, si.nulls_last)
                                     for si in item.order_by]))


def _exec_window(node: L.WindowNode, ctx: ExecContext) -> ExecBlock:
    """Window functions over sorted partitions (the reference's
    _exec_window, exec/executor.py:1232; ClickHouse's WindowTransform):
    the sort grouping (K4, K5) by the PARTITION BY keys with the ORDER BY
    keys as secondaries, a call's values computed in sorted order
    (row_number and rank from the partitions' bounds, K17's scans, K18's
    searches), and each result scattered back to row order through the
    permutation (the reference sorts by the inverse permutation).  Before
    it allocates, a call holds its working set (_window_bytes, and its
    sort's) against what the governor's estimate leaves of the budget,
    and raises MemoryLimitExceeded naming the call."""
    child = execute_plan(node.child, ctx)
    cap = child.capacity
    rows = child.rows
    n = min(cap, rows.n_rows) if rows.mask is None and not rows.terms \
        else cap
    cols = dict(child.cols)
    sorts: Dict[str, _WindowSort] = {}
    frames: Dict[Tuple[str, str], int] = {}
    for item in node.items:
        if item.fn not in ("row_number", "rank", "dense_rank", "lag",
                           "lead"):
            f = (_window_key(item), repr(_frame_of(item)))
            frames[f] = frames.get(f, 0) + 1
    held = 0
    for item in node.items:
        what = f"the window function {item.field.display} over {n} rows"
        key = _window_key(item)
        kept = {f for (k, f), c in frames.items() if k == key and c > 1}
        # a kept frame's bounds: two int64 arrays and a flag a row
        shared = 0 if key in sorts \
            else (_WINDOW_SORT_ROW_BYTES + 17 * len(kept)) * n
        left = _hold_bytes(ctx, held + shared + _window_bytes(item, n, cap),
                           what)
        if key not in sorts:
            try:
                sorts[key] = _WindowSort(item, child, node.child.schema, ctx,
                                         left)
            except MemoryLimitExceeded as e:
                raise MemoryLimitExceeded(f"{what}: {e}") from None
            sorts[key].shared_frames = kept
            held += shared
        ws = sorts[key]
        out_s, validity_s, dict_ = _window_call(item, ws, child, ctx)
        st = out_s.dtype if item.field.dtype.is_dictionary \
            else dt.remove_nullable(item.field.dtype).torch_dtype
        out = torch.zeros(cap, dtype=st, device=ctx.device)
        out.index_copy_(0, ws.perm, out_s.to(st))
        validity = None
        if validity_s is not None:
            validity = torch.zeros(cap, dtype=torch.uint8, device=ctx.device)
            validity.index_copy_(0, ws.perm, validity_s)
        cols[item.field.id] = ColVal(item.field.dtype, out, validity, dict_)
        del out_s, validity_s
        held += 9 * cap
    return ExecBlock(cols, rows, cap)


# -- UNION ALL, INTERSECT, EXCEPT ---------------------------------------------

def _pad_width(x: torch.Tensor, width: int) -> torch.Tensor:
    """An Array's (rows, max_len) matrix padded with zeros to width."""
    if x.dim() >= 2 and x.shape[-1] < width:
        return torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    return x


def _union_column(f: L.Field, pieces: List[ColVal]) -> ColVal:
    """One output column of UNION ALL: the branches' rows one after
    another, String codes recoded into one dictionary (Dictionary.unify),
    validity where a branch has it, an Array's rows padded to the widest
    branch with their lengths.  A column every branch stores narrow in one
    type stays narrow."""
    dev = pieces[0].storage.device
    want = dt.remove_nullable(f.dtype).np_dtype
    is_arr = dt.remove_nullable(f.dtype).is_array
    width = max((cv.data.shape[-1] for cv in pieces if cv.data.dim() >= 2),
                default=0) if is_arr else 0
    validity = None
    if any(cv.validity is not None for cv in pieces):
        validity = torch.cat([
            cv.validity.to(torch.uint8) if cv.validity is not None
            else torch.ones(cv.storage.shape[0], dtype=torch.uint8,
                            device=dev) for cv in pieces])
    stored = [cv.storage for cv in pieces
              if isinstance(cv, StoredColVal) and storage_np(cv) == want]
    if not f.dtype.is_dictionary and not is_arr \
            and len(stored) == len(pieces) \
            and len({t.dtype for t in stored}) == 1:
        return StoredColVal(f.dtype, torch.cat(stored), validity)
    dict_ = None
    if f.dtype.is_dictionary:
        merged, recoded = None, []
        for cv in pieces:
            d = cv.dictionary or Dictionary(np.asarray([], dtype=object))
            x0 = _pad_width(cv.data, width) if is_arr else cv.data
            if merged is None:
                merged = d
                recoded.append(x0)
                continue
            # unify keeps the merged dictionary's codes; an empty
            # dictionary's codes are padding only
            merged, _, rb = Dictionary.unify(merged, d)
            recoded.append(torch.from_numpy(rb).to(dev).index_select(
                0, torch.clamp(x0.reshape(-1), min=0).long()).reshape(
                x0.shape) if len(rb) else x0)
        data, dict_ = torch.cat(recoded), merged
    else:
        data = torch.cat([_pad_width(dt.cast_tensor(
            cv.data, storage_np(cv), want), width) for cv in pieces])
    lengths = None
    if is_arr:
        lens = []
        for cv in pieces:
            lv = cv.lengths
            if lv is None:                # full-width rows
                lv = torch.full((cv.data.shape[0],), cv.data.shape[-1],
                                dtype=torch.int32, device=dev)
            elif lv.dim() == 0:
                lv = lv.expand(cv.data.shape[0])
            lens.append(lv.to(torch.int32))
        lengths = torch.cat(lens)
    return ColVal(f.dtype, data, validity, dict_, lengths=lengths)


def _exec_union(node: L.UnionNode, ctx: ExecContext,
                blocks: Optional[List[ExecBlock]] = None) -> ExecBlock:
    """UNION ALL (and ROLLUP, CUBE, GROUPING SETS and FULL JOIN, which the
    analyzer plans as a union of branches): the branches' blocks one
    after another (the reference's _exec_union, exec/executor.py:1799).
    An output column's proven bounds are its branches' together."""
    if blocks is None:
        blocks = [execute_plan(c, ctx) for c in node.inputs]
    cols: Dict[str, ColVal] = {}
    for i, f in enumerate(node.schema):
        pieces = [b.cols[c.schema[i].id].broadcast(b.capacity)
                  for b, c in zip(blocks, node.inputs)]
        cols[f.id] = _union_column(f, pieces)
        bs = [ctx.field_bounds.get(c.schema[i].id) for c in node.inputs]
        if all(b is not None for b in bs):
            ctx.field_bounds[f.id] = (min(b[0] for b in bs),
                                      max(b[1] for b in bs))
    valid = torch.cat([b.valid for b in blocks])
    return ExecBlock(cols, agg_ops.RowMask.of(valid),
                     sum(b.capacity for b in blocks))


def _exec_setop(node: L.SetOpNode, ctx: ExecContext) -> ExecBlock:
    """INTERSECT / EXCEPT, ALL (multisets) or DISTINCT (the reference's
    _exec_setop, exec/executor.py:1881; ClickHouse's
    IntersectOrExceptTransform): ONE sort grouping (K4, K5) of both
    sides' rows brings equal rows together; a left row's occurrence
    index within its group is K17's running count of the group's left
    rows; the i-th left occurrence survives iff i < the group's right
    rows (INTERSECT ALL) or i >= them (EXCEPT ALL); DISTINCT keeps a
    group's first left row where the right side has (INTERSECT) or lacks
    (EXCEPT) the value.  The flags go back to row order by a scatter
    through the permutation."""
    left = execute_plan(node.left, ctx)
    right = execute_plan(node.right, ctx)
    eb = _exec_union(L.UnionNode([node.left, node.right], node.schema), ctx,
                     [left, right])
    cap, lcap = eb.capacity, left.capacity
    what = f"{node.op.upper()}{'' if node.distinct else ' ALL'}"
    for f in node.schema:
        _not_array_key(BoundColumn(f.id, f.dtype), node.schema, what)
    # beside the sort: the permutation as int64, the running counts and
    # their tiles, the flags
    left_bytes = _hold_bytes(ctx, 8 * cap + scan_ops.segmented_scan_bytes(
        cap) + 4 * cap, f"{what} over {cap} rows")
    g, cap_g = _group_rows(eb, [(eb.cols[f.id], BoundColumn(f.id, f.dtype))
                                for f in node.schema], ctx, what,
                           max_bytes=left_bytes)
    n = g.perm.shape[0]
    keep = torch.zeros(cap, dtype=torch.bool, device=ctx.device)
    if n:
        gid = g.group_ids
        la = (gid < cap_g) & (g.perm < lcap)      # a left row, in a group
        seen = scan_ops.segmented_scan("sum", la, _boundary(gid))
        # a group's left rows: the running count at its last row
        n_left = torch.where(g.ends > g.starts, seen.index_select(
            0, torch.clamp(g.ends - 1, 0, n - 1)), torch.zeros_like(g.ends))
        n_right = (g.ends - g.starts - n_left).index_select(
            0, torch.clamp(gid, max=cap_g - 1))
        pos = seen - 1
        if node.distinct:
            keep_s = la & (pos == 0) & ((n_right > 0) if node.op ==
                                        "intersect" else (n_right == 0))
        elif node.op == "intersect":
            keep_s = la & (pos < n_right)
        else:
            keep_s = la & (pos >= n_right)
        keep.scatter_(0, g.perm.long(), keep_s)
    return ExecBlock(eb.cols, eb.rows.and_mask(keep), cap)


_DISPATCH: Dict[type, Callable] = {
    L.OneRowNode: _exec_onerow,
    L.NumbersNode: _exec_numbers,
    L.ScanNode: _exec_scan,
    L.FilterNode: _exec_filter,
    L.ProjectNode: _exec_project,
    L.AggregateNode: _exec_aggregate,
    L.SortNode: _exec_sort,
    L.LimitNode: _exec_limit,
    L.LimitByNode: _exec_limit_by,
    L.DistinctNode: _exec_distinct,
    L.JoinNode: _exec_join,
    L.BlockSourceNode: _exec_blocksource,
    L.WindowNode: _exec_window,
    L.UnionNode: _exec_union,
    L.SetOpNode: _exec_setop,
}


# -- materialization ---------------------------------------------------------

def _array_rows(cv: ColVal, data: np.ndarray, pick) -> np.ndarray:
    """An Array result's visible rows (data: their (rows, max_len)
    matrix; pick: the visible rows of a tensor) as Python lists of their
    first `length` elements, as the reference gives them (lengths None:
    full-width rows)."""
    if cv.lengths is None:
        lens = np.full(len(data), data.shape[-1])
    else:
        lens = pick(cv.lengths).cpu().numpy()
    rows = np.empty(len(data), object)
    for i in range(len(data)):
        rows[i] = data[i][:lens[i]].tolist()
    return rows


def materialize(block: ExecBlock, schema: List[L.Field],
                ctx: Optional[ExecContext] = None) -> Dict[str, np.ndarray]:
    """Pull the visible rows to host, in order (first host sync point),
    after testing the plan's capacity checks."""
    valid = block.valid
    valid_np = valid.cpu().numpy()
    # the visible rows are picked on the device: only they cross to the
    # host (a sorted block keeps every slot, LIMIT a few of them)
    sel = None if valid_np.all() else torch.from_numpy(
        np.flatnonzero(valid_np)).to(valid.device)

    def pick(t: torch.Tensor) -> torch.Tensor:
        return t if sel is None else t.index_select(0, sel)
    for check in (ctx.checks if ctx is not None else ()):
        actual = int(check.value)
        if actual > check.limit:
            raise CapacityError(f"{check.message} (needed {actual}, "
                                f"capacity {check.limit})",
                                setting=check.setting, needed=actual)
    out: Dict[str, np.ndarray] = {}
    for f in schema:
        cv = block.cols[f.id].broadcast(block.capacity)
        if dt.is_composite(cv.dtype) or cv.dtype.agg_state is not None:
            raise NotImplementedError_(
                f"{cv.dtype} results are not ported to the CUDA engine yet")
        data = dt.to_numpy_storage(
            pick(cv.data), dt.remove_nullable(cv.dtype).np_dtype)
        if cv.dtype.is_array:
            data = _array_rows(cv, data, pick)
        elif cv.dtype.is_dictionary:
            codes = data.astype(np.int64)
            vals = np.empty(len(codes), object)
            d = cv.dictionary
            ok = (codes >= 0) & (codes < (len(d) if d else 0))
            if d is not None and len(d):
                vals[ok] = d.values[codes[ok]]
            vals[~ok] = ""
            data = vals
        if cv.validity is not None:
            v = pick(cv.validity).cpu().numpy()
            data = data.astype(object) if data.dtype != object \
                else data.copy()
            data[v == 0] = None
        from ..core import typed
        if typed.needs_decode(cv.dtype):
            data = typed.decode_for_display(cv.dtype, data)
        name = f.display
        if name in out:   # duplicate display names: disambiguate
            k = 1
            while f"{name}_{k}" in out:
                k += 1
            name = f"{name}_{k}"
        out[name] = data
    return out
