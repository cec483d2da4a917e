"""Logical plan optimizer.

Analog of the reference's QueryPlan optimization passes
(src/Processors/QueryPlan/Optimizations/optimizeTree.cpp:23,121).  Round-1
rule set (the highest-leverage ones for a columnar engine):

  * column pruning     -- trim unused columns all the way into ScanNode
                          (the reference gets this from per-step header
                          tracking; for us it avoids HBM residency + transfer)
  * unused aggregates  -- drop aggregate items nobody reads
  * filter fusion      -- merge adjacent FilterNodes into one predicate

Top-N (limit -> sort hint) is applied by the analyzer; scan-level predicate
pruning (minmax/KeyCondition analog) hooks in here once parts expose stats.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from ..core import dtypes as dt
from ..core.settings import Settings
from ..exprs.expr import BoundCall, BoundColumn, BoundExpr, BoundInList
from . import logical as L

__all__ = ["optimize_plan", "expr_column_refs"]


def expr_column_refs(e: BoundExpr, out: Optional[Set[str]] = None) -> Set[str]:
    if out is None:
        out = set()
    if isinstance(e, BoundColumn):
        out.add(e.name)
    for c in e.children():
        expr_column_refs(c, out)
    return out


_NONDETERMINISTIC = {"now", "today", "yesterday", "rand", "rand32",
                     "rand64", "randconstant", "now64", "sleep",
                     "sleepeachrow", "generateuuidv4", "hostname",
                     "currentuser", "currentdatabase", "uptime", "version",
                     "randomstring", "randomprintableascii",
                     "randomstringutf8", "randomfixedstring"}


def _fold_constants(e):
    """Evaluate pure calls over literals into literals (ActionsDAG constant
    folding analog) — this is what lets part pruning see through
    `d >= toDate('2024-03-01')`."""
    import dataclasses as _dc
    from ..exprs.expr import BoundCall, BoundLiteral, evaluate
    if not isinstance(e, BoundCall):
        return e
    args = [_fold_constants(a) for a in e.args]
    e = _dc.replace(e, args=args)
    if e.name.lower() in _NONDETERMINISTIC or dt.is_composite(e.dtype) \
            or e.dtype.is_array:
        return e
    # fold only dtypes whose literal encoding is unambiguous (decimals /
    # DateTime64 literals carry scale conventions owned by the analyzer)
    base = dt.remove_nullable(e.dtype)
    if not (base.is_dictionary
            or base.name in ("Date", "Date32", "DateTime", "Bool")
            or (base.np_dtype.kind in "iuf" and dt.is_decimal(base) is False
                and not dt.is_enum(base))):
        return e
    if dt.is_decimal(base) or dt.is_interval(base):
        return e
    if args and all(isinstance(a, BoundLiteral) for a in args):
        try:
            cv = evaluate(e, {})
            if not cv.is_const:
                return e
            if cv.validity is not None:
                import numpy as _np
                if not bool(_np.asarray(cv.validity).reshape(-1)[:1].all()):
                    return e           # NULL results keep the call form
            if cv.dtype.is_dictionary:
                if cv.dictionary is None or len(cv.dictionary) != 1:
                    return e
                return BoundLiteral(str(cv.dictionary.values[0]), e.dtype)
            v = cv.host
            if v is None:
                import numpy as _np
                arr = _np.asarray(cv.data)
                if arr.ndim != 0:
                    return e
                v = arr.item()
            if isinstance(v, list):
                return e
            if cv.validity is not None:
                import numpy as _np
                if not bool(_np.asarray(cv.validity).reshape(-1)[:1].all()):
                    return e           # NULL results keep the call form
            return BoundLiteral(v, e.dtype)
        except Exception:              # noqa: BLE001 — folding is best-effort
            return e
    return e


def _fold_plan_constants(node: L.PlanNode) -> None:
    if isinstance(node, L.FilterNode):
        node.predicate = _fold_constants(node.predicate)
    elif isinstance(node, L.ProjectNode):
        node.exprs = [_fold_constants(x) for x in node.exprs]
    for c in node.children():
        _fold_plan_constants(c)


def optimize_plan(plan: L.PlanNode, settings: Settings,
                  catalog=None) -> L.PlanNode:
    _fold_plan_constants(plan)
    plan = _fuse_filters(plan)
    if getattr(settings, "optimize_move_conditions", True):
        plan = _push_filters(plan)
        plan = _fuse_filters(plan)
    if catalog is not None:
        _reorder_join_sides(plan, catalog)
    if catalog is not None and getattr(settings, "optimize_use_projections",
                                       True):
        plan = _apply_projections(plan, catalog)
    _push_limit_into_numbers(plan)
    needed = {f.id for f in plan.schema}
    _prune_columns(plan, needed)
    return plan


# -- join side reordering -----------------------------------------------------
# (optimizeJoin.cpp analog): an INNER join whose written build (right)
# side is far larger than its probe side swaps sides — the build side is
# the capacity-bound one (it sorts into the probe's merged key space), so
# fact-as-build queries would die on capacity where dim-as-build runs.

def _subtree_rows(node: L.PlanNode, catalog) -> int:
    if isinstance(node, L.ScanNode):
        try:
            return catalog.get_table(node.database, node.table).num_rows
        except Exception:      # noqa: BLE001 — virtual sources
            return 0
    rows = [_subtree_rows(c, catalog) for c in node.children()]
    return max(rows) if rows else 0


def _scan_key_unique(node: L.PlanNode, keys, catalog) -> bool:
    from ..exprs.expr import BoundColumn
    while isinstance(node, L.FilterNode):
        node = node.child
    if not isinstance(node, L.ScanNode):
        return False
    field_to_col = {f.id: n for f, n in zip(node.schema, node.column_names)}
    try:
        table = catalog.get_table(node.database, node.table)
    except Exception:          # noqa: BLE001
        return False
    for k in keys:
        if isinstance(k, BoundColumn) and k.name in field_to_col:
            try:
                if table.column_unique(field_to_col[k.name]):
                    return True
            except Exception:  # noqa: BLE001
                return False
    return False


def _reorder_join_sides(node: L.PlanNode, catalog) -> None:
    for c in node.children():
        _reorder_join_sides(c, catalog)
    if not isinstance(node, L.JoinNode):
        return
    if node.kind != "inner" or node.strictness != "all" \
            or node.asof_left is not None:
        return
    if node.build_unique:
        return                  # N:1 propagate path: already optimal
    l = _subtree_rows(node.left, catalog)
    r = _subtree_rows(node.right, catalog)
    if l <= 0 or r <= 4 * l:
        return
    node.left, node.right = node.right, node.left
    node.left_keys, node.right_keys = node.right_keys, node.left_keys
    node.build_unique = _scan_key_unique(node.right, node.right_keys,
                                         catalog)


# -- aggregate-projection rewrite ---------------------------------------------
# (optimizeUseAggregateProjection.cpp analog): an AggregateNode over a plain
# scan (optionally filtered on projection key columns) whose keys are a
# subset of a projection's GROUP BY and whose aggregates all appear in the
# projection scans the hidden STATE table and -Merges instead — exact at any
# key granularity because states merge.

_PROJ_SEQ = [0]


def _proj_fresh_id() -> str:
    _PROJ_SEQ[0] += 1
    return f"#prj{_PROJ_SEQ[0]}"


def _bound_columns(e, out):
    from ..exprs.expr import BoundColumn
    if isinstance(e, BoundColumn):
        out.add(e.name)
    for c in e.children():
        _bound_columns(c, out)


def _remap_bound(e, mapping):
    """Clone a BoundExpr tree with BoundColumn ids rewritten."""
    import dataclasses as _dc
    from ..exprs.expr import BoundColumn
    if isinstance(e, BoundColumn):
        nid = mapping.get(e.name)
        return BoundColumn(nid, e.dtype) if nid is not None else e
    kids = list(e.children())
    if not kids:
        return e
    for f in _dc.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, list) and v and v is not None                 and all(hasattr(x, "dtype") or hasattr(x, "children")
                        for x in v if x is not None):
            try:
                e = _dc.replace(e, **{f.name: [
                    _remap_bound(x, mapping) if hasattr(x, "children")
                    else x for x in v]})
            except TypeError:
                pass
        elif hasattr(v, "children") and hasattr(v, "dtype"):
            try:
                e = _dc.replace(e, **{f.name: _remap_bound(v, mapping)})
            except TypeError:
                pass
    return e


def _apply_projections(plan: L.PlanNode, catalog) -> L.PlanNode:
    import dataclasses as _dc

    def rw(node):
        for f in _dc.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, L.PlanNode):
                object.__setattr__(node, f.name, rw(v))
            elif isinstance(v, list) and v                     and isinstance(v[0], L.PlanNode):
                object.__setattr__(node, f.name, [rw(x) for x in v])
        if isinstance(node, L.AggregateNode):
            r = _try_projection_rewrite(node, catalog)
            if r is not None:
                return r
        return node

    return rw(plan)


def _try_projection_rewrite(agg: L.AggregateNode, catalog):
    from ..exprs.expr import BoundColumn
    child = agg.child
    filt = None
    scan = child
    if isinstance(child, L.FilterNode):
        filt = child.predicate
        scan = child.child
    if not isinstance(scan, L.ScanNode) or scan.final:
        return None
    try:
        table = catalog.get_table(scan.database, scan.table)
    except Exception:
        return None
    projs = getattr(table, "projections", None)
    if not projs:
        return None
    col_of = {f.id: n for f, n in zip(scan.schema, scan.column_names)}
    type_of = {n: f.dtype for f, n in zip(scan.schema, scan.column_names)}
    key_cols = []
    for _, ke in agg.keys:
        if isinstance(ke, BoundColumn) and ke.name in col_of:
            key_cols.append(col_of[ke.name])
        else:
            return None
    filt_cols = set()
    if filt is not None:
        ids = set()
        _bound_columns(filt, ids)
        for i in ids:
            c = col_of.get(i)
            if c is None:
                return None
            filt_cols.add(c)
    sigs = []
    for item in agg.aggregates:
        if item.cond is not None:
            return None
        fn = getattr(item.fn, "name", "").lower()
        if not item.args:
            sigs.append((fn, ""))
        elif len(item.args) == 1 and isinstance(item.args[0], BoundColumn)                 and item.args[0].name in col_of:
            sigs.append((fn, col_of[item.args[0].name]))
        else:
            return None
    for pdef in projs.values():
        if not (set(key_cols) <= set(pdef.key_cols)
                and filt_cols <= set(pdef.key_cols)
                and all(s in pdef.aggs for s in sigs)):
            continue
        return _build_projection_scan(agg, filt, scan, table, pdef,
                                      key_cols, sigs, type_of, col_of)
    return None


def _build_projection_scan(agg, filt, scan, table, pdef, key_cols, sigs,
                           type_of, col_of):
    from ..core import dtypes as dt
    from ..exprs.aggregates import make_merge_for_dtype
    from ..exprs.expr import BoundColumn
    from ..storage.projections import PROJ_DB, state_column_name, \
        storage_name
    store_name = storage_name(scan.database, scan.table, pdef.name)
    # fresh fields for the projection-store scan
    names = list(pdef.key_cols) + [state_column_name(f, a)
                                   for f, a in pdef.aggs]
    fields = []
    for nm in pdef.key_cols:
        fields.append(L.Field(_proj_fresh_id(), nm, type_of[nm]))
    state_fields = {}
    for f, a in pdef.aggs:
        sd = dt.AggregateState(f, [type_of[a]] if a else [])
        fld = L.Field(_proj_fresh_id(), state_column_name(f, a), sd)
        fields.append(fld)
        state_fields[(f, a)] = fld
    scan2 = L.ScanNode(PROJ_DB, store_name, fields, names)
    plan2: L.PlanNode = scan2
    key_id_of = {nm: f.id for nm, f in zip(pdef.key_cols, fields)}
    if filt is not None:
        mapping = {old_id: key_id_of[c] for old_id, c in col_of.items()
                   if c in key_id_of}
        plan2 = L.FilterNode(plan2, _remap_bound(filt, mapping),
                             scan2.schema)
    new_keys = []
    for (kf, ke) in agg.keys:
        c = col_of[ke.name]
        new_keys.append((kf, BoundColumn(key_id_of[c], kf.dtype)))
    new_items = []
    for item, sig in zip(agg.aggregates, sigs):
        fld = state_fields[sig]
        merge_fn = make_merge_for_dtype(fld.dtype)
        new_items.append(L.AggregateItem(
            item.field, merge_fn, [BoundColumn(fld.id, fld.dtype)]))
    return L.AggregateNode(plan2, new_keys, new_items, agg.schema,
                           with_totals=agg.with_totals, mode=agg.mode)


def _push_limit_into_numbers(node: L.PlanNode) -> None:
    """LIMIT n over a projection chain on the virtual numbers source shrinks
    the source itself (the reference reads only ceil(n/block) blocks from
    system.numbers; for us it shrinks the static capacity)."""
    if isinstance(node, L.LimitNode) and node.limit >= 0:
        child = node.child
        while isinstance(child, L.ProjectNode):
            child = child.child
        if isinstance(child, L.NumbersNode):
            child.count = min(child.count, node.limit + max(node.offset, 0))
    for c in node.children():
        _push_limit_into_numbers(c)


# -- predicate pushdown --------------------------------------------------------
# (filterPushDown.cpp / optimizePrimaryKeyCondition analog): move WHERE
# conjuncts below joins / projections / unions / array joins / GROUP BY keys
# so they reach the scans, where part/granule pruning and streamed chunk
# skipping can use them, and shrink join inputs before the gather.

def _split_conj(e: BoundExpr, out: List[BoundExpr]) -> None:
    if isinstance(e, BoundCall) and e.name.lower() == "and":
        for a in e.args:
            _split_conj(a, out)
    else:
        out.append(e)


def _and_all(parts: Sequence[BoundExpr]) -> BoundExpr:
    acc = parts[0]
    for p in parts[1:]:
        acc = BoundCall("and", [acc, p], dt.UInt8)
    return acc


def _is_deterministic(e: BoundExpr) -> bool:
    if isinstance(e, BoundCall) and e.name.lower() in _NONDETERMINISTIC:
        return False
    return all(_is_deterministic(c) for c in e.children())


def _subst_fields(e: BoundExpr, mapping: Dict[str, BoundExpr]):
    """Clone e with BoundColumn ids replaced by mapped expressions.
    Returns None when a referenced id has no mapping."""
    import dataclasses as _dc
    if isinstance(e, BoundColumn):
        return mapping.get(e.name)
    kids = list(e.children())
    if not kids:
        return e
    for f in _dc.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, BoundExpr):
            nv = _subst_fields(v, mapping)
            if nv is None:
                return None
            try:
                e = _dc.replace(e, **{f.name: nv})
            except TypeError:
                return None
        elif isinstance(v, list) and v and any(isinstance(x, BoundExpr)
                                               for x in v):
            nl = []
            for x in v:
                if isinstance(x, BoundExpr):
                    nx = _subst_fields(x, mapping)
                    if nx is None:
                        return None
                    nl.append(nx)
                else:
                    nl.append(x)
            try:
                e = _dc.replace(e, **{f.name: nl})
            except TypeError:
                return None
    return e


def _push_filters(node: L.PlanNode) -> L.PlanNode:
    import dataclasses as _dc
    for f in _dc.fields(node) if _dc.is_dataclass(node) else ():
        v = getattr(node, f.name)
        if isinstance(v, L.PlanNode):
            object.__setattr__(node, f.name, _push_filters(v))
        elif isinstance(v, list) and v and isinstance(v[0], L.PlanNode):
            object.__setattr__(node, f.name, [_push_filters(x) for x in v])
    if not isinstance(node, L.FilterNode):
        return node
    child = node.child
    conj: List[BoundExpr] = []
    _split_conj(node.predicate, conj)

    def _wrap(rest: List[BoundExpr], new_child: L.PlanNode) -> L.PlanNode:
        if not rest:
            return new_child
        return L.FilterNode(new_child, _and_all(rest), node.schema)

    if isinstance(child, L.JoinNode):
        left_ids = {f.id for f in child.left.schema}
        right_ids = {f.id for f in child.right.schema}
        # right-side pushes change ANY/ASOF match selection — only ALL inner
        right_ok = (child.kind in ("inner", "cross")
                    and child.strictness == "all"
                    and child.asof_left is None)
        to_left: List[BoundExpr] = []
        to_right: List[BoundExpr] = []
        rest: List[BoundExpr] = []
        for c in conj:
            refs = expr_column_refs(c)
            if refs and refs <= left_ids and _is_deterministic(c):
                to_left.append(c)
            elif refs and refs <= right_ids and right_ok \
                    and _is_deterministic(c):
                to_right.append(c)
            else:
                rest.append(c)
        if not to_left and not to_right:
            return node
        if to_left:
            child.left = _push_filters(
                L.FilterNode(child.left, _and_all(to_left),
                             list(child.left.schema)))
        if to_right:
            child.right = _push_filters(
                L.FilterNode(child.right, _and_all(to_right),
                             list(child.right.schema)))
        return _wrap(rest, child)

    if isinstance(child, L.ProjectNode):
        mapping = {f.id: e for f, e in zip(child.schema, child.exprs)}
        pushed: List[BoundExpr] = []
        rest = []
        for c in conj:
            refs = expr_column_refs(c)
            ok = all(r in mapping and _is_deterministic(mapping[r])
                     for r in refs)
            nc = _subst_fields(c, mapping) if ok else None
            if nc is not None:
                pushed.append(nc)
            else:
                rest.append(c)
        if not pushed:
            return node
        child.child = _push_filters(
            L.FilterNode(child.child, _and_all(pushed),
                         list(child.child.schema)))
        return _wrap(rest, child)

    if isinstance(child, L.AggregateNode) and child.mode == "single":
        key_map = {f.id: e for f, e in child.keys}
        pushed, rest = [], []
        for c in conj:
            refs = expr_column_refs(c)
            ok = refs and all(r in key_map and _is_deterministic(key_map[r])
                              for r in refs)
            nc = _subst_fields(c, key_map) if ok else None
            if nc is not None:
                pushed.append(nc)
            else:
                rest.append(c)
        if not pushed:
            return node
        child.child = _push_filters(
            L.FilterNode(child.child, _and_all(pushed),
                         list(child.child.schema)))
        return _wrap(rest, child)

    if isinstance(child, L.UnionNode):
        pos_of = {f.id: i for i, f in enumerate(child.schema)}
        if not all(r in pos_of for c in conj for r in expr_column_refs(c)):
            return node
        for i, inp in enumerate(child.inputs):
            mapping = {fid: BoundColumn(inp.schema[p].id, inp.schema[p].dtype)
                       for fid, p in pos_of.items()}
            parts = [_subst_fields(c, mapping) for c in conj]
            if any(p is None for p in parts):
                return node
            child.inputs[i] = _push_filters(
                L.FilterNode(inp, _and_all(parts), list(inp.schema)))
        return child

    if isinstance(child, L.ArrayJoinNode):
        pushed, rest = [], []
        for c in conj:
            refs = expr_column_refs(c)
            if child.out_field.id not in refs and refs \
                    and _is_deterministic(c):
                pushed.append(c)
            else:
                rest.append(c)
        if not pushed:
            return _wrap(conj, child)
        child.child = _push_filters(
            L.FilterNode(child.child, _and_all(pushed),
                         list(child.child.schema)))
        f = L.FilterNode(child, _and_all(rest), child.schema) if rest \
            else child
        return f

    return node


def _fuse_filters(node: L.PlanNode) -> L.PlanNode:
    for attr in ("child", "left", "right"):
        if hasattr(node, attr):
            setattr(node, attr, _fuse_filters(getattr(node, attr)))
    if isinstance(node, L.UnionNode):
        node.inputs = [_fuse_filters(c) for c in node.inputs]
    if isinstance(node, L.FilterNode) and isinstance(node.child, L.FilterNode):
        inner = node.child
        from ..core import dtypes as dt
        combined = BoundCall("and", [inner.predicate, node.predicate],
                             dt.UInt8)
        return L.FilterNode(inner.child, combined, node.schema)
    return node


def _prune_columns(node: L.PlanNode, needed: Set[str]) -> None:
    """Push the set of needed field ids down, trimming producers."""
    if isinstance(node, L.ScanNode):
        keep = [(f, n) for f, n in zip(node.schema, node.column_names)
                if f.id in needed
                or (node.final and (n in node.order_by_cols
                                    or n in node.engine_args))]
        if not keep:        # keep at least one column to carry the row count
            keep = [(node.schema[0], node.column_names[0])]
        node.schema = [f for f, _ in keep]
        node.column_names = [n for _, n in keep]
        return
    if isinstance(node, (L.OneRowNode, L.NumbersNode)):
        return
    if isinstance(node, L.FilterNode):
        child_needed = set(needed) | expr_column_refs(node.predicate)
        _prune_columns(node.child, child_needed)
        node.schema = [f for f in node.child.schema]
        return
    if isinstance(node, L.ProjectNode):
        keep = [(f, e) for f, e in zip(node.schema, node.exprs)
                if f.id in needed]
        if not keep:
            keep = [(node.schema[0], node.exprs[0])]
        node.schema = [f for f, _ in keep]
        node.exprs = [e for _, e in keep]
        child_needed: Set[str] = set()
        for e in node.exprs:
            expr_column_refs(e, child_needed)
        _prune_columns(node.child, child_needed)
        return
    if isinstance(node, L.AggregateNode):
        node.aggregates = [a for a in node.aggregates if a.field.id in needed]
        child_needed: Set[str] = set()
        for _, e in node.keys:
            expr_column_refs(e, child_needed)
        for a in node.aggregates:
            for e in a.args:
                expr_column_refs(e, child_needed)
            if a.cond is not None:
                expr_column_refs(a.cond, child_needed)
        if not child_needed and isinstance(node.child, L.PlanNode):
            # global count(): still need one column for the row mask
            for f in node.child.schema[:1]:
                child_needed.add(f.id)
        _prune_columns(node.child, child_needed)
        node.schema = [f for f, _ in node.keys] + [a.field
                                                   for a in node.aggregates]
        return
    if isinstance(node, L.SortNode):
        child_needed = set(needed)
        for i in node.items:
            expr_column_refs(i.expr, child_needed)
        _prune_columns(node.child, child_needed)
        node.schema = [f for f in node.child.schema]
        return
    if isinstance(node, (L.LimitNode,)):
        _prune_columns(node.child, set(needed))
        node.schema = [f for f in node.child.schema]
        return
    if isinstance(node, L.LimitByNode):
        child_needed = set(needed)
        for e in node.keys:
            expr_column_refs(e, child_needed)
        _prune_columns(node.child, child_needed)
        node.schema = [f for f in node.child.schema]
        return
    if isinstance(node, L.ArrayJoinNode):
        child_needed = set(needed) - {node.out_field.id}
        expr_column_refs(node.array_expr, child_needed)
        _prune_columns(node.child, child_needed)
        kept = {f.id for f in node.child.schema}
        node.schema = [f for f in node.schema
                       if f.id in kept or f.id == node.out_field.id]
        return
    if isinstance(node, L.WindowNode):
        child_needed = set(needed) - {i.field.id for i in node.items}
        for i in node.items:
            for e in i.args + i.partition_by:
                expr_column_refs(e, child_needed)
            for si in i.order_by:
                expr_column_refs(si.expr, child_needed)
        _prune_columns(node.child, child_needed)
        kept = {f.id for f in node.child.schema}
        node.schema = [f for f in node.schema
                       if f.id in kept or f.id in {i.field.id
                                                   for i in node.items}]
        return
    if isinstance(node, L.DistinctNode):
        # DISTINCT semantics depend on its full schema — keep everything
        _prune_columns(node.child, {f.id for f in node.schema})
        return
    if isinstance(node, L.JoinNode):
        left_ids = {f.id for f in node.left.schema}
        lneed: Set[str] = set()
        rneed: Set[str] = set()
        for e in node.left_keys:
            expr_column_refs(e, lneed)
        for e in node.right_keys:
            expr_column_refs(e, rneed)
        if node.asof_left is not None:
            expr_column_refs(node.asof_left, lneed)
        if node.asof_right is not None:
            expr_column_refs(node.asof_right, rneed)
        extra: Set[str] = set(needed)
        if node.residual is not None:
            expr_column_refs(node.residual, extra)
        for fid in extra:
            (lneed if fid in left_ids else rneed).add(fid)
        _prune_columns(node.left, lneed)
        _prune_columns(node.right, rneed)
        kept_left = {f.id for f in node.left.schema}
        kept_right = {f.id for f in node.right.schema}
        node.schema = [f for f in node.schema
                       if f.id in kept_left or f.id in kept_right
                       or f.id in needed]
        return
    if isinstance(node, L.UnionNode):
        # positional: keep positions needed in the union output
        keep_pos = [i for i, f in enumerate(node.schema) if f.id in needed]
        if not keep_pos:
            keep_pos = [0]
        node.schema = [node.schema[i] for i in keep_pos]
        for child in node.inputs:
            child_ids = {child.schema[i].id for i in keep_pos}
            _prune_columns(child, child_ids)
            child.schema = [f for f in child.schema if f.id in child_ids]
        return
    # default: pass everything through
    for c in node.children():
        _prune_columns(c, {f.id for f in c.schema})
