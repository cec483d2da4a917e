"""Analyzer: AST -> bound logical plan.

The analog of the reference's QueryAnalyzer + Planner
(src/Analyzer/Resolve/QueryAnalyzer.cpp, src/Planner/Planner.cpp:1355):
resolves identifiers through scopes (FROM/joins/CTEs/aliases), types every
expression, splits aggregation into keys + mergeable aggregate items, and
emits the logical plan tree.

Uncorrelated subqueries (scalar, IN, EXISTS) are executed eagerly through a
session-provided callback and folded into literals/sets — the reference
builds IN-sets as a pre-pass the same way (GlobalSubqueriesVisitor.h).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core import dtypes as dt
from ..core.errors import (AnalysisError, NotImplementedError_, TypeError_,
                           UnknownFunction, UnknownIdentifier, UnknownTable)
from ..core.settings import Settings
from ..exprs import aggregates as agg_reg
from ..exprs import functions as fn_reg
from ..exprs.expr import (BoundArrayLambda, BoundCall, BoundColumn,
                          BoundExpr, BoundInList, BoundLiteral)
from ..sql import ast
from . import logical as L

__all__ = ["Analyzer", "Scope"]


class Scope:
    """Resolves identifiers to plan fields."""

    def __init__(self, fields: Sequence[L.Field]):
        self.fields = list(fields)

    def resolve(self, parts: Tuple[str, ...]) -> Optional[L.Field]:
        if len(parts) == 1:
            name = parts[0]
            matches = [f for f in self.fields if f.display == name]
            if len(matches) > 1:
                visible = [f for f in matches if not f.star_hidden]
                if visible:
                    # duplicate unqualified names across join sides:
                    # leftmost wins (the reference's legacy-analyzer rule —
                    # qualified refs select the other side explicitly)
                    return visible[0]
                raise AnalysisError(f"Ambiguous column '{name}'")
            return matches[0] if matches else None
        if len(parts) >= 2:
            # dotted displays first: JSON subcolumns ("j.price.usd") are
            # single fields whose display contains dots
            dotted = ".".join(parts)
            matches = [f for f in self.fields if f.display == dotted]
            if len(matches) == 1:
                return matches[0]
            qual, name = parts[0], ".".join(parts[1:])
            matches = [f for f in self.fields
                       if f.display == name and qual in f.qualifiers]
            if len(matches) > 1:
                raise AnalysisError(f"Ambiguous column '{qual}.{name}'")
            return matches[0] if matches else None
        return None

    def __add__(self, other: "Scope") -> "Scope":
        return Scope(self.fields + other.fields)


class Analyzer:
    def __init__(self, catalog, settings: Settings,
                 subquery_executor: Optional[Callable] = None,
                 user_name: Optional[str] = None):
        self.catalog = catalog
        self.settings = settings
        self.subquery_executor = subquery_executor
        self.user_name = user_name
        self._next_id = 0

    # -- id/plumbing ---------------------------------------------------------
    def fresh_id(self) -> str:
        self._next_id += 1
        return f"#{self._next_id}"

    def field(self, display: str, dtype: dt.DType,
              qualifiers: Tuple[str, ...] = ()) -> L.Field:
        return L.Field(self.fresh_id(), display, dtype, qualifiers)

    # -- entry ---------------------------------------------------------------
    def analyze(self, stmt) -> L.PlanNode:
        if isinstance(stmt, ast.Select):
            return self.analyze_select(stmt, {})
        if isinstance(stmt, ast.Union):
            return self.analyze_union(stmt, {})
        if isinstance(stmt, ast.SetOp):
            return self.analyze_setop(stmt, {})
        raise NotImplementedError_(f"Cannot plan statement {type(stmt).__name__}")

    def _analyze_any_select(self, s, ctes) -> L.PlanNode:
        if isinstance(s, ast.Select):
            return self.analyze_select(s, dict(ctes))
        if isinstance(s, ast.SetOp):
            return self.analyze_setop(s, dict(ctes))
        return self.analyze_union(s, dict(ctes))

    def analyze_setop(self, s: ast.SetOp, ctes) -> L.PlanNode:
        left = self._analyze_any_select(s.left, ctes)
        right = self._analyze_any_select(s.right, ctes)
        if len(left.schema) != len(right.schema):
            raise AnalysisError(f"{s.op.upper()} inputs have different "
                                "column counts")
        out_fields = [self.field(f.display,
                                 _union_type([left.schema[i].dtype,
                                              right.schema[i].dtype]))
                      for i, f in enumerate(left.schema)]
        return L.SetOpNode(left, right, s.op, s.distinct, out_fields)

    def _analyze_merge_engine(self, db: str, ref, table, quals):
        """ENGINE = Merge(db, 'regex'): the union of every matching table
        (reference: src/Storages/StorageMerge.cpp).  Reads only; schema is
        the Merge table's declared schema, matched by column name."""
        import re as _re
        args = list(getattr(table, "engine_args", []) or [])
        src_db = args[0] if args else db
        if src_db in ("currentDatabase", "currentDatabase()", ""):
            src_db = db
        pattern = _re.compile(args[1] if len(args) > 1 else ".*")
        dbo = self.catalog.databases.get(src_db)
        if dbo is None:
            raise UnknownTable(f"Unknown database '{src_db}'")
        matches = sorted(
            n for n, t in dbo.tables.items()
            if pattern.fullmatch(n) and t is not table
            and t.engine != "Merge")
        if not matches:
            raise AnalysisError(
                f"Merge engine matched no tables in '{src_db}'")
        plans = []
        for name in matches:
            sub = self.catalog.get_table(src_db, name)
            fields, names = [], []
            for cname, ctype in table.schema_items():
                if cname not in sub.schema:
                    raise AnalysisError(
                        f"Merge source '{name}' lacks column '{cname}'")
                fields.append(self.field(cname, sub.schema[cname], quals))
                names.append(cname)
            scan = L.ScanNode(src_db, name, fields, names,
                              engine=sub.engine,
                              order_by_cols=tuple(sub.order_by or ()))
            # `_table` virtual column: the source table's name per row
            # (StorageMerge virtual, star-hidden like the reference)
            tf = L.Field(self.fresh_id(), "_table", dt.String, quals,
                         star_hidden=True)
            proj = L.ProjectNode(
                scan,
                [BoundColumn(f.id, f.dtype) for f in fields]
                + [BoundLiteral(name, dt.String)], fields + [tf])
            plans.append(proj)
        out_fields = [self.field(cname, ctype, quals)
                      for cname, ctype in table.schema_items()]
        out_fields.append(dataclasses.replace(
            self.field("_table", dt.String, quals), star_hidden=True))
        if len(plans) == 1:
            node = plans[0]
            return node, Scope(node.schema)
        node = L.UnionNode(plans, out_fields)
        return node, Scope(out_fields)

    def analyze_union(self, u: ast.Union, ctes) -> L.PlanNode:
        plans = [self._analyze_any_select(s, ctes) for s in u.selects]
        base = plans[0].schema
        for p in plans[1:]:
            if len(p.schema) != len(base):
                raise AnalysisError("UNION inputs have different column counts")
        out_fields = [self.field(f.display,
                                 _union_type([p.schema[i].dtype for p in plans]))
                      for i, f in enumerate(base)]
        node: L.PlanNode = L.UnionNode(plans, out_fields)
        if u.mode == "distinct":
            node = L.DistinctNode(node, out_fields)
        return node

    # -- SELECT --------------------------------------------------------------
    def analyze_select(self, sel: ast.Select, outer_ctes: Dict) -> L.PlanNode:
        # depth gates session-level limit/offset settings to the top query
        self._depth = getattr(self, "_depth", 0) + 1
        try:
            return self._analyze_select_inner(sel, outer_ctes)
        finally:
            self._depth -= 1

    def _analyze_select_inner(self, sel: ast.Select,
                              outer_ctes: Dict) -> L.PlanNode:
        ctes = dict(outer_ctes)
        scalar_aliases: Dict[str, ast.Expr] = {}
        for cte in sel.ctes:
            if cte.query is not None:
                ctes[cte.name] = cte.query
            else:
                scalar_aliases[cte.name] = cte.expr

        # expression-level aliases — `(x AS a)`, `f(e AS a)` — register
        # query-wide like select-item aliases (reference
        # ParserWithOptionalAlias semantics); the AST is copied before
        # stripping so re-analysis of a cached statement stays correct
        expr_aliases: Dict[str, ast.Expr] = {}
        _probe = [it.expr for it in sel.items
                  if not isinstance(it.expr, ast.Star)]
        _probe += [v for v in (sel.where, sel.prewhere, sel.having)
                   if v is not None]
        _probe += list(sel.group_by or [])
        _probe += [oi.expr for oi in (sel.order_by or [])]
        for v in _probe:
            _collect_aliased(v, expr_aliases)
        if expr_aliases:
            import copy as _copy
            sel = _copy.deepcopy(sel)
            for item in sel.items:
                if not isinstance(item.expr, ast.Star):
                    item.expr = _strip_aliased(item.expr)
            for attr in ("where", "prewhere", "having"):
                v = getattr(sel, attr)
                if v is not None:
                    setattr(sel, attr, _strip_aliased(v))
            if sel.group_by:
                sel.group_by = [_strip_aliased(g) for g in sel.group_by]
            for oi in (sel.order_by or []):
                oi.expr = _strip_aliased(oi.expr)
            scalar_aliases.update(expr_aliases)

        # GROUP BY (a, b) groups by the elements (tuple keys splat)
        if sel.group_by:
            gb2 = []
            for g in sel.group_by:
                if isinstance(g, ast.Tuple_):
                    gb2.extend(g.items)
                elif isinstance(g, ast.FuncCall) and g.name == "tuple":
                    gb2.extend(g.args)
                else:
                    gb2.append(g)
            sel.group_by = gb2

        # FROM clause
        if sel.from_ is None:
            dummy = self.field("dummy", dt.UInt8)
            plan: L.PlanNode = L.OneRowNode([dummy])
            scope = Scope([dummy])     # implicit FROM system.one
        else:
            plan, scope = self.analyze_table_expr(sel.from_, ctes)

        # JOINs
        for join in sel.joins:
            plan, scope = self.analyze_join(plan, scope, join, ctes,
                                            scalar_aliases)

        # select-item aliases usable in WHERE/GROUP BY/HAVING/ORDER BY
        aliases: Dict[str, ast.Expr] = dict(scalar_aliases)
        # ALIAS columns of scanned tables resolve by substitution
        # (reference: ColumnsDescription ALIAS defaults, expanded in the
        # analyzer — not stored, computed at read)
        for tref in [sel.from_] + [j.table for j in sel.joins]:
            if isinstance(tref, ast.TableRef):
                try:
                    tdb = tref.database or self.catalog.current_database
                    tobj = self.catalog.get_table(tdb, tref.table)
                except Exception:      # noqa: BLE001 — CTE/view names
                    continue
                for cn, (kind, cexpr) in (getattr(
                        tobj, "column_defaults", None) or {}).items():
                    if kind == "alias" and cexpr is not None:
                        aliases.setdefault(cn, cexpr)
                        qual = tref.alias or tref.table
                        aliases.setdefault(f"{qual}.{cn}", cexpr)
        for item in sel.items:
            if item.alias and not isinstance(item.expr, ast.Star):
                aliases[item.alias] = item.expr

        # ARRAY JOIN clause desugars to the arrayJoin() machinery below:
        # each joined array contributes an element alias; multiple arrays
        # zip through a shared arrayJoin(arrayEnumerate(first)) index;
        # LEFT keeps empty arrays via emptyArrayToSingle
        # (ref: src/Interpreters/ArrayJoinAction.cpp).
        aj_shadow: frozenset = frozenset()
        if sel.array_join is not None:
            aj_kind, aj_items_cl = sel.array_join
            arr0 = aj_items_cl[0][0]
            if len(aj_items_cl) == 1:
                src = arr0 if aj_kind == "inner" else \
                    ast.FuncCall("emptyArrayToSingle", [arr0])
                elems_cl = [ast.FuncCall("arrayJoin", [src])]
            else:
                base = ast.FuncCall("arrayEnumerate", [arr0])
                if aj_kind == "left":
                    base = ast.FuncCall("emptyArrayToSingle", [base])
                idx_e = ast.FuncCall("arrayJoin", [base])
                elems_cl = [ast.FuncCall("arrayElement", [ai, idx_e])
                            for ai, _ in aj_items_cl]
            for (ai, al), elem in zip(aj_items_cl, elems_cl):
                nm = al or (ai.name if isinstance(ai, ast.Identifier)
                            else ast.format_expr(ai))
                aliases[nm] = elem
            aj_shadow = frozenset(
                al or (ai.name if isinstance(ai, ast.Identifier)
                       else ast.format_expr(ai))
                for ai, al in aj_items_cl)

        def expand(e: ast.Expr, own: Optional[str] = None) -> ast.Expr:
            excl = frozenset({own}) if own else frozenset()
            return _expand_aliases(e, aliases, scope, exclude=excl)

        # PREWHERE/WHERE — predicates referencing an array-join element
        # must filter AFTER expansion (reference clause order: ARRAY JOIN
        # runs before WHERE)
        aj_post_preds: List[ast.Expr] = []
        for pred_ast in (sel.prewhere, sel.where):
            if pred_ast is not None:
                pe = expand(pred_ast)
                if _contains_array_join(pe):
                    aj_post_preds.append(pe)
                    continue
                pred = self.bind(pe, scope, allow_agg=False)
                plan = L.FilterNode(plan, pred, plan.schema)

        # arrayJoin(...) expands rows after WHERE, before aggregation
        # (reference: ArrayJoinAction position in the chain)
        aj_texts: Dict[str, str] = {}
        aj_exprs: List[ast.Expr] = []

        def collect_aj(e: ast.Expr):
            if isinstance(e, ast.FuncCall) and e.name == "arrayJoin" \
                    and len(e.args) == 1:
                text = ast.format_expr(e)
                if text not in aj_texts:
                    aj_texts[text] = ""
                    aj_exprs.append(e)
                return
            for c in _ast_children(e):
                collect_aj(c)

        probe_exprs = [expand(it.expr, it.alias) for it in sel.items
                       if not isinstance(it.expr, ast.Star)]
        for ge in (sel.group_by or []):
            probe_exprs.append(expand(ge))
        if sel.having is not None:
            probe_exprs.append(expand(sel.having))
        for oi in (sel.order_by or []):
            probe_exprs.append(expand(oi.expr))
        probe_exprs.extend(aj_post_preds)
        for e in probe_exprs:
            collect_aj(e)
        if len(aj_exprs) > 1:
            raise NotImplementedError_(
                "Multiple distinct arrayJoin expressions are not supported")
        if aj_exprs:
            call = aj_exprs[0]
            arr_bound = self.bind(
                _expand_aliases(call.args[0], aliases, scope,
                                exclude=aj_shadow), scope,
                allow_agg=False)
            if not arr_bound.dtype.is_array:
                raise TypeError_("arrayJoin expects an Array argument")
            placeholder = "__array_join"
            elem_f = L.Field(self.fresh_id(), placeholder,
                             dt.array_inner(arr_bound.dtype))
            plan = L.ArrayJoinNode(plan, arr_bound, elem_f,
                                   list(plan.schema) + [elem_f])
            scope = Scope(scope.fields + [elem_f])
            aj_texts[ast.format_expr(call)] = placeholder
            outer_expand = expand

            def expand(e: ast.Expr, own: Optional[str] = None):  # noqa: F811
                return _replace_by_text(outer_expand(e, own), aj_texts)

            for pe in aj_post_preds:
                pred = self.bind(_replace_by_text(pe, aj_texts), scope,
                                 allow_agg=False)
                plan = L.FilterNode(plan, pred, plan.schema)

        # Expand stars & name items
        items: List[Tuple[ast.Expr, str]] = []
        for item in sel.items:
            if isinstance(item.expr, ast.Star):
                st = item.expr
                tf = getattr(st, "transformers", None) or []
                excepts: set = set()
                applies: List[str] = []
                replaces: Dict[str, ast.Expr] = {}
                for kind_t, payload in tf:
                    if kind_t == "except":
                        excepts |= set(payload)
                    elif kind_t == "apply":
                        applies.append(payload)
                    elif kind_t == "replace":
                        replaces.update({nm: e2 for e2, nm in payload})
                cre = None
                if getattr(st, "columns_re", None):
                    import re as _re
                    cre = _re.compile(st.columns_re)
                for f in scope.fields:
                    if st.table and st.table not in f.qualifiers:
                        continue
                    if not st.table and f.star_hidden:
                        continue     # USING right key folded out of bare *
                    if f.display in excepts:
                        continue
                    if cre is not None and not cre.search(f.display):
                        continue
                    base: ast.Expr = (
                        ast.Identifier(f.display, (f.display,))
                        if not st.table else
                        ast.Identifier(f"{st.table}.{f.display}",
                                       (st.table, f.display)))
                    disp = f.display
                    if f.display in replaces:
                        base = replaces[f.display]
                    for fn in applies:
                        base = ast.FuncCall(fn, [base])
                        disp = f"{fn}({disp})"
                    items.append((base, disp, None))
            else:
                name = item.alias or ast.format_expr(item.expr)
                items.append((item.expr, name, item.alias))

        has_agg = (sel.group_by is not None
                   or any(_contains_aggregate(expand(e, own))
                          for e, _, own in items)
                   or (sel.having is not None
                       and _contains_aggregate(expand(sel.having))))

        order_items = sel.order_by or []
        if len(order_items) == 1 \
                and isinstance(order_items[0].expr, ast.Identifier) \
                and order_items[0].expr.name == "__order_all__":
            # ORDER BY ALL: every visible select column, ascending
            order_items = [ast.OrderItem(e) for e, _, _ in items]
        # ORDER BY (a, b) == ORDER BY a, b (reference: tuple sort keys are
        # flattened, src/Interpreters/sortBlock.cpp lexicographic order)
        flat = []
        for it in order_items:
            if isinstance(it.expr, ast.Tuple_) and it.fill is None:
                flat.extend(ast.OrderItem(x, it.descending, it.nulls_last)
                            for x in it.expr.items)
            else:
                flat.append(it)
        order_items = flat

        if has_agg:
            plan, scope_after, rewrite = self.plan_aggregation(
                plan, scope, sel, items, aliases, expand)
            if sel.group_by_modifier and isinstance(plan, L.AggregateNode):
                plan = self._expand_grouping_sets(plan,
                                                  sel.group_by_modifier,
                                                  sel.grouping_sets, rewrite)
            bind_post = lambda e, own=None: self.bind_post_agg(
                expand(e, own), rewrite, scope_after)
            if sel.having is not None:
                having = bind_post(sel.having)
                plan = L.FilterNode(plan, having, plan.schema)
        else:
            bind_post = lambda e, own=None: self.bind(expand(e, own), scope,
                                                      allow_agg=False)
            scope_after = scope

        # window functions (evaluated after aggregation/HAVING, before the
        # projection — the reference's WindowStep position)
        win_exprs = [expand(e, own) for e, _, own in items] \
            + [expand(oi.expr) for oi in order_items]
        if any(_contains_window(e) for e in win_exprs):
            plan, scope_after, win_map = self.plan_windows(
                plan, scope_after, win_exprs, bind_post)
            subst = lambda e: _replace_windows(e, win_map)
            if has_agg:
                bind_post = lambda e, own=None: self.bind_post_agg(
                    subst(expand(e, own)), rewrite, scope_after)
            else:
                bind_post = lambda e, own=None: self.bind(
                    subst(expand(e, own)), scope_after, allow_agg=False)
        bound_items = [(bind_post(e, own), name)
                       for e, name, own in items]

        # Projection (+ hidden sort columns)
        out_fields = [self.field(name, be.dtype) for be, name in bound_items]
        proj_exprs = [be for be, _ in bound_items]
        proj_scope_fields = list(out_fields)

        bound_order: List[L.SortItem] = []
        for oi in order_items:
            # ORDER BY may reference select aliases/outputs or source columns
            e = expand(oi.expr)
            be = None
            # 1) matches a projected item syntactically?
            key = ast.format_expr(e)
            for (bexpr, name), f in zip(bound_items, out_fields):
                if name == key or ast.format_expr(oi.expr) == name:
                    be = BoundColumn(f.id, f.dtype)
                    break
            if be is None:
                inner = bind_post(e)
                # add as hidden projection column
                hf = self.field(f"__sort_{len(proj_exprs)}", inner.dtype)
                proj_exprs.append(inner)
                proj_scope_fields.append(hf)
                be = BoundColumn(hf.id, hf.dtype)
            nl = oi.nulls_last if oi.nulls_last is not None else True
            bound_order.append(L.SortItem(be, oi.descending, nl,
                                          fill=self._bind_fill(oi)))

        # LIMIT BY keys: a projected column, else a hidden projection column
        # as ORDER BY's (the reference binds such a key below the
        # projection, whose block no longer holds its columns)
        limit_by_keys = None
        if sel.limit_by is not None:
            limit_by_keys = []
            for raw in sel.limit_by[1]:
                inner = bind_post(expand(raw))
                key = ast.format_expr(raw)
                matched = None
                for (bexpr, name), f in zip(bound_items, out_fields):
                    if name == key:
                        matched = BoundColumn(f.id, f.dtype)
                        break
                if matched is None:
                    hf = self.field(f"__limit_by_{len(proj_exprs)}",
                                    inner.dtype)
                    proj_exprs.append(inner)
                    proj_scope_fields.append(hf)
                    matched = BoundColumn(hf.id, hf.dtype)
                limit_by_keys.append(matched)

        plan = L.ProjectNode(plan, proj_exprs, proj_scope_fields)

        if sel.distinct:
            # DISTINCT applies to the visible columns only
            plan = L.DistinctNode(plan, plan.schema)

        limit_val = _const_int(sel.limit) if sel.limit is not None else None
        offset_val = _const_int(sel.offset) if sel.offset is not None else 0
        # `limit` / `offset` SETTINGS wrap OUTSIDE the query's own LIMIT
        # clause (src/Core/Settings.cpp limit, offset).  A subquery-level
        # SETTINGS clause scopes to that subquery; session/query settings
        # apply to the top-level query only.
        own = getattr(sel, "settings", None) or {}
        if "limit" in own or "offset" in own:
            s_lim = int(own.get("limit", 0) or 0)
            s_off = int(own.get("offset", 0) or 0)
        elif getattr(self, "_depth", 1) == 1:
            s_lim = int(getattr(self.settings, "limit", 0) or 0)
            s_off = int(getattr(self.settings, "offset", 0) or 0)
        else:
            s_lim = s_off = 0
        if s_lim > 0 or s_off > 0:
            if limit_val is not None:
                inner = max(limit_val - s_off, 0)
                limit_val = min(s_lim, inner) if s_lim > 0 else inner
            elif s_lim > 0:
                limit_val = s_lim
            offset_val += s_off

        if bound_order:
            hint = None
            if limit_val is not None and sel.limit_by is None:
                hint = limit_val + offset_val
            plan = L.SortNode(plan, bound_order, plan.schema, limit_hint=hint)

        if limit_by_keys is not None:
            n = _const_int(sel.limit_by[0])
            plan = L.LimitByNode(plan, n, 0, limit_by_keys, plan.schema)

        if limit_val is not None or offset_val:
            plan = L.LimitNode(plan, limit_val if limit_val is not None else -1,
                               offset_val, plan.schema)

        # Final projection: visible columns only
        if len(proj_scope_fields) != len(out_fields):
            plan = L.ProjectNode(
                plan,
                [BoundColumn(f.id, f.dtype) for f in out_fields],
                out_fields)
        return plan

    # -- FROM / JOIN ---------------------------------------------------------
    def analyze_table_expr(self, ref, ctes) -> Tuple[L.PlanNode, Scope]:
        if isinstance(ref, ast.SubqueryRef):
            sub = (self.analyze_select(ref.query, ctes)
                   if isinstance(ref.query, ast.Select)
                   else self.analyze_union(ref.query, ctes))
            quals = (ref.alias,) if ref.alias else ()
            fields = [L.Field(f.id, f.display, f.dtype, quals)
                      for f in sub.schema]
            sub.schema = fields
            return sub, Scope(fields)
        if isinstance(ref, ast.TableFunctionRef):
            return self.analyze_table_function(ref)
        assert isinstance(ref, ast.TableRef)
        if ref.table in ctes:
            q = ctes[ref.table]
            sub = (self.analyze_select(q, {k: v for k, v in ctes.items()
                                           if k != ref.table})
                   if isinstance(q, ast.Select) else self.analyze_union(q, {}))
            quals = (ref.alias or ref.table,)
            fields = [L.Field(f.id, f.display, f.dtype, quals)
                      for f in sub.schema]
            sub.schema = fields
            return sub, Scope(fields)
        db = ref.database or self.catalog.current_database
        if db == "system" and ref.table in ("numbers", "numbers_mt"):
            # virtual sequence source; statically capped (static shapes) —
            # queries take LIMIT n below system_numbers_limit
            quals = (ref.alias or ref.table, "numbers")
            f = L.Field(self.fresh_id(), "number", dt.UInt64, quals)
            return L.NumbersNode([f], 0,
                                 self.settings.system_numbers_limit), \
                Scope([f])
        if db == "system" and ref.table in ("zeros", "zeros_mt"):
            quals = (ref.alias or ref.table, "zeros")
            nf = L.Field(self.fresh_id(), "number", dt.UInt64, quals)
            node = L.NumbersNode([nf], 0,
                                 self.settings.system_numbers_limit)
            f = L.Field(self.fresh_id(), "zero", dt.UInt8, quals)
            zero_e = BoundCall("_cast", [BoundCall(
                "multiply", [BoundColumn(nf.id, nf.dtype),
                             BoundLiteral(0, dt.UInt64)], dt.UInt64)],
                dt.UInt8)
            return L.ProjectNode(node, [zero_e], [f]), Scope([f])
        view = self.catalog.get_view(db, ref.table) \
            if hasattr(self.catalog, "get_view") else None
        if view is not None and not view.materialized:
            sub = (self.analyze_select(view.query, dict(ctes))
                   if isinstance(view.query, ast.Select)
                   else self.analyze_union(view.query, dict(ctes)))
            quals = (ref.alias or ref.table,)
            fields = [L.Field(f.id, f.display, f.dtype, quals)
                      for f in sub.schema]
            sub.schema = fields
            return sub, Scope(fields)
        if view is not None and view.materialized \
                and getattr(view, "to_table", None) \
                and self.catalog.has_table(db, view.to_table):
            # reading a materialized view reads its target storage
            # (StorageMaterializedView::read delegates to the target)
            ref = dataclasses.replace(ref, table=view.to_table,
                                      alias=ref.alias or ref.table)
        table = self.catalog.get_table(db, ref.table)
        quals = (ref.alias,) if ref.alias else (ref.table,)
        if table.engine == "Merge":
            return self._analyze_merge_engine(db, ref, table, quals)
        fields = []
        names = []
        stats = {}
        coldefs = getattr(table, "column_defaults", None) or {}
        for name, ctype in table.schema_items():
            f = self.field(name, ctype, quals)
            if coldefs.get(name, ("",))[0] == "materialized":
                # MATERIALIZED columns are stored but folded out of `*`
                # (reference: ColumnsDescription::getOrdinary)
                f = dataclasses.replace(f, star_hidden=True)
            fields.append(f)
            names.append(name)
            b = table.column_bounds(name)
            if b is not None:
                stats[f.id] = b
            if getattr(ctype, "is_json", False):
                # shredded JSON subcolumns are ordinary scan fields named
                # "<col>.<path>" (ColumnObject typed-path analog); the
                # device block materializes them (table._build_device_block)
                for path, pdt in table.json_paths(name).items():
                    fields.append(self.field(f"{name}.{path}", pdt, quals))
                    names.append(f"{name}.{path}")
            if getattr(ctype, "variant_types", None) is not None:
                # Variant/Dynamic discriminator + per-type subcolumns
                # (ColumnVariant analog; variantType/variantElement bind
                # to these fields)
                for sub, sdt in table.variant_subcols(name).items():
                    fields.append(dataclasses.replace(
                        self.field(f"{name}.{sub}", sdt, quals),
                        star_hidden=True))
                    names.append(f"{name}.{sub}")
        if getattr(ref, "sample", None) is not None \
                and getattr(table, "sample_by", None) is None:
            raise AnalysisError(
                f"Table {ref.table} does not support sampling "
                f"(no SAMPLE BY in its definition)")
        node = L.ScanNode(db, ref.table, fields, names, final=ref.final,
                          column_stats=stats or None,
                          engine=table.engine,
                          order_by_cols=tuple(table.order_by or ()),
                          engine_args=tuple(
                              a for a in (getattr(table, "engine_args", [])
                                          or [])
                              if isinstance(a, str) and a in table.schema))
        scope = Scope(fields)
        plan: L.PlanNode = node
        if getattr(ref, "sample", None) is not None:
            # SAMPLE ratio: deterministic subset by the declared sampling
            # key — intHash64(key) % M < ratio*M above the scan (the
            # reference reads a prefix of the sampling-key range,
            # MergeTreeDataSelectExecutor::sampling; hash-threshold here)
            ratio = float(ref.sample)
            if not (0.0 < ratio <= 1.0):
                raise AnalysisError("SAMPLE ratio must be in (0, 1]")
            if ratio < 1.0:
                m = 1_000_003
                pred_ast = ast.FuncCall("less", [
                    ast.FuncCall("modulo", [
                        ast.FuncCall("intHash64", [table.sample_by]),
                        ast.Literal(m)]),
                    ast.Literal(int(ratio * m))])
                pred = self.bind(pred_ast, scope, allow_agg=False)
                plan = L.FilterNode(plan, pred, plan.schema)
        # row policies: inject the USING predicate above the scan for
        # matching users (reference: RowPolicyFilter in the analyzer,
        # src/Access/EnabledRowPolicies.h)
        access = getattr(self.catalog, "access", None)
        if access is not None and self.user_name is not None:
            for pol in access.policies_for(self.user_name, db, ref.table):
                from ..sql.parser import parse_expression
                pred = self.bind(parse_expression(pol.using_text), scope,
                                 allow_agg=False)
                plan = L.FilterNode(plan, pred, plan.schema)
        return plan, scope

    def _analyze_values(self, fc: ast.FuncCall, quals
                        ) -> Tuple[L.PlanNode, Scope]:
        """values() table function: literal rows become a union of one-row
        projections (reference: src/TableFunctions/TableFunctionValues.cpp).
        Forms: values((1,'x'),(2,'y')) with inferred c1..cN columns, or
        values('a Int64, b String', (1,'x'), ...) with a declared schema."""
        args = list(fc.args)
        declared = None
        if args and isinstance(args[0], ast.Literal) \
                and isinstance(args[0].value, str):
            declared = _parse_structure(str(args[0].value))
            if declared is not None:
                args = args[1:]
        rows: List[List[ast.Expr]] = []
        for a in args:
            if isinstance(a, ast.Tuple_):
                rows.append(list(a.items))
            elif isinstance(a, ast.FuncCall) and a.name.lower() == "tuple":
                rows.append(list(a.args))
            else:
                rows.append([a])
        if not rows:
            raise AnalysisError("values() needs at least one row")
        ncol = len(rows[0])
        if any(len(r) != ncol for r in rows):
            raise AnalysisError("values() rows differ in arity")
        empty = Scope([])
        bound_rows = [[self.bind(c, empty, allow_agg=False) for c in r]
                      for r in rows]
        if declared is not None:
            if len(declared) != ncol:
                raise AnalysisError(
                    "values() structure does not match the row arity")
            cols = declared
        else:
            cols = []
            for j in range(ncol):
                t = bound_rows[0][j].dtype
                for r in bound_rows[1:]:
                    t = dt.common_supertype(t, r[j].dtype)
                cols.append((f"c{j + 1}", t))
        out_fields = [self.field(nm, t, quals) for nm, t in cols]
        branches: List[L.PlanNode] = []
        for r in bound_rows:
            one = L.OneRowNode([self.field("dummy", dt.UInt8)])
            fs = [self.field(nm, be.dtype)
                  for (nm, _), be in zip(cols, r)]
            branches.append(L.ProjectNode(one, list(r), fs))
        if len(branches) == 1:
            node: L.PlanNode = L.ProjectNode(
                branches[0],
                [BoundColumn(f.id, f.dtype) for f in branches[0].schema],
                out_fields)
        else:
            node = L.UnionNode(branches, out_fields)
        return node, Scope(out_fields)

    def _const_int_eval(self, e) -> int:
        """Constant integer from a literal OR any column-free expression —
        numbers(intExp2(9)) evaluates eagerly at bind time (the reference
        folds table-function arguments the same way)."""
        try:
            return _const_int(e)
        except AnalysisError:
            pass
        try:
            be = self.bind(e, Scope([]), allow_agg=False)
            if _bound_has_columns(be):
                raise ValueError("non-constant")
            from ..exprs.expr import evaluate
            cv = evaluate(be, {})
            return int(cv.data.item())
        except Exception:
            raise AnalysisError("Expected a constant integer")

    def analyze_table_function(self, ref: ast.TableFunctionRef
                               ) -> Tuple[L.PlanNode, Scope]:
        fc = ref.func
        name = fc.name.lower()
        quals = (ref.alias,) if ref.alias else (fc.name,)
        if name in ("numbers", "numbers_mt"):
            args = [self._const_int_eval(a) for a in fc.args]
            count_arg = args[0] if len(args) == 1 else \
                (args[1] if len(args) == 2 else None)
            if count_arg is not None and count_arg > (1 << 31):
                raise AnalysisError(
                    "numbers() count exceeds the static-shape source limit "
                    "(2^31 rows)")
            if len(args) == 1:
                start, count = 0, args[0]
            elif len(args) == 2:
                start, count = args
            else:
                raise AnalysisError("numbers() takes 1 or 2 arguments")
            f = L.Field(self.fresh_id(), "number", dt.UInt64, quals)
            return L.NumbersNode([f], start, count), Scope([f])
        if name == "one":
            f = L.Field(self.fresh_id(), "dummy", dt.UInt8, quals)
            return L.OneRowNode([f]), Scope([f])
        if name in ("zeros", "zeros_mt", "null"):
            # zeros(n): n rows of UInt8 zero; null('structure') swallows
            # writes and reads empty — served as a zero-row numbers source
            count = self._const_int_eval(fc.args[0]) if fc.args \
                and name != "null" else 0
            nf = L.Field(self.fresh_id(), "number", dt.UInt64, quals)
            node = L.NumbersNode([nf], 0, count)
            f = L.Field(self.fresh_id(), "zero", dt.UInt8, quals)
            zero_e = BoundCall("_cast", [BoundCall(
                "multiply", [BoundColumn(nf.id, nf.dtype),
                             BoundLiteral(0, dt.UInt64)], dt.UInt64)],
                dt.UInt8)
            proj = L.ProjectNode(node, [zero_e], [f])
            return proj, Scope([f])
        if name == "merge":
            # merge('db', 'regex') / merge(regex): union of matching
            # tables (ref: src/TableFunctions/TableFunctionMerge.cpp)
            lits = []
            for a in fc.args:
                if isinstance(a, ast.Literal):
                    lits.append(str(a.value))
                elif isinstance(a, ast.Identifier):
                    lits.append(a.name)
                elif isinstance(a, ast.FuncCall) \
                        and a.name == "currentDatabase":
                    lits.append(self.catalog.current_database)
            if len(lits) >= 2:
                src_db, rx = lits[0], lits[1]
            elif len(lits) == 1:
                src_db, rx = self.catalog.current_database, lits[0]
            else:
                raise AnalysisError("merge() expects (db, 'regex')")
            import re as _re2
            dbo = self.catalog.databases.get(src_db)
            if dbo is None:
                raise UnknownTable(f"Unknown database '{src_db}'")
            pat = _re2.compile(rx)
            first = next((t for n, t in sorted(dbo.tables.items())
                          if pat.fullmatch(n) and t.engine != "Merge"),
                         None)
            if first is None:
                raise AnalysisError(
                    f"merge() matched no tables in '{src_db}'")

            class _Shim:
                engine_args = [src_db, rx]
                schema_items = first.schema_items
            return self._analyze_merge_engine(src_db, ref, _Shim(), quals)
        if name == "values":
            return self._analyze_values(fc, quals)
        if name == "file":
            if not fc.args or not isinstance(fc.args[0], ast.Literal):
                raise AnalysisError("file() expects a constant path")
            path = str(fc.args[0].value)
            fmt = str(fc.args[1].value) if len(fc.args) > 1 \
                and isinstance(fc.args[1], ast.Literal) else None
            table = self.catalog.file_table(
                path, fmt, files_root=self.settings.user_files_path)
            fields, names = [], []
            for cname, ctype in table.schema_items():
                fields.append(self.field(cname, ctype, quals))
                names.append(cname)
            node = L.ScanNode("_files", table.name, fields, names)
            return node, Scope(fields)
        if name == "format":
            # format('Fmt'[, 'structure'], 'data') — inline data literal
            # (ref: src/TableFunctions/TableFunctionFormat.cpp)
            lits = [a.value for a in fc.args if isinstance(a, ast.Literal)]
            if len(lits) < 2:
                raise AnalysisError("format() expects constant arguments")
            fmt = str(lits[0])
            if len(lits) >= 3:
                schema = _parse_structure(str(lits[1]))
                text = str(lits[2])
            else:
                schema, text = None, str(lits[1])
            table = self.catalog.inline_format_table(fmt, text, schema)
            fields, names = [], []
            for cname, ctype in table.schema_items():
                fields.append(self.field(cname, ctype, quals))
                names.append(cname)
            node = L.ScanNode("_files", table.name, fields, names)
            return node, Scope(fields)
        if name == "generaterandom":
            if not fc.args or not isinstance(fc.args[0], ast.Literal):
                raise AnalysisError(
                    "generateRandom() expects a constant structure")
            schema = _parse_structure(str(fc.args[0].value))
            if schema is None:
                raise AnalysisError(
                    "generateRandom(): bad structure string")
            extra = [int(a.value) for a in fc.args[1:4]
                     if isinstance(a, ast.Literal) and a.value is not None]
            table = self.catalog.generate_random_table(schema, *extra)
            fields, names = [], []
            for cname, ctype in table.schema_items():
                fields.append(self.field(cname, ctype, quals))
                names.append(cname)
            node = L.ScanNode("_files", table.name, fields, names)
            return node, Scope(fields)
        if name in ("remote", "remotesecure", "cluster", "clusterallreplicas"):
            # remote('host:port', db.table | 'db', 'table' [, user, pwd]):
            # pull the table over the native TCP wire (the legacy
            # whole-table path for shapes the pushdown rewriter in
            # parallel/remote_query.py does not handle — joins, subqueries;
            # ref src/TableFunctions/TableFunctionRemote.cpp)
            from ..parallel.remote_query import (loopback_local_source,
                                                 loopback_shards,
                                                 parse_remote_args)
            if len(fc.args) >= 2 and isinstance(fc.args[0], ast.Literal) \
                    and isinstance(fc.args[1], ast.FuncCall) \
                    and fc.args[1].name.lower() not in (
                        "dot", "currentdatabase", "concat", "tostring"):
                # remote(addr, numbers(10)) — table-function target: on
                # loopback shards analyze the inner function locally
                nsh = loopback_shards(self.catalog, str(fc.args[0].value))
                if nsh is not None:
                    inner_ref = ast.TableFunctionRef(fc.args[1], ref.alias)
                    if nsh == 1:
                        return self.analyze_table_expr(inner_ref, {})
                    sub = ast.SubqueryRef(ast.Union(
                        [ast.Select(items=[ast.SelectItem(ast.Star())],
                                    from_=ast.TableFunctionRef(fc.args[1]))
                         for _ in range(nsh)], mode="all"), ref.alias)
                    return self.analyze_table_expr(sub, {})
            addr, target, creds = parse_remote_args(
                fc, self.catalog.current_database)
            src = loopback_local_source(self.catalog, addr, target,
                                        ref.alias)
            if src is not None:
                # loopback with no live server: the local catalog IS the
                # remote (N shards = N local reads)
                return self.analyze_table_expr(src, {})
            table = self.catalog.remote_table(addr, target, *creds)
            fields, names = [], []
            for cname, ctype in table.schema_items():
                fields.append(self.field(cname, ctype, quals))
                names.append(cname)
            node = L.ScanNode("_files", table.name, fields, names)
            return node, Scope(fields)
        raise UnknownTable(f"Unknown table function '{fc.name}'")

    def analyze_join(self, left: L.PlanNode, lscope: Scope, join: ast.Join,
                     ctes, scalar_aliases) -> Tuple[L.PlanNode, Scope]:
        right, rscope = self.analyze_table_expr(join.table, ctes)
        if join.strictness == "asof":
            return self._analyze_asof_join(left, lscope, right, rscope, join,
                                           scalar_aliases)

        left_keys: List[BoundExpr] = []
        right_keys: List[BoundExpr] = []
        residual: Optional[BoundExpr] = None
        out_fields = list(left.schema)

        if join.kind == "cross":
            out_fields += list(right.schema)
            node = L.JoinNode(left, right, "cross", "all", [], [], None,
                              out_fields, join.is_global)
            return node, Scope(out_fields)

        if join.using:
            for name in join.using:
                lf = lscope.resolve((name,))
                rf = rscope.resolve((name,))
                if lf is None or rf is None:
                    raise UnknownIdentifier(f"USING column '{name}' missing")
                left_keys.append(BoundColumn(lf.id, lf.dtype))
                right_keys.append(BoundColumn(rf.id, rf.dtype))
            using = set(join.using)
            out_fields += [f if f.display not in using
                           else dataclasses.replace(f, star_hidden=True)
                           for f in right.schema]
        elif join.on is not None:
            both = lscope + rscope
            conjuncts = _split_conjuncts(join.on)
            extra = []
            for c in conjuncts:
                pair = self._try_equi_pair(c, lscope, rscope, scalar_aliases)
                if pair is not None:
                    left_keys.append(pair[0])
                    right_keys.append(pair[1])
                else:
                    extra.append(c)
            if not left_keys:
                if join.kind == "inner":
                    # no equi-keys (constant or inequality-only ON): run a
                    # cross join filtered by the ON predicate (the
                    # reference's grace-hash fallback for non-equi inner
                    # joins, src/Planner/PlannerJoins.cpp)
                    out_fields += list(right.schema)
                    node = L.JoinNode(left, right, "cross", "all", [], [],
                                      None, out_fields, join.is_global)
                    pred = self.bind(join.on, Scope(out_fields),
                                     allow_agg=False)
                    node = L.FilterNode(node, pred, out_fields)
                    return node, Scope(out_fields)
                raise AnalysisError("JOIN ON requires at least one equality "
                                    "between left and right columns")
            if extra:
                combined = extra[0]
                for c in extra[1:]:
                    combined = ast.FuncCall("and", [combined, c])
                residual = self.bind(combined, both, allow_agg=False)
            out_fields += list(right.schema)
        else:
            raise AnalysisError("JOIN requires ON or USING")

        kind = join.kind
        strict = join.strictness
        if strict in ("semi", "anti"):
            out_fields = list(left.schema)
            node = L.JoinNode(left, right, kind, strict, left_keys,
                              right_keys, residual, out_fields,
                              join.is_global)
            return node, Scope(out_fields)

        if kind == "right":
            # RIGHT JOIN = LEFT JOIN with swapped sides; the schema keeps the
            # user-facing orientation (field ids are side-agnostic)
            node = L.JoinNode(right, left, "left", strict, right_keys,
                              left_keys, residual, out_fields,
                              join.is_global)
            return node, Scope(out_fields)

        if kind == "full":
            # FULL JOIN = LEFT JOIN  UNION ALL  (right ANTI left) padded with
            # left-side defaults (the reference composes NotJoined rows the
            # same way, HashJoin::getNonJoinedBlocks)
            import copy
            inner_left = L.JoinNode(left, right, "left", strict, left_keys,
                                    right_keys, residual, out_fields,
                                    join.is_global)
            # the anti branch needs its own copies: plan nodes are mutated by
            # the optimizer (column pruning), so subtrees must not be shared
            anti = L.JoinNode(copy.deepcopy(right), copy.deepcopy(left),
                              "left", "anti", right_keys, left_keys, None,
                              list(right.schema), join.is_global)
            proj_exprs: List[BoundExpr] = []
            proj_fields: List[L.Field] = []
            right_ids = {f.id for f in right.schema}
            # USING keys in right-only rows carry the RIGHT key value
            # (reference: the non-joined block keeps its own keys)
            using_right = {}
            if join.using:
                for name in join.using:
                    rf_ = rscope.resolve((name,))
                    if rf_ is not None:
                        using_right[name] = rf_
            for f in out_fields:
                nf = L.Field(self.fresh_id(), f.display, f.dtype,
                             f.qualifiers, star_hidden=f.star_hidden)
                proj_fields.append(nf)
                if f.id in right_ids:
                    proj_exprs.append(BoundColumn(f.id, f.dtype))
                elif f.display in using_right \
                        and not f.star_hidden:
                    rf_ = using_right[f.display]
                    proj_exprs.append(BoundColumn(rf_.id, rf_.dtype))
                else:
                    proj_exprs.append(_default_literal(f.dtype))
            padded = L.ProjectNode(anti, proj_exprs, proj_fields)
            union_fields = [dataclasses.replace(
                self.field(f.display, f.dtype, f.qualifiers),
                star_hidden=f.star_hidden) for f in out_fields]
            node = L.UnionNode([inner_left, padded], union_fields)
            # map original field ids to the union outputs for upper scopes
            return node, Scope(union_fields)

        node = L.JoinNode(left, right, kind, strict, left_keys, right_keys,
                          residual, out_fields, join.is_global)
        node.build_unique = self._build_unique_stat(right, right_keys)
        return node, Scope(out_fields)

    def _analyze_asof_join(self, left, lscope, right, rscope,
                           join: ast.Join, scalar_aliases):
        """ASOF JOIN: equalities + exactly one inequality (the asof pair).
        Reference semantics: src/Interpreters/HashJoin/HashJoin.h:110 ASOF
        strictness — match the closest build row on the inequality column."""
        if join.kind not in ("inner", "left"):
            raise AnalysisError("ASOF JOIN supports INNER/LEFT only")
        if join.on is None:
            raise AnalysisError("ASOF JOIN requires ON with an inequality")
        left_keys: List[BoundExpr] = []
        right_keys: List[BoundExpr] = []
        asof = None
        for c in _split_conjuncts(join.on):
            pair = self._try_equi_pair(c, lscope, rscope, scalar_aliases)
            if pair is not None:
                left_keys.append(pair[0])
                right_keys.append(pair[1])
                continue
            ineq = self._try_ineq_pair(c, lscope, rscope, scalar_aliases)
            if ineq is None:
                raise AnalysisError("ASOF JOIN ON supports only equalities "
                                    "plus one inequality")
            if asof is not None:
                raise AnalysisError("ASOF JOIN needs exactly one inequality")
            asof = ineq
        if asof is None:
            raise AnalysisError("ASOF JOIN requires an inequality in ON")
        if not left_keys:
            raise AnalysisError("ASOF JOIN requires at least one equality")
        out_fields = list(left.schema) + list(right.schema)
        node = L.JoinNode(left, right, join.kind, "asof", left_keys,
                          right_keys, None, out_fields, join.is_global,
                          asof_left=asof[0], asof_right=asof[1],
                          asof_op=asof[2])
        return node, Scope(out_fields)

    _INEQ_OPS = {"less": "<", "lessOrEquals": "<=",
                 "greater": ">", "greaterOrEquals": ">="}
    _INEQ_SWAP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}

    def _try_ineq_pair(self, c: ast.Expr, lscope: Scope, rscope: Scope,
                       scalar_aliases):
        """-> (left_expr, right_expr, op) with op oriented left OP right."""
        if not (isinstance(c, ast.FuncCall) and c.name in self._INEQ_OPS
                and len(c.args) == 2):
            return None
        op = self._INEQ_OPS[c.name]
        a, b = c.args
        for first, second, cur_op in ((a, b, op),
                                      (b, a, self._INEQ_SWAP[op])):
            try:
                le = self.bind(_expand_aliases(first, scalar_aliases, lscope),
                               lscope, allow_agg=False)
                re_ = self.bind(_expand_aliases(second, scalar_aliases,
                                                rscope),
                                rscope, allow_agg=False)
            except (UnknownIdentifier, AnalysisError):
                continue
            return (le, re_, cur_op)
        return None

    def _build_unique_stat(self, right_node, right_keys) -> bool:
        """True iff the build side's join keys are provably unique (N:1
        propagate-join eligibility; see storage/table.py column_unique)."""
        node = right_node
        while isinstance(node, (L.FilterNode,)):
            node = node.child
        if not isinstance(node, L.ScanNode):
            return False
        field_to_col = {f.id: n for f, n in zip(node.schema,
                                                node.column_names)}
        try:
            table = self.catalog.get_table(node.database, node.table)
        except Exception:
            return False
        for k in right_keys:
            if isinstance(k, BoundColumn) and k.name in field_to_col:
                try:
                    if table.column_unique(field_to_col[k.name]):
                        return True
                except Exception:
                    return False
        return False

    def _try_equi_pair(self, c: ast.Expr, lscope: Scope, rscope: Scope,
                       scalar_aliases):
        if not (isinstance(c, ast.FuncCall) and c.name == "equals"
                and len(c.args) == 2):
            return None
        a, b = c.args
        for first, second, swap in ((a, b, False), (b, a, True)):
            try:
                le = self.bind(_expand_aliases(first, scalar_aliases, lscope),
                               lscope, allow_agg=False)
            except (UnknownIdentifier, AnalysisError):
                continue
            try:
                re_ = self.bind(_expand_aliases(second, scalar_aliases, rscope),
                                rscope, allow_agg=False)
            except (UnknownIdentifier, AnalysisError):
                continue
            return (le, re_)
        return None

    # -- aggregation ---------------------------------------------------------
    def plan_aggregation(self, plan: L.PlanNode, scope: Scope, sel: ast.Select,
                         items, aliases, expand=None):
        if expand is None:
            expand = lambda e: _expand_aliases(e, aliases, scope)
        key_fields: List[Tuple[L.Field, BoundExpr]] = []
        key_by_text: Dict[str, L.Field] = {}
        key_by_bound: Dict[str, L.Field] = {}
        group_exprs = sel.group_by or []
        for ge in group_exprs:
            ge2 = expand(ge)
            be = self.bind(ge2, scope, allow_agg=False)
            text = ast.format_expr(ge2)
            f = self.field(ast.format_expr(ge), be.dtype)
            key_fields.append((f, be))
            key_by_text[text] = f
            key_by_bound[_bound_repr(be)] = f

        # collect aggregate calls from select items / having / order by
        agg_items: List[L.AggregateItem] = []
        agg_by_text: Dict[str, L.Field] = {}

        def collect(e: ast.Expr):
            if isinstance(e, ast.FuncCall) and self._is_aggregate_call(e):
                text = ast.format_expr(e)
                if text in agg_by_text:
                    return
                item = self._bind_aggregate(e, scope)
                agg_by_text[text] = item.field
                agg_items.append(item)
                return
            for ch in _ast_children(e):
                collect(ch)

        for e, _, own in items:
            collect(expand(e, own))
        if sel.having is not None:
            collect(expand(sel.having))
        for oi in (sel.order_by or []):
            collect(expand(oi.expr))

        schema = [f for f, _ in key_fields] + [a.field for a in agg_items]
        node = L.AggregateNode(plan, key_fields, agg_items, schema,
                               with_totals=sel.group_by_with_totals)
        rewrite = {"keys": key_by_text, "aggs": agg_by_text,
                   "keys_bound": key_by_bound, "pre_scope": scope}
        return node, Scope(schema), rewrite

    # -- window functions ----------------------------------------------------
    _WINDOW_FNS = {
        "row_number": dt.UInt64, "rank": dt.UInt64, "dense_rank": dt.UInt64,
        "count": dt.UInt64, "avg": dt.Float64,
        # None -> derived from the argument
        "sum": None, "min": None, "max": None, "any": None,
        "lag": None, "lead": None, "first_value": None, "last_value": None,
    }
    _WINDOW_ALIASES = {"laginframe": "lag", "leadinframe": "lead",
                       "rownumber": "row_number", "denserank": "dense_rank",
                       "anylast": "any"}

    def plan_windows(self, plan: L.PlanNode, scope_after: Scope,
                     exprs: List[ast.Expr], binder):
        """Collect window calls, build the WindowNode, return substitution
        map text(call) -> placeholder identifier name."""
        win_items: List[L.WindowItem] = []
        win_map: Dict[str, str] = {}
        fields: List[L.Field] = []

        def collect(e: ast.Expr):
            if isinstance(e, ast.FuncCall) and e.over is not None:
                text = ast.format_expr(e)
                if text in win_map:
                    return
                item = self._bind_window(e, binder, text)
                placeholder = f"__win{len(win_items)}"
                win_map[text] = placeholder
                f = L.Field(item.field.id, placeholder, item.field.dtype)
                item.field = f
                win_items.append(item)
                fields.append(f)
                return
            for c in _ast_children(e):
                collect(c)

        for e in exprs:
            collect(e)
        schema = list(plan.schema) + fields
        node = L.WindowNode(plan, win_items, schema)
        return node, Scope(scope_after.fields + fields), win_map

    def _bind_window(self, e: ast.FuncCall, binder, text: str) -> L.WindowItem:
        name = e.name.lower()
        name = self._WINDOW_ALIASES.get(name, name)
        if name not in self._WINDOW_FNS:
            raise NotImplementedError_(
                f"Window function '{e.name}' is not supported")
        args = [binder(a) for a in e.args]
        shift = 1
        if name in ("lag", "lead"):
            if len(args) >= 2:
                shift = _const_int(e.args[1])
                args = args[:1]
        part = [binder(p) for p in (e.over.partition_by or [])]
        order = []
        for oi in (e.over.order_by or []):
            nl = oi.nulls_last if oi.nulls_last is not None else True
            order.append(L.SortItem(binder(oi.expr), oi.descending, nl))
        out_t = self._WINDOW_FNS[name]
        if out_t is None:
            base = args[0].dtype if args else dt.UInt64
            if name == "sum":
                t0 = dt.remove_nullable(base)
                out_t = dt.Float64 if dt.is_float(t0) else (
                    dt.UInt64 if t0.np_dtype.kind == "u" else dt.Int64)
            elif name in ("lag", "lead"):
                out_t = dt.make_nullable(base)
            else:
                out_t = base
        field = self.field(text, out_t)
        frame = e.over.frame or ("running" if order else "full")
        return L.WindowItem(field=field, fn=name, args=args,
                            partition_by=part, order_by=order, frame=frame,
                            shift=shift)

    def _is_aggregate_call(self, e: ast.FuncCall) -> bool:
        # Aggregate and scalar namespaces are disjoint in our registry (the
        # reference resolves aggregates first too, executeQuery.cpp path).
        # `sum(x) OVER (...)` is a window call, not an aggregate.
        return e.over is None and agg_reg.is_aggregate_name(e.name)

    def _bind_aggregate(self, e: ast.FuncCall, scope: Scope) -> L.AggregateItem:
        name = e.name
        args_ast = list(e.args)
        if name.lower() == "count" and e.distinct:
            name = "uniqExact"
        elif name.lower() == "count" and args_ast \
                and isinstance(args_ast[0], ast.Star):
            args_ast = []
        elif e.distinct:
            if name.lower() not in ("uniq", "uniqexact"):
                raise NotImplementedError_(
                    f"DISTINCT inside {name} is not supported yet")
            name = "uniqExact"
        bound_args = [self.bind(a, scope, allow_agg=False) for a in args_ast]
        params = None
        if e.params:
            params = []
            for p in e.params:
                if not isinstance(p, ast.Literal):
                    raise AnalysisError("Aggregate parameters must be literals")
                params.append(p.value)
        arg_types = [a.dtype for a in bound_args]
        fn, has_if = agg_reg.get_aggregate(name, arg_types, params)
        cond = None
        if has_if:
            cond = bound_args[-1]
            bound_args = bound_args[:-1]
        field = self.field(ast.format_expr(e), fn.result_type())
        return L.AggregateItem(field, fn, bound_args, cond)

    def _expand_grouping_sets(self, agg: L.AggregateNode, modifier: str,
                              sets: Optional[List[List[ast.Expr]]] = None,
                              rewrite: Optional[dict] = None) -> L.PlanNode:
        """ROLLUP/CUBE/GROUPING SETS: union of aggregations over key
        subsets, each padded to the full key list with default values
        (reference: RollupTransform/CubeTransform re-aggregate the full
        result; here each set re-aggregates the input — simpler and
        parallel).  Every branch also emits a constant __grouping_mask
        (bit i set ⟺ key i absent from the set) feeding grouping()
        (src/Functions/grouping.h)."""
        import copy
        import itertools
        n = len(agg.keys)
        displays = [kf.display for kf, _ in agg.keys]
        full = tuple(range(n))
        if modifier == "rollup":
            subsets = [full] + [tuple(range(k))
                                for k in range(n - 1, -1, -1)]
        elif modifier == "cube":
            subsets = [full] + [s for r in range(n - 1, -1, -1)
                                for s in itertools.combinations(range(n), r)]
        else:                                   # explicit GROUPING SETS
            subsets = []
            for st in sets or []:
                idx = []
                for e in st:
                    t = ast.format_expr(e)
                    if t not in displays:
                        raise AnalysisError(
                            f"GROUPING SETS expression '{t}' did not bind "
                            "to a grouping key")
                    i = displays.index(t)
                    if i not in idx:
                        idx.append(i)
                subsets.append(tuple(sorted(idx)))
        mask_field = self.field("__grouping_mask", dt.UInt64)
        if rewrite is not None:
            rewrite["grouping"] = (mask_field, list(displays))
        branches: List[L.PlanNode] = []
        for subset in subsets:
            mask = sum(1 << (n - 1 - i) for i in range(n)
                       if i not in subset)
            if subset == full:
                sub, by_pos = agg, {i: kf for i, (kf, _)
                                    in enumerate(agg.keys)}
                aggs = list(agg.aggregates)
            else:
                child = copy.deepcopy(agg.child)
                keys = [(self.field(agg.keys[i][0].display,
                                    agg.keys[i][0].dtype),
                         copy.deepcopy(agg.keys[i][1])) for i in subset]
                aggs = []
                for item in agg.aggregates:
                    it = copy.deepcopy(item)
                    it.field = self.field(item.field.display,
                                          item.field.dtype)
                    aggs.append(it)
                sub_schema = [f for f, _ in keys] + [a.field for a in aggs]
                sub = L.AggregateNode(child, keys, aggs, sub_schema)
                by_pos = {i: f for i, f in zip(subset,
                                               (f for f, _ in keys))}
            # pad to the full key list: defaults for folded-away keys
            proj_exprs: List[BoundExpr] = []
            proj_fields: List[L.Field] = []
            for i, (kf, _) in enumerate(agg.keys):
                nf = self.field(kf.display, kf.dtype)
                proj_fields.append(nf)
                if i in by_pos:
                    proj_exprs.append(BoundColumn(by_pos[i].id,
                                                  by_pos[i].dtype))
                else:
                    proj_exprs.append(_default_literal(kf.dtype))
            for item, orig in zip(aggs, agg.aggregates):
                nf = self.field(orig.field.display, orig.field.dtype)
                proj_fields.append(nf)
                proj_exprs.append(BoundColumn(item.field.id,
                                              item.field.dtype))
            proj_fields.append(self.field("__grouping_mask", dt.UInt64))
            proj_exprs.append(BoundLiteral(mask, dt.UInt64))
            branches.append(L.ProjectNode(sub, proj_exprs, proj_fields))
        # the union reuses the primary aggregate's field ids so every
        # post-aggregation reference keeps resolving unchanged
        return L.UnionNode(branches, list(agg.schema) + [mask_field])

    def _bind_grouping(self, e: ast.FuncCall, rewrite) -> BoundExpr:
        """grouping(k1, ..) over the per-branch __grouping_mask constant.
        Standard (SQL/reference default force_grouping_standard_compatibility
        =1): bit j = 1 when arg j is aggregated away in this set; legacy
        (=0): inverted (src/Functions/grouping.h)."""
        mask_f, displays = rewrite["grouping"]
        n = len(displays)
        standard = bool(getattr(self.settings,
                                "force_grouping_standard_compatibility", 1))
        k = len(e.args)
        if not e.args:
            raise AnalysisError("grouping() needs at least one argument")
        tree: Optional[ast.Expr] = None
        for j, a in enumerate(e.args):
            t = ast.format_expr(a)
            if t not in displays:
                raise AnalysisError(
                    f"grouping() argument '{t}' is not a GROUP BY key")
            p = displays.index(t)
            bit: ast.Expr = ast.FuncCall(
                "bitAnd", [ast.FuncCall("bitShiftRight",
                                        [ast.Identifier("__grouping_mask"),
                                         ast.Literal(n - 1 - p)]),
                           ast.Literal(1)])
            if not standard:
                bit = ast.FuncCall("minus", [ast.Literal(1), bit])
            w = 1 << (k - 1 - j)
            if w != 1:
                bit = ast.FuncCall("multiply", [bit, ast.Literal(w)])
            tree = bit if tree is None else ast.FuncCall("plus", [tree, bit])
        return self.bind(tree, Scope([mask_f]), allow_agg=False)

    def bind_post_agg(self, e: ast.Expr, rewrite, scope_after: Scope
                      ) -> BoundExpr:
        if isinstance(e, ast.FuncCall) and e.name.lower() == "grouping" \
                and "grouping" in rewrite:
            return self._bind_grouping(e, rewrite)
        text = ast.format_expr(e)
        if text in rewrite["aggs"]:
            f = rewrite["aggs"][text]
            return BoundColumn(f.id, f.dtype)
        if text in rewrite["keys"]:
            f = rewrite["keys"][text]
            return BoundColumn(f.id, f.dtype)
        # semantic key match: the expression binds (pre-aggregation) to the
        # same bound tree as a GROUP BY key, under any spelling/qualification
        if not _contains_aggregate(e):
            try:
                cand = self.bind(e, rewrite["pre_scope"], allow_agg=False)
                key = _bound_repr(cand)
                if key in rewrite["keys_bound"]:
                    f = rewrite["keys_bound"][key]
                    return BoundColumn(f.id, f.dtype)
            except (AnalysisError, UnknownIdentifier, UnknownFunction,
                    NotImplementedError_):
                pass
        if isinstance(e, ast.FuncCall):
            if self._is_aggregate_call(e):
                raise AnalysisError(f"Aggregate {text} was not collected")
            args = [self.bind_post_agg(a, rewrite, scope_after) for a in e.args]
            return self._bind_call(e, args)
        if isinstance(e, ast.Identifier):
            f = scope_after.resolve(e.parts)
            if f is not None:
                return BoundColumn(f.id, f.dtype)
            raise UnknownIdentifier(
                f"Column '{e.name}' must appear in GROUP BY or inside an "
                f"aggregate function")
        if isinstance(e, ast.Literal):
            return _bind_literal(e)
        raise AnalysisError(f"Cannot bind post-aggregation expression {text}")

    # -- expression binding --------------------------------------------------
    def bind(self, e: ast.Expr, scope: Scope, allow_agg: bool) -> BoundExpr:
        if isinstance(e, ast.Identifier):
            f = scope.resolve(e.parts)
            if f is None:
                # bare nan/inf are Float64 literals in the reference lexer
                # (src/Parsers/Lexer.cpp number tokens)
                low = e.name.lower()
                if low in ("nan", "inf", "infinity"):
                    return _bind_literal(ast.Literal(
                        float("nan") if low == "nan" else float("inf")))
                raise UnknownIdentifier(f"Unknown column '{e.name}'")
            return BoundColumn(f.id, f.dtype)
        if isinstance(e, ast.Literal):
            return _bind_literal(e)
        if isinstance(e, ast.Subquery):
            return self._execute_scalar_subquery(e)
        if isinstance(e, ast.Aliased):
            # an alias that survived the select-level pre-pass (e.g. inside
            # a UDF body): the definition IS the value here
            return self.bind(e.expr, scope, allow_agg)
        if isinstance(e, ast.FuncCall):
            if e.name in ("variantType", "dynamicType") \
                    and len(e.args) == 1 \
                    and isinstance(e.args[0], ast.Identifier):
                # discriminator subcolumn of a Variant/Dynamic column
                sub = ast.Identifier(e.args[0].name + ".__vtype")
                if scope.resolve(sub.parts) is not None:
                    return self.bind(sub, scope, allow_agg)
            if e.name in ("variantElement", "dynamicElement") \
                    and len(e.args) >= 2 \
                    and isinstance(e.args[0], ast.Identifier) \
                    and isinstance(e.args[1], ast.Literal):
                tname = str(e.args[1].value)
                sub = ast.Identifier(f"{e.args[0].name}.{tname}")
                if scope.resolve(sub.parts) is not None:
                    return self.bind(sub, scope, allow_agg)
                if scope.resolve(e.args[0].parts) is not None:
                    # variant column exists but this type never occurs:
                    # a NULL column of the requested type
                    return _bind_literal(ast.Literal(None))
            udf = getattr(self.catalog, "udfs", {}).get(e.name)
            if udf is not None:
                # SQL UDF: inline the body with parameters substituted
                # (ref: UserDefinedSQLFunctionVisitor.cpp)
                params, body = udf
                if len(params) != len(e.args):
                    raise AnalysisError(
                        f"Function {e.name} expects {len(params)} "
                        f"arguments, got {len(e.args)}")
                body2 = _inline_local_aliases(
                    _subst_params(body, dict(zip(params, e.args))))
                return self.bind(body2, scope, allow_agg)
            if self._is_aggregate_call(e) and not fn_reg.exists(e.name):
                raise AnalysisError(
                    f"Aggregate function {e.name} is not allowed here")
            if e.name.lower() in ("in", "notin", "globalin", "globalnotin"):
                return self._bind_in(e, scope)
            if e.name.lower() in ("dictget", "dictgetordefault", "dicthas"):
                return self._bind_dict_get(e, scope)
            if e.name.lower() == "joinget":
                return self._bind_join_get(e, scope)
            if e.name == "CAST" or e.name.lower() in (
                    "cast", "_cast", "accuratecast", "accuratecastornull"):
                bc = self._bind_cast(e, scope)
                if e.name.lower().endswith("ornull") \
                        and not bc.dtype.nullable:
                    return BoundCall("toNullable", [bc],
                                     dt.make_nullable(bc.dtype))
                return bc
            if e.name.lower() == "exists":
                return self._execute_exists(e)
            if any(isinstance(a, ast.Lambda) for a in e.args):
                return self._bind_array_lambda(e, scope)
            args = [self.bind(a, scope, allow_agg) for a in e.args]
            return self._bind_call(e, args)
        if isinstance(e, ast.Tuple_):
            return self.bind(ast.FuncCall("tuple", list(e.items)), scope,
                             allow_agg)
        raise AnalysisError(f"Cannot bind expression {e!r}")

    _HIGHER_ORDER = {
        "arraymap": ("map", None), "arrayfilter": ("filter", None),
        "arrayexists": ("exists", None), "arrayall": ("all", None),
        "arraycount": ("count", None), "arraysum": ("sum", None),
        "arrayfirstindex": ("first_index", None),
        "arrayfold": ("fold", None),
        "arrayfirst": ("first", None),
        "arrayfirstornull": ("first_or_null", None),
        "arraylast": ("last", None),
        "arraylastornull": ("last_or_null", None),
        "arraylastindex": ("last_index", None),
        "arraymin": ("min", None), "arraymax": ("max", None),
        "arrayavg": ("avg", None),
        "arraysort": ("sort", None), "arrayreversesort": ("rsort", None),
        "arrayfill": ("fill", None), "arrayreversefill": ("rfill", None),
        "arraycumsum": ("cumsum", None),
        "arraycumsumnonnegative": ("cumsum_nonneg", None),
    }

    def _bind_array_lambda(self, e: ast.FuncCall, scope: Scope) -> BoundExpr:
        """Higher-order array functions (FunctionArrayMapped analog)."""
        key = e.name.lower()
        if key not in self._HIGHER_ORDER:
            raise NotImplementedError_(
                f"Higher-order function '{e.name}' is not supported")
        op, _ = self._HIGHER_ORDER[key]
        lam = e.args[0]
        if not isinstance(lam, ast.Lambda):
            raise AnalysisError(f"{e.name} expects a lambda first argument")
        if op == "fold":
            # arrayFold(acc, x -> expr, arr, init): sequential accumulation
            # over elements (ref: src/Functions/array/arrayFold.cpp)
            if len(e.args) < 3:
                raise AnalysisError("arrayFold expects (lambda, array..., "
                                    "init)")
            arrays = [self.bind(a, scope, allow_agg=False)
                      for a in e.args[1:-1]]
            init = self.bind(e.args[-1], scope, allow_agg=False)
            for a in arrays:
                if not a.dtype.is_array:
                    raise TypeError_("arrayFold middle arguments must be "
                                     "arrays")
            if len(lam.params) != 1 + len(arrays):
                raise AnalysisError(
                    f"arrayFold: lambda takes {len(lam.params)} parameters "
                    f"but needs {1 + len(arrays)} (acc + arrays)")
            acc_t = dt.remove_nullable(init.dtype)
            pfields = [self.field(lam.params[0], acc_t)] + \
                [self.field(p, dt.array_inner(a.dtype))
                 for p, a in zip(lam.params[1:], arrays)]
            shadowed = set(lam.params)
            inner_scope = Scope(pfields + [f for f in scope.fields
                                           if f.display not in shadowed])
            body = self.bind(lam.body, inner_scope, allow_agg=False)
            return BoundArrayLambda("fold", [f.id for f in pfields], body,
                                    arrays + [init], acc_t)
        arrays = [self.bind(a, scope, allow_agg=False) for a in e.args[1:]]
        if not arrays:
            raise AnalysisError(f"{e.name} needs an array argument")
        for a in arrays:
            if not a.dtype.is_array:
                raise TypeError_(
                    f"{e.name} arguments after the lambda must be arrays")
        if len(lam.params) != len(arrays):
            raise AnalysisError(
                f"{e.name}: lambda takes {len(lam.params)} parameters but "
                f"{len(arrays)} arrays were given")
        pfields = [self.field(p, dt.array_inner(a.dtype))
                   for p, a in zip(lam.params, arrays)]
        shadowed = set(lam.params)
        inner_scope = Scope(pfields + [f for f in scope.fields
                                       if f.display not in shadowed])
        body = self.bind(lam.body, inner_scope, allow_agg=False)
        if op == "map":
            out_t = dt.Array(dt.remove_nullable(body.dtype))
        elif op in ("filter", "sort", "rsort", "fill", "rfill"):
            out_t = arrays[0].dtype
        elif op == "sum":
            bt = dt.remove_nullable(body.dtype)
            out_t = dt.Float64 if dt.is_float(bt) else (
                dt.UInt64 if bt.np_dtype.kind == "u" else dt.Int64)
        elif op == "count":
            out_t = dt.UInt64
        elif op in ("first_index", "last_index"):
            out_t = dt.UInt32
        elif op in ("first", "last"):
            out_t = dt.array_inner(arrays[0].dtype)
        elif op in ("first_or_null", "last_or_null"):
            out_t = dt.make_nullable(dt.array_inner(arrays[0].dtype))
        elif op in ("min", "max"):
            out_t = dt.remove_nullable(body.dtype)
        elif op == "avg":
            out_t = dt.Float64
        elif op in ("cumsum", "cumsum_nonneg"):
            bt = dt.remove_nullable(body.dtype)
            out_t = dt.Array(dt.Float64 if dt.is_float(bt) else (
                dt.UInt64 if bt.np_dtype.kind == "u" and op == "cumsum"
                else dt.Int64))
        else:
            out_t = dt.UInt8
        return BoundArrayLambda(op, [f.id for f in pfields], body, arrays,
                                out_t)

    def _bind_fill(self, oi: ast.OrderItem):
        """ORDER BY ... WITH FILL literal bounds -> (from, to, step)."""
        if getattr(oi, "fill", None) is None:
            return None
        out = []
        for e in oi.fill:
            if e is None:
                out.append(None)
                continue
            b = self.bind(e, Scope([]), allow_agg=False)
            if not isinstance(b, BoundLiteral) \
                    or not isinstance(b.value, (int, float)):
                raise NotImplementedError_(
                    "WITH FILL FROM/TO/STEP must be numeric literals")
            out.append(b.value)
        return tuple(out)

    def _bind_call(self, e: ast.FuncCall, args: List[BoundExpr]) -> BoundExpr:
        if e.name.lower() == "totypename":
            return BoundLiteral(str(args[0].dtype), dt.String)
        if e.name.lower() == "currentdatabase":
            return BoundLiteral(self.catalog.current_database, dt.String)
        if e.name.lower() == "getsetting" and len(args) == 1 \
                and isinstance(args[0], BoundLiteral) \
                and isinstance(args[0].value, str):
            # constant-fold with the setting's REAL type (accepted-inert
            # settings live in Settings.extra, not as attributes — advisor
            # r04; string-valued settings must come back as String)
            from ..exec.session import active_session
            s = active_session()
            if s is not None:
                name_ = args[0].value
                d = s.settings.as_dict()
                if name_ not in d:
                    from ..core.errors import TypeError_
                    raise TypeError_(f"Unknown setting '{name_}'")
                v = d[name_]
                if isinstance(v, bool):
                    return BoundLiteral(int(v), dt.UInt8)
                if isinstance(v, int):
                    return BoundLiteral(v, dt.Int64)
                if isinstance(v, float):
                    return BoundLiteral(v, dt.Float64)
                return BoundLiteral(str(v), dt.String)
        # literal-parameterized type constructors (toDecimal32(x, S), ...)
        # become `_cast` calls whose result dtype carries the parameters
        from ..exprs.conv import literal_typed_target
        literals = [a.value if isinstance(a, BoundLiteral) else None
                    for a in args]
        target = literal_typed_target(e.name, [a.dtype for a in args],
                                      literals)
        if target is not None:
            ln_ = e.name.lower()
            if ln_.endswith("orzero"):
                return BoundCall("_castOrZero", [args[0]],
                                 target.with_nullable(
                                     args[0].dtype.nullable))
            if ln_.endswith("ornull"):
                return BoundCall("_castOrNull", [args[0]],
                                 dt.make_nullable(target))
            return BoundCall("_cast", [args[0]],
                             target.with_nullable(args[0].dtype.nullable))
        name = fn_reg.canonical_name(e.name)
        fn = fn_reg.get(name)
        out = fn.resolve([a.dtype for a in args])
        if name == "JSONExtract" and len(args) >= 2 \
                and isinstance(args[-1], BoundLiteral) \
                and isinstance(args[-1].value, str):
            # the trailing literal names the result type (FunctionsJSON.cpp
            # generic JSONExtract form)
            out = dt.parse_type_name(args[-1].value) \
                .with_nullable(args[0].dtype.nullable)
        if name == "initializeAggregation" and args \
                and isinstance(args[0], BoundLiteral) \
                and isinstance(args[0].value, str):
            from ..exprs.aggregates import get_aggregate
            agg_, _if = get_aggregate(str(args[0].value),
                                      [a.dtype for a in args[1:]])
            out = agg_.result_type()
        if name == "tupleElement" and len(args) == 2 \
                and dt.is_tuple(args[0].dtype) \
                and isinstance(args[1], BoundLiteral) \
                and isinstance(args[1].value, str):
            # named-tuple member access: tupleElement(t, 'a') / t.a
            names_ = dt.tuple_member_names(args[0].dtype)
            if args[1].value in names_:
                idx = names_.index(args[1].value) + 1
                args = [args[0], BoundLiteral(idx, dt.UInt8)]
        if name == "tupleElement" and len(args) == 2 \
                and dt.is_tuple(args[0].dtype) \
                and isinstance(args[1], BoundLiteral) \
                and isinstance(args[1].value, int):
            # the element's REAL type (resolve sees only types; the
            # constant index selects it here) — tuple(1,'a').2 is String
            tts = args[0].dtype.tuple_types
            if 1 <= args[1].value <= len(tts):
                out = dt.parse_type_name(tts[args[1].value - 1])
        # x % CONST / intDiv(x, CONST) with a nonzero literal divisor cannot
        # produce the zero-divide NULL — strip the speculative nullability
        if name in ("modulo", "intDiv") and len(args) == 2 \
                and isinstance(args[1], BoundLiteral) \
                and args[1].value not in (0, None) \
                and not args[0].dtype.nullable:
            out = dt.remove_nullable(out)
        bc = BoundCall(name, args, out)
        if out.is_dictionary and name in ("toString", "_cast", "hex",
                                          "unhex", "bin", "repeat"):
            folded = _fold_const_string(bc)
            if folded is not None:
                return folded
        return bc

    def _bind_cast(self, e: ast.FuncCall, scope: Scope) -> BoundExpr:
        arg = self.bind(e.args[0], scope, allow_agg=False)
        tname_lit = e.args[1]
        if not isinstance(tname_lit, ast.Literal):
            raise AnalysisError("CAST target type must be a literal")
        target = dt.parse_type_name(str(tname_lit.value))
        base = dt.remove_nullable(target)
        conv_name = f"to{base.name}"
        if base.name == "String":
            conv_name = "toString"
        if fn_reg.exists(conv_name):
            out = fn_reg.get(conv_name).resolve([arg.dtype])
            bc = BoundCall(fn_reg.canonical_name(conv_name), [arg], out)
        else:
            # parametric / long-tail targets: the unified cast machine
            out = target.with_nullable(target.nullable or arg.dtype.nullable)
            bc = BoundCall("_cast", [arg], out)
        if target.nullable and not out.nullable:
            return BoundCall("toNullable", [bc], dt.make_nullable(out))
        return bc

    def _bind_in(self, e: ast.FuncCall, scope: Scope) -> BoundExpr:
        negated = "not" in e.name.lower()
        lhs_ast, rhs = e.args
        lhs = self.bind(lhs_ast, scope, allow_agg=False)
        if isinstance(rhs, ast.Tuple_):
            vals = []
            for item in rhs.items:
                if isinstance(item, ast.Literal):
                    vals.append(item.value)
                    continue
                # constant expressions in the list (`x IN (1+1, -3,
                # toDate('2024-01-01'))`) fold to literals, the
                # ActionsDAG-constant-folding path the reference uses for
                # IN sets (src/Interpreters/ActionsVisitor.cpp makeSet)
                from .optimizer import _fold_constants
                folded = _fold_constants(self.bind(item, scope,
                                                   allow_agg=False))
                if isinstance(folded, BoundLiteral):
                    vals.append(folded.value)
                else:
                    raise NotImplementedError_(
                        "IN list elements must be literals")
            values = np.asarray(vals, dtype=object)
        elif isinstance(rhs, ast.Subquery):
            values = self._materialize_subquery_column(rhs)
        elif isinstance(rhs, ast.Literal):
            values = np.asarray([rhs.value], dtype=object)
        elif isinstance(rhs, ast.Identifier) \
                and scope.resolve(rhs.parts) is None:
            # `x IN table_name` (Set-engine tables & friends): the table's
            # first column becomes the membership set
            # (reference: StorageSet / interpreting IN with a table)
            parts = rhs.parts
            tdb = self.catalog.current_database if len(parts) == 1 \
                else parts[0]
            tname = parts[-1]
            q = ast.Select(items=[ast.SelectItem(ast.Star())],
                           from_=ast.TableRef(tdb, tname))
            values = self._materialize_subquery_column(ast.Subquery(q))
        else:
            raise NotImplementedError_("Unsupported IN right-hand side")
        return BoundInList(lhs, values, negated, dt.UInt8)

    def _bind_join_get(self, e: ast.FuncCall, scope: Scope) -> BoundExpr:
        """joinGet('join_table', 'value_col', key) — lookup into a
        Join-engine table (reference: StorageJoin + FunctionJoinGet); the
        table's rows become a device-constant sorted lookup like dictGet."""
        from ..exprs.expr import BoundDictGet
        if len(e.args) != 3 \
                or not isinstance(e.args[0], ast.Literal) \
                or not isinstance(e.args[1], ast.Literal):
            raise AnalysisError(
                "joinGet('table', 'column', key) expects literal names")
        tref = str(e.args[0].value)
        col = str(e.args[1].value)
        tdb = self.catalog.current_database
        tname = tref
        if "." in tref:
            tdb, tname = tref.split(".", 1)
        table = self.catalog.get_table(tdb, tname)
        key_col = getattr(table, "join_key_col", None)
        if key_col is None:
            args = [a for a in getattr(table, "engine_args", []) or []]
            key_col = args[-1] if args else None
        if key_col is None or key_col not in table.schema:
            raise AnalysisError(
                f"'{tname}' is not a Join-engine table with a key column")
        if col not in table.schema:
            raise AnalysisError(f"Unknown column '{col}' in '{tname}'")
        kt = table.schema[key_col]
        if kt.is_dictionary or kt.np_dtype.kind not in ("i", "u"):
            raise NotImplementedError_(
                "joinGet requires an integer join key")
        keys_np = np.concatenate(
            [np.asarray(p.columns[key_col]) for p in table.parts]) \
            if table.parts else np.zeros(0, np.int64)
        vals_np = np.concatenate(
            [np.asarray(p.columns[col], object) for p in table.parts]) \
            if table.parts else np.zeros(0, object)
        order = np.argsort(keys_np.astype(np.int64), kind="stable")
        vt = table.schema[col]
        default = "" if vt.is_dictionary else 0
        key = self.bind(e.args[2], scope, allow_agg=False)
        return BoundDictGet(key, keys_np.astype(np.int64)[order],
                            vals_np[order], default, vt)

    def _bind_dict_get(self, e: ast.FuncCall, scope: Scope) -> BoundExpr:
        from ..exprs.expr import BoundDictGet
        name = e.name.lower()
        is_has = name == "dicthas"
        min_args = 2 if is_has else 3
        if len(e.args) < min_args:
            raise AnalysisError(f"{e.name} expects at least {min_args} args")
        if not isinstance(e.args[0], ast.Literal):
            raise AnalysisError("dictGet: dictionary name must be a literal")
        dname = str(e.args[0].value)
        db = self.catalog.current_database
        dbo = self.catalog.databases.get(db)
        ddef = (dbo.dictionaries.get(dname)
                if dbo is not None else None)
        if ddef is None:
            raise UnknownTable(f"Unknown dictionary '{dname}'")
        src = self.catalog.get_table(ddef.source_db, ddef.source_table)
        # host-side snapshot: keys + attribute values (hashed-layout analog)
        keys_np = np.concatenate(
            [p.columns[ddef.key_column] for p in src.parts]) \
            if src.parts else np.zeros(0, np.int64)
        keys_np = keys_np.astype(np.int64)
        order = np.argsort(keys_np, kind="stable")
        if is_has:
            key_expr = self.bind(e.args[1], scope, allow_agg=False)
            return BoundDictGet(key_expr, keys_np[order],
                                np.ones(len(keys_np), np.uint8), 0, dt.UInt8)
        if not isinstance(e.args[1], ast.Literal):
            raise AnalysisError("dictGet: attribute name must be a literal")
        attr = str(e.args[1].value)
        if attr not in src.schema:
            raise UnknownIdentifier(f"Dictionary attribute '{attr}' missing")
        at = src.schema[attr]
        vals_np = np.concatenate(
            [np.asarray(p.columns[attr],
                        object if at.is_dictionary else at.np_dtype)
             for p in src.parts]) if src.parts else \
            np.zeros(0, object if at.is_dictionary else at.np_dtype)
        key_expr = self.bind(e.args[2], scope, allow_agg=False)
        default = "" if at.is_dictionary else 0
        if len(e.args) > 3 and isinstance(e.args[3], ast.Literal):
            default = e.args[3].value
        return BoundDictGet(key_expr, keys_np[order], vals_np[order],
                            default, at.with_nullable(key_expr.dtype.nullable
                                                      and False))

    # -- subquery execution (uncorrelated, eager) ----------------------------
    def _run_subquery(self, sq: ast.Subquery):
        if self.subquery_executor is None:
            raise NotImplementedError_(
                "Subqueries are not available in this context")
        return self.subquery_executor(sq.query)

    def _materialize_subquery_column(self, sq: ast.Subquery) -> np.ndarray:
        data = self._run_subquery(sq)       # dict name -> numpy
        cols = list(data.values())
        if len(cols) != 1:
            raise AnalysisError("IN subquery must return exactly one column")
        return np.asarray(cols[0], dtype=object)

    def _execute_scalar_subquery(self, sq: ast.Subquery) -> BoundExpr:
        data = self._run_subquery(sq)
        cols = list(data.values())
        if len(cols) != 1 or len(cols[0]) != 1:
            raise AnalysisError("Scalar subquery must return one row, one column")
        v = cols[0][0]
        if isinstance(v, (np.integer,)):
            v = int(v)
        elif isinstance(v, np.floating):
            v = float(v)
        return _bind_literal(ast.Literal(v))

    def _execute_exists(self, e: ast.FuncCall) -> BoundExpr:
        sq = e.args[0]
        assert isinstance(sq, ast.Subquery)
        data = self._run_subquery(sq)
        cols = list(data.values())
        nonempty = bool(len(cols) and len(cols[0]))
        return _bind_literal(ast.Literal(1 if nonempty else 0))


# -- helpers -----------------------------------------------------------------

def _parse_structure(s: str) -> Optional[List[Tuple[str, dt.DType]]]:
    """'a Int64, b String' -> [(name, dtype)]; None when the string is not
    a structure spec (then it is a data literal of a values() row)."""
    parts: List[str] = []
    depth, cur = 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        parts.append("".join(cur))
    out: List[Tuple[str, dt.DType]] = []
    for p in parts:
        p = p.strip()
        if " " not in p:
            return None
        nm, tn = p.split(" ", 1)
        try:
            out.append((nm.strip(), dt.parse_type_name(tn.strip())))
        except Exception:
            return None
    return out or None


def _default_literal(t: dt.DType):
    if t.nullable:
        return BoundLiteral(None, t)
    if dt.remove_nullable(t).is_array:
        return BoundCall("array", [], t)     # default: empty array
    if t.is_dictionary:
        return BoundLiteral("", t)
    return BoundLiteral(0, t)


def _bound_repr(be: BoundExpr) -> str:
    """Canonical string of a bound expression tree (for key matching)."""
    if isinstance(be, BoundColumn):
        return f"C({be.name})"
    if isinstance(be, BoundLiteral):
        return f"L({be.value!r}:{be.dtype})"
    if isinstance(be, BoundCall):
        return f"F({be.name};{','.join(_bound_repr(a) for a in be.args)})"
    if isinstance(be, BoundInList):
        return f"IN({_bound_repr(be.arg)};{be.negated};{id(be.values)})"
    return repr(be)


def _bind_literal(e: ast.Literal) -> BoundLiteral:
    v = e.value
    if v is None:
        return BoundLiteral(None, dt.make_nullable(dt.Nothing))
    if isinstance(v, bool):
        return BoundLiteral(int(v), dt.UInt8)
    if isinstance(v, int):
        if v > 2**64 - 1 or v < -(2**63):
            return BoundLiteral(float(v), dt.Float64)   # beyond 64-bit range
        # smallest fitting type, like the reference's literal inference
        # (src/DataTypes/FieldToDataType.cpp: 1 -> UInt8, -1 -> Int8, ...)
        if v >= 0:
            for bits, t in ((8, dt.UInt8), (16, dt.UInt16), (32, dt.UInt32)):
                if v < (1 << bits):
                    return BoundLiteral(v, t)
            return BoundLiteral(v, dt.UInt64)
        for bits, t in ((7, dt.Int8), (15, dt.Int16), (31, dt.Int32)):
            if v >= -(1 << bits):
                return BoundLiteral(v, t)
        return BoundLiteral(v, dt.Int64)
    if isinstance(v, float):
        return BoundLiteral(v, dt.Float64)
    if isinstance(v, str):
        return BoundLiteral(v, dt.String)
    raise AnalysisError(f"Unsupported literal {v!r}")


def _const_int(e) -> int:
    if isinstance(e, ast.Literal) and isinstance(e.value, int):
        return e.value
    if isinstance(e, ast.FuncCall) and e.name == "negate" \
            and isinstance(e.args[0], ast.Literal):
        return -e.args[0].value
    raise AnalysisError("Expected a constant integer")


def _bound_has_columns(be: BoundExpr) -> bool:
    if isinstance(be, BoundColumn):
        return True
    return any(_bound_has_columns(c) for c in be.children())


def _fold_const_string(bc: BoundCall):
    """Bind-time evaluation of a column-free string cast so
    toString(toDecimal32(1.5, 2)) becomes a plain string literal — outside
    jit the chain runs eagerly on concrete values, which the trace-time
    const-fold in conv.cast_exec cannot do (literals trace as Tracers)."""
    if _bound_has_columns(bc):
        return None
    from ..exprs.expr import evaluate
    try:
        cv = evaluate(bc, {})
    except Exception:
        return None
    if not (cv.dtype.is_dictionary and cv.dictionary is not None
            and cv.is_const):
        return None
    code = int(np.asarray(cv.data))
    if not (0 <= code < len(cv.dictionary)):
        return None
    return BoundLiteral(str(cv.dictionary.values[code]),
                        dt.String.with_nullable(bc.dtype.nullable))


def _ast_children(e: ast.Expr):
    if isinstance(e, ast.FuncCall):
        out = list(e.args)
        return out
    if isinstance(e, ast.Tuple_):
        return list(e.items)
    return ()


def _contains_aggregate(e: ast.Expr) -> bool:
    if isinstance(e, ast.FuncCall):
        if e.over is None and agg_reg.is_aggregate_name(e.name):
            return True
        return any(_contains_aggregate(a) for a in e.args)
    if isinstance(e, ast.Tuple_):
        return any(_contains_aggregate(i) for i in e.items)
    return False


def _subst_params(e: ast.Expr, sub: Dict[str, ast.Expr]) -> ast.Expr:
    """Replace bare identifiers with argument expressions (UDF inlining)."""
    if isinstance(e, ast.Identifier) and len(e.parts) == 1 \
            and e.name in sub:
        return sub[e.name]
    if isinstance(e, ast.FuncCall):
        return dataclasses.replace(
            e, args=[_subst_params(a, sub) for a in e.args],
            params=[_subst_params(p, sub) for p in e.params]
            if e.params else e.params)
    if isinstance(e, ast.Tuple_):
        return dataclasses.replace(
            e, items=[_subst_params(i, sub) for i in e.items])
    if isinstance(e, ast.Aliased):
        return dataclasses.replace(e, expr=_subst_params(e.expr, sub))
    if isinstance(e, ast.Lambda):
        inner = {k: v for k, v in sub.items() if k not in e.params}
        return dataclasses.replace(e, body=_subst_params(e.body, inner))
    return e


def _collect_aliased(e: ast.Expr, out: Dict[str, ast.Expr]) -> None:
    if isinstance(e, ast.Aliased):
        out[e.alias] = _strip_aliased(e.expr)
        _collect_aliased(e.expr, out)
        return
    if isinstance(e, ast.FuncCall):
        for a in e.args:
            _collect_aliased(a, out)
        for p in e.params or []:
            _collect_aliased(p, out)
    elif isinstance(e, ast.Tuple_):
        for i in e.items:
            _collect_aliased(i, out)
    elif isinstance(e, ast.Lambda):
        _collect_aliased(e.body, out)


def _strip_aliased(e: ast.Expr) -> ast.Expr:
    if isinstance(e, ast.Aliased):
        return _strip_aliased(e.expr)
    if isinstance(e, ast.FuncCall):
        return dataclasses.replace(
            e, args=[_strip_aliased(a) for a in e.args],
            params=[_strip_aliased(p) for p in e.params]
            if e.params else e.params)
    if isinstance(e, ast.Tuple_):
        return dataclasses.replace(
            e, items=[_strip_aliased(i) for i in e.items])
    if isinstance(e, ast.Lambda):
        return dataclasses.replace(e, body=_strip_aliased(e.body))
    return e


def _inline_local_aliases(e: ast.Expr) -> ast.Expr:
    """Resolve `(expr AS name) ... name` references locally (UDF bodies)."""
    defs: Dict[str, ast.Expr] = {}
    _collect_aliased(e, defs)
    if not defs:
        return e
    out = _strip_aliased(e)
    for _ in range(8):               # chained aliases: iterate to fixpoint
        nxt = _subst_params(out, defs)
        if ast.format_expr(nxt) == ast.format_expr(out):
            break
        out = nxt
    return out


def _contains_array_join(e: ast.Expr) -> bool:
    if isinstance(e, ast.FuncCall):
        if e.name == "arrayJoin":
            return True
        return any(_contains_array_join(a) for a in e.args)
    if isinstance(e, ast.Tuple_):
        return any(_contains_array_join(i) for i in e.items)
    return False


def _contains_window(e: ast.Expr) -> bool:
    if isinstance(e, ast.FuncCall):
        if e.over is not None:
            return True
        return any(_contains_window(a) for a in e.args)
    if isinstance(e, ast.Tuple_):
        return any(_contains_window(i) for i in e.items)
    return False


def _replace_by_text(e: ast.Expr, mapping: Dict[str, str]) -> ast.Expr:
    """Substitute subtrees whose formatted text appears in `mapping` with the
    mapped identifier."""
    text = ast.format_expr(e)
    if text in mapping and mapping[text]:
        return ast.Identifier(mapping[text])
    if isinstance(e, ast.FuncCall):
        return ast.FuncCall(e.name,
                            [_replace_by_text(a, mapping) for a in e.args],
                            e.params, e.distinct, e.over)
    if isinstance(e, ast.Tuple_):
        return ast.Tuple_([_replace_by_text(i, mapping) for i in e.items])
    return e


def _replace_windows(e: ast.Expr, win_map: Dict[str, str]) -> ast.Expr:
    """Substitute collected window calls with their placeholder columns."""
    if isinstance(e, ast.FuncCall):
        if e.over is not None:
            text = ast.format_expr(e)
            if text in win_map:
                return ast.Identifier(win_map[text])
        return ast.FuncCall(e.name,
                            [_replace_windows(a, win_map) for a in e.args],
                            e.params, e.distinct, e.over)
    if isinstance(e, ast.Tuple_):
        return ast.Tuple_([_replace_windows(i, win_map) for i in e.items])
    return e


def _split_conjuncts(e: ast.Expr) -> List[ast.Expr]:
    if isinstance(e, ast.FuncCall) and e.name == "and":
        out = []
        for a in e.args:
            out.extend(_split_conjuncts(a))
        return out
    return [e]


def _expand_aliases(e: ast.Expr, aliases: Dict[str, ast.Expr], scope: Scope,
                    depth: int = 0,
                    exclude: frozenset = frozenset()) -> ast.Expr:
    """Substitute select-item aliases into an expression.

    Reference default semantics (prefer_column_name_to_alias=0): the alias
    REPLACES the column name everywhere in the query, including other select
    items — except inside its own definition, where the name keeps referring
    to the source column (`x*2 AS x` is not cyclic)."""
    if depth > 16:
        raise AnalysisError("Alias expansion too deep (cyclic aliases?)")
    if isinstance(e, ast.Identifier) \
            and (len(e.parts) == 1 or e.name in aliases):
        name = e.parts[0] if len(e.parts) == 1 else e.name
        if name in aliases and name not in exclude:
            sub = aliases[name]
            if ast.format_expr(sub) != name:     # x AS x is a no-op
                return _expand_aliases(sub, aliases, scope, depth + 1,
                                       exclude | {name})
        return e
    if isinstance(e, ast.FuncCall):
        over = e.over
        if over is not None:
            over = ast.WindowSpec(
                [_expand_aliases(p, aliases, scope, depth, exclude)
                 for p in over.partition_by],
                [ast.OrderItem(_expand_aliases(o.expr, aliases, scope, depth,
                                               exclude),
                               o.descending, o.nulls_last)
                 for o in over.order_by],
                over.frame)
        return ast.FuncCall(e.name,
                            [_expand_aliases(a, aliases, scope, depth,
                                             exclude)
                             for a in e.args],
                            e.params, e.distinct, over)
    if isinstance(e, ast.Tuple_):
        return ast.Tuple_([_expand_aliases(i, aliases, scope, depth, exclude)
                           for i in e.items])
    return e


def _union_type(types: List[dt.DType]) -> dt.DType:
    out = types[0]
    for t in types[1:]:
        out = dt.common_supertype(out, t)
    return out
