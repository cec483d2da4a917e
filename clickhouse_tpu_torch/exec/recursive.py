"""WITH RECURSIVE evaluation: a host-side fixpoint over ordinary SELECTs
(reference: clickhouse_tpu/exec/recursive.py, copied).

ClickHouse executes recursive CTEs iteratively on the initiator
(src/Processors/QueryPlan/ReadFromRecursiveCTEStep.cpp): evaluate the
non-recursive branches, then re-run the recursive branches against the
previous iteration's rows until no new rows appear.  Here each iteration
is one normal SELECT, run on the session's device, over a scratch working
table (``__rcte*``), registered in the catalog for the query and dropped
after it.
"""
from __future__ import annotations

import dataclasses as dc
from typing import Any, Dict, List, Optional

import numpy as np

from ..sql import ast

__all__ = ["has_recursive_ctes", "run_recursive_select"]

_MAX_ITERS = 1000     # reference: max_recursive_cte_evaluation_depth


def _select_has_rec(sel) -> bool:
    return isinstance(sel, ast.Select) and any(
        getattr(c, "recursive", False) and c.query is not None
        and _references(c.query, c.name)
        for c in sel.ctes)


def has_recursive_ctes(stmt) -> bool:
    if not isinstance(stmt, (ast.Select, ast.Union, ast.SetOp)):
        return False
    if _select_has_rec(stmt):
        return True
    return _find_rec_select(stmt) is not None


def _find_rec_select(stmt):
    """Outermost Select carrying self-referential recursive CTEs (it may
    sit inside a subquery: `SELECT * FROM (WITH RECURSIVE ...)`).  Inner
    nested ones resolve naturally when their enclosing branch executes."""
    found = [None]

    def fn(n):
        if found[0] is None and _select_has_rec(n):
            found[0] = n
            return n          # stop descending into it
        return None
    _walk(stmt, fn)
    return found[0]


def _walk(node, fn):
    """Depth-first ast rewrite; fn(obj) returns a replacement or None."""
    if isinstance(node, list):
        return [_walk(x, fn) for x in node]
    if isinstance(node, tuple):
        return tuple(_walk(x, fn) for x in node)
    if not dc.is_dataclass(node) or isinstance(node, type):
        return node
    rep = fn(node)
    if rep is not None:
        return rep
    changed = {}
    for f in dc.fields(node):
        v = getattr(node, f.name)
        nv = _walk(v, fn)
        if isinstance(v, (list, tuple)):
            if nv != v:
                changed[f.name] = nv
        elif nv is not v:
            changed[f.name] = nv
    return dc.replace(node, **changed) if changed else node


def _rewrite_tables(node, mapping: Dict[str, str]):
    def fn(n):
        if isinstance(n, ast.TableRef) and n.database is None \
                and n.table in mapping:
            # keep the CTE name visible as an alias so qualified column
            # references (cte.col) still resolve
            return dc.replace(n, table=mapping[n.table],
                              alias=n.alias or n.table)
        return None
    return _walk(node, fn)


def _references(node, name: str) -> bool:
    hit = [False]

    def fn(n):
        if isinstance(n, ast.TableRef) and n.database is None \
                and n.table == name:
            hit[0] = True
        return None
    _walk(node, fn)
    return hit[0]


def _branches(q) -> List[ast.Select]:
    out: List[ast.Select] = []
    if isinstance(q, ast.Union):
        for s in q.selects:
            out.extend(_branches(s))
    else:
        out.append(q)
    return out


def _with_ctes(q, ctes: List[ast.CTE]):
    """Attach sibling CTE definitions to a branch query so references to
    other (non-recursive) CTEs keep resolving when the branch runs alone."""
    if not ctes:
        return q
    if isinstance(q, ast.Select):
        return dc.replace(q, ctes=list(ctes) + list(q.ctes))
    # Union: wrap in SELECT * so the ctes have a Select to live on
    inner = ast.SubqueryRef(q, None)
    return ast.Select(items=[ast.SelectItem(ast.Star(), None)],
                      from_=inner, ctes=list(ctes))


def _rows_key(columns: Dict[str, np.ndarray]) -> set:
    n = 0
    for v in columns.values():
        n = len(v)
        break
    return {tuple(repr(columns[k][i]) for k in columns) for i in range(n)}


class _Scratch:
    """Temp tables registered directly in the catalog (never persisted)."""

    def __init__(self, session):
        self.session = session
        self.db = session.catalog.databases[session.catalog.current_database]
        self.names: List[str] = []
        self.seq = 0

    def create(self, name: str, types: List, columns: Dict[str, np.ndarray]):
        from ..core import dtypes as dt
        from ..storage.table import Table
        t = Table(name, [(nm, dt.parse_type_name(ts)) for nm, ts in types],
                  device=self.session.device)
        self.db.tables[name] = t
        self.names.append(name)
        self.append(name, columns)
        return t

    def replace_rows(self, name: str, types, columns):
        del self.db.tables[name]
        self.names.remove(name)
        self.create(name, types, columns)

    def append(self, name: str, columns: Dict[str, np.ndarray]):
        # the result's values as INSERT takes them (dates encoded again)
        from .session import _align_insert
        if any(len(v) for v in columns.values()):
            t = self.db.tables[name]
            t.insert_pydict(_align_insert(columns, t))

    def cleanup(self):
        for n in self.names:
            self.db.tables.pop(n, None)


def run_recursive_select(session, stmt, overrides: Dict[str, Any],
                         sql: str = ""):
    """Materialize every recursive CTE into scratch tables (innermost ones
    resolve on branch execution re-entry), then run the rewritten query."""
    scratch = _Scratch(session)
    try:
        for _ in range(64):
            target = _find_rec_select(stmt)
            if target is None:
                break
            new_target = _materialize_ctes(session, target, overrides,
                                           scratch)
            if target is stmt:
                stmt = new_target
            else:
                stmt = _walk(stmt, lambda n: new_target
                             if n is target else None)
        return session._run_select(stmt, dict(overrides))
    finally:
        scratch.cleanup()


def _materialize_ctes(session, stmt: ast.Select,
                      overrides: Dict[str, Any], scratch: "_Scratch"):
    """Evaluate stmt's self-referential CTEs into scratch tables; return
    stmt with those CTEs removed and references redirected."""
    from ..core.errors import AnalysisError
    rec = [c for c in stmt.ctes
           if getattr(c, "recursive", False) and c.query is not None]
    mapping: Dict[str, str] = {}
    if True:
        for cte in rec:
            if not _references(cte.query, cte.name):
                # RECURSIVE keyword without self-reference: plain CTE
                continue
            branches = _branches(cte.query)
            mode = "all"
            if isinstance(cte.query, ast.Union):
                mode = cte.query.mode
                if not getattr(cte.query, "mode_explicit", True):
                    mode = "distinct"   # bare UNION in recursion = DISTINCT
            base = [b for b in branches if not _references(b, cte.name)]
            steps = [b for b in branches if _references(b, cte.name)]
            if not base:
                raise AnalysisError(
                    f"Recursive CTE '{cte.name}' has no non-recursive "
                    "branch")
            scratch.seq += 1
            acc = f"__rcte_{cte.name}_{scratch.seq}"
            work = f"{acc}__w"
            # sibling plain CTEs stay visible inside the branches
            sibling = [c for c in stmt.ctes
                       if c.name != cte.name and c.name not in mapping
                       and not (getattr(c, "recursive", False)
                                and c.query is not None
                                and _references(c.query, c.name))]
            base_q = base[0] if len(base) == 1 \
                else ast.Union(list(base), mode)
            res = session._run_select(
                _rewrite_tables(_with_ctes(base_q, sibling), mapping),
                dict(overrides))
            types = res.types
            cols = res.columns
            if mode == "distinct":
                seen = _rows_key(cols)
            scratch.create(acc, types, cols)
            scratch.create(work, types, cols)
            step_map = dict(mapping)
            step_map[cte.name] = work
            step_q = steps[0] if len(steps) == 1 \
                else ast.Union(list(steps), "all")
            step_ast = _rewrite_tables(_with_ctes(step_q, sibling),
                                       step_map)
            base_names = [nm for nm, _ in types]
            for it in range(_MAX_ITERS):
                r = session._run_select(step_ast, dict(overrides))
                if len(r.columns) != len(base_names):
                    raise AnalysisError(
                        f"Recursive CTE '{cte.name}': the recursive branch "
                        f"returns {len(r.columns)} columns, the "
                        f"non-recursive returns {len(base_names)}")
                # column names come from the non-recursive branch (SQL
                # standard); the step's output renames positionally
                new = {nm: v for nm, v in zip(base_names,
                                              r.columns.values())}
                if mode == "distinct":
                    keep = []
                    nrows = r.row_count
                    keys = [tuple(repr(new[k][i]) for k in new)
                            for i in range(nrows)]
                    for i, k in enumerate(keys):
                        if k not in seen:
                            seen.add(k)
                            keep.append(i)
                    new = {k: v[keep] if len(keep) else v[:0]
                           for k, v in new.items()}
                n_new = next((len(v) for v in new.values()), 0)
                if n_new == 0:
                    break
                # the working table holds ONLY the previous iteration's
                # rows (SQL standard iteration semantics)
                wtypes = [(nm, ts) for nm, (_, ts) in zip(base_names,
                                                          r.types)]
                scratch.append(acc, {k: np.asarray(v)
                                     for k, v in new.items()})
                scratch.replace_rows(work, wtypes,
                                     {k: np.asarray(v)
                                      for k, v in new.items()})
            else:
                raise AnalysisError(
                    f"Recursive CTE '{cte.name}' exceeded {_MAX_ITERS} "
                    "iterations")
            mapping[cte.name] = acc
        rest = [c for c in stmt.ctes
                if not (getattr(c, "recursive", False)
                        and c.query is not None
                        and c.name in mapping)]
        stmt2 = dc.replace(stmt, ctes=rest)
        return _rewrite_tables(stmt2, mapping)
