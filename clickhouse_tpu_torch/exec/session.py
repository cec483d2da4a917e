"""Session: the public query API (reference: clickhouse_tpu/exec/session.py).

``Session.execute(sql)`` parses, analyzes, optimizes and runs one
statement: CREATE TABLE, INSERT ... VALUES / SELECT, SELECT and DROP TABLE.
Plans run eagerly on the session's device (there is no whole-query
compilation).  A SELECT over a table above ``max_device_block_bytes``
streams chunk by chunk (exec/streaming.py) where the reference streams it:
with ``compile_queries`` set (the default) in a local session.  Every
other statement raises ``NotImplementedError_`` naming it.

The device is explicit: ``"cuda"`` (the default) runs the hand-written
kernels and raises when no GPU is present; ``"cpu"`` runs the kernels'
plain PyTorch versions and must be asked for.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core import dtypes as dt
from ..core import typed
from ..core.column import check_array_type, pad_to, state_width
from ..core.errors import (AnalysisError, CapacityError, MemoryLimitExceeded,
                           NotImplementedError_)
from ..core.settings import Settings
from ..plan.analyzer import Analyzer
from ..plan import logical as L
from ..plan.optimizer import optimize_plan
from ..sql import ast, parse
from ..storage.table import Catalog, Table
from .executor import ExecContext, execute_plan, materialize
from .result import Result

__all__ = ["Session", "active_session", "set_active_session"]

_ACTIVE = threading.local()


def set_active_session(s) -> None:
    _ACTIVE.session = s


def active_session():
    return getattr(_ACTIVE, "session", None)


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "connect(device='cuda'): no CUDA device is available; pass "
                "device='cpu' to run the kernels' plain versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Session:
    def __init__(self, device="cuda", settings: Optional[Settings] = None,
                 catalog: Optional[Catalog] = None):
        self.device = _resolve_device(device)
        self.settings = settings or Settings()
        self.catalog = catalog or Catalog(device=self.device)
        # counters of the queries run (the reference's ProfileEvents):
        # Query, SelectedRows, CapacityRetunes and the executor's own
        # (DenseGatherJoins, ...)
        self.profile_events: Dict[str, int] = {}
        # streamed programs by (SQL, settings), with their tables' versions
        self._stream_cache: Dict[tuple, tuple] = {}

    # -- public API ----------------------------------------------------------
    def execute(self, sql: str, settings: Optional[Dict[str, Any]] = None
                ) -> Result:
        t0 = time.monotonic()
        set_active_session(self)
        stmt = parse(sql)
        res = self._dispatch(stmt, settings or {}, sql)
        res.elapsed_s = time.monotonic() - t0
        return res

    def insert_pydict(self, table: str, data: Dict[str, np.ndarray],
                      database: Optional[str] = None):
        db = database or self.catalog.current_database
        self.catalog.get_table(db, table).insert_pydict(data)

    # -- dispatch ------------------------------------------------------------
    def _dispatch(self, stmt, overrides: Dict[str, Any], sql: str = ""
                  ) -> Result:
        if isinstance(stmt, (ast.Select, ast.Union, ast.SetOp)):
            return self._run_select(stmt, overrides, sql)
        if isinstance(stmt, ast.CreateTable):
            return self._run_create_table(stmt)
        if isinstance(stmt, ast.Insert):
            return self._run_insert(stmt, overrides)
        if isinstance(stmt, ast.DropTable) and not stmt.is_database:
            db = stmt.database or self.catalog.current_database
            self.catalog.drop_table(db, stmt.table, stmt.if_exists)
            return _status_result()
        raise NotImplementedError_(
            f"Statement {type(stmt).__name__} is not ported to the CUDA "
            f"engine yet")

    # -- SELECT --------------------------------------------------------------
    def _plan(self, stmt, settings: Settings):
        analyzer = Analyzer(self.catalog, settings,
                            subquery_executor=self._subquery_executor(
                                settings))
        plan = analyzer.analyze(stmt)
        return optimize_plan(plan, settings, catalog=self.catalog)

    def _subquery_executor(self, settings: Settings):
        def run(sel_ast) -> Dict[str, np.ndarray]:
            plan = self._plan(sel_ast, settings)
            return self._execute(plan, settings)[0]
        return run

    def _query_settings(self, stmt, overrides: Dict[str, Any]) -> Settings:
        clause = getattr(stmt, "settings", None)
        merged = dict(clause or {})
        merged.update(overrides)
        return self.settings.copy_with(merged) if merged else self.settings

    def _run_select(self, stmt, overrides: Dict[str, Any],
                    sql: str = "") -> Result:
        """SELECT with capacity autotuning, as the reference's: a
        CapacityError that names a setting (GROUP BY groups beyond
        max_groups) re-plans the query with that setting raised to
        max(pad(needed * 5/4 + 1), twice its value), at most
        capacity_autotune_max_retries times.  A plan over a table above
        the streaming threshold streams (exec/streaming.try_streaming,
        counted in StreamedQueries) where it can; one over the budget
        that cannot raises MemoryLimitExceeded, unless an expanding
        join's probe side streams in chunks that fit
        (exec/streaming.try_blowup_streaming, counted in
        BlowupStreamedQueries).  WITH RECURSIVE runs as a fixpoint of such
        SELECTs over scratch tables (exec/recursive.py)."""
        from .recursive import has_recursive_ctes, run_recursive_select
        if has_recursive_ctes(stmt):
            return run_recursive_select(self, stmt, overrides, sql)
        from .streaming import (_stream_threshold, scans_over_threshold,
                                try_blowup_streaming, try_streaming)
        settings = self._query_settings(stmt, overrides)
        retries = settings.capacity_autotune_max_retries \
            if settings.capacity_autotune else 0
        for attempt in range(retries + 1):
            try:
                streamed = None
                if settings.compile_queries:
                    try:
                        streamed = try_streaming(self, stmt, settings, sql)
                    except MemoryLimitExceeded:
                        # refused before it ran because another table of
                        # the catalog is above the threshold: the same
                        # second chance, where no table this plan scans is
                        # (a plan over a big table that did not stream
                        # stays refused, as in the reference)
                        plan = self._plan(stmt, settings)
                        if scans_over_threshold(
                                self.catalog, plan,
                                _stream_threshold(settings)):
                            raise
                        blown = try_blowup_streaming(self, plan, settings)
                        if blown is None:
                            raise
                        plan, cols, ctx = blown
                        break
                if streamed is not None:
                    plan, cols, ctx = streamed
                    self._count("StreamedQueries")
                    break
                plan = self._plan(stmt, settings)
                try:
                    cols, ctx = self._execute(plan, settings)
                except MemoryLimitExceeded:
                    # the second chance: a cross join's intermediate
                    # streamed in chunks of its probe side
                    blown = try_blowup_streaming(self, plan, settings)
                    if blown is None:
                        raise
                    plan, cols, ctx = blown
                break
            except CapacityError as e:
                if attempt >= retries or not e.setting or e.needed is None:
                    raise
                cur = getattr(settings, e.setting)
                new = max(pad_to(int(e.needed * 5 // 4) + 1), cur * 2)
                settings = settings.copy_with({e.setting: new})
                self._count("CapacityRetunes")
        types = [(f.display, str(f.dtype)) for f in plan.schema]
        self._count("Query")
        self._count("SelectedRows", ctx.profile.get("rows_scanned", 0))
        for k, v in ctx.profile.items():
            if k != "rows_scanned":
                self._count(k, v)
        return Result(cols, types,
                      rows_read=ctx.profile.get("rows_scanned", 0),
                      totals=ctx.totals)

    def _count(self, name: str, value: int = 1) -> None:
        self.profile_events[name] = self.profile_events.get(name, 0) + value

    def _collect_table_blocks(self, plan: L.PlanNode, out=None):
        if out is None:
            out = {}
        if isinstance(plan, L.ScanNode):
            key = (plan.database, plan.table)
            if key not in out:
                out[key] = self.catalog.get_table(*key).read_block()
        for c in plan.children():
            self._collect_table_blocks(c, out)
        return out

    def _governor_check(self, plan: L.PlanNode, settings: Settings) -> int:
        """Refuse plans whose whole-block footprint exceeds the device
        budget.  -> the bytes of the budget the estimate leaves (for a
        sort's working set)."""
        from .streaming import (effective_memory_budget,
                                estimate_plan_device_bytes)
        budget = effective_memory_budget(settings)
        est = estimate_plan_device_bytes(plan, self.catalog, settings)
        if est > budget:
            raise MemoryLimitExceeded(
                f"query would need ~{est >> 20} MiB of device memory "
                f"(budget {budget >> 20} MiB)")
        return budget - est

    def _execute(self, plan: L.PlanNode, settings: Settings):
        from .streaming import cached_chars_bytes
        headroom = self._governor_check(plan, settings)
        blocks = self._collect_table_blocks(plan)
        # a string dictionary's chars, cached on the device by an earlier
        # query, count against every query that reads the column
        chars = cached_chars_bytes(plan, blocks, self.device)
        if chars > headroom:
            raise MemoryLimitExceeded(
                f"query would need its estimate and {chars} bytes of cached "
                f"string dictionary chars ({max(headroom, 0)} bytes of the "
                f"budget left beside the estimate)")
        ctx = ExecContext(blocks, settings, device=self.device)
        ctx.memory_headroom = headroom - chars
        out = execute_plan(plan, ctx)
        cols = materialize(out, plan.schema, ctx)
        # WITH TOTALS: the totals block's one row, as the result's columns
        ctx.totals = None if ctx.totals_block is None else \
            materialize(ctx.totals_block, plan.schema)
        return cols, ctx

    # -- DDL / INSERT ----------------------------------------------------------
    def _run_create_table(self, stmt: ast.CreateTable) -> Result:
        db = stmt.database or self.catalog.current_database
        if stmt.as_select is not None or stmt.as_table is not None \
                or stmt.as_table_function is not None:
            raise NotImplementedError_(
                "CREATE TABLE ... AS is not ported to the CUDA engine yet")
        if any(c.default_kind != "default" or c.default is not None
               for c in stmt.columns):
            raise NotImplementedError_(
                "column DEFAULT/MATERIALIZED/ALIAS expressions are not "
                "ported to the CUDA engine yet")
        if getattr(stmt, "or_replace", False):
            self.catalog.drop_table(db, stmt.table, if_exists=True)
        schema = []
        for c in stmt.columns:
            if not c.type_name:
                raise AnalysisError(f"Column '{c.name}' needs a type")
            try:
                t = dt.parse_type_name(c.type_name)
            except ValueError as e:        # nested arrays
                if not c.type_name.lower().startswith("array("):
                    raise
                raise NotImplementedError_(
                    f"{c.type_name} columns are not ported to the CUDA "
                    f"engine yet ({e})") from None
            if t.is_array:
                check_array_type(t)
            if t.agg_state is not None:
                state_width(t)        # the state's layout, or a typed error
            schema.append((c.name, t))
        t = Table(stmt.table, schema, stmt.engine,
                  order_by=[ast.format_expr(e) for e in (stmt.order_by or [])],
                  device=self.device)
        t.engine_args = list(getattr(stmt, "engine_args", []) or [])
        self.catalog.create_table(db, t, stmt.if_not_exists)
        return _status_result()

    def _run_insert(self, stmt: ast.Insert,
                    overrides: Optional[Dict[str, Any]] = None) -> Result:
        if stmt.table_function is not None or stmt.infile is not None \
                or stmt.format is not None \
                or getattr(stmt, "inline_data", None) is not None:
            raise NotImplementedError_(
                "INSERT from table functions, files or formats is not "
                "ported to the CUDA engine yet")
        db = stmt.database or self.catalog.current_database
        table = self.catalog.get_table(db, stmt.table)
        if stmt.values is not None:
            names = stmt.columns or list(table.schema.keys())
            cols: Dict[str, list] = {n: [] for n in names}

            def evalr(e: ast.Expr):
                import datetime as _dtm
                sel = ast.Select(items=[ast.SelectItem(e, None)])
                v = self._run_select(sel, {}).rows()[0][0]
                if isinstance(v, (_dtm.date, _dtm.datetime)):
                    return v.isoformat(sep=" ") \
                        if isinstance(v, _dtm.datetime) else v.isoformat()
                return v

            for row in stmt.values:
                if len(row) != len(names):
                    raise AnalysisError("INSERT VALUES arity mismatch")
                for n, e in zip(names, row):
                    cols[n].append(_literal_value(e, evalr))
            data = {n: np.asarray(v, dtype=object) for n, v in cols.items()}
        else:
            settings = self._query_settings(stmt, overrides or {})
            data, ictx = self._execute(self._plan(stmt.select, settings),
                                       settings)
            for k, v in ictx.profile.items():
                if k != "rows_scanned":
                    self._count(k, v)
            data = dict(zip(stmt.columns or table.schema.keys(),
                            data.values()))
        table.insert_pydict(_align_insert(data, table))
        return _status_result()


def _status_result() -> Result:
    return Result({}, [])


def _literal_value(e: ast.Expr, evalr=None):
    if isinstance(e, ast.Literal):
        return e.value
    if isinstance(e, ast.FuncCall) and e.name == "negate" \
            and isinstance(e.args[0], ast.Literal):
        return -e.args[0].value
    if isinstance(e, ast.FuncCall) and e.name == "array":
        return [_literal_value(x, evalr) for x in e.args]
    if evalr is not None:
        return evalr(e)
    raise AnalysisError("INSERT VALUES must be literals")


def _align_insert(data: Dict[str, np.ndarray], table: Table
                  ) -> Dict[str, np.ndarray]:
    """Cast host values to the table's storage dtypes."""
    out = {}
    for name, vals in data.items():
        if name not in table.schema:
            raise AnalysisError(f"Unknown column '{name}' in INSERT")
        ctype = table.schema[name]
        v = np.asarray(vals)
        if dt.is_composite(ctype):
            raise NotImplementedError_(
                f"{ctype} columns are not ported to the CUDA engine yet")
        if ctype.agg_state is not None:
            out[name] = vals      # Table.insert_pydict makes its matrix
        elif ctype.is_array:
            if v.ndim == 2 and v.dtype != object:
                out[name] = v        # a vector matrix goes in as it is
                continue
            rows = np.empty(len(v), object)     # a list a row
            for i, x in enumerate(v):
                rows[i] = list(x) if isinstance(
                    x, (list, tuple, np.ndarray)) else x
            out[name] = rows
        elif ctype.is_dictionary:
            if dt.remove_nullable(ctype).fixed_len is not None:
                raise NotImplementedError_(
                    "FixedString columns are not ported to the CUDA engine "
                    "yet")
            out[name] = v.astype(object)
        elif typed.needs_decode(ctype):
            enc = typed.encode_for_storage(ctype, v)
            if v.dtype == object and any(x is None for x in v):
                res = np.empty(len(v), object)   # keep NULL markers
                for i, x in enumerate(v):
                    res[i] = None if x is None else enc[i]
                out[name] = res
            else:
                out[name] = enc
        elif v.dtype == object and any(x is None for x in v):
            out[name] = v
        else:
            out[name] = v.astype(ctype.np_dtype)
    return out
