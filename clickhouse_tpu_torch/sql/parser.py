"""Hand-written recursive-descent SQL parser.

Analog of the reference's parser combinators (src/Parsers/ParserSelectQuery.cpp,
ExpressionListParsers.cpp).  Operators are desugared to ClickHouse function
names; clause order follows the reference's SELECT grammar.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ..core.errors import ParseError
from . import ast
from .lexer import Token, tokenize

__all__ = ["parse", "parse_expression"]

RESERVED = {
    "FROM", "WHERE", "PREWHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET",
    "BY", "AS", "ON", "USING", "JOIN", "INNER", "LEFT", "RIGHT", "FULL",
    "CROSS", "GLOBAL", "ANY", "ALL", "SEMI", "ANTI", "ASOF", "UNION",
    "SETTINGS", "WITH", "SELECT", "DISTINCT", "AND", "OR", "NOT", "IN",
    "LIKE", "ILIKE", "BETWEEN", "IS", "NULL", "CASE", "WHEN", "THEN", "ELSE",
    "END", "ASC", "DESC", "DESCENDING", "ASCENDING", "NULLS",
    "INTO", "VALUES", "FORMAT", "TOTALS", "FINAL", "SAMPLE", "ROLLUP",
    "CUBE",
    "INTERVAL", "EXISTS", "ARRAY", "OUTFILE", "INFILE", "OVER",
    "INTERSECT", "EXCEPT", "WINDOW", "COLLATE", "INTERPOLATE", "FETCH",
}


def parse(sql: str):
    """Parse one statement (trailing semicolon tolerated)."""
    p = Parser(tokenize(sql))
    stmt = p.parse_statement()
    p.accept_op(";")
    p.expect_end()
    return stmt


def parse_expression(sql: str) -> ast.Expr:
    p = Parser(tokenize(sql))
    e = p.parse_expr()
    p.expect_end()
    return e


class Parser:
    def __init__(self, tokens: List[Token]):
        self.tokens = tokens
        self.i = 0

    # -- token plumbing ------------------------------------------------------
    @property
    def tok(self) -> Token:
        return self.tokens[self.i]

    def advance(self) -> Token:
        t = self.tok
        self.i += 1
        return t

    def accept_kw(self, *kws: str) -> Optional[Token]:
        if self.tok.is_kw(*kws):
            return self.advance()
        return None

    def expect_kw(self, *kws: str) -> Token:
        if not self.tok.is_kw(*kws):
            raise ParseError(f"Expected {'/'.join(kws)}, got {self.tok.text!r} "
                             f"at {self.tok.pos}")
        return self.advance()

    def accept_op(self, op: str) -> bool:
        if self.tok.kind == "op" and self.tok.text == op:
            self.advance()
            return True
        return False

    def expect_op(self, op: str):
        if not self.accept_op(op):
            raise ParseError(f"Expected {op!r}, got {self.tok.text!r} at "
                             f"{self.tok.pos}")

    def expect_word(self) -> str:
        if self.tok.kind != "word":
            raise ParseError(f"Expected identifier, got {self.tok.text!r} at "
                             f"{self.tok.pos}")
        return self.advance().text

    def expect_end(self):
        if self.tok.kind != "end":
            raise ParseError(f"Unexpected trailing input {self.tok.text!r} at "
                             f"{self.tok.pos}")

    # -- statements ----------------------------------------------------------
    def parse_statement(self):
        t = self.tok
        if t.is_kw("SELECT", "WITH"):
            return self.parse_select_union()
        if t.is_kw("EXPLAIN"):
            return self.parse_explain()
        if t.is_kw("DETACH"):
            self.advance()
            self.expect_kw("TABLE", "VIEW", "DICTIONARY", "DATABASE")
            if_exists = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                if_exists = True
            db, tbl = self.parse_table_name()
            self._accept_on_cluster()
            self.accept_kw("PERMANENTLY")
            self._ddl_tail()
            return ast.DetachAttach("detach", db, tbl, if_exists)
        if t.is_kw("ATTACH"):
            # bare `ATTACH TABLE [db.]name` reloads from the durable store;
            # ATTACH with a full definition parses as CREATE (reference
            # behavior: ATTACH = CREATE without data initialization)
            save = self.i
            self.advance()
            if self.tok.is_kw("TABLE"):
                self.advance()
                if_exists = False
                if self.accept_kw("IF"):
                    self.accept_kw("NOT")    # ATTACH TABLE IF NOT EXISTS
                    self.expect_kw("EXISTS")
                    if_exists = True
                db, tbl = self.parse_table_name()
                if self.tok.kind == "end" or self.tok.text == ";":
                    return ast.DetachAttach("attach", db, tbl, if_exists)
            self.i = save
            return self.parse_create()
        if t.is_kw("KILL"):
            self.advance()
            self.expect_kw("QUERY")
            self.expect_kw("WHERE")
            cond = self.parse_expr()
            sync = bool(self.accept_kw("SYNC"))
            self.accept_kw("ASYNC")
            return ast.KillQuery(cond, sync)
        if t.is_kw("CREATE") or t.is_kw("REPLACE"):
            return self.parse_create()
        if t.is_kw("INSERT"):
            return self.parse_insert()
        if t.is_kw("DROP"):
            return self.parse_drop()
        if t.is_kw("TRUNCATE"):
            return self.parse_truncate()
        if t.is_kw("OPTIMIZE"):
            self.advance()
            self.expect_kw("TABLE")
            db, tbl = self.parse_table_name()
            self._accept_on_cluster()
            if self.accept_kw("PARTITION"):
                if not self.accept_kw("ID"):
                    self.parse_expr()
                else:
                    self.advance()           # PARTITION ID 'str'
            final = bool(self.accept_kw("FINAL"))
            self.accept_kw("CLEANUP")        # replacing-merge cleanup pass
            if self.accept_kw("DEDUPLICATE"):
                if self.accept_kw("BY"):
                    self.parse_expr()
                    while self.accept_op(","):
                        self.parse_expr()
            if self.accept_kw("SETTINGS"):
                self.parse_settings_list()
            return ast.OptimizeTable(db, tbl, final)
        if t.is_kw("ALTER"):
            return self.parse_alter()
        if t.is_kw("GRANT", "REVOKE"):
            return self.parse_grant()
        if t.is_kw("BACKUP", "RESTORE"):
            kind = self.advance().text.lower()
            self.expect_kw("TABLE")
            db, tbl = self.parse_table_name()
            self.expect_kw("TO" if kind == "backup" else "FROM")
            pt = self.tok
            if pt.kind == "word" and pt.text.lower() == "disk":
                # Disk('name', 'path') target (reference: BackupFactory
                # engine syntax, src/Backups/registerBackupEnginesFileAndDisk)
                self.advance()
                self.expect_op("(")
                dn = self.tok
                if dn.kind != "string":
                    raise ParseError("Disk() expects a quoted disk name")
                self.advance()
                self.expect_op(",")
                dp = self.tok
                if dp.kind != "string":
                    raise ParseError("Disk() expects a quoted path")
                self.advance()
                self.expect_op(")")
                return ast.BackupRestore(kind, db, tbl, dp.text,
                                         disk=dn.text)
            if pt.kind != "string":
                raise ParseError("BACKUP/RESTORE expects a string path "
                                 "or Disk('name', 'path')")
            self.advance()
            return ast.BackupRestore(kind, db, tbl, pt.text)
        if t.is_kw("SHOW"):
            return self.parse_show()
        if t.is_kw("DESCRIBE", "DESC"):
            self.advance()
            self.accept_kw("TABLE")
            te = self.parse_table_expression()
            if isinstance(te, ast.TableRef):
                d = ast.Describe(te.database, te.table)
            else:
                d = ast.Describe(None, "", table_expr=te)
            if self.accept_kw("SETTINGS"):
                self.parse_settings_list()
            if self.accept_kw("FORMAT"):
                self.expect_word()
            return d
        if t.is_kw("RENAME", "EXCHANGE"):
            exchange = t.text.upper() == "EXCHANGE"
            self.advance()
            self.expect_kw("TABLE", "TABLES", "DICTIONARY")
            pairs = []
            while True:
                a = self.parse_table_name()
                self.expect_kw("AND" if exchange else "TO")
                b = self.parse_table_name()
                pairs.append((a, b))
                if not self.accept_op(","):
                    break
            cl = self._accept_on_cluster()
            return ast.RenameTable(pairs, exchange, cluster=cl)
        if t.is_kw("SET"):
            return self.parse_set()
        if t.is_kw("USE"):
            self.advance()
            return ast.Use(self.expect_word())
        if t.is_kw("SYSTEM"):
            words = [self.advance().text]
            while self.tok.kind in ("word", "number", "string") \
                    or (self.tok.kind == "op"
                        and self.tok.text in (".", ",", "=", "'")):
                words.append(self.advance().text)
            return ast.SystemCommand(" ".join(words[1:]))
        if t.is_kw("DELETE"):
            # lightweight DELETE FROM t WHERE p -> the mutation machinery
            # (ref: src/Interpreters/InterpreterDeleteQuery.cpp)
            self.advance()
            self.expect_kw("FROM")
            db, tbl = self.parse_table_name()
            self._accept_on_cluster()
            if self.accept_kw("IN"):
                self.expect_kw("PARTITION")
                self._parse_partition_ref()
            self.expect_kw("WHERE")
            pred = self.parse_expr()
            self._ddl_tail()
            return ast.AlterTable(db, tbl, "delete", predicate=pred)
        if t.is_kw("CHECK"):
            self.advance()
            self.expect_kw("TABLE")
            db, tbl = self.parse_table_name()
            if self.accept_kw("PARTITION"):
                if self.accept_kw("ID"):
                    self.advance()
                else:
                    self.parse_expr()
            if self.accept_kw("PART"):
                self.advance()
            if self.accept_kw("SETTINGS"):
                self.parse_settings_list()
            self._ddl_tail()
            # CHECK TABLE result contract: 1 = healthy (parts are
            # checksummed on write; reads verify — InterpreterCheckQuery)
            return ast.CheckTable(db, tbl)
        if t.is_kw("EXISTS"):
            self.advance()
            self.accept_kw("TEMPORARY")
            self.accept_kw("TABLE", "VIEW", "DICTIONARY", "DATABASE")
            db, tbl = self.parse_table_name()
            self._ddl_tail()
            return ast.ExistsTable(db, tbl)
        if t.is_kw("BEGIN", "COMMIT", "ROLLBACK"):
            words = []
            while self.tok.kind == "word":
                words.append(self.advance().text)
            return ast.SystemCommand("txn " + " ".join(words))
        if t.is_kw("UNDROP"):
            self.advance()
            self.expect_kw("TABLE")
            db, tbl = self.parse_table_name()
            self._ddl_tail()
            return ast.SystemCommand(f"undrop {tbl}")
        if t.kind == "op" and t.text == "(":
            return self.parse_select_union()
        raise ParseError(f"Unknown statement start {t.text!r} at {t.pos}")

    def parse_select_union(self):
        left = self._parse_intersect_chain()
        while True:
            if self.accept_kw("UNION"):
                mode = "all"
                explicit = True
                if self.accept_kw("DISTINCT"):
                    mode = "distinct"
                elif not self.accept_kw("ALL"):
                    explicit = False   # bare UNION: DISTINCT in recursion
                right = self._parse_intersect_chain()
                # flatten consecutive same-mode unions
                if isinstance(left, ast.Union) and left.mode == mode:
                    left.selects.append(right)
                    if not explicit:
                        left.mode_explicit = False
                else:
                    left = ast.Union([left, right], mode, explicit)
            elif self.accept_kw("EXCEPT"):
                distinct = bool(self.accept_kw("DISTINCT"))
                self.accept_kw("ALL")
                right = self._parse_intersect_chain()
                left = ast.SetOp(left, right, "except", distinct)
            else:
                return left

    def _parse_select_or_parens(self):
        """SELECT ..., or a parenthesized (SELECT ... [UNION ...]) branch
        (reference: ParserUnionQueryElement accepts subquery elements)."""
        if self.tok.kind == "op" and self.tok.text == "(":
            nxt = self.tokens[self.i + 1]
            if nxt.is_kw("SELECT", "WITH") \
                    or (nxt.kind == "op" and nxt.text == "("):
                self.expect_op("(")
                q = self.parse_select_union()
                self.expect_op(")")
                return q
        return self.parse_select()

    def _parse_intersect_chain(self):
        left = self._parse_select_or_parens()
        while self.accept_kw("INTERSECT"):
            distinct = bool(self.accept_kw("DISTINCT"))
            self.accept_kw("ALL")
            right = self._parse_select_or_parens()
            left = ast.SetOp(left, right, "intersect", distinct)
        return left

    def parse_select(self) -> ast.Select:
        ctes: List[ast.CTE] = []
        if self.accept_kw("WITH"):
            recursive = bool(self.accept_kw("RECURSIVE"))
            while True:
                cte = self.parse_cte()
                cte.recursive = recursive and cte.query is not None
                ctes.append(cte)
                if not self.accept_op(","):
                    break
        self.expect_kw("SELECT")
        distinct = bool(self.accept_kw("DISTINCT"))
        items = [self.parse_select_item()]
        while self.accept_op(","):
            items.append(self.parse_select_item())

        sel = ast.Select(items=items, distinct=distinct, ctes=ctes)

        if self.accept_kw("FROM"):
            sel.from_ = self.parse_table_expression()
            while True:
                # comma-separated table list = CROSS JOIN (reference:
                # ParserTablesInSelectQuery comma element)
                if self.accept_op(","):
                    sel.joins.append(ast.Join(
                        "cross", "all", self.parse_table_expression()))
                    continue
                if sel.array_join is None:
                    aj = self._try_parse_array_join()
                    if aj is not None:
                        sel.array_join = aj
                        continue
                join = self.try_parse_join()
                if join is None:
                    break
                sel.joins.append(join)
        if self.accept_kw("PREWHERE"):
            sel.prewhere = self.parse_expr()
        if self.accept_kw("WHERE"):
            sel.where = self.parse_expr()
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            if self.tok.is_kw("GROUPING") \
                    and self.tokens[self.i + 1].is_kw("SETS"):
                self.advance()
                self.advance()
                self.expect_op("(")
                sets: list = []
                while True:
                    exprs = []
                    if self.accept_op("("):
                        if not self.accept_op(")"):
                            exprs.append(self.parse_expr())
                            while self.accept_op(","):
                                exprs.append(self.parse_expr())
                            self.expect_op(")")
                    else:
                        exprs.append(self.parse_expr())
                    sets.append(exprs)
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                sel.group_by_modifier = "grouping_sets"
                sel.grouping_sets = sets
                # keys = union of all set expressions, first-appearance order
                seen: set = set()
                sel.group_by = []
                for st in sets:
                    for e in st:
                        k = ast.format_expr(e)
                        if k not in seen:
                            seen.add(k)
                            sel.group_by.append(e)
                if not sel.group_by:
                    raise ParseError("GROUPING SETS needs at least one key")
                if self.accept_kw("WITH"):
                    self.expect_kw("TOTALS")
                    sel.group_by_with_totals = True
            else:
                mod = self.accept_kw("ROLLUP", "CUBE")
                if mod:
                    sel.group_by_modifier = mod.text.lower()
                    self.expect_op("(")
                    sel.group_by = [self.parse_expr()]
                    while self.accept_op(","):
                        sel.group_by.append(self.parse_expr())
                    self.expect_op(")")
                else:
                    sel.group_by = [self._parse_expr_alias()]
                    while self.accept_op(","):
                        sel.group_by.append(self._parse_expr_alias())
                while self.accept_kw("WITH"):
                    kw = self.expect_kw("TOTALS", "ROLLUP", "CUBE")
                    if kw.text.upper() == "TOTALS":
                        sel.group_by_with_totals = True
                    else:
                        sel.group_by_modifier = kw.text.lower()
        # WITH TOTALS may ride without GROUP BY (implicit all-row group)
        if self.tok.is_kw("WITH") and self.tokens[self.i + 1].is_kw("TOTALS"):
            self.advance()
            self.advance()
            sel.group_by_with_totals = True
        if self.accept_kw("HAVING"):
            sel.having = self.parse_expr()
        if self.accept_kw("WINDOW"):
            # WINDOW w AS (spec) [, w2 AS (spec)] named windows
            while True:
                wname = self.expect_word()
                self.expect_kw("AS")
                sel.windows[wname] = self.parse_window_spec()
                if not self.accept_op(","):
                    break
            _resolve_named_windows(sel)
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            nxt = self.tokens[self.i + 1]
            if self.tok.is_kw("ALL") and not (
                    nxt.kind == "op" and nxt.text in ("(", ".", "[")):
                self.advance()
                sel.order_by = [ast.OrderItem(ast.Identifier("__order_all__"))]
            else:
                sel.order_by = [self.parse_order_item()]
                while self.accept_op(","):
                    sel.order_by.append(self.parse_order_item())
        if sel.order_by and self.accept_kw("INTERPOLATE"):
            # INTERPOLATE [( col [AS expr], ... )] — WITH FILL companion
            interp: list = []
            if self.accept_op("("):
                if not self.accept_op(")"):
                    while True:
                        nm = self.expect_word()
                        ie = None
                        if self.accept_kw("AS"):
                            ie = self.parse_expr()
                        interp.append((nm, ie))
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
            sel.interpolate = interp
        if self.accept_kw("LIMIT"):
            first = self.parse_expr()
            if self.accept_op(","):
                sel.offset = first
                sel.limit = self.parse_expr()
            elif self.accept_kw("BY"):
                by = [self.parse_expr()]
                while self.accept_op(","):
                    by.append(self.parse_expr())
                sel.limit_by = (first, by)
                if self.accept_kw("LIMIT"):
                    sel.limit = self.parse_expr()
                    if self.accept_kw("OFFSET"):
                        sel.offset = self.parse_expr()
            else:
                sel.limit = first
                if self.tok.is_kw("WITH") \
                        and self.tokens[self.i + 1].is_kw("TIES"):
                    self.advance()
                    self.advance()
                    sel.limit_with_ties = True
                if self.accept_kw("OFFSET"):
                    sel.offset = self.parse_expr()
        elif self.accept_kw("OFFSET"):
            # SQL-standard OFFSET n ROWS [FETCH FIRST|NEXT n ROWS ONLY]
            sel.offset = self.parse_expr()
            self.accept_kw("ROW", "ROWS")
            if self.accept_kw("FETCH"):
                self.accept_kw("FIRST")
                self.accept_kw("NEXT")
                sel.limit = self.parse_expr()
                self.accept_kw("ROW", "ROWS")
                if self.accept_kw("ONLY"):
                    pass
                elif self.accept_kw("WITH"):
                    self.expect_kw("TIES")
                    sel.limit_with_ties = True
        if self.accept_kw("SETTINGS"):
            sel.settings = self.parse_settings_list()
        if self.accept_kw("INTO"):
            self.expect_kw("OUTFILE")
            t = self.tok
            if t.kind != "string":
                raise ParseError("INTO OUTFILE expects a string path")
            sel.outfile = self.advance().text
        if self.accept_kw("FORMAT"):
            sel.format = self.expect_word()
        if self.accept_kw("SETTINGS") and not sel.settings:
            sel.settings = self.parse_settings_list()
        return sel

    def parse_cte(self) -> ast.CTE:
        # Two forms: `name AS (SELECT ...)` and `expr AS name`
        save = self.i
        if self.tok.kind == "word" and not self.tok.is_kw(*RESERVED):
            name = self.advance().text
            if self.accept_kw("AS"):
                if self.tok.kind == "op" and self.tok.text == "(":
                    self.expect_op("(")
                    q = self.parse_select_union()
                    self.expect_op(")")
                    return ast.CTE(name=name, query=q)
            self.i = save
        expr = self.parse_expr()
        self.expect_kw("AS")
        name = self.expect_word()
        return ast.CTE(name=name, expr=expr)

    def parse_select_item(self) -> ast.SelectItem:
        expr = self.parse_expr()
        alias = self.try_parse_alias()
        return ast.SelectItem(expr, alias)

    def try_parse_alias(self) -> Optional[str]:
        if self.accept_kw("AS"):
            return self.expect_word()
        t = self.tok
        if t.kind == "word" and not t.is_kw(*RESERVED):
            return self.advance().text
        return None

    def parse_order_item(self) -> ast.OrderItem:
        e = self.parse_expr()
        collate = None
        if self.accept_kw("COLLATE"):
            t = self.tok
            if t.kind != "string":
                raise ParseError("COLLATE expects a string locale")
            collate = self.advance().text
        desc = False
        if self.accept_kw("DESC", "DESCENDING"):
            desc = True
        elif self.accept_kw("ASC", "ASCENDING"):
            desc = False
        if collate is None and self.accept_kw("COLLATE"):
            t = self.tok
            if t.kind != "string":
                raise ParseError("COLLATE expects a string locale")
            collate = self.advance().text
        nulls_last = None
        if self.accept_kw("NULLS"):
            kw = self.expect_kw("FIRST", "LAST")
            nulls_last = kw.text.upper() == "LAST"
        fill = None
        if self.tok.is_kw("WITH") and self.tokens[self.i + 1].is_kw("FILL"):
            self.advance()
            self.expect_kw("FILL")
            f_from = f_to = f_step = None
            while True:
                if self.accept_kw("FROM"):
                    f_from = self.parse_expr()
                elif self.accept_kw("TO"):
                    f_to = self.parse_expr()
                elif self.accept_kw("STEP"):
                    f_step = self.parse_expr()
                elif self.accept_kw("STALENESS"):
                    self.parse_expr()
                else:
                    break
            fill = (f_from, f_to, f_step)
        return ast.OrderItem(e, desc, nulls_last, fill)

    def parse_table_name(self) -> Tuple[Optional[str], str]:
        a = self.expect_word()
        if self.accept_op("."):
            return a, self.expect_word()
        return None, a

    def parse_table_expression(self):
        if self.tok.kind == "op" and self.tok.text == "(":
            self.expect_op("(")
            if self.tok.is_kw("EXPLAIN"):
                q = self.parse_explain()
            else:
                q = self.parse_select_union()
            self.expect_op(")")
            alias = self.try_parse_alias()
            return ast.SubqueryRef(q, alias)
        if self.tok.is_kw("VIEW") \
                and self.tokens[self.i + 1].kind == "op" \
                and self.tokens[self.i + 1].text == "(":
            # view(SELECT ...) table function: an inline subquery
            # (reference: src/TableFunctions/TableFunctionView.cpp)
            self.advance()
            self.expect_op("(")
            q = self.parse_select_union()
            self.expect_op(")")
            return ast.SubqueryRef(q, self.try_parse_alias())
        db, name = self.parse_table_name()
        if self.tok.kind == "op" and self.tok.text == "(" and db is None:
            # table function: numbers(10), file('x.parquet')
            self.expect_op("(")
            args = []
            if not (self.tok.kind == "op" and self.tok.text == ")"):
                args.append(self.parse_expr())
                while self.accept_op(","):
                    args.append(self.parse_expr())
            self.expect_op(")")
            alias = None
            if not self.tok.is_kw("FINAL", "SAMPLE"):
                alias = self.try_parse_alias()
            # tolerate FINAL / SAMPLE r on table functions: parsed, and the
            # engine raises/ignores per-source (merge() SAMPLE is a typed
            # error in the reference, covered by expects-error cases)
            self.accept_kw("FINAL")
            if self.accept_kw("SAMPLE"):
                if self.tok.kind == "number":
                    self.advance()
                    if self.accept_op("/") and self.tok.kind == "number":
                        self.advance()
            return ast.TableFunctionRef(ast.FuncCall(name, args), alias)
        alias = None
        final = False
        if self.accept_kw("FINAL"):
            final = True
        else:
            alias = self.try_parse_alias()
            if self.accept_kw("FINAL"):
                final = True
        sample = None
        if self.accept_kw("SAMPLE"):
            t = self.tok
            if t.kind != "number":
                raise ParseError("SAMPLE expects a numeric ratio")
            self.advance()
            sample = float(_parse_number(t.text))
            if self.accept_op("/"):
                d = self.tok
                if d.kind != "number":
                    raise ParseError("SAMPLE a/b expects numbers")
                self.advance()
                sample = sample / float(_parse_number(d.text))
        return ast.TableRef(db, name, alias, final, sample)

    def _try_parse_array_join(self) -> Optional[tuple]:
        """[LEFT|INNER] ARRAY JOIN e [AS a], ... ->
        ('left'|'inner', [(expr, alias|None), ...])
        (ref: ParserArrayJoin, src/Parsers/ParserTablesInSelectQuery.cpp)."""
        save = self.i
        kind = "inner"
        if self.accept_kw("LEFT"):
            kind = "left"
        elif self.accept_kw("INNER"):
            kind = "inner"
        if not (self.accept_kw("ARRAY")
                and self.accept_kw("JOIN")):
            self.i = save
            return None
        items = []
        while True:
            e = self.parse_expr()
            alias = None
            if self.accept_kw("AS"):
                alias = self.expect_word()
            else:
                t = self.tok
                if t.kind == "word" and not t.is_kw(*RESERVED):
                    alias = self.advance().text
            items.append((e, alias))
            if not self.accept_op(","):
                break
        return (kind, items)

    def try_parse_join(self) -> Optional[ast.Join]:
        save = self.i
        is_global = bool(self.accept_kw("GLOBAL"))
        strictness = "all"
        if self.accept_kw("ANY"):
            strictness = "any"
        elif self.accept_kw("SEMI"):
            strictness = "semi"
        elif self.accept_kw("ANTI"):
            strictness = "anti"
        elif self.accept_kw("ASOF"):
            strictness = "asof"
        elif self.accept_kw("ALL"):
            strictness = "all"
        kind = None
        if self.accept_kw("INNER"):
            kind = "inner"
        elif self.accept_kw("LEFT"):
            kind = "left"
            self.accept_kw("OUTER")
        elif self.accept_kw("RIGHT"):
            kind = "right"
            self.accept_kw("OUTER")
        elif self.accept_kw("FULL"):
            kind = "full"
            self.accept_kw("OUTER")
        elif self.accept_kw("CROSS"):
            kind = "cross"
        # strictness may also follow the kind: LEFT SEMI JOIN, LEFT ANY JOIN
        # (the reference's documented order, ParserJoin)
        if strictness == "all" and kind in ("left", "right", "inner"):
            if self.accept_kw("SEMI"):
                strictness = "semi"
            elif self.accept_kw("ANTI"):
                strictness = "anti"
            elif self.accept_kw("ANY"):
                strictness = "any"
            elif self.accept_kw("ASOF"):
                strictness = "asof"
        if not self.accept_kw("JOIN"):
            if kind is None and strictness == "all" and not is_global:
                self.i = save
                return None
            if self.tok.is_kw("JOIN"):
                self.advance()
            else:
                self.i = save
                return None
        if kind is None:
            kind = "inner"
        table = self.parse_table_expression()
        on = None
        using = None
        if self.accept_kw("ON"):
            on = self.parse_expr()
        elif self.accept_kw("USING"):
            paren = self.accept_op("(")
            using = [self.expect_word()]
            while self.accept_op(","):
                using.append(self.expect_word())
            if paren:
                self.expect_op(")")
        return ast.Join(kind, strictness, table, on, using, is_global)

    def parse_settings_list(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        while True:
            name = self.expect_word()
            self.expect_op("=")
            out[name] = self.parse_setting_value()
            if not self.accept_op(","):
                break
        return out

    def parse_setting_value(self):
        t = self.tok
        if t.kind == "number":
            self.advance()
            return _parse_number(t.text)
        if t.kind == "string":
            self.advance()
            return t.text
        if t.kind == "word":
            self.advance()
            return t.text
        raise ParseError(f"Bad setting value at {t.pos}")

    # -- DDL/DML -------------------------------------------------------------
    def parse_create(self):
        lead = self.advance()  # CREATE/ATTACH/REPLACE
        or_replace = lead.text.upper() == "REPLACE"
        if self.accept_kw("OR"):        # CREATE OR REPLACE <anything>
            self.expect_kw("REPLACE")
            or_replace = True
        if self.accept_kw("USER"):
            ine = self._if_not_exists()
            name = self.expect_word()
            pwd = None
            if self.accept_kw("IDENTIFIED"):
                self.accept_kw("WITH")
                self.accept_kw("PLAINTEXT_PASSWORD")
                self.expect_kw("BY")
                t = self.tok
                if t.kind != "string":
                    raise ParseError("IDENTIFIED BY expects a string")
                pwd = self.advance().text
            return ast.CreateUser(name, pwd, ine)
        if self.accept_kw("DATABASE"):
            ine = self._if_not_exists()
            name = self.expect_word()
            cluster = self._accept_on_cluster()
            engine = None
            eargs: List[str] = []
            if self.accept_kw("ENGINE"):
                self.accept_op("=")
                engine = self.expect_word()
                if self.tok.kind == "op" and self.tok.text == "(":
                    eargs = [a for a in self._parse_engine_args()
                             if isinstance(a, str)]
            if self.accept_kw("COMMENT") and self.tok.kind == "string":
                self.advance()
            if self.accept_kw("SETTINGS"):
                self.parse_settings_list()
            cd = ast.CreateDatabase(name, ine, engine, cluster)
            cd.engine_args = eargs
            return cd
        if self.accept_kw("FUNCTION"):
            ine = self._if_not_exists()
            name = self.expect_word()
            self._accept_on_cluster()
            self.expect_kw("AS")
            body = self.parse_expr()
            params: List[str] = []
            if isinstance(body, ast.Lambda):
                params, body = body.params, body.body
            return ast.CreateFunction(name, params, body, or_replace, ine)
        if self.accept_kw("ROLE"):
            ine = self._if_not_exists()
            return ast.CreateRole(self.expect_word(), ine)
        if self.accept_kw("QUOTA"):
            ine = self._if_not_exists()
            name = self.expect_word()
            duration_s, maxes, users = 3600, {}, []
            if self.accept_kw("FOR"):
                self.accept_kw("RANDOMIZED")
                self.expect_kw("INTERVAL")
                amount = int(self.advance().text)
                unit = self.expect_word().lower().rstrip("s")
                mult = {"second": 1, "minute": 60, "hour": 3600,
                        "day": 86400, "week": 604800}.get(unit, 1)
                duration_s = amount * mult
            if self.accept_kw("MAX"):
                while True:
                    key = self.expect_word().lower()
                    self.expect_op("=")
                    maxes[key] = int(self.advance().text)
                    if not self.accept_op(","):
                        break
            if self.accept_kw("TO"):
                if not self.accept_kw("ALL"):
                    users.append(self.expect_word())
                    while self.accept_op(","):
                        users.append(self.expect_word())
            return ast.CreateQuota(name, duration_s, maxes, users, ine)
        if self.tok.is_kw("ROW"):
            save = self.i
            self.advance()
            if not self.accept_kw("POLICY"):
                self.i = save
            else:
                ine = self._if_not_exists()
                name = self.expect_word()
                self.expect_kw("ON")
                db, tbl = self.parse_table_name()
                self.expect_kw("USING")
                using = self.parse_expr()
                users = []
                if self.accept_kw("TO"):
                    if not self.accept_kw("ALL"):
                        users.append(self.expect_word())
                        while self.accept_op(","):
                            users.append(self.expect_word())
                return ast.CreateRowPolicy(name, db, tbl,
                                           ast.format_expr(using), users,
                                           ine)
        if self.accept_kw("DICTIONARY"):
            self._if_not_exists()
            db, name = self.parse_table_name()
            self._accept_on_cluster()
            cols = []
            if self.accept_op("("):
                while True:
                    cname = self.expect_word()
                    ctype = self.parse_type_name()
                    while True:      # attribute tail (DictionaryAttribute)
                        if self.accept_kw("DEFAULT", "EXPRESSION"):
                            self.parse_expr()
                        elif self.accept_kw("HIERARCHICAL", "INJECTIVE",
                                            "IS_OBJECT_ID"):
                            pass
                        else:
                            break
                    cols.append(ast.ColumnDef(cname, ctype))
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            pk = None
            src_table = None
            while self.tok.kind == "word":
                if self.accept_kw("PRIMARY"):
                    self.expect_kw("KEY")
                    paren = self.accept_op("(")
                    pk = self.expect_word()
                    while self.accept_op(","):
                        self.expect_word()   # composite keys: first wins
                    if paren:
                        self.expect_op(")")
                elif self.accept_kw("COMMENT"):
                    if self.tok.kind == "string":
                        self.advance()
                elif self.tok.is_kw("SOURCE", "LAYOUT", "LIFETIME",
                                    "RANGE", "SETTINGS"):
                    self.advance()
                    # skim the parenthesized block, remembering any string
                    # or TABLE ident (the source table name)
                    depth = 0
                    prev_word = ""
                    first_str = None
                    saw_table_kw = False
                    while True:
                        t = self.advance()
                        if t.kind == "op" and t.text == "(":
                            depth += 1
                        elif t.kind == "op" and t.text == ")":
                            depth -= 1
                            if depth == 0:
                                break
                        elif t.kind == "string":
                            if first_str is None:
                                first_str = t.text
                            if prev_word.upper() == "TABLE":
                                src_table = t.text
                        if t.kind == "word":
                            prev_word = t.text
                            if t.text.upper() == "TABLE":
                                saw_table_kw = True
                    # the source table is the string after TABLE; only a
                    # TABLE-less source falls back to its first string
                    if src_table is None and not saw_table_kw \
                            and first_str is not None:
                        src_table = first_str
                else:
                    break
            return ast.CreateDictionary(db, name, cols, pk, src_table)
        temporary = bool(self.accept_kw("TEMPORARY"))
        materialized = bool(self.accept_kw("MATERIALIZED"))
        if self.accept_kw("VIEW"):
            ine = self._if_not_exists()
            db, name = self.parse_table_name()
            if self.accept_kw("UUID"):
                if self.tok.kind == "string":
                    self.advance()           # explicit UUID: ignored
            view_cluster = self._accept_on_cluster()
            to_table = None
            if self.accept_kw("TO"):
                _, to_table = self.parse_table_name()
                if self.accept_kw("UUID") and self.tok.kind == "string":
                    self.advance()
            if self.tok.kind == "op" and self.tok.text == "(":
                # explicit column list: types come from the SELECT — the
                # declared names/types are accepted and skimmed
                self._skim_parens()
            # tolerate storage clauses on materialized views: ENGINE [=]
            # X[(args)], ORDER/PARTITION BY, TTL, SETTINGS, POPULATE
            populate = False
            while True:
                if self.accept_kw("ENGINE"):
                    self.accept_op("=")
                    self.expect_word()
                    if self.tok.kind == "op" and self.tok.text == "(":
                        self._skim_parens()
                elif self.accept_kw("ORDER", "PARTITION", "SAMPLE",
                                    "PRIMARY"):
                    self.expect_kw("BY", "KEY")
                    self._parse_key_list()
                elif self.accept_kw("TTL"):
                    self.parse_expr()
                elif self.accept_kw("SETTINGS"):
                    self.parse_settings_list()
                elif self.accept_kw("POPULATE"):
                    populate = True
                elif self.accept_kw("DEFINER"):
                    self.accept_op("=")
                    self.expect_word()
                elif self.accept_kw("SQL"):
                    self.expect_kw("SECURITY")
                    self.expect_word()
                else:
                    break
            self.expect_kw("AS")
            q = self.parse_select_union()
            return ast.CreateView(db, name, q, materialized, to_table, ine,
                                  cluster=view_cluster, populate=populate)
        self.expect_kw("TABLE")
        ine = self._if_not_exists()
        db, tbl = self.parse_table_name()
        cluster = self._accept_on_cluster()
        cols: List[ast.ColumnDef] = []
        ct_projections: List[tuple] = []
        ct_indexes: List[ast.IndexDef] = []
        ct_constraints: List[tuple] = []
        ct_primary: Optional[List[ast.Expr]] = None
        if self.accept_op("("):
            while True:
                if self.accept_kw("CONSTRAINT"):
                    cn = self.expect_word()
                    self.expect_kw("CHECK", "ASSUME")
                    ct_constraints.append((cn, self.parse_expr()))
                    if not self.accept_op(","):
                        break
                    continue
                if self.tok.is_kw("PRIMARY") \
                        and self.tokens[self.i + 1].is_kw("KEY"):
                    self.advance()
                    self.advance()
                    ct_primary = self._parse_key_list()
                    if not self.accept_op(","):
                        break
                    continue
                if self.accept_kw("PROJECTION"):
                    pname = self.expect_word()
                    self.expect_op("(")
                    psel = self.parse_select_union()
                    self.expect_op(")")
                    ct_projections.append((pname, psel))
                    if not self.accept_op(","):
                        break
                    continue
                if self.accept_kw("INDEX"):
                    # skip index: INDEX name expr TYPE kind(...) GRANULARITY n
                    iname = self.expect_word()
                    iexpr = self.parse_expr()
                    self.expect_kw("TYPE")
                    ikind = self.expect_word()
                    iparams: List = []
                    if self.tok.kind == "op" and self.tok.text == "(":
                        self.advance()
                        while not (self.tok.kind == "op"
                                   and self.tok.text == ")"):
                            if self.tok.kind in ("number", "string"):
                                iparams.append(
                                    _parse_number(self.tok.text)
                                    if self.tok.kind == "number"
                                    else self.tok.text)
                            self.advance()
                        self.expect_op(")")
                    igran = 1
                    if self.accept_kw("GRANULARITY"):
                        g = self.parse_expr()
                        if isinstance(g, ast.Literal) \
                                and isinstance(g.value, int):
                            igran = g.value
                    ct_indexes.append(ast.IndexDef(
                        iname, iexpr, ikind.lower(), iparams, igran))
                    if not self.accept_op(","):
                        break
                    continue
                cname = self._column_name()
                # type is optional when DEFAULT/ALIAS/MATERIALIZED follows
                # (`c ALIAS a + b` — type inferred from the expression)
                if self.tok.is_kw("DEFAULT", "MATERIALIZED", "ALIAS",
                                  "EPHEMERAL"):
                    ctype = ""
                else:
                    ctype = self.parse_type_name()
                    # INT NULL / NOT NULL nullability suffix
                    if self.accept_kw("NOT"):
                        self.expect_kw("NULL")
                    elif self.tok.is_kw("NULL"):
                        self.advance()
                        ctype = f"Nullable({ctype})"
                default = None
                default_kind = "default"
                kindtok = self.accept_kw("DEFAULT", "MATERIALIZED",
                                         "ALIAS", "EPHEMERAL")
                if kindtok is not None:
                    default_kind = kindtok.text.lower()
                    if default_kind == "ephemeral" and (
                            self.tok.kind == "op"
                            or self.tok.is_kw(*RESERVED) or ctype):
                        default = None       # bare EPHEMERAL
                    else:
                        default = self.parse_expr()
                    # trailing nullability after the default: INT DEFAULT
                    # 1 NULL / NOT NULL
                    if self.accept_kw("NOT"):
                        self.expect_kw("NULL")
                    elif self.tok.is_kw("NULL"):
                        self.advance()
                        if ctype:
                            ctype = f"Nullable({ctype})"
                if self.accept_kw("STATISTICS") \
                        and self.tok.kind == "op" and self.tok.text == "(":
                    self._skim_parens()
                if self.accept_kw("SETTINGS") \
                        and self.tok.kind == "op" and self.tok.text == "(":
                    self._skim_parens()   # per-column setting overrides
                codec = None
                if self.accept_kw("CODEC") and self.tok.kind == "op" \
                        and self.tok.text == "(":
                    depth, names = 0, []
                    while True:
                        t = self.tok
                        if t.kind == "op" and t.text == "(":
                            depth += 1
                            self.advance()
                        elif t.kind == "op" and t.text == ")":
                            depth -= 1
                            self.advance()
                            if depth == 0:
                                break
                        else:
                            if t.kind == "word" and depth == 1:
                                names.append(t.text)
                            self.advance()
                    codec = ", ".join(names) if names else None
                elif self.tok.kind == "op" and self.tok.text == "(":
                    self._skim_parens()
                if self.accept_kw("TTL"):
                    self.parse_expr()
                if self.accept_kw("COMMENT") and self.tok.kind == "string":
                    self.advance()
                if self.accept_kw("PRIMARY"):
                    self.expect_kw("KEY")
                cols.append(ast.ColumnDef(cname, ctype, default,
                                          codec=codec,
                                          default_kind=default_kind))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        ct = ast.CreateTable(db, tbl, cols, if_not_exists=ine)
        ct.projections = ct_projections
        ct.indexes = ct_indexes
        ct.constraints = ct_constraints
        if ct_primary is not None:
            ct.primary_key = ct_primary
            if ct.order_by is None:
                ct.order_by = list(ct_primary)
        ct.cluster = cluster
        ct.or_replace = or_replace
        # CREATE TABLE x AS other_table / AS table_function(...) — the AS
        # source may precede the ENGINE clause (ParserCreateQuery)
        if not cols and self.accept_kw("AS"):
            if not self.tok.is_kw("SELECT", "WITH") and \
                    self.tok.kind == "word":
                self._parse_as_source(ct)
            else:
                ct.as_select = self.parse_select_union()
        if temporary:
            ct.engine = "Memory"
        if self.accept_kw("ENGINE"):
            self.accept_op("=")          # ENGINE MergeTree == ENGINE = ...
            ct.engine = self.expect_word()
            if self.tok.kind == "op" and self.tok.text == "(":
                ct.engine_args = self._parse_engine_args()
        while True:
            if self.accept_kw("ORDER"):
                self.expect_kw("BY")
                ct.order_by = self._parse_key_list()
            elif self.accept_kw("PARTITION"):
                self.expect_kw("BY")
                ct.partition_by = self.parse_expr()
            elif self.accept_kw("PRIMARY"):
                self.expect_kw("KEY")
                ct.primary_key = self._parse_key_list()
            elif self.accept_kw("SAMPLE"):
                self.expect_kw("BY")
                ct.sample_by = self.parse_expr()
            elif self.accept_kw("TTL"):
                ct.ttl = ast.format_expr(self.parse_expr())
                # TTL modifiers (DELETE / TO DISK|VOLUME / WHERE / GROUP BY
                # ... SET / recompression) parse and are retained as text
                # where the delete machinery can honor them
                while True:
                    if self.accept_kw("DELETE"):
                        continue
                    if self.accept_kw("TO"):
                        self.expect_kw("DISK", "VOLUME")
                        self.advance()
                        continue
                    if self.accept_kw("WHERE"):
                        ct.ttl_where = ast.format_expr(self.parse_expr())
                        continue
                    if self.tok.is_kw("GROUP") \
                            and self.tokens[self.i + 1].is_kw("BY"):
                        self.advance()
                        self.advance()
                        self._parse_key_list()
                        if self.accept_kw("SET"):
                            while True:
                                self.expect_word()
                                self.expect_op("=")
                                self.parse_expr()
                                if not self.accept_op(","):
                                    break
                        continue
                    if self.accept_op(","):
                        self.parse_expr()     # secondary TTL expression
                        continue
                    break
            elif self.accept_kw("COMMENT"):
                if self.tok.kind == "string":
                    self.advance()
            elif self.accept_kw("SETTINGS"):
                ct.settings = self.parse_settings_list()
            else:
                break
        if self.accept_kw("AS"):
            if not self.tok.is_kw("SELECT", "WITH") and \
                    self.tok.kind == "word" and ct.as_table is None \
                    and ct.as_table_function is None:
                self._parse_as_source(ct)
            else:
                ct.as_select = self.parse_select_union()
        # storage clauses may also FOLLOW the AS source
        while True:
            if self.accept_kw("ENGINE"):
                self.accept_op("=")
                ct.engine = self.expect_word()
                if self.tok.kind == "op" and self.tok.text == "(":
                    ct.engine_args = self._parse_engine_args()
            elif self.accept_kw("ORDER"):
                self.expect_kw("BY")
                ct.order_by = self._parse_key_list()
            elif self.accept_kw("SETTINGS"):
                ct.settings = self.parse_settings_list()
            else:
                break
        return ct

    def _parse_engine_args(self) -> List:
        """Engine argument capture: depth-1 word/number/string tokens as
        strings, one level of parenthesized groups as sub-lists (the legacy
        MergeTree(date, (keys...), granularity) signature needs the key
        tuple intact)."""
        depth, args = 0, []
        sub: Optional[List[str]] = None
        while True:
            t = self.tok
            if t.kind == "op" and t.text == "(":
                depth += 1
                if depth == 2:
                    sub = []
                self.advance()
            elif t.kind == "op" and t.text == ")":
                depth -= 1
                self.advance()
                if depth == 1 and sub is not None:
                    if sub:          # fn() call parens yield no group
                        args.append(sub)
                    sub = None
                if depth == 0:
                    return args
            else:
                if t.kind in ("string", "word", "number"):
                    if depth == 1:
                        args.append(t.text)
                    elif depth == 2 and sub is not None:
                        sub.append(t.text)
                self.advance()

    def _column_name(self) -> str:
        """Column name, possibly dotted (Nested subcolumns: n.ui8)."""
        nm = self.expect_word()
        while self.tok.kind == "op" and self.tok.text == "." \
                and self.tokens[self.i + 1].kind == "word":
            self.advance()
            nm += "." + self.advance().text
        return nm

    def _parse_as_source(self, ct) -> None:
        """AS other_table | AS table_function(...) for CREATE TABLE —
        no alias parsing (the next word is a storage clause keyword)."""
        db, name = self.parse_table_name()
        if self.tok.kind == "op" and self.tok.text == "(" and db is None:
            self.expect_op("(")
            args: List[ast.Expr] = []
            if not (self.tok.kind == "op" and self.tok.text == ")"):
                args.append(self.parse_expr())
                while self.accept_op(","):
                    args.append(self.parse_expr())
            self.expect_op(")")
            ct.as_table_function = ast.FuncCall(name, args)
        else:
            ct.as_table = (db, name)

    def _skim_parens(self) -> None:
        """Consume a balanced (...) group starting at the current '('."""
        depth = 0
        while True:
            if self.accept_op("("):
                depth += 1
            elif self.accept_op(")"):
                depth -= 1
                if depth == 0:
                    return
            else:
                if self.tok.kind == "end":
                    raise ParseError("Unbalanced parentheses")
                self.advance()

    def _parse_key_list(self) -> List[ast.Expr]:
        def one():
            e = self.parse_expr()
            self.accept_kw("ASC", "DESC", "ASCENDING", "DESCENDING")
            return e
        if self.accept_op("("):
            if self.accept_op(")"):
                return []
            out = [one()]
            while self.accept_op(","):
                out.append(one())
            self.expect_op(")")
            return out
        out = [one()]
        while self.accept_op(","):
            out.append(one())
        return out

    def _if_not_exists(self) -> bool:
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def _accept_on_cluster(self) -> Optional[str]:
        """[ON CLUSTER name] — returns the cluster name or None."""
        save = self.i
        if self.accept_kw("ON"):
            if self.accept_kw("CLUSTER"):
                t = self.tok
                if t.kind in ("word", "string"):
                    self.advance()
                    return t.text
                raise ParseError(f"Expected cluster name at {t.pos}")
            self.i = save
        return None

    def _ddl_tail(self) -> None:
        """Trailing [SYNC | NO DELAY] [SETTINGS ...] [FORMAT x] tolerated on
        DDL statements (reference: ParserDropQuery & co.)."""
        while True:
            if self.accept_kw("SYNC"):
                continue
            if self.accept_kw("NO"):
                self.expect_kw("DELAY")
                continue
            if self.accept_kw("SETTINGS"):
                self.parse_settings_list()
                continue
            if self.accept_kw("FORMAT"):
                self.expect_word()
                continue
            return

    _TYPE_TAIL = {"PRECISION", "VARYING", "LARGE", "OBJECT", "CHAR",
                  "CHARACTER"}
    _TYPE_HEADS = {"DOUBLE", "CHAR", "CHARACTER", "NATIONAL", "NCHAR",
                   "BINARY", "NVARCHAR", "VARBINARY"}

    def parse_type_name(self) -> str:
        name = self.expect_word()
        if name.upper() in self._TYPE_HEADS:
            # SQL-standard multiword spellings: DOUBLE PRECISION, CHAR
            # VARYING, CHARACTER LARGE OBJECT, NATIONAL CHAR ... map onto
            # the native types (ref: DataTypeFactory case-insensitive
            # aliases)
            words = [name.upper()]
            while self.tok.kind == "word" \
                    and self.tok.text.upper() in self._TYPE_TAIL:
                words.append(self.advance().text.upper())
            mapped = "Float64" if words[0] == "DOUBLE" else "String"
            if self.tok.kind == "op" and self.tok.text == "(":
                self._skim_parens()          # CHARACTER VARYING(123)
            return mapped
        if self.tok.kind == "op" and self.tok.text == "(":
            depth = 0
            parts = [name]
            prev_wordish = False     # after `name` comes "(": no space
            while True:
                t = self.advance()
                if t.kind == "string":   # Enum8('a' = 1): keep the quotes
                    txt = "'" + t.text.replace("\\", "\\\\") \
                        .replace("'", "\\'") + "'"
                    wordish = False
                else:
                    txt = t.text
                    wordish = bool(txt) and (txt[0].isalnum()
                                             or txt[0] == "_")
                if prev_wordish and wordish:
                    # named members — Tuple(a UInt64) / Nested(x UInt32) —
                    # keep the separating space the tokenizer dropped
                    parts.append(" ")
                parts.append(txt)
                prev_wordish = wordish
                if t.kind == "op" and t.text == "(":
                    depth += 1
                elif t.kind == "op" and t.text == ")":
                    depth -= 1
                    if depth == 0:
                        break
            return "".join(parts)
        return name

    def parse_insert(self):
        self.advance()
        self.expect_kw("INTO")
        tfn = None
        if self.accept_kw("TABLE") or self.tok.is_kw("FUNCTION"):
            if self.accept_kw("FUNCTION"):
                nm = self.expect_word()
                self.expect_op("(")
                fargs: List[ast.Expr] = []
                if not (self.tok.kind == "op" and self.tok.text == ")"):
                    fargs.append(self.parse_expr())
                    while self.accept_op(","):
                        fargs.append(self.parse_expr())
                self.expect_op(")")
                tfn = ast.FuncCall(nm, fargs)
        if tfn is not None:
            db, tbl = None, ""
        else:
            db, tbl = self.parse_table_name()
        columns = None
        if self.tok.kind == "op" and self.tok.text == "(":
            save = self.i
            self.expect_op("(")
            try:
                columns = [self.expect_word()]
                while self.accept_op(","):
                    columns.append(self.expect_word())
                self.expect_op(")")
            except ParseError:
                self.i = save
                columns = None
        ins_settings: Dict[str, Any] = {}
        if self.accept_kw("SETTINGS"):
            ins_settings = self.parse_settings_list()

        def _mk(**kw):
            node = ast.Insert(db, tbl, columns, **kw)
            node.table_function = tfn
            node.settings = ins_settings
            return node

        if self.accept_kw("FROM"):
            self.expect_kw("INFILE")
            t = self.tok
            if t.kind != "string":
                raise ParseError("FROM INFILE expects a string path")
            path = self.advance().text
            if self.accept_kw("COMPRESSION") and self.tok.kind == "string":
                self.advance()
            fmt = None
            if self.accept_kw("FORMAT"):
                fmt = self.expect_word()
            return _mk(infile=path, format=fmt)
        if self.accept_kw("VALUES"):
            rows = []
            while self.accept_op("("):
                row = [self.parse_expr()]
                while self.accept_op(","):
                    row.append(self.parse_expr())
                self.expect_op(")")
                rows.append(row)
                self.accept_op(",")   # tuple separator comma is optional
            return _mk(values=rows)
        if self.tok.is_kw("SELECT", "WITH") or (
                self.tok.kind == "op" and self.tok.text == "("
                and self.tokens[self.i + 1].is_kw("SELECT", "WITH")):
            return _mk(select=self.parse_select_union())
        if self.accept_kw("FORMAT"):
            # INSERT INTO t FORMAT X: data may follow inline (split by the
            # statement splitter into inline_data) or arrive out-of-band
            # (native TCP Data packets / client streams)
            return _mk(format=self.expect_word())
        if self.tok.kind == "end" or (self.tok.kind == "op"
                                      and self.tok.text == ";"):
            return _mk()
        raise ParseError(f"Expected VALUES, SELECT or FROM INFILE at "
                         f"{self.tok.pos}")

    def parse_drop(self):
        self.advance()
        self.accept_kw("TEMPORARY")
        if self.accept_kw("USER"):
            ie = self._if_exists()

            def uname():
                t2 = self.tok
                if t2.kind in ("word", "string"):
                    self.advance()
                    return t2.text
                raise ParseError(f"Expected user name at {t2.pos}")
            names = [uname()]
            while True:          # DROP USER a, b@'host', 'u@h', c
                if self.accept_op("@"):
                    self.advance()
                if not self.accept_op(","):
                    break
                names.append(uname())
            self._accept_on_cluster()
            self._ddl_tail()
            if len(names) == 1:
                return ast.DropUser(names[0], ie)
            return ast.MultiStatement(
                [ast.DropUser(nm, ie) for nm in names])
        if self.accept_kw("ROLE"):
            ie = self._if_exists()
            name = self.expect_word()
            self._accept_on_cluster()
            self._ddl_tail()
            return ast.DropAccessEntity("role", name, ie)
        if self.accept_kw("QUOTA"):
            ie = self._if_exists()
            name = self.expect_word()
            self._accept_on_cluster()
            self._ddl_tail()
            return ast.DropAccessEntity("quota", name, ie)
        if self.accept_kw("FUNCTION"):
            ie = self._if_exists()
            name = self.expect_word()
            self._accept_on_cluster()
            self._ddl_tail()
            return ast.DropFunction(name, ie)
        if self.tok.is_kw("ROW"):
            save = self.i
            self.advance()
            if self.accept_kw("POLICY"):
                ie = self._if_exists()
                name = self.expect_word()
                if self.accept_kw("ON"):
                    self.parse_table_name()
                self._ddl_tail()
                return ast.DropAccessEntity("row_policy", name, ie)
            self.i = save
        if self.accept_kw("DATABASE"):
            ie = self._if_exists()
            name = self.expect_word()
            cl = self._accept_on_cluster()
            self._ddl_tail()
            return ast.DropTable(None, name, ie, is_database=True,
                                 cluster=cl)
        self.expect_kw("TABLE", "VIEW", "DICTIONARY")
        ie = self._if_exists()
        db, tbl = self.parse_table_name()
        cl = self._accept_on_cluster()
        self._ddl_tail()
        return ast.DropTable(db, tbl, ie, cluster=cl)

    def parse_alter(self):
        self.advance()
        if not self.accept_kw("TABLE"):
            # ALTER USER/ROLE/QUOTA/ROW POLICY: accepted, settings-level
            kind = self.expect_word()
            words = []
            while self.tok.kind in ("word", "number", "string") \
                    or (self.tok.kind == "op" and self.tok.text in
                        (".", ",", "=", "(", ")", "@")):
                words.append(self.advance().text)
            return ast.SystemCommand(f"alter {kind.lower()} "
                                     + " ".join(words))
        db, tbl = self.parse_table_name()
        cl = self._accept_on_cluster()
        actions = [self._parse_alter_action(db, tbl)]
        while self.accept_op(","):
            actions.append(self._parse_alter_action(db, tbl))
        if self.accept_kw("SETTINGS"):
            self.parse_settings_list()
        if len(actions) == 1:
            actions[0].cluster = cl
            return actions[0]
        m = ast.AlterMulti(db, tbl, actions)
        m.cluster = cl
        return m

    def _parse_partition_ref(self) -> ast.Expr:
        """PARTITION expr | PARTITION ID 'str' | PARTITION ALL."""
        if self.accept_kw("ID"):
            t = self.tok
            if t.kind != "string":
                raise ParseError(f"PARTITION ID expects a string at {t.pos}")
            self.advance()
            return ast.FuncCall("__partition_id", [ast.Literal(t.text)])
        if self.accept_kw("ALL"):
            return ast.Literal("__all__")
        return self.parse_expr()

    def _parse_alter_action(self, db, tbl) -> ast.AlterTable:
        if self.accept_kw("DELETE"):
            if self.accept_kw("IN"):
                self.expect_kw("PARTITION")
                part = self._parse_partition_ref()
                self.expect_kw("WHERE")
                return ast.AlterTable(db, tbl, "delete",
                                      predicate=self.parse_expr(),
                                      partition=part)
            self.expect_kw("WHERE")
            return ast.AlterTable(db, tbl, "delete",
                                  predicate=self.parse_expr())
        if self.accept_kw("UPDATE"):
            updates = []
            while True:
                col = self.expect_word()
                self.expect_op("=")
                updates.append((col, self.parse_expr()))
                if not self.accept_op(","):
                    break
            if self.accept_kw("IN"):
                self.expect_kw("PARTITION")
                self._parse_partition_ref()
            self.expect_kw("WHERE")
            return ast.AlterTable(db, tbl, "update", updates=updates,
                                  predicate=self.parse_expr())
        if self.accept_kw("ADD"):
            if self.accept_kw("PROJECTION"):
                self._if_not_exists()
                pname = self.expect_word()
                self.expect_op("(")
                psel = self.parse_select_union()
                self.expect_op(")")
                a = ast.AlterTable(db, tbl, "add_projection")
                a.projection = (pname, psel)
                return a
            if self.accept_kw("INDEX"):
                self._if_not_exists()
                iname = self.expect_word()
                iexpr = self.parse_expr()
                self.expect_kw("TYPE")
                ikind = self.expect_word()
                iparams: List = []
                if self.tok.kind == "op" and self.tok.text == "(":
                    self.advance()
                    while not (self.tok.kind == "op"
                               and self.tok.text == ")"):
                        if self.tok.kind in ("number", "string"):
                            iparams.append(
                                _parse_number(self.tok.text)
                                if self.tok.kind == "number"
                                else self.tok.text)
                        self.advance()
                    self.expect_op(")")
                igran = 1
                if self.accept_kw("GRANULARITY"):
                    g = self.parse_expr()
                    if isinstance(g, ast.Literal) \
                            and isinstance(g.value, int):
                        igran = g.value
                if self.accept_kw("AFTER"):
                    self.expect_word()
                return ast.AlterTable(db, tbl, "add_index",
                                      index=ast.IndexDef(
                                          iname, iexpr, ikind.lower(),
                                          iparams, igran))
            if self.accept_kw("CONSTRAINT"):
                self._if_not_exists()
                cn = self.expect_word()
                self.expect_kw("CHECK", "ASSUME")
                e = self.parse_expr()
                a = ast.AlterTable(db, tbl, "add_constraint",
                                   column_name=cn)
                a.predicate = e
                return a
            self.expect_kw("COLUMN")
            ine = False
            if self.accept_kw("IF"):  # IF NOT EXISTS tolerated
                self.expect_kw("NOT")
                self.expect_kw("EXISTS")
                ine = True
            cname = self._column_name()
            if self.tok.is_kw("DEFAULT", "MATERIALIZED", "ALIAS",
                              "EPHEMERAL"):
                ctype = ""
            else:
                ctype = self.parse_type_name()
            default = None
            default_kind = "default"
            kindtok = self.accept_kw("DEFAULT", "MATERIALIZED", "ALIAS",
                                     "EPHEMERAL")
            if kindtok is not None:
                default_kind = kindtok.text.lower()
                default = self.parse_expr()
            codec = None
            if self.accept_kw("CODEC") and self.tok.kind == "op" \
                    and self.tok.text == "(":
                depth, names = 0, []
                while True:
                    t = self.tok
                    if t.kind == "op" and t.text == "(":
                        depth += 1
                        self.advance()
                    elif t.kind == "op" and t.text == ")":
                        depth -= 1
                        self.advance()
                        if depth == 0:
                            break
                    else:
                        if t.kind == "word" and depth == 1:
                            names.append(t.text)
                        self.advance()
                codec = ", ".join(names) if names else None
            if self.accept_kw("TTL"):
                self.parse_expr()
            after = None
            first = False
            if self.accept_kw("AFTER"):
                after = self.expect_word()
            elif self.accept_kw("FIRST"):
                first = True
            a = ast.AlterTable(db, tbl, "add_column",
                               column=ast.ColumnDef(
                                   cname, ctype, default, codec,
                                   default_kind),
                               if_exists=ine)
            a.new_name = after          # AFTER anchor rides new_name
            a.settings = {"first": first} if first else {}
            return a
        if self.accept_kw("DROP", "DETACH"):
            kw = "drop" if self.tokens[self.i - 1].text.upper() == "DROP" \
                else "detach"
            if self.accept_kw("PROJECTION"):
                self._if_exists()
                a = ast.AlterTable(db, tbl, "drop_projection")
                a.projection = (self.expect_word(), None)
                return a
            if self.accept_kw("INDEX"):
                self._if_exists()
                return ast.AlterTable(db, tbl, "drop_index",
                                      index_name=self.expect_word())
            if self.accept_kw("CONSTRAINT"):
                self._if_exists()
                return ast.AlterTable(db, tbl, "drop_constraint",
                                      column_name=self.expect_word())
            if self.accept_kw("PARTITION"):
                return ast.AlterTable(db, tbl, f"{kw}_partition",
                                      partition=self._parse_partition_ref())
            if self.accept_kw("PART"):
                t = self.tok
                self.advance()
                return ast.AlterTable(db, tbl, "drop_part",
                                      partition=ast.Literal(t.text))
            self.expect_kw("COLUMN")
            ie = self._if_exists()
            return ast.AlterTable(db, tbl, "drop_column",
                                  column_name=self._column_name(),
                                  if_exists=ie)
        if self.accept_kw("ATTACH"):
            self.expect_kw("PARTITION", "PART")
            part = self._parse_partition_ref()
            a = ast.AlterTable(db, tbl, "attach_partition", partition=part)
            if self.accept_kw("FROM"):
                a.from_table = self.parse_table_name()
            return a
        if self.accept_kw("REPLACE"):
            self.expect_kw("PARTITION")
            part = self._parse_partition_ref()
            self.expect_kw("FROM")
            return ast.AlterTable(db, tbl, "replace_partition",
                                  partition=part,
                                  from_table=self.parse_table_name())
        if self.accept_kw("MOVE"):
            self.expect_kw("PARTITION", "PART")
            part = self._parse_partition_ref()
            self.expect_kw("TO")
            dk = self.expect_kw("TABLE", "DISK", "VOLUME")
            if dk.text.upper() == "TABLE":
                dest = self.parse_table_name()
            else:
                dest = (None, self.advance().text)   # disk/volume name
            return ast.AlterTable(db, tbl, "move_partition",
                                  partition=part, from_table=dest)
        if self.accept_kw("FREEZE", "UNFREEZE"):
            if self.accept_kw("PARTITION"):
                self._parse_partition_ref()
            if self.accept_kw("WITH"):
                self.expect_kw("NAME")
                self.advance()
            return ast.AlterTable(db, tbl, "freeze")
        if self.accept_kw("CLEAR"):
            kind = self.expect_kw("COLUMN", "INDEX").text.lower()
            self._if_exists()
            name = self.expect_word()
            if self.accept_kw("IN"):
                self.expect_kw("PARTITION")
                self._parse_partition_ref()
            return ast.AlterTable(db, tbl, f"clear_{kind}",
                                  column_name=name)
        if self.accept_kw("COMMENT"):
            self.expect_kw("COLUMN")
            self._if_exists()
            name = self.expect_word()
            if self.tok.kind == "string":
                self.advance()
            return ast.AlterTable(db, tbl, "comment_column",
                                  column_name=name)
        if self.accept_kw("RENAME"):
            self.expect_kw("COLUMN")
            ie = self._if_exists()
            old = self.expect_word()
            self.expect_kw("TO")
            return ast.AlterTable(db, tbl, "rename_column",
                                  column_name=old,
                                  new_name=self.expect_word(),
                                  if_exists=ie)
        if self.accept_kw("MATERIALIZE"):
            if self.accept_kw("PROJECTION"):
                a = ast.AlterTable(db, tbl, "materialize_projection")
                a.projection = (self.expect_word(), None)
                if self.accept_kw("IN"):
                    self.expect_kw("PARTITION")
                    self._parse_partition_ref()
                return a
            if self.accept_kw("INDEX"):
                a = ast.AlterTable(db, tbl, "materialize_index",
                                   index_name=self.expect_word())
                if self.accept_kw("IN"):
                    self.expect_kw("PARTITION")
                    self._parse_partition_ref()
                return a
            if self.accept_kw("TTL"):
                return ast.AlterTable(db, tbl, "materialize_ttl")
            if self.accept_kw("COLUMN"):
                a = ast.AlterTable(db, tbl, "materialize_column",
                                   column_name=self.expect_word())
                if self.accept_kw("IN"):
                    self.expect_kw("PARTITION")
                    self._parse_partition_ref()
                return a
        if self.accept_kw("MODIFY"):
            if self.accept_kw("TTL"):
                a = ast.AlterTable(db, tbl, "modify_ttl")
                a.ttl = ast.format_expr(self.parse_expr())
                return a
            if self.accept_kw("ORDER"):
                self.expect_kw("BY")
                a = ast.AlterTable(db, tbl, "modify_order_by")
                a.settings = {"order_by": self._parse_key_list()}
                return a
            if self.accept_kw("SAMPLE"):
                self.expect_kw("BY")
                a = ast.AlterTable(db, tbl, "modify_sample_by")
                a.predicate = self.parse_expr()
                return a
            if self.accept_kw("SETTING"):
                a = ast.AlterTable(db, tbl, "modify_setting")
                a.settings = self.parse_settings_list()
                return a
            if self.accept_kw("QUERY"):
                a = ast.AlterTable(db, tbl, "modify_query")
                a.settings = {"query": self.parse_select_union()}
                return a
            if self.accept_kw("COMMENT"):
                if self.tok.kind == "string":
                    self.advance()
                return ast.AlterTable(db, tbl, "comment_column")
            self.expect_kw("COLUMN")
            ie = self._if_exists()
            cname = self._column_name()
            if self.accept_kw("REMOVE"):
                self.expect_word()          # DEFAULT/MATERIALIZED/TTL/...
                return ast.AlterTable(db, tbl, "modify_column_remove",
                                      column_name=cname, if_exists=ie)
            if self.tok.is_kw("DEFAULT", "MATERIALIZED", "ALIAS"):
                ctype = ""
            else:
                ctype = self.parse_type_name()
            default = None
            default_kind = "default"
            kindtok = self.accept_kw("DEFAULT", "MATERIALIZED", "ALIAS")
            if kindtok is not None:
                default_kind = kindtok.text.lower()
                default = self.parse_expr()
            if self.accept_kw("CODEC") and self.tok.kind == "op" \
                    and self.tok.text == "(":
                self._skim_parens()
            if self.accept_kw("TTL"):
                self.parse_expr()
            if self.accept_kw("AFTER"):
                self.expect_word()
            return ast.AlterTable(db, tbl, "modify_column",
                                  column=ast.ColumnDef(
                                      cname, ctype, default,
                                      default_kind=default_kind),
                                  if_exists=ie)
        if self.accept_kw("RESET"):
            self.expect_kw("SETTING")
            names = [self.expect_word()]
            while self.accept_op(","):
                names.append(self.expect_word())
            a = ast.AlterTable(db, tbl, "reset_setting")
            a.settings = {nm: None for nm in names}
            return a
        raise ParseError(f"Unsupported ALTER action at {self.tok.pos}")

    def parse_grant(self):
        kind = self.advance().text.lower()
        privs = [self.expect_word()]
        while self.accept_op(","):
            privs.append(self.expect_word())
        if self.accept_kw("TO" if kind == "grant" else "FROM"):
            # GRANT <role>[, ...] TO <user> -- role grant, no ON clause
            user = self.expect_word()
            return ast.GrantRevoke(kind, privs, "__role__", user)
        self.expect_kw("ON")
        if self.accept_op("*"):
            self.expect_op(".")
            self.expect_op("*")
            target = "*.*"
        else:
            a = self.expect_word()
            if self.accept_op("."):
                if self.accept_op("*"):
                    target = f"{a}.*"
                else:
                    target = f"{a}.{self.expect_word()}"
            else:
                target = f"*.{a}"
        self.expect_kw("TO" if kind == "grant" else "FROM")
        user = self.expect_word()
        return ast.GrantRevoke(kind, privs, target, user)

    def parse_truncate(self):
        self.advance()
        self.accept_kw("TEMPORARY")
        if self.accept_kw("ALL"):
            # TRUNCATE ALL TABLES FROM [IF EXISTS] db
            self.expect_kw("TABLES")
            self.accept_kw("FROM")
            ie = self._if_exists()
            dbn = self.expect_word()
            self._accept_on_cluster()
            self._ddl_tail()
            t = ast.TruncateTable(dbn, None)
            t.if_exists = ie
            t.cluster = None
            t.all_tables = True
            return t
        if self.accept_kw("DATABASE"):
            ie = self._if_exists()
            dbn = self.expect_word()
            self._accept_on_cluster()
            self._ddl_tail()
            t = ast.TruncateTable(dbn, None)
            t.if_exists = ie
            t.cluster = None
            t.all_tables = True
            return t
        self.accept_kw("TABLE")          # TRUNCATE [TABLE] [IF EXISTS] t
        ie = self._if_exists()
        db, tbl = self.parse_table_name()
        cl = self._accept_on_cluster()
        self._ddl_tail()
        t = ast.TruncateTable(db, tbl)
        t.if_exists = ie
        t.cluster = cl
        return t

    def _if_exists(self) -> bool:
        if self.accept_kw("IF"):
            self.expect_kw("EXISTS")
            return True
        return False

    def parse_show(self):
        self.advance()
        if self.accept_kw("CREATE"):
            kw = self.accept_kw("TABLE", "DATABASE", "VIEW", "DICTIONARY",
                                "TEMPORARY")
            if kw is not None and kw.text.upper() == "TEMPORARY":
                self.expect_kw("TABLE")
            kind = "database" if (kw is not None
                                  and kw.text.upper() == "DATABASE") \
                else "table"
            if kind == "database":
                name = self.expect_word()
                self._ddl_tail()
                return ast.ShowCreate("database", None, name)
            db, tbl = self.parse_table_name()
            self._ddl_tail()
            return ast.ShowCreate("table", db, tbl)
        if self.accept_kw("DATABASES"):
            like = None
            if self.accept_kw("LIKE") and self.tok.kind == "string":
                like = self.advance().text
            self._ddl_tail()
            return ast.ShowTables(databases=True, like=like)
        if self.accept_kw("SETTING"):
            name = self.expect_word()
            # SELECT value FROM system.settings WHERE name = '<name>'
            q = ast.Select(
                items=[ast.SelectItem(ast.Identifier("value"))],
                from_=ast.TableRef("system", "settings"),
                where=ast.FuncCall("equals", [ast.Identifier("name"),
                                              ast.Literal(name)]))
            return q
        if self.accept_kw("PROCESSLIST"):
            return ast.Select(
                items=[ast.SelectItem(ast.Star())],
                from_=ast.TableRef("system", "processes"))
        if self.accept_kw("GRANTS"):
            if self.accept_kw("FOR"):
                self.expect_word()
            return ast.SystemCommand("show grants")
        self.accept_kw("TEMPORARY")
        self.expect_kw("TABLES")
        if self.accept_kw("FROM", "IN"):
            self.expect_word()
        like = None
        neg = False
        if self.accept_kw("NOT"):
            neg = True
        if self.accept_kw("LIKE", "ILIKE"):
            t = self.tok
            if t.kind != "string":
                raise ParseError("SHOW TABLES LIKE expects a string")
            like = self.advance().text
        elif self.accept_kw("WHERE"):
            self.parse_expr()
        if self.accept_kw("LIMIT"):
            self.parse_expr()
        self._ddl_tail()
        st = ast.ShowTables(like=like)
        st.not_like = neg
        return st

    def parse_set(self):
        self.advance()
        return ast.SetStatement(self.parse_settings_list())

    def parse_explain(self):
        self.advance()
        kind = "plan"
        if self.tok.is_kw("AST", "PLAN", "PIPELINE", "ESTIMATE", "SYNTAX",
                          "INDEXES"):
            kind = self.advance().text.lower()
        elif self.tok.is_kw("QUERY") \
                and self.tokens[self.i + 1].is_kw("TREE"):
            self.advance()
            self.advance()
            kind = "query_tree"
        # key = value option list (actions=1, header=1, indexes=1, ...)
        options: Dict[str, Any] = {}
        while self.tok.kind == "word" \
                and self.tokens[self.i + 1].kind == "op" \
                and self.tokens[self.i + 1].text == "=" \
                and not self.tok.is_kw(*RESERVED):
            name = self.advance().text
            self.expect_op("=")
            options[name] = self.parse_setting_value()
            self.accept_op(",")
        if self.tok.is_kw("INSERT", "CREATE", "ALTER", "DROP"):
            q = self.parse_statement()
        else:
            q = self.parse_select_union()
        return ast.Explain(kind, q, options)

    # -- expressions ---------------------------------------------------------
    def _parse_expr_alias(self) -> ast.Expr:
        """Expression with an optional `AS alias` — ClickHouse allows an
        alias on any argument/parenthesized expression, visible query-wide
        (ref: ExpressionListParsers ParserWithOptionalAlias)."""
        if self.tok.is_kw("SELECT", "WITH"):
            # bare subquery argument: view(SELECT ...), in(x, SELECT ...)
            q = self.parse_select_union()
            return ast.Subquery(q)
        e = self.parse_expr()
        if self.accept_kw("AS"):
            return ast.Aliased(e, self.expect_word())
        return e

    def parse_expr(self) -> ast.Expr:
        e = self.parse_ternary()
        if self.tok.kind == "op" and self.tok.text == "->":
            params = None
            if isinstance(e, ast.Identifier):
                params = [e.name]
            elif isinstance(e, ast.Tuple_) and all(
                    isinstance(i, ast.Identifier) for i in e.items):
                params = [i.name for i in e.items]
            elif isinstance(e, ast.FuncCall) and e.name == "tuple" and all(
                    isinstance(i, ast.Identifier) for i in e.args):
                params = [i.name for i in e.args]
            if params is not None:
                self.advance()
                return ast.Lambda(params, self.parse_expr())
        return e

    def parse_ternary(self) -> ast.Expr:
        cond = self.parse_or()
        if self.accept_op("?"):
            a = self.parse_or()
            self.expect_op(":")
            b = self.parse_ternary()
            return ast.FuncCall("if", [cond, a, b])
        return cond

    def parse_or(self) -> ast.Expr:
        left = self.parse_and()
        args = [left]
        while self.accept_kw("OR"):
            args.append(self.parse_and())
        return args[0] if len(args) == 1 else ast.FuncCall("or", args)

    def parse_and(self) -> ast.Expr:
        left = self.parse_not()
        args = [left]
        while self.accept_kw("AND"):
            args.append(self.parse_not())
        return args[0] if len(args) == 1 else ast.FuncCall("and", args)

    def parse_not(self) -> ast.Expr:
        if self.accept_kw("NOT"):
            return ast.FuncCall("not", [self.parse_not()])
        return self.parse_comparison()

    def parse_comparison(self) -> ast.Expr:
        left = self.parse_additive()
        t = self.tok
        if t.kind == "op" and t.text in ("=", "==", "!=", "<>", "<", "<=",
                                         ">", ">="):
            self.advance()
            name = {"=": "equals", "==": "equals", "!=": "notEquals",
                    "<>": "notEquals", "<": "less", "<=": "lessOrEquals",
                    ">": "greater", ">=": "greaterOrEquals"}[t.text]
            # quantified comparison: x = ANY (SELECT ...) -> IN;
            # x != ALL (SELECT ...) -> NOT IN (ref: ParserComparison ANY/ALL)
            if self.tok.is_kw("ANY", "ALL", "SOME") \
                    and self.tokens[self.i + 1].kind == "op" \
                    and self.tokens[self.i + 1].text == "(":
                quant = self.advance().text.upper()
                quant = "ANY" if quant == "SOME" else quant
                rhs = self.parse_in_rhs()
                if name == "equals" and quant == "ANY":
                    return ast.FuncCall("in", [left, rhs])
                if name == "notEquals" and quant == "ALL":
                    return ast.FuncCall("notIn", [left, rhs])
                raise ParseError(
                    f"Unsupported quantified comparison {name} {quant}")
            right = self.parse_additive()
            return ast.FuncCall(name, [left, right])
        negate = False
        save = self.i
        if self.accept_kw("GLOBAL"):
            # GLOBAL IN / GLOBAL NOT IN: single-process semantics are
            # identical to IN (the build side is already local)
            if self.accept_kw("NOT") and self.tok.is_kw("IN"):
                self.advance()
                return ast.FuncCall("notIn", [left, self.parse_in_rhs()])
            if self.tok.is_kw("IN"):
                self.advance()
                return ast.FuncCall("in", [left, self.parse_in_rhs()])
            self.i = save
            return left
        if self.accept_kw("NOT"):
            if self.tok.is_kw("LIKE", "ILIKE", "IN", "BETWEEN"):
                negate = True
            else:
                self.i = save
                return left
        if self.accept_kw("LIKE"):
            right = self.parse_additive()
            return ast.FuncCall("notLike" if negate else "like", [left, right])
        if self.accept_kw("ILIKE"):
            right = self.parse_additive()
            return ast.FuncCall("notILike" if negate else "ilike", [left, right])
        if self.accept_kw("IN"):
            right = self.parse_in_rhs()
            return ast.FuncCall("notIn" if negate else "in", [left, right])
        if self.accept_kw("BETWEEN"):
            lo = self.parse_additive()
            self.expect_kw("AND")
            hi = self.parse_additive()
            rng = ast.FuncCall("and", [
                ast.FuncCall("greaterOrEquals", [left, lo]),
                ast.FuncCall("lessOrEquals", [left, hi])])
            return ast.FuncCall("not", [rng]) if negate else rng
        if self.accept_kw("IS"):
            if self.accept_kw("NOT"):
                self.expect_kw("NULL")
                return ast.FuncCall("isNotNull", [left])
            self.expect_kw("NULL")
            return ast.FuncCall("isNull", [left])
        return left

    def parse_in_rhs(self) -> ast.Expr:
        if self.tok.kind == "op" and self.tok.text == "(":
            self.expect_op("(")
            if self.tok.is_kw("SELECT", "WITH"):
                q = self.parse_select_union()
                self.expect_op(")")
                if isinstance(q, ast.Union):
                    raise ParseError("UNION inside IN is not supported yet")
                return ast.Subquery(q)
            items = [self.parse_expr()]
            while self.accept_op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            return ast.Tuple_(items)
        return self.parse_additive()

    def parse_additive(self) -> ast.Expr:
        left = self.parse_multiplicative()
        while True:
            if self.accept_op("+"):
                left = ast.FuncCall("plus", [left, self.parse_multiplicative()])
            elif self.accept_op("-"):
                left = ast.FuncCall("minus", [left, self.parse_multiplicative()])
            elif self.accept_op("||"):
                left = ast.FuncCall("concat", [left, self.parse_multiplicative()])
            else:
                return left

    def parse_multiplicative(self) -> ast.Expr:
        left = self.parse_unary()
        while True:
            if self.accept_op("*"):
                left = ast.FuncCall("multiply", [left, self.parse_unary()])
            elif self.accept_op("/"):
                left = ast.FuncCall("divide", [left, self.parse_unary()])
            elif self.accept_op("%"):
                left = ast.FuncCall("modulo", [left, self.parse_unary()])
            else:
                return left

    def parse_unary(self) -> ast.Expr:
        if self.accept_op("-"):
            inner = self.parse_unary()
            if isinstance(inner, ast.Literal) and isinstance(inner.value,
                                                             (int, float)):
                return ast.Literal(-inner.value)
            return ast.FuncCall("negate", [inner])
        if self.accept_op("+"):
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self) -> ast.Expr:
        e = self.parse_primary()
        while True:
            if isinstance(e, ast.FuncCall) \
                    and self.tok.is_kw("IGNORE", "RESPECT") \
                    and self.tokens[self.i + 1].is_kw("NULLS"):
                kw = self.advance().text.upper()
                self.advance()
                if kw == "RESPECT":
                    e = dataclasses.replace(
                        e, name=f"{e.name}_respect_nulls")
                continue
            if isinstance(e, ast.FuncCall) and e.over is None \
                    and self.tok.is_kw("OVER"):
                self.advance()
                if self.tok.kind == "word":
                    # OVER w — named window, resolved once the WINDOW
                    # clause has been parsed (_resolve_named_windows)
                    e = ast.FuncCall(e.name, e.args, e.params, e.distinct,
                                     over=self.advance().text)
                else:
                    e = ast.FuncCall(e.name, e.args, e.params, e.distinct,
                                     over=self.parse_window_spec())
            elif self.accept_op("::"):
                tname = self.parse_type_name()
                e = ast.FuncCall("CAST", [e, ast.Literal(tname)])
            elif self.accept_op("["):
                idx = self.parse_expr()
                self.expect_op("]")
                e = ast.FuncCall("arrayElement", [e, idx])
            elif self.tok.kind == "op" and self.tok.text == "." \
                    and self.tokens[self.i + 1].kind in ("word", "number"):
                # postfix element access (ref ExpressionListParsers.cpp):
                # tuple(1,'a').2, deep dotted names j.geo.cc
                nxt = self.tokens[self.i + 1]
                if nxt.kind == "number":
                    if not nxt.text.isdigit():
                        return e
                    self.advance()
                    self.advance()
                    e = ast.FuncCall("tupleElement",
                                     [e, ast.Literal(int(nxt.text))])
                else:
                    self.advance()
                    self.advance()
                    if isinstance(e, ast.Identifier):
                        parts = tuple(e.parts) + (nxt.text,)
                        e = ast.Identifier(".".join(parts), parts)
                    else:
                        e = ast.FuncCall("tupleElement",
                                         [e, ast.Literal(nxt.text)])
            elif self.tok.kind == "number" \
                    and self.tok.text.startswith(".") \
                    and all(p.isdigit()
                            for p in self.tok.text[1:].split(".")):
                # the lexer folds '.2' (or a chain '.2.1') into one number
                # token after ')': each segment is an element access
                t = self.tok
                self.advance()
                for seg in t.text[1:].split("."):
                    e = ast.FuncCall("tupleElement",
                                     [e, ast.Literal(int(seg))])
            elif self.tok.kind == "op" and self.tok.text == "(" \
                    and isinstance(e, ast.FuncCall) and e.params is None:
                # parameterized aggregate: quantile(0.5)(x) — the first
                # argument list becomes the parameter list.
                self.expect_op("(")
                args = []
                if not (self.tok.kind == "op" and self.tok.text == ")"):
                    args.append(self.parse_expr())
                    while self.accept_op(","):
                        args.append(self.parse_expr())
                self.expect_op(")")
                e = ast.FuncCall(e.name, args, params=list(e.args))
            else:
                return e

    def parse_primary(self) -> ast.Expr:
        t = self.tok
        if t.kind == "number":
            self.advance()
            return ast.Literal(_parse_number(t.text))
        if t.kind == "string":
            self.advance()
            return ast.Literal(t.text)
        if t.kind == "op" and t.text == "*":
            self.advance()
            return self._star_transformers(ast.Star())
        if t.kind == "op" and t.text == "[":
            self.advance()
            items: List[ast.Expr] = []
            if not (self.tok.kind == "op" and self.tok.text == "]"):
                items.append(self._parse_expr_alias())
                while self.accept_op(","):
                    items.append(self._parse_expr_alias())
            self.expect_op("]")
            return ast.FuncCall("array", items)
        if t.kind == "op" and t.text == "(":
            self.advance()
            if self.tok.is_kw("SELECT", "WITH") or self.tok.is_kw("EXPLAIN"):
                if self.tok.is_kw("EXPLAIN"):
                    q = self.parse_explain()
                    self.expect_op(")")
                    return ast.Subquery(q)
                q = self.parse_select_union()
                self.expect_op(")")
                if isinstance(q, ast.Union):
                    raise ParseError("UNION subquery expression not supported")
                return ast.Subquery(q)
            first = self._parse_expr_alias()
            if self.accept_op(","):
                # (1,) — single-element tuple via trailing comma
                if self.tok.kind == "op" and self.tok.text == ")":
                    self.advance()
                    return ast.Tuple_([first])
                items = [first, self._parse_expr_alias()]
                while self.accept_op(","):
                    if self.tok.kind == "op" and self.tok.text == ")":
                        break
                    items.append(self._parse_expr_alias())
                self.expect_op(")")
                return ast.Tuple_(items)
            self.expect_op(")")
            return first
        if t.kind == "word":
            up = t.text.upper()
            if up == "NULL":
                self.advance()
                return ast.Literal(None)
            if up == "TRUE":
                self.advance()
                return ast.Literal(1)
            if up == "FALSE":
                self.advance()
                return ast.Literal(0)
            if up == "CASE":
                return self.parse_case()
            if up == "CAST":
                self.advance()
                self.expect_op("(")
                e = self.parse_expr()
                if self.accept_kw("AS"):
                    tname = self.parse_type_name()
                    self.expect_op(")")
                    return ast.FuncCall("CAST", [e, ast.Literal(tname)])
                self.expect_op(",")
                tlit = self.parse_expr()
                self.expect_op(")")
                return ast.FuncCall("CAST", [e, tlit])
            if up == "COLUMNS" and self.tokens[self.i + 1].kind == "op" \
                    and self.tokens[self.i + 1].text == "(" \
                    and self.tokens[self.i + 2].kind == "string":
                self.advance()
                self.expect_op("(")
                pat = self.advance().text
                self.expect_op(")")
                return self._star_transformers(ast.Star(columns_re=pat))
            if up == "EXTRACT" and self.tokens[self.i + 1].kind == "op" \
                    and self.tokens[self.i + 1].text == "(" \
                    and self.tokens[self.i + 3].is_kw("FROM"):
                self.advance()
                self.expect_op("(")
                unit = self.expect_word().upper()
                self.expect_kw("FROM")
                arg = self.parse_expr()
                self.expect_op(")")
                fn = {"YEAR": "toYear", "MONTH": "toMonth",
                      "DAY": "toDayOfMonth", "HOUR": "toHour",
                      "MINUTE": "toMinute", "SECOND": "toSecond",
                      "QUARTER": "toQuarter", "WEEK": "toISOWeek",
                      "YYYY": "toYear", "MM": "toMonth",
                      "DD": "toDayOfMonth", "HH": "toHour",
                      "MI": "toMinute", "SS": "toSecond",
                      "DOW": "toDayOfWeek", "DOY": "toDayOfYear",
                      }.get(unit)
                if fn is None:
                    raise ParseError(f"EXTRACT: unknown unit {unit}")
                return ast.FuncCall(fn, [arg])
            if up == "INTERVAL":
                self.advance()
                if self.tok.kind == "string":
                    # INTERVAL '2 year' string form
                    raw = self.advance().text.strip().split()
                    if len(raw) != 2:
                        raise ParseError(f"Bad INTERVAL string {raw!r}")
                    num = (float(raw[0]) if "." in raw[0]
                           else int(raw[0]))
                    unit = raw[1].upper().rstrip("S")
                    return ast.FuncCall(
                        f"toInterval{unit.capitalize()}",
                        [ast.Literal(num)])
                n = self.parse_additive()
                unit = self.expect_word().upper()
                return ast.FuncCall(f"toInterval{unit.capitalize()}", [n])
            if up == "EXISTS" and self.tokens[self.i + 1].text == "(":
                self.advance()
                self.expect_op("(")
                q = self.parse_select_union()
                self.expect_op(")")
                if isinstance(q, ast.Union):
                    raise ParseError("UNION in EXISTS not supported")
                return ast.FuncCall("exists", [ast.Subquery(q)])
            # identifier or function call
            self.advance()
            name = t.text
            if self.accept_op("."):
                nxt = self.tok
                if nxt.kind == "op" and nxt.text == "*":
                    self.advance()
                    return self._star_transformers(ast.Star(table=name))
                part = self.expect_word()
                full = f"{name}.{part}"
                return ast.Identifier(full, (name, part))
            if self.tok.kind == "op" and self.tok.text == "(":
                self.expect_op("(")
                distinct = bool(self.accept_kw("DISTINCT"))
                args: List[ast.Expr] = []
                if not (self.tok.kind == "op" and self.tok.text == ")"):
                    args.append(self._parse_expr_alias())
                    while self.accept_op(","):
                        args.append(self._parse_expr_alias())
                self.expect_op(")")
                return ast.FuncCall(name, args, distinct=distinct)
            return ast.Identifier(name)
        raise ParseError(f"Unexpected token {t.text!r} at {t.pos}")

    def _star_transformers(self, star: ast.Star) -> ast.Star:
        """* EXCEPT (...) / APPLY(fn) / REPLACE(expr AS col) chains
        (ref: src/Parsers/ParserColumnsTransformers.cpp)."""
        while True:
            if self.tok.is_kw("EXCEPT") \
                    and not self.tokens[self.i + 1].is_kw("SELECT", "ALL",
                                                          "DISTINCT") \
                    and not (self.tokens[self.i + 1].text == "("
                             and self.tokens[self.i + 2].is_kw("SELECT",
                                                               "WITH")):
                self.advance()
                self.accept_kw("STRICT")
                names = []
                if self.accept_op("("):
                    names.append(self.expect_word())
                    while self.accept_op(","):
                        names.append(self.expect_word())
                    self.expect_op(")")
                else:
                    names.append(self.expect_word())
                star.transformers.append(("except", names))
            elif self.tok.is_kw("APPLY"):
                self.advance()
                self.expect_op("(")
                fn = self.expect_word()
                self.expect_op(")")
                star.transformers.append(("apply", fn))
            elif self.tok.is_kw("REPLACE") \
                    and self.tokens[self.i + 1].kind == "op" \
                    and self.tokens[self.i + 1].text == "(":
                self.advance()
                self.accept_kw("STRICT")
                self.expect_op("(")
                pairs = []
                while True:
                    e = self.parse_expr()
                    self.expect_kw("AS")
                    pairs.append((e, self.expect_word()))
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                star.transformers.append(("replace", pairs))
            else:
                return star

    def parse_window_spec(self) -> ast.WindowSpec:
        spec = ast.WindowSpec()
        self.expect_op("(")
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            spec.partition_by.append(self.parse_expr())
            while self.accept_op(","):
                spec.partition_by.append(self.parse_expr())
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            spec.order_by.append(self.parse_order_item())
            while self.accept_op(","):
                spec.order_by.append(self.parse_order_item())
            spec.frame = "running"     # SQL default with ORDER BY
        else:
            spec.frame = "full"
        if self.tok.is_kw("ROWS", "RANGE"):
            mode = self.tok.text.lower()
            self.advance()
            if self.accept_kw("BETWEEN"):
                lo = self._parse_frame_bound(is_start=True)
                self.expect_kw("AND")
                hi = self._parse_frame_bound(is_start=False)
            else:                       # short form: frame start only
                lo = self._parse_frame_bound(is_start=True)
                hi = 0                  # .. AND CURRENT ROW
            if lo is None and hi is None:
                spec.frame = "full"
            elif mode == "range" and lo is None and hi == 0:
                spec.frame = "running"  # the SQL default (peers included)
            else:
                spec.frame = (mode, lo, hi)
        self.expect_op(")")
        return spec

    def _parse_frame_bound(self, is_start: bool):
        """-> None (unbounded), 0 (current row), or a signed row/value
        offset (negative = PRECEDING, positive = FOLLOWING)."""
        if self.accept_kw("UNBOUNDED"):
            self.expect_kw("PRECEDING" if is_start else "FOLLOWING")
            return None
        if self.accept_kw("CURRENT"):
            self.expect_kw("ROW")
            return 0
        t = self.tok
        if t.kind == "number":
            self.advance()
            n = int(t.text)
            kw = self.expect_kw("PRECEDING", "FOLLOWING")
            return -n if kw.text.upper() == "PRECEDING" else n
        raise ParseError(f"Unsupported frame bound at {self.tok.pos}")

    def parse_case(self) -> ast.Expr:
        self.expect_kw("CASE")
        operand = None
        if not self.tok.is_kw("WHEN"):
            operand = self.parse_expr()
        branches = []
        while self.accept_kw("WHEN"):
            cond = self.parse_expr()
            self.expect_kw("THEN")
            val = self.parse_expr()
            if operand is not None:
                cond = ast.FuncCall("equals", [operand, cond])
            branches.append((cond, val))
        default = None
        if self.accept_kw("ELSE"):
            default = self.parse_expr()
        self.expect_kw("END")
        args: List[ast.Expr] = []
        for c, v in branches:
            args.extend([c, v])
        if default is not None:
            args.append(default)
        return ast.FuncCall("multiIf", args)


def _resolve_named_windows(sel: "ast.Select") -> None:
    """Replace string `over` references (OVER w) with the named window's
    spec from the WINDOW clause."""
    def walk(e):
        if isinstance(e, ast.FuncCall):
            if isinstance(e.over, str):
                spec = sel.windows.get(e.over)
                if spec is None:
                    raise ParseError(f"Unknown window {e.over!r}")
                e.over = spec
            for a in e.args:
                walk(a)
            for p in e.params or []:
                walk(p)
        elif isinstance(e, ast.Tuple_):
            for i in e.items:
                walk(i)
        elif isinstance(e, ast.Aliased):
            walk(e.expr)
        elif isinstance(e, ast.Lambda):
            walk(e.body)
    for it in sel.items:
        walk(it.expr)
    if sel.having is not None:
        walk(sel.having)


def _parse_number(text: str):
    if text.startswith(("0x", "0X")):
        if "p" in text or "P" in text or "." in text:
            return float.fromhex(text)        # hex float: 0x123p4
        return int(text, 16)
    if text.startswith(("0b", "0B")):
        return int(text, 2)
    if any(c in text for c in ".eE"):
        return float(text)
    return int(text)
