"""WITH RECURSIVE of the CUDA engine against the JAX reference, on the CPU.

The port runs the reference's host-side fixpoint (exec/recursive.py,
copied): each iteration an ordinary SELECT on the session's device over a
scratch working table, dropped after the query.  The reference's
TestRecursiveCTE cases (tests/test_sql_e2e.py:748; its Array path case
holds an Array(UInt64) that arrayConcat grows) and a hierarchy walk over
a seeded tree go through both engines; every answer must be equal.
F11, the port's misleading UnknownIdentifier before the module was
ported, is repaired.
"""
import numpy as np
import pytest

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch


def _both(sql, setup=()):
    js, ts = jch.connect(), tch.connect(device="cpu")
    for st in setup:
        js.execute(st)
        ts.execute(st)
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    assert got == want, (sql, got[:5], want[:5])
    return ts, got


TREE = ("CREATE TABLE rc_tree (id UInt64, link Nullable(UInt64)) "
        "ENGINE = Memory",
        "INSERT INTO rc_tree VALUES (0, NULL), (1, 0), (2, 0), (3, 1)")


@pytest.mark.parametrize("sql,setup,want", [
    ("WITH RECURSIVE t AS (SELECT 1 AS n UNION ALL SELECT n+1 FROM t "
     "WHERE n < 5) SELECT * FROM t ORDER BY n", (),
     [(1,), (2,), (3,), (4,), (5,)]),
    ("WITH RECURSIVE f AS (SELECT 0 AS i, 0 AS a, 1 AS b UNION ALL "
     "SELECT i+1, b, a+b FROM f WHERE i < 10) SELECT max(b) FROM f", (),
     [(89,)]),
    ("WITH RECURSIVE t AS (SELECT 1 AS n UNION SELECT 1 FROM t) "
     "SELECT count() FROM t", (), [(1,)]),
    ("WITH RECURSIVE st AS (SELECT id, link, [t.id] AS path FROM rc_tree t "
     "WHERE t.id = 0 UNION ALL SELECT t.id, t.link, arrayConcat(path, "
     "[t.id]) FROM rc_tree t, st WHERE t.link = st.id) "
     "SELECT id, path FROM st ORDER BY id", TREE,
     [(0, [0]), (1, [0, 1]), (2, [0, 2]), (3, [0, 1, 3])]),
    ("SELECT sum(n) FROM (WITH RECURSIVE q AS (SELECT 1 AS n UNION ALL "
     "SELECT n+1 FROM q WHERE n < 4) SELECT * FROM q)", (), [(10,)]),
], ids=["sequence", "fibonacci", "bare_union_is_distinct",
        "tree_with_array_path", "nested_in_subquery"])
def test_reference_recursive_cases(sql, setup, want):
    assert _both(sql, setup)[1] == want


def test_scratch_tables_cleaned_up():
    ts, _ = _both("WITH RECURSIVE t AS (SELECT 1 AS n UNION ALL "
                  "SELECT n+1 FROM t WHERE n < 3) SELECT * FROM t")
    assert not any(n.startswith("__rcte")
                   for db in ts.catalog.databases.values()
                   for n in db.tables)


def test_f11_recursive_cte_answers():
    """F11: WITH RECURSIVE raised UnknownIdentifier ('n') in the port
    where the reference answers."""
    assert _both("WITH RECURSIVE r AS (SELECT 1 AS n UNION ALL SELECT n + 1 "
                 "FROM r WHERE n < 10) SELECT sum(n) FROM r")[1] == [(55,)]


@pytest.mark.parametrize("levels", [5, 9])
def test_hierarchy_walk_matches_reference(levels):
    """Qrec1's shape: the descendants of the root of a binary tree of
    2^levels - 1 nodes, one join an iteration."""
    n = (1 << levels) - 1
    ids = np.arange(n, dtype=np.int64)
    js, ts = jch.connect(), tch.connect(device="cpu")
    for s in (js, ts):
        s.execute("CREATE TABLE tree (id Int64, parent Int64)")
        s.insert_pydict("tree", {"id": ids, "parent": (ids - 1) // 2})
    sql = ("WITH RECURSIVE sub AS (SELECT id FROM tree WHERE id = 0 "
           "UNION ALL SELECT tree.id FROM tree JOIN sub "
           "ON tree.parent = sub.id) SELECT count(), sum(id) FROM sub")
    got = ts.execute(sql).rows()
    assert got == js.execute(sql).rows() == [(n, int(ids.sum()))]
