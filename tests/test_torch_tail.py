"""The tail phase of chip_smoke.py (``--tail``) on the CPU at a small
size: its tables (arr's ragged arrays as ArrayRows, the five
MergeTree-family tables in four inserts, quotes, trades and tree) go into
a ``clickhouse_tpu_torch.connect(device="cpu")`` session, and each of its
queries must equal the numpy answer the smoke holds the card to
(chip_smoke.arr_answers, final_answers, asof_answers, tail_hits_answers).
The same sizes, cut as the whole smoke cuts smt, cmt and vcmt, check the
cut's answers.  The card's run of the same code is chip_smoke.py's.
"""
import numpy as np
import pytest

import chip_smoke as cs
import clickhouse_tpu_torch as tch

SMALL = {"N_ARR": 20_000, "N_FINAL": 60_000, "N_FINAL_CUT": 30_000,
         "FINAL_P": 10_007, "N_QUOTES": 20_000, "N_SYMS": 100,
         "N_TRADES": 200_000, "TREE_LEVELS": 9}
HITS = 200_000


def _tail_session(cut):
    mp = pytest.MonkeyPatch()
    for k, v in SMALL.items():
        mp.setattr(cs, k, v)
    try:
        s = tch.connect(device="cpu")
        x = (np.arange(HITS, dtype=np.int64) * 2654435761) % 1_000_003
        s.execute("CREATE TABLE hits (x Int64)")
        s.insert_pydict("hits", {"x": x})
        want = cs.tail_hits_answers(x)
        want.update(cs.load_tail_tables(s, cut))
    finally:
        mp.undo()
    return s, want


@pytest.fixture(scope="module")
def full():
    return _tail_session(False)


@pytest.fixture(scope="module")
def cut():
    return _tail_session(True)


def _run(s, sql):
    return s.execute(sql, settings=cs.tail_settings("", sql)).rows()


@pytest.mark.parametrize("name,sql", cs.TAIL_QUERIES,
                         ids=[q for q, _ in cs.TAIL_QUERIES])
def test_tail_query_matches_numpy(full, name, sql):
    s, want = full
    assert _run(s, sql) == want[name]


@pytest.mark.parametrize("name,sql", [q for q in cs.TAIL_QUERIES
                                      if q[0] in ("Qf3", "Qf4", "Qf5")],
                         ids=["Qf3", "Qf4", "Qf5"])
def test_tail_cut_tables_match_numpy(cut, name, sql):
    s, want = cut
    assert _run(s, sql) == want[name]


def test_array_rows_insert_equals_lists():
    """ArrayRows (a padded matrix and its lengths) inserts the rows a list
    a row gives, and reads back as them."""
    from clickhouse_tpu_torch.core.column import ArrayRows
    mat = np.array([[1, 2, 9], [0, 0, 0], [3, 0, 0]], np.int32)
    lens = np.array([2, 0, 1])
    a, b = tch.connect(device="cpu"), tch.connect(device="cpu")
    for s in (a, b):
        s.execute("CREATE TABLE t (i Int64, v Array(Int32))")
    a.insert_pydict("t", {"i": np.arange(3), "v": ArrayRows(mat, lens)})
    a.insert_pydict("t", {"i": np.array([3]),
                          "v": np.asarray([[5, 6, 7, 8]], object)})
    b.insert_pydict("t", {"i": np.arange(4), "v": np.asarray(
        [[1, 2], [], [3], [5, 6, 7, 8]], object)})
    sql = "SELECT i, v, length(v), arraySum(v) FROM t ORDER BY i"
    assert a.execute(sql).rows() == b.execute(sql).rows()
    with pytest.raises(ValueError):
        ArrayRows(mat, np.array([4, 0, 0]))
