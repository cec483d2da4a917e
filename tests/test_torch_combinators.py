"""The aggregate combinators -Array, -ForEach, -Distinct and -OrNull /
-OrDefault of the CUDA engine against the JAX reference, on the CPU.

The same numpy-seeded rows go through ``clickhouse_tpu.connect()`` and
``clickhouse_tpu_torch.connect(device="cpu")``: ragged arrays (empty ones
among them) of Int64, UInt32 and Float64, a Nullable column, -If beside
each combinator, GROUP BY () and the sort grouping, and groups with no
row.  Integers must be equal, floats within rtol 1e-9.  An Array(String)
argument raises, naming the type.
"""
import numpy as np
import pytest

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import (NotImplementedError_, TypeError_,
                                              UnknownFunction)

FLOAT_RTOL = 1e-9
N = 3000
_SESSIONS = []


def _arr_rows(rng, n, lo, hi, kind):
    lens = rng.integers(0, 7, n)
    lens[::17] = 0                                # empty arrays
    rows = []
    for ln in lens:
        if kind == "f":
            rows.append([float(x) for x in rng.normal(size=ln).round(3)])
        else:
            rows.append([int(x) for x in rng.integers(lo, hi, ln)])
    return rows


def _pair():
    """A reference and a port session over t (k, g, v Nullable(Int64),
    u UInt32, a Array(Int64), au Array(UInt32), af Array(Float64)),
    made once for the module."""
    if not _SESSIONS:
        rng = np.random.default_rng(41)
        k = rng.integers(0, 6, N)
        v = rng.integers(-40, 40, N)
        nulls = rng.random(N) < 0.15
        cols = {"k": k, "g": rng.integers(0, 9, N), "u": rng.integers(0, 50, N),
                "v": [None if z else int(x) for x, z in zip(v, nulls)],
                "a": _arr_rows(rng, N, -100, 100, "i"),
                "au": _arr_rows(rng, N, 0, 4_000_000_000, "i"),
                "af": _arr_rows(rng, N, 0, 0, "f")}
        out = []
        for s in (jch.connect(), tch.connect(device="cpu")):
            s.execute("CREATE TABLE t (k Int64, g Int64, u UInt32, "
                      "v Nullable(Int64), a Array(Int64), au Array(UInt32), "
                      "af Array(Float64))")
            for lo in range(0, N, 1000):
                values = ", ".join(
                    f"({cols['k'][i]}, {cols['g'][i]}, {cols['u'][i]}, "
                    f"{'NULL' if cols['v'][i] is None else cols['v'][i]}, "
                    f"{cols['a'][i]}, {cols['au'][i]}, {cols['af'][i]})"
                    for i in range(lo, min(lo + 1000, N)))
                s.execute(f"INSERT INTO t VALUES {values}")
            out.append(s)
        _SESSIONS.extend(out + [cols])
    return _SESSIONS


def _close(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if np.isnan(a) or np.isnan(b):
            return np.isnan(a) and np.isnan(b)
        return abs(a - b) <= FLOAT_RTOL * max(abs(a), abs(b), 1e-300)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


def _both(sql):
    js, ts = _pair()[:2]
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    assert len(got) == len(want), (sql, got[:5], want[:5])
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_close(x, y) for x, y in zip(g, w)), \
            (sql, g, w)
    return got


GROUPINGS = {"global": ("", ""), "grouped": ("k, ", " GROUP BY k ORDER BY k")}

ARRAY_CALLS = ["sumArray(a)", "minArray(a)", "maxArray(a)", "avgArray(a)",
               "countArray(a)", "sumArray(au)", "maxArray(au)",
               "minArray(af)", "sumArray(af)", "avgArray(af)",
               "sumArrayIf(a, u > 20)", "countArrayIf(af, k != 3)",
               "maxArrayIf(a, u > 45)"]


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
@pytest.mark.parametrize("call", ARRAY_CALLS)
def test_array_combinator(call, grouping):
    head, tail = GROUPINGS[grouping]
    _both(f"SELECT {head}{call} FROM t{tail}")


FOREACH_CALLS = ["sumForEach(a)", "minForEach(a)", "maxForEach(au)",
                 "countForEach(af)", "avgForEach(af)", "sumForEach(af)",
                 "sumForEachIf(a, u > 20)", "maxForEachIf(af, k != 3)"]


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
@pytest.mark.parametrize("call", FOREACH_CALLS)
def test_foreach_combinator(call, grouping):
    head, tail = GROUPINGS[grouping]
    _both(f"SELECT {head}{call} FROM t{tail}")


def test_foreach_is_numpys():
    """sumForEach(a) by k: element j of each group's arrays summed over
    the rows that have one; the length is the group's longest array."""
    cols = _pair()[2]
    got = _pair()[1].execute("SELECT k, sumForEach(a) FROM t GROUP BY k "
                             "ORDER BY k").rows()
    for key, arr in got:
        rows = [r for kk, r in zip(cols["k"], cols["a"]) if kk == key]
        width = max(len(r) for r in rows)
        assert arr == [sum(r[j] for r in rows if len(r) > j)
                       for j in range(width)]


DISTINCT_CALLS = ["sumDistinct(u)", "countDistinct(u)", "avgDistinct(u)",
                  "sumDistinct(v)", "maxDistinct(v)", "countDistinct(v)",
                  "sumDistinctIf(u, g > 3)", "avgDistinctIf(v, g != 2)"]


@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
@pytest.mark.parametrize("call", DISTINCT_CALLS)
def test_distinct_combinator(call, grouping):
    head, tail = GROUPINGS[grouping]
    _both(f"SELECT {head}{call} FROM t{tail}")


def test_distinct_is_numpys():
    """sumDistinct(v) by k over a Nullable column: the sum of each group's
    distinct non-NULL values."""
    cols = _pair()[2]
    got = _pair()[1].execute("SELECT k, sumDistinct(v) FROM t GROUP BY k "
                             "ORDER BY k").rows()
    for key, total in got:
        vals = {v for kk, v in zip(cols["k"], cols["v"])
                if kk == key and v is not None}
        assert total == sum(vals)


ORFILL_CALLS = ["maxOrNull(v)", "minOrNull(u)", "sumOrNull(v)",
                "avgOrNull(v)", "countOrNull(v)", "sumOrDefault(v)",
                "maxOrDefault(u)", "argMaxOrNull(u, v)",
                "uniqOrNull(u)", "maxOrNullIf(v, g > 100)",
                "sumOrDefaultIf(u, g > 100)", "minOrDefault(v)",
                "avgOrDefault(u)", "anyOrNull(v)"]


@pytest.mark.parametrize("where", ["", " WHERE u > 1000", " WHERE g != 4"])
@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
@pytest.mark.parametrize("call", ORFILL_CALLS)
def test_orfill_combinator(call, grouping, where):
    """-OrNull / -OrDefault over the rows, over no row (WHERE u > 1000)
    and under -If conditions no row passes (g > 100)."""
    head, tail = GROUPINGS[grouping]
    _both(f"SELECT {head}{call} FROM t{where}{tail}")


def test_orfill_is_clickhouses():
    ts = _pair()[1]
    assert ts.execute("SELECT maxOrNull(v), sumOrDefault(u) FROM t "
                      "WHERE u > 1000").rows() == [(None, 0)]
    rows = ts.execute("SELECT k, maxOrNullIf(v, g = 8 AND u = 49) FROM t "
                      "GROUP BY k ORDER BY k").rows()
    cols = _pair()[2]
    for key, got in rows:
        vals = [v for kk, g, u, v in zip(cols["k"], cols["g"], cols["u"],
                                         cols["v"])
                if kk == key and g == 8 and u == 49 and v is not None]
        assert got == (max(vals) if vals else None)


def test_array_string_argument_raises_naming_it():
    ts = _pair()[1]
    with pytest.raises(NotImplementedError_, match=r"Array\(String\)"):
        ts.execute("CREATE TABLE s (x Array(String))")
    with pytest.raises(NotImplementedError_, match=r"Array\(String\)"):
        ts.execute("SELECT countArray(['a', 'b']) FROM t")
    with pytest.raises(NotImplementedError_, match=r"Array\(String\)"):
        ts.execute("SELECT sumForEach(['a']) FROM t")


@pytest.mark.parametrize("sql,err", [
    ("SELECT uniqArray(a) FROM t", NotImplementedError_),
    ("SELECT sumForEach(u) FROM t", NotImplementedError_),
    ("SELECT sumArrayState(a) FROM t", NotImplementedError_),
    ("SELECT sumDistinctState(u) FROM t", NotImplementedError_),
    ("SELECT medianDistinct(u) FROM t", NotImplementedError_),
    ("SELECT sumArrayOrNull(a) FROM t", UnknownFunction)])
def test_combinators_that_do_not_apply_raise(sql, err):
    """A combinator over an aggregate or argument it does not apply to,
    -State/-Merge over the other combinators, and -OrNull outside the
    others (not an aggregate name, as in the reference), raise typed
    errors."""
    with pytest.raises(err):
        _pair()[1].execute(sql)


def test_combinator_states_are_not_merged():
    """-ForEach and -Distinct keep no mergeable state (the reference's
    TypeError_)."""
    from clickhouse_tpu_torch.core import dtypes as dt
    from clickhouse_tpu_torch.exprs import aggregates as tagg
    for name, args in (("sumForEach", [dt.Array(dt.Int64)]),
                       ("sumDistinct", [dt.Int64])):
        inst, _ = tagg.get_aggregate(name, args)
        with pytest.raises(TypeError_):
            inst.merge_ops()
