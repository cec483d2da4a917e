"""Aggregate states of the CUDA engine against the JAX reference, on the
CPU: -State and -Merge, AggregateFunction columns, AggregatingMergeTree
FINAL, finalizeAggregation, initializeAggregation and runningAccumulate,
and K19's plain version (ops/state_ops.py) against the reference's
pack_state_columns / unpack_state_columns.

The same numpy-seeded rows go through ``clickhouse_tpu.connect()`` and
``clickhouse_tpu_torch.connect(device="cpu")``.  Integers and state bytes
must be equal; floats (and the float columns of a state) within rtol
1e-9, since the engines add float partials in other orders.  A state of
min, max, any, argMin/argMax or groupBitAnd is the reference's bytes
followed by the int64 count of the rows it saw (M1): its leading bytes
are compared with the reference's where it saw a row, its count with
numpy's.  Where the reference is wrong against ClickHouse (M1: an empty
min state taken as 0 by -Merge; A8: uniqMerge under GROUP BY () raises)
the divergence is pinned in tests/test_torch_ops.py DIVERGENCES.
"""
import numpy as np
import pytest
import torch

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import (CapacityError,
                                              MemoryLimitExceeded,
                                              NotImplementedError_,
                                              TypeError_)
from clickhouse_tpu_torch.exprs import aggregates as tagg
from clickhouse_tpu_torch.ops import state_ops

FLOAT_RTOL = 1e-9
N = 4000

# -- the reference's cases (tests/test_agg_state.py) --------------------------


def _src_columns(n=N, seed=3):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 5, n).astype(np.int64),
            "u": rng.integers(0, 700, n).astype(np.int64),
            "v": rng.integers(-50, 50, n).astype(np.int64),
            "f": rng.normal(size=n),
            "w": rng.integers(0, 4_000_000_000, n).astype(np.uint32),
            "b": rng.integers(0, 4, n).astype(np.uint8)}


_SESSIONS = []


def _pair():
    """A reference and a port session over src (k, u, v, f as the
    reference's test_agg_state fixture; w UInt32, b UInt8 beside them),
    made once for the module."""
    if not _SESSIONS:
        cols = _src_columns()
        out = []
        for s in (jch.connect(), tch.connect(device="cpu")):
            s.execute("CREATE TABLE src (k Int64, u Int64, v Int64, "
                      "f Float64, w UInt32, b UInt8)")
            s.insert_pydict("src", cols)
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


def _both(sql, sessions=None):
    js, ts = (sessions or _pair())[:2]
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    assert len(got) == len(want), (sql, got[:5], want[:5])
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_close(x, y) for x, y in zip(g, w)), \
            (sql, g, w)
    return got


BASIC = ["sum(v)", "count()", "min(v)", "max(v)", "avg(v)", "any(v)",
         "sum(f)", "avg(f)", "varPop(v)", "stddevSamp(f)", "argMax(v, u)"]


@pytest.mark.parametrize("call", BASIC)
def test_state_merge_round_trip(call):
    """fnState -> subquery -> fnMerge: the reference's answer, and the
    port's fn directly."""
    fn = call.split("(")[0]
    args = call[len(fn):]
    via = _both(f"SELECT k, {fn}Merge(st) AS r FROM "
                f"(SELECT k, {fn}State{args} AS st FROM src GROUP BY k) "
                "GROUP BY k ORDER BY k")
    direct = _pair()[1].execute(
        f"SELECT k, {fn}{args} AS r FROM src GROUP BY k ORDER BY k").rows()
    assert all(_close(a, b) for x, y in zip(via, direct)
               for a, b in zip(x, y)), (via, direct)


def test_state_type_name():
    js, ts = _pair()[:2]
    r = ts.execute("SELECT sumState(v) FROM src")
    assert r.types == js.execute("SELECT sumState(v) FROM src").types
    assert r.types[0][1] == "AggregateFunction(sum, Int64)"
    assert isinstance(r.rows()[0][0], bytes)
    _both("SELECT sumState(v) FROM src")


def test_aggregating_merge_tree_final():
    sessions = _fresh()
    for s in sessions[:2]:
        s.execute("CREATE TABLE agg (k Int64, c AggregateFunction(count, "
                  "Int64), s AggregateFunction(sum, Int64)) "
                  "ENGINE = AggregatingMergeTree ORDER BY k")
        for _ in range(2):
            s.execute("INSERT INTO agg SELECT k, countState(v), sumState(v) "
                      "FROM src GROUP BY k")
    exp = sessions[1].execute("SELECT k, count() * 2, sum(v) * 2 FROM src "
                              "GROUP BY k ORDER BY k").rows()
    assert _both("SELECT k, countMerge(c), sumMerge(s) FROM agg GROUP BY k "
                 "ORDER BY k", sessions) == exp
    assert _both("SELECT k, finalizeAggregation(c), finalizeAggregation(s) "
                 "FROM agg FINAL ORDER BY k", sessions) == exp


def test_uniq_state_merge_tolerance():
    """uniqState over two inserts: the reference's estimates within 1 (the
    registers are the same; the estimate sums 2^-register in another
    order), and within the reference's 10 % of the exact count."""
    sessions = _fresh()
    for s in sessions[:2]:
        s.execute("CREATE TABLE ua (k Int64, st AggregateFunction(uniq, "
                  "Int64)) ENGINE = AggregatingMergeTree ORDER BY k")
        s.execute("INSERT INTO ua SELECT k, uniqState(u) FROM src GROUP BY k")
        s.execute("INSERT INTO ua SELECT k, uniqState(u + 1000) FROM src "
                  "GROUP BY k")
    sql = "SELECT k, uniqMerge(st) FROM ua GROUP BY k ORDER BY k"
    want = sessions[0].execute(sql).rows()
    got = sessions[1].execute(sql).rows()
    exact = sessions[1].execute("SELECT k, uniqExact(u) * 2 FROM src "
                                "GROUP BY k ORDER BY k").rows()
    for (k1, u), (k2, e), (k3, r) in zip(got, exact, want):
        assert k1 == k2 == k3 and abs(u - r) <= 1
        assert abs(u - e) / e < 0.1
    assert sessions[1].execute("SELECT k, u FROM (SELECT k, st AS u FROM "
                               "ua) ORDER BY k").row_count == 10
    _both("SELECT k, st FROM ua ORDER BY k, finalizeAggregation(st)",
          sessions)


def test_state_if_combinator():
    direct = _pair()[1].execute(
        "SELECT k, sumIf(v, v > 0) FROM src GROUP BY k ORDER BY k").rows()
    for form in ("sumStateIf(v, v > 0)", "sumIfState(v, v > 0)"):
        via = _both(f"SELECT k, sumMerge(st) FROM (SELECT k, {form} AS st "
                    "FROM src GROUP BY k) GROUP BY k ORDER BY k")
        assert via == direct


def test_merge_type_mismatch_raises():
    with pytest.raises(TypeError_, match="cannot merge"):
        _pair()[1].execute(
            "SELECT maxMerge(st) FROM (SELECT sumState(v) AS st FROM src)")


@pytest.mark.parametrize("sql,err", [
    ("SELECT groupArrayState(v) FROM src", TypeError_),
    ("SELECT quantileState(0.5)(v) FROM src", TypeError_),
    ("SELECT topKState(3)(v) FROM src", TypeError_),
    ("SELECT uniqExactState(v) FROM src", NotImplementedError_)])
def test_state_of_nonmergeable_raises(sql, err):
    """The reference's refusal (TypeError_) of a state it cannot merge;
    uniqExact's state, which the reference merges by adding distinct
    counts, is not ported."""
    with pytest.raises(err):
        _pair()[1].execute(sql)
    if err is TypeError_:
        with pytest.raises(Exception):
            _pair()[0].execute(sql)


def test_state_of_a_string_raises():
    sessions = _fresh()
    for s in sessions[:2]:
        s.execute("CREATE TABLE st (k Int64, s String)")
        s.execute("INSERT INTO st VALUES (1, 'a'), (2, 'b')")
    with pytest.raises(NotImplementedError_, match="String"):
        sessions[1].execute("SELECT minState(s) FROM st")


def test_finalize_aggregation_global():
    got = _both("SELECT finalizeAggregation(st) FROM "
                "(SELECT avgState(v) AS st FROM src)")
    exp = _pair()[1].execute("SELECT avg(v) FROM src").scalar()
    assert got[0][0] == pytest.approx(exp, rel=1e-12)


# -- every mergeable aggregate's state bytes ------------------------------------

# the arguments of each class's states in the comparison (w is UInt32: 4-
# byte min/max/any/groupBit states, argMax(UInt32, Int64)'s 12 bytes)
_ARGS = {"CountAgg": "v", "SumAgg": "v", "SumWithOverflowAgg": "w",
         "MinAgg": "w", "MaxAgg": "f", "AvgAgg": "v", "AnyAgg": "w",
         "AnyRespectNullsAgg": "v", "VarPopAgg": "f", "VarSampAgg": "v",
         "StddevPopAgg": "v", "StddevSampAgg": "f", "ArgMinAgg": "v, f",
         "ArgMaxAgg": "w, v", "CovarPopAgg": "v, f", "CovarSampAgg": "f, u",
         "CorrAgg": "u, f", "SkewPopAgg": "f", "SkewSampAgg": "v",
         "KurtPopAgg": "f", "KurtSampAgg": "u", "AvgWeightedAgg": "f, u",
         "GroupBitAndAgg": "w", "GroupBitOrAgg": "w", "GroupBitXorAgg": "b",
         "HLLUniqAgg": "u"}
_TYPES = {"v": "Int64", "u": "Int64", "f": "Float64", "w": "UInt32",
          "b": "UInt8"}


def _mergeable_names():
    """Every name of the port's registry whose state is stored."""
    from clickhouse_tpu_torch.core import dtypes as dt
    out = []
    for name in sorted(tagg._BASE):
        cls = tagg._BASE[name]
        args = _ARGS.get(cls.__name__)
        if args is None:
            continue
        inst = cls([dt.parse_type_name(_TYPES[a.strip()])
                    for a in args.split(",")])
        try:
            tagg._check_mergeable(inst, name)
        except (TypeError_, NotImplementedError_):
            continue
        out.append(name)
    return out


MERGEABLE = _mergeable_names()
_NOT_STORED = ("countdistinct", "entropy", "grouparray", "grouparraydistinct",
               "groupbitmap", "groupuniqarray", "topk", "uniqexact",
               "uniqthetasketch")
# the aggregate tail (exprs/agg_ext*.py): holistic, or mergeable with no
# stored layout yet (singleValueOrNull, retention, nothing); aggThrow(p)
# raises when it is made for p > 0
_TAIL_NOT_STORED = (
    "boundingratio", "contingency", "cramersv", "cramersvbiascorrected",
    "deltasum", "deltasumtimestamp", "exponentialmovingaverage",
    "exponentialtimedecayedavg", "exponentialtimedecayedcount",
    "exponentialtimedecayedmax", "exponentialtimedecayedsum",
    "grouparraylast", "grouparraymovingavg", "grouparraymovingsum",
    "grouparraysample", "grouparraysorted", "intervallengthsum",
    "maxintersections", "maxintersectionsposition", "nothing", "rankcorr",
    "retention", "sequencematch", "singlevalueornull", "theilsu",
    "topkweighted", "uniqupto", "windowfunnel", "aggthrow")
_TAIL_PARAMS = {"sequencematch": ["(?1)"], "aggthrow": [0]}


def test_every_registry_name_is_stored_or_refused():
    """Every aggregate of the registry either stores its state (and is
    compared below) or is a holistic one whose -State raises (the tail's
    two-argument ones made over two Int64 columns)."""
    from clickhouse_tpu_torch.core import dtypes as dt
    for name in sorted(tagg._BASE):
        if name in MERGEABLE:
            continue
        assert name in _NOT_STORED or name in _TAIL_NOT_STORED \
            or "quantile" in name or "median" in name, name
        two = "weighted" in name or name in _TAIL_NOT_STORED and name not in (
            "uniqupto", "deltasum", "grouparraymovingsum",
            "grouparraymovingavg", "grouparraysorted", "grouparraylast",
            "grouparraysample")
        inst, _ = tagg.get_aggregate(name, [dt.Int64] * (2 if two else 1),
                                     _TAIL_PARAMS.get(name))
        with pytest.raises((TypeError_, NotImplementedError_)):
            tagg._check_mergeable(inst, name)


# GROUP BY () (K1), a sort grouping of a wide key, and a key the dense
# grouping would take for sums (states take the sort grouping, as the
# reference's: StateAgg.sum_only is False)
GROUPINGS = {"global": "", "sort": "k", "small_key": "b"}
FORMS = {"State": "", "StateIf": "k != 2 AND v > -20"}
_RUNS = {}


def _state_call(name, form) -> str:
    args = _ARGS[tagg._BASE[name].__name__]
    cond = FORMS[form]
    return f"{name}{form}({args}{', ' + cond if cond else ''})"


def _state_run(grouping, form):
    """One query of every mergeable aggregate's -State (or -StateIf) under
    one grouping through both engines, cached: -> (reference rows, port
    rows)."""
    key = (grouping, form)
    if key not in _RUNS:
        js, ts = _pair()[:2]
        g = GROUPINGS[grouping]
        calls = ", ".join(_state_call(n, form) for n in MERGEABLE)
        sql = (f"SELECT {g + ', ' if g else ''}{calls} FROM src"
               + (f" GROUP BY {g} ORDER BY {g}" if g else ""))
        _RUNS[key] = (js.execute(sql).rows(), ts.execute(sql).rows())
    return _RUNS[key]


def _decode(b: bytes, spec):
    out, off = [], 0
    for d, w in spec:
        nb = d.itemsize * w
        out.append(np.frombuffer(b[off:off + nb], d))
        off += nb
    return out


def _numpy_counts(grouping, form):
    """Rows a group's state saw, in key order (numpy)."""
    c = _pair()[2]
    m = np.ones(N, bool) if form == "State" \
        else (c["k"] != 2) & (c["v"] > -20)
    g = GROUPINGS[grouping]
    if not g:
        return [int(m.sum())]
    keys = np.unique(c[g])
    return [int(m[c[g] == key].sum()) for key in keys]


def _mix(z):
    with np.errstate(over="ignore"):
        z = z.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _np_group_registers(grouping, form, m=4096):
    """numpy's registers of uniqState(u) (splitmix64 of u's bits) a group
    of the grouping, over the rows of the form's condition."""
    c = _pair()[2]
    keep = np.ones(N, bool) if form == "State" \
        else (c["k"] != 2) & (c["v"] > -20)
    g = GROUPINGS[grouping]
    gid = np.zeros(N, np.int64) if not g \
        else np.searchsorted(np.unique(c[g]), c[g])
    log2m = m.bit_length() - 1
    h = _mix(c["u"].view(np.uint64))
    reg = (h & np.uint64(m - 1)).astype(np.int64)
    w = (h >> np.uint64(log2m)) | (np.uint64(1) << np.uint64(64 - log2m))
    rho = np.log2((w & (~w + np.uint64(1))).astype(np.float64)) \
        .astype(np.int64) + 1
    out = np.zeros((int(gid.max()) + 1, m), np.uint8)
    np.maximum.at(out, (gid[keep], reg[keep]), rho[keep].astype(np.uint8))
    return out


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
@pytest.mark.parametrize("name", MERGEABLE)
def test_state_bytes_match_reference(name, grouping, form):
    """A state's bytes are the reference's (floats within rtol); a state
    that keeps presence ends with numpy's row count, and its leading
    bytes are the reference's where it saw a row."""
    from clickhouse_tpu_torch.core import dtypes as dt
    want_rows, got_rows = _state_run(grouping, form)
    col = MERGEABLE.index(name) + (1 if GROUPINGS[grouping] else 0)
    args = _ARGS[tagg._BASE[name].__name__]
    inst, _ = tagg.get_aggregate(
        name, [dt.parse_type_name(_TYPES[a.strip()]) for a in args.split(",")])
    inst.pin_state_layout()
    spec = tagg.state_spec(inst)
    ref_spec = spec[:-1] if inst.keeps_presence else spec
    counts = _numpy_counts(grouping, form)
    assert len(got_rows) == len(want_rows) == len(counts)
    hll = tagg._BASE[name].__name__ == "HLLUniqAgg"
    if hll:
        model = _np_group_registers(grouping, form)
    for i, (got_row, want_row, cnt) in enumerate(zip(got_rows, want_rows,
                                                     counts)):
        got, want = got_row[col], want_row[col]
        assert len(got) == tagg.state_width_bytes(spec)
        parts = _decode(got, spec)
        if hll:
            # numpy's registers; the reference's where it is right (A6:
            # its grouped -If registers are not numpy's past group 0)
            assert np.array_equal(parts[0], model[i]), name
            if form == "StateIf" and GROUPINGS[grouping]:
                continue
        if inst.keeps_presence:
            assert int(parts[-1][0]) == cnt, (name, cnt, parts[-1])
            if cnt == 0:
                continue                  # M1: the reference holds 0
        assert len(want) == tagg.state_width_bytes(ref_spec)
        for (d, _), g, w in zip(ref_spec, parts, _decode(want, ref_spec)):
            if d.kind == "f":
                np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL,
                                           equal_nan=True)
            else:
                assert np.array_equal(g, w), (name, g, w)


def _is_hll(name: str) -> bool:
    return tagg._BASE[name].__name__ == "HLLUniqAgg"


def _own_name(name: str) -> str:
    from clickhouse_tpu_torch.core import dtypes as dt
    args = _ARGS[tagg._BASE[name].__name__]
    return tagg.get_aggregate(name, [dt.parse_type_name(_TYPES[a.strip()])
                                     for a in args.split(",")])[0].name


@pytest.mark.parametrize("grouping", ["global", "sort"])
@pytest.mark.parametrize("name", MERGEABLE)
def test_merge_of_every_state(name, grouping):
    """-Merge of each stored state over the groups of k: the reference's
    answer (the port's M1 empty states never arise: every state saw a
    row)."""
    key = ("merge", grouping)
    if key not in _RUNS:
        # a state's type names the aggregate's own name (an alias's
        # state is its class's: any_value's is AggregateFunction(any, ..))
        calls = ", ".join(f"{_own_name(n)}Merge(c{i})"
                          for i, n in enumerate(MERGEABLE))
        inner = ", ".join(f"{_state_call(n, 'State')} AS c{i}"
                          for i, n in enumerate(MERGEABLE))
        g = "k % 2 AS g, " if grouping == "sort" else ""
        sql = (f"SELECT {g}{calls} FROM (SELECT k, {inner} FROM src "
               f"GROUP BY k)" + (" GROUP BY g ORDER BY g"
                                 if grouping == "sort" else ""))
        js, ts = _pair()[:2]
        got = ts.execute(sql).rows()
        if grouping == "global":
            # A8: the reference's uniqMerge under GROUP BY () raises, so
            # its query leaves the uniq columns out (NaN in their places)
            keep = [i for i, n in enumerate(MERGEABLE) if not _is_hll(n)]
            sql = "SELECT " + ", ".join(
                f"{_own_name(MERGEABLE[i])}Merge(c{i})" for i in keep) \
                + f" FROM (SELECT k, {inner} FROM src GROUP BY k)"
            row = js.execute(sql).rows()[0]
            full = [float("nan")] * len(MERGEABLE)
            for i, v in zip(keep, row):
                full[i] = v
            want = [tuple(full)]
        else:
            want = js.execute(sql).rows()
        _RUNS[key] = (want, got)
    want, got = _RUNS[key]
    col = MERGEABLE.index(name) + (1 if grouping == "sort" else 0)
    hll = _is_hll(name)
    if grouping == "global" and hll:
        # A8: the reference's uniqMerge under GROUP BY () raises; the port
        # answers: the merged registers' estimate of every row
        direct = _pair()[1].execute(f"SELECT uniqExact(u) FROM src").scalar()
        assert abs(got[0][col] - direct) / direct < 0.1
        return
    for g, w in zip(got, want):
        if hll:
            assert abs(g[col] - w[col]) <= 1
        else:
            assert _close(g[col], w[col]), (name, g[col], w[col])


# -- AggregatingMergeTree FINAL -----------------------------------------------

def _fresh():
    """A new reference and port session with src (its tables of their
    own)."""
    cols = _pair()[2]
    out = []
    for s in (jch.connect(), tch.connect(device="cpu")):
        s.execute("CREATE TABLE src (k Int64, u Int64, v Int64, f Float64, "
                  "w UInt32, b UInt8)")
        s.insert_pydict("src", cols)
        out.append(s)
    return out + [cols]


def test_final_over_parts_with_duplicate_keys():
    """Four inserts of overlapping keys into an AggregatingMergeTree of
    count, sum, avg, min, max, argMax and uniq states: FINAL keeps one row
    a key whose states are the merged ones; numpy's sums and counts."""
    sessions = _fresh()
    cols = sessions[2]
    for s in sessions[:2]:
        s.execute("CREATE TABLE am (k Int64, c AggregateFunction(count), "
                  "s AggregateFunction(sum, Int64), a AggregateFunction("
                  "avg, Float64), mn AggregateFunction(min, Int64), "
                  "mx AggregateFunction(max, UInt32), "
                  "am AggregateFunction(argMax, Int64, Float64), "
                  "uq AggregateFunction(uniq, Int64)) "
                  "ENGINE = AggregatingMergeTree ORDER BY k")
        for i in range(4):
            s.execute(f"INSERT INTO am SELECT u % 97 AS k, countState(), "
                      f"sumState(v), avgState(f), minState(v), maxState(w), "
                      f"argMaxState(u, f), uniqState(u) FROM src "
                      f"WHERE u % 4 = {i} OR k = {i} GROUP BY k")
    got = _both("SELECT k, finalizeAggregation(c), finalizeAggregation(s), "
                "finalizeAggregation(a), finalizeAggregation(mn), "
                "finalizeAggregation(mx), finalizeAggregation(am) "
                "FROM am FINAL ORDER BY k", sessions)
    u, v = cols["u"], cols["v"]
    for key, c, s_, *_ in got:
        # WHERE's k is the SELECT's alias, u % 97
        sel = (u % 97 == key)
        rows = sum(((u % 4 == i) | (u % 97 == i)) & sel for i in range(4))
        assert c == int(rows.sum()) and s_ == int((rows * v).sum())
    est = sessions[1].execute("SELECT k, finalizeAggregation(uq) FROM am "
                              "FINAL ORDER BY k").rows()
    ref = sessions[1].execute("SELECT k, uniqMerge(uq) FROM am GROUP BY k "
                              "ORDER BY k").rows()
    assert est == ref
    _both("SELECT count(), sum(finalizeAggregation(s)) FROM am FINAL",
          sessions)


def test_final_merges_ties_newest_first():
    """F12: FINAL merges each key's states newest insertion first, as the
    reference's FINAL grouping orders them (anti_rowid), so a merge that
    keeps one partial keeps the newest part's: argMax at an order value
    every part ties on, and any.  Three inserts of every key; the rows of
    the reference and numpy's newest part."""
    sessions = _fresh()
    cols = sessions[2]
    for s in sessions[:2]:
        s.execute("CREATE TABLE at (k Int64, am AggregateFunction(argMax, "
                  "Int64, UInt8), an AggregateFunction(any, Int64), "
                  "mx AggregateFunction(max, Int64)) "
                  "ENGINE = AggregatingMergeTree ORDER BY k")
        for i in range(3):
            s.execute(f"INSERT INTO at SELECT k, argMaxState(v + {1000 * i}, "
                      f"toUInt8(1)), anyState(v + {1000 * i}), maxState(v) "
                      f"FROM src WHERE u % 3 != {i} GROUP BY k")
    got = _both("SELECT k, finalizeAggregation(am), finalizeAggregation(an), "
                "finalizeAggregation(mx) FROM at FINAL ORDER BY k", sessions)
    k, u, v = cols["k"], cols["u"], cols["v"]
    for key, am, an, mx in got:
        rows = np.flatnonzero((k == key) & (u % 3 != 2))
        assert am == an == int(v[rows[0]]) + 2000, (key, am, an)
        assert mx == int(v[k == key].max())


@pytest.mark.parametrize("state,newest_first", [
    ("sumState(v)", False), ("maxState(v)", False), ("avgState(f)", False),
    ("groupBitAndState(u)", False), ("anyState(v)", True),
    ("anyLastState(v)", True), ("argMaxState(v, toUInt8(1))", True),
    ("argMinState(v, u)", True)])
def test_final_reverses_only_merges_that_keep_a_row(state, newest_first,
                                                    monkeypatch):
    """FINAL puts a key's states newest first (agg_ops.reversed_rows) only
    for a merge that keeps one partial by its row id (any, anyLast,
    argMin/argMax); the others merge the states as stored.  Either way
    the rows are the reference's."""
    from clickhouse_tpu_torch.ops import agg_ops
    reversed_rows = agg_ops.reversed_rows
    calls = []

    def watch(*a):
        calls.append(a[1])
        return reversed_rows(*a)
    monkeypatch.setattr(agg_ops, "reversed_rows", watch)
    sessions = _fresh()
    fn = state[:state.index("State")]
    args = "Int64, UInt8" if "toUInt8" in state else "Int64, Int64" \
        if fn.startswith("arg") else "Float64" if fn == "avg" else "Int64"
    for s in sessions[:2]:
        s.execute(f"CREATE TABLE fr (k Int64, st AggregateFunction({fn}, "
                  f"{args})) ENGINE = AggregatingMergeTree ORDER BY k")
        for i in range(2):
            s.execute(f"INSERT INTO fr SELECT k, {state} FROM src "
                      f"WHERE u % 2 = {i} GROUP BY k")
    _both("SELECT k, finalizeAggregation(st) FROM fr FINAL ORDER BY k",
          sessions)
    assert bool(calls) == newest_first, (state, calls)


def test_final_past_max_groups_replans():
    """FINAL over more keys than max_groups raises CapacityError naming the
    setting; the session re-plans with more slots and answers."""
    ts = tch.connect(device="cpu")
    ts.execute("CREATE TABLE big (k Int64, s AggregateFunction(sum, Int64)) "
               "ENGINE = AggregatingMergeTree ORDER BY k")
    ts.execute("CREATE TABLE raw (k Int64)")
    keys = np.arange(3000, dtype=np.int64)
    ts.insert_pydict("raw", {"k": np.concatenate([keys, keys[::3]])})
    ts.execute("INSERT INTO big SELECT k, initializeAggregation('sumState', "
               "k) FROM raw")
    sql = "SELECT count(), sum(finalizeAggregation(s)) FROM big FINAL"
    want = [(3000, int(keys.sum() + keys[::3].sum()))]
    with pytest.raises(CapacityError) as e:
        ts.execute(sql, settings={"max_groups": 1024,
                                  "capacity_autotune": 0})
    assert e.value.setting == "max_groups" and e.value.needed == 3000
    assert ts.execute(sql, settings={"max_groups": 1024}).rows() == want


def test_insert_keeps_a_state_matrix():
    """INSERT ... SELECT stores a state column as one (rows, B) uint8
    matrix, never a bytes object a row; a value of another width raises
    naming the layout."""
    ts = _pair()[1]
    ts.execute("CREATE TABLE keep (k Int64, s AggregateFunction(avg, Int64))")
    ts.execute("INSERT INTO keep SELECT k, avgState(v) FROM src GROUP BY k")
    part = ts.catalog.get_table("default", "keep").parts[0].columns["s"]
    assert part.dtype == np.uint8 and part.shape == (5, 16)
    with pytest.raises(TypeError_, match="16 bytes"):
        ts.execute("INSERT INTO keep VALUES (1, 'abc')")
    row = ts.execute("SELECT s FROM keep ORDER BY k LIMIT 1").rows()[0][0]
    ts.execute("CREATE TABLE keep2 (k Int64, s AggregateFunction(avg, "
               "Int64))")
    ts.insert_pydict("keep2", {"k": np.array([7]),
                               "s": np.array([row], dtype=object)})
    assert ts.execute("SELECT s FROM keep2").rows()[0][0] == row


def test_state_plan_does_not_stream():
    """At max_device_block_bytes = 1 every table is big; a plan reading a
    state column is not streamed (its column is not chunked), and answers
    as the reference does."""
    sessions = _fresh()
    for s in sessions[:2]:
        s.execute("CREATE TABLE sp (k Int64, s AggregateFunction(sum, "
                  "Int64)) ENGINE = AggregatingMergeTree ORDER BY k")
        s.execute("INSERT INTO sp SELECT k, sumState(v) FROM src GROUP BY k")
    ts = sessions[1]
    before = ts.profile_events.get("StreamedQueries", 0)
    for sql in ("SELECT k, sumMerge(s) FROM sp GROUP BY k ORDER BY k",
                "SELECT sum(finalizeAggregation(s)) FROM sp FINAL"):
        want = sessions[0].execute(sql).rows()
        got = ts.execute(sql, settings={"max_device_block_bytes": 1}).rows()
        assert got == want
    assert ts.profile_events.get("StreamedQueries", 0) == before


def test_unpacked_states_held_against_the_budget():
    """-Merge holds its unpacked states against the budget before it
    unpacks them."""
    sessions = _fresh()
    ts = sessions[1]
    ts.execute("CREATE TABLE hb (k Int64, s AggregateFunction(avg, Int64))")
    ts.execute("INSERT INTO hb SELECT u, avgState(v) FROM src GROUP BY u")
    sql = "SELECT avgMerge(s) FROM hb SETTINGS max_device_memory_bytes = {}"
    from clickhouse_tpu_torch.exec.streaming import \
        estimate_plan_device_bytes
    from clickhouse_tpu_torch.sql import parse
    est = estimate_plan_device_bytes(ts._plan(parse(sql.format(1 << 30)),
                                              ts.settings), ts.catalog,
                                     ts.settings)
    # more than the estimate, less than it and the 1,024 x 16 bytes of the
    # unpacked states
    with pytest.raises(MemoryLimitExceeded, match="unpacked states"):
        ts.execute(sql.format(est + 8192))
    assert ts.execute(sql.format(1 << 30)).row_count == 1


def test_uniq_state_over_the_groups_present():
    """uniqState's 4,096-byte rows are built over the groups present, not
    the grouping's slots (AggregateStateSlots), and agree with the
    reference's registers."""
    sessions = _fresh()
    ts = sessions[1]
    sql = "SELECT k, uniqState(u) FROM src GROUP BY k ORDER BY k"
    before = ts.profile_events.get("AggregateStateSlots", 0)
    got = ts.execute(sql, settings={"max_groups": 1 << 16}).rows()
    assert ts.profile_events["AggregateStateSlots"] - before == 1024
    want = sessions[0].execute(sql).rows()
    assert got == want


# -- the state functions ------------------------------------------------------

@pytest.mark.parametrize("fn", ["sum", "min", "max", "avg", "any"])
def test_finalize_initialize_running(fn):
    """finalizeAggregation of grouped states, initializeAggregation's
    per-row states (their bytes the reference's, less the presence
    count), and runningAccumulate down a sorted block."""
    ts = _pair()[1]
    _both(f"SELECT k, finalizeAggregation(st) FROM (SELECT k, {fn}State(v) "
          f"AS st FROM src GROUP BY k) ORDER BY k")
    _both(f"SELECT finalizeAggregation(initializeAggregation('{fn}State', "
          f"v)) AS r FROM src ORDER BY r LIMIT 50")
    _both(f"SELECT k, runningAccumulate(st) FROM (SELECT k, {fn}State(v) "
          f"AS st FROM src GROUP BY k ORDER BY k)")
    js = _pair()[0]
    want = js.execute(f"SELECT initializeAggregation('{fn}State', v) "
                      f"FROM src LIMIT 5").rows()
    got = ts.execute(f"SELECT initializeAggregation('{fn}State', v) "
                     f"FROM src LIMIT 5").rows()
    for (g,), (w,) in zip(got, want):
        assert g[:len(w)] == w
    if fn in ("min", "max", "any"):
        assert all(g[len(w):] == (1).to_bytes(8, "little")
                   for (g,), (w,) in zip(got, want))


def test_running_accumulate_of_a_big_block():
    """Qm7's shape at a small size: a state a distinct value, in key order,
    accumulated down the block (K17's plain version): numpy's cumulative
    sums."""
    ts = _pair()[1]
    c = _pair()[2]
    rows = ts.execute("SELECT k, runningAccumulate(s) FROM (SELECT u AS k, "
                      "sumState(u) AS s FROM src GROUP BY k ORDER BY k)"
                      ).rows()
    vals, cnt = np.unique(c["u"], return_counts=True)
    assert [r[0] for r in rows] == vals.tolist()
    assert [r[1] for r in rows] == np.cumsum(vals * cnt).tolist()


# -- K19's plain version against the reference ---------------------------------

# state layouts of the widths K19 is held at on the card: B = 2, 4, 6, 9,
# 12, 16, 20, 24, 36, 40 and 4,096
LAYOUTS = {2: ["int16"], 4: ["uint32"], 6: ["uint16", "uint32"],
           9: ["uint8", "int64"], 12: ["uint64", "uint32"],
           16: ["float64", "int64"], 20: ["uint64", "int32", "int64"],
           24: ["float64", "float64", "int64"],
           36: ["float64"] * 4 + ["uint32"],
           40: ["float64"] * 4 + ["int64"], 4096: [("uint8", 4096)],
           "every": ["bool", "int8", "uint8", "int16", "uint16", "int32",
                     "uint32", "float32", "int64", "uint64", "float64"]}
# K19's word width at each layout with every base address 16-aligned: the
# largest of 16, 8, 4, 2, 1 dividing B and each column's row bytes
K19_WORD = {2: 2, 4: 4, 6: 2, 9: 1, 12: 4, 16: 8, 20: 4, 24: 8, 36: 4,
            40: 8, 4096: 16, "every": 1}


def _layout(name):
    return [(np.dtype(d), 1) if isinstance(d, str) else (np.dtype(d[0]), d[1])
            for d in LAYOUTS[name]]


def _columns(spec, n, rng):
    out = []
    for d, w in spec:
        shape = (n,) if w == 1 else (n, w)
        if d.kind == "f":
            a = rng.normal(size=shape).astype(d)
        elif d.kind == "b":
            a = rng.integers(0, 2, shape).astype(bool)
        else:
            info = np.iinfo(d)
            a = rng.integers(info.min, info.max, shape, dtype=d,
                             endpoint=True)
        out.append(a)
    return out


def _torch_of(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "u" and a.dtype.itemsize > 1:
        a = a.view(f"int{8 * a.dtype.itemsize}")
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [0, 1, 7, 1025])
@pytest.mark.parametrize("layout", sorted(LAYOUTS, key=str))
def test_k19_plain_matches_reference(layout, n):
    """pack and unpack (with and without dst_rows / src_rows) against the
    reference's pack_state_columns / unpack_state_columns over every
    element type and each width."""
    import jax.numpy as jnp
    from clickhouse_tpu.exprs.aggregates import (pack_state_columns,
                                                 unpack_state_columns)
    rng = np.random.default_rng(19)
    spec = _layout(layout)
    cols = _columns(spec, n, rng)
    width = sum(d.itemsize * w for d, w in spec)
    if n:
        want = np.asarray(pack_state_columns([jnp.asarray(c) for c in cols]))
    else:
        want = np.zeros((0, width), np.uint8)
    tcols = [_torch_of(c) for c in cols]
    got = state_ops.pack_state_rows(tcols)
    assert got.numpy().tobytes() == want.tobytes() \
        and got.shape == (n, width)
    layout_t = [(t.dtype, w) for t, (_, w) in zip(tcols, spec)]
    back = state_ops.unpack_state_rows(got, layout_t)
    if n:
        ref_back = unpack_state_columns(jnp.asarray(want), spec)
        for b, r in zip(back, ref_back):
            assert b.numpy().tobytes() == np.asarray(r).astype(
                np.asarray(r).dtype).tobytes()
    for b, t in zip(back, tcols):
        assert torch.equal(b, t)
    # dst_rows: each row to a row of a bigger matrix, the others kept
    out = torch.from_numpy(rng.integers(0, 256, (n + 5, width),
                                        dtype=np.uint8))
    dst = torch.from_numpy(rng.permutation(n + 5)[:n].astype(np.int64))
    before = out.clone()
    state_ops.pack_state_rows(tcols, dst_rows=dst, out=out)
    assert torch.equal(out[dst], got)
    rest = torch.ones(n + 5, dtype=torch.bool)
    rest[dst] = False
    assert torch.equal(out[rest], before[rest])
    # src_rows: the columns of chosen rows, one twice
    src = torch.cat([dst, dst[:1]]) if n else dst
    picked = state_ops.unpack_state_rows(out, layout_t, src)
    for p, t in zip(picked, tcols):
        assert torch.equal(p, t[torch.cat([torch.arange(n),
                                           torch.arange(min(n, 1))])])


@pytest.mark.parametrize("offset", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("side", ["packed", "column"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS, key=str))
def test_k19_plan_word_width(layout, side, offset):
    """k19_plan's word width at each layout, with the packed matrix's or
    the last column's address `offset` bytes past a 16-byte boundary, and
    its word table: word j of the packed row is word k of column c's row,
    the same bytes as the reference's layout puts there."""
    spec = _layout(layout)
    widths = [d.itemsize * w for d, w in spec]
    ptrs = [1 << 20] + [(i + 2) << 20 for i in range(len(widths))]
    ptrs[0 if side == "packed" else -1] += offset
    w, words = state_ops.k19_plan(widths, ptrs)
    want = K19_WORD[layout]
    if offset:
        want = min(want, offset & -offset)
    assert w == want
    starts = np.cumsum([0] + widths)
    assert len(words) == starts[-1] // w
    assert [int(starts[c]) + k * w for c, k in words] == \
        list(range(0, int(starts[-1]), w))


@pytest.mark.parametrize("case", ["row_slice", "column_slice",
                                  "prefix_slice"])
def test_k19_plan_of_views(case):
    """The width _ptrs takes from tensors: a packed matrix sliced a row in
    (m[1:] of B = 12: 12 bytes past its base), an int32 column sliced an
    element in (4 bytes), and a prefix slice (the base kept)."""
    m = torch.zeros((5, 12), dtype=torch.uint8)
    a, b = torch.zeros(5, dtype=torch.int64), torch.zeros(6, dtype=torch.int32)
    if case == "row_slice":
        cols, packed, want = [a[1:], b[2:]], m[1:], 4
    elif case == "column_slice":
        cols, packed, want = [torch.zeros(4, dtype=torch.int32), b[1:5]], \
            torch.zeros((4, 8), dtype=torch.uint8), 4
    else:
        cols, packed, want = [a[:3], a[:3]], torch.zeros((3, 16),
                                                          dtype=torch.uint8), 8
    ptrs, cb, w = state_ops._ptrs(cols, packed)
    assert w == want and list(cb) == [c.element_size() for c in cols]
    assert list(ptrs) == [c.data_ptr() for c in cols]
    assert state_ops.k19_plan([12], [16]) == (4, [(0, 0), (0, 1), (0, 2)])
    assert state_ops.k19_plan([8, 4], [0, 0, 0]) == (4, [(0, 0), (0, 1),
                                                         (1, 0)])
    assert state_ops.k19_plan([8, 8], [0, 0, 0]) == (8, [(0, 0), (1, 0)])


def test_k19_refuses_bad_shapes():
    with pytest.raises(ValueError):
        state_ops.unpack_state_rows(torch.zeros((3, 5), dtype=torch.uint8),
                                    [(torch.int64, 1)])
    with pytest.raises(ValueError):
        state_ops.pack_state_rows([torch.zeros(3), torch.zeros(4)])
    with pytest.raises(ValueError):
        state_ops.pack_state_rows([torch.zeros(2, dtype=torch.int64)],
                                  dst_rows=torch.zeros(2, dtype=torch.int64))


# -- chip_smoke.py's --states phase at a small size -----------------------------

@pytest.mark.parametrize("srow_rows", [200_000, 100_000])
def test_smoke_state_statements_small(srow_rows):
    """chip_smoke's state tables and statements (STATE_INSERTS,
    STATE_QUERIES) in a CPU session at a small size (hits 200,000 rows,
    arr 20,000; srow whole and cut by LIMIT) against its numpy answers
    (state_answers, state_agree) and su's registers (check_su_registers);
    the card's run of the same code is chip_smoke.py's."""
    import chip_smoke as cs
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "N_ARR", 20_000)
    mp.setattr(cs, "N_ROWS", 200_000)
    try:
        s = tch.connect(device="cpu")
        x = (np.arange(200_000, dtype=np.int64) * 2654435761) % 1_000_003
        s.execute("CREATE TABLE hits (x Int64)")
        s.insert_pydict("hits", {"x": x})
        want = cs.state_answers(x, srow_rows)
        cs.load_state_tables(s, srow_rows)
        limit = "" if srow_rows >= cs.N_ROWS else f" LIMIT {srow_rows}"
        for _, sqls in cs.STATE_INSERTS:
            for q in sqls:
                s.execute(q.format(limit=limit), settings=cs.STATE_SETTINGS)
        cs.check_su_registers(s, want)
        for name, sql in cs.STATE_QUERIES:
            rows = s.execute(sql, settings=cs.STATE_SETTINGS).rows()
            assert cs.state_agree(name, rows, want), (name, rows[:3],
                                                      want[name][:3])
    finally:
        mp.undo()
