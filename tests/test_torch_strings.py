"""The CUDA engine's dictionary string functions against the JAX reference,
on the CPU.

Each function of the reference's "strings (dictionary-LUT execution)"
section runs through ``clickhouse_tpu.connect()`` and
``clickhouse_tpu_torch.connect(device="cpu")`` over the same rows (made
from a seed with numpy, loaded into the reference, read back from its
table and handed to the port), over dictionaries of 1, 512, 513 and
65,536 values: 512 and 513 sit on either side of the host path's switch
from a Python loop to numpy, and 65,536 is the bottom of the reference's
device window for prefixes and suffixes (``_device_prefix_lut``), so both
of its branches are compared with the port's one (K10's plain version).
The rows compare in order and exactly.  The values hold NULLs, empty
strings and multibyte UTF-8, all of at most 64 bytes (longer ones meet
the reference's defect S1, pinned in test_torch_ops.DIVERGENCES); the
needles include the empty one, one longer than every value, and one
equal to a whole value.
"""
import numpy as np
import pytest

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import (NotImplementedError_,
                                              TypeError_)
from clickhouse_tpu_torch.interop import table_from_numpy
from clickhouse_tpu_torch.ops import string_ops

SIZES = [1, 512, 513, 65536]
TYPES = {"s": "String", "n": "Nullable(String)", "k": "String",
         "i": "Int32"}
WHOLE = "abcé"                   # a whole value of every dictionary
LONG = "a" * 70                  # longer than every value
PIECES = ["a", "b", "c", "ab", "é", "日本", "😀", " ", "%", "_", "\\", "x"]


def _values(rng, u):
    """u distinct strings: WHOLE and '' first, then words of the pieces
    (1-24 pieces, each value at most 64 bytes), told apart by a number."""
    out = [WHOLE, ""][:u]
    i = 0
    while len(out) < u:
        k = int(rng.integers(1, 12))
        w = "".join(rng.choice(PIECES, k)) + str(i)
        if rng.random() < 0.3:
            w = " " + w + " "
        i += 1
        if len(w.encode()) <= 64:
            out.append(w)
    return np.asarray(out, dtype=object)


def _reference_columns(js, table):
    blk = js.catalog.get_table("default", table).read_block()
    return {name: np.asarray(v) for name, v in blk.to_pydict().items()}


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(77)
    js = jch.connect()
    ts = tch.connect(device="cpu")
    for u in SIZES:
        vals = _values(rng, u)
        rows = np.concatenate([vals, vals[rng.integers(0, u, u // 2 + 3)]])
        rng.shuffle(rows)
        n = rows.copy()
        n[rng.random(len(rows)) < 0.15] = None
        if u > 1:
            n[0] = None
        k = np.asarray([f"k{v}é" for v in rng.integers(0, 7, len(rows))],
                       object)
        name = f"d{u}"
        js.execute(f"CREATE TABLE {name} (s String, n Nullable(String), "
                   f"k String, i Int32)")
        js.insert_pydict(name, {"s": rows, "n": n, "k": k,
                                "i": np.arange(len(rows), dtype=np.int32)})
        table_from_numpy(ts, name, _reference_columns(js, name), TYPES)
    return js, ts


def _both(sessions, sql):
    js, ts = sessions
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    assert got == want, (sql, [(g, w) for g, w in zip(got, want)
                               if g != w][:5])
    return got


# select lists, each over every dictionary size; ORDER BY i keeps the rows
# in one order in both engines
FUNCTIONS = {
    "length": "length(s), length(n), length(k)",
    "lengthUTF8": "lengthUTF8(s), lengthUTF8(n)",
    "empty": "empty(s), notEmpty(s), empty(n), notEmpty(n)",
    "lower-upper": "lower(s), upper(s), upper(n)",
    "reverse-trim": "reverse(s), trim(s), trim(n)",
    "like": "s LIKE 'ab%', s LIKE '%é', s NOT LIKE 'a%', s NOT LIKE '%0', "
            "s LIKE '%b%', s LIKE 'abcé', s LIKE '%', n LIKE 'a%', "
            "n LIKE '%1'",
    "like-escapes": r"s LIKE 'a\\_%', s LIKE '%\\%%', s LIKE '%\\\\%', "
                    "s LIKE 'a_c%', s LIKE 'a%c%', s LIKE '_', "
                    r"s NOT LIKE '%\\_%'",
    "ilike": "s ILIKE 'AB%', s NOT ILIKE '%C', s ILIKE '%É%', "
             "n ILIKE 'a%'",
    "match": "match(s, '^a[bc]'), match(s, '[0-9]$'), match(n, 'é')",
    "startsWith": f"startsWith(s, ''), startsWith(s, 'a'), "
                  f"startsWith(s, 'ab'), startsWith(s, '{WHOLE}'), "
                  f"startsWith(s, '{LONG}'), startsWith(s, '日本'), "
                  f"startsWith(n, 'b'), startsWith(k, 'k1')",
    "endsWith": f"endsWith(s, ''), endsWith(s, '1'), endsWith(s, ' '), "
                f"endsWith(s, '{WHOLE}'), endsWith(s, '{LONG}'), "
                f"endsWith(s, 'é'), endsWith(n, '2'), endsWith(k, 'é')",
    "position": "position(s, 'b'), position(s, ''), position(n, 'é'), "
                f"position(s, '{LONG}')",
    "substring": "substring(s, 2, 3), substr(s, -2), substring(s, 1), "
                 "substring(n, 2)",
    "concat": "concat(s, '-'), concat('<', s, '>'), concat(k, s), "
              "concat(n, '!')",
}
# the reference reads substring's bounds on the host, which its whole-query
# compilation cannot
EAGER = {"substring"}


@pytest.mark.parametrize("u", SIZES)
@pytest.mark.parametrize("fn", sorted(FUNCTIONS))
def test_string_functions_match_reference(sessions, fn, u):
    sql = f"SELECT {FUNCTIONS[fn]} FROM d{u} ORDER BY i"
    if fn in EAGER:
        sql += " SETTINGS compile_queries = 0"
    _both(sessions, sql)


@pytest.mark.parametrize("u", SIZES)
@pytest.mark.parametrize("where", [
    "startsWith(s, 'a')", "endsWith(s, '5')", "s LIKE 'ab%'",
    "s NOT LIKE '%é'", "NOT startsWith(n, 'b')", "length(s) > 10",
    "lower(s) = 'abcé'"], ids=["startsWith", "endsWith", "like-prefix",
                               "not-like-suffix", "not-startsWith-nullable",
                               "length", "lower-eq"])
def test_string_filters_match_reference(sessions, where, u):
    _both(sessions, f"SELECT count(), sum(i) FROM d{u} WHERE {where}")


@pytest.mark.parametrize("sql", [
    "SELECT startsWith('abc', 'a'), endsWith('abc', 'bc'), length('héllo'), "
    "lengthUTF8('héllo'), upper('ab'), 'abc' LIKE 'a%', "
    "position('abc', 'c'), concat('a', 'b', 'c')",
    "SELECT startsWith(lower(s), 'ab'), endsWith(upper(s), 'É') FROM d513 "
    "ORDER BY i",
    "SELECT lower(s) AS l, count() FROM d513 GROUP BY l ORDER BY l "
    "LIMIT 20",
], ids=["constants", "nested", "group-by-lower"])
def test_string_function_forms_match_reference(sessions, sql):
    _both(sessions, sql)


@pytest.mark.parametrize("sql", [
    "SELECT startsWith(s, k) FROM d512",
    "SELECT endsWith(s, k) FROM d512",
    "SELECT position(s, k) FROM d512",
    "SELECT match(s, k) FROM d512",
    "SELECT s LIKE k FROM d512",
], ids=["startsWith", "endsWith", "position", "match", "like"])
def test_a_needle_column_raises(sessions, sql):
    """A needle or pattern that is a column raises TypeError_ (the
    reference's LIKE does; its startsWith, endsWith, position and match
    take the needle column's first dictionary value instead: S2)."""
    with pytest.raises(TypeError_, match="constant string"):
        sessions[1].execute(sql)


@pytest.mark.parametrize("type_name", ["Array(Int32)", "Map(String, Int64)"])
def test_length_of_an_array_or_map_raises(type_name):
    """length over a Map (no such column is ported yet) raises a typed
    error when the analyzer resolves it; over an Array (its lengths read
    since groupArray was ported) it resolves to UInt64."""
    from clickhouse_tpu_torch.core import dtypes as tdt
    from clickhouse_tpu_torch.exprs import functions
    t = tdt.parse_type_name(type_name)
    if t.is_array:
        assert functions.get("length").resolve([t]) == tdt.UInt64
        return
    with pytest.raises(NotImplementedError_, match="Map"):
        functions.get("length").resolve([t])


def test_startswith_takes_prefix_match_for_every_size(sessions,
                                                      monkeypatch):
    """startsWith, endsWith and LIKE 'p%' / '%s' take the dictionary's bytes
    through string_ops.prefix_match at every dictionary size (the
    reference's device window is 65,536 to 4,194,304 values)."""
    calls = []
    real = string_ops.prefix_match

    def spy(chars, offsets, needle, suffix=False, negate=False):
        calls.append((offsets.numel() - 1, needle, suffix, negate))
        return real(chars, offsets, needle, suffix, negate)
    monkeypatch.setattr(string_ops, "prefix_match", spy)
    ts = sessions[1]
    for u in SIZES:
        del calls[:]
        ts.execute(f"SELECT startsWith(s, 'a'), endsWith(s, 'é'), "
                   f"s LIKE 'b%', s NOT LIKE '%1', s LIKE '%b%' FROM d{u}")
        assert [c[1:] for c in calls] == [
            (b"a", False, False), ("é".encode(), True, False),
            (b"b", False, False), (b"1", True, True)]
        assert all(c[0] == u for c in calls)


def test_dictionary_chars_are_built_once(sessions):
    ts = sessions[1]
    d = ts.catalog.get_table("default", "d513").read_block()["s"].dictionary
    ts.execute("SELECT count() FROM d513 WHERE startsWith(s, 'a')")
    chars, offsets = d.device_chars("cpu")
    ts.execute("SELECT count() FROM d513 WHERE endsWith(s, 'a')")
    assert d.device_chars("cpu")[0] is chars
    vals = [v.encode() for v in d.values_str()]
    assert bytes(chars.numpy()) == b"".join(vals)
    assert offsets.dtype.is_signed and offsets.element_size() == 4
    assert np.diff(offsets.numpy()).tolist() == [len(v) for v in vals]


@pytest.mark.parametrize("sql", [
    "SELECT count() FROM d65536 WHERE startsWith(s, 'ab')",
    "SELECT sum(endsWith(s, 'b')) FROM d65536",
    "SELECT countIf(s NOT LIKE '%b') FROM d65536",
], ids=["filter", "projection", "aggregate-condition"])
def test_dictionary_chars_are_held_to_the_budget(sessions, sql):
    """A dictionary's chars, offsets and LUT are built only where what the
    governor's estimate leaves of the budget holds them, wherever the
    function stands in the query: one byte less raises
    MemoryLimitExceeded naming them, the exact budget answers."""
    from clickhouse_tpu_torch.core.errors import MemoryLimitExceeded
    from clickhouse_tpu_torch.exec.streaming import \
        estimate_plan_device_bytes
    from clickhouse_tpu_torch.sql import parse
    js, ts = sessions
    d = ts.catalog.get_table("default", "d65536").read_block()["s"] \
        .dictionary
    est = estimate_plan_device_bytes(ts._plan(parse(sql), ts.settings),
                                     ts.catalog, ts.settings)
    chars = sum(len(v.encode()) for v in d.values_str())
    need = est + chars + 4 * (len(d) + 1) + len(d)
    d._chars = {}
    with pytest.raises(MemoryLimitExceeded, match="string dictionary"):
        ts.execute(sql + f" SETTINGS max_device_memory_bytes = {need - 1}")
    assert not d._chars
    got = ts.execute(sql + f" SETTINGS max_device_memory_bytes = {need}")
    assert got.rows() == js.execute(sql).rows()
