"""The CUDA engine's dates, times, math and bit functions against the JAX
reference, on the CPU.

Every name these sections of the port register runs through
``clickhouse_tpu.connect()`` and ``clickhouse_tpu_torch.connect(
device="cpu")`` over the same seeded numpy tables, and the rows must agree
in order:
  * dates, times and integers exactly: the calendar (K12's plain version,
    ops/calendar_ops.py) is integer arithmetic in both engines;
  * floor, ceil, round, trunc, roundBankers (without places), sign,
    isNaN, isFinite, isInfinite, intExp2, factorial, gcd, lcm and the bit
    functions exactly;
  * sqrt within 2 ulp (XLA's CPU sqrt is not correctly rounded);
  * the other transcendental functions within rtol 5e-14 (XLA's CPU
    implementations of cbrt, log1p, atanh and exp2 are less accurate than
    torch's), the exp family (exp, exp2, exp10, sinh, cosh) within 1e-12
    (XLA's error grows with the argument), erfc also within an absolute
    1e-15 (1 - erf cancels), lgamma and tgamma within rtol 1e-11 and an
    absolute 1e-13 (lgamma's relative error grows near its zeros at 1
    and 2);
  * round(x, N) within 1 ulp (XLA divides by 10^N as a product with its
    reciprocal), also for an integer result above 2^53;
  * a subnormal result that XLA flushes to 0 (D9).
Where the reference is wrong against ClickHouse the port gives ClickHouse's
answer; each such case is pinned in tests/test_torch_ops.py DIVERGENCES
(D1-D9) and held to numpy here.
"""
import math

import numpy as np
import pytest
import torch

import clickhouse_tpu as jch
import clickhouse_tpu_torch as tch
from clickhouse_tpu_torch.core.errors import NotImplementedError_, TypeError_
from clickhouse_tpu_torch.interop import table_from_numpy
from chip_smoke import (K12_DIVISORS, K12_EDGE_ROWS, K12_SPECS, Q_T,
                        hits_t_columns, k12_edge_cases, k12_values,
                        slice13_agree, slice13_answers)
from clickhouse_tpu_torch.core import dtypes as cdt
from clickhouse_tpu_torch.ops import _native, calendar_ops

N_C = 3000
_TINY = 2.2250738585072014e-308       # the smallest normal float64
EDGE_DATES = [
    "1900-01-01", "1900-02-28", "1900-03-01", "1899-12-31", "2000-02-28",
    "2000-02-29", "2000-03-01", "2100-02-28", "2100-03-01", "2096-02-29",
    "1969-12-31", "1970-01-01", "1970-01-04", "1970-01-05", "2012-02-29",
    "2012-01-31", "2013-01-31", "2013-03-31", "2013-05-31", "2013-08-31",
    "2013-10-31", "2012-12-30", "2012-12-31", "2013-01-01", "2014-12-29",
    "2015-12-31", "2016-01-03", "2010-01-03", "2013-07-14", "2013-07-15",
    "2013-07-31", "1600-01-01", "1600-02-29", "0200-03-01", "0001-01-01",
    "9999-12-31", "1968-12-29", "1968-12-30"]
C_TYPES = {"t": "DateTime", "d": "Date", "t2": "DateTime", "d2": "Date",
           "nt": "Nullable(DateTime)", "nd": "Nullable(Date)", "i": "Int32"}
# narrow storage: July 2013's seconds in int32, days near 1970 in int8
CN_TYPES = {"t": "DateTime", "d": "Date"}
M_TYPES = {"f": "Float64", "g": "Float32", "n": "Nullable(Float64)",
           "p": "Float64", "i8": "Int8", "u8": "UInt8", "i16": "Int16",
           "u16": "UInt16", "i32": "Int32", "u32": "UInt32", "i": "Int64",
           "u": "UInt64", "s": "UInt8"}
INT_COLS = ["i8", "u8", "i16", "u16", "i32", "u32", "i", "u"]
N_T = 200_000
HITS_T = {"t": "DateTime", "d": "Date", "x": "Int64"}


def _days(iso: str) -> int:
    return int(np.datetime64(iso, "D").astype(np.int64))


def _reference_columns(js, table):
    blk = js.catalog.get_table("default", table).read_block()
    return {name: np.asarray(v) for name, v in blk.to_pydict().items()}


def _load(js, ts, name, cols, types):
    js.execute(f"CREATE TABLE {name} ("
               + ", ".join(f"{c} {t}" for c, t in types.items()) + ")")
    js.insert_pydict(name, cols)
    table_from_numpy(ts, name, _reference_columns(js, name), types)


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(2013)
    js, ts = jch.connect(), tch.connect(device="cpu")
    edge = np.array([_days(s) for s in EDGE_DATES], np.int64)
    d = np.concatenate([edge, rng.integers(-700_000, 1_200_000,
                                           N_C - len(edge))])
    secs = rng.integers(0, 86400, N_C)
    secs[:len(edge)] = np.resize([0, 86399, 43200, 1, 3599, 3600], len(edge))
    t = d * 86400 + secs
    d2 = rng.integers(-700_000, 1_200_000, N_C)
    t2 = d2 * 86400 + rng.integers(0, 86400, N_C)
    nt, nd = t.astype(object), d.astype(object)
    nt[rng.random(N_C) < 0.2] = None
    nd[rng.random(N_C) < 0.2] = None
    _load(js, ts, "c", {"t": t, "d": d.astype(np.int32), "t2": t2,
                        "d2": d2.astype(np.int32), "nt": nt, "nd": nd,
                        "i": rng.integers(-100_000, 100_000, N_C)
                        .astype(np.int32)}, C_TYPES)
    tn = 1372636800 + rng.integers(0, 2678400, 1000)
    _load(js, ts, "cn", {"t": tn, "d": rng.integers(-120, 120, 1000)
                         .astype(np.int32)}, CN_TYPES)
    _load(js, ts, "m", _math_columns(rng), M_TYPES)
    _load(js, ts, "hits_t", hits_t_columns(N_T), HITS_T)
    for s in (js, ts):
        s.execute("CREATE TABLE dm (x Decimal(10, 2), y Decimal(18, 4))")
        s.execute("INSERT INTO dm VALUES (1.25, 2.00005), (-2.35, -1.23455),"
                  " (0.05, 0.5), (-0.05, -0.5), (12.34, 9.99995), "
                  "(-12.35, 0.0001), (0, -0.0001), (99.95, 123.4567)")
    return js, ts


def _math_columns(rng):
    n = 2000
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, 1.5, 2.5,
                        -0.5, -1.5, -2.5, 0.125, 1.005, 2.675, -2.675, 1e300,
                        -1e-300, 5e-324, 1.0, 2.0, -1.0, 0.25, 1e-5, 123.456,
                        1e15 + 0.5, -7.0, 3.0])
    f = np.concatenate([special, rng.normal(0, 100, n - len(special))])
    half = rng.random(n) < 0.1
    f[half] = np.round(f[half], 1) + 0.05
    nf = f.astype(object)
    nf[rng.random(n) < 0.2] = None
    u = rng.integers(0, 2**64, n, dtype=np.uint64)
    u[:4] = [0, 1, (1 << 63) + 1025, (1 << 64) - 1]
    cols = {"f": f, "g": rng.normal(0, 10, n).astype(np.float32), "n": nf,
            "p": rng.uniform(-1.0, 1.0, n), "u": u,
            "s": rng.integers(0, 70, n).astype(np.uint8)}
    for c, t in (("i8", np.int8), ("u8", np.uint8), ("i16", np.int16),
                 ("u16", np.uint16), ("i32", np.int32), ("u32", np.uint32),
                 ("i", np.int64)):
        info = np.iinfo(t)
        v = rng.integers(info.min, info.max, n, dtype=t, endpoint=True)
        v[:3] = [info.min, info.max, 0]
        cols[c] = v
    return cols


def _close(a, b, rtol, atol, ints=False) -> bool:
    if ints and isinstance(a, int) and isinstance(b, int):
        return math.isclose(a, b, rel_tol=rtol)
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        if math.isnan(b):
            return math.isnan(a)
        if b == 0.0 and abs(a) < _TINY:
            return True             # XLA flushes a subnormal result (D9)
        if math.isinf(b) or not (rtol or atol):
            return a == b
        return math.isclose(a, b, rel_tol=rtol, abs_tol=atol)
    return a == b


def _both(sessions, sql, rtol=0.0, atol=0.0, ints=False):
    """Run sql on both engines; the rows must agree in order, floats
    within (rtol, atol) (integers too, with ints: a float rounded to an
    integer above 2^53)."""
    js, ts = sessions
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    assert len(got) == len(want), (sql, len(got), len(want))
    for r, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (sql, g, w)
        bad = [j for j, (a, b) in enumerate(zip(g, w))
               if not _close(a, b, rtol, atol, ints)]
        assert not bad, (sql, f"row {r}, column {bad[0]}", g[bad[0]],
                         w[bad[0]])
    return got


# -- the plain calendar against the reference's ------------------------------

def test_plain_calendar_matches_reference_every_day():
    """civil_from_days, days_from_civil and days_in_month for every day
    from -800,000 to +1,200,000 (years -220 to 5255)."""
    import jax.numpy as jnp
    from clickhouse_tpu.exprs import functions as jf
    z = np.arange(-800_000, 1_200_001, dtype=np.int64)
    want = [np.asarray(a) for a in jf._civil_from_days(jnp.asarray(z))]
    got = calendar_ops.civil_from_days(torch.from_numpy(z))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    y, m, d = (torch.from_numpy(w.copy()) for w in want)
    np.testing.assert_array_equal(
        calendar_ops.days_from_civil(y, m, d).numpy(),
        np.asarray(jf._days_from_civil(*(jnp.asarray(w) for w in want))))
    np.testing.assert_array_equal(calendar_ops.days_from_civil(y, m, d)
                                  .numpy(), z)
    np.testing.assert_array_equal(
        calendar_ops.days_in_month(y, m).numpy(),
        np.asarray(jf._days_in_month(jnp.asarray(want[0]),
                                     jnp.asarray(want[1]))))


def test_op_table_is_the_kernels_and_the_smoke_covers_it():
    """calendar_ops.OPS numbers the ops as csrc/calendar_part.cu's CalOp
    does (0 .. OP_COUNT - 1), and chip_smoke's K12 cases use every op."""
    import re
    from pathlib import Path
    from chip_smoke import K12_SPECS
    src = (Path(calendar_ops.__file__).parent.parent / "csrc"
           / "calendar_part.cu").read_text()
    enum = dict(re.findall(r"\b(OP_\w+) = (\d+),", src))
    assert int(enum.pop("OP_COUNT")) == len(calendar_ops.OPS)
    assert sorted(int(v) for v in enum.values()) \
        == sorted(calendar_ops.OPS.values())
    assert {op for op, *_ in K12_SPECS} == set(calendar_ops.OPS)


# -- K12's arithmetic, mirrored on the host -----------------------------------
# csrc/calendar_part.cu's 32-bit path (op32) step for step in numpy int64,
# which holds every value exactly: each int32 and u32 intermediate of the
# kernel is checked to stay in its range, and each division by a run-time
# divisor goes through calendar_ops.magic's multiplier as the kernel's
# does.  The kernel composes a result modulo 2^32 (an output of 32 bits or
# fewer) or in 64 bits, which the output's cast keeps alike.

ERA_DAYS, ERA_BIAS, DOE_BIAS = 146097, 14695, 131235     # the era shift
I32, U32 = (-2**31, 2**31 - 1), (0, 2**32 - 1)
_NARROW = (torch.int8, torch.int16, torch.int32)


def _in(a, bounds, what):
    a = np.asarray(a)
    assert a.size == 0 or bounds[0] <= a.min() and a.max() <= bounds[1], \
        (what, a.min(), a.max())
    return a


def _gm_udiv(n, d: int, bits: int):
    """n // d as the kernel's udiv: t = (m n) >> bits, (t + ((n - t) >>
    min(l, 1))) >> max(l - 1, 0); n uint64 (bits 32) or Python ints."""
    m, l = calendar_ops.magic(d, bits)
    s1, s2 = min(l, 1), max(l - 1, 0)
    if bits == 32:
        n = np.asarray(n, np.uint64)
        t = (np.uint64(m) * n) >> np.uint64(32)
        return (t + ((n - t) >> np.uint64(s1))) >> np.uint64(s2)
    t = (m * n) >> 64
    return (t + ((n - t) >> s1)) >> s2


def _fdivmod(a, d: int, bits=None):
    """(floor(a / d), a mod d) as the kernel's fdivmod: b = a ^ (a >> 31),
    q = b / d, floor = q ^ (a >> 31); by the multiplier where bits is
    given (the run-time divisor), else by a constant."""
    a = np.asarray(a, np.int64)
    s = a >> 63
    b = a ^ s
    if bits == 32:
        q = _gm_udiv(_in(b, U32, "b").astype(np.uint64), d, 32) \
            .astype(np.int64)
    elif bits == 64:
        q = np.array([_gm_udiv(int(x), d, 64) for x in b.ravel()],
                     np.int64).reshape(b.shape)
    else:
        q = b // d
    rb = b - q * d
    return q ^ s, np.where(s < 0, d - 1 - rb, rb)


def _era_civil(doe):
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    leap = ((yoe % 4 == 0) & (yoe % 100 != 0)) | (yoe == 0)
    return yoe, m, d, np.where(doy >= 306, doy - 305, doy + 60 + leap)


def _era_day(yoe, m, d):
    mp = np.where(m > 2, m - 3, m + 9)
    return yoe * 365 + yoe // 4 - yoe // 100 + (153 * mp + 2) // 5 + d - 1


def _civil32(z, off=0):
    """The kernel's civil32: (y, m, d, day of the year) of day z + off."""
    u = _in(z, I32, "z") + 2**31
    q = u // ERA_DAYS
    doe = _in(u - q * ERA_DAYS + DOE_BIAS + off, U32, "doe")
    carry = (doe >= ERA_DAYS).astype(np.int64)
    doe, q = doe - carry * ERA_DAYS, q + carry
    yoe, m, d, yday = _era_civil(_in(doe, (0, ERA_DAYS - 1), "doe"))
    return _in(yoe + (q - ERA_BIAS) * 400 + (m <= 2), I32, "y"), m, d, yday


def _days_from_civil32(y, m, d):
    era, yoe = _fdivmod(_in(y - (m <= 2), I32, "y"), 400)
    return era * ERA_DAYS + _era_day(yoe, m, d) - 719468


def _days_in_month32(y, m):
    leap = np.where(y % 100 == 0, (y & 15) == 0, (y & 3) == 0)
    return np.where(m == 2, 28 + leap, 30 + ((m ^ (m >> 3)) & 1))


def _op32(v, op: str, seconds: bool, c0: int, c1: int):
    """The kernel's op32 over int64 values v of int8/16/32 storage: the
    op's exact value."""
    f0, f1 = calendar_ops.fold(op, c0, c1)
    d32 = min(c0, 2**31)
    z, tod = _fdivmod(v, 86400) if seconds else (v, np.zeros_like(v))
    if op == "hour":
        return tod // 3600
    if op == "minute":
        return tod // 60 % 60
    if op == "second":
        return tod % 60
    if op == "day_number":
        return z + c0
    if op in ("day_of_week", "relative_week", "last_day_of_week"):
        q, r = _fdivmod(z, 7)
        return {"day_of_week": (r + 3) % 7 + 1, "relative_week": q + (r >= 3),
                "last_day_of_week": z - (r + f0) % 7 + 6}[op]
    if op in ("floor_seconds", "start_of_seconds", "start_of_days"):
        if op == "start_of_days" or seconds:
            x = z if op == "start_of_days" else v
            q, r = _fdivmod(x, d32, 32)
            d = d32
        else:
            x = z * 86400                       # a Date's seconds: 64 bits
            q, r = _fdivmod(x, c0, 64)
            d = c0
        if op == "floor_seconds":
            return q
        return x - np.where(r >= d - f1, r - (d - f1), r + f1)
    if op in ("iso_year", "iso_week"):
        _, r = _fdivmod(z, 7)
        y, _, _, yday = _civil32(z, 3 - (r + 3) % 7)
        return y if op == "iso_year" else (yday - 1) // 7 + 1
    y, m, d, yday = _civil32(z)
    hms = tod // 3600 * 10000 + tod // 60 % 60 * 100 + tod % 60
    simple = {"year": y, "quarter": (m + 2) // 3, "month": m,
              "day_of_month": d, "day_of_year": yday, "yyyymm": y * 100 + m,
              "yyyymmdd": y * 10000 + m * 100 + d,
              "yyyymmddhhmmss": (y * 10000 + m * 100 + d) * 1000000 + hms,
              "relative_quarter": y * 4 + (m - 1) // 3,
              "relative_month": y * 12 + m,
              "last_day_of_month": z + _days_in_month32(y, m) - d}
    if op in simple:
        return simple[op]
    if op == "start_of_months":
        q, _ = _fdivmod(_in(y * 12 + m - 1, I32, "months"), d32, 32)
        ny, r = _fdivmod(_in(q * d32, I32, "start"), 12)
        return _days_from_civil32(ny, r + 1, 1)
    assert op == "add_months", op
    t = m - 1 + f1
    carry = (t >= 12).astype(np.int64)
    nm = t - 12 * carry + 1
    ny = _in(y + f0 + carry, I32, "ny")
    out = _days_from_civil32(ny, nm, np.minimum(d, _days_in_month32(ny, nm)))
    return out * 86400 + tod if seconds else out


def _mirror_cases(dtype):
    """chip_smoke's K12 edge cases of one storage type, and every op use of
    K12_SPECS over K12_EDGE_ROWS values of k12_values, both units."""
    yield from k12_edge_cases((dtype,))
    rng = np.random.default_rng(1404)
    for seconds in (False, True):
        v = k12_values(rng, dtype, seconds, K12_EDGE_ROWS)
        for spec in K12_SPECS:
            yield (v, dtype, seconds) + spec


def test_k12_magic_divides_every_numerator():
    """calendar_ops.magic's multiplier, run as the kernel's udiv, is
    floor division for every c0 of K12_SPECS and K12_DIVISORS and 10,000
    random divisors in [1, 2^31), over the numerators 0, 1, d - 1, d,
    d + 1, k d +- 1 up to 2^32 - 1, 2^32 - 1 itself and random ones; the
    64-bit multiplier alike for those c0 and 300 random divisors below
    2^63, over 64-bit numerators."""
    rng = np.random.default_rng(1994)
    fixed = sorted({c0 for _, _, c0, _ in K12_SPECS if c0 > 0}
                   | set(K12_DIVISORS) | {2**31})
    ds = np.concatenate([fixed, rng.integers(1, 2**31, 10_000)])
    top = 2**32 - 1
    for d in ds.tolist():
        k = np.array([2, 3, max(top // d - 1, 1), top // d])
        n = np.concatenate([[0, 1, d - 1, d, d + 1, top], k * d - 1,
                            k * d + 1, rng.integers(0, 2**32, 24)])
        n = np.clip(n, 0, top).astype(np.uint64)
        np.testing.assert_array_equal(_gm_udiv(n, d, 32), n // np.uint64(d),
                                      err_msg=f"d={d}")
    ds64 = fixed + [int(x) for x in rng.integers(1, 2**63, 300,
                                                 dtype=np.int64)]
    top = 2**64 - 1
    for d in ds64:
        ks = [2, 3, top // d - 1, top // d]
        for n in [0, 1, d - 1, d, d + 1, top, 2**63, 2**63 - 1] \
                + [k * d - 1 for k in ks] + [k * d + 1 for k in ks] \
                + [int(x) for x in rng.integers(0, 2**63, 8)]:
            n = min(max(n, 0), top)
            assert _gm_udiv(n, d, 64) == n // d, (d, n)
    with pytest.raises(ValueError):
        calendar_ops.magic(0, 32)


def test_k12_civil32_steps_match_the_plain_calendar():
    """The kernel's 32-bit civil steps (civil32 with its era shift,
    days_from_civil32, days_in_month32, the day of the year) against
    calendar_ops' over every day of the int16 range, every day an int32
    count of seconds reaches (-24,856 .. 24,855), the era shift's edges
    (the days around each carry of doe, the ends of int32) with the ISO
    Thursday's offsets -3..3, and random int32 days."""
    rng = np.random.default_rng(146097)
    eras = np.arange(0, 2**32 // ERA_DAYS + 1) * ERA_DAYS - 2**31
    edge = (eras[:, None] + (ERA_DAYS - DOE_BIAS)
            + np.arange(-5, 6)).ravel()
    z = np.concatenate([np.arange(-32768, 32768), np.arange(-24856, 24856),
                        edge, eras, [I32[0], I32[0] + 3, I32[1] - 3, I32[1]],
                        rng.integers(I32[0], I32[1], 100_000,
                                     endpoint=True)])
    z = z[(z >= I32[0] + 3) & (z <= I32[1] - 3)]
    for off in range(-3, 4):
        y, m, d, yday = _civil32(z, off)
        want = calendar_ops.civil_from_days(torch.from_numpy(z + off))
        for got, w in zip((y, m, d), want):
            np.testing.assert_array_equal(got, w.numpy())
        one = torch.ones_like(want[0])
        np.testing.assert_array_equal(
            yday, z + off - calendar_ops.days_from_civil(want[0], one, one)
            .numpy() + 1)
        np.testing.assert_array_equal(_days_from_civil32(y, m, d), z + off)
        np.testing.assert_array_equal(
            _days_in_month32(y, m),
            calendar_ops.days_in_month(*want[:2]).numpy())
    ends = np.array([I32[0], I32[0] + 1, I32[0] + 2, I32[1] - 2, I32[1]])
    for off in range(-3, 4):                   # beyond int32, as the ISO
        y, m, d, _ = _civil32(ends, off)       # Thursday may go
        want = calendar_ops.civil_from_days(torch.from_numpy(ends + off))
        for got, w in zip((y, m, d), want):
            np.testing.assert_array_equal(got, w.numpy())
    # the month step's years: far beyond the civil calendar's own
    y = np.concatenate([rng.integers(-2**30 - 6_000_000, 2**30 + 6_000_000,
                                     50_000), [-1, 0, 1, 1600, 1900, 2000]])
    m = rng.integers(1, 13, y.size)
    ty, tm = torch.from_numpy(y), torch.from_numpy(m)
    np.testing.assert_array_equal(_days_in_month32(y, m),
                                  calendar_ops.days_in_month(ty, tm).numpy())
    np.testing.assert_array_equal(
        _days_from_civil32(y, m, np.ones_like(y)),
        calendar_ops.days_from_civil(ty, tm, torch.ones_like(ty)).numpy())


def test_k12_source_states_the_mirrored_constants():
    """calendar_part.cu states the era shift, the era's length and the
    day of 0000-03-01 that the mirror above uses, and K12_INSTANCES is
    calendar_ops.INSTANCES: every (op, output storage) pair of
    chip_smoke.K12_SPECS and no other."""
    import re
    from pathlib import Path
    src = (Path(calendar_ops.__file__).parent.parent / "csrc"
           / "calendar_part.cu").read_text()
    consts = dict(re.findall(r"constexpr u32 (k\w+) = (\d+);", src))
    assert {k: int(v) for k, v in consts.items()} == {
        "kEraDays": ERA_DAYS, "kEraBias": ERA_BIAS, "kDoeBias": DOE_BIAS}
    assert ERA_BIAS * ERA_DAYS - DOE_BIAS == 2**31 - 719468
    assert src.count("719468") >= 3
    enum = {k: int(v) for k, v in re.findall(r"\b(OP_\w+) = (\d+),", src)}
    names = {v: k for k, v in calendar_ops.OPS.items()}
    storage = {"DT_U8": torch.uint8, "DT_I32": torch.int32,
               "DT_I64": torch.int64}
    macro = src[src.index("#define K12_INSTANCES"):]
    macro = macro[:macro.index("\n\n")]
    pairs = {(names[enum[o]], storage[d])
             for o, d in re.findall(r"X\((OP_\w+), (DT_\w+)\)", macro)}
    assert pairs == {(op, t) for op, ts in calendar_ops.INSTANCES.items()
                     for t in ts}
    assert pairs == {(op, cdt.torch_dtype_of(np.dtype(out_np)))
                     for op, out_np, _, _ in K12_SPECS}


@pytest.mark.parametrize("dtype", _NARROW, ids=str)
def test_k12_32_bit_path_mirror_matches_plain(dtype):
    """The kernel's 32-bit path, mirrored, against _calendar_part_plain
    exactly over chip_smoke's K12 edge cases of one storage type (every
    int8 and int16 day, every day's first and last second in int32, the
    divisors of K12_DIVISORS with their anchors, the constants of
    K12_CONSTANT_EDGES the 32-bit path takes) and every op use of
    K12_SPECS over random values of the storage's range, both units."""
    calls = 0
    for v, dt_, seconds, op, out_np, c0, c1 in _mirror_cases(dtype):
        if not calendar_ops.narrow_ok(op, c0, c1):
            continue                    # the int64 instance's
        got = cdt.cast_tensor(torch.from_numpy(
            _op32(v.astype(np.int64), op, seconds, c0, c1)), np.int64,
            np.dtype(out_np))
        want = calendar_ops._calendar_part_plain(
            torch.from_numpy(v).to(dt_), op, seconds, out_np, c0, c1)
        assert got.dtype == want.dtype
        assert torch.equal(got, want), (op, out_np, seconds, c0, c1)
        calls += 1
    assert calls > len(K12_SPECS)


class _FakeLibrary:
    """Stands for the kernel library: records each K12Args it is given."""
    def __init__(self):
        self.calls = []

    def chtt_calendar_part(self, args, blocks, stream):
        a = args._obj
        self.calls.append({f: getattr(a, f) for f, _ in a._fields_})
        return 0


def test_k12_wrapper_arguments(monkeypatch):
    """_calendar_part_cuda's launch arguments, taken on the host with the
    library stubbed: the instance's storages, the magic of c0 for both
    widths, the folded constants, a constant beyond the 32-bit path's
    reach sending the column to the int64 instance (one copy), a missing
    instance and a width c0 <= 0 raising; never the plain version."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_native, "library", lambda: lib)
    monkeypatch.setattr(_native, "grid_blocks", lambda dev, n: 1)
    monkeypatch.setattr(_native, "stream_ptr", lambda dev: 0)

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(calendar_ops, "_calendar_part_plain", no_plain)
    code = calendar_ops.OPS
    x = torch.arange(40, dtype=torch.int32)
    out = calendar_ops._calendar_part_cuda(
        x, code["start_of_seconds"], True, np.dtype(np.int64), 900, -7)
    a = lib.calls[-1]
    assert out.dtype == torch.int64 and a["n"] == 40
    assert a["in_dtype"] == _native.dtype_code(torch.int32)
    assert (a["div32"], a["div64"]) == (900, 900)
    assert (a["mul32"], a["log32"]) == calendar_ops.magic(900, 32)
    assert (a["mul64"], a["log64"]) == calendar_ops.magic(900, 64)
    assert (a["f0"], a["f1"], a["c0"], a["c1"]) == (0, 893, 900, -7)
    calendar_ops._calendar_part_cuda(x, code["add_months"], False,
                                     np.dtype(np.int32), -13, 0)
    assert (lib.calls[-1]["f0"], lib.calls[-1]["f1"]) == (-2, 11)
    calendar_ops._calendar_part_cuda(x, code["floor_seconds"], True,
                                     np.dtype(np.uint32), 2**40, 0)
    a = lib.calls[-1]
    assert (a["div32"], a["div64"], a["mask_bits"]) == (2**31, 2**40, 32)
    assert a["in_dtype"] == _native.dtype_code(torch.int32)
    calendar_ops._calendar_part_cuda(x, code["start_of_months"], False,
                                     np.dtype(np.int32), 2**31, 0)
    a = lib.calls[-1]
    assert a["in_dtype"] == _native.dtype_code(torch.int64)
    assert (a["f0"], a["f1"]) == (0, 0)
    calendar_ops._calendar_part_cuda(x.to(torch.int64), code["hour"], True,
                                     np.dtype(np.uint8), 0, 0)
    assert (lib.calls[-1]["div32"], lib.calls[-1]["mul32"]) == (1, 1)
    n = len(lib.calls)
    with pytest.raises(ValueError, match="no kernel instance"):
        calendar_ops._calendar_part_cuda(x, code["hour"], True,
                                         np.dtype(np.int64), 0, 0)
    with pytest.raises(ValueError, match="c0 > 0"):
        calendar_ops._calendar_part_cuda(x, code["start_of_months"], False,
                                         np.dtype(np.int32), 0, 0)
    assert len(lib.calls) == n


# -- dates and times ----------------------------------------------------------

# name -> the columns of table c it is called on (i: an Int32 read as the
# reference reads it: days, or seconds for the functions of the time)
DAY_FUNCS = ["toYear", "toMonth", "toDayOfMonth", "toDayOfWeek", "toQuarter",
             "toDayOfYear", "toISOYear", "toISOWeek", "toYYYYMM",
             "toYYYYMMDD", "toStartOfYear", "toStartOfQuarter",
             "toStartOfMonth", "toMonday", "toLastDayOfMonth",
             "toStartOfDay", "monthName", "toDaysSinceYearZero"]
SECS_FUNCS = ["toYYYYMMDDhhmmss", "toRelativeYearNum", "toRelativeQuarterNum",
              "toRelativeMonthNum", "toRelativeWeekNum", "toRelativeDayNum",
              "toRelativeHourNum", "toRelativeMinuteNum",
              "toRelativeSecondNum"]
TIME_FUNCS = ["toHour", "toMinute", "toSecond", "toStartOfHour",
              "toStartOfMinute", "toStartOfFiveMinutes",
              "toStartOfTenMinutes", "toStartOfFifteenMinutes",
              "toStartOfSecond", "timeSlot", "toUnixTimestamp"]


@pytest.mark.parametrize("fn", DAY_FUNCS + SECS_FUNCS)
def test_calendar_function_matches_reference(sessions, fn):
    """Over Date, DateTime, their Nullable forms and an Int, every edge day
    above (1900, 2000 and 2100's Februaries, month ends, year edges, ISO
    week 1 and 53, days before 1970), and the narrow storage of July
    2013's seconds (int32) and days near 1970 (int8)."""
    _both(sessions, f"SELECT {fn}(t), {fn}(d), {fn}(nt), {fn}(nd), {fn}(i) "
                    f"FROM c")
    _both(sessions, f"SELECT {fn}(t), {fn}(d) FROM cn")


@pytest.mark.parametrize("fn", TIME_FUNCS)
def test_time_of_day_function_matches_reference(sessions, fn):
    """The functions of the time of day over DateTime, Nullable(DateTime)
    and an Int (seconds); a Date is refused (D2)."""
    _both(sessions, f"SELECT {fn}(t), {fn}(nt), {fn}(i) FROM c")
    _both(sessions, f"SELECT {fn}(t) FROM cn")


@pytest.mark.parametrize("fn", TIME_FUNCS[:-1])
def test_time_of_day_function_refuses_a_date(sessions, fn):
    """ClickHouse refuses a Date there (the reference reads its day number
    as seconds: D2)."""
    with pytest.raises(TypeError_, match="Date"):
        sessions[1].execute(f"SELECT {fn}(d) FROM c")


def test_unix_timestamp_of_a_date_is_its_midnight(sessions):
    """toUnixTimestamp(Date) is the midnight's seconds, as a UInt32 (D2:
    the reference gives the day number)."""
    d = _reference_columns(sessions[0], "cn")["d"].astype(np.int64)
    got = [r[0] for r in sessions[1].execute(
        "SELECT toUnixTimestamp(d) FROM cn").rows()]
    assert got == ((d * 86400) % (1 << 32)).tolist()


def test_conversions_match_reference(sessions):
    _both(sessions, "SELECT toDate(t), toDate(nt), toDate(i), "
                    "fromUnixTimestamp(i), toTimeZone(t, 'UTC'), "
                    "timezoneOffset(t), fromDaysSinceYearZero(i + 800000) "
                    "FROM c")
    _both(sessions, "SELECT toDate(t), toDateTime(d) FROM cn")


@pytest.mark.parametrize("unit", ["year", "quarter", "month", "week", "day",
                                  "hour", "minute", "second"])
def test_date_trunc_matches_reference_or_clickhouse(sessions, unit):
    """dateTrunc's start of the period in the argument's type.  The
    reference agrees where it passes the right unit through (a DateTime
    from a day down, a Date from a week up); elsewhere (D1) the port's
    answer is the period's first day at midnight, checked against numpy."""
    js, ts = sessions
    if unit in ("day", "hour", "minute", "second"):
        _both(sessions, f"SELECT date_trunc('{unit}', t), "
                        f"dateTrunc('{unit}', nt) FROM c")
    else:
        _both(sessions, f"SELECT date_trunc('{unit}', d), "
                        f"dateTrunc('{unit}', nd) FROM c")
    cols = _reference_columns(js, "c")
    for col, secs in (("t", True), ("d", False)):
        got = ts.execute(f"SELECT toInt64(date_trunc('{unit}', {col})) "
                         f"FROM c").rows()
        want = _np_trunc(unit, cols[col].astype(np.int64), secs)
        assert [r[0] for r in got] == want.tolist(), (unit, col)


def _np_trunc(unit: str, v: np.ndarray, secs: bool) -> np.ndarray:
    """numpy's start of the period of v (seconds, or days), in v's unit."""
    days = v // 86400 if secs else v
    day = days.astype("datetime64[D]")
    if unit in ("year", "month"):
        start = day.astype(f"datetime64[{unit[0].upper()}]") \
            .astype("datetime64[D]").astype(np.int64)
    elif unit == "quarter":
        m = day.astype("datetime64[M]").astype(np.int64)
        start = (m - m % 3).astype("datetime64[M]").astype("datetime64[D]") \
            .astype(np.int64)
    elif unit == "week":
        start = days - (days + 3) % 7            # Monday
    else:
        start = days
    if not secs:
        return start
    if unit in ("hour", "minute", "second"):
        q = {"hour": 3600, "minute": 60, "second": 1}[unit]
        return v - v % q
    return start * 86400


@pytest.mark.parametrize("unit", ["Nanosecond", "Microsecond", "Millisecond",
                                  "Second", "Minute", "Hour", "Day", "Week",
                                  "Month", "Quarter", "Year"])
def test_interval_arithmetic_matches_reference(sessions, unit):
    """DateTime +/- an interval of every unit, the interval first too,
    add*s / subtract*s; a Date for the units of a day and up (a Date
    and a smaller unit: D3); month steps from the 31st clamp the day.
    The sub-second add*s / subtract*s floor as the intervals do (D8: the
    reference's round through float64), checked against numpy."""
    sub = unit in ("Nanosecond", "Microsecond", "Millisecond")
    _both(sessions, f"SELECT t + INTERVAL 3 {unit}, t - INTERVAL 2 {unit}, "
                    f"INTERVAL 5 {unit} + t, nt + INTERVAL -1 {unit}"
                    + ("" if sub else f", add{unit}s(t, 7), "
                       f"subtract{unit}s(nt, 13)") + " FROM c")
    if sub:
        den = {"Nanosecond": 10**9, "Microsecond": 10**6,
               "Millisecond": 10**3}[unit]
        t = _reference_columns(sessions[0], "c")["t"].astype(np.int64)
        got = sessions[1].execute(
            f"SELECT toInt64(add{unit}s(t, 7)), toInt64(subtract{unit}s(t, "
            f"13)), toInt64(add{unit}s(t, 2500000000)) FROM c").rows()
        want = np.stack([t + 7 // den, t + (-13) // den,
                         t + 2500000000 // den], axis=1)
        assert np.array_equal(np.array(got), want)
    if unit in ("Day", "Week", "Month", "Quarter", "Year"):
        _both(sessions, f"SELECT d + INTERVAL 3 {unit}, "
                        f"d - INTERVAL 14 {unit}, add{unit}s(nd, 1), "
                        f"subtract{unit}s(d, 25) FROM c")
        _both(sessions, f"SELECT d + INTERVAL 1 {unit}, "
                        f"t - INTERVAL 1 {unit} FROM cn")
    else:
        with pytest.raises(NotImplementedError_):
            sessions[1].execute(f"SELECT d + INTERVAL 1 {unit} FROM c")


def test_date_number_arithmetic_matches_reference(sessions):
    _both(sessions, "SELECT t + i, d + i, d - 3, t - 86400, 7 + d, "
                    "d - toStartOfMonth(d), t - toStartOfDay(t), "
                    "nd - d FROM c")


@pytest.mark.parametrize("unit", ["second", "minute", "hour", "day", "week",
                                  "month", "quarter", "year"])
def test_date_diff_matches_reference(sessions, unit):
    _both(sessions, f"SELECT dateDiff('{unit}', t, t2), "
                    f"dateDiff('{unit}', d, d2), dateDiff('{unit}', d, t2), "
                    f"dateDiff('{unit}', nt, t), dateDiff('{unit}', nd, d2)"
                    f" FROM c")


@pytest.mark.parametrize("unit", ["Second", "Minute", "Hour", "Day", "Week",
                                  "Month", "Quarter", "Year"])
def test_start_of_interval_matches_reference(sessions, unit):
    cols = "t, nt, i" if unit in ("Second", "Minute", "Hour") \
        else "t, nt, d, nd, i"
    exprs = ", ".join(f"toStartOfInterval({c}, INTERVAL {n} {unit})"
                      for c in cols.split(", ") for n in (1, 5))
    _both(sessions, f"SELECT {exprs} FROM c")


def test_week_starts_take_clickhouse_mode(sessions):
    """toStartOfWeek's default mode 0 starts the week on a Sunday (an odd
    mode on a Monday); toLastDayOfWeek ends it on a Saturday: numpy's
    days (the reference takes Monday for both: D6), across a year's edge
    and before 1970."""
    js, ts = sessions
    d = _reference_columns(js, "c")["d"].astype(np.int64)
    sun = d - (d + 4) % 7
    rows = ts.execute("SELECT toStartOfWeek(d), toStartOfWeek(d, 1), "
                      "toLastDayOfWeek(d), toMonday(d), toStartOfWeek(t) "
                      "FROM c").rows()
    epoch = np.datetime64("1970-01-01", "D")
    got = np.array([[v if isinstance(v, int) else
                     (np.datetime64(v) - epoch).astype(np.int64) for v in r]
                    for r in rows])
    np.testing.assert_array_equal(got[:, 0], sun)
    np.testing.assert_array_equal(got[:, 1], d - (d + 3) % 7)
    np.testing.assert_array_equal(got[:, 2], sun + 6)
    np.testing.assert_array_equal(got[:, 3], d - (d + 3) % 7)
    np.testing.assert_array_equal(got[:, 4], sun)
    dow = ((sun + 3) % 7) + 1
    assert (dow == 7).all()                     # every start is a Sunday


def test_host_clock_functions_match_reference(sessions, monkeypatch):
    """now(), today(), yesterday(), UTCTimestamp(), nowInBlock() under a
    fixed clock; serverTimezone() is UTC."""
    import time
    monkeypatch.setattr(time, "time", lambda: 1373884200.75)
    _both(sessions, "SELECT now(), today(), yesterday(), UTCTimestamp(), "
                    "nowInBlock(), serverTimezone()")
    _both(sessions, "SELECT count() FROM c WHERE t < now() AND d <= today()")


# -- math -----------------------------------------------------------------------

EXACT = 0.0, 0.0
LIB = 5e-14, 0.0
EXP = 1e-12, 0.0
MATH_FUNCS = {
    "sqrt": (4.5e-16, 0.0), "cbrt": LIB, "exp": EXP, "log": LIB, "ln": LIB,
    "exp2": EXP, "log2": LIB, "exp10": EXP, "log10": LIB, "sin": LIB,
    "cos": LIB, "tan": LIB, "asin": LIB, "acos": LIB, "atan": LIB,
    "sigmoid": LIB, "tanh": LIB, "erf": LIB, "erfc": (5e-14, 1e-15),
    "lgamma": (1e-11, 1e-13), "tgamma": (1e-11, 1e-13), "sinh": EXP,
    "cosh": EXP, "asinh": LIB, "acosh": LIB, "atanh": LIB, "log1p": LIB,
    "expm1": LIB, "degrees": LIB, "radians": LIB, "sign": EXACT,
    "isNaN": EXACT, "isFinite": EXACT, "isInfinite": EXACT,
    "floor": EXACT, "ceil": EXACT, "ceiling": EXACT, "round": EXACT,
    "trunc": EXACT, "truncate": EXACT, "roundBankers": EXACT,
    "intExp2": EXACT, "factorial": EXACT}


@pytest.mark.parametrize("fn", sorted(MATH_FUNCS))
def test_math_function_matches_reference(sessions, fn):
    """Over NaN, +-inf, +-0.0, the rounding halves and random floats
    (Float64, Float32, Nullable), values in [-1, 1], and integers of every
    width (UInt64 above 2^63 among them); tolerance per function above."""
    rtol, atol = MATH_FUNCS[fn]
    _both(sessions, f"SELECT {fn}(f), {fn}(g), {fn}(n), {fn}(p) FROM m",
          rtol, atol)
    _both(sessions, "SELECT " + ", ".join(f"{fn}({c})" for c in INT_COLS)
          + " FROM m", rtol, atol)


@pytest.mark.parametrize("fn", ["round", "floor", "ceil", "trunc",
                                "roundBankers"])
def test_rounding_to_places_matches_reference(sessions, fn):
    """round(x, N) keeps the reference's k(x * 10^N) / 10^N in float64,
    within 1 ulp (XLA divides by 10^N as a product with its reciprocal),
    also for an integer result above 2^53; the Decimal branch's exact
    integer rounding of the scaled values."""
    _both(sessions, f"SELECT {fn}(f, 2), {fn}(f, 1), {fn}(f, -1), "
                    f"{fn}(g, 1), {fn}(n, 3), {fn}(i32, -2), {fn}(u, -1), "
                    f"{fn}(i16, 0), {fn}(u8, -1) FROM m", 2.3e-16, ints=True)
    _both(sessions, f"SELECT {fn}(x, 1), {fn}(x), {fn}(x, 3), {fn}(x, -1), "
                    f"{fn}(y, 2), {fn}(y, 3) FROM dm")


def test_binary_math_matches_reference(sessions):
    _both(sessions, "SELECT pow(f, 2), power(p, g), atan2(f, g), "
                    "hypot(f, p), pow(i8, 3), ifNotFinite(f, -1), "
                    "pi(), e(), exp10(2), intExp10(i8), intExp2(f), "
                    "factorial(p * 25) FROM m", *LIB)
    # 10^x truncated: pow's last bits differ between the libraries
    _both(sessions, "SELECT intExp10(p * 30) FROM m", *LIB, ints=True)
    _both(sessions, "SELECT gcd(i, i32), gcd(i16, i8), lcm(i16, i8), "
                    "lcm(i8, 12), gcd(u8, 0) FROM m")


def test_round_down_reads_the_array_within_its_length(sessions):
    """roundDown's boundaries are the array's values (D5: the reference
    also reads its zero padding): numpy's greatest boundary <= x."""
    js, ts = sessions
    f = _reference_columns(js, "m")["f"]
    b = np.array([-1.0, 0.5, 2.5, 100.0])
    got = np.array([r[0] for r in ts.execute(
        "SELECT roundDown(f, [-1, 0.5, 2.5, 100]) FROM m").rows()])
    idx = np.searchsorted(b, f, side="right") - 1
    want = np.where(idx < 0, b[0], b[np.clip(idx, 0, 3)])
    want = np.where(np.isnan(f), b[0], want)
    np.testing.assert_array_equal(got, want)


# -- bit operations --------------------------------------------------------------

@pytest.mark.parametrize("col", INT_COLS)
def test_bit_functions_match_reference(sessions, col):
    """Every bit function over every integer type, UInt64 above 2^63
    among them; shifts past the type's width and by a column of counts."""
    c = col
    _both(sessions, f"SELECT bitAnd({c}, 255), bitOr({c}, 4096), "
                    f"bitXor({c}, 12345), bitNot({c}), bitShiftLeft({c}, 3), "
                    f"bitShiftRight({c}, 5), bitShiftLeft({c}, s), "
                    f"bitShiftRight({c}, s), bitShiftLeft({c}, 70), "
                    f"bitShiftRight({c}, 63) FROM m")
    _both(sessions, f"SELECT bitCount({c}), bitTest({c}, 3), "
                    f"bitHammingDistance({c}, 7), bitRotateLeft({c}, 5), "
                    f"bitRotateRight({c}, s), byteSwap({c}), "
                    f"bitAnd({c}, u16), bitOr(i8, {c}), bitXor({c}, u) "
                    f"FROM m")


def test_bit_constants_match_reference(sessions):
    rows = _both(sessions, "SELECT bitShiftLeft(1, 62), bitShiftRight(-8, "
                           "70), bitNot(toUInt16(1)), bitAnd(-1, 255), "
                           "bitCount(1.5), bitCount(f), bitTest(u, 63) "
                           "FROM m LIMIT 3")
    assert rows[0][:3] == (0, -1, 65534)


# -- the slice's queries ----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(Q_T))
def test_slice_queries_match_reference(sessions, name):
    """Qt1-Qt5 (chip_smoke.py's hits_t queries) at 200,000 rows against
    the reference (integers, dates and times exactly, Qt5's floats within
    rtol 1e-14: sqrt and log differ by an ulp between the libraries, the
    sums' order too) and against chip_smoke's numpy answers, which the
    smoke holds the card's to."""
    rows = _both(sessions, Q_T[name], 1e-14)
    want = slice13_answers(_reference_columns(sessions[0], "hits_t"))
    assert rows and slice13_agree(want)(name, rows)
