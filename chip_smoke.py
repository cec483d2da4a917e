"""Quickest proof that the CUDA engine (clickhouse_tpu_torch) runs on a GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k2-wide   # only K2 at S = 16,384 (see k2_wide)
    python3 chip_smoke.py --queries   # only the query times (time_queries)

Needs one NVIDIA Hopper card, nvcc and PyTorch built for CUDA; exits
non-zero without them.  Phases, each of which fails the run:

  1. build the six hand-written kernels (csrc/*.cu) with nvcc for sm_90a,
     one nvcc a source, all started together;
  2. hold each kernel against its plain PyTorch version on the card: edge
     cases (K1 with and without filter terms over every storage type and
     comparison, constants outside the storage range, NaN, NULLs, row
     bounds off the 16-row grid and misaligned views; K2 with skewed slots;
     both K3 entries with ties, extreme keys, invalid rows, monotone keys
     and ties across blocks; K4 over every key type's token, UInt64 above
     2^63, NaN and -0.0, all-equal keys, one row, row counts off the tile
     grid, invalid rows, no valid row and multi-key chains; K5 with one
     group, a group a row, and more groups than slots; K6 for every op,
     with masks, empty and fully masked groups, and one group holding 40 %
     of the rows); integer results must agree exactly, K1's and K2's float
     sums within rtol 1e-12, K6's within n_g * eps * sum(|x|) a group of
     n_g rows (its atomics add a group's parts in a varying order);
  3. drive the main path through the public API: connect(device="cuda"),
     CREATE TABLE hits (x Int64), insert_pydict 100M rows of
     (arange * 2654435761) % 1_000_003, then Q1, Q2, Q2b, Q2m and Q3
     (Q1-Q3 and Q2b the SQL of bench.py), each checked against a numpy
     answer, with the kernels' launch counters reset before and read after
     to show the queries went through K1-K6: Q1 must reach K1 once at 100M
     rows with its filter as a term (read in x's int32 storage) and
     allocate no row mask; Q2b and Q2m must reach K4 and K5 over every
     row, and Q2m K6;
  4. replay each kernel on the exact inputs the main path gave it (its
     largest launch on the main path), held against its plain version, and
     time it, its plain version and, where one exists, the single PyTorch
     call computing the same function (CUDA events, L2 flushed, device
     time); print bytes and bound_ms (bytes / 3.35 TB/s) for each, K1 in
     both its forms (Q1's filter term, and the largest bool-mask count the
     main path made: the aggregated block's row count in _sort_block) and
     the kernels of one call from a torch.profiler trace, K2 on skewed slots at 100M rows and at
     S = 16,384, K3's level 1 and merge apart (torch.profiler), K6 for
     each of Q2m's ops and over 100M rows where one group holds 40 % of
     them; time each query (median wall time of 20 runs, synchronised) and
     the device-busy time of Q1, Q2b and Q2m (torch.profiler).

The second-to-last line is a JSON object of per-kernel results (name,
route, source, replaces, launches, ms, plain_ms, bound_ms, bound_by,
library_ms, ...); the last line is {"ok": true, "device": {...}}.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS = 100_000_000
Q1 = "SELECT count() FROM hits WHERE x > 500000"
Q2 = ("SELECT x % 1024 AS k, count() AS c, sum(x) FROM hits GROUP BY k "
      "ORDER BY c DESC LIMIT 10")
Q3 = "SELECT x FROM hits ORDER BY x LIMIT 100"
Q2B = ("SELECT x AS k, count() AS c FROM hits GROUP BY k ORDER BY c DESC "
       "LIMIT 10 SETTINGS max_groups = 2097152")
Q2M = ("SELECT intDiv(x, 4) AS k, count() AS c, sum(x) AS s, min(x) AS lo, "
       "max(x) AS hi, any(x) AS a FROM hits GROUP BY k ORDER BY s DESC "
       "LIMIT 10")
QUERIES = (("Q1", Q1), ("Q2", Q2), ("Q2b", Q2B), ("Q2m", Q2M), ("Q3", Q3))
QUERY_REPS = 20
KERNEL_REPS = 20
FLOAT_RTOL = 1e-12      # the kernel adds float partials in another order
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
L2_FLUSH_BYTES = 128 << 20  # > the H100's 50 MB L2
SLEEP_CYCLES = 1_000_000    # ~0.5 ms of device time to cover host enqueue
# per-kernel keys of the kernels line beyond the contract's
EXTRA_KEYS = ("level1_ms", "merge_ms", "entry64_ms", "entry64_bound_ms",
              "one_slot_ms", "zipf_ms", "wide_s_ms", "counts_only_ms",
              "sums_only_ms", "mask_form_ms", "mask_form_plain_ms",
              "mask_form_library_ms", "mask_form_bytes",
              "mask_form_bound_ms", "mask_form_shape", "launches_fused",
              "launches_mask_form", "kernels_per_call", "passes",
              "digit_bits", "per_op_ms", "skew_ms", "skew_bound_ms",
              "information", "hist_ms", "scan_ms", "scatter_ms")
F64_EPS = 2.0 ** -52
CMPS = ["equals", "notEquals", "less", "lessOrEquals", "greater",
        "greaterOrEquals"]


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=KERNEL_REPS) -> float:
    """Mean device milliseconds of one fn() (after one warm run), timed with
    CUDA events around each call.  Before each call the L2 is flushed (a
    write of L2_FLUSH_BYTES) and the device is held busy by a sleep kernel
    while the host enqueues fn(), so the events see device time from a cold
    cache and no host launch gaps."""
    fn()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def bound_ms(nbytes: int) -> float:
    """Least time to move nbytes at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"shape/dtype {tuple(got.shape)}/{got.dtype} != "
             f"{tuple(want.shape)}/{want.dtype}")
    if got.is_floating_point():
        g, w = got.double(), want.double()
        nan_g, nan_w = torch.isnan(g), torch.isnan(w)
        if not torch.equal(nan_g, nan_w):
            fail("NaN positions differ")
        g, w = g[~nan_g], w[~nan_w]
        if g.numel() and not torch.allclose(g, w, rtol=FLOAT_RTOL, atol=0):
            fail(f"float results differ beyond rtol {FLOAT_RTOL}")
        return float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.equal(got, want):
        fail("integer results differ")
    return 0.0


def _lit_type(v) -> str:
    """The type the analyzer gives a numeric literal: the narrowest
    unsigned type for v >= 0, signed for v < 0, Float64 for a float."""
    if isinstance(v, float):
        return "Float64"
    for bits in (8, 16, 32, 64):
        if 0 <= v < 1 << bits:
            return f"UInt{bits}"
        if -(1 << (bits - 1)) <= v < 0:
            return f"Int{bits}"
    raise ValueError(v)


def term_cases(rng, n):
    """(column type, values, literals) for K1's filter terms: every storage
    type a term reads (Int64 narrowed to int8 / int16 / int32, full int64,
    uint8, UInt16 in int32, UInt32 in int64, UInt64 bits, Float64 stored as
    float32, float32, float64), NULLs, NaN, -0.0 and infinities, and
    constants outside the storage range."""
    big = rng.integers(-(1 << 62), 1 << 62, n)
    u64 = rng.integers(0, 1 << 62, n).astype(np.uint64)
    u64[rng.random(n) < 0.3] += np.uint64(1 << 63)
    f = rng.normal(0, 100, n)
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    f[:3] = [np.inf, -np.inf, 0.0]
    nul = rng.integers(-50, 50, n).astype(object)
    nul[rng.random(n) < 0.2] = None
    lits = [0, 7, -1, -129, 127, 300, 40000, -(1 << 40), 1 << 40,
            (1 << 63) + 5, 1.5, -0.0, float("nan"), float("inf")]
    return [
        ("Int64", rng.integers(-100, 100, n), lits),               # int8
        ("Int64", rng.integers(-30000, 30000, n), lits),           # int16
        ("Int64", (np.arange(n) * 2654435761) % 1_000_003, lits),  # int32
        ("Int64", big, lits + [int(big[5]), -(1 << 63) + 1]),
        ("UInt8", rng.integers(0, 256, n).astype(np.uint8), lits),
        ("UInt16", rng.integers(0, 65536, n).astype(np.uint16), lits),
        ("UInt32", rng.integers(0, 1 << 32, n).astype(np.uint32), lits),
        ("UInt64", u64, lits + [int(u64[3]), (1 << 64) - 1]),
        ("UInt64", rng.integers(0, 200, n).astype(np.uint64), lits),
        ("Float32", f.astype(np.float32), lits + [float(np.float32(f[7]))]),
        ("Float64", f.astype(np.float32).astype(np.float64), lits),
        ("Float64", f, lits + [float(f[9])]),
        ("Nullable(Int32)", nul, lits),
    ]


def make_term(values, type_name, cmp, lit, dev):
    """The executor's K1 term for `c CMP lit` over a column of `values`."""
    from clickhouse_tpu_torch.core import dtypes as dt
    from clickhouse_tpu_torch.core.column import column_from_numpy
    from clickhouse_tpu_torch.exec.executor import _filter_term
    from clickhouse_tpu_torch.exprs.expr import (BoundCall, BoundColumn,
                                                 BoundLiteral,
                                                 colval_from_column)
    col = column_from_numpy(np.asarray(values), dt.parse_type_name(type_name),
                            device=dev)
    cv = colval_from_column(col)
    expr = BoundCall(cmp, [BoundColumn("c", cv.dtype), BoundLiteral(
        lit, dt.parse_type_name(_lit_type(lit)))], dt.UInt8)
    term = _filter_term(expr, {"c": cv}, col.capacity)
    if term is None:
        fail(f"`{type_name} {cmp} {lit!r}` did not become a K1 term")
    return term


def check_k1_terms(dev) -> int:
    """K1 with filter terms against its plain version: every case of
    term_cases, every comparison, row bounds off the 16-row grid (and 0),
    a count, a sum and a min of a second column, and views starting 1 and
    3 rows in (misaligned for every type).  -> calls compared."""
    import dataclasses
    from clickhouse_tpu_torch.ops.agg_ops import (_masked_reduce_plain,
                                                  masked_reduce)
    rng = np.random.default_rng(4)
    n = 10_007
    calls = 0
    for type_name, values, lits in term_cases(rng, n):
        y = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n)).to(dev)
        for cmp in CMPS:
            for lit in lits:
                t = make_term(values, type_name, cmp, lit, dev)
                data = torch.zeros(t.storage.shape[0], dtype=torch.int64,
                                   device=dev)
                data[:n] = y
                for rows in (n, n - 5, 0):
                    for op, d in (("sum", None), ("sum", data),
                                  ("min", data)):
                        max_abs_err(
                            masked_reduce(op, d, None, n_rows=rows,
                                          terms=[t]),
                            _masked_reduce_plain(op, d, None, False, rows,
                                                 [t]))
                        calls += 1
                for off in (1, 3):
                    tv = dataclasses.replace(
                        t, storage=t.storage[off:],
                        validity=None if t.validity is None
                        else t.validity[off:])
                    for d in (None, data[off:]):
                        max_abs_err(
                            masked_reduce("sum", d, None, n_rows=n - 9,
                                          terms=[tv]),
                            _masked_reduce_plain("sum", d, None, False,
                                                 n - 9, [tv]))
                        calls += 1
    return calls


def check_k1(dev):
    from clickhouse_tpu_torch.ops.agg_ops import (_masked_reduce_plain,
                                                  masked_reduce)
    g = torch.Generator(device="cpu").manual_seed(1)
    n = 1_000_003
    mask = torch.rand(n, generator=g) < 0.3
    cases = []
    for dtype in (torch.bool, torch.int8, torch.uint8, torch.int16,
                  torch.int32, torch.int64, torch.float32, torch.float64):
        if dtype.is_floating_point:
            x = torch.randn(n, generator=g, dtype=torch.float64) * 1e6
            x[::97] = -0.0
            x[::89] = float("nan")
            x = x.to(dtype)
        elif dtype == torch.bool:
            x = torch.rand(n, generator=g) < 0.5
        else:
            info = torch.iinfo(dtype)
            x = torch.randint(info.min, info.max, (n,), generator=g,
                              dtype=torch.int64).to(dtype)
        for op in ("sum", "min", "max", "any", "bor", "band", "bxor"):
            if op in ("bor", "band", "bxor") and dtype.is_floating_point:
                continue
            for m in (None, mask, torch.zeros(n, dtype=torch.bool)):
                cases.append((op, x, m, False))
    u64 = torch.tensor([1, -1, 5, -(1 << 63)], dtype=torch.int64)
    cases += [("min", u64, None, True), ("max", u64, None, True),
              ("sum", torch.full((10_000,), 1 << 62, dtype=torch.int64),
               None, False)]
    for op, x, m, uns in cases:
        want = _masked_reduce_plain(op, x.to(dev),
                                    None if m is None else m.to(dev), uns)
        got = masked_reduce(op, x.to(dev), None if m is None else m.to(dev),
                            unsigned=uns)
        max_abs_err(got, want)
    n_terms = check_k1_terms(dev)
    print(f"K1 masked_reduce edge cases: {len(cases)} without terms and "
          f"{n_terms} with filter terms agree", flush=True)


def check_k2(dev):
    from clickhouse_tpu_torch.ops.mxu_segsum import (
        _dense_group_reduce_plain, dense_group_reduce)
    g = torch.Generator(device="cpu").manual_seed(2)
    n = 3_000_000
    for S in (1, 1000, 16384):
        ids = torch.randint(-3, S + 3, (n,), generator=g, dtype=torch.int32)
        base = torch.rand(n, generator=g) < 0.9
        cm = [None, torch.rand(n, generator=g) < 0.5]
        sv = [torch.randint(-(1 << 62), 1 << 62, (n,), generator=g),
              torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=g,
                            dtype=torch.int64).to(torch.int32),
              torch.rand(n, generator=g) < 0.5]
        sm = [None, torch.rand(n, generator=g) < 0.5, None]

        def on(ts):
            return [None if t is None else t.to(dev) for t in ts]
        args = (ids.to(dev), base.to(dev), on(cm), on(sv), on(sm), S)
        want = _dense_group_reduce_plain(*args)
        got = dense_group_reduce(*args)
        for a, b in zip(got, want):
            max_abs_err(a, b)
    # skewed keys, where lanes of a warp share a slot: one slot, Zipf(1.1)
    # over 1,024 slots; both count masks None (counted once, then copied)
    zipf = np.random.default_rng(2).zipf(1.1, n)
    x = torch.randint(-(1 << 62), 1 << 62, (n,), generator=g)
    for S, ids in ((1, torch.zeros(n, dtype=torch.int32)),
                   (1024, torch.from_numpy(((zipf - 1) % 1024)
                                           .astype(np.int32)))):
        args = (ids.to(dev), None, [None, None], [x.to(dev)], [None], S)
        want = _dense_group_reduce_plain(*args)
        got = dense_group_reduce(*args)
        for a, b in zip(got, want):
            max_abs_err(a, b)
    # one mask tensor counted twice (counted once), and one count and one
    # sum over S = 4,096 (one 48 KB histogram), 8,192 (one of 96 KB) and
    # 16,384 (two 96 KB tiles)
    m = torch.rand(n, generator=g) < 0.5
    for S, cms in ((1024, [m, None, m]), (4096, [None]), (8192, [None]),
                   (16384, [None])):
        ids = torch.randint(-3, S + 3, (n,), generator=g, dtype=torch.int32)
        md = m.to(dev)
        args = (ids.to(dev), None, [md if c is m else None for c in cms],
                [x.to(dev)], [md], S)
        want = _dense_group_reduce_plain(*args)
        for a, b in zip(dense_group_reduce(*args), want):
            max_abs_err(a, b)
    print("K2 dense_group_reduce edge cases: S in (1, 1000, 16384), one "
          "slot, Zipf(1.1) slots, a mask counted twice, S in (4096, 8192, "
          "16384) with one count and one sum agree", flush=True)


def check_k3(dev):
    from clickhouse_tpu_torch.ops.sort_ops import (_topk_smallest32_plain,
                                                   _topk_smallest_plain,
                                                   topk_smallest,
                                                   topk_smallest32)
    g = torch.Generator(device="cpu").manual_seed(3)
    for n, k in ((7, 3), (7, 50), (5000, 100), (3_000_000, 4096),
                 (3_000_000, 1)):
        tok = torch.randint(-40, 40, (n,), generator=g) * (1 << 57)
        valid = torch.rand(n, generator=g) < 0.8
        desc = torch.arange(n, 0, -1, dtype=torch.int64)  # all rows admitted
        for tok, v in ((tok, valid), (tok, None), (desc, None)):
            want = _topk_smallest_plain(tok.to(dev),
                                        None if v is None else v.to(dev), k)
            got = topk_smallest(tok.to(dev),
                                None if v is None else v.to(dev), k)
            m = min(n if v is None else int(v.sum()), k)
            max_abs_err(got[:m], want[:m])
    for n, k in ((7, 3), (7, 50), (5000, 100), (3_000_000, 100),
                 (3_000_000, 4096), (3_000_000, 1)):
        rnd = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=g,
                            dtype=torch.int64).to(torch.int32)
        rnd[torch.rand(n, generator=g) < 0.2] = 7          # ties
        rnd[:4] = torch.tensor([-1, -2, -1, 0], dtype=torch.int32)[:n]
        valid = torch.rand(n, generator=g) < 0.8
        keys = {"random": rnd,
                # every row beats the k-th best so far: all rows admitted
                "descending": torch.arange(n, 0, -1, dtype=torch.int32),
                "ascending": torch.arange(n, dtype=torch.int32),
                # one key: ties across every block boundary
                "constant": torch.full((n,), 5, dtype=torch.int32)}
        for key in keys.values():
            for v in (valid, None):
                want = _topk_smallest32_plain(
                    key.to(dev), None if v is None else v.to(dev), k)
                got = topk_smallest32(key.to(dev),
                                      None if v is None else v.to(dev), k)
                m = min(n if v is None else int(v.sum()), k)
                max_abs_err(got[:m], want[:m])
    print("K3 topk_smallest edge cases (64-bit and 32-bit entries): ties, "
          "keys 2^32-2 and 2^32-1, invalid rows, k > n, monotone keys, "
          "ties across blocks agree", flush=True)


# multi-key sorts of the sort_key_columns, least significant key last
SORT_KEY_CHAINS = [["bool", "int32_bounded"], ["float64", "uint64", "int64"],
                   ["uint64", "float64", "float32", "bool"]]


def sort_key_columns(rng, n):
    """CPU SortKeys of n rows for every kind of key K4 sorts: signed and
    unsigned ints, UInt64 bits above 2^63, floats with NaN, -0.0 and +0.0,
    bools and a bounded int32 (Q2b's key)."""
    from clickhouse_tpu_torch.ops.sort_ops import SortKey
    f = rng.normal(0, 1, n)
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    f[rng.random(n) < 0.05] = 0.0
    u = rng.integers(0, 4, n).astype(np.uint64) << np.uint64(62)
    return {
        "int64": SortKey(torch.from_numpy(rng.integers(-3, 3, n))),
        "uint64": SortKey(torch.from_numpy(u.view(np.int64)), unsigned=True),
        "float64": SortKey(torch.from_numpy(f)),
        "float32": SortKey(torch.from_numpy(f.astype(np.float32))),
        "int16": SortKey(torch.from_numpy(
            rng.integers(-300, 300, n).astype(np.int16))),
        "uint8": SortKey(torch.from_numpy(
            rng.integers(0, 256, n).astype(np.uint8))),
        "bool": SortKey(torch.from_numpy(rng.random(n) < 0.5),
                        bounds=(0, 1)),
        "int32_bounded": SortKey(torch.from_numpy(
            rng.integers(0, 1_000_003, n).astype(np.int32)),
            bounds=(0, 1_000_002)),
    }


def check_k4(dev):
    """K4 against its plain version: raw keys (one row, row counts off the
    4,096-row tile grid, all-equal keys, u64 keys above 2^63, 0 bits), and
    the whole pass plan of sort_rows (every key type's token, NaN and -0.0,
    invalid rows, no valid row, multi-key chains) on the card against the
    same call on the CPU copies."""
    import dataclasses
    from clickhouse_tpu_torch.ops.sort_ops import (
        _radix_sort_pairs_plain, radix_sort_pairs, sort_rows)
    rng = np.random.default_rng(6)
    calls = 0
    for n in (1, 4095, 4097, 1_000_003):
        cases = [
            (torch.from_numpy(rng.integers(0, 1 << 21, n).astype(np.int32)),
             21),
            (torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                              .astype(np.uint32).view(np.int32)), 32),
            (torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                           dtype=np.int64)), 64),
            (torch.from_numpy(rng.integers(0, 3, n).astype(np.int64) << 62),
             64),
            (torch.full((n,), 5, dtype=torch.int32), 3),
            (torch.zeros(n, dtype=torch.int64), 0)]
        perm = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
        for key, bits in cases:
            for vals in (None, perm):
                got = radix_sort_pairs(key.to(dev), bits, vals)
                want = _radix_sort_pairs_plain(key.to(dev), bits, vals)
                for a, b in zip(got, want):
                    max_abs_err(a, b)
                calls += 1
    n = 1_000_003
    cols = sort_key_columns(rng, n)
    chains = [[k] for k in cols] + SORT_KEY_CHAINS
    valids = [None, torch.from_numpy(rng.random(n) < 0.8),
              torch.zeros(n, dtype=torch.bool)]
    for names in chains:
        for valid in valids:
            keys = [cols[k] for k in names]
            want, wk = sort_rows(keys, valid)
            got, gk = sort_rows(
                [dataclasses.replace(k, data=k.data.to(dev)) for k in keys],
                None if valid is None else valid.to(dev))
            m = n if valid is None else int(valid.sum())
            max_abs_err(got.cpu()[:m], want[:m])
            for a, b in zip(gk, wk):
                max_abs_err(a.cpu()[:m], b[:m])
            calls += 1
    print(f"K4 radix_sort_pairs edge cases: {calls} calls agree (raw keys "
          f"at n in (1, 4095, 4097, 1000003); sort_rows over every key "
          f"type, chains, invalid rows and no valid row)", flush=True)


def check_k5(dev):
    """K5 against its plain version: one group, a group a row, more groups
    than slots, invalid rows, no valid row, two key arrays."""
    from clickhouse_tpu_torch.ops.scan_ops import (_segment_bounds_plain,
                                                   segment_bounds)
    rng = np.random.default_rng(7)
    n = 3_000_017
    base = np.sort(rng.integers(0, 200_000, n))
    cases = {"one_group": ([np.zeros(n, np.int32)], n, 1 << 20),
             "group_a_row": ([np.arange(n, dtype=np.int64)], n, 1 << 22),
             "over_cap": ([(np.arange(n) // 3).astype(np.int32)], n, 1024),
             "invalid_rows": ([base.astype(np.int32)], n - 54_321, 1 << 18),
             "no_valid_row": ([base.astype(np.int32)], 0, 1 << 18),
             "two_keys": ([base.astype(np.int32),
                           np.where(base % 7 == 0, rng.integers(0, 2, n), 0)
                           .astype(np.int64)], n, 1 << 18)}
    for name, (keys, nv, cap_g) in cases.items():
        kd = [torch.from_numpy(k).to(dev) for k in keys]
        nvt = torch.tensor(nv, dtype=torch.int64, device=dev)
        for a, b in zip(segment_bounds(kd, nvt, cap_g),
                        _segment_bounds_plain(kd, nvt, cap_g)):
            max_abs_err(a, b)
    print(f"K5 segment_bounds edge cases agree: {', '.join(cases)}",
          flush=True)


def grouped_rows(n, groups, dev, skew=None, seed=8):
    """(perm, gid) of n rows over `groups` groups, key-sorted on the card
    (a `skew` share of the rows in one group), the rows of each group in
    ascending row order: what K4 and K5 give K6."""
    g = torch.Generator(device=dev).manual_seed(seed)
    key = torch.randint(0, groups, (n,), generator=g, device=dev)
    if skew is not None:
        key[torch.rand(n, generator=g, device=dev) < skew] = groups // 2
    order = torch.sort(key, stable=True)
    ks = order.values
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = ks[1:] != ks[:-1]
    gid = (torch.cumsum(head.to(torch.int32), 0) - 1).to(torch.int32)
    return order.indices.to(torch.int32), gid


def k6_agrees(op, data, mask, perm, gid, cap_g, unsigned=False) -> float:
    """K6 against its plain version on the same inputs; float sums within
    n_g * eps * sum(|x|) a group of n_g masked-in rows.  -> max abs err."""
    from clickhouse_tpu_torch.ops.scan_ops import (_segment_reduce_plain,
                                                   segment_reduce)
    got = segment_reduce(op, data, mask, perm, gid, cap_g,
                         unsigned=unsigned)
    want = _segment_reduce_plain(op, data, mask, perm, gid, cap_g, unsigned)
    if not (op == "sum" and got.is_floating_point()):
        if got.is_floating_point():     # min/max/any: the same bits
            bits = torch.int64 if got.dtype == torch.float64 else torch.int32
            got, want = got.view(bits), want.view(bits)
        return max_abs_err(got, want)
    scale = _segment_reduce_plain("sum", data.abs().to(torch.float64), mask,
                                  perm, gid, cap_g, False)
    cnt = _segment_reduce_plain("count", None, mask, perm, gid, cap_g,
                                False)
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        fail(f"K6 {op}: NaN groups differ")
    err = (got - want).abs()[~nan]
    if not bool((err <= (cnt.to(torch.float64) * F64_EPS * scale)[~nan])
                .all()):
        fail(f"K6 float sum beyond n_g * eps * sum(|x|) a group")
    return float(err.max()) if err.numel() else 0.0


def check_k6(dev):
    """K6 against its plain version: every op over every storage type, with
    no mask, a partial mask and a mask of no row (empty and fully masked
    groups), UInt64 bits, and 3M rows where one group holds 40 %."""
    rng = np.random.default_rng(9)
    n = 1_000_003
    perm, gid = grouped_rows(n, 70_000, dev)
    masks = [None, torch.from_numpy(rng.random(n) < 0.3).to(dev),
             torch.zeros(n, dtype=torch.bool, device=dev)]
    calls = 0
    for dtype in (torch.bool, torch.int8, torch.uint8, torch.int16,
                  torch.int32, torch.int64, torch.float32, torch.float64):
        if dtype.is_floating_point:
            x = torch.from_numpy(rng.normal(0, 1e6, n)).to(dtype)
            x[::97] = -0.0
            x[::89] = float("nan")
        elif dtype == torch.bool:
            x = torch.from_numpy(rng.random(n) < 0.5)
        else:
            info = torch.iinfo(dtype)
            x = torch.from_numpy(rng.integers(info.min, info.max, n,
                                              endpoint=True)).to(dtype)
        for op in ("sum", "min", "max", "any", "bor", "band", "bxor",
                   "count"):
            if op in ("bor", "band", "bxor") and dtype.is_floating_point:
                continue
            for m in masks:
                for uns in ((False, True) if dtype == torch.int64
                            else (False,)):
                    k6_agrees(op, None if op == "count" else x.to(dev), m,
                              perm, gid, 1 << 17, unsigned=uns)
                    calls += 1
    sperm, sgid = grouped_rows(3_000_000, 200_000, dev, skew=0.4)
    y = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, 3_000_000)).to(dev)
    for op in ("sum", "min", "max", "any", "count"):
        k6_agrees(op, None if op == "count" else y, None, sperm, sgid,
                  1 << 18)
        calls += 1
    print(f"K6 segment_reduce edge cases: {calls} calls agree (every op "
          f"and storage type, masks of some and of no row, a group of 40 % "
          f"of the rows)", flush=True)


def main_path_args(session):
    """Run the main path's queries once more with each kernel's launch
    wrapper spied on, and return the arguments of each kernel's largest
    launch (K1: of each form, its filter terms and its bool mask; K6: of
    each op): the exact inputs the main path hands it."""
    from clickhouse_tpu_torch.ops import agg_ops, mxu_segsum, scan_ops, \
        sort_ops
    # kernel -> (module, wrapper, rows of a launch from its arguments)
    spied = {"masked_reduce": (agg_ops, "_masked_reduce_cuda",
                               lambda a: a[4]),
             "dense_group_reduce": (mxu_segsum, "_dense_group_reduce_cuda",
                                    lambda a: a[0].shape[0]),
             "topk_smallest": (sort_ops, "_topk_cuda",
                               lambda a: a[0].shape[0]),
             "radix_sort_pairs": (sort_ops, "_radix_sort_cuda",
                                  lambda a: a[0].shape[0]),
             "segment_bounds": (scan_ops, "_segment_bounds_cuda",
                                lambda a: a[0][0].shape[0]),
             "segment_reduce": (scan_ops, "_segment_reduce_cuda",
                                lambda a: a[4].shape[0])}
    got, saved = {}, {}
    for name, (mod, attr, rows_of) in spied.items():
        fn = saved[name] = getattr(mod, attr)

        def spy(*args, _fn=fn, _name=name, _rows_of=rows_of):
            rows = _rows_of(args)
            key = _name
            if _name == "segment_reduce":
                key = f"{_name}:{args[0]}"
            elif _name == "masked_reduce" and not args[5]:
                key = f"{_name}:mask"
            if key not in got or rows > got[key][1]:
                got[key] = (args, rows)
            return _fn(*args)
        setattr(mod, attr, spy)
    try:
        for _, sql in QUERIES:
            session.execute(sql)
    finally:
        for name, (mod, attr, _) in spied.items():
            setattr(mod, attr, saved[name])
    return {name: args for name, (args, _) in got.items()}


def nbytes(*ts) -> int:
    """Bytes of the tensors among ts (lists flattened; None skipped)."""
    total = 0
    for t in ts:
        if isinstance(t, (list, tuple)):
            total += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def k2_wide(dev) -> float:
    """K2 over S = 16,384 slots at 100M rows (the slot of x % 16,384 for
    the main path's column, one count and one sum of x), held against its
    plain version: the widest GROUP BY K2 takes.  -> kernel ms."""
    from clickhouse_tpu_torch.ops.mxu_segsum import (
        _dense_group_reduce_plain, dense_group_reduce)
    S = 16384
    x = torch.arange(N_ROWS, dtype=torch.int64, device=dev) \
        * 2654435761 % 1_000_003
    args = (x.remainder(S).to(torch.int32), None, [None], [x], [None], S)
    for a, b in zip(dense_group_reduce(*args),
                    _dense_group_reduce_plain(*args)):
        max_abs_err(a, b)
    ms = cuda_ms(lambda: dense_group_reduce(*args))
    nb = nbytes(args[0], x) + 2 * S * 8
    print(f"dense_group_reduce at S = {S}, one count and one int64 sum, "
          f"{N_ROWS} rows: {ms:.4f} ms, {nb} bytes, bound "
          f"{bound_ms(nb):.4f} ms (exact against the plain version)",
          flush=True)
    return ms


def device_kernels(call, reps=5):
    """{kernel name: device ms per call} over `reps` calls of call(), the L2
    flushed before each, from a torch.profiler trace (the flush's own
    kernel left out)."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        if t > 0 and e.count >= reps:
            out[e.key] = t / reps / 1e3
    flush_keys = [k for k in out if "fill" in k.lower()
                  or "memset" in k.lower()]
    for k in flush_keys:
        del out[k]
    return out


def k1_forms(dev, args, mask_args):
    """K1 at Q1's inputs (its filter as a term over x's int32 storage, the
    row bound, no mask) and at the main path's largest count over a bool
    mask (mask_args: the aggregated block's rows that _sort_block counts),
    each held against its plain version and timed beside it.  -> record of
    the kernels line."""
    from clickhouse_tpu_torch.ops.agg_ops import (_masked_reduce_plain,
                                                  masked_reduce)
    op, data, mask, unsigned, n_rows, terms = args
    if data is not None or mask is not None or len(terms) != 1 \
            or terms[0].storage.dtype != torch.int32 or n_rows < N_ROWS:
        fail(f"Q1 did not reach K1 as one int32 term over {N_ROWS} rows: "
             f"data {data is not None}, mask {mask is not None}, "
             f"{[t.storage.dtype for t in terms]}, {n_rows} rows")
    t = terms[0]

    def fused():
        return masked_reduce(op, None, None, n_rows=n_rows, terms=terms)

    def fused_plain():
        return _masked_reduce_plain(op, None, None, False, n_rows, terms)
    rec = dict(
        max_abs_err=max_abs_err(fused(), fused_plain()),
        ms=cuda_ms(fused), plain_ms=cuda_ms(fused_plain),
        library_ms=None,
        library="none: no single PyTorch call counts x > c "
                "(torch.count_nonzero(x > c) timed for information)",
        # the rows the kernel must read, 4 bytes each, and the count
        bytes=n_rows * t.storage.element_size() + 8,
        shape=f"count over {n_rows} rows of `x {t.cmp} {t.constant}`, x "
              f"stored as {t.storage.dtype}")
    x = t.storage
    c = t.constant
    info_ms = cuda_ms(lambda: torch.count_nonzero(x > c))
    kernels = device_kernels(fused)
    rec["kernels_per_call"] = len(kernels)
    print(f"masked_reduce at Q1's inputs, device kernels of one call "
          f"(torch.profiler): {kernels}; torch.count_nonzero(x > c) "
          f"{info_ms:.4f} ms, for information", flush=True)
    if len(kernels) != 1:
        fail(f"one K1 call ran {len(kernels)} device kernels: {kernels}")
    # the mask form, at the main path's largest bool-mask count
    mop, mdata, m, muns, mrows, mterms = mask_args
    if mdata is not None or m is None or mterms:
        fail(f"K1's largest mask-form launch is not a count over a mask: "
             f"data {mdata is not None}, mask {m is not None}, {mterms}")

    def mask_form():
        return masked_reduce(mop, None, m, n_rows=mrows)
    # the mask's rows below the row bound, and the count
    mb = mrows * m.element_size() + 8
    max_abs_err(mask_form(),
                _masked_reduce_plain(mop, None, m, False, mrows))
    rec.update(
        mask_form_ms=cuda_ms(mask_form),
        mask_form_plain_ms=cuda_ms(
            lambda: _masked_reduce_plain(mop, None, m, False, mrows)),
        mask_form_library_ms=cuda_ms(lambda: torch.sum(m[:mrows])),
        mask_form_bytes=mb, mask_form_bound_ms=bound_ms(mb),
        mask_form_shape=f"count over bool{tuple(m.shape)}, {mrows} rows")
    print(f"masked_reduce, mask form (count over bool{tuple(m.shape)}, "
          f"{mrows} rows, the main path's largest): "
          f"kernel {rec['mask_form_ms']:.4f} ms, plain "
          f"{rec['mask_form_plain_ms']:.4f} ms, library "
          f"{rec['mask_form_library_ms']:.4f} ms (torch.sum(mask)), {mb} "
          f"bytes, bound {bound_ms(mb):.4f} ms, share of bound "
          f"{bound_ms(mb) / rec['mask_form_ms']:.3f}", flush=True)
    return rec


def k3_split(call):
    """Device ms of K3's level 1 (k_topk_stream) and of its merge
    (k_topk_bound + k_topk_final) in one call, from a torch.profiler trace
    (device_kernels).  None where the trace holds no device time for
    them."""
    kernels = device_kernels(call)

    def ms(*names):
        return sum(t for k, t in kernels.items()
                   if any(n in k for n in names)) or None
    return ms("k_topk_stream"), ms("k_topk_bound", "k_topk_final")


def q_shapes(dev, args):
    """Each kernel on the inputs the main path gave it (100M rows), held
    against its plain version and timed beside it, beside one PyTorch call
    of the same function where there is one (timed here only; the port
    never calls it).  -> {name: record}."""
    from clickhouse_tpu_torch.ops.mxu_segsum import (
        _dense_group_reduce_plain, dense_group_reduce)
    from clickhouse_tpu_torch.ops.sort_ops import (
        _topk_smallest32_plain, _topk_smallest_plain, topk_smallest,
        topk_smallest32)
    out = {}
    for key in ("masked_reduce", "masked_reduce:mask"):
        if key not in args:
            fail(f"the main path gave {key} no launch")
    # Q1: count() with the filter `x > 500000` as a K1 term
    out["masked_reduce"] = k1_forms(dev, args["masked_reduce"],
                                    args["masked_reduce:mask"])
    # Q2: slot ids, base mask, counts for count() and the group count (one
    # mask, counted once), sum(x)
    k2 = args["dense_group_reduce"]
    ids, base, cms, svs, sms, S = k2
    got, want = dense_group_reduce(*k2), _dense_group_reduce_plain(*k2)
    out["dense_group_reduce"] = dict(
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
        ms=cuda_ms(lambda: dense_group_reduce(*k2)),
        plain_ms=cuda_ms(lambda: _dense_group_reduce_plain(*k2), reps=5),
        library_ms=None,
        library="none: no single PyTorch call gives exact per-slot counts "
                "and int64 sums together",
        bytes=nbytes(ids, base, cms, svs, sms) + (len(cms) + len(svs)) * S * 8,
        shape=f"ids {tuple(ids.shape)} {ids.dtype}, base mask "
              f"{None if base is None else base.dtype}, {len(cms)} counts, "
              f"sums of {[v.dtype for v in svs]}, S = {S}")
    # its two halves alone: the counts, and the sums
    out["dense_group_reduce"]["counts_only_ms"] = cuda_ms(
        lambda: dense_group_reduce(ids, base, cms[:1], [], [], S))
    out["dense_group_reduce"]["sums_only_ms"] = cuda_ms(
        lambda: dense_group_reduce(ids, base, [], svs, sms, S))
    print(f"dense_group_reduce at Q2's inputs, counts alone "
          f"{out['dense_group_reduce']['counts_only_ms']:.4f} ms, sums alone "
          f"{out['dense_group_reduce']['sums_only_ms']:.4f} ms", flush=True)
    # the same reduction over skewed slots, where a warp's lanes share one:
    # every row in one slot (S = 1), and Zipf(1.1) slots over S = 1,024
    # (inverse CDF on the card, from a seed)
    n = ids.shape[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    cdf = torch.cumsum(torch.arange(1, 1025, dtype=torch.float64,
                                    device=dev) ** -1.1, 0)
    zipf = torch.searchsorted(cdf / cdf[-1], torch.rand(
        n, generator=gen, dtype=torch.float64, device=dev)).clamp_(max=1023)
    for key, S_, sid in (("one_slot_ms", 1, torch.zeros_like(ids)),
                         ("zipf_ms", 1024, zipf.to(torch.int32))):
        ks = (sid, base, cms, svs, sms, S_)
        for a, b in zip(dense_group_reduce(*ks),
                        _dense_group_reduce_plain(*ks)):
            max_abs_err(a, b)
        out["dense_group_reduce"][key] = cuda_ms(
            lambda: dense_group_reduce(*ks))
    del zipf
    print(f"dense_group_reduce at 100M rows, skewed: one slot "
          f"{out['dense_group_reduce']['one_slot_ms']:.4f} ms, Zipf(1.1) over "
          f"1,024 slots {out['dense_group_reduce']['zipf_ms']:.4f} ms "
          f"(exact against the plain version)", flush=True)
    out["dense_group_reduce"]["wide_s_ms"] = k2_wide(dev)

    def bincount_index_add():
        torch.bincount(ids, minlength=1024)
        torch.zeros(1024, dtype=torch.int64, device=dev).index_add_(
            0, ids, svs[0])
    print(f"dense_group_reduce for information: torch.bincount + "
          f"index_add_ at Q2's shape {cuda_ms(bincount_index_add):.4f} ms",
          flush=True)
    # Q3: ORDER BY x LIMIT 100 reads the u32 key (int32 bits) and the
    # block's row validity through the 32-bit entry
    key, dtype, valid, k = args["topk_smallest"][:4]
    if dtype != torch.int32:
        fail(f"Q3 took K3's {dtype} entry, not the 32-bit one")
    out["topk_smallest"] = dict(
        max_abs_err=max_abs_err(topk_smallest32(key, valid, k),
                                _topk_smallest32_plain(key, valid, k)),
        ms=cuda_ms(lambda: topk_smallest32(key, valid, k)),
        plain_ms=cuda_ms(lambda: _topk_smallest32_plain(key, valid, k),
                         reps=5),
        library_ms=cuda_ms(lambda: torch.topk(key, k, largest=False,
                                              sorted=True)),
        library=f"torch.topk(key, {k}, largest=False, sorted=True), time "
                f"only (its tie order is unpinned)",
        bytes=nbytes(key, valid) + k * 8,
        shape=f"key {tuple(key.shape)} {key.dtype}, valid "
              f"{None if valid is None else valid.dtype}, k = {k}")
    level1, merge = k3_split(lambda: topk_smallest32(key, valid, k))
    # the 64-bit entry at the same rows: the u64 order token of the key
    tok = key.to(torch.int64) & 0xFFFFFFFF
    max_abs_err(topk_smallest(tok, valid, k),
                _topk_smallest_plain(tok, valid, k))
    ms64 = cuda_ms(lambda: topk_smallest(tok, valid, k))
    b64 = nbytes(tok, valid) + k * 8
    out["topk_smallest"].update(level1_ms=level1, merge_ms=merge,
                                entry64_ms=ms64,
                                entry64_bound_ms=bound_ms(b64))
    print(f"topk_smallest 32-bit entry, device time by kernel "
          f"(torch.profiler): level 1 {level1} ms, merge {merge} ms; 64-bit "
          f"entry at Q3's rows {ms64:.4f} ms, bound {bound_ms(b64):.4f} ms "
          f"({b64} bytes)", flush=True)
    for name, r in out.items():
        r["bound_ms"] = bound_ms(r["bytes"])
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"{name} at the main path's shape ({r['shape']}): max_abs_err "
              f"{r['max_abs_err']}, kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib} ms ({r['library']}), "
              f"{r['bytes']} bytes, bound {r['bound_ms']:.4f} ms, share of "
              f"bound {r['bound_ms'] / r['ms']:.3f}", flush=True)
    return out


def sort_shapes(dev, args):
    """K4, K5 and K6 on the inputs the main path gave them (Q2b's sort and
    bounds over 100M rows, Q2m's reductions), each held against its plain
    version and timed beside it and beside a PyTorch call of the same
    function where there is one.  -> {name: record}."""
    from clickhouse_tpu_torch.ops.scan_ops import (
        COUNTED_OPS, _segment_bounds_plain, _segment_reduce_plain,
        segment_bounds, segment_reduce)

    def slot_bytes(op):
        """Bytes K6 writes a group slot: the state, and the count where
        the op keeps one (a count keeps the count alone)."""
        return 8 * ((op != "count") + (op in COUNTED_OPS))
    from clickhouse_tpu_torch.ops.sort_ops import (
        _radix_sort_pairs_plain, radix_sort_pairs, sort_pass_plan)
    out = {}
    key, bits, vals = args["radix_sort_pairs"]
    n = key.shape[0]
    got = radix_sort_pairs(key, bits, vals)
    want = _radix_sort_pairs_plain(key, bits, vals)
    passes, digit = sort_pass_plan(bits)
    out["radix_sort_pairs"] = dict(
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
        ms=cuda_ms(lambda: radix_sort_pairs(key, bits, vals)),
        plain_ms=cuda_ms(lambda: _radix_sort_pairs_plain(key, bits, vals),
                         reps=5),
        library_ms=cuda_ms(lambda: torch.sort(key, stable=True)),
        library="torch.sort(key, stable=True)",
        # read each key (and value) once, write sorted keys and row ids
        bytes=nbytes(key, vals) + n * key.element_size() + n * 4,
        passes=passes, digit_bits=digit,
        shape=f"{n} {key.dtype} keys of {bits} bits, "
              f"{'row ids' if vals is None else 'given values'}: "
              f"{passes} passes of {digit}-bit digits")
    # its three kernels a pass apart, summed over the passes (a trace)
    split = device_kernels(lambda: radix_sort_pairs(key, bits, vals))
    for part in ("hist", "scan", "scatter"):
        out["radix_sort_pairs"][f"{part}_ms"] = sum(
            t for k, t in split.items() if f"k_radix_{part}" in k) or None
    print(f"radix_sort_pairs device time by kernel (torch.profiler): "
          f"{split}", flush=True)
    del got, want
    keys, nv, cap_g = args["segment_bounds"]
    got = segment_bounds(keys, nv, cap_g)
    want = _segment_bounds_plain(keys, nv, cap_g)
    k0 = keys[0]
    info = cuda_ms(lambda: torch.unique_consecutive(k0, return_counts=True),
                   reps=5)
    out["segment_bounds"] = dict(
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
        ms=cuda_ms(lambda: segment_bounds(keys, nv, cap_g)),
        plain_ms=cuda_ms(lambda: _segment_bounds_plain(keys, nv, cap_g),
                         reps=5),
        library_ms=None,
        library="none: no single PyTorch call gives the group ids and "
                "bounds",
        information=f"torch.unique_consecutive(key, return_counts=True) "
                    f"{info:.4f} ms",
        # read the keys, write a group id a row and 16 bytes a slot
        bytes=nbytes(keys) + k0.shape[0] * 4 + cap_g * 16 + 8,
        shape=f"{len(keys)} sorted key array(s) of {k0.shape[0]} "
              f"{k0.dtype}, {cap_g} group slots")
    del got, want
    ops = sorted(k.split(":")[1] for k in args if
                 k.startswith("segment_reduce:"))
    if not ops:
        fail("the main path gave K6 no launch")
    rec = None
    per_op = {}
    for op in ops:
        a = args[f"segment_reduce:{op}"]
        op_, data, mask, perm, gid, cap_g, uns = a
        err = k6_agrees(op_, data, mask, perm, gid, cap_g, uns)
        ms = cuda_ms(lambda: segment_reduce(op_, data, mask, perm, gid,
                                            cap_g, unsigned=uns))
        per_op[op] = ms
        if op == "sum" or rec is None:
            rows = gid.shape[0]
            rec = dict(
                max_abs_err=err, ms=ms,
                plain_ms=cuda_ms(lambda: _segment_reduce_plain(
                    op_, data, mask, perm, gid, cap_g, uns), reps=5),
                library_ms=None,
                library="none: no single PyTorch call gathers through the "
                        "permutation and reduces each group",
                # a group id, a permutation entry, a value (and a mask
                # byte) a row; the state (and count) a slot
                bytes=rows * (8 + data.element_size()
                              + (0 if mask is None else 1))
                + cap_g * slot_bytes(op),
                shape=f"{op} over {rows} sorted rows, data "
                      f"{data.dtype}, mask {mask is not None}, {cap_g} "
                      f"group slots")
    rec["per_op_ms"] = per_op
    # for information: torch.segment_reduce over the values gathered into
    # sorted order beforehand (floats only), at Q2m's groups
    a = args["segment_reduce:sum"] if "sum" in ops else \
        args[f"segment_reduce:{ops[0]}"]
    _, data, _, perm, gid, _, _ = a
    nvalid = int((gid < a[5]).sum())
    lengths = torch.bincount(gid[:nvalid].long())
    vals = data.index_select(0, perm[:nvalid]).to(torch.float64)
    info = cuda_ms(lambda: torch.segment_reduce(vals, "sum",
                                                lengths=lengths), reps=5)
    rec["information"] = (f"torch.segment_reduce(sum) over pre-gathered "
                          f"float64 values {info:.4f} ms")
    del vals
    # one group holding 40 % of 100M rows
    sperm, sgid = grouped_rows(N_ROWS, 1 << 20, dev, skew=0.4)
    x = data if data.shape[0] >= N_ROWS else torch.arange(
        N_ROWS, dtype=torch.int32, device=dev)
    k6_agrees("sum", x, None, sperm, sgid, 1 << 21)
    rec["skew_ms"] = cuda_ms(lambda: segment_reduce("sum", x, None, sperm,
                                                    sgid, 1 << 21))
    sb = N_ROWS * (8 + x.element_size()) + (1 << 21) * slot_bytes("sum")
    rec["skew_bound_ms"] = bound_ms(sb)
    print(f"segment_reduce over {N_ROWS} rows, one group holding 40 % of "
          f"them: {rec['skew_ms']:.4f} ms, bound "
          f"{rec['skew_bound_ms']:.4f} ms ({sb} bytes; agrees with the "
          f"plain version); per op at Q2m's inputs {per_op}", flush=True)
    del sperm, sgid
    out["segment_reduce"] = rec
    for name, r in out.items():
        r["bound_ms"] = bound_ms(r["bytes"])
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"{name} at the main path's shape ({r['shape']}): max_abs_err "
              f"{r['max_abs_err']}, kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib} ms ({r['library']}), "
              f"{r['bytes']} bytes, bound {r['bound_ms']:.4f} ms, share of "
              f"bound {r['bound_ms'] / r['ms']:.3f}"
              + (f"; {r['information']}" if "information" in r else ""),
              flush=True)
    return out


def expected_answers(x: np.ndarray):
    q1 = [(int((x > 500000).sum()),)]
    k = x % 1024
    cnt = np.bincount(k, minlength=1024)
    # float64 weights are exact here: every partial sum is an integer below
    # 2^53 (the whole column sums to ~5e13)
    if int(x.sum()) >= 2**53:
        fail("numpy reference sum would not be exact")
    sums = np.bincount(k, weights=x.astype(np.float64),
                       minlength=1024).astype(np.int64)
    # ORDER BY c DESC: ties keep slot (= key) order, as the engine's top-k
    top = np.lexsort((np.arange(1024), -cnt))[:10]
    q2 = [(int(i), int(cnt[i]), int(sums[i])) for i in top]
    q3 = [(int(v),) for v in np.sort(np.partition(x, 100)[:100])]
    # Q2b: a group a distinct x, in ascending key order; ties of c keep it
    cnt_b = np.bincount(x)
    top_b = np.lexsort((np.arange(len(cnt_b)), -cnt_b))[:10]
    q2b = [(int(i), int(cnt_b[i])) for i in top_b]
    # Q2m: groups of intDiv(x, 4) (x >= 0: floor division) by (-s, k);
    # any(x) is the first row of the group in row order
    km = x // 4
    cnt_m = np.bincount(km)
    sum_m = np.bincount(km, weights=x.astype(np.float64)).astype(np.int64)
    top_m = np.lexsort((np.arange(len(sum_m)), -sum_m))[:10]
    q2m = []
    for g in top_m:
        rows = np.flatnonzero(km == g)
        q2m.append((int(g), int(cnt_m[g]), int(sum_m[g]),
                    int(x[rows].min()), int(x[rows].max()), int(x[rows[0]])))
    return {"Q1": q1, "Q2": q2, "Q2b": q2b, "Q2m": q2m, "Q3": q3}


def load_hits(ch):
    """A cuda session with hits (x Int64) of N_ROWS rows on the device."""
    x = (np.arange(N_ROWS, dtype=np.int64) * 2654435761) % 1_000_003
    s = ch.connect(device="cuda")
    s.execute("CREATE TABLE hits (x Int64)")
    t0 = time.perf_counter()
    s.insert_pydict("hits", {"x": x})
    s.catalog.get_table("default", "hits").read_block()
    torch.cuda.synchronize()
    print(f"insert + device block of {N_ROWS} rows: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return s, x


def device_busy(s, sql, reps=QUERY_REPS):
    """(device-busy ms, device operations, wall ms, top) per run of sql,
    from a torch.profiler trace of `reps` runs (busy: the union of the
    intervals of the device's kernels, copies and fills; the wall is the
    traced one; top: the 8 device operations that take the most device
    time, as (name, ms a run))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    s.execute(sql)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            s.execute(sql)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    top = [(name[:70], t / reps / 1e3) for name, t in top]
    return busy / reps / 1e3, len(spans) / reps, wall / reps * 1e3, top


def time_queries(s):
    """Median wall of QUERY_REPS runs of each query (after one untimed run),
    then the device-busy time of Q1, Q2b and Q2m from a trace.  Uses only
    the public API, so copied into an unpacked older checkout
    (``--queries``) it times that tree alike; a query that tree does not
    run (NotImplementedError_) is reported and skipped."""
    from clickhouse_tpu_torch.core.errors import NotImplementedError_
    ran = set()
    for name, sql in QUERIES:
        try:
            s.execute(sql)
        except NotImplementedError_ as e:
            print(f"{name} not ported in this tree: {e}", flush=True)
            continue
        ran.add(name)
        times = []
        for _ in range(QUERY_REPS):
            t0 = time.perf_counter()
            s.execute(sql)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"{name} median wall {statistics.median(times) * 1e3:.3f} ms "
              f"over {QUERY_REPS} runs ({N_ROWS} rows): {sql}", flush=True)
    for name, sql in QUERIES:
        if name in ("Q1", "Q2b", "Q2m") and name in ran:
            busy, ops, wall, top = device_busy(s, sql)
            print(f"{name} under torch.profiler: device busy {busy:.4f} ms "
                  f"of {wall:.3f} ms wall a run, {ops:g} device operations "
                  f"a run", flush=True)
            if name != "Q1":
                print(f"{name} device ms a run by operation (the top 8): "
                      + "; ".join(f"{n} {t:.4f}" for n, t in top),
                      flush=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    import clickhouse_tpu_torch as ch
    from clickhouse_tpu_torch.ops import _native

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _native.library()
    print(f"kernel build (nvcc, sm_90a) + load: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if sys.argv[1:] == ["--k2-wide"]:
        # uses only dense_group_reduce and its plain version, so it runs
        # beside a checkout of an earlier tree to time K2 there alike
        k2_wide(dev)
        return
    if sys.argv[1:] == ["--queries"]:
        time_queries(load_hits(ch)[0])
        return

    check_k1(dev)
    check_k2(dev)
    check_k3(dev)
    check_k4(dev)
    check_k5(dev)
    check_k6(dev)

    s, x = load_hits(ch)
    want = expected_answers(x)

    # the main path, once, through the public API: each query with the
    # launch counters set to 0 just before it and read just after.  Two
    # wrappers are watched on the way (each call passed on as it is): K1's,
    # for its launches with and without filter terms, and K4's, for the
    # bits it sorts
    from clickhouse_tpu_torch.ops import agg_ops, sort_ops
    per_query = {}
    launches = {k: 0 for k in _native.LAUNCHES}
    launch_rows = {k: [] for k in _native.LAUNCHES}
    k1_forms_seen = {"fused": 0, "mask_form": 0}
    k4_calls = []
    k1_cuda, k4_cuda = agg_ops._masked_reduce_cuda, sort_ops._radix_sort_cuda

    def k1_watch(*a):
        k1_forms_seen["fused" if a[5] else "mask_form"] += 1
        return k1_cuda(*a)

    def k4_watch(keys, bits, values):
        k4_calls.append((keys.shape[0], bits))
        return k4_cuda(keys, bits, values)
    agg_ops._masked_reduce_cuda = k1_watch
    sort_ops._radix_sort_cuda = k4_watch
    try:
        main_path(s, want, per_query, launches, launch_rows, k1_forms_seen,
                  k4_calls)
    finally:
        agg_ops._masked_reduce_cuda = k1_cuda
        sort_ops._radix_sort_cuda = k4_cuda
    time_queries(s)

    args = main_path_args(s)
    shapes = q_shapes(dev, args)
    shapes.update(sort_shapes(dev, args))
    del args
    shapes["masked_reduce"].update(
        launches_fused=k1_forms_seen["fused"],
        launches_mask_form=k1_forms_seen["mask_form"])
    print(f"masked_reduce launches on the main path: "
          f"{k1_forms_seen['fused']} with filter terms, "
          f"{k1_forms_seen['mask_form']} without (bool-mask counts)",
          flush=True)
    kernel_line(card, shapes, launches, launch_rows)


def main_path(s, want, per_query, launches, launch_rows, k1_forms_seen,
              k4_calls):
    """Q1, Q2, Q2b, Q2m and Q3 once each, checked against numpy, with the
    launch counters set to 0 before each and read after; fails unless
    each query reached the kernels of its path."""
    from clickhouse_tpu_torch.ops import _native
    from clickhouse_tpu_torch.ops.sort_ops import sort_rows_bytes
    for name, sql in QUERIES:
        k1_before = dict(k1_forms_seen)
        del k4_calls[:]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _native.reset_launches()
        rows = s.execute(sql).rows()
        per_query[name] = dict(_native.LAUNCHES)
        rows_of = {k: list(v) for k, v in _native.LAUNCH_ROWS.items()}
        extra = torch.cuda.max_memory_allocated() - base
        if rows != want[name]:
            fail(f"{name} returned {rows[:5]}..., numpy says "
                 f"{want[name][:5]}...")
        for k, v in rows_of.items():
            launches[k] += per_query[name][k]
            launch_rows[k] += v
        # the rows of this query's largest launch of each kernel
        big = {k: max(v, default=0) for k, v in rows_of.items()}
        k1_split = {f: k1_forms_seen[f] - k1_before[f] for f in k1_before}
        print(f"{name}: K1 launches {k1_split}; device memory at its peak "
              f"{extra} bytes above what was allocated before it",
              flush=True)
        if name in ("Q2b", "Q2m"):
            for kernel in ("radix_sort_pairs", "segment_bounds") + (
                    ("segment_reduce",) if name == "Q2m" else ()):
                if big[kernel] < N_ROWS:
                    fail(f"{name} did not reach {kernel} over {N_ROWS} "
                         f"rows: {per_query[name]}, largest launch "
                         f"{big[kernel]} rows")
            est = sort_rows_bytes(k4_calls[0][0], [b for _, b in k4_calls])
            print(f"{name}: K4 calls (rows, bits) {k4_calls}; sort_rows' "
                  f"working set by sort_rows_bytes {est} bytes, the "
                  f"query's peak {extra} bytes", flush=True)
            print(f"{name}: K4, K5{', K6' if name == 'Q2m' else ''} over "
                  f"{big['radix_sort_pairs']} rows; launches "
                  f"{per_query[name]}", flush=True)
        elif any(per_query[name][k] for k in ("radix_sort_pairs",
                                              "segment_bounds",
                                              "segment_reduce")):
            fail(f"{name} launched a sort kernel: {per_query[name]}")
        if name == "Q1":
            # one K1 launch over every row, and no row mask on the way (a
            # bool mask of the rows alone would take N_ROWS bytes)
            if per_query["Q1"]["masked_reduce"] != 1 \
                    or big["masked_reduce"] < N_ROWS:
                fail(f"Q1 did not reach K1 once over {N_ROWS} rows: "
                     f"{per_query['Q1']}, {rows_of['masked_reduce']}")
            if extra >= N_ROWS:
                fail(f"Q1 allocated {extra} bytes of device memory")
            print(f"Q1: one K1 launch over {big['masked_reduce']} rows; "
                  f"{extra} bytes of device memory allocated at its peak",
                  flush=True)
    for name, kernel in (("Q1", "masked_reduce"),
                         ("Q2", "dense_group_reduce"),
                         ("Q3", "topk_smallest")):
        if per_query[name][kernel] < 1:
            fail(f"{name} did not launch {kernel}: {per_query[name]}")
    print(f"Q1, Q2, Q2b, Q2m and Q3 match numpy; launches per query: "
          f"{per_query}", flush=True)


def kernel_line(card, shapes, launches, launch_rows):
    """Print the card and the kernels line, then the last line."""
    sources = {"masked_reduce": ("clickhouse_tpu_torch/csrc/masked_reduce.cu",
                                 "scratch/q1_profile.py:92"),
               "dense_group_reduce": (
                   "clickhouse_tpu_torch/csrc/dense_group_reduce.cu",
                   "clickhouse_tpu/ops/mxu_segsum.py:51"),
               "topk_smallest": ("clickhouse_tpu_torch/csrc/topk_smallest.cu",
                                 "clickhouse_tpu/ops/sort_ops.py:110"),
               "radix_sort_pairs": (
                   "clickhouse_tpu_torch/csrc/radix_sort.cu",
                   "clickhouse_tpu/ops/agg_ops.py:227"),
               "segment_bounds": (
                   "clickhouse_tpu_torch/csrc/segment_bounds.cu",
                   "clickhouse_tpu/ops/scan_ops.py:52"),
               "segment_reduce": (
                   "clickhouse_tpu_torch/csrc/segment_reduce.cu",
                   "clickhouse_tpu/ops/scan_ops.py:147")}
    kernels = []
    for name, (src, repl) in sources.items():
        r = shapes[name]
        big = sum(1 for m in launch_rows[name] if m >= N_ROWS)
        print(f"{name}: {launches[name]} launches on the main path, {big} "
              f"of them over {N_ROWS} rows", flush=True)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[name],
                        "launches_at_100M_rows": big,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": "bytes", "bytes": r["bytes"],
                        "library_ms": r["library_ms"],
                        **{k: v for k, v in r.items() if k in EXTRA_KEYS}})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
