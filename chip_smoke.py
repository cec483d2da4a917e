"""Quickest proof that the CUDA engine (clickhouse_tpu_torch) runs on a GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k2-wide   # only K2 at S = 16,384 (see k2_wide)
    python3 chip_smoke.py --queries   # only Q1-Q3 times (see time_queries)

Needs one NVIDIA Hopper card, nvcc and PyTorch built for CUDA; exits
non-zero without them.  Phases, each of which fails the run:

  1. build the three hand-written kernels (csrc/*.cu) with nvcc for sm_90a,
     one nvcc a source, all started together;
  2. hold each kernel against its plain PyTorch version on the card: edge
     cases (K1 with and without filter terms over every storage type and
     comparison, constants outside the storage range, NaN, NULLs, row
     bounds off the 16-row grid and misaligned views; K2 with skewed slots;
     both K3 entries with ties, extreme keys, invalid rows, monotone keys
     and ties across blocks); integer results must agree exactly, float
     sums within rtol 1e-12;
  3. drive the main path through the public API: connect(device="cuda"),
     CREATE TABLE hits (x Int64), insert_pydict 100M rows of
     (arange * 2654435761) % 1_000_003, then Q1, Q2 and Q3 (the SQL of
     bench.py), each checked against a numpy answer, with the kernels'
     launch counters reset before and read after to show the queries went
     through K1, K2 and K3; Q1 must reach K1 once at 100M rows with its
     filter as a term (read in x's int32 storage) and allocate no row mask;
  4. replay each kernel on the exact inputs the main path gave it (its
     largest launch in Q1-Q3), held against its plain version, and time
     it, its plain version and, where one exists, the single PyTorch call
     computing the same function (CUDA events, L2 flushed, device time);
     print bytes and bound_ms (bytes / 3.35 TB/s) for each, K1 also over a
     bool mask of 100M rows (and the kernels of one call from a
     torch.profiler trace), K2 on skewed slots at 100M rows and at
     S = 16,384, and K3's level 1 and merge apart (torch.profiler); time
     each query (median wall time of 20 runs, synchronised) and Q1's
     device-busy time (torch.profiler).

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
              "mask_form_bound_ms", "kernels_per_call")
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


def main_path_args(session):
    """Run Q1-Q3 once more with each kernel's launch wrapper spied on, and
    return the arguments of each kernel's largest launch: the exact inputs
    the main path hands it."""
    from clickhouse_tpu_torch.ops import agg_ops, mxu_segsum, sort_ops
    # kernel -> (module, wrapper, rows of a launch from its arguments)
    spied = {"masked_reduce": (agg_ops, "_masked_reduce_cuda",
                               lambda a: a[4]),
             "dense_group_reduce": (mxu_segsum, "_dense_group_reduce_cuda",
                                    lambda a: a[0].shape[0]),
             "topk_smallest": (sort_ops, "_topk_cuda",
                               lambda a: a[0].shape[0])}
    got, saved = {}, {}
    for name, (mod, attr, rows_of) in spied.items():
        fn = saved[name] = getattr(mod, attr)

        def spy(*args, _fn=fn, _name=name, _rows_of=rows_of):
            rows = _rows_of(args)
            if _name not in got or rows > got[_name][1]:
                got[_name] = (args, rows)
            return _fn(*args)
        setattr(mod, attr, spy)
    try:
        for sql in (Q1, Q2, Q3):
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


def k1_forms(dev, args):
    """K1 at Q1's inputs (its filter as a term over x's int32 storage, the
    row bound, no mask) and over a bool mask of the same rows (the form
    K1 took before it read filter terms; a mask of x > c made here), each
    held against its plain version and timed beside it.  -> record of the
    kernels line."""
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
    # the mask form: a bool mask of every row of the column
    m = x > c
    mb = m.numel() + 8
    max_abs_err(masked_reduce("sum", None, m),
                _masked_reduce_plain("sum", None, m))
    rec.update(
        mask_form_ms=cuda_ms(lambda: masked_reduce("sum", None, m)),
        mask_form_plain_ms=cuda_ms(
            lambda: _masked_reduce_plain("sum", None, m)),
        mask_form_library_ms=cuda_ms(lambda: torch.sum(m)),
        mask_form_bytes=mb, mask_form_bound_ms=bound_ms(mb))
    print(f"masked_reduce, mask form (count over bool{tuple(m.shape)}): "
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
    # Q1: count() with the filter `x > 500000` as a K1 term
    out["masked_reduce"] = k1_forms(dev, args["masked_reduce"])
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
    return {"Q1": q1, "Q2": q2, "Q3": q3}


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
    """(device-busy ms, device operations, wall ms) per run of sql, from a
    torch.profiler trace of `reps` runs (busy: the union of the intervals
    of the device's kernels, copies and fills; the wall is the traced
    one)."""
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
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / reps / 1e3, len(spans) / reps, wall / reps * 1e3


def time_queries(s):
    """Median wall of QUERY_REPS runs of each query (after one untimed run),
    then Q1's device-busy time from a trace.  Uses only the public API, so
    copied into an unpacked older checkout (``--queries``) it times that
    tree alike."""
    for name, sql in (("Q1", Q1), ("Q2", Q2), ("Q3", Q3)):
        s.execute(sql)
        times = []
        for _ in range(QUERY_REPS):
            t0 = time.perf_counter()
            s.execute(sql)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"{name} median wall {statistics.median(times) * 1e3:.3f} ms "
              f"over {QUERY_REPS} runs ({N_ROWS} rows): {sql}", flush=True)
    busy, ops, wall = device_busy(s, Q1)
    print(f"Q1 under torch.profiler: device busy {busy:.4f} ms of "
          f"{wall:.3f} ms wall a run, {ops:g} device operations a run",
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

    s, x = load_hits(ch)
    want = expected_answers(x)

    # the main path, once, through the public API
    _native.reset_launches()
    per_query = {}
    for name, sql in (("Q1", Q1), ("Q2", Q2), ("Q3", Q3)):
        before = dict(_native.LAUNCHES)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rows = s.execute(sql).rows()
        extra = torch.cuda.max_memory_allocated() - base
        if rows != want[name]:
            fail(f"{name} returned {rows[:5]}..., numpy says "
                 f"{want[name][:5]}...")
        per_query[name] = {k: _native.LAUNCHES[k] - before[k]
                           for k in before}
        if name == "Q1":
            # one K1 launch over every row, and no row mask on the way (a
            # bool mask of the rows alone would take N_ROWS bytes)
            if per_query["Q1"]["masked_reduce"] != 1 \
                    or _native.LAUNCH_ROWS["masked_reduce"][-1] < N_ROWS:
                fail(f"Q1 did not reach K1 once over {N_ROWS} rows: "
                     f"{per_query['Q1']}, "
                     f"{_native.LAUNCH_ROWS['masked_reduce']}")
            if extra >= N_ROWS:
                fail(f"Q1 allocated {extra} bytes of device memory")
            print(f"Q1: one K1 launch over "
                  f"{_native.LAUNCH_ROWS['masked_reduce'][-1]} rows; "
                  f"{extra} bytes of device memory allocated at its peak",
                  flush=True)
    launches = dict(_native.LAUNCHES)
    launch_rows = {k: list(v) for k, v in _native.LAUNCH_ROWS.items()}
    for name, kernel in (("Q1", "masked_reduce"),
                         ("Q2", "dense_group_reduce"),
                         ("Q3", "topk_smallest")):
        if per_query[name][kernel] < 1:
            fail(f"{name} did not launch {kernel}: {per_query[name]}")
    print(f"Q1-Q3 match numpy; launches per query: {per_query}",
          flush=True)
    time_queries(s)

    shapes = q_shapes(dev, main_path_args(s))

    sources = {"masked_reduce": ("clickhouse_tpu_torch/csrc/masked_reduce.cu",
                                 "scratch/q1_profile.py:92"),
               "dense_group_reduce": (
                   "clickhouse_tpu_torch/csrc/dense_group_reduce.cu",
                   "clickhouse_tpu/ops/mxu_segsum.py:51"),
               "topk_smallest": ("clickhouse_tpu_torch/csrc/topk_smallest.cu",
                                 "clickhouse_tpu/ops/sort_ops.py:110")}
    kernels = []
    for name, (src, repl) in sources.items():
        r = shapes[name]
        big = sum(1 for m in launch_rows[name] if m >= N_ROWS)
        print(f"{name}: {launches[name]} launches in Q1-Q3, {big} of them "
              f"over {N_ROWS} rows", flush=True)
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
