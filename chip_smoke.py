"""Quickest proof that the CUDA engine (clickhouse_tpu_torch) runs on a GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card, nvcc and PyTorch built for CUDA; exits
non-zero without them.  Phases, each of which fails the run:

  1. build the three hand-written kernels (csrc/*.cu) with nvcc for sm_90a;
  2. hold each kernel against its plain PyTorch version on the card: edge
     cases, then the shapes the main path gives it at 100M rows (integer
     results must agree exactly, float sums within rtol 1e-12);
  3. drive the main path through the public API: connect(device="cuda"),
     CREATE TABLE hits (x Int64), insert_pydict 100M rows of
     (arange * 2654435761) % 1_000_003, then Q1, Q2 and Q3 (the SQL of
     bench.py), each checked against a numpy answer, with the kernels'
     launch counters reset before and read after to show the queries went
     through K1, K2 and K3;
  4. time each kernel against its plain version (CUDA events) and each
     query (median wall time of a few runs, synchronised).

The second-to-last line is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}.
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
QUERY_REPS = 5
KERNEL_REPS = 20
FLOAT_RTOL = 1e-12      # the kernel adds float partials in another order


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
    """Mean device milliseconds of fn() over reps launches (after one warm
    run), timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
    print(f"K1 masked_reduce edge cases: {len(cases)} agree", flush=True)


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
    print("K2 dense_group_reduce edge cases: S in (1, 1000, 16384) agree",
          flush=True)


def check_k3(dev):
    from clickhouse_tpu_torch.ops.sort_ops import (_topk_smallest_plain,
                                                   topk_smallest)
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
    print("K3 topk_smallest edge cases: ties, invalid rows, k > n agree",
          flush=True)


def q_shapes(dev, x_dev):
    """Each kernel at the shape the main path gives it at 100M rows, held
    against its plain version; -> {name: (max_abs_err, ms, plain_ms)}."""
    from clickhouse_tpu_torch.ops.agg_ops import (_masked_reduce_plain,
                                                  masked_reduce)
    from clickhouse_tpu_torch.ops.mxu_segsum import (
        _dense_group_reduce_plain, dense_group_reduce)
    from clickhouse_tpu_torch.ops.sort_ops import (_topk_smallest_plain,
                                                   topk_smallest)
    out = {}
    # Q1: count() = K1 sum over the filter's bool row mask
    mask = x_dev > 500000
    err = max_abs_err(masked_reduce("sum", mask),
                      _masked_reduce_plain("sum", mask, None))
    out["masked_reduce"] = (
        err, cuda_ms(lambda: masked_reduce("sum", mask)),
        cuda_ms(lambda: _masked_reduce_plain("sum", mask, None)))
    # Q2: dense slot of x % 1024, group counts + count() + sum(x)
    ids = torch.remainder(x_dev, 1024).to(torch.int32)
    k2 = (ids, None, [None, None], [x_dev], [None], 1024)
    got, want = dense_group_reduce(*k2), _dense_group_reduce_plain(*k2)
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    out["dense_group_reduce"] = (
        err, cuda_ms(lambda: dense_group_reduce(*k2)),
        cuda_ms(lambda: _dense_group_reduce_plain(*k2)))
    # Q3: the u32 key of ORDER BY x LIMIT 100 (rows all valid)
    key = (x_dev - int(x_dev.min())) & 0xFFFFFFFF
    err = max_abs_err(topk_smallest(key, None, 100),
                      _topk_smallest_plain(key, None, 100))
    out["topk_smallest"] = (
        err, cuda_ms(lambda: topk_smallest(key, None, 100), reps=5),
        cuda_ms(lambda: _topk_smallest_plain(key, None, 100), reps=5))
    for name, (e, ms, pms) in out.items():
        print(f"{name} at the main path's 100M-row shape: max_abs_err {e}, "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
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

    check_k1(dev)
    check_k2(dev)
    check_k3(dev)

    x = (np.arange(N_ROWS, dtype=np.int64) * 2654435761) % 1_000_003
    want = expected_answers(x)
    s = ch.connect(device="cuda")
    s.execute("CREATE TABLE hits (x Int64)")
    t0 = time.perf_counter()
    s.insert_pydict("hits", {"x": x})
    s.catalog.get_table("default", "hits").read_block()
    torch.cuda.synchronize()
    print(f"insert + device block of {N_ROWS} rows: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the main path, once, through the public API
    _native.reset_launches()
    per_query = {}
    for name, sql in (("Q1", Q1), ("Q2", Q2), ("Q3", Q3)):
        before = dict(_native.LAUNCHES)
        rows = s.execute(sql).rows()
        if rows != want[name]:
            fail(f"{name} returned {rows[:5]}..., numpy says "
                 f"{want[name][:5]}...")
        per_query[name] = {k: _native.LAUNCHES[k] - before[k]
                           for k in before}
    launches = dict(_native.LAUNCHES)
    for name, kernel in (("Q1", "masked_reduce"),
                         ("Q2", "dense_group_reduce"),
                         ("Q3", "topk_smallest")):
        if per_query[name][kernel] < 1:
            fail(f"{name} did not launch {kernel}: {per_query[name]}")
    print(f"Q1-Q3 match numpy; launches per query: {per_query}",
          flush=True)

    for name, sql in (("Q1", Q1), ("Q2", Q2), ("Q3", Q3)):
        times = []
        for _ in range(QUERY_REPS):
            t0 = time.perf_counter()
            s.execute(sql)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"{name} median wall {statistics.median(times) * 1e3:.3f} ms "
              f"over {QUERY_REPS} runs ({N_ROWS} rows): {sql}", flush=True)

    blk = s.catalog.get_table("default", "hits").read_block()
    x_dev = blk["x"].data[:N_ROWS].to(torch.int64)
    shapes = q_shapes(dev, x_dev)

    sources = {"masked_reduce": ("clickhouse_tpu_torch/csrc/masked_reduce.cu",
                                 "scratch/q1_profile.py:92"),
               "dense_group_reduce": (
                   "clickhouse_tpu_torch/csrc/dense_group_reduce.cu",
                   "clickhouse_tpu/ops/mxu_segsum.py:51"),
               "topk_smallest": ("clickhouse_tpu_torch/csrc/topk_smallest.cu",
                                 "clickhouse_tpu/ops/sort_ops.py:110")}
    kernels = []
    for name, (src, repl) in sources.items():
        err, ms, pms = shapes[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
