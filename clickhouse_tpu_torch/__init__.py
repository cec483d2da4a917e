"""clickhouse_tpu_torch — the query engine on PyTorch and CUDA.

A port of ``clickhouse_tpu`` (the JAX engine, kept as the reference) to one
NVIDIA Hopper GPU.  Same public surface:

    import clickhouse_tpu_torch as ch
    s = ch.connect()                      # device="cuda"
    s.execute("CREATE TABLE t (x Int64)")
    s.insert_pydict("t", {"x": values})
    print(s.execute("SELECT count() FROM t WHERE x > 5"))

Plain tensor code is PyTorch; the device primitives of the reference's
main path are hand-written CUDA kernels (see ``ops/``).  This package never
imports JAX.
"""
__version__ = "0.1.0"

from .core import dtypes, Block, Column, Settings


def connect(device="cuda", **kwargs):
    """Create an in-process session on `device` ("cuda" by default; the
    CPU runs the kernels' plain versions and must be asked for)."""
    from .exec.session import Session
    return Session(device=device, **kwargs)
