"""Build, load and call the engine's CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a`` into ONE shared library
with a plain C interface, loaded with ctypes.  The build runs at the first
launch, into ``clickhouse_tpu_torch/_build/`` (named by a digest of the
sources and flags, so an edited source builds anew); nothing is compiled
or loaded when a module is imported.

Every pointer and the stream go to C as ``c_void_p``; kernels run on
PyTorch's current stream and allocate nothing: the wrappers in ``ops/``
allocate outputs and scratch with torch.  Each C entry point returns
``cudaGetLastError()`` and :func:`check` raises on a non-zero code.

Each wrapper adds one to its entry in :data:`LAUNCHES` when it launches its
kernel, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

__all__ = ["LAUNCHES", "KernelBuildError", "build", "library", "check",
           "reset_launches", "stream_ptr", "dtype_code", "grid_blocks"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# kernel name -> launches since the last reset
LAUNCHES: Dict[str, int] = {"masked_reduce": 0, "dense_group_reduce": 0,
                            "topk_smallest": 0}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources (message holds its stderr)."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found under {home}/bin or on PATH; set CUDA_HOME")
    return found


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def build() -> Path:
    """Compile csrc/*.cu into _build/libchtt_<digest>.so (once)."""
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libchtt_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
           *[str(p) for p in cus]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc exited {proc.returncode}: {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.chtt_masked_reduce.argtypes = [P, I, P, LL, I, I, P, P, P,
                                               I, P]
            lib.chtt_masked_reduce.restype = I
            lib.chtt_dense_group_reduce.argtypes = [P, I, P, LL, I, I, P, I,
                                                    P, P, P, P, P, I, P]
            lib.chtt_dense_group_reduce.restype = I
            lib.chtt_topk_smallest.argtypes = [P, P, LL, I, I, I, P, P, P,
                                               P]
            lib.chtt_topk_smallest.restype = I
            lib.chtt_error_string.argtypes = [I]
            lib.chtt_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().chtt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    """Element-type number of csrc/common.cuh (ChttDtype)."""
    import torch
    codes = {torch.bool: 0, torch.int8: 1, torch.uint8: 2, torch.int16: 3,
             torch.int32: 4, torch.int64: 5, torch.float32: 6,
             torch.float64: 7}
    if dtype not in codes:
        raise TypeError(f"no kernel element type for {dtype}")
    return codes[dtype]


def grid_blocks(device, n: int, threads: int = 256, per_sm: int = 8) -> int:
    """Blocks of a grid-stride launch: enough to fill the card, at most
    one per `threads` rows."""
    import torch
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(sms * per_sm, (n + threads - 1) // threads))
