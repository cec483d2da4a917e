"""Build, load and call the engine's CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a`` into ONE shared library
with a plain C interface, loaded with ctypes: one ``nvcc`` a source, all
started together, then one link.  The build runs at the first launch, into
``clickhouse_tpu_torch/_build/`` (named by a digest of the sources and
flags, so an edited source builds anew); nothing is compiled or loaded when
a module is imported.

Every pointer and the stream go to C as ``c_void_p``; kernels run on
PyTorch's current stream and allocate nothing: the wrappers in ``ops/``
allocate outputs and scratch with torch.  Each C entry point returns
``cudaGetLastError()`` and :func:`check` raises on a non-zero code.

Each wrapper calls :func:`count_launch` where it launches its kernel: that
adds one to the kernel's entry in :data:`LAUNCHES` and records the launch's
row count in :data:`LAUNCH_ROWS`, so a run can show that its path went
through the kernels, and at which sizes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["LAUNCHES", "LAUNCH_ROWS", "KernelBuildError", "build", "library",
           "check", "count_launch", "reset_launches", "stream_ptr",
           "dtype_code", "grid_blocks", "aligned16", "K1_MAX_TERMS",
           "K1Term", "K1Args"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# kernel name -> launches since the last reset
LAUNCHES: Dict[str, int] = {"masked_reduce": 0, "dense_group_reduce": 0,
                            "topk_smallest": 0, "radix_sort_pairs": 0,
                            "segment_bounds": 0, "segment_reduce": 0}
# kernel name -> row count of each launch since the last reset
LAUNCH_ROWS: Dict[str, List[int]] = {k: [] for k in LAUNCHES}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


K1_MAX_TERMS = 4       # kMaxTerms of csrc/masked_reduce.cu


class K1Term(ctypes.Structure):
    """ChttK1Term of csrc/masked_reduce.cu (one `column CMP constant`)."""
    _fields_ = [("col", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("lo", ctypes.c_ulonglong), ("span", ctypes.c_ulonglong),
                ("xorv", ctypes.c_ulonglong), ("dtype", ctypes.c_int),
                ("mode", ctypes.c_int), ("neg", ctypes.c_int),
                ("nan_pass", ctypes.c_int), ("u64src", ctypes.c_int),
                ("vec", ctypes.c_int), ("valid_vec", ctypes.c_int),
                ("pad", ctypes.c_int)]


class K1Args(ctypes.Structure):
    """ChttK1Args of csrc/masked_reduce.cu (one call of K1)."""
    _fields_ = [("data", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("partials", ctypes.c_void_p),
                ("ticket", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("head", ctypes.c_longlong), ("dtype", ctypes.c_int),
                ("data_vec", ctypes.c_int), ("mask_vec", ctypes.c_int),
                ("uns", ctypes.c_int), ("n_terms", ctypes.c_int),
                ("pad", ctypes.c_int), ("terms", K1Term * K1_MAX_TERMS)]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources (message holds its stderr)."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_ROWS[k].clear()


def count_launch(name: str, rows: int) -> None:
    LAUNCHES[name] += 1
    LAUNCH_ROWS[name].append(int(rows))


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
    objs = BUILD_DIR / f"{out.stem}.{os.getpid()}.obj"
    objs.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for p in cus:
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o",
               str(objs / f"{p.stem}.o"), str(p)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc exited {proc.returncode}: {' '.join(cmd)}"
                          f"\n{err}")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *[str(objs / f"{p.stem}.o") for p in cus]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"nvcc exited {proc.returncode}: {' '.join(cmd)}"
                          f"\n{proc.stderr}")
    shutil.rmtree(objs, ignore_errors=True)
    if failed:
        raise KernelBuildError("\n".join(failed))
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.chtt_masked_reduce.argtypes = [P, I, I, P]
            lib.chtt_masked_reduce.restype = I
            lib.chtt_dense_group_reduce.argtypes = [P, I, P, LL, I, I, P, I,
                                                    P, P, P, P, P, I, P]
            lib.chtt_dense_group_reduce.restype = I
            lib.chtt_topk_smallest.argtypes = [P, I, P, LL, I, I, P, P, P]
            lib.chtt_topk_smallest.restype = I
            lib.chtt_topk_blocks.argtypes = [I, LL, I]
            lib.chtt_topk_blocks.restype = I
            lib.chtt_topk_scratch_bytes.argtypes = [I, I, I]
            lib.chtt_topk_scratch_bytes.restype = LL
            lib.chtt_radix_sort_pairs.argtypes = [P, I, P, LL, I, I, P, P, P,
                                                  P, P, P, P]
            lib.chtt_radix_sort_pairs.restype = I
            lib.chtt_radix_tile_rows.argtypes = [I]
            lib.chtt_radix_tile_rows.restype = I
            lib.chtt_segment_bounds.argtypes = [P, P, I, LL, P, I, P, P, P,
                                                P, P, I, P]
            lib.chtt_segment_bounds.restype = I
            lib.chtt_segment_tile_rows.argtypes = []
            lib.chtt_segment_tile_rows.restype = I
            lib.chtt_segment_reduce.argtypes = [I, P, I, I, P, P, P, LL, I, P,
                                                P, P]
            lib.chtt_segment_reduce.restype = I
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


def aligned16(t):
    """t itself if it starts on a 16-byte boundary (the kernels' vector
    loads need it), else an aligned copy; None stays None."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()
