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
           "K1Term", "K1Args", "K6_MAX_SPECS", "K6_MAX_DATA", "K6_MAX_FORMS",
           "K6_MAX_MASKS", "K6Form", "K6Spec", "K6Count", "K6Args", "K7_MAX_ENTRIES", "K7Word",
           "K7Out", "K7Args", "K8_MAX_KEYS", "K8_MAX_WORDS", "K8Args", "K9Args",
           "K11_MAX_WIDTH", "K14Args", "MAX_HASH_COLS", "HashCol",
           "K16_MAX_SLOT_KEYS", "K16SlotKey", "K16Args", "K17Args"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# kernel name -> launches since the last reset
LAUNCHES: Dict[str, int] = {"masked_reduce": 0, "dense_group_reduce": 0,
                            "topk_smallest": 0, "radix_sort_pairs": 0,
                            "segment_bounds": 0, "segment_reduce": 0,
                            "segment_reduce_sorted": 0,
                            "dense_join": 0, "hash_join": 0,
                            "expand_matches": 0, "prefix_match": 0,
                            "vector_distance": 0, "calendar_part": 0,
                            "unpack_pairs": 0, "compact_rows": 0,
                            "row_hash": 0, "hll_update": 0,
                            "hll_update_rows": 0, "hll_cells": 0,
                            "hll_merge": 0, "hll_finalize": 0,
                            "segmented_scan": 0, "segmented_search": 0}
# kernel name -> row count of each launch since the last reset
LAUNCH_ROWS: Dict[str, List[int]] = {k: [] for k in LAUNCHES}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


K1_MAX_TERMS = 4       # kMaxTerms of csrc/k1_terms.cuh


class K1Term(ctypes.Structure):
    """ChttK1Term of csrc/k1_terms.cuh (one `column CMP constant`)."""
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


class K14Args(ctypes.Structure):
    """ChttCompactArgs of csrc/compact_rows.cu (one call of K14)."""
    _fields_ = [("mask", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("count", ctypes.c_void_p), ("status", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("tiles", ctypes.c_int),
                ("mask_vec", ctypes.c_int), ("n_terms", ctypes.c_int),
                ("epoch", ctypes.c_uint), ("terms", K1Term * K1_MAX_TERMS)]


K6_MAX_SPECS = 8       # kMaxSpecs of csrc/segment_reduce.cu
K6_MAX_DATA = 4        # kMaxData
K6_MAX_FORMS = 4       # kMaxForms
K6_MAX_MASKS = 4       # kMaxMasks (and kMaxMasks + 1 counts)


class K6Form(ctypes.Structure):
    """ChttSegForm of csrc/segment_reduce.cu (what a reduction reads of a
    source column: its value, order key or double, of an optional
    intDiv/modulo term)."""
    _fields_ = [("data", ctypes.c_int), ("kind", ctypes.c_int),
                ("term", ctypes.c_int), ("uns", ctypes.c_int),
                ("c", ctypes.c_int), ("magic", ctypes.c_uint),
                ("shift1", ctypes.c_int), ("shift2", ctypes.c_int)]


class K6Spec(ctypes.Structure):
    """ChttSegSpec of csrc/segment_reduce.cu (one reduction)."""
    _fields_ = [("op", ctypes.c_int), ("form", ctypes.c_int),
                ("mask", ctypes.c_int), ("form2", ctypes.c_int),
                ("pow", ctypes.c_int), ("pad", ctypes.c_int),
                ("acc", ctypes.c_void_p)]


class K6Count(ctypes.Structure):
    """ChttSegCount of csrc/segment_reduce.cu (one masked-in row count)."""
    _fields_ = [("mask", ctypes.c_int), ("pad", ctypes.c_int),
                ("out", ctypes.c_void_p)]


class K6Args(ctypes.Structure):
    """ChttSegArgs of csrc/segment_reduce.cu (one launch of K6)."""
    _fields_ = [("perm", ctypes.c_void_p), ("gid", ctypes.c_void_p),
                ("starts", ctypes.c_void_p), ("ends", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("cap_g", ctypes.c_int),
                ("n_specs", ctypes.c_int), ("n_data", ctypes.c_int),
                ("n_forms", ctypes.c_int), ("n_masks", ctypes.c_int),
                ("n_counts", ctypes.c_int),
                ("data", ctypes.c_void_p * K6_MAX_DATA),
                ("dtype", ctypes.c_int * K6_MAX_DATA),
                ("form", K6Form * K6_MAX_FORMS),
                ("mask", ctypes.c_void_p * K6_MAX_MASKS),
                ("count", K6Count * (K6_MAX_MASKS + 1)),
                ("spec", K6Spec * K6_MAX_SPECS)]


K7_MAX_ENTRIES = 8     # kMaxOuts of csrc/dense_join.cu (and kMaxWords)


class K7Word(ctypes.Structure):
    """ChttDenseWord of csrc/dense_join.cu (one word of a table slot)."""
    _fields_ = [("src", ctypes.c_void_p), ("base", ctypes.c_uint),
                ("bytes", ctypes.c_int), ("offset", ctypes.c_int),
                ("empty", ctypes.c_uint), ("lo", ctypes.c_uint),
                ("span", ctypes.c_uint)]


class K7Out(ctypes.Structure):
    """ChttDenseOut of csrc/dense_join.cu (one output word)."""
    _fields_ = [("out", ctypes.c_void_p), ("kind", ctypes.c_int),
                ("base", ctypes.c_uint), ("bytes", ctypes.c_int),
                ("offset", ctypes.c_int)]


class K7Args(ctypes.Structure):
    """ChttDenseArgs of csrc/dense_join.cu (one call of K7)."""
    _fields_ = [("build_key", ctypes.c_void_p),
                ("build_valid", ctypes.c_void_p),
                ("n_build", ctypes.c_longlong),
                ("probe_key", ctypes.c_void_p),
                ("probe_valid", ctypes.c_void_p),
                ("n_probe", ctypes.c_longlong), ("lo", ctypes.c_longlong),
                ("R", ctypes.c_longlong), ("table", ctypes.c_void_p),
                ("matched", ctypes.c_void_p),
                ("out_of_range", ctypes.c_void_p),
                ("build_dtype", ctypes.c_int), ("probe_dtype", ctypes.c_int),
                ("slot_bytes", ctypes.c_int), ("n_words", ctypes.c_int),
                ("n_outs", ctypes.c_int), ("pad", ctypes.c_int),
                ("w", K7Word * K7_MAX_ENTRIES),
                ("o", K7Out * K7_MAX_ENTRIES)]


K8_MAX_KEYS = 8        # kMaxKeys of csrc/hash_join.cu
K8_MAX_WORDS = 4       # kMaxWords: the words of one probe launch


class K8Args(ctypes.Structure):
    """ChttHashArgs of csrc/hash_join.cu (one build or probe of K8)."""
    _fields_ = [("build", ctypes.c_void_p * K8_MAX_KEYS),
                ("probe", ctypes.c_void_p * K8_MAX_KEYS),
                ("bytes", ctypes.c_int * K8_MAX_KEYS), ("nk", ctypes.c_int),
                ("n_words", ctypes.c_int), ("build_valid", ctypes.c_void_p),
                ("probe_valid", ctypes.c_void_p),
                ("n_build", ctypes.c_longlong),
                ("n_probe", ctypes.c_longlong), ("table", ctypes.c_void_p),
                ("cap", ctypes.c_longlong), ("payload", ctypes.c_void_p),
                ("stride", ctypes.c_int), ("pad", ctypes.c_int),
                ("hash_mask", ctypes.c_ulonglong),
                ("matched", ctypes.c_void_p),
                ("src", ctypes.c_void_p * K8_MAX_WORDS),
                ("out", ctypes.c_void_p * K8_MAX_WORDS)]


class K9Args(ctypes.Structure):
    """ChttExpandArgs of csrc/expand_matches.cu (one call of K9)."""
    _fields_ = [("matched", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("seg_start", ctypes.c_void_p), ("seg_len", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("n_rows", ctypes.c_longlong),
                ("out_cap", ctypes.c_longlong), ("heavy", ctypes.c_longlong),
                ("left", ctypes.c_int), ("any_join", ctypes.c_int),
                ("vec", ctypes.c_int), ("tiles", ctypes.c_int),
                ("out_count", ctypes.c_void_p), ("status", ctypes.c_void_p),
                ("p_idx", ctypes.c_void_p), ("build_pos", ctypes.c_void_p),
                ("mask", ctypes.c_void_p)]


K11_MAX_WIDTH = 4096   # kMaxWidth of csrc/vector_distance.cu


MAX_HASH_COLS = 4      # kMaxHashCols of csrc/hash64.cuh


class HashCol(ctypes.Structure):
    """ChttHashCol of csrc/hash64.cuh (one column of a row hash: its
    storage, how its values become u64 bits, an optional intDiv/modulo
    term by the host's multiplier, and stride 0 for a constant)."""
    _fields_ = [("data", ctypes.c_void_p), ("dtype", ctypes.c_int),
                ("kind", ctypes.c_int), ("term", ctypes.c_int),
                ("c", ctypes.c_int), ("magic", ctypes.c_uint),
                ("shift1", ctypes.c_int), ("shift2", ctypes.c_int),
                ("stride", ctypes.c_int)]


K16_MAX_SLOT_KEYS = 4  # kMaxSlotKeys of csrc/hll.cu


class K16SlotKey(ctypes.Structure):
    """ChttSlotKey of csrc/hll.cu (one GROUP BY key of K16's row-order
    update: its int32 values, proven least value, span and slot
    multiplier)."""
    _fields_ = [("data", ctypes.c_void_p), ("lo", ctypes.c_longlong),
                ("span", ctypes.c_longlong), ("mult", ctypes.c_longlong),
                ("stride", ctypes.c_int), ("pad", ctypes.c_int)]


class K16Args(ctypes.Structure):
    """ChttHllArgs of csrc/hll.cu (one update of K16)."""
    _fields_ = [("cols", HashCol * MAX_HASH_COLS),
                ("n_cols", ctypes.c_int), ("log2m", ctypes.c_int),
                ("n", ctypes.c_longlong), ("cap_g", ctypes.c_longlong),
                ("perm", ctypes.c_void_p),
                ("gid", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("state", ctypes.c_void_p),
                ("keys", K16SlotKey * K16_MAX_SLOT_KEYS),
                ("n_keys", ctypes.c_int), ("pad", ctypes.c_int),
                ("slots", ctypes.c_longlong), ("cells", ctypes.c_void_p)]


class K17Args(ctypes.Structure):
    """ChttScanArgs of csrc/segmented_scan.cu (one scan of K17)."""
    _fields_ = [("data", ctypes.c_void_p), ("boundary", ctypes.c_void_p),
                ("mask", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("states", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("ident", ctypes.c_ulonglong), ("op", ctypes.c_int),
                ("acc", ctypes.c_int), ("dtype", ctypes.c_int),
                ("out_dtype", ctypes.c_int), ("reverse", ctypes.c_int),
                ("sms", ctypes.c_int)]


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
                                                  P, P, LL, P]
            lib.chtt_radix_sort_pairs.restype = I
            lib.chtt_radix_tile_rows.argtypes = [I]
            lib.chtt_radix_tile_rows.restype = I
            lib.chtt_segment_bounds.argtypes = [P, P, I, LL, P, I, P, P, P,
                                                P, P, LL, P]
            lib.chtt_segment_bounds.restype = I
            lib.chtt_segment_tile_rows.argtypes = []
            lib.chtt_segment_tile_rows.restype = I
            lib.chtt_segment_reduce.argtypes = [P, P]
            lib.chtt_segment_reduce.restype = I
            lib.chtt_dense_join.argtypes = [P, P]
            lib.chtt_dense_join.restype = I
            lib.chtt_hash_build.argtypes = [P, P]
            lib.chtt_hash_build.restype = I
            lib.chtt_hash_probe.argtypes = [P, P]
            lib.chtt_hash_probe.restype = I
            lib.chtt_expand_matches.argtypes = [P, P]
            lib.chtt_expand_matches.restype = I
            lib.chtt_expand_tile_rows.argtypes = []
            lib.chtt_expand_tile_rows.restype = I
            lib.chtt_expand_spill_slots.argtypes = []
            lib.chtt_expand_spill_slots.restype = I
            lib.chtt_prefix_match.argtypes = [P, P, I, LL, P, I, I, I, P, I,
                                              P]
            lib.chtt_prefix_match.restype = I
            lib.chtt_vector_distance.argtypes = [P, P, P, LL, LL, I, I, P,
                                                 I, P]
            lib.chtt_vector_distance.restype = I
            lib.chtt_calendar_part.argtypes = [P, I, P]
            lib.chtt_calendar_part.restype = I
            lib.chtt_unpack_pairs.argtypes = [P, LL, I, I, LL, I, P, I, P]
            lib.chtt_unpack_pairs.restype = I
            lib.chtt_compact_rows.argtypes = [P, P]
            lib.chtt_compact_rows.restype = I
            lib.chtt_compact_tile_rows.argtypes = []
            lib.chtt_compact_tile_rows.restype = I
            lib.chtt_compact_scratch_words.argtypes = []
            lib.chtt_compact_scratch_words.restype = I
            lib.chtt_row_hash.argtypes = [P, I, LL, P, I, P]
            lib.chtt_row_hash.restype = I
            lib.chtt_hll_update.argtypes = [P, I, P]
            lib.chtt_hll_update.restype = I
            lib.chtt_hll_rows_per_sm.argtypes = [P]
            lib.chtt_hll_rows_per_sm.restype = I
            lib.chtt_hll_split.argtypes = [P, I, I, P]
            lib.chtt_hll_split.restype = I
            lib.chtt_hll_cells.argtypes = [P, LL, I, P, LL, P, P]
            lib.chtt_hll_cells.restype = I
            lib.chtt_hll_merge.argtypes = [P, P, P, P, P, LL, LL, I, P, I,
                                           P]
            lib.chtt_hll_merge.restype = I
            lib.chtt_hll_finalize.argtypes = [P, LL, I, P, I, P]
            lib.chtt_hll_finalize.restype = I
            lib.chtt_segmented_scan.argtypes = [P, P]
            lib.chtt_segmented_scan.restype = I
            lib.chtt_segmented_scan_split.argtypes = [P, I, P]
            lib.chtt_segmented_scan_split.restype = I
            lib.chtt_scan_chunks.argtypes = [LL, I]
            lib.chtt_scan_chunks.restype = LL
            lib.chtt_scan_tile_rows.argtypes = []
            lib.chtt_scan_tile_rows.restype = I
            lib.chtt_segmented_search.argtypes = [P, LL, P, LL, P, P, P, LL,
                                                  I, I, P, P, P]
            lib.chtt_segmented_search.restype = I
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
