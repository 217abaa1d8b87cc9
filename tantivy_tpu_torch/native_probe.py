"""ctypes bindings for the native probe-plan helpers (`native/probe_plan.cc`).

`group_work_sorted` is the single-pass C++ version of the launch assembler's
group collapse (`ops/fused_bool._group_work`) for the planner's natural
item order; the caller falls back to the numpy path when the library is
unavailable or the C++ pass detects an unsorted key (returns -1).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_build_failed = False

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
_SRC = os.path.join(_ROOT, "native", "probe_plan.cc")
#: built beside the port's kernels, never into `native/`, where another
#: build of the same source may write its own library
_OUT = os.path.join(_ROOT, "build", "native", "libprobe_plan.so")

_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if os.environ.get("TANTIVY_TPU_NO_NATIVE"):
            _build_failed = True
            return None
        try:
            if not os.path.exists(_OUT) or (
                os.path.getmtime(_OUT) < os.path.getmtime(_SRC)
            ):
                os.makedirs(os.path.dirname(_OUT), exist_ok=True)
                tmp = f"{_OUT}.{os.getpid()}.tmp"
                subprocess.run(
                    [
                        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        _SRC, "-o", tmp,
                    ],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _OUT)
            lib = ctypes.CDLL(_OUT)
        except Exception:
            _build_failed = True
            return None
        lib.group_work_sorted.restype = ctypes.c_int64
        lib.group_work_sorted.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            _I64P, _I32P, _I32P, _I32P, _I32P,  # blocks, prow, cl, qid, seg
            _I32P, _I32P, _I32P, _U8P,          # jlo, wid, frc, groupable
            _I64P, _I64P,                       # g_base, g_mask
            _I32P, _I32P, _I32P, _I32P,         # g_prow, g_cl, g_qid, g_seg
            _I32P, _I32P, _I32P,                # g_jlo, g_pk, g_eff
        ]
        _lib = lib
        return _lib


def group_work_sorted(blocks, prow, clause, qid, seg, jlo, wid, frc,
                      groupable, kw_max: int):
    """C++ single-pass group collapse. Returns the 9-tuple of
    `_group_work` outputs, or None to signal the numpy fallback."""
    lib = _load()
    if lib is None:
        return None
    n = len(blocks)
    T = int(jlo.shape[1]) if jlo.ndim == 2 else 0
    if n == 0 or T == 0 or T > 32:
        return None
    blocks = np.ascontiguousarray(blocks, dtype=np.int64)
    prow = np.ascontiguousarray(prow, dtype=np.int32)
    clause = np.ascontiguousarray(clause, dtype=np.int32)
    qid = np.ascontiguousarray(qid, dtype=np.int32)
    seg = np.ascontiguousarray(seg, dtype=np.int32)
    jlo = np.ascontiguousarray(jlo, dtype=np.int32)
    wid = np.ascontiguousarray(wid, dtype=np.int32)
    frc = np.ascontiguousarray(frc, dtype=np.int32)
    groupable = np.ascontiguousarray(groupable, dtype=np.uint8)
    g_base = np.empty(n, dtype=np.int64)
    g_mask = np.empty(n, dtype=np.int64)
    g_prow = np.empty(n, dtype=np.int32)
    g_cl = np.empty(n, dtype=np.int32)
    g_qid = np.empty(n, dtype=np.int32)
    g_seg = np.empty(n, dtype=np.int32)
    g_jlo = np.empty((n, T), dtype=np.int32)
    g_pk = np.empty((n, T, 8), dtype=np.int32)
    g_eff = np.empty(n, dtype=np.int32)
    ng = lib.group_work_sorted(
        n, T, int(kw_max), blocks, prow, clause, qid, seg,
        jlo.reshape(-1), wid.reshape(-1), frc.reshape(-1), groupable,
        g_base, g_mask, g_prow, g_cl, g_qid, g_seg,
        g_jlo.reshape(-1), g_pk.reshape(-1), g_eff,
    )
    if ng < 0:
        return None  # unsorted groupable keys: numpy argsort path
    return (
        g_base[:ng], g_mask[:ng], g_prow[:ng], g_cl[:ng], g_qid[:ng],
        g_seg[:ng], g_jlo[:ng], g_pk[:ng], g_eff[:ng],
    )
