"""ctypes bindings for the native C++ indexing core (`native/indexer_core.cc`).

Builds the shared library on first use (g++ available per environment);
falls back cleanly to the pure-Python path when compilation fails. The core
only handles ASCII text with the "default" analyzer — exactly where the hot
loop lives — everything else stays in Python, and the two streams merge at
serialization.
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
_SRC = os.path.join(_ROOT, "native", "indexer_core.cc")
#: built beside the port's kernels, never into `native/`, where another
#: build of the same source may write its own library
_OUT = os.path.join(_ROOT, "build", "native", "libindexer_core.so")


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
        lib.indexer_new.restype = ctypes.c_void_p
        lib.indexer_free.argtypes = [ctypes.c_void_p]
        lib.indexer_index_text.restype = ctypes.c_uint32
        lib.indexer_index_text.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_int64,
        ]
        lib.indexer_index_text_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.indexer_subscribe.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.indexer_prepare_export.restype = ctypes.c_int
        lib.indexer_prepare_export.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32,
        ] + [ctypes.POINTER(ctypes.c_int64)] * 5
        lib.indexer_export.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.indexer_clear.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeIndexerCore:
    """One per SegmentWriter. None-safe: construct via `create()`."""

    @classmethod
    def create(cls) -> "NativeIndexerCore | None":
        lib = _load()
        if lib is None:
            return None
        return cls(lib)

    def __init__(self, lib):
        self._lib = lib
        self._h = lib.indexer_new()

    def __del__(self):
        try:
            self._lib.indexer_free(self._h)
        except Exception:
            pass

    def index_text(self, field_id: int, doc_id: int, text: bytes,
                   with_positions: bool, pos_offset: int,
                   remove_long_limit: int = 40) -> int:
        """Returns number of positions consumed (== tokens seen)."""
        return self._lib.indexer_index_text(
            self._h, field_id, doc_id, text, len(text),
            1 if with_positions else 0, pos_offset, remove_long_limit,
        )

    def index_text_batch(self, field_id: int, doc_ids: np.ndarray,
                         prevs: np.ndarray, texts: list[bytes],
                         with_positions: bool,
                         remove_long_limit: int = 40) -> np.ndarray:
        """One GIL-releasing call tokenizes many docs' texts for one field;
        returns each entry's kept-token count."""
        n = len(texts)
        buf = b"".join(texts)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(t) for t in texts], out=offsets[1:])
        doc_ids = np.ascontiguousarray(doc_ids, dtype=np.uint32)
        prevs = np.ascontiguousarray(prevs, dtype=np.uint32)
        kept = np.zeros(n, dtype=np.uint32)

        def ptr(arr, typ):
            return arr.ctypes.data_as(ctypes.POINTER(typ))

        self._lib.indexer_index_text_batch(
            self._h, field_id,
            ptr(doc_ids, ctypes.c_uint32), ptr(prevs, ctypes.c_uint32),
            buf, ptr(offsets, ctypes.c_int64), n,
            1 if with_positions else 0, remove_long_limit,
            ptr(kept, ctypes.c_uint32),
        )
        return kept

    def subscribe(self, field_id: int, doc_id: int, term_bytes: bytes) -> None:
        self._lib.indexer_subscribe(self._h, field_id, doc_id, term_bytes,
                                    len(term_bytes))

    def export_field(self, field_id: int):
        """Returns None or dict with sorted terms + postings arrays."""
        vals = [ctypes.c_int64() for _ in range(5)]
        ok = self._lib.indexer_prepare_export(
            self._h, field_id, *[ctypes.byref(v) for v in vals]
        )
        if not ok:
            return None
        n_terms, tb_len, n_post, n_pos, total_tokens = (v.value for v in vals)
        term_data = np.zeros(max(tb_len, 1), dtype=np.uint8)
        term_offsets = np.zeros(n_terms + 1, dtype=np.int64)
        post_offsets = np.zeros(n_terms + 1, dtype=np.int64)
        docs = np.zeros(max(n_post, 1), dtype=np.uint32)
        tfs = np.zeros(max(n_post, 1), dtype=np.uint32)
        positions = np.zeros(max(n_pos, 1), dtype=np.uint32)

        def ptr(arr, typ):
            return arr.ctypes.data_as(ctypes.POINTER(typ))

        self._lib.indexer_export(
            self._h, field_id,
            ptr(term_data, ctypes.c_uint8),
            ptr(term_offsets, ctypes.c_int64),
            ptr(post_offsets, ctypes.c_int64),
            ptr(docs, ctypes.c_uint32),
            ptr(tfs, ctypes.c_uint32),
            ptr(positions, ctypes.c_uint32),
        )
        return {
            "n_terms": n_terms,
            "term_data": term_data[:tb_len],
            "term_offsets": term_offsets,
            "post_offsets": post_offsets,
            "docs": docs[:n_post],
            "tfs": tfs[:n_post],
            "positions": positions[:n_pos],
            "total_tokens": total_tokens,
        }
