"""SegmentReader — open all per-segment readers (reference
`src/index/segment_reader.rs:33,144-221` + `inverted_index_reader.rs:30`).

Host side holds numpy arrays; `ops.device_index.DeviceSegment` mirrors the
scoring-relevant pieces into HBM lazily (first query touching the field).
"""

from __future__ import annotations

import threading
import weakref

import numpy as np

from ..common import arrayio
from ..directory import Directory
from ..fastfield import FastFieldReaders
from ..postings import format as pfmt
from ..schema import Schema
from ..store import StoreReader
from ..termdict import TermDictionary
from .segment import SegmentMeta


class InvertedIndexReader:
    """Per-(segment, field) postings access (reference
    `inverted_index_reader.rs`)."""

    def __init__(self, termdict: TermDictionary, arrays: dict[str, np.ndarray]):
        self.termdict = termdict
        self.arrays = arrays
        self._postings_lru: dict[int, tuple] = {}

    def total_num_tokens(self) -> int:
        return int(self.arrays["total_num_tokens"][0])

    def doc_freq(self, term_bytes: bytes) -> int:
        ord_ = self.termdict.term_ord(term_bytes)
        if ord_ is None:
            return 0
        return int(self.arrays["term_doc_freq"][ord_])

    def term_ord(self, term_bytes: bytes) -> int | None:
        return self.termdict.term_ord(term_bytes)

    def num_terms(self) -> int:
        return len(self.termdict)

    def read_postings(self, term_ord: int) -> tuple[np.ndarray, np.ndarray]:
        """Host decode of a full posting list -> (docs, tfs), LRU-cached:
        host-tail batches (sloppy phrase, fuzzy, MLT, ...) repeat Zipf
        terms heavily, and the block unpack + cumsum decode dominated their
        profile. Segments are immutable, so the cache never invalidates;
        bounded at 128 terms per index to cap memory on frequent terms."""
        cached = self._postings_lru.get(term_ord)
        if cached is None:
            cached = pfmt.decode_term_host(self.arrays, term_ord)
            self._postings_lru[term_ord] = cached
            if len(self._postings_lru) > 128:
                self._postings_lru.pop(next(iter(self._postings_lru)))
        else:
            # refresh recency (dict preserves insertion order)
            self._postings_lru.pop(term_ord)
            self._postings_lru[term_ord] = cached
        return cached

    def positions_for_term(self, term_ord: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (docs, tfs, flat positions) for a term."""
        docs, tfs = self.read_postings(term_ord)
        start = int(self.arrays["term_pos_start"][term_ord])
        total = int(tfs.sum())
        pos = self.arrays["positions"][start : start + total]
        return docs, tfs, pos


#: Census of live SegmentReaders — the `census::Inventory` analogue
#: (reference `index_meta.rs:228`, `managed_directory.rs:109`). GC must not
#: unlink files that an older Searcher generation's readers can still read
#: (components load lazily, so a reader may touch its files long after its
#: segment left meta.json). WeakSet: a collected reader releases its files.
_live_readers: "weakref.WeakSet" = weakref.WeakSet()
_live_readers_lock = threading.Lock()


def live_reader_files(directory) -> set[str]:
    """Union of files referenced by live SegmentReaders over `directory`."""
    with _live_readers_lock:
        readers = list(_live_readers)
    inner = getattr(directory, "inner", None)
    out: set[str] = set()
    for r in readers:
        if r.directory is directory or (inner is not None and r.directory is inner):
            out.update(r.meta.list_files())
    return out


class SegmentReader:
    def __init__(self, meta: SegmentMeta, directory: Directory, schema: Schema):
        self.meta = meta
        self.schema = schema
        self.directory = directory
        self.segment_id = meta.segment_id
        self.max_doc = meta.max_doc
        # components load lazily (reference startup is mmap + <10ms open)
        self._idx_cache = None
        self._term_cache = None
        self._fieldnorm_cache = None
        self._fast_cache = None
        self._store_cache = None
        self._alive_cache = None
        self._alive_loaded = False
        self._inverted: dict[int, InvertedIndexReader] = {}
        #: device mirrors by mode ("dense", "packed"), made on first use
        self._devices: dict = {}
        with _live_readers_lock:
            _live_readers.add(self)

    def _load(self, component: str) -> dict[str, np.ndarray]:
        return arrayio.load_arrays(
            self.directory.open_read(self.meta.relative_path(component))
        )

    @property
    def _idx(self):
        if self._idx_cache is None:
            self._idx_cache = self._load("idx")
        return self._idx_cache

    @property
    def _term(self):
        if self._term_cache is None:
            self._term_cache = self._load("term")
        return self._term_cache

    @property
    def _fieldnorm(self):
        if self._fieldnorm_cache is None:
            self._fieldnorm_cache = self._load("fieldnorm")
        return self._fieldnorm_cache

    @property
    def _fast(self):
        if self._fast_cache is None:
            self._fast_cache = FastFieldReaders(self._load("fast"))
        return self._fast_cache

    @property
    def _store(self):
        if self._store_cache is None:
            self._store_cache = StoreReader(self._load("store"))
        return self._store_cache

    @property
    def _alive(self):
        if not self._alive_loaded:
            self._alive_loaded = True
            if self.meta.has_deletes():
                self._alive_cache = self._load("del")["alive"].astype(bool)
        return self._alive_cache

    # -- doc liveness --------------------------------------------------------

    def num_docs(self) -> int:
        return self.meta.num_docs()

    def num_deleted_docs(self) -> int:
        return self.meta.num_deleted_docs

    def has_deletes(self) -> bool:
        return self._alive is not None

    def alive_bitset(self) -> np.ndarray | None:
        return self._alive

    def is_deleted(self, doc: int) -> bool:
        return self._alive is not None and not self._alive[doc]

    def doc_ids_alive(self) -> np.ndarray:
        if self._alive is None:
            return np.arange(self.max_doc, dtype=np.uint32)
        return np.nonzero(self._alive)[0].astype(np.uint32)

    # -- component readers ---------------------------------------------------

    def inverted_index(self, field_name: str) -> InvertedIndexReader:
        entry = self.schema.get_field(field_name)
        inv = self._inverted.get(entry.field_id)
        if inv is None:
            field_term = arrayio.field_arrays(self._term, entry.field_id)
            field_idx = arrayio.field_arrays(self._idx, entry.field_id)
            if not field_term:
                td = TermDictionary.from_sorted_terms([])
                field_idx = {
                    "total_num_tokens": np.zeros(1, dtype=np.int64),
                    "term_doc_freq": np.zeros(0, dtype=np.uint32),
                    "term_block_start": np.zeros(0, dtype=np.int32),
                    "term_num_blocks": np.zeros(0, dtype=np.int32),
                }
            else:
                td = TermDictionary.from_arrays(field_term)
            inv = InvertedIndexReader(td, field_idx)
            self._inverted[entry.field_id] = inv
        return inv

    def fieldnorms(self, field_name: str) -> np.ndarray:
        entry = self.schema.get_field(field_name)
        arr = self._fieldnorm.get(str(entry.field_id))
        if arr is None:
            if entry.has_fieldnorms():
                return np.zeros(self.max_doc, dtype=np.uint8)
            # fields without fieldnorms score with constant fieldnorm 1
            # (reference term_weight.rs:218 FieldNormReader::constant(.., 1))
            return np.ones(self.max_doc, dtype=np.uint8)
        return arr

    def fast_fields(self) -> FastFieldReaders:
        return self._fast

    def fields_metadata(self) -> list[dict]:
        """Per-field presence/type metadata for this segment (reference
        `segment_reader.rs:300` `fields_metadata`) — includes JSON dynamic
        per-path fast columns under their dotted names."""
        out = []
        fast_names = set(self._fast.column_fields())
        for entry in self.schema.fields():
            key = f"{entry.field_id}/"
            indexed = entry.is_indexed() and any(
                k.startswith(key) for k in self._term
            )
            out.append({
                "field_name": entry.name,
                "typ": entry.field_type.value,
                "indexed": indexed,
                "stored": entry.is_stored(),
                "fast": entry.name in fast_names,
            })
        for nm in sorted(fast_names):
            if "\x01" in nm:  # JSON dynamic path column
                out.append({
                    "field_name": nm.replace("\x01", "."),
                    "typ": self._fast.column(nm).type_name,
                    "indexed": False,
                    "stored": False,
                    "fast": True,
                })
        return out

    def store_reader(self) -> StoreReader:
        return self._store

    def doc(self, doc_id: int):
        return self._store.get(doc_id)

    # -- device mirror -------------------------------------------------------

    def device(self, mode: str = "dense"):
        """Lazy mirror of the scoring-relevant arrays in `mode` ("dense" or
        "packed"); one per mode, so executors of both modes share a reader
        without rebuilding each other's."""
        dseg = self._devices.get(mode)
        if dseg is None:
            from ..ops.device_index import DeviceSegment

            dseg = self._devices[mode] = DeviceSegment(self, mode)
        return dseg

    def space_usage(self) -> dict[str, int]:
        def nbytes(arrs) -> int:
            return int(sum(a.nbytes for a in arrs.values()))

        return {
            "postings": nbytes(self._idx),
            "termdict": nbytes(self._term),
            "fieldnorms": nbytes(self._fieldnorm),
            "fastfields": nbytes(self._fast._arrays),
            "store": nbytes(self._store.__dict__.get("_arrays", {})) or len(self._store._blob),
            "deletes": int(self._alive.nbytes) if self._alive is not None else 0,
        }
