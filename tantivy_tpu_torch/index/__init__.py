"""Index — the top-level handle tying Directory + Schema + tokenizers
(reference `src/index/index.rs:306`), and IndexReader with reload policies
(reference `src/reader/mod.rs:21`).
"""

from __future__ import annotations

import json
import threading
from enum import Enum

from ..directory import (
    Directory,
    FsDirectory,
    ManagedDirectory,
    META_FILEPATH,
    RamDirectory,
)
from ..schema import Schema
from ..searcher import Searcher
from ..tokenizer import TokenizerManager
from .segment import IndexMeta, SegmentMeta
from .segment_reader import SegmentReader


class ReloadPolicy(str, Enum):
    """Reference `src/reader/mod.rs:21`: Manual / OnCommitWithDelay.
    ON_COMMIT reloads synchronously in the watch callback;
    ON_COMMIT_WITH_DELAY debounces bursts of commits — the reload runs on
    a background thread after `reload_delay_s`, coalescing every commit
    that lands in the window into one searcher generation (and one warmer
    pass — exactly where device-store warming wants coalescing)."""

    MANUAL = "manual"
    ON_COMMIT = "on_commit"
    ON_COMMIT_WITH_DELAY = "on_commit_with_delay"


class IndexSettings:
    """Reference `index_meta.rs:248` IndexSettings{sort_by_field,
    docstore_compression, docstore_blocksize}."""

    def __init__(self, sort_by_field: tuple[str, str] | None = None,
                 docstore_compression: str = "zstd",
                 docstore_blocksize: int = 16_384,
                 docstore_compress_dedicated_thread: bool = False):
        # sort_by_field: (field_name, "asc"|"desc")
        self.sort_by_field = sort_by_field
        self.docstore_compression = docstore_compression
        self.docstore_blocksize = docstore_blocksize
        self.docstore_compress_dedicated_thread = (
            docstore_compress_dedicated_thread
        )

    def to_json(self) -> dict:
        return {
            "sort_by_field": list(self.sort_by_field) if self.sort_by_field else None,
            "docstore_compression": self.docstore_compression,
            "docstore_blocksize": self.docstore_blocksize,
            "docstore_compress_dedicated_thread":
                self.docstore_compress_dedicated_thread,
        }

    @classmethod
    def from_json(cls, d: dict | None) -> "IndexSettings":
        if not d:
            return cls()
        sbf = d.get("sort_by_field")
        return cls(
            sort_by_field=tuple(sbf) if sbf else None,
            docstore_compression=d.get("docstore_compression", "zstd"),
            docstore_blocksize=d.get("docstore_blocksize", 16_384),
            docstore_compress_dedicated_thread=d.get(
                "docstore_compress_dedicated_thread", False
            ),
        )


class Index:
    def __init__(self, directory: Directory, schema: Schema,
                 tokenizers: TokenizerManager | None = None,
                 settings: "IndexSettings | None" = None):
        self.directory = directory
        self.schema = schema
        self.tokenizers = tokenizers or TokenizerManager.default()
        self.settings = settings or IndexSettings()
        self.search_executor = None

    def set_multithread_executor(self, num_threads: int) -> None:
        """Reference `Index::set_multithread_executor`."""
        from ..executor import Executor

        self.search_executor = Executor.multi_thread(num_threads)

    def set_default_multithread_executor(self) -> None:
        import os

        self.set_multithread_executor(os.cpu_count() or 1)

    # -- constructors --------------------------------------------------------

    @classmethod
    def create_in_ram(cls, schema: Schema, settings: "IndexSettings | None" = None) -> "Index":
        index = cls(ManagedDirectory(RamDirectory()), schema, settings=settings)
        index.save_metas(
            IndexMeta(schema_json=schema.to_json(), settings=index.settings.to_json())
        )
        return index

    @classmethod
    def create_in_dir(cls, path, schema: Schema, settings: "IndexSettings | None" = None) -> "Index":
        directory = ManagedDirectory(FsDirectory.create(path))
        if directory.exists(META_FILEPATH):
            raise FileExistsError(f"index already exists at {path}")
        index = cls(directory, schema, settings=settings)
        index.save_metas(
            IndexMeta(schema_json=schema.to_json(), settings=index.settings.to_json())
        )
        return index

    @classmethod
    def open_in_dir(cls, path) -> "Index":
        directory = ManagedDirectory(FsDirectory(path))
        meta = IndexMeta.from_json(
            json.loads(directory.atomic_read(META_FILEPATH).decode("utf-8"))
        )
        schema = Schema.from_json(meta.schema_json)
        return cls(directory, schema, settings=IndexSettings.from_json(meta.settings))

    @classmethod
    def open_or_create(cls, path, schema: Schema,
                       settings: "IndexSettings | None" = None) -> "Index":
        directory = ManagedDirectory(FsDirectory.create(path))
        if directory.exists(META_FILEPATH):
            index = cls.open_in_dir(path)  # settings come from meta.json
            if index.schema.to_json() != schema.to_json():
                raise ValueError("schema mismatch with existing index")
            return index
        index = cls(directory, schema, settings=settings)
        index.save_metas(
            IndexMeta(
                schema_json=schema.to_json(),
                settings=index.settings.to_json(),
            )
        )
        return index

    # -- metas ---------------------------------------------------------------

    def load_metas(self) -> IndexMeta:
        raw = self.directory.atomic_read(META_FILEPATH)
        return IndexMeta.from_json(json.loads(raw.decode("utf-8")))

    def save_metas(self, meta: IndexMeta) -> None:
        from ..utils.failpoints import fail_point

        payload = json.dumps(meta.to_json(), indent=1).encode("utf-8")
        fail_point("meta-file-write")  # crash BEFORE publishing new meta
        self.directory.atomic_write(META_FILEPATH, payload)
        fail_point("meta-file-written")  # crash after publish, before sync
        self.directory.sync_directory()

    def searchable_segment_metas(self) -> list[SegmentMeta]:
        return self.load_metas().segments

    def validate_checksum(self) -> list[str]:
        """Returns the list of corrupted files (reference `index.rs:729`)."""
        damaged = []
        validate = getattr(self.directory, "validate_checksum", None)
        if validate is None:
            return []
        for meta in self.searchable_segment_metas():
            for path in meta.list_files():
                if self.directory.exists(path) and not validate(path):
                    damaged.append(path)
        return damaged

    # -- writer / reader -----------------------------------------------------

    def writer(self, memory_budget: int = 15_000_000, **kwargs):
        from ..indexer import IndexWriter

        return IndexWriter(self, memory_budget=memory_budget, **kwargs)

    def writer_for_tests(self):
        """Single worker thread, minimum budget, no merges (reference
        `index.rs:637`)."""
        from ..indexer import IndexWriter
        from ..indexer.merge_policy import NoMergePolicy

        return IndexWriter(self, merge_policy=NoMergePolicy(), num_threads=1)

    def reader(self, reload_policy: ReloadPolicy = ReloadPolicy.ON_COMMIT,
               warmers: list | None = None,
               reload_delay_s: float = 0.1) -> "IndexReader":
        return IndexReader(self, reload_policy, warmers=warmers,
                           reload_delay_s=reload_delay_s)

    # -- convenience ---------------------------------------------------------

    def parse_query(self, query_str: str, default_fields: list[str] | None = None):
        from ..query.parser import QueryParser

        if default_fields is None:
            default_fields = [
                e.name
                for e in self.schema.fields()
                if e.is_indexed() and e.field_type.value in ("text", "json")
            ]
        return QueryParser.for_index(self, default_fields).parse_query(query_str)


class IndexReader:
    """Searcher factory with reload policy (reference `src/reader/`)."""

    def __init__(self, index: Index, reload_policy: ReloadPolicy,
                 warmers: list | None = None, reload_delay_s: float = 0.1):
        self.index = index
        self.reload_policy = reload_policy
        self.reload_delay_s = reload_delay_s
        self._warmers = list(warmers or [])
        self._lock = threading.Lock()
        self._searcher: Searcher | None = None
        self._watch_handle = None
        self._delay_timer: threading.Timer | None = None
        self._timer_lock = threading.Lock()
        self.reload()
        if reload_policy == ReloadPolicy.ON_COMMIT:
            self._watch_handle = index.directory.watch(self._on_commit)
        elif reload_policy == ReloadPolicy.ON_COMMIT_WITH_DELAY:
            self._watch_handle = index.directory.watch(
                self._on_commit_delayed
            )

    def _on_commit(self) -> None:
        try:
            self.reload()
        except Exception:
            pass

    def _on_commit_delayed(self) -> None:
        """Debounced reload (reference OnCommitWithDelay,
        `src/reader/mod.rs:21`): restart the timer on every commit so a
        burst coalesces into ONE reload + warm pass after the window."""
        with self._timer_lock:
            if self._delay_timer is not None:
                self._delay_timer.cancel()
            t = threading.Timer(self.reload_delay_s, self._on_commit)
            t.daemon = True
            self._delay_timer = t
            t.start()

    def reload(self) -> None:
        metas = self.index.load_metas()
        with self._lock:
            prev = self._searcher
        # reuse readers of unchanged segments from the previous generation:
        # their lazily-built caches (decoded postings, device slabs) carry
        # over, so an incremental commit only pays for its new segments
        old = {}
        if prev is not None:
            for r in prev.segment_readers():
                old[(r.meta.segment_id, r.meta.delete_opstamp)] = r
        readers = [
            old.get((m.segment_id, m.delete_opstamp))
            or SegmentReader(m, self.index.directory, self.index.schema)
            for m in metas.segments
        ]
        searcher = Searcher(self.index, readers)
        for warmer in self._warmers:
            warmer.warm(searcher)
        with self._lock:
            self._searcher = searcher

    def searcher(self) -> Searcher:
        with self._lock:
            return self._searcher


class Warmer:
    """Reference `src/reader/warming.rs:14` — hook run on every new searcher
    generation (e.g. pre-moving postings to HBM)."""

    def warm(self, searcher: Searcher) -> None:
        raise NotImplementedError
