"""Row-oriented document store — parity with reference `src/store/`.

Docs are serialized (JSON) and appended into ~16KB uncompressed blocks; each
block is compressed (zstd by default — the environment has no LZ4 — or none)
and indexed by a checkpoint `(first_doc, num_docs, byte_range)` skip list
(reference `src/store/index/mod.rs`). Reads go through an LRU block cache
(reference `reader.rs:25,63`, 100 blocks). Doc fetch happens post-ranking on
host; this component never touches the device.
"""

from __future__ import annotations

import io
import struct
from collections import OrderedDict

import numpy as np

from ..schema.document import Document

BLOCK_SIZE = 16_384
CACHE_LEN = 100


class Compressor:
    NONE = "none"
    ZSTD = "zstd"


def _compress(data: bytes, compressor: str) -> bytes:
    if compressor == Compressor.ZSTD:
        import zstandard

        return zstandard.ZstdCompressor(level=3).compress(data)
    return data


def _decompress(data: bytes, compressor: str) -> bytes:
    if compressor == Compressor.ZSTD:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(data)
    return data


class StoreWriter:
    """Reference `src/store/writer.rs`.

    With `dedicated_thread=True`, block compression runs on a dedicated
    worker thread fed through a bounded queue (reference
    `store_compressor.rs:25` — the `docstore_compress_dedicated_thread`
    index setting): ingestion overlaps zstd work (which releases the GIL).
    `finish()` joins the thread, so output is identical either way."""

    def __init__(self, compressor: str = Compressor.ZSTD, block_size: int = BLOCK_SIZE,
                 dedicated_thread: bool = False):
        self.compressor = compressor
        self.block_size = block_size
        self._current: list[bytes] = []
        self._current_size = 0
        self._first_doc_in_block = 0
        self._num_docs = 0
        self._blocks: list = []  # bytes, or a pending-slot index marker
        self._checkpoints: list[tuple[int, int]] = []  # (first_doc, num_docs)
        self._thread = None
        self._queue = None
        if dedicated_thread and compressor != Compressor.NONE:
            import queue
            import threading

            self._queue = queue.Queue(maxsize=8)
            self._thread = threading.Thread(
                target=self._compress_loop, daemon=True,
                name="tantivy-tpu-store-compressor",
            )
            self._thread.start()

    def _compress_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            slot, raw = item
            self._blocks[slot] = _compress(raw, self.compressor)
            self._queue.task_done()

    def store(self, doc: Document) -> None:
        self.store_payload(doc.to_json().encode("utf-8"))

    def store_payload(self, payload: bytes) -> None:
        """Append one stored row from pre-serialized payload bytes (the
        Document.from_json wire format) — the hot ingest path skips the
        Document round-trip."""
        self._current.append(struct.pack("<I", len(payload)) + payload)
        self._current_size += 4 + len(payload)
        self._num_docs += 1
        if self._current_size >= self.block_size:
            self._flush_block()

    _EMPTY_ROW = struct.pack("<I", 2) + b"{}"

    def store_empty(self) -> None:
        """Fast path for schemas with no stored fields: keeps doc ids aligned
        without serializing a Document."""
        self._current.append(self._EMPTY_ROW)
        self._current_size += len(self._EMPTY_ROW)
        self._num_docs += 1
        if self._current_size >= self.block_size:
            self._flush_block()

    def store_raw_block(self, compressed: bytes, first_doc: int, num_docs: int) -> None:
        """Merge fast path: stack an existing compressed block without
        recompressing (reference `writer.rs:126`)."""
        self._flush_block()
        self._blocks.append(compressed)
        self._checkpoints.append((self._first_doc_in_block, num_docs))
        self._first_doc_in_block += num_docs
        self._num_docs += num_docs

    def _flush_block(self) -> None:
        if not self._current:
            return
        raw = b"".join(self._current)
        if self._queue is not None:
            self._blocks.append(b"")  # slot filled by the compressor thread
            self._queue.put((len(self._blocks) - 1, raw))
        else:
            self._blocks.append(_compress(raw, self.compressor))
        ndocs = self._num_docs - self._first_doc_in_block
        self._checkpoints.append((self._first_doc_in_block, ndocs))
        self._first_doc_in_block = self._num_docs
        self._current = []
        self._current_size = 0

    def finish(self) -> dict[str, np.ndarray]:
        self._flush_block()
        if self._queue is not None:
            self._queue.join()
            self._queue.put(None)
            self._thread.join()
            self._queue = None
            self._thread = None
        offsets = np.zeros(len(self._blocks) + 1, dtype=np.int64)
        for i, b in enumerate(self._blocks):
            offsets[i + 1] = offsets[i] + len(b)
        blob = b"".join(self._blocks)
        checkpoints = np.asarray(self._checkpoints or np.zeros((0, 2)), dtype=np.int64)
        return {
            "blob": np.frombuffer(blob, dtype=np.uint8),
            "block_offsets": offsets,
            "checkpoints": checkpoints.reshape(-1, 2),
            "compressor": np.frombuffer(self.compressor.encode(), dtype=np.uint8),
            "num_docs": np.asarray([self._num_docs], dtype=np.int64),
        }


class CacheStats:
    def __init__(self):
        self.cache_hits = 0
        self.cache_misses = 0


class StoreReader:
    """Reference `src/store/reader.rs`."""

    def __init__(self, arrays: dict[str, np.ndarray], cache_len: int = CACHE_LEN):
        self._blob = bytes(arrays["blob"].tobytes())
        self._offsets = arrays["block_offsets"]
        self._checkpoints = arrays["checkpoints"]
        self.compressor = bytes(arrays["compressor"].tobytes()).decode()
        self.num_docs = int(arrays["num_docs"][0])
        self._cache: OrderedDict[int, list[bytes]] = OrderedDict()
        self._cache_len = cache_len
        self.cache_stats = CacheStats()

    def _block_for_doc(self, doc_id: int) -> int:
        firsts = self._checkpoints[:, 0]
        idx = int(np.searchsorted(firsts, doc_id, side="right")) - 1
        if idx < 0 or idx >= len(self._checkpoints):
            raise KeyError(f"doc {doc_id} out of range")
        first, ndocs = self._checkpoints[idx]
        if not (first <= doc_id < first + ndocs):
            raise KeyError(f"doc {doc_id} not stored")
        return idx

    def _read_block(self, block_idx: int) -> list[bytes]:
        cached = self._cache.get(block_idx)
        if cached is not None:
            self.cache_stats.cache_hits += 1
            self._cache.move_to_end(block_idx)
            return cached
        self.cache_stats.cache_misses += 1
        lo, hi = int(self._offsets[block_idx]), int(self._offsets[block_idx + 1])
        raw = _decompress(self._blob[lo:hi], self.compressor)
        docs = []
        view = io.BytesIO(raw)
        while True:
            header = view.read(4)
            if len(header) < 4:
                break
            (length,) = struct.unpack("<I", header)
            docs.append(view.read(length))
        self._cache[block_idx] = docs
        if len(self._cache) > self._cache_len:
            self._cache.popitem(last=False)
        return docs

    def get(self, doc_id: int) -> Document:
        block_idx = self._block_for_doc(doc_id)
        first, _ = self._checkpoints[block_idx]
        docs = self._read_block(block_idx)
        return Document.from_json(docs[doc_id - int(first)].decode("utf-8"))

    def iter_raw_blocks(self):
        """(compressed_bytes, first_doc, num_docs) per block — merge stacking."""
        for i in range(len(self._checkpoints)):
            lo, hi = int(self._offsets[i]), int(self._offsets[i + 1])
            first, ndocs = (int(x) for x in self._checkpoints[i])
            yield self._blob[lo:hi], first, ndocs

    def iter_documents(self):
        for i in range(len(self._checkpoints)):
            for payload in self._read_block(i):
                yield Document.from_json(payload.decode("utf-8"))
