"""Write path — IndexWriter / deletes / commit / merge orchestration.

Counterpart of reference `src/indexer/` (index_writer.rs:71,
segment_updater.rs:274, delete_queue.rs). Ingestion mirrors the reference's
threading model: documents are stamped on the caller thread and pushed down a
bounded queue (the crossbeam channel, cap 10k — `index_writer.rs:39-40,304`)
to N worker threads, each building private SegmentWriters and flushing when
its budget share fills (`index_writer.rs:182-211,412-461`). The C++ indexing
core releases the GIL during tokenize+hash (ctypes), so workers overlap on
the hot loop. Commits join the workers, collect their segments, and respawn
them. Merges run inline at commit (the reference uses merge threads).
Durable-commit semantics are identical: a commit atomically swaps meta.json;
segments are immutable; deletes are opstamp-ordered tombstones.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading

import numpy as np

from ..common import arrayio
from ..directory import META_FILEPATH
from ..index.segment import IndexMeta, SegmentMeta, new_segment_id
from ..schema.document import Document
from ..schema.term import Term
from .merge_policy import LogMergePolicy, MergePolicy, NoMergePolicy
from .merger import IndexMerger
from .segment_writer import SegmentWriter

#: reference `index_writer.rs:28-33`
MEMORY_BUDGET_NUM_BYTES_MIN = 15_000_000
MARGIN_IN_BYTES = 1_000_000


class _DeleteOp:
    __slots__ = ("opstamp", "kind", "payload")

    def __init__(self, opstamp: int, kind: str, payload):
        self.opstamp = opstamp
        self.kind = kind  # "term" | "query"
        self.payload = payload


class PreparedCommit:
    """Reference `prepared_commit.rs` — lets callers attach a payload before
    finalizing."""

    def __init__(self, writer: "IndexWriter", opstamp: int):
        self._writer = writer
        self.opstamp = opstamp
        self._payload: str | None = None

    def set_payload(self, payload: str) -> None:
        self._payload = payload

    def commit(self) -> int:
        return self._writer._finish_commit(self.opstamp, self._payload)

    def abort(self) -> None:
        self._writer.rollback()


#: queue capacity, reference `index_writer.rs:39-40`
PIPELINE_MAX_SIZE_IN_DOCS = 10_000


class IndexWriter:
    def __init__(self, index, memory_budget: int = MEMORY_BUDGET_NUM_BYTES_MIN,
                 merge_policy: MergePolicy | None = None,
                 num_threads: int | None = None):
        if memory_budget < MEMORY_BUDGET_NUM_BYTES_MIN:
            raise ValueError(
                f"memory budget below minimum ({MEMORY_BUDGET_NUM_BYTES_MIN})"
            )
        self.index = index
        self.memory_budget = memory_budget
        self._merge_policy = merge_policy or LogMergePolicy()
        self._lock = index.directory.acquire_lock(".tantivy-writer.lock")
        self._opstamp = index.load_metas().opstamp
        self._segment_writer: SegmentWriter | None = None
        self._doc_opstamps: list[int] = []
        self._pending_segments: list[tuple[SegmentMeta, list[int]]] = []
        self._pending_lock = threading.Lock()
        self._deletes: list[_DeleteOp] = []
        self._committed_opstamp = self._opstamp
        if num_threads is None:
            num_threads = min(8, os.cpu_count() or 1)
        self.num_threads = max(1, int(num_threads))
        self._queue: queue_mod.Queue | None = None
        self._workers: list[threading.Thread] = []
        self._worker_error: BaseException | None = None
        self._ingest_buf: list = []  # single-threaded ingest batch buffer
        #: serializes meta.json read-modify-write between commits and
        #: background merge threads (the reference's single-threaded
        #: SegmentUpdater provides the same guarantee, segment_updater.rs:274)
        self._meta_lock = threading.Lock()
        self._merge_threads: list[threading.Thread] = []
        #: in-flight merge output files, written before their meta swap —
        #: GC must not reclaim them (guarded by _pending_lock)
        self._merge_outputs: set[str] = set()
        if self.num_threads > 1:
            self._start_workers()

    # -- worker pool -----------------------------------------------------------

    def _start_workers(self) -> None:
        self._queue = queue_mod.Queue(maxsize=PIPELINE_MAX_SIZE_IN_DOCS)
        self._workers = []
        per_budget = max(
            self.memory_budget // self.num_threads, 3_000_000
        )
        for i in range(self.num_threads):
            t = threading.Thread(
                target=self._worker_loop,
                args=(per_budget,),
                name=f"thrd-tantivy-index{i}",
                daemon=True,
            )
            t.start()
            self._workers.append(t)

    def _new_segment_writer(self) -> SegmentWriter:
        settings = self.index.settings
        return SegmentWriter(
            self.index.schema,
            self.index.tokenizers,
            sort_by_field=settings.sort_by_field,
            compress_dedicated_thread=getattr(
                settings, "docstore_compress_dedicated_thread", False
            ),
        )

    def _worker_loop(self, budget: int) -> None:
        sw: SegmentWriter | None = None
        ops: list[int] = []
        q = self._queue
        while True:
            # greedy batch drain: one blocking get, then up to 255 more
            # without blocking — batches feed SegmentWriter.add_documents,
            # whose native text path makes ONE GIL-releasing C call per
            # field per batch (workers overlap during it)
            items = [q.get()]
            while len(items) < 256:
                try:
                    items.append(q.get_nowait())
                except queue_mod.Empty:
                    break
            n_none = sum(1 for it in items if it is None)
            batch = [it for it in items if it is not None]
            try:
                if batch and self._worker_error is None:
                    if sw is None:
                        sw = self._new_segment_writer()
                        ops = []
                    sw.add_documents([doc for _, doc in batch])
                    ops.extend(stamp for stamp, _ in batch)
                    if sw.mem_usage() >= \
                            budget - MARGIN_IN_BYTES // self.num_threads:
                        self._write_segment(sw, ops)
                        sw, ops = None, []
            except BaseException as e:  # worker death poisons the writer
                self._worker_error = e
                sw, ops = None, []
            finally:
                for _ in items:
                    q.task_done()
            if n_none:
                # sentinels for other workers this drain swallowed
                for _ in range(n_none - 1):
                    q.put(None)
                if sw is not None and self._worker_error is None:
                    try:
                        self._write_segment(sw, ops)
                    except BaseException as e:
                        # a death during the shutdown flush must poison the
                        # writer too — otherwise the commit would silently
                        # publish without this worker's segment
                        self._worker_error = e
                return

    def _join_workers(self) -> None:
        """Stop all workers (each flushes its partial segment) and respawn
        them — the reference's prepare_commit worker cycle
        (`index_writer.rs:617-648`)."""
        if not self._workers:
            return
        for _ in self._workers:
            self._queue.put(None)
        for t in self._workers:
            t.join()
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            self._start_workers()
            raise RuntimeError("an indexing worker died; writer rolled back") from err
        self._start_workers()

    # -- ops -----------------------------------------------------------------

    def _stamp(self) -> int:
        self._opstamp += 1
        return self._opstamp

    def add_document(self, doc: Document) -> int:
        opstamp = self._stamp()
        if self._worker_error is not None:
            raise RuntimeError("indexing worker died; rollback and retry") \
                from self._worker_error
        if self.num_threads > 1:
            self._queue.put((opstamp, doc))
            return opstamp
        # single-threaded path batches ingest too (one C call per field per
        # 256 docs — see SegmentWriter.add_documents)
        self._ingest_buf.append((opstamp, doc))
        if len(self._ingest_buf) >= 256:
            self._flush_ingest_buf()
        return opstamp

    def _flush_ingest_buf(self) -> None:
        buf = getattr(self, "_ingest_buf", None)
        if not buf:
            return
        self._ingest_buf = []
        if self._segment_writer is None:
            self._segment_writer = self._new_segment_writer()
            self._doc_opstamps = []
        self._segment_writer.add_documents([d for _, d in buf])
        self._doc_opstamps.extend(s for s, _ in buf)
        if self._segment_writer.mem_usage() >= \
                self.memory_budget - MARGIN_IN_BYTES:
            self._flush_segment()

    def delete_term(self, term: Term) -> int:
        opstamp = self._stamp()
        self._deletes.append(_DeleteOp(opstamp, "term", term))
        return opstamp

    def delete_query(self, query) -> int:
        """Reference `index_writer.rs:675-700` — the query is evaluated at
        commit time against every segment."""
        opstamp = self._stamp()
        self._deletes.append(_DeleteOp(opstamp, "query", query))
        return opstamp

    def delete_all_documents(self) -> int:
        from ..query import AllQuery

        return self.delete_query(AllQuery())

    # -- segment flushing ----------------------------------------------------

    def _write_segment(self, sw: SegmentWriter, doc_opstamps: list[int]) -> None:
        """Serialize one segment and register it (thread-safe; called from
        worker threads and the single-threaded path alike)."""
        if sw.max_doc == 0:
            return
        from ..utils.failpoints import fail_point
        from ..utils.trace import debug_time

        # crash while serializing a segment: nothing is registered, the last
        # commit stays intact (reference "FieldSerializer::close_term" point)
        fail_point("segment-serialize")
        with debug_time("segment.serialize", docs=sw.max_doc):
            components = sw.serialize()
        sid = new_segment_id()
        meta = SegmentMeta(segment_id=sid, max_doc=sw.max_doc)
        payload = [
            (f"{sid}.{comp}", arrayio.save_arrays(arrays))
            for comp, arrays in components.items()
        ]
        with self._pending_lock:
            for name, data in payload:
                self.index.directory.write(name, data)
            self._pending_segments.append((meta, doc_opstamps))

    def _flush_segment(self) -> None:
        if self._ingest_buf:
            self._flush_ingest_buf()
        sw = self._segment_writer
        if sw is None or sw.max_doc == 0:
            self._segment_writer = None
            return
        self._write_segment(sw, self._doc_opstamps)
        self._segment_writer = None
        self._doc_opstamps = []

    # -- commit --------------------------------------------------------------

    def prepare_commit(self) -> PreparedCommit:
        if self.num_threads > 1:
            self._join_workers()
        self._flush_ingest_buf()
        self._flush_segment()
        return PreparedCommit(self, self._stamp())

    def commit(self) -> int:
        return self.prepare_commit().commit()

    def _finish_commit(self, commit_opstamp: int, payload: str | None) -> int:
        with self._pending_lock:
            pending_segments, self._pending_segments = self._pending_segments, []

        pending = [d for d in self._deletes if d.opstamp <= commit_opstamp]
        self._deletes = [d for d in self._deletes if d.opstamp > commit_opstamp]

        # the whole load→modify→save must run under _meta_lock: a concurrent
        # background merge's swap interleaving here would let the commit
        # resurrect merged-away segments (advisor r2 finding)
        with self._meta_lock:
            meta = self.index.load_metas()
            segments = list(meta.segments)

            # new segments join the manifest
            new_doc_opstamps = {m.segment_id: ops for m, ops in pending_segments}
            segments.extend(m for m, _ in pending_segments)

            # apply deletes (advance_deletes, reference index_writer.rs:131)
            if pending:
                segments = [
                    self._advance_deletes(
                        s, pending, new_doc_opstamps.get(s.segment_id)
                    )
                    for s in segments
                ]
            segments = [s for s in segments if s.num_docs() > 0]

            new_meta = IndexMeta(
                schema_json=self.index.schema.to_json(),
                segments=segments,
                opstamp=commit_opstamp,
                payload=payload,
                settings=self.index.settings.to_json(),
            )
            self.index.save_metas(new_meta)
        self._committed_opstamp = commit_opstamp

        self._consider_merges()
        self.garbage_collect_files()
        return commit_opstamp

    def _advance_deletes(self, seg_meta: SegmentMeta, ops: list[_DeleteOp],
                         doc_opstamps: list[int] | None) -> SegmentMeta:
        from ..index.segment_reader import SegmentReader
        from ..searcher import Searcher

        reader = SegmentReader(seg_meta, self.index.directory, self.index.schema)
        alive = (
            reader.alive_bitset().copy()
            if reader.alive_bitset() is not None
            else np.ones(seg_meta.max_doc, dtype=bool)
        )
        doc_opstamps_arr = (
            np.asarray(doc_opstamps, dtype=np.int64) if doc_opstamps else None
        )
        changed = False
        searcher = Searcher(self.index, [reader])
        for op in ops:
            if op.kind == "term":
                inv = reader.inverted_index(op.payload.field)
                ord_ = inv.term_ord(op.payload.value_bytes)
                if ord_ is None:
                    continue
                docs, _ = inv.read_postings(ord_)
            else:
                weight = op.payload.weight(searcher, scoring=False)
                docs = weight.execute(reader).docs
            if doc_opstamps_arr is not None:
                # a delete only applies to docs added before it
                docs = docs[doc_opstamps_arr[docs] < op.opstamp]
            if len(docs):
                before = alive[docs].any()
                alive[docs] = False
                changed = changed or bool(before)
        if not changed:
            return seg_meta
        num_deleted = int(seg_meta.max_doc - np.count_nonzero(alive))
        new_meta = SegmentMeta(
            segment_id=seg_meta.segment_id,
            max_doc=seg_meta.max_doc,
            delete_opstamp=ops[-1].opstamp,
            num_deleted_docs=num_deleted,
        )
        self.index.directory.write(
            new_meta.relative_path("del"),
            arrayio.save_arrays({"alive": alive.astype(np.uint8)}),
        )
        return new_meta

    def rollback(self) -> int:
        """Drop everything since the last commit (reference
        `index_writer.rs:563-596`). In threaded mode, drains the document
        queue and discards worker segments (their files are reclaimed by the
        next GC pass)."""
        if self.num_threads > 1 and self._workers:
            for _ in self._workers:
                self._queue.put(None)
            for t in self._workers:
                t.join()
            self._worker_error = None
            self._start_workers()
        self._segment_writer = None
        self._doc_opstamps = []
        self._ingest_buf = []
        with self._pending_lock:
            self._pending_segments = []
        self._deletes = []
        self._opstamp = self._committed_opstamp
        return self._opstamp

    # -- merging -------------------------------------------------------------

    def set_merge_policy(self, policy: MergePolicy) -> None:
        self._merge_policy = policy

    def get_merge_policy(self) -> MergePolicy:
        return self._merge_policy

    def _consider_merges(self) -> None:
        """Schedule policy-selected merges on background threads (reference
        `segment_updater.rs:490-615` merge threads). Merges of disjoint
        candidates run concurrently; the meta.json swap is serialized."""
        meta = self.index.load_metas()
        for candidate in self._merge_policy.compute_merge_candidates(meta.segments):
            if len(candidate) >= 1:
                t = threading.Thread(
                    target=self._merge_guarded,
                    args=(candidate,),
                    name=f"thrd-tantivy-merge{len(self._merge_threads)}",
                    daemon=True,
                )
                t.start()
                self._merge_threads.append(t)

    def _merge_guarded(self, segment_ids: list[str]) -> None:
        try:
            self.merge(segment_ids)
        except Exception:
            import logging

            logging.getLogger("tantivy_tpu_torch").exception(
                "background merge failed"
            )

    def merge(self, segment_ids: list[str]) -> SegmentMeta | None:
        """Merge the given segments into one (runs inline; reference spawns a
        merge thread — `segment_updater.rs:490`)."""
        from ..index.segment_reader import SegmentReader

        meta = self.index.load_metas()
        chosen = [s for s in meta.segments if s.segment_id in set(segment_ids)]
        if len(chosen) < 1:
            return None
        # delete generations at merge start: a delete committed mid-merge
        # keeps the segment_id and only advances delete_opstamp, so the
        # liveness check below must compare generations, not just ids
        # (reference advance_deletes / end_merge, segment_updater.rs:617)
        start_del_opstamps = {s.segment_id: s.delete_opstamp for s in chosen}
        readers = [
            SegmentReader(s, self.index.directory, self.index.schema) for s in chosen
        ]
        merger = IndexMerger(
            self.index.schema, readers,
            sort_by_field=self.index.settings.sort_by_field,
        )
        from ..utils.trace import debug_time

        with debug_time("segment.merge", n_segments=len(readers)):
            components, max_doc = merger.write()
        sid = new_segment_id()
        out_files = [f"{sid}.{comp}" for comp in components]
        with self._pending_lock:
            self._merge_outputs.update(out_files)
        try:
            for comp, arrays in components.items():
                self.index.directory.write(
                    f"{sid}.{comp}", arrayio.save_arrays(arrays)
                )
            merged_meta = SegmentMeta(segment_id=sid, max_doc=max_doc)

            chosen_ids = {s.segment_id for s in chosen}
            with self._meta_lock:
                # re-read: commits/merges may have landed while merging; only
                # swap if every source segment is still live (otherwise drop
                # the merge result — reference end_merge semantics)
                meta = self.index.load_metas()
                live = {s.segment_id: s for s in meta.segments}
                if not chosen_ids <= live.keys():
                    return None
                if max_doc > 0:
                    merged_meta = self._reapply_merge_deletes(
                        merged_meta, chosen, live, merger.mappings,
                        start_del_opstamps,
                    )
                new_segments = [
                    s for s in meta.segments if s.segment_id not in chosen_ids
                ]
                if merged_meta.num_docs() > 0:
                    new_segments.append(merged_meta)
                from ..utils.failpoints import fail_point

                # crash with the merged segment fully written but the
                # manifest swap not performed: both source segments must
                # stay searchable, the orphan output is GC'd later
                fail_point("merge-swap")
                self.index.save_metas(
                    IndexMeta(
                        schema_json=self.index.schema.to_json(),
                        segments=new_segments,
                        opstamp=meta.opstamp,
                        payload=meta.payload,
                        settings=self.index.settings.to_json(),
                    )
                )
        finally:
            with self._pending_lock:
                self._merge_outputs.difference_update(out_files)
        self.garbage_collect_files()
        return merged_meta if merged_meta.num_docs() > 0 else None

    def _reapply_merge_deletes(
        self,
        merged_meta: SegmentMeta,
        chosen: list[SegmentMeta],
        live_by_id: dict[str, SegmentMeta],
        mappings,
        start_del_opstamps: dict[str, int | None],
    ) -> SegmentMeta:
        """If a source segment's delete generation advanced while the merge
        ran, project the newer alive bitsets through the merge doc mapping
        onto the merged segment (reference end_merge re-applies deletes
        committed during the merge)."""
        from ..index.segment_reader import SegmentReader

        alive = None
        del_opstamp = 0
        for seg, m in zip(chosen, mappings):
            cur = live_by_id[seg.segment_id]
            if cur.delete_opstamp is not None:
                del_opstamp = max(del_opstamp, cur.delete_opstamp)
            if cur.delete_opstamp == start_del_opstamps[seg.segment_id]:
                continue
            new_alive = SegmentReader(
                cur, self.index.directory, self.index.schema
            ).alive_bitset()
            if new_alive is None:
                continue
            merged_ids = m[np.nonzero(~new_alive)[0]]
            merged_ids = merged_ids[merged_ids >= 0]
            if len(merged_ids):
                if alive is None:
                    alive = np.ones(merged_meta.max_doc, dtype=bool)
                alive[merged_ids] = False
        if alive is None:
            return merged_meta
        num_deleted = int(merged_meta.max_doc - np.count_nonzero(alive))
        new_meta = SegmentMeta(
            segment_id=merged_meta.segment_id,
            max_doc=merged_meta.max_doc,
            delete_opstamp=del_opstamp,
            num_deleted_docs=num_deleted,
        )
        self.index.directory.write(
            new_meta.relative_path("del"),
            arrayio.save_arrays({"alive": alive.astype(np.uint8)}),
        )
        return new_meta

    def wait_merging_threads(self) -> None:
        """Join all background merge threads (reference
        `index_writer.rs` wait_merging_threads)."""
        for t in self._merge_threads:
            t.join()
        self._merge_threads = []

    def garbage_collect_files(self) -> list[str]:
        gc = getattr(self.index.directory, "garbage_collect", None)
        if gc is None:
            return []
        from ..index.segment_reader import live_reader_files

        # serialized under _meta_lock so no commit/merge swap interleaves
        # between reading meta and unlinking files
        with self._meta_lock:
            meta = self.index.load_metas()
            living: set[str] = set()
            for s in meta.segments:
                living.update(s.list_files())
            with self._pending_lock:
                # uncommitted worker segments + in-flight merge outputs
                for m, _ in self._pending_segments:
                    living.update(m.list_files())
                living.update(self._merge_outputs)
            # census: files still readable by live SegmentReaders from older
            # Searcher generations (reference Inventory, index_meta.rs:228)
            living.update(live_reader_files(self.index.directory))
            return gc(living)

    def commit_opstamp(self) -> int:
        return self._committed_opstamp

    def close(self) -> None:
        self.wait_merging_threads()
        if self.num_threads > 1 and self._workers:
            for _ in self._workers:
                self._queue.put(None)
            for t in self._workers:
                t.join()
            self._workers = []
        self._lock.release()

    def __del__(self):
        try:
            self._lock.release()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
