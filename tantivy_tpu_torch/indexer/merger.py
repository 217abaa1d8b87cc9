"""IndexMerger — merge N segments into one, dropping deleted docs (reference
`src/indexer/merger.rs:116,950`).

Doc-id mapping is "stacked": alive docs of segment 0 first, then segment 1,
etc., each compacted (reference stacked mapping, `doc_id_mapping.rs`). Terms
are k-way merged across per-segment term dictionaries; postings are decoded,
remapped, and re-serialized through the block serializer so all block/skip/
block-max metadata is rebuilt against the merged segment's average fieldnorm.
"""

from __future__ import annotations

import numpy as np

from ..fastfield import ColumnarWriter
from ..fieldnorm import FIELD_NORMS_TABLE
from ..postings.format import PostingsSerializer
from ..schema import FieldType, Schema
from ..store import Compressor, StoreWriter
from ..termdict import TermDictionary


class IndexMerger:
    def __init__(self, schema: Schema, segment_readers: list,
                 sort_by_field: tuple[str, str] | None = None):
        self.schema = schema
        self.readers = segment_readers
        self.sort_by_field = sort_by_field

    def _doc_mappings(self):
        """per-segment old_doc -> new_doc (int64, -1 for deleted), and new
        max_doc. Stacked by default; k-way merged by sort key when the index
        is sorted (reference `doc_id_mapping.rs`)."""
        if self.sort_by_field is not None:
            return self._sorted_doc_mappings()
        mappings = []
        next_id = 0
        for r in self.readers:
            m = np.full(r.max_doc, -1, dtype=np.int64)
            alive = r.doc_ids_alive()
            m[alive] = np.arange(next_id, next_id + len(alive), dtype=np.int64)
            next_id += len(alive)
            mappings.append(m)
        return mappings, next_id

    def _sorted_doc_mappings(self):
        field, order = self.sort_by_field
        keys_parts, seg_parts, doc_parts = [], [], []
        for seg_i, r in enumerate(self.readers):
            alive = r.doc_ids_alive()
            col = r.fast_fields().column(field)
            keys = np.full(len(alive), np.iinfo(np.uint64).max, dtype=np.uint64)
            if col is not None:
                from ..fastfield import CARD_FULL

                if col.cardinality == CARD_FULL:
                    keys = col.values[alive]
                else:
                    for i, d in enumerate(alive):
                        if col.has_value(int(d)):
                            from ..fastfield import to_u64

                            v = col.values_for_doc(int(d))[0]
                            keys[i] = to_u64(v, col.type_name)
            if order == "desc":
                keys = np.iinfo(np.uint64).max - keys
            keys_parts.append(keys)
            seg_parts.append(np.full(len(alive), seg_i, dtype=np.int64))
            doc_parts.append(alive.astype(np.int64))
        keys = np.concatenate(keys_parts) if keys_parts else np.zeros(0, np.uint64)
        segs = np.concatenate(seg_parts) if seg_parts else np.zeros(0, np.int64)
        docs = np.concatenate(doc_parts) if doc_parts else np.zeros(0, np.int64)
        # tie-break: (key, segment ord, old doc) — stable sort over
        # concatenation in (seg, doc) order achieves it
        perm = np.argsort(keys, kind="stable")
        mappings = [np.full(r.max_doc, -1, dtype=np.int64) for r in self.readers]
        for new_id, p in enumerate(perm):
            mappings[int(segs[p])][int(docs[p])] = new_id
        return mappings, len(perm)

    def write(self) -> dict[str, dict[str, np.ndarray]]:
        mappings, max_doc = self._doc_mappings()
        # kept so the caller can re-apply deletes that advance on a source
        # segment while a background merge runs (reference end_merge /
        # advance_deletes semantics, segment_updater.rs:617)
        self.mappings = mappings

        # fieldnorms ----------------------------------------------------------
        fieldnorm_arrays: dict[str, np.ndarray] = {}
        total_tokens: dict[int, int] = {}
        norm_ids_by_field: dict[int, np.ndarray] = {}
        for entry in self.schema.fields():
            if not (entry.is_indexed() and entry.has_fieldnorms()):
                continue
            ids = np.zeros(max_doc, dtype=np.uint8)
            for r, m in zip(self.readers, mappings):
                src = r.fieldnorms(entry.name)
                alive = m >= 0
                ids[m[alive]] = src[alive]
            fieldnorm_arrays[str(entry.field_id)] = ids
            norm_ids_by_field[entry.field_id] = ids
            total_tokens[entry.field_id] = int(
                FIELD_NORMS_TABLE[ids].astype(np.int64).sum()
            )

        # postings ------------------------------------------------------------
        idx_arrays: dict[str, np.ndarray] = {}
        term_arrays: dict[str, np.ndarray] = {}
        for entry in self.schema.fields():
            if not entry.is_indexed():
                continue
            fid = entry.field_id
            invs = [r.inverted_index(entry.name) for r in self.readers]
            if all(inv.num_terms() == 0 for inv in invs):
                continue
            has_freqs = entry.index_record_option().has_freq()
            has_positions = entry.index_record_option().has_positions()
            tot = total_tokens.get(fid)
            if tot is None:
                # no fieldnorms (e.g. numeric): recompute token total as sum
                tot = sum(inv.total_num_tokens() for inv in invs)
            avg = (tot / max_doc) if max_doc else 0.0
            ser = PostingsSerializer(
                avg_fieldnorm=avg,
                fieldnorm_ids=norm_ids_by_field.get(fid),
                has_freqs=has_freqs,
            )
            # merged sorted term stream (reference TermMerger k-way heap;
            # host-side term dicts make a flat sort equally correct). The
            # postings themselves merge fully VECTORIZED: one whole-field
            # decode per source (`decode_field_host`), doc remap + alive
            # filter as array ops, one (term, doc) lexsort, and ONE
            # `serialize_sorted_field` pass — no per-term Python loop.
            from ..postings.format import decode_field_host

            all_terms: list[tuple[bytes, int, int]] = []
            for seg_i, inv in enumerate(invs):
                for ord_, term in inv.termdict.stream():
                    all_terms.append((term, seg_i, ord_))
            all_terms.sort(key=lambda x: (x[0], x[1]))
            gterms: list[bytes] = []
            seg_gid = [
                np.zeros(inv.num_terms(), dtype=np.int64) for inv in invs
            ]
            for term, seg_i, ord_ in all_terms:
                if not gterms or gterms[-1] != term:
                    gterms.append(term)
                seg_gid[seg_i][ord_] = len(gterms) - 1

            tid_p, docs_p, tfs_p, src_p, posflat_p = [], [], [], [], []
            pos_base = 0
            for seg_i, inv in enumerate(invs):
                poff, docs, tfs = decode_field_host(inv.arrays)
                new_docs = mappings[seg_i][docs]
                alive = new_docs >= 0
                dfv = np.diff(poff)
                tid = np.repeat(seg_gid[seg_i], dfv)
                if has_positions:
                    # per-posting start of its position chunk, in a global
                    # concatenated position space
                    tps = inv.arrays["term_pos_start"].astype(np.int64)
                    cum = np.zeros(len(tfs) + 1, dtype=np.int64)
                    np.cumsum(tfs, out=cum[1:])
                    src = (
                        np.repeat(tps - cum[poff[:-1]], dfv) + cum[:-1]
                    )
                    src_p.append(pos_base + src[alive])
                    posflat_p.append(
                        np.asarray(inv.arrays["positions"], dtype=np.uint32)
                    )
                    pos_base += len(posflat_p[-1])
                tid_p.append(tid[alive])
                docs_p.append(new_docs[alive].astype(np.uint32))
                tfs_p.append(tfs[alive].astype(np.uint32))
            tid = np.concatenate(tid_p) if tid_p else np.zeros(0, np.int64)
            docs = np.concatenate(docs_p) if docs_p else \
                np.zeros(0, np.uint32)
            tfs = np.concatenate(tfs_p) if tfs_p else np.zeros(0, np.uint32)
            order = np.lexsort((docs, tid))
            tid, docs, tfs = tid[order], docs[order], tfs[order]
            counts = np.bincount(tid, minlength=len(gterms))
            nz = counts > 0
            merged_terms = [t for t, k in zip(gterms, nz) if k]
            poff_out = np.zeros(int(nz.sum()) + 1, dtype=np.int64)
            np.cumsum(counts[nz], out=poff_out[1:])
            positions = None
            if has_positions:
                src = np.concatenate(src_p) if src_p else \
                    np.zeros(0, np.int64)
                src = src[order]
                pos_all = (
                    np.concatenate(posflat_p) if posflat_p
                    else np.zeros(0, np.uint32)
                )
                lens = tfs.astype(np.int64)
                total = int(lens.sum())
                outc = np.zeros(len(lens) + 1, dtype=np.int64)
                np.cumsum(lens, out=outc[1:])
                out_idx = (
                    np.repeat(src - outc[:-1], lens)
                    + np.arange(total, dtype=np.int64)
                )
                positions = pos_all[out_idx]
            ser.serialize_sorted_field(poff_out, docs, tfs, positions)

            arrays = ser.finish()
            arrays["total_num_tokens"] = np.asarray([tot], dtype=np.int64)
            for k, v in arrays.items():
                idx_arrays[f"{fid}/{k}"] = v
            td = TermDictionary.from_sorted_terms(merged_terms)
            for k, v in td.to_arrays().items():
                term_arrays[f"{fid}/{k}"] = v

        # fast fields ---------------------------------------------------------
        # every stored column merges — enumerated from the readers, NOT the
        # schema, so JSON dynamic per-path columns survive merges too
        # (reference `columnar/merge/mod.rs:77` merges the columnar files'
        # actual column sets). Raw u64 slices transfer wholesale via
        # `record_raw`: no per-(doc, value) Python objects.
        from ..fastfield import CARD_FULL, CARD_OPTIONAL

        columnar = ColumnarWriter()
        col_names: list[str] = []
        for r in self.readers:
            for nm in r.fast_fields().column_fields():
                if nm not in col_names:
                    col_names.append(nm)
        for nm in col_names:
            for r, m in zip(self.readers, mappings):
                col = r.fast_fields().column(nm)
                if col is None:
                    continue
                if col.cardinality == CARD_FULL:
                    old = np.arange(r.max_doc, dtype=np.int64)
                elif col.cardinality == CARD_OPTIONAL:
                    old = col.present_docs.astype(np.int64)
                else:
                    counts = np.diff(col.offsets)
                    old = np.repeat(
                        np.arange(r.max_doc, dtype=np.int64), counts
                    )
                new = m[old]
                keep = new >= 0
                terms = None
                if col.dictionary is not None:
                    terms = [
                        col.dictionary.term(i)
                        for i in range(len(col.dictionary))
                    ]
                columnar.record_raw(
                    nm, col.type_name, new[keep], col.values[keep], terms
                )

        # store ---------------------------------------------------------------
        store = StoreWriter(Compressor.ZSTD)
        if self.sort_by_field is not None:
            # mapped order: old (seg, doc) for each new id
            old_of_new: list[tuple[int, int] | None] = [None] * max_doc
            for seg_i, m in enumerate(mappings):
                for old_doc, new_doc in enumerate(m):
                    if new_doc >= 0:
                        old_of_new[int(new_doc)] = (seg_i, old_doc)
            readers_docs = [list(r.store_reader().iter_documents()) for r in self.readers]
            for entry_ in old_of_new:
                seg_i, old_doc = entry_
                store.store(readers_docs[seg_i][old_doc])
        else:
            for r in self.readers:
                sr = r.store_reader()
                if not r.has_deletes():
                    for compressed, first, ndocs in sr.iter_raw_blocks():
                        store.store_raw_block(compressed, first, ndocs)
                else:
                    alive = r.alive_bitset()
                    for old_doc, doc in enumerate(sr.iter_documents()):
                        if alive[old_doc]:
                            store.store(doc)

        return {
            "idx": idx_arrays,
            "term": term_arrays,
            "fieldnorm": fieldnorm_arrays,
            "fast": columnar.serialize(max_doc),
            "store": store.finish(),
        }, max_doc
