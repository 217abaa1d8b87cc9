"""SegmentWriter — builds one immutable segment from a stream of documents.

Counterpart of reference `src/indexer/segment_writer.rs:66` + the `stacker`
term-hash (we use a Python dict of term bytes -> per-term growing arrays; the
planned C++ arena hashmap drops in behind the same `serialize()` contract).

Output is a dict of component-name -> bytes (see `index/segment.py` for the
file naming), with postings laid out in the TPU block format
(`postings/format.py`).
"""

from __future__ import annotations

from collections import defaultdict
from functools import partial
from json import dumps as _dumps

import numpy as np

from ..fastfield import ColumnarWriter
from ..fieldnorm import fieldnorm_to_id
from ..postings.format import PostingsSerializer
from ..schema import FieldType, Schema
from ..schema.document import Document
from ..schema.term import Term, f64_to_u64, i64_to_u64, u64_to_bytes
from ..store import Compressor, StoreWriter
from ..termdict import TermDictionary
from ..tokenizer import TokenizerManager

_json_dumps = partial(_dumps, separators=(",", ":"))

#: JSON path separator / end-of-path markers (reference
#: `common/src/json_path_writer.rs`: \x01-separated path, \x00 end).
JSON_PATH_SEP = b"\x01"
JSON_END_OF_PATH = b"\x00"


class _TermPostings:
    """Per-term growing posting list (reference `Recorder`, `recorder.rs:62`)."""

    __slots__ = ("docs", "tfs", "positions")

    def __init__(self):
        self.docs: list[int] = []
        self.tfs: list[int] = []
        self.positions: list[int] = []

    def record(self, doc: int, positions: list[int] | None) -> None:
        if self.docs and self.docs[-1] == doc:
            self.tfs[-1] += 1
        else:
            self.docs.append(doc)
            self.tfs.append(1)
        if positions is not None:
            self.positions.extend(positions)


def encode_json_terms(path_prefix: bytes, value, out: list[tuple[bytes, str]]):
    """Flatten a JSON value into (term_suffix_bytes, token_text|None) pairs.

    Numeric/bool leaves encode inline; text leaves are returned for
    tokenization by the caller. Type bytes: s=str, i=i64, f=f64, o=bool.
    """
    if isinstance(value, dict):
        for k, v in value.items():
            sub = path_prefix + (JSON_PATH_SEP if path_prefix else b"") + k.encode("utf-8")
            encode_json_terms(sub, v, out)
    elif isinstance(value, list):
        for v in value:
            encode_json_terms(path_prefix, v, out)
    elif isinstance(value, bool):
        out.append((path_prefix + JSON_END_OF_PATH + b"o" + u64_to_bytes(int(value)), None))
    elif isinstance(value, int):
        out.append(
            (path_prefix + JSON_END_OF_PATH + b"i" + u64_to_bytes(i64_to_u64(value)), None)
        )
    elif isinstance(value, float):
        out.append(
            (path_prefix + JSON_END_OF_PATH + b"f" + u64_to_bytes(f64_to_u64(value)), None)
        )
    elif isinstance(value, str):
        out.append((path_prefix + JSON_END_OF_PATH + b"s", value))
    elif value is None:
        pass
    else:
        raise TypeError(f"unsupported json value: {type(value)}")


def _merge_postings(nd, ntf, npos, pd, ptf, ppos, has_positions):
    """Merge two sorted posting lists of one term (same doc may appear in
    both when a doc mixes ASCII/non-ASCII values): tf sums, positions merge
    sorted per doc."""
    if len(pd) == 0:
        return (
            np.asarray(nd, dtype=np.uint32),
            np.asarray(ntf, dtype=np.uint32),
            np.asarray(npos, dtype=np.uint32) if has_positions else None,
        )
    if len(nd) == 0:
        return (
            np.asarray(pd, dtype=np.uint32),
            np.asarray(ptf, dtype=np.uint32),
            np.asarray(ppos, dtype=np.uint32) if has_positions else None,
        )
    docs_all = np.union1d(nd, pd).astype(np.uint32)
    tfs_out = np.zeros(len(docs_all), dtype=np.uint32)
    n_idx = np.searchsorted(nd, docs_all)
    p_idx = np.searchsorted(pd, docs_all)
    n_found = (n_idx < len(nd)) & (nd[np.minimum(n_idx, max(len(nd) - 1, 0))] == docs_all)
    p_found = (p_idx < len(pd)) & (pd[np.minimum(p_idx, max(len(pd) - 1, 0))] == docs_all)
    tfs_out += np.where(n_found, ntf[np.minimum(n_idx, max(len(nd) - 1, 0))], 0).astype(np.uint32)
    tfs_out += np.where(p_found, ptf[np.minimum(p_idx, max(len(pd) - 1, 0))], 0).astype(np.uint32)
    pos_out = None
    if has_positions:
        ncum = np.zeros(len(ntf) + 1, dtype=np.int64)
        np.cumsum(ntf, out=ncum[1:])
        pcum = np.zeros(len(ptf) + 1, dtype=np.int64)
        np.cumsum(ptf, out=pcum[1:])
        parts = []
        for di, d in enumerate(docs_all):
            merged = []
            if n_found[di]:
                k = int(n_idx[di])
                merged.append(npos[int(ncum[k]) : int(ncum[k + 1])])
            if p_found[di]:
                k = int(p_idx[di])
                merged.append(ppos[int(pcum[k]) : int(pcum[k + 1])])
            seg = np.concatenate(merged) if merged else np.zeros(0, np.uint32)
            parts.append(np.sort(seg))
        pos_out = (
            np.concatenate(parts).astype(np.uint32)
            if parts
            else np.zeros(0, np.uint32)
        )
    return docs_all, tfs_out, pos_out


class SegmentWriter:
    def __init__(self, schema: Schema, tokenizers: TokenizerManager | None = None,
                 compressor: str = Compressor.ZSTD, use_native: bool = True,
                 sort_by_field: tuple[str, str] | None = None,
                 compress_dedicated_thread: bool = False):
        self.schema = schema
        self.tokenizers = tokenizers or TokenizerManager.default()
        self.sort_by_field = sort_by_field
        # when sorting, stored docs are buffered and written in mapped order
        self._stored_buffer: list[bytes] | None = [] if sort_by_field else None
        self._native = None
        if use_native:
            from ..native import NativeIndexerCore

            self._native = NativeIndexerCore.create()
        # field_id -> {term_bytes: _TermPostings}
        self._postings: dict[int, dict[bytes, _TermPostings]] = defaultdict(dict)
        # field_id -> ([doc_ids], [raw values]) — deferred numeric terms,
        # encoded vectorized at serialize time (`_numeric_exports`)
        self._pend_numeric: dict[int, tuple[list, list]] = {}
        # field_id -> {doc: num_tokens}
        self._fieldnorms: dict[int, dict[int, int]] = defaultdict(dict)
        # field_id -> total tokens subscribed (reference
        # `postings_writer.rs:215` counts one per subscribe)
        self._token_counts: dict[int, int] = defaultdict(int)
        self._columnar = ColumnarWriter()
        self._store = StoreWriter(
            compressor, dedicated_thread=compress_dedicated_thread
        )
        self._has_stored = any(e.is_stored() for e in schema.fields())
        self._stored_fields = {
            e.name for e in schema.fields() if e.is_stored()
        }
        self.max_doc = 0
        self._mem_hint = 0

    # -- ingestion -----------------------------------------------------------

    def add_document(self, doc: Document) -> int:
        doc_id = self.max_doc
        self.max_doc += 1
        for field_name, value in doc.field_values():
            entry = self.schema.get_field(field_name)
            ftype = entry.field_type
            if ftype == FieldType.TEXT:
                self._index_text(entry, doc_id, value)
            elif ftype in (FieldType.U64, FieldType.I64, FieldType.F64,
                           FieldType.BOOL, FieldType.DATE):
                self._index_numeric(entry, doc_id, value)
            elif ftype == FieldType.BYTES:
                if entry.is_indexed():
                    self._subscribe(entry.field_id, bytes(value), doc_id, None)
                if entry.is_fast():
                    self._columnar.record(doc_id, entry.name, bytes(value), "bytes")
            elif ftype == FieldType.FACET:
                self._index_facet(entry, doc_id, str(value))
            elif ftype == FieldType.JSON:
                self._index_json(entry, doc_id, value)
            elif ftype == FieldType.IP_ADDR:
                self._index_ip(entry, doc_id, value)
            else:
                raise TypeError(f"unhandled field type {ftype}")
        # every doc gets a (possibly empty) store row so doc ids stay aligned
        if self._stored_buffer is not None:
            self._stored_buffer.append(self._stored_payload(doc))
        elif self._has_stored:
            self._store.store_payload(self._stored_payload(doc))
        else:
            self._store.store_empty()
        self._mem_hint += 200 + sum(len(str(v)) for _, v in doc.field_values())
        return doc_id

    def add_documents(self, docs: list[Document]) -> list[int]:
        """Batched ingest: native-eligible text values (default analyzer,
        ASCII) across the whole batch ride ONE GIL-releasing C call per
        field (`indexer_index_text_batch`) — the per-call ctypes overhead
        was the multithreaded-scaling bottleneck at one call per doc."""
        if self._native is None:
            return [self.add_document(d) for d in docs]
        pend: dict[int, list] = {}  # field_id -> [(doc_id, text)]
        ids = []
        # per-field metadata resolved once per batch, not once per value
        meta: dict[str, tuple] = {}
        numeric_types = (FieldType.U64, FieldType.I64, FieldType.F64,
                         FieldType.BOOL, FieldType.DATE)
        mem = 0
        for doc in docs:
            doc_id = self.max_doc
            self.max_doc += 1
            ids.append(doc_id)
            for field_name, value in doc.field_values():
                m = meta.get(field_name)
                if m is None:
                    entry = self.schema.get_field(field_name)
                    ftype = entry.field_type
                    m = meta[field_name] = (
                        entry, ftype,
                        ftype in numeric_types and entry.is_indexed(),
                        ftype is FieldType.TEXT and entry.is_indexed()
                        and entry.tokenizer_name() == "default",
                        entry.is_fast(),
                        entry.field_id,
                        self._pend_numeric.setdefault(entry.field_id,
                                                      ([], []))
                        if ftype in numeric_types and entry.is_indexed()
                        else None,
                    )
                entry, ftype, num_idx, text_fast_ok, fast, fid, npend = m
                if ftype is FieldType.TEXT:
                    if not isinstance(value, str):
                        # PreTokenizedString (or str-able): order-dependent
                        # positions — land pending batched values first
                        self._flush_text_batch(fid, pend)
                        self._index_text(entry, doc_id, value)
                        mem += 32
                        continue
                    text = value
                    mem += len(text)
                    if text_fast_ok and text.isascii():
                        pend.setdefault(fid, []).append((doc_id, text))
                        if fast:
                            self._columnar.record(doc_id, entry.name,
                                                  text, "str")
                    else:
                        # position offsets are order-dependent: land any
                        # pending batched values of this field first
                        self._flush_text_batch(fid, pend)
                        self._index_text(entry, doc_id, text)
                elif num_idx:
                    mem += 24
                    npend[0].append(doc_id)
                    npend[1].append(value)
                    if fast:
                        self._columnar.record(doc_id, entry.name, value,
                                              ftype.value)
                elif ftype in numeric_types:
                    mem += 24
                    if fast:
                        self._columnar.record(doc_id, entry.name, value,
                                              ftype.value)
                elif ftype == FieldType.BYTES:
                    mem += len(value)
                    if entry.is_indexed():
                        self._subscribe(fid, bytes(value), doc_id, None)
                    if fast:
                        self._columnar.record(
                            doc_id, entry.name, bytes(value), "bytes"
                        )
                elif ftype == FieldType.FACET:
                    mem += len(str(value))
                    self._index_facet(entry, doc_id, str(value))
                elif ftype == FieldType.JSON:
                    mem += 64 + 32 * len(value)
                    self._index_json(entry, doc_id, value)
                elif ftype == FieldType.IP_ADDR:
                    mem += 24
                    self._index_ip(entry, doc_id, value)
                else:
                    raise TypeError(f"unhandled field type {ftype}")
            if self._stored_buffer is not None:
                self._stored_buffer.append(self._stored_payload(doc))
            elif self._has_stored:
                self._store.store_payload(self._stored_payload(doc))
            else:
                self._store.store_empty()
        self._mem_hint += mem + 200 * len(docs)
        for field_id in list(pend):
            self._flush_text_batch(field_id, pend)
        return ids

    def _flush_text_batch(self, field_id: int, pend: dict) -> None:
        entries = pend.pop(field_id, None)
        if not entries:
            return
        entry = self.schema.get_field_entry(field_id)
        fn = self._fieldnorms[field_id]
        doc_ids = np.fromiter(
            (d for d, _ in entries), np.uint32, len(entries)
        )
        prevs = np.fromiter(
            (fn.get(int(d), 0) for d, _ in entries), np.uint32, len(entries)
        )
        texts = [t.encode("ascii") for _, t in entries]
        kept = self._native.index_text_batch(
            field_id, doc_ids, prevs, texts,
            entry.index_record_option().has_positions(),
        )
        for (d, _), k in zip(entries, kept):
            fn[d] = fn.get(d, 0) + int(k)

    def _stored_payload(self, doc: Document) -> bytes:
        """Stored-row payload bytes for `doc` (the Document.from_json wire
        format) built in one pass — no intermediate Document, one schema-set
        membership test per value instead of a get_field lookup."""
        from ..tokenizer import PreTokenizedString

        stored = self._stored_fields
        out: dict = {}
        for f, v in doc.field_values():
            if f in stored:
                if isinstance(v, bytes):
                    import base64

                    v = {"__bytes__": base64.b64encode(v).decode("ascii")}
                elif isinstance(v, PreTokenizedString):
                    v = v.text  # stored form is the text (tokenized_string.rs)
                prev = out.get(f)
                if prev is None:
                    out[f] = [v]
                else:
                    prev.append(v)
        return _json_dumps(out).encode("utf-8")

    def _subscribe(self, field_id: int, term_bytes: bytes, doc_id: int,
                   positions: list[int] | None) -> None:
        self._token_counts[field_id] += 1
        postings = self._postings[field_id]
        rec = postings.get(term_bytes)
        if rec is None:
            rec = _TermPostings()
            postings[term_bytes] = rec
        rec.record(doc_id, positions)

    def _index_text(self, entry, doc_id: int, text) -> None:
        from ..tokenizer import PreTokenizedString

        if isinstance(text, PreTokenizedString):
            # caller-supplied tokens index verbatim; no analyzer runs
            if entry.is_indexed():
                self._index_tokens(entry, doc_id, text.tokens)
            if entry.is_fast():
                self._columnar.record(doc_id, entry.name, text.text, "str")
            return
        text = str(text)
        if entry.is_indexed():
            record = entry.index_record_option()
            # native fast path: default analyzer + pure-ASCII text
            if (
                self._native is not None
                and entry.tokenizer_name() == "default"
                and text.isascii()
            ):
                prev = self._fieldnorms[entry.field_id].get(doc_id, 0)
                kept = self._native.index_text(
                    entry.field_id, doc_id, text.encode("ascii"),
                    record.has_positions(), prev,
                )
                self._fieldnorms[entry.field_id][doc_id] = prev + kept
                if entry.is_fast():
                    self._columnar.record(doc_id, entry.name, text, "str")
                return
            analyzer = self.tokenizers.get(entry.tokenizer_name())
            if analyzer is None:
                raise KeyError(f"tokenizer not registered: {entry.tokenizer_name()}")
            num_tokens = 0
            # accumulate per-term in-doc positions, then subscribe once
            local: dict[bytes, list[int]] = {}
            prev_num_tokens = self._fieldnorms[entry.field_id].get(doc_id, 0)
            for tok in analyzer.token_stream(text):
                term_bytes = tok.text.encode("utf-8")
                local.setdefault(term_bytes, []).append(prev_num_tokens + tok.position)
                num_tokens += 1
            for term_bytes, positions in local.items():
                for p in positions:
                    self._subscribe(
                        entry.field_id, term_bytes, doc_id,
                        None,
                    )
                if record.has_positions():
                    self._postings[entry.field_id][term_bytes].positions.extend(positions)
            # tracked even without fieldnorms: doubles as the multi-value
            # position offset (arrays emitted only for has_fieldnorms fields)
            self._fieldnorms[entry.field_id][doc_id] = prev_num_tokens + num_tokens
        if entry.is_fast():
            self._columnar.record(doc_id, entry.name, text, "str")

    def _index_tokens(self, entry, doc_id: int, tokens) -> None:
        """Subscribe an explicit token sequence (PreTokenizedString path) —
        same position/fieldnorm bookkeeping as the analyzer loop."""
        record = entry.index_record_option()
        local: dict[bytes, list[int]] = {}
        prev_num_tokens = self._fieldnorms[entry.field_id].get(doc_id, 0)
        num_tokens = 0
        for tok in tokens:
            term_bytes = tok.text.encode("utf-8")
            local.setdefault(term_bytes, []).append(
                prev_num_tokens + tok.position
            )
            num_tokens += 1
        for term_bytes, positions in local.items():
            for _ in positions:
                self._subscribe(entry.field_id, term_bytes, doc_id, None)
            if record.has_positions():
                self._postings[entry.field_id][term_bytes].positions.extend(
                    positions
                )
        self._fieldnorms[entry.field_id][doc_id] = (
            prev_num_tokens + num_tokens
        )

    def _index_numeric(self, entry, doc_id: int, value) -> None:
        type_name = entry.field_type.value
        if entry.is_indexed():
            # deferred: (doc, value) pairs accumulate per field and are
            # encoded/sorted/grouped in ONE vectorized pass at serialize
            # time (`_numeric_exports`) — no per-value Term object, dict
            # probe or list append chain on the ingest hot path
            pend = self._pend_numeric.get(entry.field_id)
            if pend is None:
                pend = self._pend_numeric[entry.field_id] = ([], [])
            pend[0].append(doc_id)
            pend[1].append(value)
        if entry.is_fast():
            self._columnar.record(doc_id, entry.name, value, type_name)

    def _index_facet(self, entry, doc_id: int, path: str) -> None:
        if entry.is_indexed():
            analyzer = self.tokenizers.get("facet")
            for tok in analyzer.token_stream(path):
                self._subscribe(entry.field_id, tok.text.encode("utf-8"), doc_id, None)
        if entry.is_fast():
            self._columnar.record(doc_id, entry.name, path, "str")

    def _index_json(self, entry, doc_id: int, value) -> None:
        if not isinstance(value, dict):
            raise TypeError("json field expects a dict")
        if entry.is_fast():
            self._record_json_fast(entry, doc_id, value, ())
        if not entry.is_indexed():
            return
        leaves: list[tuple[bytes, str | None]] = []
        encode_json_terms(b"", value, leaves)
        analyzer = self.tokenizers.get(entry.tokenizer_name())
        has_positions = entry.index_record_option().has_positions()
        pos_base = self._fieldnorms[entry.field_id].get(doc_id, 0)
        pos = pos_base
        postings = self._postings[entry.field_id]
        for term_prefix, text in leaves:
            if text is None:
                self._subscribe(entry.field_id, term_prefix, doc_id, None)
                if has_positions:
                    postings[term_prefix].positions.append(pos)
                pos += 1
            else:
                for tok in analyzer.token_stream(text):
                    tb = term_prefix + tok.text.encode("utf-8")
                    self._subscribe(entry.field_id, tb, doc_id, None)
                    if has_positions:
                        postings[tb].positions.append(pos)
                    pos += 1
        if entry.has_fieldnorms():
            self._fieldnorms[entry.field_id][doc_id] = pos

    def _record_json_fast(self, entry, doc_id: int, value, path: tuple) -> None:
        """Dynamic per-path fast-field columns for a FAST json field
        (reference `columnar/src/columnar/writer/mod.rs:50` creates one
        column per JSON path; readers resolve `field.path` —
        `src/fastfield/readers.rs:64-101`). Column key =
        `field\\x01path\\x01...` (the JSON path separator of
        `common/src/json_path_writer.rs`). Mixed int/float leaves promote
        the column to f64; other type conflicts keep the first type and
        drop conflicting values (documented divergence — the reference
        keeps one column per (path, type))."""
        if isinstance(value, dict):
            for k, v in value.items():
                self._record_json_fast(entry, doc_id, v, path + (k,))
            return
        if isinstance(value, list):
            for v in value:
                self._record_json_fast(entry, doc_id, v, path)
            return
        if value is None or not path:
            return
        key = "\x01".join((entry.name,) + path)
        if isinstance(value, bool):
            tname, val = "bool", bool(value)
        elif isinstance(value, int):
            tname, val = "i64", int(value)
        elif isinstance(value, float):
            tname, val = "f64", float(value)
        elif isinstance(value, str):
            tname, val = "str", value
        else:
            return
        col = self._columnar._columns.get(key)
        if col is not None and col[0] != tname:
            have = col[0]
            if {have, tname} == {"i64", "f64"}:
                if have == "i64":  # promote the column to f64
                    self._columnar._columns[key] = (
                        "f64", [(d, float(v)) for d, v in col[1]]
                    )
                tname, val = "f64", float(val)
            else:
                return  # conflicting type: first wins
        self._columnar.record(doc_id, key, val, tname)

    def _index_ip(self, entry, doc_id: int, value) -> None:
        from ..schema.term import ip_to_bytes

        raw = ip_to_bytes(value)
        if entry.is_indexed():
            self._subscribe(entry.field_id, raw, doc_id, None)
        if entry.is_fast():
            self._columnar.record(doc_id, entry.name, raw, "bytes")

    def mem_usage(self) -> int:
        return self._mem_hint

    def _numeric_exports(self) -> dict[int, dict]:
        """Drain `_pend_numeric` into native-export-format dicts: per field
        ONE vectorized encode + lexsort + run-length group over all (doc,
        value) records, producing the sorted term stream
        `serialize_sorted_field` consumes. tf of a (term, doc) pair = how
        many times the doc recorded that value (multi-valued parity with
        the per-value `_subscribe` path this replaces)."""
        from ..schema.term import numeric_keys_u64

        out: dict[int, dict] = {}
        for field_id, (doc_list, val_list) in self._pend_numeric.items():
            entry = self.schema.get_field_entry(field_id)
            docs = np.asarray(doc_list, dtype=np.uint32)
            keys = numeric_keys_u64(val_list, entry.field_type.value)
            order = np.lexsort((docs, keys))
            keys, docs = keys[order], docs[order]
            n = len(docs)
            new_pair = np.empty(n, dtype=bool)
            new_pair[:1] = True
            new_pair[1:] = (keys[1:] != keys[:-1]) | (docs[1:] != docs[:-1])
            idx = np.nonzero(new_pair)[0]
            gdocs = docs[idx]
            gkeys = keys[idx]
            tfs = np.diff(np.append(idx, n)).astype(np.uint32)
            new_term = np.empty(len(gkeys), dtype=bool)
            new_term[:1] = True
            new_term[1:] = gkeys[1:] != gkeys[:-1]
            tidx = np.nonzero(new_term)[0]
            ukeys = gkeys[tidx]
            n_terms = len(ukeys)
            out[field_id] = {
                "n_terms": n_terms,
                # 8-byte big-endian keys = Term.value_bytes order
                "term_data": ukeys.astype(">u8").view(np.uint8),
                "term_offsets": np.arange(n_terms + 1, dtype=np.int64) * 8,
                "post_offsets": np.append(tidx, len(gkeys)).astype(np.int64),
                "docs": gdocs,
                "tfs": tfs,
                "positions": np.zeros(0, dtype=np.uint32),
                "total_tokens": n,
            }
        self._pend_numeric = {}
        return out

    # -- serialization -------------------------------------------------------

    def _sort_mapping(self) -> np.ndarray | None:
        """new_of_old[old_doc] = new_doc when index sorting is enabled
        (reference `doc_id_mapping.rs` sorted mapping)."""
        if self.sort_by_field is None or self.max_doc == 0:
            return None
        field, order = self.sort_by_field
        from ..fastfield import to_u64

        col = self._columnar._columns.get(field)
        keys = np.full(self.max_doc, np.iinfo(np.uint64).max, dtype=np.uint64)
        if col is not None:
            type_name, pairs = col
            for doc, value in pairs:
                keys[doc] = to_u64(value, type_name)
        if order == "desc":
            keys = np.iinfo(np.uint64).max - keys
        old_sorted = np.argsort(keys, kind="stable")  # stable: doc-id tiebreak
        new_of_old = np.empty(self.max_doc, dtype=np.int64)
        new_of_old[old_sorted] = np.arange(self.max_doc)
        return new_of_old

    def _apply_doc_mapping(self, new_of_old: np.ndarray) -> None:
        """Remap every in-memory structure to the sorted doc order. The
        native core (if any) is drained into the Python dicts first so the
        remap runs over one unified store."""
        if self._native is not None:
            for entry in self.schema.fields():
                exp = self._native.export_field(entry.field_id)
                if exp is None or exp["n_terms"] == 0:
                    continue
                postings = self._postings[entry.field_id]
                term_data = exp["term_data"].tobytes()
                toff, poff = exp["term_offsets"], exp["post_offsets"]
                tf_cum = np.zeros(len(exp["tfs"]) + 1, dtype=np.int64)
                np.cumsum(exp["tfs"], out=tf_cum[1:])
                for i in range(exp["n_terms"]):
                    tb = term_data[toff[i] : toff[i + 1]]
                    lo, hi = int(poff[i]), int(poff[i + 1])
                    rec = postings.get(tb)
                    if rec is None:
                        rec = _TermPostings()
                        postings[tb] = rec
                    # merge native postings into python rec (docs disjoint or
                    # overlapping -> use _merge_postings)
                    nd = exp["docs"][lo:hi]
                    ntf = exp["tfs"][lo:hi]
                    npos = exp["positions"][int(tf_cum[lo]) : int(tf_cum[hi])]
                    pd = np.asarray(rec.docs, dtype=np.uint32)
                    ptf = np.asarray(rec.tfs, dtype=np.uint32)
                    ppos = np.asarray(rec.positions, dtype=np.uint32)
                    has_pos = bool(len(npos)) or bool(len(ppos))
                    docs, tfs, pos = _merge_postings(
                        nd, ntf, npos, pd, ptf, ppos, has_pos
                    )
                    rec.docs = list(docs)
                    rec.tfs = list(tfs)
                    rec.positions = list(pos) if pos is not None else []
                self._token_counts[entry.field_id] += exp["total_tokens"]
            self._native = None  # drained
        self._apply_doc_mapping_py_only(new_of_old)

    def _apply_doc_mapping_py_only(self, new_of_old):
        for field_id, (doc_list, val_list) in self._pend_numeric.items():
            remapped = new_of_old[np.asarray(doc_list, dtype=np.int64)]
            # the drain re-sorts by (key, doc), so list order is free
            self._pend_numeric[field_id] = (remapped, val_list)
        for field_id, postings in self._postings.items():
            for rec in postings.values():
                docs = new_of_old[np.asarray(rec.docs, dtype=np.int64)]
                tfs = np.asarray(rec.tfs, dtype=np.uint32)
                order = np.argsort(docs, kind="stable")
                if rec.positions:
                    cum = np.zeros(len(tfs) + 1, dtype=np.int64)
                    np.cumsum(tfs, out=cum[1:])
                    pos = np.asarray(rec.positions, dtype=np.uint32)
                    rec.positions = list(
                        np.concatenate([pos[cum[i] : cum[i + 1]] for i in order])
                    )
                rec.docs = list(docs[order].astype(np.uint32))
                rec.tfs = list(tfs[order])
        self._remap_norms_cols_store(new_of_old)

    def _remap_norms_cols_store(self, new_of_old):
        for field_id, per_doc in self._fieldnorms.items():
            self._fieldnorms[field_id] = {
                int(new_of_old[d]): n for d, n in per_doc.items()
            }
        for field, (type_name, pairs) in self._columnar._columns.items():
            self._columnar._columns[field] = (
                type_name,
                [(int(new_of_old[d]), v) for d, v in pairs],
            )
        if self._stored_buffer is not None:
            order = np.argsort(new_of_old)  # old doc for each new id
            for old in order:
                self._store.store_payload(self._stored_buffer[int(old)])
            self._stored_buffer = None

    def serialize(self) -> dict[str, dict[str, np.ndarray]]:
        """Returns component -> arrays: {"idx", "term", "fieldnorm", "fast",
        "store"}."""
        mapping = self._sort_mapping()
        if mapping is not None:
            self._apply_doc_mapping(mapping)
        elif self._stored_buffer is not None:
            for payload in self._stored_buffer:
                self._store.store_payload(payload)
            self._stored_buffer = None
        max_doc = self.max_doc
        fieldnorm_arrays: dict[str, np.ndarray] = {}
        norm_ids_by_field: dict[int, np.ndarray] = {}
        total_tokens: dict[int, int] = dict(self._token_counts)
        for field_id, per_doc in self._fieldnorms.items():
            entry = self.schema.get_field_entry(field_id)
            if not entry.has_fieldnorms():
                continue
            ids = np.zeros(max_doc, dtype=np.uint8)
            for d, n in per_doc.items():
                ids[d] = fieldnorm_to_id(n)
            fieldnorm_arrays[str(field_id)] = ids
            norm_ids_by_field[field_id] = ids

        # native core exports (sorted terms + postings arrays per field)
        native_exports: dict[int, dict] = {}
        if self._native is not None:
            for entry in self.schema.fields():
                exp = self._native.export_field(entry.field_id)
                if exp is not None and exp["n_terms"] > 0:
                    native_exports[entry.field_id] = exp
                    total_tokens[entry.field_id] = (
                        total_tokens.get(entry.field_id, 0) + exp["total_tokens"]
                    )
        # deferred numeric fields export the same sorted-stream format
        # (disjoint from native text fields by construction)
        for field_id, exp in self._numeric_exports().items():
            native_exports[field_id] = exp
            total_tokens[field_id] = (
                total_tokens.get(field_id, 0) + exp["total_tokens"]
            )

        idx_arrays: dict[str, np.ndarray] = {}
        term_arrays: dict[str, np.ndarray] = {}
        field_ids = sorted(set(self._postings) | set(native_exports))
        for field_id in field_ids:
            entry = self.schema.get_field_entry(field_id)
            has_freqs = entry.index_record_option().has_freq()
            has_positions = entry.index_record_option().has_positions()
            norm_ids = norm_ids_by_field.get(field_id)
            if norm_ids is None and entry.is_indexed():
                # no-fieldnorm fields score with constant fieldnorm 1; the
                # block-max pair must use the same id or pruning is unsafe
                norm_ids = np.ones(max_doc, dtype=np.uint8)
            tot = total_tokens.get(field_id, 0)
            avg = (tot / max_doc) if max_doc else 0.0
            ser = PostingsSerializer(
                avg_fieldnorm=avg,
                fieldnorm_ids=norm_ids,
                has_freqs=has_freqs,
            )
            exp = native_exports.get(field_id)
            if exp is not None and not self._postings.get(field_id):
                # native-only field (the common case for default-tokenizer
                # ASCII text): ONE vectorized pass over the whole sorted
                # term stream — no per-term Python loop (the round-3
                # indexing bottleneck, GIL-bound at ~12k docs/s)
                ser.serialize_sorted_field(
                    exp["post_offsets"],
                    exp["docs"],
                    exp["tfs"],
                    exp["positions"] if has_positions else None,
                )
                term_data = exp["term_data"].tobytes()
                toff = exp["term_offsets"]
                sorted_terms = [
                    term_data[toff[i] : toff[i + 1]]
                    for i in range(exp["n_terms"])
                ]
            else:
                sorted_terms = []
                for term_bytes, docs, tfs, pos in self._merged_term_stream(
                    field_id, exp, has_positions
                ):
                    ser.serialize_term(docs, tfs, pos)
                    sorted_terms.append(term_bytes)
            arrays = ser.finish()
            arrays["total_num_tokens"] = np.asarray([tot], dtype=np.int64)
            for k, v in arrays.items():
                idx_arrays[f"{field_id}/{k}"] = v
            td = TermDictionary.from_sorted_terms(sorted_terms)
            for k, v in td.to_arrays().items():
                term_arrays[f"{field_id}/{k}"] = v

        return {
            "idx": idx_arrays,
            "term": term_arrays,
            "fieldnorm": fieldnorm_arrays,
            "fast": self._columnar.serialize(max_doc),
            "store": self._store.finish(),
        }

    def _merged_term_stream(self, field_id: int, native_exp: dict | None,
                            has_positions: bool):
        """Yields (term_bytes, docs, tfs, positions) in sorted term order,
        merging the native core's export with the Python-side postings."""
        py = self._postings.get(field_id, {})
        py_terms = sorted(py)

        def py_rec(term_bytes):
            rec = py[term_bytes]
            docs = np.asarray(rec.docs, dtype=np.uint32)
            tfs = np.asarray(rec.tfs, dtype=np.uint32)
            pos = (
                np.asarray(rec.positions, dtype=np.uint32) if has_positions else None
            )
            return docs, tfs, pos

        if native_exp is None:
            for tb in py_terms:
                yield (tb, *py_rec(tb))
            return

        term_data = native_exp["term_data"].tobytes()
        toff = native_exp["term_offsets"]
        poff = native_exp["post_offsets"]
        n_docs_arr = native_exp["docs"]
        n_tfs_arr = native_exp["tfs"]
        n_pos_arr = native_exp["positions"]
        n_terms = native_exp["n_terms"]
        # per-term position offsets = cumsum of tfs at posting boundaries
        tf_cum = np.zeros(len(n_tfs_arr) + 1, dtype=np.int64)
        np.cumsum(n_tfs_arr, out=tf_cum[1:])

        def native_rec(i):
            lo, hi = int(poff[i]), int(poff[i + 1])
            docs = n_docs_arr[lo:hi]
            tfs = n_tfs_arr[lo:hi]
            pos = (
                n_pos_arr[int(tf_cum[lo]) : int(tf_cum[hi])] if has_positions else None
            )
            return docs, tfs, pos

        i, j = 0, 0
        while i < n_terms or j < len(py_terms):
            nt = term_data[toff[i] : toff[i + 1]] if i < n_terms else None
            pt = py_terms[j] if j < len(py_terms) else None
            if pt is None or (nt is not None and nt < pt):
                yield (nt, *native_rec(i))
                i += 1
            elif nt is None or pt < nt:
                yield (pt, *py_rec(pt))
                j += 1
            else:
                # same term on both sides: merge doc-wise
                nd, ntf, npos = native_rec(i)
                pd, ptf, ppos = py_rec(pt)
                yield (nt, *_merge_postings(nd, ntf, npos, pd, ptf, ppos,
                                            has_positions))
                i += 1
                j += 1
