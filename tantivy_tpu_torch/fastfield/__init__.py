"""Fast fields (columnar storage) — counterpart of reference `columnar/` +
`src/fastfield/`.

A column = cardinality index x values (reference `columnar/src/lib.rs:82-95`):

* FULL     — one value per doc: dense `values[max_doc]`
* OPTIONAL — 0..1 value per doc: `values[n]` + sorted `present_docs[n]`
  (rank = searchsorted, the device-friendly form of the reference's
  dense/sparse rank-select blocks)
* MULTI    — any number: `values[total]` + `offsets[max_doc+1]`

All numeric types are stored as order-preserving u64 (monotonic mapping,
reference `columnar/src/column_values/monotonic_mapping.rs`): i64/date via
sign-flip, f64 via sign-magnitude-to-biased, bool as 0/1. Str/bytes columns are
dictionary-encoded: per-field sorted dict + a u64 term-ord column (reference
`columnar/src/column/dictionary_encoded.rs`). Dense u64 arrays live in HBM for
range queries and aggregations — this is the most directly TPU-friendly piece
of the index.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..schema.term import f64_to_u64, i64_to_u64, u64_to_f64, u64_to_i64
from ..termdict import TermDictionary

CARD_FULL = 0
CARD_OPTIONAL = 1
CARD_MULTI = 2

#: value codecs (reference `columnar/src/column_values/u64_based/mod.rs`
#: auto-selects Bitpacked / Linear / BlockwiseLinear by estimated size; we
#: implement all three — BlockwiseLinear fits a line per 512-value block
#: (reference `blockwise_linear.rs`), winning on locally-linear columns
#: with global kinks (monotonic timestamps with rate changes)
CODEC_RAW = 0
CODEC_BITPACKED = 1
CODEC_LINEAR = 2
CODEC_BLOCKWISE = 3
_BW_BLOCK = 512


def _blockwise_encode(vals: np.ndarray):
    """Per-512-block line fit + bitpacked residuals. Returns
    (total_bits_estimate, arrays) or (inf, None) when inapplicable."""
    from ..common import bitpack

    n = len(vals)
    if n < 2 * _BW_BLOCK or int(vals.max()) >= (1 << 62):
        return float("inf"), None
    nblk = -(-n // _BW_BLOCK)
    meta = np.zeros((nblk, 4), dtype=np.uint64)  # v0, slope, rmin+bias, bits
    packed_parts = []
    total_bits = nblk * 4 * 64
    resids = []
    for b in range(nblk):
        v = vals[b * _BW_BLOCK : (b + 1) * _BW_BLOCK]
        m = len(v)
        slope = (float(v[-1]) - float(v[0])) / (m - 1) if m > 1 else 0.0
        pred = (
            float(v[0]) + slope * np.arange(m, dtype=np.float64)
        ).astype(np.int64)
        resid = v.astype(np.int64) - pred
        rmin = int(resid.min())
        rspan = int(resid.max()) - rmin
        if not 0 <= rspan < (1 << 32):
            return float("inf"), None
        bits = bitpack.bits_required(rspan)
        meta[b] = (
            np.uint64(v[0]),
            np.float64(slope).view(np.uint64),
            np.uint64(rmin + (1 << 63)),
            np.uint64(bits),
        )
        resids.append((resid - rmin).astype(np.uint32))
        total_bits += m * bits + 32  # + word-alignment slack
    for b in range(nblk):
        packed_parts.append(
            bitpack.pack(resids[b], int(meta[b, 3])) if int(meta[b, 3])
            else np.zeros(0, dtype=np.uint32)
        )
    lens = np.array([len(p) for p in packed_parts], dtype=np.uint64)
    arrays = {
        "vmeta": np.asarray([CODEC_BLOCKWISE, 0, 0, n], dtype=np.uint64),
        "values": (
            np.concatenate(packed_parts)
            if packed_parts else np.zeros(0, dtype=np.uint32)
        ),
        "vblk": meta.reshape(-1),
        "vblkoff": np.concatenate([[0], np.cumsum(lens)]).astype(np.uint64),
    }
    return total_bits, arrays


def _blockwise_decode(arrays: dict, prefix: str, n: int) -> np.ndarray:
    from ..common import bitpack

    meta = arrays[prefix + "vblk"].reshape(-1, 4)
    offs = arrays[prefix + "vblkoff"]
    words = arrays[prefix + "values"]
    nblk = meta.shape[0]
    out = np.zeros(n, dtype=np.uint64)
    for b in range(nblk):
        lo = b * _BW_BLOCK
        m = min(_BW_BLOCK, n - lo)
        v0, slope_bits, rbias, bits = (int(x) for x in meta[b])
        slope = np.uint64(slope_bits).view(np.float64)
        pred = (
            float(np.uint64(v0)) + slope * np.arange(m, dtype=np.float64)
        ).astype(np.int64)
        rmin = rbias - (1 << 63)
        resid = (
            bitpack.unpack(
                words[int(offs[b]) : int(offs[b + 1])], bits, m
            ).astype(np.int64)
            + rmin
            if bits
            else np.full(m, rmin, dtype=np.int64)
        )
        out[lo : lo + m] = (pred + resid).astype(np.uint64)
    return out


def _codec_encode(vals: np.ndarray) -> dict[str, np.ndarray]:
    """Pick the cheapest codec for a u64 column. Returns the arrays to
    store, always including 'vmeta' = [codec, bits, p0, p1]."""
    from ..common import bitpack

    n = len(vals)
    raw = {
        "vmeta": np.asarray([CODEC_RAW, 64, 0, 0], dtype=np.uint64),
        "values": vals,
    }
    if n == 0:
        return raw
    vmin = np.uint64(vals.min())
    span = int(vals.max() - vmin)
    bp_bits = bitpack.bits_required(span) if span < (1 << 32) else 64
    # linear: residuals from an integer line through (0, v0) .. (n-1, vlast)
    # (int64 residual math needs headroom: skip when the top bit is in play)
    lin_bits = 64
    if n > 2 and int(vals.max()) < (1 << 62):
        idx = np.arange(n, dtype=np.float64)
        slope = (float(vals[-1]) - float(vals[0])) / (n - 1)
        pred = (float(vals[0]) + slope * idx).astype(np.int64)
        resid = vals.astype(np.int64) - pred
        rmin = int(resid.min())
        rspan = int(resid.max()) - rmin
        if 0 <= rspan < (1 << 32):
            lin_bits = bitpack.bits_required(rspan)
    bw_bits, bw_arrays = _blockwise_encode(vals)
    bw_bits_per_val = bw_bits / n
    best = min(bp_bits, lin_bits, bw_bits_per_val, 64)
    if best >= 64:
        return raw
    if bw_bits_per_val < min(bp_bits, lin_bits):
        return bw_arrays
    if bp_bits <= lin_bits:
        packed = bitpack.pack((vals - vmin).astype(np.uint32), bp_bits)
        return {
            "vmeta": np.asarray(
                [CODEC_BITPACKED, bp_bits, int(vmin), n], dtype=np.uint64
            ),
            "values": packed,
        }
    packed = bitpack.pack((resid - rmin).astype(np.uint32), lin_bits)
    return {
        "vmeta": np.asarray(
            [CODEC_LINEAR, lin_bits, np.uint64(rmin + (1 << 63)), n],
            dtype=np.uint64,
        ),
        "values": packed,
        "vline": np.asarray(
            [np.uint64(vals[0]), np.float64(slope).view(np.uint64)],
            dtype=np.uint64,
        ),
    }


def _codec_decode(arrays: dict, prefix: str) -> np.ndarray:
    """Inverse of `_codec_encode`; returns the dense u64 values array."""
    from ..common import bitpack

    vmeta = arrays.get(prefix + "vmeta")
    vals = arrays[prefix + "values"]
    if vmeta is None or int(vmeta[0]) == CODEC_RAW:
        return np.ascontiguousarray(vals, dtype=np.uint64)
    codec, bits, p0, n = (int(x) for x in vmeta)
    if codec == CODEC_BITPACKED:
        return bitpack.unpack(vals, bits, n).astype(np.uint64) + np.uint64(p0)
    if codec == CODEC_BLOCKWISE:
        return _blockwise_decode(arrays, prefix, n)
    # CODEC_LINEAR
    v0, slope_bits = (int(x) for x in arrays[prefix + "vline"])
    slope = np.uint64(slope_bits).view(np.float64)
    rmin = p0 - (1 << 63)
    pred = (float(v0) + slope * np.arange(n, dtype=np.float64)).astype(np.int64)
    resid = bitpack.unpack(vals, bits, n).astype(np.int64) + rmin
    return (pred + resid).astype(np.uint64)

_TYPE_CODES = {"u64": 0, "i64": 1, "f64": 2, "bool": 3, "date": 4, "str": 5, "bytes": 6, "ip": 7}
_TYPE_NAMES = {v: k for k, v in _TYPE_CODES.items()}


def to_u64(value, type_name: str) -> int:
    # NOTE: IPs are NOT u64-coercible (IPv6 > 2^64); they are stored as
    # dictionary-encoded 16-byte keys (see SegmentWriter._index_ip), whose
    # sorted dictionary is the order-preserving compact space.
    if type_name == "u64":
        return int(value)
    if type_name in ("i64", "date"):
        return i64_to_u64(int(value))
    if type_name == "f64":
        return f64_to_u64(float(value))
    if type_name == "bool":
        return 1 if value else 0
    raise TypeError(type_name)


def from_u64(value: int, type_name: str):
    if type_name == "u64":
        return int(value)
    if type_name in ("i64", "date"):
        return u64_to_i64(int(value))
    if type_name == "f64":
        return u64_to_f64(int(value))
    if type_name == "bool":
        return bool(value)
    raise TypeError(type_name)


class ColumnarWriter:
    """Reference `columnar/src/columnar/writer/mod.rs:50`."""

    def __init__(self):
        # field -> (type_name, list[(doc, value)])
        self._columns: dict[str, tuple[str, list]] = {}

    def record(self, doc: int, field: str, value, type_name: str) -> None:
        col = self._columns.get(field)
        if col is None:
            col = (type_name, [])
            self._columns[field] = col
        elif col[0] != type_name:
            raise TypeError(f"type mismatch on column {field}: {col[0]} vs {type_name}")
        col[1].append((doc, value))

    def record_raw(self, field: str, type_name: str, docs, raw,
                   terms: list | None = None) -> None:
        """Bulk-append one source column's (already-encoded) slice — the
        merge path: `docs` are NEW doc ids (any order), `raw` u64 encoded
        values; for dict columns `raw` holds ordinals into `terms` (that
        source's sorted term table). No per-value Python objects."""
        parts = getattr(self, "_raw", None)
        if parts is None:
            parts = self._raw = {}
        parts.setdefault(field, []).append(
            (type_name,
             np.asarray(docs, dtype=np.uint32),
             np.asarray(raw, dtype=np.uint64),
             terms)
        )

    def serialize(self, max_doc: int) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {}
        raw_cols = getattr(self, "_raw", {})
        fields = list(self._columns) + [
            f for f in raw_cols if f not in self._columns
        ]
        for field in fields:
            type_name, pairs = self._columns.get(field, (None, []))
            parts = raw_cols.get(field, [])
            if type_name is None:
                type_name = parts[0][0]
            if any(p[0] != type_name for p in parts):
                raise TypeError(f"type mismatch on column {field}")
            prefix = f"col/{field}/"
            is_bytes_like = type_name in ("str", "bytes")
            doc_chunks = [np.array([d for d, _ in pairs], dtype=np.uint32)]
            doc_chunks.extend(p[1] for p in parts)
            docs = np.concatenate(doc_chunks)
            if len(docs) == 0:
                # a merged column whose docs were all deleted emits NOTHING
                # (no orphan dict arrays without meta/values)
                continue
            if is_bytes_like:
                raw_vals = [
                    v.encode("utf-8") if isinstance(v, str) else bytes(v)
                    for _, v in pairs
                ]
                term_set = set(raw_vals)
                for _, _, _, terms in parts:
                    term_set.update(terms or [])
                dict_terms = sorted(term_set)
                ord_of = {t: i for i, t in enumerate(dict_terms)}
                td = TermDictionary.from_sorted_terms(dict_terms)
                for k, v in td.to_arrays().items():
                    out[prefix + "dict_" + k] = v
                val_chunks = [np.array(
                    [ord_of[v] for v in raw_vals], dtype=np.uint64
                )]
                for _, _, raw, terms in parts:
                    remap = np.array(
                        [ord_of[t] for t in (terms or [])], dtype=np.uint64
                    )
                    val_chunks.append(remap[raw.astype(np.int64)])
            else:
                val_chunks = [np.array(
                    [to_u64(v, type_name) for _, v in pairs], dtype=np.uint64
                )]
                val_chunks.extend(p[2] for p in parts)
            u64_vals = np.concatenate(val_chunks)

            # choose cardinality
            n = len(docs)
            distinct = len(np.unique(docs))
            if distinct < n:
                card = CARD_MULTI
            elif n == max_doc:
                card = CARD_FULL
            else:
                card = CARD_OPTIONAL

            order = np.argsort(docs, kind="stable")
            docs_sorted = docs[order]
            vals_sorted = u64_vals[order]
            if card == CARD_FULL:
                dense = np.zeros(max_doc, dtype=np.uint64)
                dense[docs_sorted] = vals_sorted
                store_vals = dense
            elif card == CARD_OPTIONAL:
                store_vals = vals_sorted
                out[prefix + "present_docs"] = docs_sorted
            else:
                offsets = np.zeros(max_doc + 1, dtype=np.int64)
                np.add.at(offsets[1:], docs_sorted, 1)
                offsets = np.cumsum(offsets)
                store_vals = vals_sorted
                out[prefix + "offsets"] = offsets.astype(np.int64)
            for k, v in _codec_encode(store_vals).items():
                out[prefix + k] = v
            out[prefix + "meta"] = np.asarray(
                [card, _TYPE_CODES[type_name], max_doc], dtype=np.int64
            )
        return out


@dataclass
class Column:
    """Read handle for one fast-field column (reference `DynamicColumn`)."""

    field: str
    type_name: str
    cardinality: int
    max_doc: int
    values: np.ndarray  # u64
    present_docs: np.ndarray | None = None
    offsets: np.ndarray | None = None
    dictionary: TermDictionary | None = None

    def values_for_doc(self, doc: int) -> list:
        if self.cardinality == CARD_FULL:
            raw = [int(self.values[doc])]
        elif self.cardinality == CARD_OPTIONAL:
            i = int(np.searchsorted(self.present_docs, doc))
            if i < len(self.present_docs) and self.present_docs[i] == doc:
                raw = [int(self.values[i])]
            else:
                raw = []
        else:
            lo, hi = int(self.offsets[doc]), int(self.offsets[doc + 1])
            raw = [int(v) for v in self.values[lo:hi]]
        if self.dictionary is not None:
            return [self.dictionary.term(o) for o in raw]
        return [from_u64(v, self.type_name) for v in raw]

    def first(self, doc: int):
        vals = self.values_for_doc(doc)
        return vals[0] if vals else None

    def has_value(self, doc: int) -> bool:
        if self.cardinality == CARD_FULL:
            return True
        if self.cardinality == CARD_OPTIONAL:
            i = int(np.searchsorted(self.present_docs, doc))
            return i < len(self.present_docs) and self.present_docs[i] == doc
        return int(self.offsets[doc + 1]) > int(self.offsets[doc])

    def first_u64s(self, docs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized first raw u64 value per doc: (values u64[n],
        present bool[n]). Raw values are order-preserving (monotonic u64
        mapping / sorted dict ordinals), so callers can sort on them and
        decode only the survivors."""
        docs = np.asarray(docs, dtype=np.int64)
        if self.cardinality == CARD_FULL:
            return self.values[docs], np.ones(len(docs), dtype=bool)
        if self.cardinality == CARD_OPTIONAL:
            pos = np.searchsorted(self.present_docs, docs)
            pos = np.minimum(pos, max(len(self.present_docs) - 1, 0))
            present = (
                self.present_docs[pos] == docs
                if len(self.present_docs)
                else np.zeros(len(docs), dtype=bool)
            )
            vals = (
                self.values[pos]
                if len(self.values)
                else np.zeros(len(docs), dtype=np.uint64)
            )
            return vals, present
        s = self.offsets[docs]
        e = self.offsets[docs + 1]
        present = e > s
        idx = np.minimum(s, max(len(self.values) - 1, 0))
        vals = (
            self.values[idx]
            if len(self.values)
            else np.zeros(len(docs), dtype=np.uint64)
        )
        return vals, present

    def decode_value(self, raw: int):
        """One raw u64 -> the user-facing value."""
        if self.dictionary is not None:
            return self.dictionary.term(int(raw))
        return from_u64(int(raw), self.type_name)

    def doc_count_with_value(self) -> int:
        if self.cardinality == CARD_FULL:
            return self.max_doc
        if self.cardinality == CARD_OPTIONAL:
            return len(self.present_docs)
        return int(np.count_nonzero(np.diff(self.offsets)))


class FastFieldReaders:
    """Per-segment façade (reference `src/fastfield/readers.rs:22`)."""

    def __init__(self, arrays: dict[str, np.ndarray]):
        self._arrays = arrays
        self._columns: dict[str, Column] = {}

    def column_fields(self) -> list[str]:
        fields = set()
        for k in self._arrays:
            if k.startswith("col/") and k.endswith("/meta"):
                fields.add(k[len("col/"):-len("/meta")])
        return sorted(fields)

    def column(self, field: str) -> Column | None:
        if field in self._columns:
            return self._columns[field]
        prefix = f"col/{field}/"
        meta_key = prefix + "meta"
        if meta_key not in self._arrays:
            # `field.path` resolution into a JSON field's dynamic per-path
            # columns (reference `src/fastfield/readers.rs:64-101`): try
            # every split of the dotted name, longest field name first
            if "." in field:
                parts = field.split(".")
                for i in range(len(parts) - 1, 0, -1):
                    cand = "\x01".join([".".join(parts[:i])] + parts[i:])
                    if f"col/{cand}/meta" in self._arrays:
                        col = self.column(cand)
                        self._columns[field] = col
                        return col
            return None
        card, type_code, max_doc = (int(x) for x in self._arrays[meta_key])
        dictionary = None
        dict_prefix = prefix + "dict_"
        dict_arrays = {
            k[len(dict_prefix):]: v
            for k, v in self._arrays.items()
            if k.startswith(dict_prefix)
        }
        if dict_arrays:
            dictionary = TermDictionary.from_arrays(dict_arrays)
        col = Column(
            field=field,
            type_name=_TYPE_NAMES[type_code],
            cardinality=card,
            max_doc=max_doc,
            values=_codec_decode(self._arrays, prefix),
            present_docs=self._arrays.get(prefix + "present_docs"),
            offsets=self._arrays.get(prefix + "offsets"),
            dictionary=dictionary,
        )
        self._columns[field] = col
        return col
