"""Posting-list block format — the heart of the index.

Semantics mirror reference `src/postings/` (128-doc blocks, strict-delta doc
encoding, tf-minus-one encoding, per-block skip metadata incl. block-max
(fieldnorm_id, tf) for WAND — `src/postings/skip.rs:7-43`), but the physical
layout is TPU-first rather than a byte-stream:

* Every posting list, regardless of length, is laid out as `ceil(df/128)`
  blocks. The reference VInt-encodes the tail (<128 docs) — we keep the tail as
  a normal (padded) block: fixed shapes are what XLA wants, and the padding
  cost is bounded by one block per term.
* Doc ids are strict-delta encoded: with `base = previous block's last doc + 1`
  (0 for the first block), `delta[0] = doc[0] - base`, `delta[i] =
  doc[i] - doc[i-1] - 1`. Decode is `base + cumsum(delta) + iota` — an
  associative scan, the natural TPU shape. Padding lanes (tail block) decode to
  values > last_doc and are masked by `block_len`.
* Term freqs are stored minus one (tf >= 1 always), like
  `compression/mod.rs:54-76`.
* Packed words use power-of-two bit widths (see `common/bitpack.py`), and
  blocks are *grouped by bit width* into per-width dense matrices
  `[n_blocks_w, 128*w/32]` so the device decode kernel for width w is a dense
  row-gather + shift/mask with no ragged indexing.
* Per-block skip metadata is a struct-of-arrays: `last_doc`, `base`, `length`,
  and the block-max `(fieldnorm_id, tf)` pair chosen at index time to maximize
  the BM25 score under the segment's average fieldnorm (reference
  `skip.rs:175-184` stores the same pair; exactness caveat identical).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..common import bitpack

COMPRESSION_BLOCK_SIZE = 128
#: Sentinel doc id (i32::MAX), reference `src/docset.rs:12`.
TERMINATED = np.uint32(2147483647)

_WIDTHS = bitpack.ALLOWED_BITS  # (0, 1, 2, 4, 8, 16, 32)
_WIDTH_INDEX = {w: i for i, w in enumerate(_WIDTHS)}


@dataclass
class _WidthBucket:
    """Accumulates packed 128-value groups of one bit width."""

    bits: int
    rows: list = field(default_factory=list)
    n_rows: int = 0

    def add(self, values: np.ndarray) -> int:
        """Pack one padded 128-group; returns its row index in this bucket."""
        row = bitpack.pack(values, self.bits)
        self.rows.append(row.reshape(1, -1))
        self.n_rows += 1
        return self.n_rows - 1

    def add_rows(self, values: np.ndarray) -> int:
        """Pack [m, 128] groups at once; returns the first row index."""
        start = self.n_rows
        self.rows.append(bitpack.pack_rows(values, self.bits))
        self.n_rows += len(values)
        return start

    def stack(self) -> np.ndarray:
        n_words = bitpack.words_for(COMPRESSION_BLOCK_SIZE, self.bits)
        if not self.rows:
            return np.zeros((0, n_words), dtype=np.uint32)
        return np.concatenate(self.rows, axis=0).astype(np.uint32)


class PostingsSerializer:
    """Builds the per-field device-layout postings arrays.

    Feed it terms in sorted order via `serialize_term(docs, tfs)`; call
    `finish()` to obtain the dict-of-arrays written to the `.idx` component.
    Equivalent role to reference `src/postings/serializer.rs` (PostingsSerializer
    + SkipSerializer), re-shaped for device residency.
    """

    def __init__(self, avg_fieldnorm: float, fieldnorm_ids: np.ndarray | None,
                 has_freqs: bool = True):
        from ..query.bm25 import compute_tf_cache

        self.has_freqs = has_freqs
        self._doc_buckets = [_WidthBucket(w) for w in _WIDTHS]
        self._tf_buckets = [_WidthBucket(w) for w in _WIDTHS]
        # per-block columns
        self._blk_last_doc: list[int] = []
        self._blk_base: list[int] = []
        self._blk_len: list[int] = []
        self._blk_doc_bits: list[int] = []
        self._blk_doc_row: list[int] = []
        self._blk_tf_bits: list[int] = []
        self._blk_tf_row: list[int] = []
        self._blk_max_fnid: list[int] = []
        self._blk_max_tf: list[int] = []
        self._blk_tf_cum: list[int] = []
        # per-term columns
        self._term_block_start: list[int] = []
        self._term_num_blocks: list[int] = []
        self._term_doc_freq: list[int] = []
        # positions (phrase queries): flat per-field array + per-term starts.
        # Absolute in-doc token positions; the (term, posting) -> slice mapping
        # is `term_pos_start[t] + blk_tf_cum[b] + in-block tf prefix sum`,
        # mirroring the reference's tf_sum skip offsets (`positions/mod.rs`).
        self._positions: list[np.ndarray] = []
        self._term_pos_start: list[int] = []
        self._pos_len = 0
        # block-max scoring inputs (index-time average fieldnorm)
        self._fieldnorm_ids = fieldnorm_ids
        self._tf_cache = compute_tf_cache(np.float32(max(avg_fieldnorm, 1e-12)))

    def serialize_term(
        self,
        docs: np.ndarray,
        tfs: np.ndarray | None,
        positions: np.ndarray | None = None,
    ) -> int:
        """Append one term's postings; returns the term ordinal.

        `positions`, if given, is the flat concatenation of in-doc token
        positions for each posting (length = sum(tfs)).
        """
        docs = np.ascontiguousarray(docs, dtype=np.uint32)
        df = len(docs)
        assert df > 0
        if tfs is None:
            tfs = np.ones(df, dtype=np.uint32)
        else:
            tfs = np.ascontiguousarray(tfs, dtype=np.uint32)

        self._term_pos_start.append(self._pos_len)
        if positions is not None:
            positions = np.ascontiguousarray(positions, dtype=np.uint32)
            assert len(positions) == int(tfs.sum())
            self._positions.append(positions)
            self._pos_len += len(positions)

        term_ord = len(self._term_doc_freq)
        self._term_doc_freq.append(df)
        self._term_block_start.append(len(self._blk_last_doc))
        n_blocks = -(-df // COMPRESSION_BLOCK_SIZE)
        self._term_num_blocks.append(n_blocks)

        if self._fieldnorm_ids is not None:
            norm_ids = self._fieldnorm_ids[docs]
        else:
            norm_ids = np.zeros(df, dtype=np.uint8)
        # BM25 tf-factor is monotone in tf and in -cache[norm], so the
        # block-max pair is argmax of tf/(tf+cache[norm]) over the block.
        tf_f = tfs.astype(np.float32)
        factors = tf_f / (tf_f + self._tf_cache[norm_ids])

        # all per-block work vectorized over the term's blocks at once:
        # strict-delta is the same formula at block starts and inside blocks
        # (base = previous block's last doc + 1), so one diff covers all.
        bs = COMPRESSION_BLOCK_SIZE
        total = n_blocks * bs
        deltas = np.empty(df, dtype=np.uint32)
        deltas[0] = docs[0]
        if df > 1:
            deltas[1:] = docs[1:] - docs[:-1] - 1
        dpad = np.zeros(total, dtype=np.uint32)
        dpad[:df] = deltas
        drows = dpad.reshape(n_blocks, bs)
        doc_bits = bitpack.bits_required_rows(drows.max(axis=1))
        doc_rows = np.empty(n_blocks, dtype=np.int64)
        for w in np.unique(doc_bits):
            sel = doc_bits == w
            start = self._doc_buckets[_WIDTH_INDEX[int(w)]].add_rows(drows[sel])
            doc_rows[sel] = start + np.arange(int(sel.sum()))

        if self.has_freqs:
            tpad = np.zeros(total, dtype=np.uint32)
            tpad[:df] = tfs - 1
            trows = tpad.reshape(n_blocks, bs)
            tf_bits = bitpack.bits_required_rows(trows.max(axis=1))
            tf_rows = np.empty(n_blocks, dtype=np.int64)
            for w in np.unique(tf_bits):
                sel = tf_bits == w
                start = self._tf_buckets[_WIDTH_INDEX[int(w)]].add_rows(trows[sel])
                tf_rows[sel] = start + np.arange(int(sel.sum()))
        else:
            tf_bits = np.zeros(n_blocks, dtype=np.int64)
            tf_rows = np.zeros(n_blocks, dtype=np.int64)

        fpad = np.full(total, -1.0, dtype=np.float32)
        fpad[:df] = factors
        arg = fpad.reshape(n_blocks, bs).argmax(axis=1)
        gidx = np.arange(n_blocks) * bs + arg
        self._blk_max_fnid.extend(norm_ids[gidx].tolist())
        self._blk_max_tf.extend(tfs[gidx].tolist())

        tfpad = np.zeros(total, dtype=np.int64)
        tfpad[:df] = tfs
        blk_sums = tfpad.reshape(n_blocks, bs).sum(axis=1)
        tf_cum = np.concatenate([[0], np.cumsum(blk_sums)[:-1]])
        self._blk_tf_cum.extend(tf_cum.tolist())

        ends = np.minimum(np.arange(1, n_blocks + 1) * bs, df) - 1
        last = docs[ends].astype(np.int64)
        bases = np.concatenate([[0], last[:-1] + 1])
        starts = np.arange(n_blocks) * bs
        self._blk_last_doc.extend(last.tolist())
        self._blk_base.extend(bases.tolist())
        self._blk_len.extend((ends - starts + 1).tolist())
        self._blk_doc_bits.extend(doc_bits.tolist())
        self._blk_doc_row.extend(doc_rows.tolist())
        self._blk_tf_bits.extend(
            tf_bits.tolist() if self.has_freqs else [0] * n_blocks
        )
        self._blk_tf_row.extend(tf_rows.tolist())
        return term_ord

    def serialize_sorted_field(
        self,
        poff: np.ndarray,       # [n_terms + 1] posting offsets per term
        docs: np.ndarray,       # [N] u32, concatenated per sorted term
        tfs: np.ndarray,        # [N] u32
        positions: np.ndarray | None = None,  # [sum(tfs)] u32 flat
    ) -> None:
        """Serialize a whole field's sorted term stream in ONE vectorized
        pass (no per-term Python loop) — the indexing-throughput hot path
        for native-core fields. Semantically identical to calling
        `serialize_term` per term: strict-delta doc encoding crosses block
        boundaries with base = previous last + 1, which equals the global
        `doc[i] - doc[i-1] - 1` everywhere except each term's first posting
        (delta = doc value)."""
        assert len(self._term_doc_freq) == 0, \
            "serialize_sorted_field builds a whole field at once"
        poff = np.ascontiguousarray(poff, dtype=np.int64)
        docs = np.ascontiguousarray(docs, dtype=np.uint32)
        tfs = np.ascontiguousarray(tfs, dtype=np.uint32)
        n_terms = len(poff) - 1
        N = len(docs)
        if N == 0:
            if positions is not None:
                self._positions.append(
                    np.ascontiguousarray(positions, dtype=np.uint32)
                )
            self._term_pos_start = [0] * n_terms
            self._term_doc_freq = [0] * n_terms
            return
        bs = COMPRESSION_BLOCK_SIZE
        df = np.diff(poff)
        nblk = -(-df // bs)
        blk_of_term = np.zeros(n_terms + 1, dtype=np.int64)
        np.cumsum(nblk, out=blk_of_term[1:])
        total_blocks = int(blk_of_term[-1])
        blk_term = np.repeat(np.arange(n_terms), nblk)
        blk_in_term = (
            np.arange(total_blocks) - blk_of_term[blk_term]
        )
        bstart = poff[blk_term] + blk_in_term * bs   # global posting index
        bend = np.minimum(bstart + bs, poff[blk_term + 1])
        blen = bend - bstart

        deltas = np.empty(N, dtype=np.uint32)
        deltas[0] = docs[0]
        if N > 1:
            deltas[1:] = docs[1:] - docs[:-1] - 1
        firsts = poff[:-1][df > 0]
        deltas[firsts] = docs[firsts]

        rows = np.repeat(np.arange(total_blocks), blen)
        cols = np.arange(N) - bstart[rows]
        dpad = np.zeros((total_blocks, bs), dtype=np.uint32)
        dpad[rows, cols] = deltas
        doc_bits = bitpack.bits_required_rows(dpad.max(axis=1))
        doc_rows = np.empty(total_blocks, dtype=np.int64)
        for w in np.unique(doc_bits):
            sel = doc_bits == w
            start = self._doc_buckets[_WIDTH_INDEX[int(w)]].add_rows(dpad[sel])
            doc_rows[sel] = start + np.arange(int(sel.sum()))

        if self.has_freqs:
            tpad = np.zeros((total_blocks, bs), dtype=np.uint32)
            tpad[rows, cols] = tfs - 1
            tf_bits = bitpack.bits_required_rows(tpad.max(axis=1))
            tf_rows = np.empty(total_blocks, dtype=np.int64)
            for w in np.unique(tf_bits):
                sel = tf_bits == w
                start = self._tf_buckets[_WIDTH_INDEX[int(w)]].add_rows(
                    tpad[sel]
                )
                tf_rows[sel] = start + np.arange(int(sel.sum()))
        else:
            tf_bits = np.zeros(total_blocks, dtype=np.int64)
            tf_rows = np.zeros(total_blocks, dtype=np.int64)

        if self._fieldnorm_ids is not None:
            norm_ids = self._fieldnorm_ids[docs]
        else:
            norm_ids = np.zeros(N, dtype=np.uint8)
        tf_f = tfs.astype(np.float32)
        factors = tf_f / (tf_f + self._tf_cache[norm_ids])
        fpad = np.full((total_blocks, bs), -1.0, dtype=np.float32)
        fpad[rows, cols] = factors
        arg = fpad.argmax(axis=1)
        gidx = bstart + arg  # argmax col < blen always (factors > -1)
        self._blk_max_fnid = norm_ids[gidx].tolist()
        self._blk_max_tf = tfs[gidx].tolist()

        tf64 = tfs.astype(np.int64)
        tcum = np.zeros(N + 1, dtype=np.int64)
        np.cumsum(tf64, out=tcum[1:])
        # per-block tf offset within the TERM's position region
        blk_tf_cum = tcum[bstart] - tcum[poff[blk_term]]
        self._blk_tf_cum = blk_tf_cum.tolist()

        last = docs[bend - 1].astype(np.int64)
        bases = np.empty(total_blocks, dtype=np.int64)
        bases[blk_in_term == 0] = 0
        mid = blk_in_term > 0
        bases[mid] = last[np.nonzero(mid)[0] - 1] + 1
        self._blk_last_doc = last.tolist()
        self._blk_base = bases.tolist()
        self._blk_len = blen.tolist()
        self._blk_doc_bits = doc_bits.tolist()
        self._blk_doc_row = doc_rows.tolist()
        self._blk_tf_bits = tf_bits.tolist()
        self._blk_tf_row = tf_rows.tolist()

        self._term_block_start = blk_of_term[:-1].tolist()
        self._term_num_blocks = nblk.tolist()
        self._term_doc_freq = df.tolist()
        self._term_pos_start = tcum[poff[:-1]].tolist()
        if positions is not None:
            positions = np.ascontiguousarray(positions, dtype=np.uint32)
            assert len(positions) == int(tcum[-1])
            self._positions.append(positions)
            self._pos_len = len(positions)

    def finish(self) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {
            "has_freqs": np.asarray([1 if self.has_freqs else 0], dtype=np.int32),
            "blk_last_doc": np.asarray(self._blk_last_doc, dtype=np.uint32),
            "blk_base": np.asarray(self._blk_base, dtype=np.uint32),
            "blk_len": np.asarray(self._blk_len, dtype=np.int32),
            "blk_doc_bits": np.asarray(self._blk_doc_bits, dtype=np.uint8),
            "blk_doc_row": np.asarray(self._blk_doc_row, dtype=np.int32),
            "blk_tf_bits": np.asarray(self._blk_tf_bits, dtype=np.uint8),
            "blk_tf_row": np.asarray(self._blk_tf_row, dtype=np.int32),
            "blk_max_fnid": np.asarray(self._blk_max_fnid, dtype=np.uint8),
            "blk_max_tf": np.asarray(self._blk_max_tf, dtype=np.uint32),
            "blk_tf_cum": np.asarray(self._blk_tf_cum, dtype=np.uint32),
            "term_pos_start": np.asarray(self._term_pos_start, dtype=np.int64),
            "positions": (
                np.concatenate(self._positions).astype(np.uint32)
                if self._positions
                else np.zeros(0, dtype=np.uint32)
            ),
            "term_block_start": np.asarray(self._term_block_start, dtype=np.int32),
            "term_num_blocks": np.asarray(self._term_num_blocks, dtype=np.int32),
            "term_doc_freq": np.asarray(self._term_doc_freq, dtype=np.uint32),
        }
        for w, bucket in zip(_WIDTHS, self._doc_buckets):
            out[f"doc_w{w}"] = bucket.stack()
        for w, bucket in zip(_WIDTHS, self._tf_buckets):
            out[f"tf_w{w}"] = bucket.stack()
        return out


def decode_block_host(arrays: dict[str, np.ndarray], block_id: int):
    """Host-side reference decoder (used by tests and the host read path).

    Returns (docs, tfs) of length `blk_len[block_id]`.
    """
    bits = int(arrays["blk_doc_bits"][block_id])
    row = int(arrays["blk_doc_row"][block_id])
    base = int(arrays["blk_base"][block_id])
    length = int(arrays["blk_len"][block_id])
    words = arrays[f"doc_w{bits}"][row]
    deltas = bitpack.unpack(words, bits, COMPRESSION_BLOCK_SIZE)
    docs = base + np.cumsum(deltas, dtype=np.uint64) + np.arange(
        COMPRESSION_BLOCK_SIZE, dtype=np.uint64
    )
    docs = docs[:length].astype(np.uint32)

    if int(arrays["has_freqs"][0]) == 0:
        return docs, np.ones(length, dtype=np.uint32)
    tbits = int(arrays["blk_tf_bits"][block_id])
    trow = int(arrays["blk_tf_row"][block_id])
    twords = arrays[f"tf_w{tbits}"][trow]
    tfs = bitpack.unpack(twords, tbits, COMPRESSION_BLOCK_SIZE)[:length] + 1
    return docs, tfs.astype(np.uint32)


def decode_field_host(arrays: dict[str, np.ndarray], chunk_blocks=65536):
    """Decode EVERY posting of a field in one vectorized pass ->
    (poff [n_terms + 1] i64, docs u32, tfs u32) flat in (term, doc) order —
    the merger's bulk read (the per-term decode loop was the round-4 merge
    bottleneck). Block-chunked to bound the [chunk, 128] scratch."""
    nb_per = arrays["term_num_blocks"].astype(np.int64)
    n_terms = len(nb_per)
    df = arrays["term_doc_freq"].astype(np.int64)
    poff = np.zeros(n_terms + 1, dtype=np.int64)
    np.cumsum(df, out=poff[1:])
    total_blocks = int(nb_per.sum())
    if total_blocks == 0:
        return poff, np.zeros(0, np.uint32), np.zeros(0, np.uint32)
    cum_nb = np.zeros(n_terms, dtype=np.int64)
    np.cumsum(nb_per[:-1], out=cum_nb[1:])
    ids_all = (
        np.repeat(arrays["term_block_start"].astype(np.int64), nb_per)
        + np.arange(total_blocks, dtype=np.int64)
        - np.repeat(cum_nb, nb_per)
    )
    doc_parts, tf_parts = [], []
    for lo in range(0, total_blocks, chunk_blocks):
        ids = ids_all[lo : lo + chunk_blocks]
        docs, tfs = _decode_blocks_host(arrays, ids)
        doc_parts.append(docs)
        tf_parts.append(tfs)
    docs = np.concatenate(doc_parts)
    tfs = np.concatenate(tf_parts)
    assert len(docs) == int(poff[-1]), "decoded postings != doc_freq sum"
    return poff, docs, tfs


def _decode_blocks_host(arrays, ids):
    """(docs, tfs) of the given block ids, flat in block order (the body of
    `decode_term_host`, factored for whole-field chunked decode)."""
    n = len(ids)
    lens = arrays["blk_len"][ids].astype(np.int64)
    bases = arrays["blk_base"][ids].astype(np.uint64)
    docs2d = np.zeros((n, COMPRESSION_BLOCK_SIZE), dtype=np.uint64)
    bits_col = arrays["blk_doc_bits"][ids]
    for w in np.unique(bits_col):
        sel = bits_col == w
        rows = arrays["blk_doc_row"][ids[sel]]
        if w == 0:
            deltas = np.zeros(
                (int(sel.sum()), COMPRESSION_BLOCK_SIZE), dtype=np.uint32
            )
        else:
            deltas = bitpack.unpack_rows(
                arrays[f"doc_w{int(w)}"][rows], int(w),
                COMPRESSION_BLOCK_SIZE,
            )
        docs2d[sel] = (
            bases[sel][:, None]
            + np.cumsum(deltas, axis=1, dtype=np.uint64)
            + np.arange(COMPRESSION_BLOCK_SIZE, dtype=np.uint64)
        )
    keep = (
        np.arange(COMPRESSION_BLOCK_SIZE, dtype=np.int64)[None, :]
        < lens[:, None]
    )
    docs = docs2d[keep].astype(np.uint32)
    if int(arrays["has_freqs"][0]) == 0:
        return docs, np.ones(len(docs), dtype=np.uint32)
    tfs2d = np.zeros((n, COMPRESSION_BLOCK_SIZE), dtype=np.uint32)
    tbits_col = arrays["blk_tf_bits"][ids]
    for w in np.unique(tbits_col):
        sel = tbits_col == w
        trows = arrays["blk_tf_row"][ids[sel]]
        if w == 0:
            tfs2d[sel] = 1
        else:
            tfs2d[sel] = bitpack.unpack_rows(
                arrays[f"tf_w{int(w)}"][trows], int(w),
                COMPRESSION_BLOCK_SIZE,
            ) + 1
    return docs, tfs2d[keep].astype(np.uint32)


def decode_term_host(arrays: dict[str, np.ndarray], term_ord: int):
    """Decode a full posting list on the host, all blocks of a bit width at
    once (vectorized `unpack_rows` — the host read path's hot loop).
    Returns (docs, tfs)."""
    start = int(arrays["term_block_start"][term_ord])
    n = int(arrays["term_num_blocks"][term_ord])
    if n == 0:
        return np.zeros(0, dtype=np.uint32), np.zeros(0, dtype=np.uint32)
    return _decode_blocks_host(arrays, np.arange(start, start + n))

