"""Segment mirrors for the device paths, in two modes.

Counterpart of `tantivy_tpu/ops/device_index.py`.
* "dense" (the default): every block is decoded once on the host
  (`docs_np`, `tfs_np`), and the fused store (`ops/fused_store.py`) ships
  those rows to the device with their BM25 denominators, 1,536 bytes per
  128-doc block. Every device path reads it.
* "packed": nothing is decoded ahead (`docs_np` and `tfs_np` are None).
  `DeviceSegment.packed_mirror(field, device)` keeps the postings on the
  device in their on-disk bit-packed form (`PackedMirror`), 16 bytes per
  bit of doc and tf width per block plus a 32-byte table row, and the
  packed flat scorer (`ops/packed_flat.py`) decodes them on the fly. Only
  `search_term_batch` runs in this mode; the dense-only paths refuse it.
The block and term tables stay host numpy in both modes: query planning is
host work.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..common import arrayio
from ..postings.format import TERMINATED

_WIDTHS = (0, 1, 2, 4, 8, 16, 32)
MODES = ("dense", "packed")

#: columns of `PackedMirror.blk_tab`, one int32 row of 8 per block
TAB_DOC_OFF, TAB_DOC_BITS, TAB_TF_OFF, TAB_TF_BITS, TAB_BASE, TAB_LEN = range(6)
TAB_COLS = 8


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    return mode


def dense_only(what: str) -> RuntimeError:
    """The error every dense-only path raises in packed mode."""
    return RuntimeError(f"{what} requires dense mode; this executor runs "
                        "mode='packed', whose only device path is "
                        "search_term_batch")


class PackedMirror(NamedTuple):
    """One (segment, field)'s postings on a device in bit-packed form.

    * `doc_words` [Nd] int32: the doc-delta rows of every width, the
      width-w matrix `[n_rows_w, 4w]` flattened, widths in ascending order;
    * `tf_words` [Nt] int32: the tf rows (stored minus one), likewise;
    * `blk_tab` [NB, 8] int32: per block its doc row's word offset and
      width, its tf row's word offset and width (width 0 when the field has
      no freqs: every tf is 1), its base doc and its length; 2 pad columns;
    * `norm_ids` [max_doc] uint8 and `alive` [max_doc] bool: the segment's
      field norm ids and live-doc mask.
    A kernel reads a work item's block by its id alone."""

    doc_words: torch.Tensor
    tf_words: torch.Tensor
    blk_tab: torch.Tensor
    norm_ids: torch.Tensor
    alive: torch.Tensor

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)


def _concat_widths(arrays, prefix: str, bits, rows):
    """(words [N] u32 of every width's matrix, per-block word offset).
    A width-w row is 4w words, so every offset is a multiple of 4 words:
    kernel K5 loads a row's words 8 or 16 bytes at a time."""
    mats = [np.ascontiguousarray(arrays[f"{prefix}_w{w}"],
                                 dtype=np.uint32).reshape(-1)
            for w in _WIDTHS]
    start = np.cumsum([0] + [m.size for m in mats])
    words = np.concatenate(mats)
    if words.size >= 2**31:
        raise ValueError(f"{prefix} words do not fit int32 offsets")
    off = np.zeros(len(bits), dtype=np.int64)
    for i, w in enumerate(_WIDTHS):
        sel = bits == w
        off[sel] = start[i] + rows[sel].astype(np.int64) * 4 * w
    return words, off


class DeviceFieldPostings:
    def __init__(self, arrays: dict[str, np.ndarray], norm_ids: np.ndarray,
                 mode: str = "dense"):
        self.mode = mode
        # host-side planning tables
        self.blk_last_doc = arrays["blk_last_doc"]
        self.blk_base = arrays["blk_base"]
        self.blk_len = arrays["blk_len"]
        self.blk_doc_bits = arrays["blk_doc_bits"]
        self.blk_doc_row = arrays["blk_doc_row"]
        self.blk_tf_bits = arrays["blk_tf_bits"]
        self.blk_tf_row = arrays["blk_tf_row"]
        self.blk_max_fnid = arrays["blk_max_fnid"]
        self.blk_max_tf = arrays["blk_max_tf"]
        self.term_block_start = arrays["term_block_start"]
        self.term_num_blocks = arrays["term_num_blocks"]
        self.term_doc_freq = arrays["term_doc_freq"]
        self.has_freqs = bool(arrays["has_freqs"][0])
        self.num_blocks = len(self.blk_len)
        # phrase support: the fused store's position slabs are built from
        # these (`FusedStore.ensure_positions`)
        self.term_pos_start = arrays["term_pos_start"]
        self._positions_np = arrays["positions"]
        self.norm_ids_np = np.ascontiguousarray(norm_ids, dtype=np.uint8)
        self._pos_cum_np = None
        self._blk_top_tf = None
        if mode == "dense":
            self.docs_np, self.tfs_np = self._decode_all(arrays)
            self._packed = None
        else:
            self.docs_np = self.tfs_np = None
            self._packed = {f"{p}_w{w}": arrays[f"{p}_w{w}"]
                            for p in ("doc", "tf") for w in _WIDTHS}
        self._tables = None

    def ensure_blk_top_tf(self) -> np.ndarray:
        """The true per-block max tf (host numpy [NB], 0 for a block
        without docs), computed once. `blk_max_tf` is the tf of the block's
        max-score (fieldnorm, tf) skip pair, no bound on tf: a high-tf doc
        in a long field can lose the score argmax. Whatever bounds in-doc
        tf (the per-segment phrase path's position windows and host
        fallbacks) reads this."""
        if self.docs_np is None:
            raise dense_only("the per-block max tf")
        if self._blk_top_tf is None:
            self._blk_top_tf = self.real_tf_flat().reshape(-1, 128).max(
                axis=1, initial=0)
        return self._blk_top_tf

    def real_tf_flat(self) -> np.ndarray:
        """Host [NB*128] uint32: tf per store lane, 0 on pad lanes."""
        if self.docs_np is None:
            raise dense_only("the position store")
        return np.where(
            self.docs_np != np.uint32(TERMINATED), self.tfs_np, np.uint32(0)
        ).reshape(-1)

    def pos_cum_np(self) -> np.ndarray:
        """Host exclusive cumsum of real tfs over the flattened block store
        (pad lanes contribute 0): the position-slice base table."""
        if self._pos_cum_np is None:
            flat = self.real_tf_flat()
            incl = np.cumsum(flat, dtype=np.uint32)
            self._pos_cum_np = incl - flat
        return self._pos_cum_np

    def _decode_all(self, arrays: dict[str, np.ndarray]):
        """Decode every block once, on the host, with vectorised numpy
        unpack: strict-delta doc ids (uint32 wraparound cumsum,
        TERMINATED-masked pad lanes) and tfs stored minus one."""
        from ..common import bitpack

        n = self.num_blocks
        docs = np.full((n, 128), TERMINATED, dtype=np.uint32)
        tfs = np.ones((n, 128), dtype=np.uint32)
        lane = np.arange(128, dtype=np.uint32)[None, :]
        for w in np.unique(self.blk_doc_bits):
            sel = np.nonzero(self.blk_doc_bits == w)[0]
            if w == 0:
                deltas = np.zeros((len(sel), 128), dtype=np.uint32)
            else:
                deltas = bitpack.unpack_rows(
                    arrays[f"doc_w{int(w)}"][self.blk_doc_row[sel]],
                    int(w), 128,
                )
            d = (
                self.blk_base[sel].astype(np.uint32)[:, None]
                + np.cumsum(deltas, axis=1, dtype=np.uint32)
                + lane
            )
            keep = lane < self.blk_len[sel].astype(np.uint32)[:, None]
            docs[sel] = np.where(keep, d, np.uint32(TERMINATED))
        if self.has_freqs:
            for w in np.unique(self.blk_tf_bits):
                if w == 0:
                    continue  # width-0 tf rows are all ones (already set)
                sel = np.nonzero(self.blk_tf_bits == w)[0]
                tfs[sel] = bitpack.unpack_rows(
                    arrays[f"tf_w{int(w)}"][self.blk_tf_row[sel]],
                    int(w), 128,
                ) + np.uint32(1)
        return docs, tfs

    def packed_tables(self):
        """Host (doc_words [Nd] u32, tf_words [Nt] u32, blk_tab [NB, 8]
        i32) of `PackedMirror`, built once (packed mode only)."""
        if self._packed is None:
            raise ValueError("the packed tables exist in packed mode only")
        if self._tables is None:
            doc_bits = self.blk_doc_bits.astype(np.int64)
            tf_bits = (self.blk_tf_bits.astype(np.int64) if self.has_freqs
                       else np.zeros(self.num_blocks, dtype=np.int64))
            doc_words, doc_off = _concat_widths(
                self._packed, "doc", doc_bits, self.blk_doc_row)
            tf_words, tf_off = _concat_widths(
                self._packed, "tf", tf_bits, self.blk_tf_row)
            tab = np.zeros((self.num_blocks, TAB_COLS), dtype=np.int64)
            tab[:, TAB_DOC_OFF] = doc_off
            tab[:, TAB_DOC_BITS] = doc_bits
            tab[:, TAB_TF_OFF] = tf_off
            tab[:, TAB_TF_BITS] = tf_bits
            tab[:, TAB_BASE] = self.blk_base
            tab[:, TAB_LEN] = self.blk_len
            if tab.max(initial=0) >= 2**31:
                raise ValueError("block table entries do not fit int32")
            self._tables = (doc_words, tf_words, tab.astype(np.int32))
        return self._tables

    def gather_blocks(self, block_ids: np.ndarray):
        """(docs, tfs) [W, 128] int32 (u32 bits, TERMINATED-padded) of the
        blocks `block_ids`, on the CPU: the dense rows, or in packed mode
        the packed tables decoded by the plain twin (`decode_blocks`)."""
        ids = np.asarray(block_ids, dtype=np.int64)
        if self.mode == "dense":
            return (torch.from_numpy(self.docs_np[ids].view(np.int32)),
                    torch.from_numpy(self.tfs_np[ids].view(np.int32)))
        from .decode import decode_blocks

        doc_words, tf_words, tab = self.packed_tables()
        return decode_blocks(torch.from_numpy(doc_words.view(np.int32)),
                             torch.from_numpy(tf_words.view(np.int32)),
                             torch.from_numpy(tab), torch.from_numpy(ids))


class DeviceSegment:
    def __init__(self, segment_reader, mode: str = "dense"):
        self.reader = segment_reader
        self.mode = check_mode(mode)
        self.max_doc = segment_reader.max_doc
        self._fields: dict[str, DeviceFieldPostings] = {}
        alive = segment_reader.alive_bitset()
        self.alive_np = (
            np.ascontiguousarray(alive, dtype=bool)
            if alive is not None else None
        )
        #: packed mirrors by (field, torch device), built under `_lock`
        self._mirrors: dict[tuple[str, torch.device], PackedMirror] = {}
        self._lock = threading.Lock()

    def field_postings(self, field_name: str) -> DeviceFieldPostings:
        dfp = self._fields.get(field_name)
        if dfp is None:
            entry = self.reader.schema.get_field(field_name)
            arrays = arrayio.field_arrays(self.reader._idx, entry.field_id)
            norms = self.reader.fieldnorms(field_name)
            dfp = DeviceFieldPostings(arrays, norms, self.mode)
            self._fields[field_name] = dfp
        return dfp

    def packed_mirror(self, field_name: str, device) -> PackedMirror:
        """The packed mirror of `field_name` on `device`, uploaded once
        (packed mode only). The upload is complete before the mirror is
        returned, so batches on other CUDA streams may read it at once."""
        dev = torch.device(device)
        key = (field_name, dev)
        mirror = self._mirrors.get(key)
        if mirror is not None:
            return mirror
        with self._lock:
            mirror = self._mirrors.get(key)
            if mirror is None:
                dfp = self.field_postings(field_name)
                doc_words, tf_words, tab = dfp.packed_tables()
                alive = (self.alive_np if self.alive_np is not None
                         else np.ones(len(dfp.norm_ids_np), dtype=bool))
                mirror = PackedMirror(*(
                    torch.from_numpy(np.array(a)).to(dev) for a in (
                        doc_words.view(np.int32), tf_words.view(np.int32),
                        tab, dfp.norm_ids_np, alive)
                ))
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
                self._mirrors[key] = mirror
        return mirror
