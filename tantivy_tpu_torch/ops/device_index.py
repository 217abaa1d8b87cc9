"""Host-side segment mirror for the fused store (numpy only).

Counterpart of `tantivy_tpu/ops/device_index.py`. The fused paths read
only host fields — the decoded doc/tf blocks, the fieldnorm ids, the block
and term tables and the flat positions — and ship them to the device once,
inside the fused store (`ops/fused_store.py`). So this port keeps no device
arrays of its own: no packed mode, no per-segment uploads, no block
gathers.
"""

from __future__ import annotations

import numpy as np

from ..common import arrayio
from ..postings.format import TERMINATED


class DeviceFieldPostings:
    def __init__(self, arrays: dict[str, np.ndarray], norm_ids: np.ndarray):
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
        self.docs_np, self.tfs_np = self._decode_all(arrays)
        self._pos_cum_np = None

    def real_tf_flat(self) -> np.ndarray:
        """Host [NB*128] uint32: tf per store lane, 0 on pad lanes."""
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


class DeviceSegment:
    def __init__(self, segment_reader):
        self.reader = segment_reader
        self.max_doc = segment_reader.max_doc
        self._fields: dict[str, DeviceFieldPostings] = {}
        alive = segment_reader.alive_bitset()
        self.alive_np = (
            np.ascontiguousarray(alive, dtype=bool)
            if alive is not None else None
        )

    def field_postings(self, field_name: str) -> DeviceFieldPostings:
        dfp = self._fields.get(field_name)
        if dfp is None:
            entry = self.reader.schema.get_field(field_name)
            arrays = arrayio.field_arrays(self.reader._idx, entry.field_id)
            norms = self.reader.fieldnorms(field_name)
            dfp = DeviceFieldPostings(arrays, norms)
            self._fields[field_name] = dfp
        return dfp
