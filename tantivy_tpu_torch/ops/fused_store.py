"""FusedStore with torch `cstore` and `postore` tensors.

The reference `tantivy_tpu/ops/fused_store.FusedStore` concatenates every
(segment, field) block store into one combined row store plus host planning
tables; it imports no jax except when it uploads. This subclass keeps its
slab registration, host tables, `region`/`region_keys` and `rmax` logic as
they are and replaces only the uploads: `cstore` and the phrase position
store `postore` become int32 tensors on the executor's device, and the
per-block last docs get one device copy for the deep probe. It does not
set the reference's `pack_addr_ok`: the port's merge tail has one form for
every segment and doc count. int32 is lossless for `cstore` because every
word is < 2^31 (TERMINATED = 2^31 - 1, and cachev bits are those of a
non-negative f32 or NaN); `postore` keeps the reference's u32 words, whose
0xFFFFFFFF padding reads as -1.
"""

from __future__ import annotations

import numpy as np
import torch

from tantivy_tpu.ops import fused_store as _ref
from tantivy_tpu.ops.fused_store import _row_tier
from tantivy_tpu.postings.format import TERMINATED


class FusedStore(_ref.FusedStore):
    def __init__(self, device="cpu"):
        super().__init__()
        self.device = torch.device(device)
        self._blk_last_t = None

    @classmethod
    def from_jax(cls, jax_fused, device="cpu") -> "FusedStore":
        """The port's store holding a reference store's state: its host
        tables as they are (the position tables `blk_pos`, `num_pos` and
        `pos_rows` included) and its cstore and, when built, its postore
        copied to `device`, so both kernels read the same stores."""
        jax_fused.ready()
        out = cls(device)
        device = out.device
        out.__dict__.update(
            {k: v for k, v in jax_fused.__dict__.items()
             if k not in ("cstore", "postore")}
        )
        out.device = device
        out.cstore = _to_device(np.array(jax_fused.cstore), device)
        if jax_fused.postore is not None:
            out.postore = _to_device(np.array(jax_fused.postore), device)
        return out

    def _rebuild(self) -> None:
        bases, lasts, bfacs, segs, stores = [], [], [], [], []
        off = 0
        for key in self._order:
            s = self.slabs[key]
            s["offset"] = off
            dfp = s["dfp"]
            nb, nbp = s["nb"], s["nbp"]
            pad = nbp - nb
            bases.append(dfp.blk_base.astype(np.uint32))
            lasts.append(dfp.blk_last_doc.astype(np.uint32))
            bfacs.append(s["bfac"])
            if pad:
                bases.append(np.full(pad, TERMINATED, dtype=np.uint32))
                lasts.append(np.full(pad, TERMINATED, dtype=np.uint32))
                bfacs.append(np.zeros(pad, dtype=np.float32))
            segs.append(np.full(nbp, s["seg_ord"], dtype=np.int32))
            stores.append(s["cstore"])
            off += nbp
        # pad to the row tier, as the reference does, so both stores stay
        # row-for-row equal
        if off > 0:
            tier = _row_tier(off)
            pad = tier - off
            if pad:
                bases.append(np.full(pad, TERMINATED, dtype=np.uint32))
                lasts.append(np.full(pad, TERMINATED, dtype=np.uint32))
                bfacs.append(np.zeros(pad, dtype=np.float32))
                segs.append(np.zeros(pad, dtype=np.int32))
                stores.append(
                    np.full((pad, 384), np.uint32(TERMINATED), np.uint32)
                )
            off = tier
        self.num_blocks = off
        self.blk_base = np.concatenate(bases) if bases else np.zeros(0, np.uint32)
        self.blk_last_doc = (
            np.concatenate(lasts) if lasts else np.zeros(0, np.uint32)
        )
        self.bfac = np.concatenate(bfacs) if bfacs else np.zeros(0, np.float32)
        self.blk_seg = np.concatenate(segs) if segs else np.zeros(0, np.int32)
        # ONE host concat + ONE device transfer for the whole store
        self.cstore = (
            _to_device(np.concatenate(stores, axis=0), self.device)
            if stores else None
        )
        from tantivy_tpu.parallel.wand import RangeMax

        self._rmax = RangeMax(self.bfac)
        self._rkeys = None
        self._blk_last_t = None
        self._dirty = False

    def blk_last_device(self) -> torch.Tensor:
        """`blk_last_doc` as an int32 tensor on the store's device (every
        entry is <= TERMINATED), copied once per store build: the deep
        probe's block searches read it."""
        self.ready()
        if self._blk_last_t is None:
            self._blk_last_t = _to_device(self.blk_last_doc, self.device)
        return self._blk_last_t

    def ensure_positions(self):
        """Build the fused position store and the per-block position
        offsets, as the reference does: `postore` [NPr, 256] holds
        positions 128r..128r+127 in columns 0:128 and each position's owner
        doc in columns 128:256, padded with 0xFFFFFFFF (int32 -1 here);
        `blk_pos[b]` is the global index of block b's first position.

        A slab whose field records no positions contributes none (the
        reference asserts there). Every other slab is checked once for the
        order the phrase kernel's binary searches need: inside each term's
        region, positions ascend by (owner doc, position)."""
        self.ready()
        if self.postore is not None and not self._pos_dirty:
            return
        from .fused_phrase import max_slab_rows

        pos_parts, own_parts, blk_pos_parts = [], [], []
        pos_off = 0
        for key in self._order:
            s = self.slabs[key]
            dfp = s["dfp"]
            positions = dfp._positions_np
            nb, nbp = s["nb"], s["nbp"]
            npos = int(positions.shape[0])
            ext = np.full(nbp, npos, dtype=np.int64)
            if npos:
                pos_cum = dfp.pos_cum_np()
                # per-block position offset within the slab
                bp = pos_cum[::128].astype(np.int64)
                # a term's flat position region starts exactly at its first
                # block's cumulative tf (positions are appended in (term,
                # block) order with no gaps)
                tbs = dfp.term_block_start
                if len(tbs) and not np.array_equal(
                    np.asarray(dfp.term_pos_start, dtype=np.int64), bp[tbs]
                ):
                    raise AssertionError(
                        "positions layout mismatch: term regions not "
                        "contiguous"
                    )
                ext[:nb] = bp[:nb]
                owners = np.repeat(dfp.docs_np.reshape(-1), dfp.real_tf_flat())
                if len(owners) != npos:
                    raise AssertionError(
                        f"{len(owners)} owners for {npos} positions"
                    )
                _check_term_order(positions, owners, dfp.term_pos_start)
                pos_parts.append(positions.astype(np.uint32, copy=False))
                own_parts.append(owners.astype(np.uint32, copy=False))
            blk_pos_parts.append(pos_off + ext)
            s["pos_offset"] = pos_off
            pos_off += npos
        total = pos_off
        # keep the widest slab window inside the store even when it is tiny
        rows = max(-(-total // 128), 1, max_slab_rows())
        rows_p = _row_tier(-(-rows // 8) * 8)
        padv = np.full(rows_p * 128 - total, np.uint32(0xFFFFFFFF), np.uint32)
        flat_pos = np.concatenate(pos_parts + [padv]).reshape(rows_p, 128)
        flat_own = np.concatenate(own_parts + [padv]).reshape(rows_p, 128)
        self.postore = _to_device(
            np.concatenate([flat_pos, flat_own], axis=1), self.device
        )
        self.blk_pos = (
            np.concatenate(blk_pos_parts + [[total]]) if blk_pos_parts
            else np.zeros(1, dtype=np.int64)
        )
        self.num_pos = total
        self.pos_rows = rows_p
        self._pos_dirty = False


def _check_term_order(positions, owners, term_pos_start) -> None:
    """Raise unless (owner, position) ascends inside every term's region
    of one slab (non-strictly: the kernel's searches are lower bounds)."""
    if len(positions) < 2:
        return
    key = (owners.astype(np.int64) << 32) | positions.astype(np.int64)
    down = np.diff(key) < 0
    # a new term may restart the order
    starts = np.asarray(term_pos_start, dtype=np.int64)
    starts = starts[(starts > 0) & (starts < len(positions))]
    down[starts - 1] = False
    if down.any():
        at = int(np.argmax(down)) + 1
        raise AssertionError(
            f"positions out of (owner, position) order at index {at}"
        )


def _to_device(store_u32: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(store_u32).view(np.int32)
    ).to(device)
