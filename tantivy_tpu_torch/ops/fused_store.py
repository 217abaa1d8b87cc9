"""FusedStore: every (segment, field) block store concatenated into one
row store on the executor's device, plus the host planning tables.

The layout is the reference's (`tantivy_tpu/ops/fused_store.py`), so a
global block id indexes both the device stores and the host tables:
* per-(segment, field) slab of cstore rows (`build_cstore_np`: docs | tfs |
  bitcast(bm25 denominator), NaN = deleted or padding lane), each padded to
  a multiple of 8 rows; the store pads to a row tier (`_row_tier`);
* host planning tables (blk_base, blk_last_doc, bfac, blk_seg)
  concatenated with the same padding;
* per-term regions through `region(seg_ord, field, term_ord)` and the
  composite keys `region_keys` the batched planner searches;
* `rmax`, a range-max table over `bfac` for block-max upper bounds.

`cstore` and the phrase position store `postore` are int32 tensors on the
store's device, and the per-block last docs and position offsets get one
device copy each, for the deep probe and the per-segment phrase probe; the
per-block first docs and `bfac` get one too, for the planner's UB sweep on
the card (`ub_tables`). int32 is lossless for `cstore` because every word
is < 2^31 (TERMINATED = 2^31 - 1, and cachev bits are those of a
non-negative f32 or NaN); `postore` keeps the reference's u32 words, whose
0xFFFFFFFF padding reads as -1. The port's merge tail has one form for
every segment and doc count, so the store sets no `pack_addr_ok`.

Several batches may use one store at once (`BatchExecutor.search_batches`,
each batch on its own CUDA stream). Registering a slab, rebuilding the
store and building the position store hold `lock`, and a new device tensor
is uploaded and its stream synchronised before it is published, so every
stream reads it whole. Slabs keep their rows when the store grows (new
slabs are appended), so a plan made against one build stays valid against
the next. A replaced `cstore`, `postore`, block-last, block-position or
UB-sweep tensor is marked as used by every stream that has read the store
(`Tensor.record_stream`), so the caching allocator hands its memory out
again only after the kernels those streams had queued have passed.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..postings.format import TERMINATED
from ..query.bm25 import compute_tf_cache


def build_cstore_np(docs_np, tfs_np, norm_ids_np, alive_np, cache):
    """The [NBp, 384] u32 combined row store of one (segment, field):
    docs | tfs | bitcast(tf-cache denominator), NaN marking deleted or
    padding lanes; rows padded to a multiple of 8."""
    max_doc = len(norm_ids_np)
    safe = np.minimum(docs_np, np.uint32(max(max_doc - 1, 0)))
    cachev = cache[norm_ids_np[safe].astype(np.int32)].astype(np.float32)
    dead = docs_np == np.uint32(TERMINATED)
    if alive_np is not None:
        dead |= ~alive_np[safe]
    cachev = np.where(dead, np.float32(np.nan), cachev)
    out = np.concatenate(
        [docs_np, tfs_np, cachev.view(np.uint32)], axis=1
    )
    nb = out.shape[0]
    pad = (-nb) % 8
    if pad:
        out = np.concatenate(
            [out, np.full((pad, 384), np.uint32(TERMINATED), np.uint32)]
        )
    return np.ascontiguousarray(out)


def _row_tier(rows: int, floor: int = 128) -> int:
    """Store rows pad up to a {1, 1.5}·pow2 ladder (waste <= 33%), as in
    the reference, so both stores stay row-for-row equal."""
    t = max(floor, 128)
    while t < rows:
        if t + t // 2 >= rows:
            return t + t // 2
        t *= 2
    return t


class FusedStore:
    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        #: held while slabs are registered and the device tensors rebuilt
        self.lock = threading.RLock()
        #: the CUDA streams that have read the store (`ready()`)
        self._streams: set = set()
        self.slabs: dict[tuple[int, str], dict] = {}
        self._order: list[tuple[int, str]] = []
        self._dirty = False
        # concatenated host tables (padded rows included)
        self.blk_base = np.zeros(0, dtype=np.uint32)
        self.blk_last_doc = np.zeros(0, dtype=np.uint32)
        self.bfac = np.zeros(0, dtype=np.float32)
        self.blk_seg = np.zeros(0, dtype=np.int32)
        self.num_blocks = 0
        self.cstore = None          # [NB, 384] int32 on `device`
        self._rmax = None
        self._rkeys = None
        self._blk_last_t = None
        self._ub_t = None           # (blk_base, bfac) on `device`
        # phrase extension, built on demand
        self.postore = None         # [NPr, 256] int32: positions | owners
        self.blk_pos = None         # host [NB + 1] i64 position offset
        self._blk_pos_t = None
        self._pos_dirty = False

    @classmethod
    def from_jax(cls, jax_fused, device="cpu") -> "FusedStore":
        """The port's store holding a reference store's state: its host
        tables as they are (the position tables `blk_pos`, `num_pos` and
        `pos_rows` included) and its cstore and, when built, its postore
        copied to `device`, so both kernels read the same stores. Reads
        attributes only; imports nothing of the reference."""
        jax_fused.ready()
        out = cls(device)
        device = out.device
        out.__dict__.update(
            {k: v for k, v in jax_fused.__dict__.items()
             if k not in ("cstore", "postore")}
        )
        out.device = device
        out._blk_last_t = None
        out._blk_pos_t = None
        out.cstore = _to_device(np.array(jax_fused.cstore), device)
        if jax_fused.postore is not None:
            out.postore = _to_device(np.array(jax_fused.postore), device)
        return out

    # -- slab registration -----------------------------------------------

    def ensure_slab(self, seg_ord: int, field: str, dfp, alive,
                    avg_fieldnorm) -> dict:
        """Register (and build, in numpy) the slab of a (segment, field).
        `alive` is a host bool mask or None. The whole store goes to the
        device in one transfer at the next `ready()`."""
        key = (seg_ord, field)
        with self.lock:
            slab = self.slabs.get(key)
            if slab is not None:
                return slab
            _check_region_order(dfp.blk_base, dfp.blk_last_doc,
                                dfp.term_block_start, dfp.term_num_blocks)
            cache = compute_tf_cache(np.float32(avg_fieldnorm))
            a = None if alive is None else np.asarray(alive, dtype=bool)
            cstore = build_cstore_np(
                dfp.docs_np, dfp.tfs_np, dfp.norm_ids_np, a, cache
            )
            nb = dfp.num_blocks
            nbp = -(-nb // 8) * 8
            tf = dfp.blk_max_tf.astype(np.float32)
            bfac = (tf / (tf + cache[dfp.blk_max_fnid])).astype(np.float32)
            slab = {
                "seg_ord": seg_ord,
                "field": field,
                "dfp": dfp,
                "cache": cache,
                "cstore": cstore,
                "nb": nb,
                "nbp": nbp,
                "bfac": bfac,
                "offset": -1,  # assigned at rebuild
            }
            self._order.append(key)
            # dirty before the slab is visible: whoever finds it calls
            # `ready()`, which then rebuilds before the offset is read
            self._dirty = True
            self._pos_dirty = True
            self.slabs[key] = slab
        return slab

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
        # row-for-row equal (and the widest boolean window stays in bounds)
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
        from ..parallel.wand import RangeMax

        bfac = np.concatenate(bfacs) if bfacs else np.zeros(0, np.float32)
        # ONE host concat + ONE device transfer for the whole store
        cstore = (
            self._upload(np.concatenate(stores, axis=0)) if stores else None
        )
        self._retire(self.cstore)
        self._retire(self._blk_last_t)
        for old in self._ub_t or ():
            self._retire(old)
        # published in one step: a reader without the lock sees the old
        # tables or the new ones, whose rows extend the old ones'
        self.__dict__.update(
            num_blocks=off,
            blk_base=(np.concatenate(bases) if bases
                      else np.zeros(0, np.uint32)),
            blk_last_doc=(np.concatenate(lasts) if lasts
                          else np.zeros(0, np.uint32)),
            bfac=bfac,
            blk_seg=np.concatenate(segs) if segs else np.zeros(0, np.int32),
            cstore=cstore,
            _rmax=RangeMax(bfac),
            _rkeys=None,
            _blk_last_t=None,
            _ub_t=None,
        )
        self._dirty = False

    def _upload(self, words: np.ndarray) -> torch.Tensor:
        """`words` (u32) as an int32 tensor on the store's device, its copy
        finished before any other stream may read it."""
        out = _to_device(words, self.device)
        if out.is_cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def _retire(self, old) -> None:
        """Keep the memory of a replaced device tensor from being handed out
        again before every stream that has read the store has passed the
        work it had queued when the tensor is freed."""
        if old is not None and old.is_cuda:
            for stream in self._streams:
                old.record_stream(stream)

    def _fresh(self):
        """Rebuild the tables and the device store when a slab was added."""
        if self._dirty:
            with self.lock:
                if self._dirty:
                    self._rebuild()
        return self

    def ready(self):
        """The store, rebuilt when a slab was added since the last build;
        on CUDA, the calling thread's current stream is noted as a reader
        (see `_retire`)."""
        self._fresh()
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            if stream not in self._streams:
                with self.lock:
                    self._streams.add(stream)
        return self

    @property
    def rmax(self):
        return self._fresh()._rmax

    @property
    def region_keys(self):
        """(cblast, cbbase) composite u64 keys: (term-region start << 32) |
        block last/base doc. Regions are contiguous and doc-sorted within,
        so one global searchsorted with a (region << 32 | doc) key answers
        a per-region bounds query. Padding rows key by their own block
        index, which keeps the array globally sorted."""
        with self.lock:
            self._fresh()
            if self._rkeys is not None:
                return self._rkeys
            rs = np.arange(self.num_blocks, dtype=np.uint64)
            for key in self._order:
                s = self.slabs[key]
                dfp = s["dfp"]
                tbs = np.asarray(dfp.term_block_start, dtype=np.int64)
                tnb = np.asarray(dfp.term_num_blocks, dtype=np.int64)
                starts = np.repeat(
                    np.uint64(s["offset"]) + tbs.astype(np.uint64), tnb
                )
                rs[s["offset"]:s["offset"] + len(starts)] = starts
            sh = np.uint64(32)
            cblast = (rs << sh) | self.blk_last_doc.astype(np.uint64)
            cbbase = (rs << sh) | self.blk_base.astype(np.uint64)
            assert len(cblast) < 2 or (
                np.all(cblast[1:] >= cblast[:-1])
                and np.all(cbbase[1:] >= cbbase[:-1])
            ), "composite region keys not globally sorted"
            self._rkeys = (cblast, cbbase)
            return self._rkeys

    def region(self, seg_ord: int, field: str, term_ord: int) -> tuple[int, int]:
        """(global block start, n_blocks) for a term of a registered slab."""
        self._fresh()
        s = self.slabs[(seg_ord, field)]
        dfp = s["dfp"]
        return (
            s["offset"] + int(dfp.term_block_start[term_ord]),
            int(dfp.term_num_blocks[term_ord]),
        )

    def clause_blocks_ub(self, start, n, weight, others, self_pos=0,
                         return_detail=False):
        """`FieldWand.clause_blocks_ub` over the fused tables."""
        from ..parallel.wand import FieldWand

        return FieldWand.clause_blocks_ub(
            self, start, n, weight, others, self_pos, return_detail
        )

    @property
    def dfp(self):
        # FieldWand.clause_blocks_ub reads self.dfp.blk_base/blk_last_doc
        return self

    def blk_last_device(self) -> torch.Tensor:
        """`blk_last_doc` as an int32 tensor on the store's device (every
        entry is <= TERMINATED), copied once per store build: the deep
        probe's block searches read it."""
        with self.lock:
            self._fresh()
            if self._blk_last_t is None:
                self._blk_last_t = self._upload(self.blk_last_doc)
            return self._blk_last_t

    def ub_tables(self) -> tuple:
        """(blk_base, blk_last_doc, bfac) on the store's device, the first
        two int32 holding u32 docs, `bfac` f32: the tables the planner's UB
        sweep reads (`ops/ub_sweep.py`). `blk_last_doc` is the deep probe's
        copy; the other two are copied once per store build."""
        with self.lock:
            self._fresh()
            if self._ub_t is None:
                self._ub_t = (
                    self._upload(self.blk_base),
                    self._upload(self.bfac.view(np.uint32)).view(
                        torch.float32),
                )
            base, bfac = self._ub_t
            return base, self.blk_last_device(), bfac

    # -- phrase position store ---------------------------------------------

    def position_tensors(self):
        """(postore, blk_pos) on the store's device, built together: the
        position store (`ensure_positions`) and `blk_pos` as int32 [R + 1],
        one entry per cstore row of the build it was made for and the
        position count after them (rows past the slabs hold that count).
        The per-segment phrase kernel reads a doc's positions from its
        row's entry."""
        with self.lock:
            self.ensure_positions()
            if self._blk_pos_t is None:
                bp = np.full(self.cstore.shape[0] + 1, self.num_pos,
                             dtype=np.int64)
                bp[:len(self.blk_pos)] = self.blk_pos
                if bp.max(initial=0) >= 2**31:
                    raise ValueError("position offsets do not fit int32")
                self._blk_pos_t = self._upload(bp.astype(np.uint32))
            return self.postore, self._blk_pos_t

    def ensure_positions(self):
        """Build the fused position store and the per-block position
        offsets, as the reference does: `postore` [NPr, 256] holds
        positions 128r..128r+127 in columns 0:128 and each position's owner
        doc in columns 128:256, padded with 0xFFFFFFFF (int32 -1 here);
        `blk_pos[b]` is the global index of block b's first position.

        A slab whose field records no positions contributes none (the
        reference asserts there). Every other slab is checked once for the
        order the phrase kernel's merges need: inside each term's region,
        positions ascend by (owner doc, position)."""
        with self.lock:
            self._fresh()
            if self.postore is None or self._pos_dirty:
                self._build_positions()

    def _build_positions(self) -> None:
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
        postore = self._upload(np.concatenate([flat_pos, flat_own], axis=1))
        self._retire(self.postore)
        self._retire(self._blk_pos_t)
        self.__dict__.update(
            postore=postore,
            blk_pos=(np.concatenate(blk_pos_parts + [[total]])
                     if blk_pos_parts else np.zeros(1, dtype=np.int64)),
            num_pos=total,
            pos_rows=rows_p,
            _blk_pos_t=None,
        )
        self._pos_dirty = False


def _check_region_order(blk_base, blk_last_doc, term_block_start,
                        term_num_blocks) -> None:
    """Raise unless, inside every term's region of one slab, each block
    holds a doc and docs ascend strictly from block to block (blk_base[b]
    <= blk_last_doc[b] < blk_base[b + 1]). The boolean kernels' fence
    searches rely on it: a doc can then lie only in the last region row
    whose first doc is <= it."""
    base = np.asarray(blk_base, dtype=np.int64)
    last = np.asarray(blk_last_doc, dtype=np.int64)
    bad = (base == TERMINATED) | (last < base)
    # the block index b of every step b -> b + 1 inside a region
    starts = np.asarray(term_block_start, dtype=np.int64)
    steps = np.maximum(np.asarray(term_num_blocks, dtype=np.int64) - 1, 0)
    inner = (np.repeat(starts - np.cumsum(steps) + steps, steps)
             + np.arange(int(steps.sum())))
    at_step = inner[last[inner] >= base[inner + 1]]
    bad[at_step] = True
    if bad.any():
        at = int(np.argmax(bad))
        raise AssertionError(
            f"block {at}: docs do not ascend strictly across the blocks of "
            "its term region"
        )


def _check_term_order(positions, owners, term_pos_start) -> None:
    """Raise unless (owner, position) ascends inside every term's region
    of one slab (non-strictly: the kernel's merges take lower bounds)."""
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
