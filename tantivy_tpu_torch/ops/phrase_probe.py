"""Phrase position-probe scorer (kernel K2): the CUDA kernel's wrapper and
its plain PyTorch twin.

Replaces the Pallas kernel `_phrase_kernel_body` / `_phrase_rows` of
`tantivy_tpu/ops/pallas_phrase.py`. The kernel source and a note on its
design are in `tantivy_tpu_torch/csrc/phrase_probe.cu`.

Inputs, per launch chunk of W groups (a group = up to 8 anchor-term blocks
of one plan row, gated by a member mask):
* `rows` [W, STRIDE] i32 — one scalar row per group, slots as in
  `fused_phrase._phrase_scal_layout`: 0=row_base, 1=prow, 2=member mask,
  3=arow0, 4+2s=crow0_s, 5+2s=delta_s, then per member r at A = 4 + 2S:
  A+r=loff_r, A+8+r=llen_r, A+16+16s+r=off_rs, A+24+16s+r=len_rs. Offsets
  count positions from the first position of the slab's first row;
* `qw` [Pp] f32 phrase weight and `row_th` [Pp] f32 threshold per plan row;
* `cstore` [NB, 384] i32 (docs | tfs | bitcast(cachev));
* `postore` [NPr, 256] i32: 128 positions, then their 128 owner docs (the
  store's 0xFFFFFFFF padding reads as -1).

A lane doc d of member r has tf = the number of anchor positions p in the
member's anchor sub-range owned by d such that every partner s with a
non-empty sub-range holds a position owned by d at p + delta_s (int32
arithmetic). Sub-ranges are cut to the `slab_rows` window that starts at
the slab's row. A lane scores `qw * tf / (tf + cachev)` when it is alive
and tf > 0. Output: per group its top-kk scoring lanes with score >=
row_th, scores [W, kk] f32 and docs [W, kk] i32, ordered (score desc, flat
index r*128 + lane asc); -inf / TERMINATED fill.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..postings.format import TERMINATED

from .probe_scorer import check_tensor, group_topk

#: kernel launches since the last reset (the CPU twin does not count);
#: batches in flight on several threads add to it under `_count_lock`
launches = 0
_count_lock = threading.Lock()

#: groups the twin scores at once, bounding its per-position temporaries
_TWIN_CHUNK = 4096

_U32 = 0xFFFFFFFF

MAX_PARTNERS = 7


def _slab_elements(start, length, row0, member, lim):
    """Flat (member slot, global position index) pairs of the per-member
    sub-ranges [start, start + length), cut to `lim[g]` positions of the
    window that starts at slab row `row0[g]`. start/length [n, 8]."""
    n = start.shape[0]
    end = torch.minimum(start + length, lim[:, None])
    lo = start.clamp(min=0)
    cnt = torch.where(member & (length > 0), (end - lo).clamp(min=0), 0)
    cnt = cnt.reshape(-1)
    slot = torch.repeat_interleave(
        torch.arange(n * 8, device=start.device), cnt
    )
    first = torch.cumsum(cnt, 0) - cnt
    off = torch.arange(len(slot), device=start.device) - first[slot]
    gpos = row0[slot // 8] * 128 + lo.reshape(-1)[slot] + off
    return slot, gpos


def phrase_probe_ref(rows, qw, row_th, cstore, postore, *, n_partners: int,
                     slab_rows: int, num_prows: int, kk: int):
    """Plain PyTorch version of the kernel, vectorised over groups.

    Partner membership is `torch.isin` on int64 keys (member lane << 32) |
    u32(position), with the anchor's target position p + delta wrapped as
    int32, so it does not rely on the order of positions in the store. The
    f32 score is three correctly rounded torch ops, as in the kernel."""
    W = rows.shape[0]
    S = n_partners
    A = 4 + 2 * S
    dev = rows.device
    nb = cstore.shape[0]
    npr = postore.shape[0]
    out_sc = torch.full((W, kk), float("-inf"), dtype=torch.float32,
                        device=dev)
    out_doc = torch.full((W, kk), TERMINATED, dtype=torch.int32, device=dev)
    r8 = torch.arange(8, device=dev)
    pos_all = postore[:, :128]
    own_all = postore[:, 128:]

    def read(gpos):
        return pos_all[gpos // 128, gpos % 128], own_all[gpos // 128,
                                                         gpos % 128]

    for lo in range(0, W, _TWIN_CHUNK):
        r = rows[lo:lo + _TWIN_CHUNK].long()
        n = r.shape[0]
        prow, mask = r[:, 1], r[:, 2]
        live = (mask != 0) & (prow >= 0) & (prow < num_prows)
        p = prow.clamp(0, qw.shape[0] - 1)
        member = live[:, None] & (((mask[:, None] >> r8) & 1) == 1)
        lane_rows = cstore[(r[:, :1] + r8).clamp(0, nb - 1)]   # [n, 8, 384]
        docs = lane_rows[..., :128]
        cachev = lane_rows[..., 256:].view(torch.float32)
        # (member slot << 32) | doc ascends: docs ascend along a row
        slot_ids = torch.arange(n * 8, device=dev).reshape(n, 8, 1)
        dkey = ((slot_ids << 32) | docs.long()).reshape(-1)

        def lane_of(slot, own):
            """Index slot*128 + lane of the lane holding doc `own`."""
            key = (slot << 32) | (own.long() & _U32)
            idx = torch.searchsorted(dkey, key).clamp(max=len(dkey) - 1)
            return idx, (own >= 0) & (dkey[idx] == key)

        def lim(row0):
            return torch.clamp((npr - row0) * 128, max=slab_rows * 128)

        arow0 = r[:, 3]
        a_slot, a_gpos = _slab_elements(
            r[:, A:A + 8], r[:, A + 8:A + 16], arow0, member, lim(arow0)
        )
        a_pos, a_own = read(a_gpos)
        a_lane, ok = lane_of(a_slot, a_own)
        for s in range(S):
            crow0 = r[:, 4 + 2 * s]
            delta = r[:, 5 + 2 * s]
            plen = r[:, A + 24 + 16 * s:A + 32 + 16 * s]
            c_slot, c_gpos = _slab_elements(
                r[:, A + 16 + 16 * s:A + 24 + 16 * s], plen, crow0, member,
                lim(crow0),
            )
            c_pos, c_own = read(c_gpos)
            c_lane, c_ok = lane_of(c_slot, c_own)
            have = (c_lane[c_ok] << 32) | (c_pos[c_ok].long() & _U32)
            tgt = (a_pos.long() + delta[a_slot // 8]) & _U32
            hit = torch.isin((a_lane << 32) | tgt, have)
            empty = plen.reshape(-1)[a_slot] <= 0
            ok = ok & (hit | empty)
        count = torch.zeros(n * 8 * 128, dtype=torch.int32, device=dev)
        count.index_add_(
            0, a_lane[ok],
            torch.ones(int(ok.sum()), dtype=torch.int32, device=dev),
        )
        count = count.reshape(n, 8, 128)
        tf = count.float()
        score = qw[p][:, None, None] * (tf / (tf + cachev))
        lane_ok = (
            member[..., None] & (docs != TERMINATED) & ~torch.isnan(cachev)
            & (count > 0)
        )
        sc = torch.where(lane_ok, score, float("-inf")).reshape(n, 8 * 128)
        out_sc[lo:lo + n], out_doc[lo:lo + n] = group_topk(
            sc, docs.reshape(n, 8 * 128), row_th[p], kk
        )
    return out_sc, out_doc


def phrase_probe(rows, qw, row_th, cstore, postore, *, n_partners: int,
                 slab_rows: int, num_prows: int, kk: int):
    """Score one launch chunk: (scores [W, kk] f32, docs [W, kk] i32).

    CUDA tensors launch the kernel; CPU tensors take `phrase_probe_ref`."""
    global launches
    dev = rows.device
    check_tensor("rows", rows, torch.int32, 2, dev)
    check_tensor("qw", qw, torch.float32, 1, dev)
    check_tensor("row_th", row_th, torch.float32, 1, dev)
    if row_th.shape[0] != qw.shape[0]:
        raise ValueError(
            f"row_th has {row_th.shape[0]} rows, qw {qw.shape[0]}"
        )
    check_tensor("cstore", cstore, torch.int32, 2, dev)
    if cstore.shape[1] != 384:
        raise ValueError(f"cstore rows hold {cstore.shape[1]} words, not 384")
    check_tensor("postore", postore, torch.int32, 2, dev)
    if postore.shape[1] != 256:
        raise ValueError(
            f"postore rows hold {postore.shape[1]} words, not 256"
        )
    if not 1 <= n_partners <= MAX_PARTNERS:
        raise ValueError(f"{n_partners} partners outside 1..{MAX_PARTNERS}")
    if not 20 + 18 * n_partners <= rows.shape[1] <= 256:
        raise ValueError(
            f"scalar stride {rows.shape[1]} does not fit {n_partners} "
            "partners"
        )
    if not 8 <= slab_rows <= postore.shape[0]:
        raise ValueError(
            f"slab_rows={slab_rows} outside 8..{postore.shape[0]}"
        )
    if not 1 <= kk <= 128:
        raise ValueError(f"kk={kk} outside 1..128")
    if not 0 <= num_prows < qw.shape[0]:
        raise ValueError(
            f"num_prows={num_prows} outside the {qw.shape[0]}-row tables"
        )
    kw = dict(n_partners=n_partners, slab_rows=slab_rows,
              num_prows=num_prows, kk=kk)
    if dev.type == "cpu":
        return phrase_probe_ref(rows, qw, row_th, cstore, postore, **kw)
    if dev.type != "cuda":
        raise ValueError(f"phrase_probe runs on cuda or cpu, not {dev}")
    if cstore.data_ptr() % 16 or postore.data_ptr() % 16:
        raise ValueError(
            "cstore and postore must start on a 16-byte boundary (the "
            "kernel copies them in 16-byte pieces)"
        )
    lib = _lib()
    W = rows.shape[0]
    out_sc = torch.empty((W, kk), dtype=torch.float32, device=dev)
    out_doc = torch.empty((W, kk), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.phrase_probe_launch(
            rows.data_ptr(), W, rows.shape[1], n_partners, slab_rows,
            qw.data_ptr(), row_th.data_ptr(), num_prows,
            cstore.data_ptr(), cstore.shape[0], postore.data_ptr(),
            postore.shape[0], kk, out_sc.data_ptr(), out_doc.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"phrase_probe kernel launch failed: CUDA error {err}"
        )
    with _count_lock:
        launches += 1
    return out_sc, out_doc


def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("phrase_probe")
    if lib.phrase_probe_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.phrase_probe_launch.argtypes = [
            p, i, i, i, i,         # rows, n_groups, stride, partners, slab
            p, p, i,               # qw, row_th, num_prows
            p, ll, p, ll,          # cstore, its rows, postore, its rows
            i, p, p, p,            # kk, out_scores, out_docs, stream
        ]
        lib.phrase_probe_launch.restype = ctypes.c_int
    return lib
