"""Boolean group-probe scorer (kernel K1): the CUDA kernel's wrapper and its
plain PyTorch twin.

Replaces the Pallas kernel `_grp_kernel_body` / `_grp_rows` of
`tantivy_tpu/ops/pallas_probe.py`. The kernel source and a note on its
design are in `tantivy_tpu_torch/csrc/group_probe.cu`.

Inputs, per launch chunk of W groups:
* `rows` [W, STRIDE] i32 — one scalar row per group, slots as in
  `fused_bool._grp_scal_layout`: 0=row_base, 1=prow, 2=lcl, 3=member mask,
  4+t=jlo_t (-1 = no probe), then at 4+T+8t+r member r's packed clause-t
  sub-window (off << 8) | len;
* plan-row tables `cl_weight` [Pp, T] f32, `cl_kind`/`cl_shipped` [Pp, T]
  i32, `req_must`/`req_should` [Pp] i32, `row_th` [Pp] f32;
* `cstore` [NB, 384] i32 (docs | tfs | bitcast(cachev)).

Output: per group its top-kk reporting lanes, scores [W, kk] f32 and docs
[W, kk] i32, ordered (score desc, flat index asc); -inf / TERMINATED fill.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..postings.format import TERMINATED

from .probe_scorer import (
    KIND_MUST,
    KIND_MUST_NOT,
    KIND_SHOULD,
    T_MAX,
    check_tensor,
    group_topk,
)

#: kernel launches since the last reset (the CPU twin does not count);
#: batches in flight on several threads add to it under `_count_lock`
launches = 0
_count_lock = threading.Lock()

#: groups the twin scores at once, bounding its [n, 8, 128] temporaries
_TWIN_CHUNK = 4096


def group_probe_ref(rows, cl_weight, cl_kind, cl_shipped, req_must,
                    req_should, row_th, cstore, *, num_prows: int, kk: int):
    """Plain PyTorch version of the kernel, vectorised over groups.

    Each f32 operation is one correctly rounded torch op in the kernel's
    clause order, so it matches the kernel bit for bit."""
    W = rows.shape[0]
    T = cl_weight.shape[1]
    dev = rows.device
    nb = cstore.shape[0]
    out_sc = torch.full((W, kk), float("-inf"), dtype=torch.float32,
                        device=dev)
    out_doc = torch.full((W, kk), TERMINATED, dtype=torch.int32, device=dev)
    r8 = torch.arange(8, device=dev)
    for lo in range(0, W, _TWIN_CHUNK):
        r = rows[lo:lo + _TWIN_CHUNK].long()
        n = r.shape[0]
        prow, lcl, mask = r[:, 1], r[:, 2], r[:, 3]
        live = (mask != 0) & (prow >= 0) & (prow < num_prows)
        p = prow.clamp(0, cl_weight.shape[0] - 1)
        lrow = r[:, :1] + r8                                  # [n, 8]
        member = (
            live[:, None] & (((mask[:, None] >> r8) & 1) == 1)
            & (lrow >= 0) & (lrow < nb)
        )
        lane_rows = cstore[lrow.clamp(0, nb - 1)]             # [n, 8, 384]
        docs = lane_rows[..., :128]
        tfs = lane_rows[..., 128:256]
        cachev = lane_rows[..., 256:].view(torch.float32)
        lane_ok = (
            member[..., None] & (docs != TERMINATED) & ~torch.isnan(cachev)
        )
        score = torch.zeros((n, 8, 128), dtype=torch.float32, device=dev)
        cnt_must = torch.zeros((n, 8, 128), dtype=torch.int32, device=dev)
        cnt_should = torch.zeros_like(cnt_must)
        has_not = torch.zeros((n, 8, 128), dtype=torch.bool, device=dev)
        primary = torch.full((n, 8, 128), T_MAX + 1, dtype=torch.int32,
                             device=dev)
        weight, kind, ship = cl_weight[p], cl_kind[p], cl_shipped[p]
        for t in range(T):
            packed = r[:, 4 + T + 8 * t:4 + T + 8 * t + 8]    # [n, 8]
            off, ln = packed >> 8, packed & 255
            jlo = r[:, 4 + t:5 + t]
            probe = member & (ln > 0) & (jlo >= 0)
            found = torch.zeros((n, 8, 128), dtype=torch.bool, device=dev)
            tf_probe = torch.zeros((n, 8, 128), dtype=torch.int32,
                                   device=dev)
            max_len = int(ln[probe].max()) if bool(probe.any()) else 0
            for i in range(max_len):
                j = jlo + off + i
                gi, ri = torch.nonzero(probe & (ln > i) & (j < nb),
                                       as_tuple=True)
                if not len(gi):
                    continue
                win = cstore[j[gi, ri]]                       # [m, 384]
                win_docs = win[:, :128].contiguous()
                want = docs[gi, ri]                           # [m, 128]
                pos = torch.searchsorted(win_docs, want).clamp(max=127)
                hit = win_docs.gather(1, pos) == want
                found[gi, ri] |= hit
                tf_probe[gi, ri] += torch.where(
                    hit, win[:, 128:256].gather(1, pos), 0
                )
            own = (lcl == t)[:, None, None]
            present = found | own
            tf = torch.where(own, tfs, tf_probe).float()
            kd = kind[:, t, None, None]
            contrib = weight[:, t, None, None] * (tf / (tf + cachev))
            positive = present & ((kd == KIND_MUST) | (kd == KIND_SHOULD))
            score = score + torch.where(positive, contrib, 0.0)
            cnt_must += (present & (kd == KIND_MUST)).int()
            cnt_should += (present & (kd == KIND_SHOULD)).int()
            has_not |= present & (kd == KIND_MUST_NOT)
            is_prim = present & (ship[:, t, None, None] > 0) & (
                primary > T_MAX
            )
            primary = torch.where(is_prim, t, primary)
        ok = (
            lane_ok
            & (lcl[:, None, None] <= primary)
            & (cnt_must >= req_must[p][:, None, None])
            & (cnt_should >= req_should[p][:, None, None])
            & ~has_not
        )
        sc = torch.where(ok, score, float("-inf")).reshape(n, 8 * 128)
        out_sc[lo:lo + n], out_doc[lo:lo + n] = group_topk(
            sc, docs.reshape(n, 8 * 128), row_th[p], kk
        )
    return out_sc, out_doc


def group_probe(rows, cl_weight, cl_kind, cl_shipped, req_must, req_should,
                row_th, cstore, *, num_prows: int, kk: int):
    """Score one launch chunk: (scores [W, kk] f32, docs [W, kk] i32).

    CUDA tensors launch the kernel; CPU tensors take `group_probe_ref`."""
    global launches
    dev = rows.device
    check_tensor("rows", rows, torch.int32, 2, dev)
    check_tensor("cl_weight", cl_weight, torch.float32, 2, dev)
    Pp, T = cl_weight.shape
    for name, x in (("cl_kind", cl_kind), ("cl_shipped", cl_shipped)):
        check_tensor(name, x, torch.int32, 2, dev)
        if tuple(x.shape) != (Pp, T):
            raise ValueError(f"{name} shape {tuple(x.shape)} != {(Pp, T)}")
    for name, x, dt in (("req_must", req_must, torch.int32),
                        ("req_should", req_should, torch.int32),
                        ("row_th", row_th, torch.float32)):
        check_tensor(name, x, dt, 1, dev)
        if x.shape[0] != Pp:
            raise ValueError(f"{name} has {x.shape[0]} rows, want {Pp}")
    check_tensor("cstore", cstore, torch.int32, 2, dev)
    if cstore.shape[1] != 384:
        raise ValueError(f"cstore rows hold {cstore.shape[1]} words, not 384")
    if not 1 <= T <= T_MAX:
        raise ValueError(f"{T} clauses outside 1..{T_MAX}")
    if not 4 + 9 * T <= rows.shape[1] <= 256:
        raise ValueError(f"scalar stride {rows.shape[1]} does not fit T={T}")
    if not 1 <= kk <= 128:
        raise ValueError(f"kk={kk} outside 1..128")
    if not 0 <= num_prows < Pp:
        raise ValueError(f"num_prows={num_prows} outside the {Pp}-row tables")
    if dev.type == "cpu":
        return group_probe_ref(
            rows, cl_weight, cl_kind, cl_shipped, req_must, req_should,
            row_th, cstore, num_prows=num_prows, kk=kk,
        )
    if dev.type != "cuda":
        raise ValueError(f"group_probe runs on cuda or cpu, not {dev}")
    lib = _lib()
    W = rows.shape[0]
    out_sc = torch.empty((W, kk), dtype=torch.float32, device=dev)
    out_doc = torch.empty((W, kk), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.group_probe_launch(
            rows.data_ptr(), W, rows.shape[1], T, cl_weight.data_ptr(),
            cl_kind.data_ptr(), cl_shipped.data_ptr(), req_must.data_ptr(),
            req_should.data_ptr(), row_th.data_ptr(), num_prows,
            cstore.data_ptr(), cstore.shape[0], kk, out_sc.data_ptr(),
            out_doc.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"group_probe kernel launch failed: CUDA error {err}")
    with _count_lock:
        launches += 1
    return out_sc, out_doc


def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("group_probe")
    if lib.group_probe_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.group_probe_launch.argtypes = [
            p, i, i, i,            # rows, n_groups, stride, n_clauses
            p, p, p,               # cl_weight, cl_kind, cl_ship
            p, p, p,               # req_must, req_should, row_th
            i, p, ctypes.c_longlong, i,  # num_prows, cstore, rows, kk
            p, p, p,               # out_scores, out_docs, stream
        ]
        lib.group_probe_launch.restype = ctypes.c_int
    return lib
