"""Merge tails (kernel K8): the CUDA kernels' wrapper, launch counters and
dispatch.

K8 is the whole of the reference's two XLA merge tails:
`per_query_topk_from_rows` (`tantivy_tpu/ops/probe_scorer.py:120`), which
every per-segment probe launch (K3, K4, K6) and packed mode (K5) ends in,
and
`per_query_topk_rows_seg` (`:178`), which the fused chains (K1, K2) end
in. The kernel source and a note on its design are in
`tantivy_tpu_torch/csrc/merge_tail.cu`; its plain twins are
`probe_scorer.per_query_topk_from_rows` and `per_query_topk_rows_seg`.

A call takes one launch's [W, kk] per-row candidates (scores f32, docs
int32 holding u32 bits), a qid a row [W] int32 and, in the seg form, a
segment a row [W] int32, and gives each query's top-k packed as the
callers return it:
* `topk_from_rows`: [2, Q, k] int32 (`probe_scorer.pack_results`: score
  bits | doc), ordered (score desc, doc asc as u32), no dedup;
* `topk_rows_seg`: [3, Q, k] int32 (`pack_results_seg`: score bits | doc |
  seg), ordered (score desc, seg asc, doc asc), duplicate (seg, doc)
  addresses of a query deduplicated keeping the max score before the cut.
-inf candidates are dropped, rows whose qid lies outside [0, num_queries)
ignored; -inf / 0 / 0 past a query's hits.

Dispatch: CPU tensors take the twin; CUDA tensors launch K8, one kernel a
call, at any k (it counts in `launches`, and by name in
`launches_by_kernel`: `tail_small` for a small call, one CTA a query;
else `tail`, the cooperative grid kernel, or `tail_global`, the same with
its sort arrays in global scratch for a k above `smem_max_k()`; the C
side picks the kernel from the call's shape). When `rec` is a dict (the
launch-log record of the kernel round whose candidates these are), the
call's form and inputs are stored in it under "tail".
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .probe_scorer import (
    check_tensor,
    pack_results,
    pack_results_seg,
    per_query_topk_from_rows,
    per_query_topk_rows_seg,
)

#: CUDA launches since the last reset (the CPU twin does not count), and
#: the same by kernel (`tail_small`, `tail`, `tail_global`); batches in
#: flight on several threads add to them under `_count_lock`
launches = 0
launches_by_kernel: dict[str, int] = {}
_count_lock = threading.Lock()

#: the largest kk the kernels take
MAX_KK = 128
#: the kernels that one call launches
KERNELS_PER_CALL = 1
#: each kernel `merge_tail_launch` reports by its name
PATH_NAMES = ("tail", "tail_global", "tail_small")


def topk_from_rows(row_sc, row_doc, qid, k: int, num_queries: int, *,
                   rec: dict | None = None):
    """Each query's top-k of [W, kk] per-row candidates, no dedup: packed
    [2, Q, k] int32 (score bits | doc)."""
    return _tail(False, row_sc, row_doc, None, qid, k, num_queries, rec)


def topk_rows_seg(row_sc, row_doc, row_seg, qid, k: int, num_queries: int,
                  *, rec: dict | None = None):
    """Each query's top-k of [W, kk] per-row candidates over segments, its
    duplicate addresses deduplicated keeping the max: packed [3, Q, k]
    int32 (score bits | doc | seg)."""
    return _tail(True, row_sc, row_doc, row_seg, qid, k, num_queries, rec)


def twin(row_sc, row_doc, row_seg, qid, k: int, num_queries: int):
    """Plain PyTorch version of a call, packed as the kernel packs it: the
    seg form when `row_seg` is given, else the rows form."""
    if row_seg is None:
        return pack_results(*per_query_topk_from_rows(
            row_sc, row_doc, qid, k, num_queries))
    return pack_results_seg(*per_query_topk_rows_seg(
        row_sc, row_doc, row_seg, qid, k, num_queries))


def _check(row_sc, row_doc, row_seg, qid, k: int, num_queries: int) -> None:
    dev = row_sc.device
    check_tensor("row_sc", row_sc, torch.float32, 2, dev)
    check_tensor("row_doc", row_doc, torch.int32, 2, dev)
    check_tensor("qid", qid, torch.int32, 1, dev)
    W, kk = row_sc.shape
    if tuple(row_doc.shape) != (W, kk) or qid.shape[0] != W:
        raise ValueError(f"row_doc {tuple(row_doc.shape)} and qid "
                         f"{tuple(qid.shape)} do not match row_sc {(W, kk)}")
    if row_seg is not None:
        check_tensor("row_seg", row_seg, torch.int32, 1, dev)
        if row_seg.shape[0] != W:
            raise ValueError(f"row_seg has {row_seg.shape[0]} rows, not {W}")
    if not 1 <= kk <= MAX_KK:
        raise ValueError(f"kk={kk} outside 1..{MAX_KK}")
    if not (1 <= k < 1 << 31 and 1 <= num_queries < 1 << 31):
        raise ValueError(f"k={k} and num_queries={num_queries} must be at "
                         "least 1 and fit 31 bits")
    if W >= 1 << 31:
        raise ValueError(f"{W} rows: row indices must fit 31 bits")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"merge_tail runs on cuda or cpu, not {dev}")


def _tail(seg: bool, row_sc, row_doc, row_seg, qid, k: int,
          num_queries: int, rec):
    _check(row_sc, row_doc, row_seg, qid, k, num_queries)
    if rec is not None:
        rec["tail"] = dict(form="seg" if seg else "rows",
                           args=(row_sc, row_doc, row_seg, qid, k,
                                 num_queries))
    dev = row_sc.device
    if dev.type == "cpu":
        return twin(row_sc, row_doc, row_seg, qid, k, num_queries)
    W, kk = row_sc.shape
    out = torch.empty((3 if seg else 2, num_queries, k), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _counted(*_launch(seg, row_sc, row_doc, row_seg, qid, W, kk, k,
                          num_queries, out, stream))
    return out


def _launch(seg: bool, row_sc, row_doc, row_seg, qid, W: int, kk: int,
            k: int, num_queries: int, out, stream):
    """Launches one call's kernel into `out` on `stream`: (the CUDA error
    code, the kernel's name)."""
    lib = _lib()
    n = lib.merge_tail_scratch_bytes(1 if seg else 0, W, kk, num_queries,
                                     k)
    if n < 0:
        raise RuntimeError("merge_tail: no scratch size for this call on "
                           "the current device")
    scratch = torch.empty(n, dtype=torch.uint8, device=out.device)
    path = ctypes.c_int(0)
    err = lib.merge_tail_launch(
        1 if seg else 0, row_sc.data_ptr(), row_doc.data_ptr(),
        row_seg.data_ptr() if seg else None, qid.data_ptr(), W, kk,
        num_queries, k, scratch.data_ptr(), out.data_ptr(), stream,
        ctypes.byref(path))
    return err, PATH_NAMES[path.value]


def smem_max_k() -> int:
    """The largest k whose sort arrays the kernel keeps in shared
    memory."""
    return _lib().merge_tail_smem_max_k()


def reset_counts() -> None:
    """Set `launches` and `launches_by_kernel` to zero."""
    global launches
    with _count_lock:
        launches = 0
        launches_by_kernel.clear()


def _counted(err: int, kernel: str) -> None:
    global launches
    if err != 0:
        raise RuntimeError(f"merge_tail {kernel} kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        launches += 1
        launches_by_kernel[kernel] = launches_by_kernel.get(kernel, 0) + 1


def signatures() -> dict:
    """Each C entry point's ctypes (argtypes, restype)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return {
        "merge_tail_scratch_bytes": ([i, i, i, i, i], ctypes.c_longlong),
        "merge_tail_smem_max_k": ([], ctypes.c_int),
        "merge_tail_launch": ([
            i, p, p, p, p,         # seg_form, scores, docs, segs, qids
            i, i, i, i,            # n_rows, kk, num_queries, k
            p, p, p,               # scratch, out, stream
            ctypes.POINTER(i),     # path: the kernel launched
        ], ctypes.c_int),
        "merge_tail_occupancy": ([i, i, i, i, p, p, p], ctypes.c_int),
    }


def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("merge_tail")
    if lib.merge_tail_scratch_bytes.argtypes is None:
        for name, (args, res) in signatures().items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib
