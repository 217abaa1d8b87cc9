"""The fused boolean planner's block-max UB sweep on the card: the CUDA
kernel's wrapper, launch counter and the planner's glue.

`parallel.wand.batched_clause_details` bounds every block of every
(segment, query, positive clause) of a batch against the query's other
clauses in numpy. `clause_details` gives the same per-call detail dicts,
bit for bit, from one launch of `csrc/ub_sweep.cu` (which holds the design
note): the calls packed into one int32 table and uploaded in one copy, the
flat outputs brought back in one copy into page-locked memory. That memory
comes from PyTorch's caching host allocator, which hands the same block to
the next batch once the views of this one are gone (one block for each
batch in flight, whatever its stream). The dicts hold views of it, cut as
the numpy version cuts its arrays.

A call is `(start, n, weight, others, self_pos)` with `others` =
[(is_must, w2, s2, n2, pos)], as `FieldWand.clause_blocks_ub` takes it;
clause positions are distinct within a call. Each other region holds
n2 >= 1 blocks wherever the planner makes a call (a term of a segment's
dictionary has a block); the kernel searches the region alone, which for
n2 = 0 gives `clause_blocks_ub`'s empty range [s2, s2).

Dispatch: a store on a CUDA device launches the kernel, one a sweep with
block rows, counted in `launches`; any other store takes the numpy
`batched_clause_details` itself, which is also the twin the tests hold the
kernel to.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..parallel.wand import batched_clause_details
from .probe_scorer import check_tensor

#: CUDA launches since the last reset; batches in flight on several threads
#: add to it under `_count_lock`
launches = 0
_count_lock = threading.Lock()

#: flags of a call's own entry in the entry table; an other's holds its
#: column, with `_MUST` set for a MUST clause
_SELF = -1
_MUST = 1 << 16


class Packed:
    """A batch of calls as the kernel takes them: `tables` (int32: the row
    offsets [C + 1], the call table [C, 4] of start, entry start, entry end
    and pair-row offset, the entry table [E, 4] of s2, n2, weight bits and
    flags, each call's entries its own included in ascending clause
    position), the counts, and what `unpack` needs to cut the outputs."""

    def __init__(self, calls: list):
        C = len(calls)
        ns = np.fromiter((c[1] for c in calls), np.int64, C)
        starts = np.fromiter((c[0] for c in calls), np.int64, C)
        o_ns = np.fromiter((len(c[3]) for c in calls), np.int64, C)
        flat = [o for c in calls for o in c[3]]
        n_o = len(flat)
        row_off = np.zeros(C + 1, np.int64)
        np.cumsum(ns, out=row_off[1:])
        pair_cnt = ns * o_ns
        pair_off = np.cumsum(pair_cnt) - pair_cnt
        R, P = int(row_off[-1]), int(pair_cnt.sum())
        if max(R, P, int(starts.max(initial=0)) + 1) >= 1 << 31:
            raise ValueError(f"{R} rows and {P} pair rows must fit 31 bits")
        col = np.arange(n_o, dtype=np.int64) - np.repeat(
            np.cumsum(o_ns) - o_ns, o_ns)
        must = np.fromiter((bool(o[0]) for o in flat), bool, n_o)
        # the others' entries, then each call's own
        ent_call = np.concatenate([np.repeat(np.arange(C), o_ns),
                                   np.arange(C)])
        ent_pos = np.concatenate([
            np.fromiter((int(o[4]) for o in flat), np.int64, n_o),
            np.fromiter((int(c[4]) for c in calls), np.int64, C)])
        ent_col = np.concatenate([col, np.full(C, _SELF, np.int64)])
        w = np.concatenate([
            np.array([o[1] for o in flat], np.float32),
            np.array([c[2] for c in calls], np.float32)])
        no_region = np.zeros(C, np.int64)
        ents = np.stack([
            np.concatenate([
                np.fromiter((o[2] for o in flat), np.int64, n_o), no_region]),
            np.concatenate([
                np.fromiter((o[3] for o in flat), np.int64, n_o), no_region]),
            w.view(np.int32).astype(np.int64),
            np.concatenate([col | np.where(must, _MUST, 0),
                            np.full(C, _SELF, np.int64)]),
        ], axis=1)
        order = np.lexsort((ent_pos, ent_call))
        ent_cnt = o_ns + 1
        ent_off = np.cumsum(ent_cnt) - ent_cnt
        call_tab = np.stack([starts, ent_off, ent_off + ent_cnt, pair_off],
                            axis=1)
        self.tables = np.concatenate(
            [row_off, call_tab.ravel(), ents[order].ravel()]
        ).astype(np.int32)
        self.n_calls, self.n_rows, self.n_pairs = C, R, P
        self.ns, self.o_ns, self.starts = ns, o_ns, starts
        self.row_off, self.pair_off, self.ent_off = row_off, pair_off, ent_off
        self.ent_pos = ent_pos[order].tolist()
        self.ent_col = ent_col[order].tolist()


def clause_details(store, calls: list) -> tuple[list, int]:
    """`batched_clause_details(store, calls)` swept over the store's device
    tables (`FusedStore.ub_tables`): (the per-call detail dicts, the pair
    rows swept on the card). On a CUDA store one launch, one copy of the
    tables up and one of the outputs back, the stream synchronised before
    the dicts are cut; on any other store the numpy version, 0 rows."""
    if store.device.type != "cuda":
        return batched_clause_details(store, calls), 0
    if not calls:
        return [], 0
    pk = Packed(calls)
    bbase, blast, bfac = store.ub_tables()
    tables = torch.from_numpy(pk.tables).to(bbase.device)
    out = sweep(bbase, blast, bfac, tables, pk.n_calls, pk.n_rows,
                pk.n_pairs)
    host = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
    host.copy_(out, non_blocking=True)
    torch.cuda.current_stream(out.device).synchronize()
    return unpack(calls, pk, host.numpy()), pk.n_pairs


def sweep(bbase, blast, bfac, tables, n_calls: int, n_rows: int,
          n_pairs: int):
    """The sweep's flat outputs, int32 [5 P + 3 R] (`csrc/ub_sweep.cu`):
    jlo, i0, i1, width and term bits per pair row, then UB bits, own-term
    bits and the drop flag per block row. `bbase`, `blast` (int32 holding
    u32 docs) and `bfac` (f32) are the store's block tables, `tables` a
    `Packed`'s."""
    dev = bbase.device
    for name, t, dtype in (("bbase", bbase, torch.int32),
                           ("blast", blast, torch.int32),
                           ("bfac", bfac, torch.float32),
                           ("tables", tables, torch.int32)):
        check_tensor(name, t, dtype, 1, dev)
    if not (bbase.shape == blast.shape == bfac.shape):
        raise ValueError("bbase, blast and bfac differ in length")
    if n_calls < 1 or tables.shape[0] < 5 * n_calls + 1:
        raise ValueError(f"tables of {tables.shape[0]} words do not hold "
                         f"{n_calls} calls")
    if dev.type != "cuda":
        raise ValueError(f"ub_sweep runs on cuda only, not {dev}")
    out = torch.empty(5 * n_pairs + 3 * n_rows, dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ub_sweep_launch(
            bbase.data_ptr(), blast.data_ptr(), bfac.data_ptr(),
            tables.data_ptr(), n_calls, n_rows, n_pairs, out.data_ptr(),
            stream)
    _counted(err, n_rows)
    return out


def unpack(calls: list, pk: Packed, flat: np.ndarray) -> list:
    """The sweep's flat int32 outputs as `batched_clause_details`'s
    per-call dicts: ids (int64), ub, the [n, o] int32 window columns
    widths, jlo, i0 and i1, and the f32 terms by clause position; rows a
    MUST other drops are cut out."""
    P, R = pk.n_pairs, pk.n_rows
    jlo_a, i0_a, i1_a, wid_a = (flat[k * P:(k + 1) * P] for k in range(4))
    term_a = flat[4 * P:5 * P].view(np.float32)
    ub_a = flat[5 * P:5 * P + R].view(np.float32)
    self_a = flat[5 * P + R:5 * P + 2 * R].view(np.float32)
    drop_a = flat[5 * P + 2 * R:5 * P + 3 * R]
    ids_a = np.repeat(pk.starts - pk.row_off[:-1], pk.ns) + np.arange(
        R, dtype=np.int64)
    dropped = set()
    if drop_a.any():
        call_of = np.repeat(np.arange(pk.n_calls), pk.ns)
        dropped = set(np.unique(call_of[drop_a != 0]).tolist())
    row_off, pair_off = pk.row_off.tolist(), pk.pair_off.tolist()
    o_ns, ent_off = pk.o_ns.tolist(), pk.ent_off.tolist()
    ent_pos, ent_col = pk.ent_pos, pk.ent_col
    out = []
    for c in range(pk.n_calls):
        s, e = row_off[c], row_off[c + 1]
        n, o_n, po = e - s, o_ns[c], pair_off[c]
        end = po + o_n * n

        def cols(a):
            return a[po:end].reshape(o_n, n).T

        terms = {}
        for k in range(ent_off[c], ent_off[c] + o_n + 1):
            col = ent_col[k]
            terms[ent_pos[k]] = (self_a[s:e] if col < 0
                                 else term_a[po + col * n:po + (col + 1) * n])
        det = {
            "ids": ids_a[s:e], "ub": ub_a[s:e], "widths": cols(wid_a),
            "jlo": cols(jlo_a), "i0": cols(i0_a), "i1": cols(i1_a),
            "terms": terms,
        }
        if c in dropped:
            keep = drop_a[s:e] == 0
            det = {k: v[keep] for k, v in det.items() if k != "terms"} | {
                "terms": {p: v[keep] for p, v in terms.items()}}
        out.append(det)
    return out


def reset_counts() -> None:
    """Set `launches` to zero."""
    global launches
    with _count_lock:
        launches = 0


def _counted(err: int, n_rows: int) -> None:
    global launches
    if err != 0:
        raise RuntimeError(f"ub_sweep kernel launch failed: CUDA error {err}")
    if n_rows > 0:
        with _count_lock:
            launches += 1


def signatures() -> dict:
    """Each C entry point's ctypes (argtypes, restype)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    return {
        "ub_sweep_launch": ([
            p, p, p, p,            # bbase, blast, bfac, tables
            i, i, i,               # n_calls, n_rows, n_pairs
            p, p,                  # out, stream
        ], ctypes.c_int),
        "ub_sweep_occupancy": ([ctypes.POINTER(i)] * 3, ctypes.c_int),
    }


def _lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("ub_sweep")
    if lib.ub_sweep_launch.argtypes is None:
        for name, (args, res) in signatures().items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib
