"""Kernel K2's plain twin (`phrase_probe_ref`) against the reference Pallas
kernel (`pallas_phrase._phrase_rows`, interpret mode) on launches captured
from a reference fused phrase search, and the wrapper's input checks.

Both kernels get the same launch: the reference's [P, R, 128] SMEM pages
are unfolded to the [W, STRIDE] scalar rows the port's kernel takes. Scores
are compared as f32 bits, docs exactly. The CUDA kernel itself is held
against the same twin on the card (`cuda` marker)."""

import functools

import jax
import numpy as np
import pytest
import torch

import tantivy_tpu as tt
from tantivy_tpu.ops import pallas_phrase as php
from tantivy_tpu.parallel import BatchExecutor as JaxBatchExecutor
from tantivy_tpu.query.phrase_query import PhrasePrefixQuery
from tantivy_tpu_torch.ops import fused_phrase as fp
from tantivy_tpu_torch.ops.phrase_probe import phrase_probe, phrase_probe_ref

import zstd_stub
from test_device_phrase import build_phrase_index, sample_phrases


def _rows_of(scal, W, G, S):
    """[P, R, 128] reference scalar pages -> [W, STRIDE] scalar rows."""
    stride = php._phrase_scal_layout(S, G)[0]
    assert stride == fp._phrase_scal_layout(S)
    pages = np.asarray(scal).reshape(W // G, -1)[:, :G * stride]
    return np.array(pages.reshape(W, stride))


def _i32(a):
    return torch.from_numpy(np.array(a).view(np.int32))


def _recorder(log):
    """Stands in for the reference's jitted `fused_phrase_topk` while
    launches are captured: records the launch, then runs it through the
    port's twin and merge tail and returns the reference's packed u32
    result. The capture then costs no Pallas compile; every captured chunk
    is held against the real Pallas kernel in the tests below."""

    def fused_phrase_topk(rung_scal, rung_qid, rung_seg, qw, row_th, cstore,
                          postore, *, k, num_queries, num_prows, n_partners,
                          rungs, interpret=False, pack_addr=False):
        rec = dict(
            chunks=[(shape, np.asarray(sc)) for shape, sc in
                    zip(rungs, rung_scal)],
            qw=np.array(qw), row_th=np.array(row_th),
            cstore=np.asarray(cstore), postore=np.asarray(postore), k=k,
            num_prows=num_prows, n_partners=n_partners,
        )
        log.append(rec)
        chunks = [
            (RR, torch.from_numpy(_rows_of(sc, W, G, n_partners)),
             torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s)))
            for ((W, RR, G), sc), q, s in zip(rec["chunks"], rung_qid,
                                              rung_seg)
        ]
        packed = fp.fused_phrase_topk(
            chunks, torch.from_numpy(rec["qw"]),
            torch.from_numpy(rec["row_th"]), _i32(rec["cstore"]),
            _i32(rec["postore"]), k, num_queries, num_prows, n_partners,
        )
        return packed.numpy().view(np.uint32)

    return fused_phrase_topk


def _queries(texts):
    rng = np.random.default_rng(3)
    qs = [tt.PhraseQuery("body", p) for p in sample_phrases(rng, texts, 6, 2)]
    qs += [tt.PhraseQuery("body", p) for p in sample_phrases(rng, texts, 4, 3)]
    qs += [tt.PhraseQuery("body", p) for p in sample_phrases(rng, texts, 2, 4)]
    qs += [tt.PhraseQuery("body", p) for p in sample_phrases(rng, texts, 2, 8)]
    # a phrase-prefix has one plan row per (segment, expansion) but a phase-1
    # budget per query, so its other rows run in phase 2 with thresholds
    qs += [PhrasePrefixQuery("body", p[:-1] + ["w"])
           for p in sample_phrases(rng, texts, 3, 2)]
    qs += [PhrasePrefixQuery("body", p[:-1] + ["w"])
           for p in sample_phrases(rng, texts, 3, 3)]
    return qs


@pytest.fixture(scope="module")
def launches():
    """Every fused phrase launch of reference searches over the phrase
    corpus: the reference planner and launch assembly, each launch's exact
    kernel inputs recorded."""
    log = []
    with pytest.MonkeyPatch.context() as mp:
        zstd_stub.use(mp)
        index, _, texts = build_phrase_index()
        searcher = index.reader().searcher()
        mp.setenv("TANTIVY_TPU_PALLAS", "1")
        # one phase-1 block per plan row, so phase 2 runs with thresholds
        mp.setenv("TANTIVY_TPU_M1", "1")
        mp.setattr(php, "fused_phrase_topk", _recorder(log))
        for k in (10, 1):
            JaxBatchExecutor(searcher).search_batch(_queries(texts), k)
    return log


def _cases(launches):
    """Named launch picks: every partner bucket in phase 1 and buckets 1
    and 3 in phase 2 (finite row thresholds)."""
    cases = {}
    for rec in launches:
        tag = f"S{rec['n_partners']}"
        if np.isfinite(rec["row_th"]).any():
            tag += "_phase2"
        cases.setdefault(tag, rec)
    return cases


_phrase_rows = jax.jit(
    functools.partial(php._phrase_rows, interpret=True),
    static_argnames=("n_partners", "rows", "num_prows", "G", "W", "kk"),
)

CASES = ("S1", "S3", "S7", "S1_phase2", "S3_phase2")


def _twin_args(rec, device="cpu"):
    return (
        torch.from_numpy(rec["qw"]).to(device),
        torch.from_numpy(rec["row_th"]).to(device),
        _i32(rec["cstore"]).to(device),
        _i32(rec["postore"]).to(device),
    )


@pytest.mark.parametrize("case", CASES)
def test_twin_matches_pallas_kernel(launches, case):
    rec = _cases(launches).get(case)
    assert rec is not None, f"the search made no {case} launch"
    S, kk = rec["n_partners"], min(rec["k"], 128)
    args = _twin_args(rec)
    reported = 0
    for (W, RR, G), scal in rec["chunks"]:
        want_sc, want_dc = _phrase_rows(
            scal, rec["qw"], rec["row_th"], rec["cstore"], rec["postore"],
            n_partners=S, rows=RR, num_prows=rec["num_prows"], G=G, W=W,
            kk=kk,
        )
        want_sc = np.asarray(want_sc)[:, :kk]
        want_dc = np.asarray(want_dc)[:, :kk]
        rows = torch.from_numpy(_rows_of(scal, W, G, S))
        got_sc, got_dc = phrase_probe_ref(
            rows, *args, n_partners=S, slab_rows=RR,
            num_prows=rec["num_prows"], kk=kk,
        )
        assert np.array_equal(got_sc.numpy().view(np.int32),
                              want_sc.view(np.int32))
        assert np.array_equal(got_dc.numpy().view(np.uint32), want_dc)
        reported += int(np.isfinite(want_sc).sum())
    assert reported > 0, "the compared chunks report no lane"


def test_wrapper_takes_twin_on_cpu_and_checks_inputs(launches):
    rec = _cases(launches)["S1"]
    qw, row_th, cstore, postore = _twin_args(rec)
    (W, RR, G), scal = rec["chunks"][0]
    rows = torch.from_numpy(_rows_of(scal, W, G, 1))
    kw = dict(n_partners=1, slab_rows=RR, num_prows=rec["num_prows"],
              kk=min(rec["k"], 128))
    got = phrase_probe(rows, qw, row_th, cstore, postore, **kw)
    want = phrase_probe_ref(rows, qw, row_th, cstore, postore, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        phrase_probe(rows.long(), qw, row_th, cstore, postore, **kw)
    with pytest.raises(ValueError):
        phrase_probe(rows, qw, row_th, cstore,
                     postore[:, :128].contiguous(), **kw)
    with pytest.raises(ValueError):
        phrase_probe(rows, qw, row_th[:-1].contiguous(), cstore, postore,
                     **kw)
    with pytest.raises(ValueError):
        phrase_probe(rows, qw, row_th, cstore, postore,
                     **dict(kw, n_partners=8))
    with pytest.raises(ValueError):
        phrase_probe(rows, qw, row_th, cstore, postore, **dict(kw, kk=129))


def test_twin_does_not_rely_on_position_order():
    """The twin's partner test is a set membership: reversing the positions
    inside every block's range of the port's store (which keeps every
    sub-range's set of positions but breaks the (owner, position) order the
    kernel's binary searches need) changes no output of the twin."""
    from tantivy_tpu_torch import BatchExecutor

    index, _, texts = build_phrase_index()
    port = BatchExecutor(index.reader().searcher(), device="cpu")
    port.launch_log = []
    port.search_batch(_queries(texts), 10)
    fused = port._fused()
    bp = torch.from_numpy(fused.blk_pos.astype(np.int64))
    idx = torch.arange(int(bp[-1]))
    b = torch.searchsorted(bp, idx, right=True) - 1
    src = bp[b] + bp[b + 1] - 1 - idx
    rev = fused.postore.clone()
    for half in (slice(0, 128), slice(128, 256)):
        col = rev[:, half].reshape(-1)
        col[idx] = fused.postore[:, half].reshape(-1)[src]
        rev[:, half] = col.reshape(-1, 128)
    key = (rev[:, 128:].reshape(-1)[idx].long() << 32) | (
        rev[:, :128].reshape(-1)[idx].long()
    )
    assert bool((key[1:] < key[:-1]).any()), "the reversal kept the order"
    compared = 0
    for rec in port.launch_log:
        if rec["kind"] != "phrase":
            continue
        for rr, rows, _, _ in rec["chunks"]:
            kw = dict(n_partners=rec["n_partners"], slab_rows=rr,
                      num_prows=rec["num_prows"], kk=min(rec["k"], 128))
            want = phrase_probe_ref(rows, rec["qw"], rec["row_th"],
                                    rec["cstore"], rec["postore"], **kw)
            got = phrase_probe_ref(rows, rec["qw"], rec["row_th"],
                                   rec["cstore"], rev, **kw)
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32))
            assert torch.equal(got[1], want[1])
            compared += int(torch.isfinite(want[0]).sum())
    assert compared > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_twin_on_card(launches, cuda_device, case):
    rec = _cases(launches)[case]
    args = _twin_args(rec, cuda_device)
    S = rec["n_partners"]
    for (W, RR, G), scal in rec["chunks"]:
        rows = torch.from_numpy(_rows_of(scal, W, G, S)).to(cuda_device)
        kw = dict(n_partners=S, slab_rows=RR, num_prows=rec["num_prows"],
                  kk=min(rec["k"], 128))
        got = phrase_probe(rows, *args, **kw)
        want = phrase_probe_ref(rows, *args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])
