"""Kernel K5's warp-level parts, emulated in numpy and held to the plain
PyTorch versions they must equal: the selection (each thread's live lanes
ordered once, then min(kk, live) rounds of `__reduce_max_sync` over each
thread's next score image and `__reduce_min_sync` over the lanes that
offer it) against `group_topk`, and the 4-lanes-a-thread unpack (one 4-,
8- or 16-byte load a thread) against `decode.unpack_rows`. The `cuda`
cases hold the kernel against its twin on chunks whose sizes leave a
warp's second item empty.

Inputs are made from a seed with numpy; scores compare as f32 bits."""

import numpy as np
import pytest
import torch

from tantivy_tpu_torch.common import bitpack
from tantivy_tpu_torch.ops import kernel_cases
from tantivy_tpu_torch.ops.decode import unpack_rows
from tantivy_tpu_torch.ops.packed_flat import (
    packed_flat,
    packed_flat_lanes,
    packed_flat_ref,
)
from tantivy_tpu_torch.ops.probe_scorer import group_topk

from test_torch_decode import random_case, torch_case

NO_LANE = np.uint32(0xFFFFFFFF)
TERMINATED = 2**31 - 1


def score_image(sc: np.ndarray) -> np.ndarray:
    """The kernel's `score_image`: order-keeping u32 image, both zeros one
    image."""
    u = sc.astype(np.float32).view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0
    neg = (u & np.uint32(0x80000000)) != 0
    return np.where(neg, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def warp_select(sc: np.ndarray, docs: np.ndarray, kk: int):
    """The kernel's selection over items [n, 128], thread t owning lanes
    4t..4t+3: each thread orders its live lanes once (image desc, lane
    asc), then one round per output slot; returns ([n, kk] scores,
    docs)."""
    n = sc.shape[0]
    img = score_image(sc).reshape(n, 32, 4).astype(np.int64)
    cand = (sc != -np.inf).reshape(n, 32, 4)
    # each live lane's place in its thread's order: the live lanes of the
    # thread with a higher image, or an equal one and a lower lane
    i = np.arange(4)
    before = cand[:, :, None, :] & (
        (img[:, :, None, :] > img[:, :, :, None])
        | ((img[:, :, None, :] == img[:, :, :, None])
           & (i[None, :] < i[:, None])[None, None]))
    pos = np.where(cand, before.sum(axis=3), 4)          # 4 = not placed
    order = np.full((n, 32, 5), -1)
    np.put_along_axis(order, pos, i[None, None, :].repeat(32, 1)
                      .repeat(n, 0), axis=2)
    cnt = cand.sum(axis=2)
    head = np.zeros((n, 32), np.int64)                   # next place
    n_out = np.minimum(cand.sum(axis=(1, 2)), kk)
    out_sc = np.full((n, kk), -np.inf, np.float32)
    out_doc = np.full((n, kk), TERMINATED, np.int32)
    rows = np.arange(n)
    t = np.arange(32)
    for r in range(kk):
        left = head < cnt
        hi = np.take_along_axis(order, np.minimum(head, 4)[:, :, None],
                                axis=2)[:, :, 0]
        hi = np.where(left, hi, 0)
        mine = np.where(left, np.take_along_axis(img, hi[:, :, None],
                                                 axis=2)[:, :, 0], 0)
        mlane = np.where(left, 4 * t[None, :] + hi, int(NO_LANE))
        best = mine.max(axis=1)                              # reduce max
        offer = (mlane != int(NO_LANE)) & (mine == best[:, None])
        pick = np.where(offer, mlane, int(NO_LANE)).min(axis=1)  # reduce min
        act = rows[r < n_out]
        p = pick[act]
        out_sc[act, r] = sc[act, p]
        out_doc[act, r] = docs[act, p]
        head[act, p // 4] += 1
    return out_sc, out_doc


def _synthetic(kind: str, seed: int = 0):
    """[64, 128] lane scores (and ascending docs) of `kind`."""
    rng = np.random.default_rng(seed + 10 * SOURCES.index(kind))
    n = 64
    if kind == "random_ties":
        sc = rng.choice(np.float32([0.5, 1.0, 1.5, 2.25]), (n, 128))
        sc[rng.random((n, 128)) < 0.3] = -np.inf
    elif kind == "signed_zeros":
        sc = rng.choice(np.float32([0.0, -0.0, 0.75]), (n, 128),
                        p=[0.45, 0.45, 0.1])
        sc[rng.random((n, 128)) < 0.1] = -np.inf
    elif kind == "all_dead":
        sc = np.full((n, 128), -np.inf, np.float32)
        sc[::4, rng.integers(0, 128)] = 1.0   # a few items hold one lane
    else:  # "short": the first len lanes live, every score distinct
        sc = rng.permutation(n * 128).astype(np.float32).reshape(n, 128)
        lens = rng.integers(0, 129, n)
        sc[np.arange(128)[None, :] >= lens[:, None]] = -np.inf
    docs = np.cumsum(rng.integers(1, 50, (n, 128)), axis=1).astype(np.int32)
    return sc.astype(np.float32), docs


def _packed(kind: str):
    """The K5 twin's lane scores on a `kernel_cases.packed_case`."""
    case = kernel_cases.packed_case(kind)
    mirror, blocks, qids, weights, caches = torch_case(case)
    sc, docs = packed_flat_lanes(*mirror, blocks, qids, weights, caches,
                                 num_queries=case["num_queries"])
    return sc.numpy(), docs.numpy()


SOURCES = ["random_ties", "signed_zeros", "all_dead", "short"]
ALL = SOURCES + [f"packed_{k}" for k in kernel_cases.PACKED_KINDS]


@pytest.mark.parametrize("kk", [1, 10, 128])
@pytest.mark.parametrize("source", ALL)
def test_warp_selection_emulation_matches_group_topk(source, kk):
    """The selection's order is `group_topk`'s (score desc, lane asc, the
    two zeros equal), its fill -inf / TERMINATED past the live lanes."""
    sc, docs = (_packed(source[7:]) if source.startswith("packed_")
                else _synthetic(source))
    got_sc, got_doc = warp_select(sc, docs, kk)
    t_sc = torch.from_numpy(sc)
    th = torch.full((sc.shape[0],), float("-inf"))
    want_sc, want_doc = group_topk(t_sc, torch.from_numpy(docs), th, kk)
    assert np.array_equal(got_sc.view(np.int32),
                          want_sc.numpy().view(np.int32))
    assert np.array_equal(got_doc, want_doc.numpy())
    # the source holds what it claims: a cut through equal scores, or
    # rows with fewer live lanes than kk
    live = (sc != -np.inf).sum(axis=1)
    s = -np.sort(-sc, axis=1)
    if kk < 128 and source not in ("short", "all_dead"):
        assert (s[:, kk - 1] == s[:, kk]).any()
    assert (live < 128).any()


@pytest.mark.parametrize("bits", [0, 1, 2, 4, 8, 16, 32])
def test_unpack4_emulation_matches_unpack_rows(bits):
    """The kernel's `unpack4`: thread t's 4 lanes from one word (width <=
    8), one 8-byte pair (16) or one 16-byte quad (32) of the row."""
    rng = np.random.default_rng(bits)
    vals = rng.integers(0, 1 << bits, 128, dtype=np.uint64).astype(np.uint32)
    vals[:4] = (1 << bits) - 1 if bits else 0   # the top bits set
    words = bitpack.pack_rows(vals[None], bits).reshape(-1).astype(np.uint32)
    got = np.zeros(128, np.uint32)
    for t in range(32):
        if bits == 32:
            v = words[4 * t:4 * t + 4]
        elif bits == 16:
            pair = words[2 * t:2 * t + 2]
            v = [pair[0] & 0xFFFF, pair[0] >> 16, pair[1] & 0xFFFF,
                 pair[1] >> 16]
        elif bits:
            bit = 4 * t * bits
            word = int(words[bit >> 5]) >> (bit & 31)
            v = [(word >> (i * bits)) & ((1 << bits) - 1) for i in range(4)]
        else:
            v = [0, 0, 0, 0]
        got[4 * t:4 * t + 4] = v
    want = unpack_rows(torch.from_numpy(words.view(np.int32))[None], bits)
    assert np.array_equal(got, want.numpy()[0].view(np.uint32))
    assert np.array_equal(got, vals)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3, 65, 4001])
def test_kernel_on_chunks_with_a_half_empty_warp(W):
    """A chunk of W items: the last warp's second item may not exist; the
    kernel writes exactly the chunk's rows, bitwise the twin's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = random_case(W, W=W)
    mirror, blocks, qids, weights, caches = torch_case(case, "cuda")
    for kk in (1, 10, 128):
        kw = dict(num_queries=case["num_queries"], kk=kk)
        sc, docs = packed_flat(*mirror, blocks, qids, weights, caches, **kw)
        rsc, rdocs = packed_flat_ref(*mirror, blocks, qids, weights, caches,
                                     **kw)
        torch.cuda.synchronize()
        assert sc.shape == (W, kk)
        assert torch.equal(sc.view(torch.int32), rsc.view(torch.int32))
        assert torch.equal(docs, rdocs)
