"""The port's packed-mode decode (`ops/decode.py`), its block gather
(`DeviceFieldPostings.gather_blocks`) and the plain twin of kernel K5
(`ops/packed_flat.py`) against the reference's decode, `DeviceSegment`
and `flat_topk_kernel`, on the CPU: words, doc ids and f32 bits equal.
The `cuda` cases hold K5 against its twin on the card."""

import numpy as np
import pytest
import torch

from tantivy_tpu.common import bitpack
from tantivy_tpu.ops import decode as ref_decode
from tantivy_tpu.ops.flat_scorer import flat_topk_kernel
from tantivy_tpu_torch.ops import decode, kernel_cases
from tantivy_tpu_torch.ops.device_index import (
    TAB_BASE,
    TAB_DOC_BITS,
    TAB_DOC_OFF,
    TAB_LEN,
    TAB_TF_BITS,
    TAB_TF_OFF,
    PackedMirror,
)
from tantivy_tpu_torch.ops.packed_flat import (
    packed_flat,
    packed_flat_ref,
    packed_flat_topk,
)
from tantivy_tpu_torch.query.bm25 import compute_tf_cache

from test_device_ops import build_random_index
from test_torch_host_parity import port_searcher

WIDTHS = (0, 1, 2, 4, 8, 16, 32)


def t32(a):
    """A u32 numpy array as the port's int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


def random_values(rng, n, bits):
    """[n, 128] u32 of width `bits`, half of the rows top-bit heavy."""
    if bits == 0:
        return np.zeros((n, 128), np.uint32)
    hi = 1 << bits
    lo = np.where(np.arange(n)[:, None] % 2 == 1, hi // 2, 0)
    return rng.integers(lo, hi, (n, 128), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("bits", WIDTHS)
def test_unpack_rows_matches_reference_and_host_pack(bits):
    """Every width, words with the top bit set included: the port's
    `unpack_rows` gives the values `bitpack.pack` packed, as the
    reference's does."""
    import jax.numpy as jnp

    rng = np.random.default_rng(bits)
    vals = random_values(rng, 8, bits)
    words = np.stack([bitpack.pack(v, bits) for v in vals]).reshape(8, -1)
    assert words.shape == (8, 4 * bits)
    if bits:
        assert (words >> 31).any()
    got = u32(decode.unpack_rows(t32(words), bits))
    np.testing.assert_array_equal(got, vals)
    want = np.asarray(ref_decode.unpack_rows(jnp.asarray(words), bits))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", WIDTHS)
def test_decode_rows_match_reference(bits):
    """Doc rows (uint32 wraparound prefix sums, short blocks masked to
    TERMINATED) and tf rows (+1, wrapping) against the reference."""
    import jax.numpy as jnp

    rng = np.random.default_rng(100 + bits)
    n = 16
    vals = random_values(rng, n, bits)
    vals[0] = np.uint32(0xFFFFFFFF) if bits == 32 else vals[0]
    words = np.stack([bitpack.pack(v, bits) for v in vals]).reshape(n, -1)
    bases = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    lengths = rng.integers(1, 129, n).astype(np.int32)
    lengths[:2] = 128
    got = u32(decode.decode_doc_rows(t32(words), t32(bases),
                                     torch.from_numpy(lengths), bits))
    want = np.asarray(ref_decode.decode_doc_rows(
        jnp.asarray(words), jnp.asarray(bases), jnp.asarray(lengths), bits))
    np.testing.assert_array_equal(got, want)
    assert (got == 2**31 - 1).any()  # short blocks' padding lanes
    got_tf = u32(decode.decode_tf_rows(t32(words), bits))
    want_tf = np.asarray(ref_decode.decode_tf_rows(jnp.asarray(words), bits))
    np.testing.assert_array_equal(got_tf, want_tf)


@pytest.mark.parametrize("mode", ["dense", "packed"])
def test_gather_blocks_matches_reference_and_host(mode):
    """`gather_blocks` of every block of a segment in both modes equals
    the reference's `DeviceSegment(reader, mode).gather_blocks` and the
    host decoder (`tests/test_device_ops.py`'s check)."""
    from tantivy_tpu.common import arrayio
    from tantivy_tpu.ops.device_index import DeviceSegment
    from tantivy_tpu.postings.format import decode_block_host

    index, _ = build_random_index(num_commits=1)
    reader = index.reader().searcher().segment_readers()[0]
    preader = port_searcher(index).segment_readers()[0]
    dfp = preader.device(mode).field_postings("body")
    assert dfp.mode == mode
    ids = np.arange(dfp.num_blocks)
    ids = np.concatenate([ids, ids[::-1][:5]])  # repeated blocks
    docs, tfs = (u32(a) for a in dfp.gather_blocks(ids))
    rdocs, rtfs = DeviceSegment(reader, mode=mode).field_postings(
        "body").gather_blocks(ids)
    np.testing.assert_array_equal(docs, np.asarray(rdocs))
    np.testing.assert_array_equal(tfs, np.asarray(rtfs))
    arrays = arrayio.field_arrays(reader._idx,
                                  reader.schema.get_field("body").field_id)
    for i, b in enumerate(ids):
        hdocs, htfs = decode_block_host(arrays, int(b))
        L = len(hdocs)
        np.testing.assert_array_equal(docs[i, :L], hdocs)
        np.testing.assert_array_equal(tfs[i, :L], htfs)
        assert (docs[i, L:] == 2**31 - 1).all()


def reference_packed_topk(case, k):
    """The reference's packed path on a `packed_case`-shaped chunk: its
    per-width decode of each item's rows, then `flat_topk_kernel`, as its
    `FlatBatchScorer.dispatch` runs them."""
    import jax.numpy as jnp

    doc_words, tf_words, tab, norm_ids, alive = case["mirror"]
    blocks, qids = case["blocks"], case["qids"]
    Q = case["num_queries"]
    W = len(blocks)
    docs = np.zeros((W, 128), np.uint32)
    tfs = np.zeros((W, 128), np.uint32)
    for i, b in enumerate(blocks):
        row = tab[b]
        w, tw = int(row[TAB_DOC_BITS]), int(row[TAB_TF_BITS])
        words = doc_words[row[TAB_DOC_OFF]:row[TAB_DOC_OFF] + 4 * w]
        docs[i] = np.asarray(ref_decode.decode_doc_rows(
            jnp.asarray(words[None]), jnp.asarray(row[TAB_BASE:TAB_BASE + 1]
                                                  .astype(np.uint32)),
            jnp.asarray(row[TAB_LEN:TAB_LEN + 1]), w))[0]
        twords = tf_words[row[TAB_TF_OFF]:row[TAB_TF_OFF] + 4 * tw]
        tfs[i] = np.asarray(ref_decode.decode_tf_rows(
            jnp.asarray(twords[None]), tw))[0]
    return np.asarray(flat_topk_kernel(
        jnp.asarray(docs), jnp.asarray(tfs), jnp.asarray(qids),
        jnp.asarray(qids < Q), jnp.asarray(norm_ids), jnp.asarray(alive),
        jnp.asarray(case["weights"]), jnp.asarray(case["caches"]), k, Q,
    ))


def torch_case(case, device="cpu"):
    """A `packed_case` dict's arrays as tensors on `device`: (mirror,
    blocks, qids, weights, caches)."""
    doc_words, tf_words, tab, norm_ids, alive = case["mirror"]
    mirror = PackedMirror(t32(doc_words), t32(tf_words),
                          torch.from_numpy(tab), torch.from_numpy(norm_ids),
                          torch.from_numpy(alive))
    mirror = PackedMirror(*(a.to(device) for a in mirror))
    return (mirror,) + tuple(
        torch.from_numpy(case[n]).to(device)
        for n in ("blocks", "qids", "weights", "caches"))


def random_case(seed, W=300, Q=9):
    """A random chunk over the packed mirror of a store like
    `test_torch_term_batch._random_store`'s: sorted docs, short blocks, tfs
    with many ties, deletes; repeated blocks, several queries."""
    rng = np.random.default_rng(seed)
    nb, max_doc = 96, 5000
    doc_words, tf_words, tab = [], [], []
    n_doc = n_tf = 0
    for _ in range(nb):
        n = int(rng.integers(1, 129))
        d = np.sort(rng.choice(max_doc, n, replace=False)).astype(np.int64)
        deltas = np.zeros(128, np.uint32)
        deltas[1:n] = np.diff(d) - 1
        w = bitpack.bits_required(int(deltas.max()))
        tf = np.zeros(128, np.uint32)
        tf[:n] = rng.integers(0, 3, n)
        tw = bitpack.bits_required(int(tf.max()))
        doc_words.append(bitpack.pack(deltas, w))
        tf_words.append(bitpack.pack(tf, tw))
        tab.append((n_doc, w, n_tf, tw, int(d[0]), n, 0, 0))
        n_doc += 4 * w
        n_tf += 4 * tw
    cache = compute_tf_cache(np.float32(7.3))
    return dict(
        mirror=(np.concatenate(doc_words).astype(np.uint32),
                np.concatenate(tf_words).astype(np.uint32),
                np.array(tab, np.int32),
                rng.integers(0, 6, max_doc).astype(np.uint8),
                rng.random(max_doc) > 0.1),
        blocks=rng.integers(0, nb, W).astype(np.int32),
        qids=rng.integers(0, Q, W).astype(np.int32),
        weights=rng.uniform(0.5, 3.0, Q + 1).astype(np.float32),
        caches=np.tile(cache, (Q + 1, 1)), num_queries=Q,
    )


@pytest.mark.parametrize("k", [1, 10, 200])
@pytest.mark.parametrize("case", ["random", *kernel_cases.PACKED_KINDS])
def test_packed_flat_twin_matches_reference(case, k):
    """K5's twin with the merge tail (`packed_flat_topk` on the CPU)
    against the reference's decode + `flat_topk_kernel`, word for word:
    repeated blocks, ties, deletes, short blocks, padding items, every
    width."""
    case = (random_case(k) if case == "random"
            else kernel_cases.packed_case(case))
    Q = case["num_queries"]
    want = reference_packed_topk(case, k)
    got = packed_flat_topk(*torch_case(case), k, Q).numpy()
    assert got.shape == want.shape == (2, Q, k)
    assert np.array_equal(got.view(np.uint32), want)
    assert np.isfinite(got[0].view(np.float32)[:, 0]).any()


def test_packed_flat_twin_rows():
    """The twin's rows: -inf / TERMINATED past each item's live lanes,
    scores descending, and padding items report nothing."""
    case = kernel_cases.packed_case("widths")
    mirror, blocks, qids, weights, caches = torch_case(case)
    sc, docs = packed_flat(*mirror, blocks, qids, weights, caches,
                           num_queries=case["num_queries"], kk=128)
    assert sc.shape == docs.shape == (len(blocks), 128)
    pad = qids == case["num_queries"]
    assert torch.isinf(sc[pad]).all() and (docs[pad] == 2**31 - 1).all()
    dead = ~torch.isfinite(sc)
    assert (docs[dead] == 2**31 - 1).all()
    assert (sc[:, :-1] >= sc[:, 1:]).all()
    # the deleted block reports nothing; the max_doc - 1 block reports it
    tab = case["mirror"][2]
    dead_blk = len(tab) - 1
    assert torch.isinf(sc[blocks == dead_blk]).all()
    last = blocks == len(tab) - 2
    assert (docs[last] == 40_000 - 1).any() or not case["mirror"][4][-1]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("kk", [1, 10, 128])
@pytest.mark.parametrize("case", ["random", *kernel_cases.PACKED_KINDS])
def test_packed_flat_kernel_matches_twin(case, kk):
    """K5 on the card against its twin on the same CUDA tensors: scores
    bitwise, docs equal; it counts its launch."""
    from tantivy_tpu_torch.ops import packed_flat as pf

    _need_cuda()
    case = (random_case(kk, W=4000) if case == "random"
            else kernel_cases.packed_case(case))
    mirror, blocks, qids, weights, caches = torch_case(case, "cuda")
    n0 = pf.launches
    sc, docs = packed_flat(*mirror, blocks, qids, weights, caches,
                           num_queries=case["num_queries"], kk=kk)
    rsc, rdocs = packed_flat_ref(*mirror, blocks, qids, weights, caches,
                                 num_queries=case["num_queries"], kk=kk)
    torch.cuda.synchronize()
    assert pf.launches == n0 + 1
    assert torch.equal(sc.view(torch.int32), rsc.view(torch.int32))
    assert torch.equal(docs, rdocs)
