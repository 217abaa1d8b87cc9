"""Posting-block decode in plain torch: the packed mode's front half.

Counterpart of `tantivy_tpu/ops/decode.py`. A width-b block row holds its
128 values in 4b u32 words, value j in word `j * b // 32` at bit offset
`j * b % 32` (`common/bitpack.py`: widths are powers of two, so no value
straddles a word). Doc ids come from the strict-delta scan
`doc = base + cumsum(delta) + lane`, wrapping as uint32 does; lanes at or
past the block length become TERMINATED. Tfs are stored minus one.

Words and doc ids are held as int32 tensors carrying the u32 bits (torch
supports uint32 only thinly). `>>` on int32 is arithmetic, which is still
right for b <= 16 because the mask clears the sign-filled bits; a width-32
row is its values as they are. Sums run in int64 and wrap to 32 bits.

`decode_blocks` gathers and decodes rows of a packed mirror
(`device_index.PackedMirror`) by block id: the plain twin of the packed
flat-scorer kernel uses it, and `DeviceFieldPostings.gather_blocks`.
"""

from __future__ import annotations

import torch

from ..postings.format import COMPRESSION_BLOCK_SIZE, TERMINATED

BLOCK = COMPRESSION_BLOCK_SIZE
_U32 = 0xFFFFFFFF


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 -> int32 tensor of the same u32 bits."""
    x = x & _U32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor of u32 bits -> int64 tensor of the u32 values."""
    return x.long() & _U32


def unpack_rows(words: torch.Tensor, bits: int) -> torch.Tensor:
    """[n, 4 * bits] int32 words -> [n, 128] int32 values of width `bits`."""
    n = words.shape[0]
    if bits == 0:
        return torch.zeros((n, BLOCK), dtype=torch.int32, device=words.device)
    if bits == 32:
        return words
    per = 32 // bits
    shifts = torch.arange(per, dtype=torch.int32, device=words.device) * bits
    vals = (words[:, :, None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(n, BLOCK)


def deltas_to_docs(deltas: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """Strict-delta decode: docs[i] = base + cumsum(delta)[i] + i, mod 2^32.
    `deltas` [n, 128] and `bases` [n] hold u32 bits; padding lanes keep
    increasing past the last real doc (callers mask with the length)."""
    csum = torch.cumsum(as_u32(deltas), dim=1)
    lane = torch.arange(BLOCK, dtype=torch.int64, device=deltas.device)
    return as_i32(as_u32(bases)[:, None] + csum + lane[None, :])


def mask_docs(docs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Set padding lanes (lane >= block length) to TERMINATED."""
    lane = torch.arange(BLOCK, device=docs.device)[None, :]
    return torch.where(lane < lengths.long()[:, None], docs, TERMINATED)


def decode_doc_rows(words: torch.Tensor, bases: torch.Tensor,
                    lengths: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed doc rows -> masked absolute doc ids [n, 128] (int32 bits)."""
    return mask_docs(deltas_to_docs(unpack_rows(words, bits), bases), lengths)


def decode_tf_rows(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed tf rows -> term frequencies [n, 128] (stored minus one; the
    +1 wraps as uint32 does)."""
    return as_i32(as_u32(unpack_rows(words, bits)) + 1)


def _rows(words: torch.Tensor, offsets: torch.Tensor, n: int) -> torch.Tensor:
    """[len(offsets), n] words starting at each offset."""
    at = offsets.long()[:, None] + torch.arange(n, device=words.device)
    return words[at]


def decode_blocks(doc_words, tf_words, blk_tab, block_ids):
    """(docs, tfs) [W, 128] int32 of the mirror's blocks `block_ids` [W]
    (each in range), one decode per bit width present, as the reference's
    `DeviceFieldPostings._gather_packed` does. `blk_tab` rows are
    `device_index.PackedMirror`'s (word offsets, widths, base, length)."""
    tab = blk_tab[block_ids.long()]
    W = tab.shape[0]
    dev = tab.device
    docs = torch.full((W, BLOCK), TERMINATED, dtype=torch.int32, device=dev)
    tfs = torch.ones((W, BLOCK), dtype=torch.int32, device=dev)
    for w in torch.unique(tab[:, 1]).tolist():
        (sel,) = torch.nonzero(tab[:, 1] == w, as_tuple=True)
        words = _rows(doc_words, tab[sel, 0], 4 * w)
        docs[sel] = decode_doc_rows(words, tab[sel, 4], tab[sel, 5], w)
    for w in torch.unique(tab[:, 3]).tolist():
        if w == 0:
            continue  # width-0 tf rows are all ones (already set)
        (sel,) = torch.nonzero(tab[:, 3] == w, as_tuple=True)
        tfs[sel] = decode_tf_rows(_rows(tf_words, tab[sel, 2], 4 * w), w)
    return docs, tfs
