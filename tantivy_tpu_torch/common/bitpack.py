"""Bit-packing primitives for posting blocks and fast-field columns.

TPU-first design note (vs reference `bitpacker/src/bitpacker.rs` and the SSE2
`bitpacking` crate used in `src/postings/compression/mod.rs`): the reference packs
with *exact* bit widths (0..=32) in a 4-lane SIMD interleaved layout. We instead
restrict block bit widths to powers of two {0, 1, 2, 4, 8, 16, 32} so that every
value sits *aligned inside a single u32 word*. Unpacking then vectorizes on the
VPU as `reshape -> broadcast -> shift -> mask` with **no cross-word funnel
shifts and no gathers**, which is the shape XLA/Mosaic tiles well. The cost is
a ~15-25% larger packed stream on Zipfian doc deltas; the benefit is an
HBM-bandwidth-bound decode kernel.

Layout for width b (b in {1,2,4,8,16,32}): `per = 32 // b` values per u32 word,
value i lives in word `i // per` at bit offset `(i % per) * b`, little-endian.
Width 0 means "all values are zero" and occupies no words.
"""

from __future__ import annotations

import numpy as np

# Allowed packed widths. Chosen so a value never straddles a u32 boundary.
ALLOWED_BITS = (0, 1, 2, 4, 8, 16, 32)

_BITS_LOOKUP = np.zeros(33, dtype=np.uint8)
for _b in ALLOWED_BITS[1:]:
    _BITS_LOOKUP[_b] = _b
for _i in range(33):
    if _BITS_LOOKUP[_i] == 0 and _i > 0:
        for _b in ALLOWED_BITS[1:]:
            if _b >= _i:
                _BITS_LOOKUP[_i] = _b
                break


def round_bits(num_bits: int) -> int:
    """Round an exact bit width up to the nearest allowed (power-of-two) width."""
    if num_bits < 0 or num_bits > 32:
        raise ValueError(f"bit width out of range: {num_bits}")
    return int(_BITS_LOOKUP[num_bits])


def bits_required(max_value: int) -> int:
    """Allowed width needed to store `max_value` (a u32)."""
    return round_bits(int(max_value).bit_length())


def words_for(count: int, bits: int) -> int:
    """Number of u32 words used to pack `count` values at width `bits`."""
    if bits == 0:
        return 0
    per = 32 // bits
    return -(-count // per)


def pack(values: np.ndarray, bits: int) -> np.ndarray:
    """Pack uint32 `values` at width `bits` into a uint32 word array."""
    values = np.ascontiguousarray(values, dtype=np.uint32)
    if bits == 0:
        if values.size and values.max() != 0:
            raise ValueError("width 0 requires all-zero values")
        return np.zeros(0, dtype=np.uint32)
    if bits == 32:
        return values.copy()
    if values.size and int(values.max()) >> bits:
        raise ValueError(f"value does not fit in {bits} bits")
    per = 32 // bits
    n_words = words_for(values.size, bits)
    padded = np.zeros(n_words * per, dtype=np.uint32)
    padded[: values.size] = values
    lanes = padded.reshape(n_words, per)
    shifts = (np.arange(per, dtype=np.uint32) * bits).astype(np.uint32)
    words = np.bitwise_or.reduce(lanes << shifts, axis=1, dtype=np.uint32)
    return words


def bits_required_rows(row_max: np.ndarray) -> np.ndarray:
    """Vectorized `bits_required` over per-row max values (u32)."""
    bl = np.zeros(len(row_max), dtype=np.int64)
    nz = row_max > 0
    # f64 log2 is exact at power-of-two boundaries for u32 inputs
    bl[nz] = np.floor(np.log2(row_max[nz].astype(np.float64))).astype(np.int64) + 1
    return _BITS_LOOKUP[bl]


def pack_rows(values: np.ndarray, bits: int) -> np.ndarray:
    """Pack [n, 128] uint32 rows at width `bits` -> [n, words] uint32."""
    n, count = values.shape
    if bits == 0:
        return np.zeros((n, 0), dtype=np.uint32)
    if bits == 32:
        return np.ascontiguousarray(values, dtype=np.uint32)
    per = 32 // bits
    n_words = count // per
    lanes = np.ascontiguousarray(values, dtype=np.uint32).reshape(n, n_words, per)
    shifts = (np.arange(per, dtype=np.uint32) * bits).astype(np.uint32)
    return np.bitwise_or.reduce(lanes << shifts, axis=2, dtype=np.uint32)


def unpack_rows(words: np.ndarray, bits: int, count: int = 128) -> np.ndarray:
    """Unpack [n, words] uint32 rows at width `bits` -> [n, count] uint32
    (the vectorized many-blocks form of `unpack`)."""
    n = words.shape[0]
    if bits == 0:
        return np.zeros((n, count), dtype=np.uint32)
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if bits == 32:
        return words[:, :count].copy()
    per = 32 // bits
    shifts = (np.arange(per, dtype=np.uint32) * bits).astype(np.uint32)
    mask = np.uint32((1 << bits) - 1)
    vals = ((words[:, :, None] >> shifts[None, None, :]) & mask)
    return vals.reshape(n, -1)[:, :count]


def unpack(words: np.ndarray, bits: int, count: int) -> np.ndarray:
    """Unpack `count` uint32 values of width `bits` from `words`."""
    if bits == 0:
        return np.zeros(count, dtype=np.uint32)
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if bits == 32:
        return words[:count].copy()
    per = 32 // bits
    shifts = (np.arange(per, dtype=np.uint32) * bits).astype(np.uint32)
    mask = np.uint32((1 << bits) - 1)
    vals = ((words[:, None] >> shifts[None, :]) & mask).reshape(-1)
    return vals[:count]
