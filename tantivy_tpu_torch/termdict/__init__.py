"""Term dictionary: sorted term bytes -> TermInfo (term ordinal).

Reference counterpart: `src/termdict/` (FST or sstable backends). TPU-first
choice: the sstable layout (reference `sstable/README.md:30-80`,
`sstable/src/dictionary.rs:40`) — terms are stored front-compressed
(per-term `keep` prefix-share + `add` suffix length, the KeepAdd scheme) in
64-term blocks, 16 blocks per zstd-compressed chunk, and the dictionary
stays COMPRESSED in memory: probes decompress one chunk and decode one
block ("one fetch per get"), never materializing the whole key set.

Resident state per dictionary (the two-level block index of the reference
sstable):

* `zdata`      — concatenated zstd frames, one per 1024-term chunk;
* `chunk_off`  — byte offset of each chunk's frame in `zdata`;
* `blk_off`    — each 64-term block's offset in the UNCOMPRESSED stream;
* `head8`      — u64 of each block head's first 8 key bytes (big-endian,
  so u64 order == lexicographic order on those bytes): `searchsorted`
  narrows any probe to one block (ties on the 8-byte prefix refine by
  decoding the tied heads).

Lookups:
* `term_ord`/`term_ords`/`range_ords`: head8 searchsorted -> decode the one
  candidate block -> bisect (blocks decode through a small LRU).
* `search_levenshtein`: lazy term-length column + banded edit-distance DP
  where every DP cell is a numpy vector over the surviving terms (the
  batched dual of the reference's Levenshtein DFA ∩ FST walk,
  `fuzzy_query.rs:80`); the candidate byte matrix materializes only the
  candidates' blocks.
* `search_regex`: a literal prefix extracted from the pattern prunes to a
  block range (reference `sstable/src/block_match_automaton.rs`), then the
  range STREAMS block-by-block through the automaton — no whole-dict
  decode.

TermInfo is implicit: `term ordinal` indexes the per-field postings arrays
(`term_block_start/term_num_blocks/term_doc_freq`), mirroring reference
`TermInfo{doc_freq, postings_range, positions_range}`
(`src/postings/term_info.rs:9-16`).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from collections import OrderedDict
from typing import Iterator

import numpy as np

#: terms per front-compression block (reference sstable restarts each block)
SST_BLOCK = 64
#: blocks per zstd chunk (the decompression unit)
CHUNK_BLOCKS = 16
CHUNK_TERMS = SST_BLOCK * CHUNK_BLOCKS

_P8_POW = (np.uint64(1) << (np.arange(7, -1, -1, dtype=np.uint64) * np.uint64(8)))


def _zc():
    import zstandard

    return zstandard.ZstdCompressor(level=3)


def _zd():
    import zstandard

    return zstandard.ZstdDecompressor()


def _write_vint(value: int, out: bytearray) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_vint(data: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = data[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, pos
        shift += 7


def _key8_of(key: bytes) -> np.uint64:
    return np.uint64(int.from_bytes(key[:8].ljust(8, b"\0"), "big"))


class TermDictionary:
    def __init__(
        self,
        zdata: np.ndarray,
        chunk_off: np.ndarray,
        blk_off: np.ndarray,
        head8: np.ndarray,
        n_terms: int,
        ascii_flag: bool,
    ):
        self._zdata = bytes(np.ascontiguousarray(zdata, dtype=np.uint8))
        self._chunk_off = np.ascontiguousarray(chunk_off, dtype=np.int64)
        self._blk_off = np.ascontiguousarray(blk_off, dtype=np.int64)
        self._head8 = np.ascontiguousarray(head8, dtype=np.uint64)
        self._n = int(n_terms)
        self._ascii = bool(ascii_flag)
        #: decompressed chunk LRU (bytes of CHUNK_TERMS front-compressed keys)
        self._chunks: OrderedDict[int, bytes] = OrderedDict()
        #: decoded block LRU: block -> list[bytes] keys
        self._blocks: OrderedDict[int, list] = OrderedDict()
        self._lens: np.ndarray | None = None  # lazy per-term lengths

    _CHUNK_CACHE = 64
    _BLOCK_CACHE = 4096

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_sorted_terms(cls, terms: list[bytes]) -> "TermDictionary":
        n = len(terms)
        if n == 0:
            return cls(
                np.zeros(0, np.uint8), np.zeros(1, np.int64),
                np.zeros(1, np.int64), np.zeros(0, np.uint64), 0, True,
            )
        keep = _common_prefix_lens(terms)
        keep[np.arange(0, n, SST_BLOCK)] = 0  # block restarts: full key

        enc = bytearray()
        n_blocks = -(-n // SST_BLOCK)
        blk_off = np.zeros(n_blocks + 1, dtype=np.int64)
        head8 = np.zeros(n_blocks, dtype=np.uint64)
        for i, t in enumerate(terms):
            if i % SST_BLOCK == 0:
                b = i // SST_BLOCK
                blk_off[b] = len(enc)
                head8[b] = _key8_of(t)
            kp = int(keep[i])
            _write_vint(kp, enc)
            _write_vint(len(t) - kp, enc)
            enc += t[kp:]
        blk_off[n_blocks] = len(enc)

        raw = bytes(enc)
        comp = _zc()
        n_chunks = -(-n_blocks // CHUNK_BLOCKS)
        chunk_off = np.zeros(n_chunks + 1, dtype=np.int64)
        frames = []
        for c in range(n_chunks):
            lo = int(blk_off[c * CHUNK_BLOCKS])
            hi = int(blk_off[min((c + 1) * CHUNK_BLOCKS, n_blocks)])
            frames.append(comp.compress(raw[lo:hi]))
            chunk_off[c + 1] = chunk_off[c] + len(frames[-1])
        zdata = np.frombuffer(b"".join(frames), dtype=np.uint8)
        # ascii-ness of all terms == ascii-ness of the suffix stream
        # (prefixes are built from earlier suffix bytes)
        raw_a = np.frombuffer(raw, dtype=np.uint8)
        ascii_flag = bool(len(raw_a) == 0 or int(raw_a.max()) < 128)
        return cls(zdata, chunk_off, blk_off, head8, n, ascii_flag)

    @classmethod
    def from_arrays(cls, arrays: dict[str, np.ndarray]) -> "TermDictionary":
        if "sst_zdata" in arrays:
            return cls(
                arrays["sst_zdata"],
                arrays["sst_chunk_off"],
                arrays["sst_blk_off"],
                arrays["sst_head8"].view(np.uint64),
                int(np.asarray(arrays["sst_n_terms"])[0]),
                bool(np.asarray(arrays["sst_ascii"])[0]),
            )
        # legacy layouts (round-1 raw concat / round-4 resident
        # front-compression): decode fully, rebuild in the current form
        if "term_data" in arrays:
            data = bytes(
                np.ascontiguousarray(arrays["term_data"], dtype=np.uint8)
            )
            off = np.asarray(arrays["term_offsets"], dtype=np.int64)
            terms = [data[off[i]: off[i + 1]] for i in range(len(off) - 1)]
            return cls.from_sorted_terms(terms)
        pl = np.asarray(arrays["sst_prefix_lens"], dtype=np.int64)
        soff = np.asarray(arrays["sst_suffix_offsets"], dtype=np.int64)
        sdata = bytes(
            np.ascontiguousarray(arrays["sst_suffix_data"], dtype=np.uint8)
        )
        terms = []
        prev = b""
        for i in range(len(pl)):
            # legacy block length was 16; restarts carry pl == 0 anyway
            t = prev[: pl[i]] + sdata[soff[i]: soff[i + 1]]
            terms.append(t)
            prev = t
        return cls.from_sorted_terms(terms)

    def to_arrays(self) -> dict[str, np.ndarray]:
        return {
            "sst_zdata": np.frombuffer(self._zdata, dtype=np.uint8),
            "sst_chunk_off": self._chunk_off,
            "sst_blk_off": self._blk_off,
            "sst_head8": self._head8.view(np.int64),
            "sst_n_terms": np.asarray([self._n], dtype=np.int64),
            "sst_ascii": np.asarray([int(self._ascii)], dtype=np.int64),
        }

    # -- block decode ------------------------------------------------------------

    def _chunk(self, c: int) -> bytes:
        got = self._chunks.get(c)
        if got is not None:
            self._chunks.move_to_end(c)
            return got
        lo, hi = int(self._chunk_off[c]), int(self._chunk_off[c + 1])
        raw = _zd().decompress(self._zdata[lo:hi])
        self._chunks[c] = raw
        if len(self._chunks) > self._CHUNK_CACHE:
            self._chunks.popitem(last=False)
        return raw

    def _n_blocks(self) -> int:
        return len(self._head8)

    def _block(self, b: int) -> list:
        """Decoded keys of block b (<= SST_BLOCK entries)."""
        got = self._blocks.get(b)
        if got is not None:
            self._blocks.move_to_end(b)
            return got
        c = b // CHUNK_BLOCKS
        raw = self._chunk(c)
        base = int(self._blk_off[c * CHUNK_BLOCKS])
        pos = int(self._blk_off[b]) - base
        end = int(self._blk_off[b + 1]) - base
        n_here = min(SST_BLOCK, self._n - b * SST_BLOCK)
        keys = []
        prev = b""
        for _ in range(n_here):
            if pos >= end:
                break
            kp, pos = _read_vint(raw, pos)
            ad, pos = _read_vint(raw, pos)
            t = prev[:kp] + raw[pos: pos + ad]
            pos += ad
            keys.append(t)
            prev = t
        self._blocks[b] = keys
        if len(self._blocks) > self._BLOCK_CACHE:
            self._blocks.popitem(last=False)
        return keys

    def __len__(self) -> int:
        return self._n

    def term(self, ordinal: int) -> bytes:
        if ordinal < 0 or ordinal >= self._n:
            raise IndexError(ordinal)
        return self._block(ordinal // SST_BLOCK)[ordinal % SST_BLOCK]

    # -- lookups ---------------------------------------------------------------

    def _candidate_block(self, key: bytes) -> int:
        """Largest block whose head <= key, or -1 if key < head(0)."""
        nb = self._n_blocks()
        if nb == 0:
            return -1
        k8 = _key8_of(key)
        lo8 = int(np.searchsorted(self._head8, k8, side="left"))
        hi8 = int(np.searchsorted(self._head8, k8, side="right"))
        if lo8 == hi8:
            return lo8 - 1
        heads = _HeadView(self)
        return bisect_right(heads, key, lo8, hi8) - 1

    def _bisect(self, key: bytes, side: str) -> int:
        b = self._candidate_block(key)
        if b < 0:
            return 0
        keys = self._block(b)
        fn = bisect_left if side == "left" else bisect_right
        return b * SST_BLOCK + fn(keys, key)

    def term_ord(self, key: bytes) -> int | None:
        b = self._candidate_block(key)
        if b < 0:
            return None
        keys = self._block(b)
        i = bisect_left(keys, key)
        if i < len(keys) and keys[i] == key:
            return b * SST_BLOCK + i
        return None

    def term_ords(self, keys: list[bytes]) -> np.ndarray:
        """Batch exact lookup -> int64 ordinals (-1 where absent). One
        vectorized head8 searchsorted narrows every key to a block; block
        decodes ride the LRU."""
        n = len(keys)
        out = np.full(n, -1, dtype=np.int64)
        if n == 0 or self._n == 0:
            return out
        k8 = np.array([_key8_of(k) for k in keys], dtype=np.uint64)
        lo8 = np.searchsorted(self._head8, k8, side="left")
        hi8 = np.searchsorted(self._head8, k8, side="right")
        heads = _HeadView(self)
        for r in range(n):
            b = int(lo8[r]) - 1
            if lo8[r] != hi8[r]:
                b = bisect_right(heads, keys[r], int(lo8[r]), int(hi8[r])) - 1
            if b < 0:
                continue
            blk = self._block(b)
            i = bisect_left(blk, keys[r])
            if i < len(blk) and blk[i] == keys[r]:
                out[r] = b * SST_BLOCK + i
        return out

    def range_ords(
        self,
        lower: bytes | None = None,
        upper: bytes | None = None,
        include_lower: bool = True,
        include_upper: bool = False,
    ) -> range:
        """Ordinal range for terms in [lower, upper) (bounds optional)."""
        lo = 0
        if lower is not None:
            lo = self._bisect(lower, "left" if include_lower else "right")
        hi = self._n
        if upper is not None:
            hi = self._bisect(upper, "right" if include_upper else "left")
        return range(lo, max(lo, hi))

    def prefix_ords(self, prefix: bytes) -> range:
        """Ordinals of terms starting with `prefix`."""
        if not prefix:
            return range(self._n)
        upper = bytearray(prefix)
        while upper and upper[-1] == 0xFF:
            upper.pop()
        if upper:
            upper[-1] += 1
            return self.range_ords(prefix, bytes(upper))
        return self.range_ords(prefix, None)

    def stream(self) -> Iterator[tuple[int, bytes]]:
        i = 0
        for b in range(self._n_blocks()):
            for t in self._block(b):
                yield i, t
                i += 1

    # -- automaton search -------------------------------------------------------

    def _is_ascii(self) -> bool:
        return self._ascii

    def term_lens(self) -> np.ndarray:
        """Per-term byte lengths (lazy; ONE pass over the compressed
        stream — lengths decode from the KeepAdd headers without
        materializing any key)."""
        if self._lens is None:
            lens = np.zeros(self._n, dtype=np.int32)
            i = 0
            nb = self._n_blocks()
            for b in range(nb):
                c = b // CHUNK_BLOCKS
                raw = self._chunk(c)
                base = int(self._blk_off[c * CHUNK_BLOCKS])
                pos = int(self._blk_off[b]) - base
                end = int(self._blk_off[b + 1]) - base
                while pos < end and i < self._n:
                    kp, pos = _read_vint(raw, pos)
                    ad, pos = _read_vint(raw, pos)
                    pos += ad
                    lens[i] = kp + ad
                    i += 1
            self._lens = lens
        return self._lens

    def _materialize(self, ords: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(concat u8, offsets int64) of the given ordinals' key bytes —
        decodes only the blocks the ordinals touch."""
        parts = []
        offsets = np.zeros(len(ords) + 1, dtype=np.int64)
        total = 0
        for r, o in enumerate(ords):
            t = self.term(int(o))
            parts.append(t)
            total += len(t)
            offsets[r + 1] = total
        data = np.frombuffer(b"".join(parts), dtype=np.uint8)
        return data, offsets

    def search_levenshtein(
        self, target: str, k: int, transposition: bool = False,
        prefix: bool = False,
    ) -> list[int]:
        """Ordinals within edit distance <= k of `target`. Vectorized banded
        DP over all length-eligible terms at once (ASCII fast path); falls
        back to the scalar matcher otherwise."""
        from ..query.automaton_queries import levenshtein_within

        if not (self._is_ascii() and target.isascii()) or self._n == 0:
            out = []
            for i, tb in self.stream():
                text = tb.decode("utf-8", errors="replace")
                if prefix and len(text) > len(target):
                    text = text[: len(target)]
                if levenshtein_within(target, text, k, transposition):
                    out.append(i)
            return out

        lens = self.term_lens()
        if prefix:
            eff_lens = np.minimum(lens, len(target))
        else:
            eff_lens = lens
        cand = np.nonzero(np.abs(eff_lens - len(target)) <= k)[0]
        if len(cand) == 0:
            return []
        L = len(target) + k
        data, off = self._materialize(cand)
        clens = np.minimum(eff_lens[cand], L).astype(np.int64)
        total = len(data)
        idx = np.minimum(
            off[:-1, None] + np.arange(max(L, 1)), max(total - 1, 0)
        )
        mat = data[idx] if total else np.zeros((len(cand), max(L, 1)), np.uint8)
        ok = _banded_levenshtein_leq(
            np.frombuffer(target.encode("ascii"), dtype=np.uint8),
            mat, clens, k, transposition,
        )
        return [int(c) for c in cand[ok]]

    def search_regex(self, pattern) -> list[int]:
        """Ordinals whose term full-matches `pattern` (compiled re). A
        literal prefix extracted from the pattern prunes the scan range;
        candidate blocks STREAM through the automaton (reference
        `block_match_automaton.rs` — no whole-dictionary decode)."""
        lit = _literal_prefix(pattern.pattern)
        rng = self.prefix_ords(lit.encode("utf-8")) if lit else range(self._n)
        out = []
        if len(rng) == 0:
            return out
        b0, b1 = rng.start // SST_BLOCK, (rng.stop - 1) // SST_BLOCK
        for b in range(b0, b1 + 1):
            base = b * SST_BLOCK
            for j, t in enumerate(self._block(b)):
                i = base + j
                if i < rng.start or i >= rng.stop:
                    continue
                if pattern.fullmatch(t.decode("utf-8", errors="replace")):
                    out.append(i)
        return out

    def search_automaton(self, accepts) -> list[int]:
        """Ordinals of terms accepted by `accepts: bytes -> bool` — generic
        fallback (reference `automaton_weight.rs`)."""
        return [i for i, t in self.stream() if accepts(t)]


class _HeadView:
    """List-like adapter for bisect over block head keys."""

    __slots__ = ("td",)

    def __init__(self, td: TermDictionary):
        self.td = td

    def __len__(self):
        return self.td._n_blocks()

    def __getitem__(self, b):
        return self.td._block(b)[0]


def _common_prefix_lens(terms: list[bytes]) -> np.ndarray:
    """keep[i] = common prefix length of terms[i-1], terms[i] (keep[0]=0) —
    vectorized over the first 64 bytes, exact Python extension for the
    rare longer-shared-prefix rows (JSON path terms)."""
    n = len(terms)
    keep = np.zeros(n, dtype=np.int64)
    if n < 2:
        return keep
    lens = np.fromiter((len(t) for t in terms), np.int64, n)
    W = int(min(max(lens.max(), 1), 64))
    data = np.frombuffer(b"".join(terms), dtype=np.uint8)
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    total = len(data)
    idx = np.minimum(off[:-1, None] + np.arange(W), max(total - 1, 0))
    mat = data[idx] if total else np.zeros((n, W), np.uint8)
    minlen = np.minimum(lens[1:], lens[:-1])
    eq = (mat[1:] == mat[:-1]) & (np.arange(W) < minlen[:, None])
    allw = eq.all(axis=1)
    cpl = np.where(allw, np.minimum(W, minlen), np.argmin(eq, axis=1))
    keep[1:] = cpl
    # rows whose shared prefix may extend past the vectorized window
    for r in np.nonzero(allw & (minlen > W))[0]:
        a, b = terms[r], terms[r + 1]
        i = W
        m = int(minlen[r])
        while i < m and a[i] == b[i]:
            i += 1
        keep[r + 1] = i
    return keep


def _has_toplevel_alternation(pattern: str) -> bool:
    """True if the pattern has an unescaped '|' at group depth 0 (outside
    character classes). Such a pattern matches strings that need not share
    any literal prefix, so prefix pruning is unsound."""
    depth = 0
    in_class = False
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            i += 2
            continue
        if in_class:
            if ch == "]":
                in_class = False
        elif ch == "[":
            in_class = True
        elif ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        elif ch == "|" and depth == 0:
            return True
        i += 1
    return False


def _literal_prefix(pattern: str) -> str:
    """Longest literal prefix of a regex pattern (conservative)."""
    if _has_toplevel_alternation(pattern):
        # 'apple|banana' shares no prefix: pruning to 'apple' would drop
        # every match of the other branches.
        return ""
    out = []
    i = 0
    meta = set(".^$*+?{}[]|()\\")
    while i < len(pattern):
        ch = pattern[i]
        if ch in meta:
            # a trailing quantifier applies to the previous char: drop it
            if ch in "*+?{" and out:
                out.pop()
            break
        out.append(ch)
        i += 1
    return "".join(out)


def _banded_levenshtein_leq(
    a: np.ndarray, mat: np.ndarray, blens: np.ndarray, k: int,
    transposition: bool,
) -> np.ndarray:
    """dist(a, mat[r, :blens[r]]) <= k per row, banded DP fully vectorized
    over rows. `a`: [la] u8; `mat`: [m, L] u8; returns bool [m].

    Band coordinate d = j - i + k (d in [0, 2k]); cell (i, d) = dist(i, j):
      deletion      dist(i-1, j)   -> prev[d+1] + 1
      insertion     dist(i,   j-1) -> band[d-1] + 1  (same row, earlier d)
      substitution  dist(i-1, j-1) -> prev[d]  + cost
      transposition dist(i-2, j-2) -> prev2[d] + 1
    """
    la = len(a)
    m = mat.shape[0]
    L = mat.shape[1]
    inf = np.int32(k + 1)
    width = 2 * k + 1
    infrow = np.full(m, inf, dtype=np.int32)
    # i = 0 row: dist(0, j) = j for j <= k (d = j + k)
    prev = [
        np.full(m, d - k, dtype=np.int32) if d >= k else infrow.copy()
        for d in range(width)
    ]
    prev2 = [infrow.copy() for _ in range(width)]
    for i in range(1, la + 1):
        band = [infrow.copy() for _ in range(width)]
        for d in range(width):
            j = i + d - k
            if j < 0 or L == 0:
                continue
            if j == 0:
                if i <= k:
                    band[d][:] = i
                continue
            jj = min(j - 1, L - 1)
            bchar = mat[:, jj]
            cost = (bchar != a[i - 1]).astype(np.int32)
            best = prev[d] + cost  # substitution / match
            if d + 1 < width:
                best = np.minimum(best, prev[d + 1] + 1)  # deletion
            if d - 1 >= 0:
                best = np.minimum(best, band[d - 1] + 1)  # insertion
            if transposition and i > 1 and j > 1:
                b2 = mat[:, min(j - 2, L - 1)]
                tr = (bchar == a[i - 2]) & (b2 == a[i - 1])
                best = np.where(tr, np.minimum(best, prev2[d] + 1), best)
            band[d][:] = np.where(j <= blens, np.minimum(best, inf), inf)
        prev2, prev = prev, band
    d_final = blens - la + k
    out = np.zeros(m, dtype=bool)
    for d in range(width):
        sel = d_final == d
        if sel.any():
            out[sel] = prev[d][sel] <= k
    return out
