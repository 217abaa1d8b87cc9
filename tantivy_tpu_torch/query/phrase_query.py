"""Phrase queries (reference `src/query/phrase_query/`,
`phrase_prefix_query/`).

Match docs where the terms appear at consecutive positions (with optional
slop); score is BM25 with tf = number of phrase matches and the idf-sum
multi-term weight (reference `phrase_scorer.rs`, `bm25.rs:120-127`).
"""

from __future__ import annotations

import numpy as np

from ..schema import IndexRecordOption
from ..schema.term import Term
from . import Query, SegmentResult, Weight, member_lookup
from .bm25 import Bm25Weight


def _intersection_count_with_slop(
    left: list[int], right: list[int], slop: int, update_left: bool
) -> tuple[int, list[int]]:
    """Two-term sloppy intersection: |left - right| <= slop counts a match,
    with best-match advancement. Semantics of reference
    `phrase_scorer.rs:145-190` (intersection_count_with_slop)."""
    li = ri = count = 0
    ll, rl = len(left), len(right)
    out: list[int] = []
    while li < ll and ri < rl:
        lv, rv = left[li], right[ri]
        if abs(lv - rv) <= slop:
            # a later left value may be a better (closer) match
            while li + 1 < ll and left[li + 1] <= rv:
                li += 1
            if update_left:
                out.append(rv)
            count += 1
            li += 1
            ri += 1
        elif lv < rv:
            li += 1
        else:
            ri += 1
    return count, out


def _intersection_count_with_carrying_slop(
    left: list[int], slops: list[int], right: list[int], max_slop: int,
    update_left: bool,
) -> tuple[int, list[int], list[int]]:
    """Multi-term sloppy intersection carrying the slop budget spent so far.
    Semantics of reference `phrase_scorer.rs:232-345`
    (intersection_count_with_carrying_slop), including its documented
    approximation for ambiguous expansions."""
    if not left or not right:
        return 0, [], []
    new_pos: list[int] = []
    new_slops: list[int] = []

    def add_val(s: int, v: int) -> None:
        if update_left:
            if new_pos and new_pos[-1] == v:
                new_slops[-1] = min(new_slops[-1], s)
            else:
                new_pos.append(v)
                new_slops.append(s)

    li = ri = count = 0
    while True:
        lv = left[li]
        ssf = slops[li] if li < len(slops) else 0
        rv = right[ri]
        if ssf + abs(lv - rv) <= max_slop:
            if lv < rv:
                smaller, larger, sidx, spos = lv, rv, li, left
            else:
                smaller, larger, sidx, spos = rv, lv, ri, right
            new_slop = ssf + abs(lv - rv)
            add_val(new_slop, smaller)
            while sidx + 1 < len(spos):
                nv = spos[sidx + 1]
                if nv > larger:
                    break
                sidx += 1
                new_slop = ssf + abs(nv - larger)
                add_val(new_slop, nv)
            add_val(new_slop, larger)
            count += 1
            li += 1
            ri += 1
        elif lv < rv:
            li += 1
        else:
            ri += 1
        if li >= len(left) or ri >= len(right):
            if li >= len(left):
                lv = left[-1]
                ssf = slops[-1] if slops else 0
                for rv2 in right[ri:]:
                    ns = abs(lv - rv2) + ssf
                    if ns <= max_slop:
                        add_val(ns, rv2)
            else:
                rv = right[-1]
                for li2 in range(li, len(left)):
                    lv2 = left[li2]
                    ssf2 = slops[li2] if li2 < len(slops) else 0
                    ns = abs(lv2 - rv) + ssf2
                    if ns <= max_slop:
                        add_val(ns, lv2)
            break
    return count, new_pos, new_slops


def _slop2_counts_vectorized(
    lpad: np.ndarray, llen: np.ndarray, rpad: np.ndarray, rlen: np.ndarray,
    slop: int,
) -> np.ndarray:
    """Two-term sloppy intersection counts for MANY docs at once: the exact
    `_intersection_count_with_slop` cursor automaton (reference
    `phrase_scorer.rs:145-190`), advanced in lockstep across docs with
    numpy `where` steps instead of a per-doc Python loop. Every iteration
    advances each active doc's state by one transition, so the iteration
    count is bounded by max(llen) + max(rlen) + max(llen) (matches, skips,
    and best-match advancements), while each iteration is a handful of
    vector ops over all docs — the batched-host-tail analogue of the device
    kernels' lane parallelism.

    lpad/rpad: [D, Lmax]/[D, Rmax] i64 position arrays (aligned/shifted),
    llen/rlen: [D] real lengths. Returns counts [D]."""
    D, Lmax = lpad.shape
    Rmax = rpad.shape[1]
    li = np.zeros(D, dtype=np.int64)
    ri = np.zeros(D, dtype=np.int64)
    cnt = np.zeros(D, dtype=np.int64)
    active = (llen > 0) & (rlen > 0)
    rows = np.arange(D)
    for _ in range(2 * Lmax + Rmax + 2):
        if not active.any():
            break
        lv = lpad[rows, np.minimum(li, Lmax - 1)]
        rv = rpad[rows, np.minimum(ri, Rmax - 1)]
        close = np.abs(lv - rv) <= slop
        # best-match advancement: a later left value may be closer
        nxt = lpad[rows, np.minimum(li + 1, Lmax - 1)]
        adv = active & close & (li + 1 < llen) & (nxt <= rv)
        li = np.where(adv, li + 1, li)
        match = active & close & ~adv
        cnt += match
        li = np.where(match, li + 1, li)
        ri = np.where(match, ri + 1, ri)
        lt = active & ~close & (lv < rv)
        li = np.where(lt, li + 1, li)
        gt = active & ~close & ~(lv < rv)
        ri = np.where(gt, ri + 1, ri)
        active &= (li < llen) & (ri < rlen)
    return cnt


def _phrase_count_for_doc(pos_lists: list[np.ndarray], offsets: list[int],
                          slop: int) -> int:
    """Count phrase matches given per-term in-doc position arrays.

    Positions are aligned by shifting term i by `max_offset - offset_i`
    (reference `phrase_scorer.rs:382` PostingsWithOffset), then:
    slop == 0: size of the n-way intersection;
    slop > 0, 2 terms: intersection_count_with_slop;
    slop > 0, >2 terms: carrying-slop fold (reference semantics, including
    its documented approximation).
    """
    mx = max(offsets)
    shifted = [
        pl.astype(np.int64) + (mx - off) for pl, off in zip(pos_lists, offsets)
    ]
    if slop == 0:
        left = shifted[0]
        for r in shifted[1:]:
            left = np.intersect1d(left, r, assume_unique=True)
            if len(left) == 0:
                return 0
        return len(left)
    if len(shifted) == 2:
        count, _ = _intersection_count_with_slop(
            list(shifted[0]), list(shifted[1]), slop, False
        )
        return count
    left = list(shifted[0])
    slops: list[int] = []
    for r in shifted[1:-1]:
        _, left, slops = _intersection_count_with_carrying_slop(
            left, slops, list(r), slop, True
        )
        if not left:
            return 0
    count, _, _ = _intersection_count_with_carrying_slop(
        left, slops, list(shifted[-1]), slop, False
    )
    return count


class PhraseQuery(Query):
    def __init__(self, field: str, terms: list[str | bytes], slop: int = 0,
                 offsets: list[int] | None = None):
        self.field = field
        self.term_bytes = [
            t.encode("utf-8") if isinstance(t, str) else bytes(t) for t in terms
        ]
        if len(self.term_bytes) < 2:
            raise ValueError("PhraseQuery requires at least 2 terms")
        self.slop = slop
        self.offsets = offsets or list(range(len(self.term_bytes)))

    def __repr__(self):
        return f"PhraseQuery({self.field}:{self.term_bytes!r}, slop={self.slop})"

    def weight(self, searcher, scoring: bool = True) -> Weight:
        entry = searcher.schema.get_field(self.field)
        if entry.index_record_option() != IndexRecordOption.WITH_FREQS_AND_POSITIONS:
            raise ValueError(
                f"field {self.field} is not indexed with positions "
                "(required for phrase queries)"
            )
        bm25 = None
        if scoring:
            terms = [Term(self.field, tb) for tb in self.term_bytes]
            dfs = [searcher.doc_freq(t) for t in terms]
            stats = searcher.field_statistics(self.field)
            bm25 = Bm25Weight.for_terms(
                dfs, stats.total_num_docs, stats.average_fieldnorm
            )
        return PhraseWeight(self, bm25)


class PhraseWeight(Weight):
    def __init__(self, query: PhraseQuery, bm25: Bm25Weight | None):
        self.q = query
        self.bm25 = bm25

    def _gather_term_data(self, segment_reader):
        inv = segment_reader.inverted_index(self.q.field)
        data = []
        for tb in self.q.term_bytes:
            ord_ = inv.term_ord(tb)
            if ord_ is None:
                return None
            docs, tfs, pos = inv.positions_for_term(ord_)
            cum = np.zeros(len(tfs) + 1, dtype=np.int64)
            np.cumsum(tfs, out=cum[1:])
            data.append((docs, tfs, pos, cum))
        return data

    def execute(self, segment_reader) -> SegmentResult:
        data = self._gather_term_data(segment_reader)
        if data is None:
            return SegmentResult.empty()
        # intersect docs
        cand = data[0][0]
        for docs, _, _, _ in data[1:]:
            found, _ = member_lookup(docs, cand)
            cand = cand[found]
        if len(cand) == 0:
            return SegmentResult.empty()

        idx_per_term = [member_lookup(docs, cand)[1] for docs, _, _, _ in data]
        counts = self._counts_for(data, cand, idx_per_term)
        hit = counts > 0
        out_docs = cand[hit].astype(np.uint32)
        if self.bm25 is not None:
            norm_ids = segment_reader.fieldnorms(self.q.field)[out_docs]
            out_scores = np.asarray(
                self.bm25.score(norm_ids, counts[hit]), dtype=np.float32
            )
        else:
            out_scores = np.ones(len(out_docs), dtype=np.float32)
        return SegmentResult(out_docs, out_scores)

    def _counts_for(self, data, cand, idx_per_term):
        """Phrase-match counts for the given candidate docs (any subset)."""
        if self.q.slop == 0:
            return self._counts_exact_vectorized(data, cand, idx_per_term)
        if len(data) == 2:
            # vectorize the two-pointer automaton across all candidate docs
            mx = max(self.q.offsets)
            pads = []
            lens = []
            for t, (docs, tfs, pos, cum) in enumerate(data):
                idx = idx_per_term[t]
                ln = tfs[idx].astype(np.int64)
                lmax = max(int(ln.max(initial=1)), 1)
                base = cum[idx].astype(np.int64)
                gath = base[:, None] + np.arange(lmax, dtype=np.int64)
                gath = np.minimum(gath, max(len(pos) - 1, 0))
                pad = pos[gath].astype(np.int64) + (mx - self.q.offsets[t])
                pads.append(pad)
                lens.append(ln)
            return _slop2_counts_vectorized(
                pads[0], lens[0], pads[1], lens[1], self.q.slop
            )
        counts = np.zeros(len(cand), dtype=np.int64)
        for j in range(len(cand)):
            pos_lists = []
            for t, (docs, tfs, pos, cum) in enumerate(data):
                i = int(idx_per_term[t][j])
                pos_lists.append(
                    pos[int(cum[i]) : int(cum[i]) + int(tfs[i])]
                )
            counts[j] = _phrase_count_for_doc(
                pos_lists, self.q.offsets, self.q.slop
            )
        return counts

    def topk(self, segment_reader, k: int, threshold=np.float32(-np.inf)):
        """Threshold-pruned top-k evaluation — the host analogue of
        reference `Weight::for_each_pruning` (`weight.rs:123-132`).

        The phrase count of a doc is at most its minimum per-term tf, and
        the BM25 tf-factor is monotone in tf with IEEE-rounded (monotone)
        f32 ops, so `ub = bm25.score(norm, min_tf) >= score` holds bitwise.
        Candidates are evaluated in (ub desc, doc asc) order in chunks; the
        expensive position-intersection work stops as soon as no remaining
        candidate can beat the running kth (score, doc) — ties continue
        until the remaining plateau's smallest doc id can no longer win.
        `threshold`: docs with score <= threshold are pruned outright (the
        caller's accumulated kth score from strictly-earlier DocAddresses).
        Deletes ARE applied here (unlike execute) so pruning sees the same
        doc set the collector would."""
        if self.bm25 is None:
            res = self.execute(segment_reader)
            alive = segment_reader.alive_bitset()
            if alive is not None and len(res.docs):
                m = alive[res.docs]
                res = SegmentResult(res.docs[m], res.scores[m])
            return res
        data = self._gather_term_data(segment_reader)
        if data is None:
            return SegmentResult.empty()
        cand = data[0][0]
        for docs, _, _, _ in data[1:]:
            found, _ = member_lookup(docs, cand)
            cand = cand[found]
        alive = segment_reader.alive_bitset()
        if alive is not None and len(cand):
            cand = cand[alive[cand]]
        if len(cand) == 0:
            return SegmentResult.empty()
        idx_per_term = [member_lookup(docs, cand)[1] for docs, _, _, _ in data]
        min_tf = data[0][1][idx_per_term[0]].astype(np.int64)
        for t in range(1, len(data)):
            min_tf = np.minimum(
                min_tf, data[t][1][idx_per_term[t]].astype(np.int64)
            )
        norms = segment_reader.fieldnorms(self.q.field)[cand]
        ub = np.asarray(self.bm25.score(norms, min_tf), dtype=np.float32)
        live = ub > threshold
        cand, ub = cand[live], ub[live]
        idx_per_term = [i[live] for i in idx_per_term]
        order = np.lexsort((cand, -ub))
        out_docs: list[np.ndarray] = []
        out_scores: list[np.ndarray] = []
        kth_score = np.float32(threshold)
        kth_doc = -1  # only meaningful when hits are full
        n_hits = 0
        C = max(2048, 4 * k)
        for lo in range(0, len(order), C):
            sel = order[lo : lo + C]
            if n_hits >= k:
                nxt_ub = ub[sel[0]]
                if nxt_ub < kth_score or (
                    nxt_ub == kth_score and kth_doc < int(cand[sel[0]])
                ):
                    break
            sub_cand = cand[sel]
            sub_idx = [i[sel] for i in idx_per_term]
            counts = self._counts_for(data, sub_cand, sub_idx)
            hit = counts > 0
            if hit.any():
                d = sub_cand[hit].astype(np.uint32)
                s = np.asarray(
                    self.bm25.score(
                        segment_reader.fieldnorms(self.q.field)[d],
                        counts[hit],
                    ),
                    dtype=np.float32,
                )
                keep = s > threshold
                d, s = d[keep], s[keep]
                out_docs.append(d)
                out_scores.append(s)
                n_hits += len(d)
                if n_hits >= k:
                    ds = np.concatenate(out_docs)
                    ss = np.concatenate(out_scores)
                    top = np.lexsort((ds, -ss))[:k]
                    kth_score = np.float32(ss[top[-1]])
                    kth_doc = int(ds[top[-1]])
        if not out_docs:
            return SegmentResult.empty()
        ds = np.concatenate(out_docs)
        ss = np.concatenate(out_scores)
        o = np.argsort(ds)
        return SegmentResult(ds[o], ss[o])

    def _counts_exact_vectorized(self, data, cand, idx_per_term):
        """slop=0 phrase counts for ALL candidate docs in one pass: encode
        (doc, shifted position) as one int64 key, then every membership test
        is a searchsorted over a term's full key array (positions stay
        doc-local because the doc id rides the key's high bits)."""
        mx = max(self.q.offsets)
        SHIFT = np.int64(1) << np.int64(32)

        def keys_for(t):
            docs, tfs, pos, cum = data[t]
            i = idx_per_term[t]
            tf = tfs[i].astype(np.int64)
            starts = cum[i]
            total = int(tf.sum())
            if total == 0:
                return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(len(cand), np.int64))
            run = np.zeros(len(cand), dtype=np.int64)
            np.cumsum(tf[:-1], out=run[1:])
            within = np.arange(total, dtype=np.int64) - np.repeat(run, tf)
            pidx = np.repeat(starts.astype(np.int64), tf) + within
            doc_of = np.repeat(np.arange(len(cand), dtype=np.int64), tf)
            shifted = pos[pidx].astype(np.int64) + (mx - self.q.offsets[t])
            return doc_of * SHIFT + shifted, doc_of, tf

        base_keys, base_doc, _ = keys_for(0)
        match = np.ones(len(base_keys), dtype=bool)
        for t in range(1, len(data)):
            kt, _, _ = keys_for(t)
            j = np.searchsorted(kt, base_keys)
            j = np.minimum(j, max(len(kt) - 1, 0))
            match &= (kt[j] == base_keys) if len(kt) else False
        counts = np.bincount(base_doc[match], minlength=len(cand))
        return counts


class RegexPhraseQuery(Query):
    """Phrase where each slot may be a regex/wildcard matching several terms
    (reference `phrase_query/regex_phrase_{query,weight}.rs`): per slot, the
    union of all matching terms' postings/positions participates in the
    phrase intersection. Scores are const 1.0 (expansion semantics)."""

    def __init__(self, field: str, patterns: list[str], slop: int = 0,
                 max_expansions: int = 1 << 14):
        import re as _re

        self.field = field
        self.patterns = [_re.compile(_wildcard_to_regex(p)) for p in patterns]
        if len(self.patterns) < 2:
            raise ValueError("RegexPhraseQuery requires at least 2 terms")
        self.slop = slop
        self.offsets = list(range(len(self.patterns)))
        self.max_expansions = max_expansions

    def weight(self, searcher, scoring: bool = True) -> Weight:
        return RegexPhraseWeight(self)


def _wildcard_to_regex(pattern: str) -> str:
    """`*`/`?` wildcards pass through as regex if they look like one;
    plain words with `*` become `.*` etc. (reference wildcard mode)."""
    import re as _re

    # treat as raw regex if it contains regex metachars beyond * and ?
    if any(c in pattern for c in ".[](){}|+\\^$"):
        return pattern
    out = []
    for ch in pattern:
        if ch == "*":
            out.append(".*")
        elif ch == "?":
            out.append(".")
        else:
            out.append(_re.escape(ch))
    return "".join(out)


class RegexPhraseWeight(Weight):
    def __init__(self, query: RegexPhraseQuery):
        self.q = query

    def execute(self, segment_reader) -> SegmentResult:
        inv = segment_reader.inverted_index(self.q.field)
        # per slot: union of matching terms' (docs, tfs, positions)
        slot_data = []
        for pat in self.q.patterns:
            ords = inv.termdict.search_regex(pat)[: self.q.max_expansions]
            if not ords:
                return SegmentResult.empty()
            per_doc: dict[int, list] = {}
            for o in ords:
                docs, tfs, pos = inv.positions_for_term(o)
                cum = np.zeros(len(tfs) + 1, dtype=np.int64)
                np.cumsum(tfs, out=cum[1:])
                for i_d, d in enumerate(docs):
                    per_doc.setdefault(int(d), []).append(
                        pos[int(cum[i_d]) : int(cum[i_d + 1])]
                    )
            slot_data.append(
                {d: np.sort(np.concatenate(ps)) for d, ps in per_doc.items()}
            )
        # intersect docs across slots
        cand = set(slot_data[0])
        for sd in slot_data[1:]:
            cand &= set(sd)
        out_docs = []
        for d in sorted(cand):
            pos_lists = [sd[d] for sd in slot_data]
            if _phrase_count_for_doc(pos_lists, self.q.offsets, self.q.slop) > 0:
                out_docs.append(d)
        return SegmentResult(
            np.asarray(out_docs, dtype=np.uint32),
            np.ones(len(out_docs), dtype=np.float32),
        )


class PhrasePrefixQuery(Query):
    """Phrase whose last term is a prefix, expanded against the term dict
    (reference `phrase_prefix_query/`, expansion cap
    `max_expansions` default 50)."""

    def __init__(self, field: str, terms: list[str | bytes],
                 max_expansions: int = 50):
        self.field = field
        self.term_bytes = [
            t.encode("utf-8") if isinstance(t, str) else bytes(t) for t in terms
        ]
        if not self.term_bytes:
            raise ValueError("PhrasePrefixQuery requires at least 1 term")
        self.max_expansions = max_expansions

    def weight(self, searcher, scoring: bool = True) -> Weight:
        return PhrasePrefixWeight(self, searcher, scoring)


class PhrasePrefixWeight(Weight):
    def __init__(self, query: PhrasePrefixQuery, searcher, scoring: bool):
        self.q = query
        self.searcher = searcher
        self.scoring = scoring

    def execute(self, segment_reader) -> SegmentResult:
        from . import BooleanQuery, Occur, TermQuery

        inv = segment_reader.inverted_index(self.q.field)
        prefix = self.q.term_bytes[-1]
        ords = list(inv.termdict.prefix_ords(prefix))[: self.q.max_expansions]
        if not ords:
            return SegmentResult.empty()
        parts: list[SegmentResult] = []
        for o in ords:
            expanded = inv.termdict.term(o)
            if len(self.q.term_bytes) == 1:
                w = TermQuery(Term(self.q.field, expanded)).weight(
                    self.searcher, self.scoring
                )
            else:
                pq = PhraseQuery(
                    self.q.field, self.q.term_bytes[:-1] + [expanded]
                )
                w = pq.weight(self.searcher, self.scoring)
            parts.append(w.execute(segment_reader))
        parts = [p for p in parts if len(p.docs)]
        if not parts:
            return SegmentResult.empty()
        # union keeping max score per doc (expansion semantics)
        cand = np.unique(np.concatenate([p.docs for p in parts]))
        best = np.zeros(len(cand), dtype=np.float32)
        for p in parts:
            found, idx = member_lookup(p.docs, cand)
            sc = np.where(found, p.scores[idx], np.float32(0.0)).astype(np.float32)
            best = np.maximum(best, sc)
        return SegmentResult(cand, best)
