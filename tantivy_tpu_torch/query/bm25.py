"""BM25 similarity — exact f32 parity with reference `src/query/bm25.rs`.

All arithmetic is float32, matching tantivy's `Score = f32`:
  idf        = ln(1 + (N - n + 0.5) / (n + 0.5))                 (bm25.rs:52-56)
  weight     = idf * (1 + K1)                                    (bm25.rs:159)
  cache[id]  = K1 * (1 - B + B * fieldnorm(id) / avg_fieldnorm)  (bm25.rs:58-69)
  score      = weight * tf / (tf + cache[fieldnorm_id])          (bm25.rs:179-193)
with K1 = 1.2, B = 0.75 and avg_fieldnorm = total_num_tokens / total_num_docs
(f32 division, bm25.rs:111). The 256-entry cache is the device-side lookup
table: scoring a block is `gather(cache, norm_ids) -> fused VPU math`.
"""

from __future__ import annotations

import numpy as np

from ..fieldnorm import FIELD_NORMS_TABLE

K1 = np.float32(1.2)
B = np.float32(0.75)

_FIELD_NORMS_F32 = FIELD_NORMS_TABLE.astype(np.float32)


def idf(doc_freq: int, doc_count: int) -> np.float32:
    assert doc_count >= doc_freq, f"{doc_count} >= {doc_freq}"
    x = (np.float32(doc_count - doc_freq) + np.float32(0.5)) / (
        np.float32(doc_freq) + np.float32(0.5)
    )
    return np.log1p(x, dtype=np.float32)


def compute_tf_cache(average_fieldnorm: np.float32) -> np.ndarray:
    """The per-fieldnorm-id saturation denominators (float32[256])."""
    one = np.float32(1.0)
    return (K1 * (one - B + B * _FIELD_NORMS_F32 / np.float32(average_fieldnorm))).astype(
        np.float32
    )


class Bm25Weight:
    """Per-(query-term-set, field) scoring weight. Reference `bm25.rs:73`."""

    __slots__ = ("weight", "cache", "average_fieldnorm", "idf")

    def __init__(self, idf_value: np.float32, average_fieldnorm: np.float32):
        self.weight = np.float32(idf_value) * (np.float32(1.0) + K1)
        self.idf = np.float32(idf_value)  # kept unboosted for explain trees
        self.average_fieldnorm = np.float32(average_fieldnorm)
        self.cache = compute_tf_cache(self.average_fieldnorm)

    @classmethod
    def for_one_term(
        cls, term_doc_freq: int, total_num_docs: int, avg_fieldnorm
    ) -> "Bm25Weight":
        return cls(idf(term_doc_freq, total_num_docs), np.float32(avg_fieldnorm))

    @classmethod
    def for_terms(cls, doc_freqs, total_num_docs: int, avg_fieldnorm) -> "Bm25Weight":
        """Multi-term (phrase) weight: sum of per-term idfs (bm25.rs:120-127)."""
        idf_sum = np.float32(0.0)
        for df in doc_freqs:
            idf_sum = np.float32(idf_sum + idf(df, total_num_docs))
        return cls(idf_sum, np.float32(avg_fieldnorm))

    def boost_by(self, boost: float) -> "Bm25Weight":
        w = Bm25Weight.__new__(Bm25Weight)
        w.weight = np.float32(self.weight * np.float32(boost))
        w.idf = self.idf  # unchanged: explain shows the true idf
        w.average_fieldnorm = self.average_fieldnorm
        w.cache = self.cache
        return w

    def score(self, fieldnorm_id, term_freq) -> np.float32 | np.ndarray:
        return np.float32(self.weight) * self.tf_factor(fieldnorm_id, term_freq)

    def explain(self, fieldnorm_id: int, term_freq: int):
        """BM25 breakdown tree — format copied from the reference
        (`bm25.rs:196-226`, itself copied from Lucene)."""
        from .explanation import Explanation

        score = self.score(np.uint8(fieldnorm_id), np.uint32(term_freq))
        norm = self.cache[int(fieldnorm_id)]
        tf = np.float32(term_freq)
        tf_expl = Explanation(
            "freq / (freq + k1 * (1 - b + b * dl / avgdl))",
            tf / (tf + norm),
        )
        tf_expl.add_const("freq, occurrences of term within document", tf)
        tf_expl.add_const("k1, term saturation parameter", K1)
        tf_expl.add_const("b, length normalization parameter", B)
        tf_expl.add_const(
            "dl, length of field", _FIELD_NORMS_F32[int(fieldnorm_id)]
        )
        tf_expl.add_const(
            "avgdl, average length of field", self.average_fieldnorm
        )
        expl = Explanation("TermQuery, product of...", score)
        expl.add_detail(Explanation("(K1+1)", K1 + np.float32(1.0)))
        expl.add_detail(Explanation(
            "idf, computed as ln(1 + (N - n + 0.5) / (n + 0.5))",
            self.idf,
        ))
        boost = np.float32(self.weight) / np.float32(
            self.idf * (K1 + np.float32(1.0))
        ) if self.idf else np.float32(1.0)
        if abs(float(boost) - 1.0) > 1e-6:
            expl.add_detail(Explanation("boost", boost))
        expl.add_detail(tf_expl)
        return expl

    def tf_factor(self, fieldnorm_id, term_freq) -> np.float32 | np.ndarray:
        tf = np.asarray(term_freq, dtype=np.float32)
        norm = self.cache[fieldnorm_id]
        out = (tf / (tf + norm)).astype(np.float32)
        if out.ndim == 0:
            return np.float32(out)
        return out

    def max_score(self) -> np.float32:
        """score(255, 2_013_265_944) — reference bm25.rs:184-186."""
        return self.score(255, 2_013_265_944)
