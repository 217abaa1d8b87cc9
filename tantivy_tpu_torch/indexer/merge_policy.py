"""Merge policies (reference `src/indexer/merge_policy.rs`,
`log_merge_policy.rs`)."""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..index.segment import SegmentMeta


class MergePolicy:
    def compute_merge_candidates(self, segments: list[SegmentMeta]) -> list[list[str]]:
        """Returns lists of segment_ids to merge together."""
        raise NotImplementedError


class NoMergePolicy(MergePolicy):
    def compute_merge_candidates(self, segments: list[SegmentMeta]) -> list[list[str]]:
        return []


@dataclass
class LogMergePolicy(MergePolicy):
    """Segments are bucketed by log(size); buckets with >= `min_num_segments`
    members merge (reference `log_merge_policy.rs:8-70` semantics and default
    constants)."""

    min_num_segments: int = 8
    max_docs_before_merge: int = 10_000_000
    min_layer_size: int = 10_000
    level_log_size: float = 0.75
    del_docs_ratio_before_merge: float = 1.0

    def _clip(self, num_docs: int) -> float:
        return math.log(max(num_docs, self.min_layer_size), 2.0)

    def compute_merge_candidates(self, segments: list[SegmentMeta]) -> list[list[str]]:
        candidates: list[list[str]] = []
        sized = [s for s in segments if 0 < s.num_docs() <= self.max_docs_before_merge]
        # deletes-driven merges (self-merge compacts tombstones)
        if self.del_docs_ratio_before_merge < 1.0:
            for s in list(sized):
                if s.max_doc > 0 and (
                    s.num_deleted_docs / s.max_doc >= self.del_docs_ratio_before_merge
                ):
                    candidates.append([s.segment_id])
                    sized.remove(s)
        sized.sort(key=lambda s: s.num_docs(), reverse=True)
        if not sized:
            return candidates
        current_level: list[SegmentMeta] = []
        level_floor = None
        for s in sized:
            size_log = self._clip(s.num_docs())
            if level_floor is None or size_log >= level_floor:
                if level_floor is None:
                    level_floor = size_log - self.level_log_size
                current_level.append(s)
            else:
                if len(current_level) >= self.min_num_segments:
                    candidates.append([m.segment_id for m in current_level])
                current_level = [s]
                level_floor = size_log - self.level_log_size
        if len(current_level) >= self.min_num_segments:
            candidates.append([m.segment_id for m in current_level])
        return candidates
