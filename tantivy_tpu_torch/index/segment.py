"""Segment identity + metadata (reference `src/index/index_meta.rs`,
`segment_id.rs`, `segment_component.rs`).

A segment's files are `{segment_id}.{component}` with components
idx / term / fieldnorm / fast / store, plus `{segment_id}.{opstamp}.del` for
the alive bitset after deletes.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field


SEGMENT_COMPONENTS = ("idx", "term", "fieldnorm", "fast", "store")

#: On-disk format version of *this* package (independent of the reference's
#: INDEX_FORMAT_VERSION=7 — the formats are deliberately different).
INDEX_FORMAT_VERSION = 1


def new_segment_id() -> str:
    return uuid.uuid4().hex


@dataclass
class SegmentMeta:
    segment_id: str
    max_doc: int
    delete_opstamp: int | None = None
    num_deleted_docs: int = 0

    def num_docs(self) -> int:
        return self.max_doc - self.num_deleted_docs

    def has_deletes(self) -> bool:
        return self.delete_opstamp is not None and self.num_deleted_docs > 0

    def relative_path(self, component: str) -> str:
        if component == "del":
            return f"{self.segment_id}.{self.delete_opstamp}.del"
        return f"{self.segment_id}.{component}"

    def list_files(self) -> list[str]:
        files = [self.relative_path(c) for c in SEGMENT_COMPONENTS]
        if self.delete_opstamp is not None:
            files.append(self.relative_path("del"))
        return files

    def to_json(self) -> dict:
        return {
            "segment_id": self.segment_id,
            "max_doc": self.max_doc,
            "deletes": (
                {"opstamp": self.delete_opstamp, "num_deleted_docs": self.num_deleted_docs}
                if self.delete_opstamp is not None
                else None
            ),
        }

    @classmethod
    def from_json(cls, d: dict) -> "SegmentMeta":
        deletes = d.get("deletes")
        return cls(
            segment_id=d["segment_id"],
            max_doc=d["max_doc"],
            delete_opstamp=deletes["opstamp"] if deletes else None,
            num_deleted_docs=deletes["num_deleted_docs"] if deletes else 0,
        )


@dataclass
class IndexMeta:
    """The durable manifest, serialized atomically to meta.json (reference
    `index_meta.rs:329`; commit = atomic meta.json swap)."""

    schema_json: str
    segments: list[SegmentMeta] = field(default_factory=list)
    opstamp: int = 0
    payload: str | None = None
    settings: dict | None = None

    def to_json(self) -> dict:
        import json

        return {
            "index_format_version": INDEX_FORMAT_VERSION,
            "segments": [s.to_json() for s in self.segments],
            "schema": json.loads(self.schema_json),
            "opstamp": self.opstamp,
            "payload": self.payload,
            "settings": self.settings,
        }

    @classmethod
    def from_json(cls, d: dict) -> "IndexMeta":
        import json

        version = d.get("index_format_version")
        if version != INDEX_FORMAT_VERSION:
            raise IOError(
                f"unsupported index format version {version} "
                f"(supported: {INDEX_FORMAT_VERSION})"
            )
        return cls(
            schema_json=json.dumps(d["schema"]),
            segments=[SegmentMeta.from_json(s) for s in d["segments"]],
            opstamp=d["opstamp"],
            payload=d.get("payload"),
            settings=d.get("settings"),
        )
