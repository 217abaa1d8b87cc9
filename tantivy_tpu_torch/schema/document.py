"""Documents — a multimap field -> values (reference `src/schema/document/`).

A `Document` is what users feed `IndexWriter.add_document` and what
`Searcher.doc` returns. Values are plain Python: str, int, float, bool, bytes,
dict (json), and facet paths (str starting with '/', via add_facet).
"""

from __future__ import annotations

import json as _json
from typing import Any, Iterator


class Document:
    __slots__ = ("_field_values",)

    def __init__(self, **fields: Any):
        self._field_values: list[tuple[str, Any]] = []
        for name, value in fields.items():
            if isinstance(value, (list, tuple)):
                for v in value:
                    self.add(name, v)
            else:
                self.add(name, value)

    def add(self, field: str, value: Any) -> "Document":
        self._field_values.append((field, value))
        return self

    def add_text(self, field: str, value: str) -> "Document":
        return self.add(field, str(value))

    def add_u64(self, field: str, value: int) -> "Document":
        return self.add(field, int(value))

    def add_i64(self, field: str, value: int) -> "Document":
        return self.add(field, int(value))

    def add_f64(self, field: str, value: float) -> "Document":
        return self.add(field, float(value))

    def add_bool(self, field: str, value: bool) -> "Document":
        return self.add(field, bool(value))

    def add_date(self, field: str, timestamp_s: int) -> "Document":
        return self.add(field, int(timestamp_s))

    def add_bytes(self, field: str, value: bytes) -> "Document":
        return self.add(field, bytes(value))

    def add_facet(self, field: str, path: str) -> "Document":
        return self.add(field, str(path))

    def add_json(self, field: str, value: dict) -> "Document":
        return self.add(field, dict(value))

    def get_all(self, field: str) -> list[Any]:
        return [v for f, v in self._field_values if f == field]

    def get_first(self, field: str) -> Any | None:
        for f, v in self._field_values:
            if f == field:
                return v
        return None

    def field_values(self) -> Iterator[tuple[str, Any]]:
        return iter(self._field_values)

    def __len__(self) -> int:
        return len(self._field_values)

    def to_json(self) -> str:
        out: dict[str, list[Any]] = {}
        for f, v in self._field_values:
            if isinstance(v, bytes):
                import base64

                v = {"__bytes__": base64.b64encode(v).decode("ascii")}
            out.setdefault(f, []).append(v)
        return _json.dumps(out)

    @classmethod
    def from_json(cls, payload: str) -> "Document":
        doc = cls()
        for f, values in _json.loads(payload).items():
            for v in values:
                if isinstance(v, dict) and "__bytes__" in v:
                    import base64

                    v = base64.b64decode(v["__bytes__"])
                doc.add(f, v)
        return doc

    def __repr__(self) -> str:
        return f"Document({self._field_values!r})"
