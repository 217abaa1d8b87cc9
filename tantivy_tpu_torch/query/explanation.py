"""Score explanations — reference `src/query/explanation.rs`.

An `Explanation` is a tree of (value, description, details, context); the
format (including the BM25 node descriptions) follows the reference, which
itself copies Lucene's."""

from __future__ import annotations

import json


class DoesNotMatchError(ValueError):
    def __init__(self, doc: int):
        super().__init__(f"Document #({doc}) does not match")


class Explanation:
    __slots__ = ("value", "description", "details", "context")

    def __init__(self, description: str, value):
        import numpy as np

        self.value = np.float32(value)
        self.description = description
        self.details: list[Explanation] | None = None
        self.context: list[str] | None = None

    def add_detail(self, child: "Explanation") -> None:
        if self.details is None:
            self.details = []
        self.details.append(child)

    def add_const(self, description: str, value) -> None:
        self.add_detail(Explanation(description, value))

    def add_context(self, context: str) -> None:
        if self.context is None:
            self.context = []
        self.context.append(context)

    def to_dict(self) -> dict:
        d: dict = {
            "value": float(self.value),
            "description": self.description,
        }
        if self.details is not None:
            d["details"] = [c.to_dict() for c in self.details]
        if self.context is not None:
            d["context"] = self.context
        return d

    def to_pretty_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def __repr__(self):
        return f"Explanation({self.to_pretty_json()})"
