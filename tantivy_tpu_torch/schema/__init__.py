"""Schema & documents — parity with reference `src/schema/`.

Field types mirror `src/schema/field_type.rs:53-73` (Str, U64, I64, F64, Bool,
Date, Facet, Bytes, Json, IpAddr). Flags compose like the reference's bitflags:
``TEXT = indexing("default", positions) | ...``, ``STORED``, ``FAST``,
``INDEXED``, ``STRING = raw-tokenized indexed``.
"""

from __future__ import annotations

import json as _json
from dataclasses import dataclass, field as dc_field, replace
from enum import Enum
from typing import Any

from .term import Term  # noqa: F401  (re-export)
from .document import Document  # noqa: F401  (re-export)


class FieldType(str, Enum):
    TEXT = "text"
    U64 = "u64"
    I64 = "i64"
    F64 = "f64"
    BOOL = "bool"
    DATE = "date"
    FACET = "facet"
    BYTES = "bytes"
    JSON = "json"
    IP_ADDR = "ip_addr"


class IndexRecordOption(str, Enum):
    """Reference `src/schema/index_record_option.rs`."""

    BASIC = "basic"
    WITH_FREQS = "freq"
    WITH_FREQS_AND_POSITIONS = "position"

    def has_freq(self) -> bool:
        return self != IndexRecordOption.BASIC

    def has_positions(self) -> bool:
        return self == IndexRecordOption.WITH_FREQS_AND_POSITIONS


@dataclass(frozen=True)
class TextOptions:
    indexed: bool = False
    tokenizer: str = "default"
    record: IndexRecordOption = IndexRecordOption.BASIC
    fieldnorms: bool = True
    stored: bool = False
    fast: bool = False
    fast_tokenizer: str | None = None

    def __or__(self, other) -> "TextOptions":
        # NumericOptions flags (STORED / FAST / INDEXED) compose with text
        # options like the reference's flag types do
        if isinstance(other, NumericOptions):
            other = TextOptions(
                indexed=self.indexed,  # keep text indexing config
                tokenizer=self.tokenizer,
                record=self.record,
                stored=other.stored,
                fast=other.fast,
            )
        return TextOptions(
            indexed=self.indexed or other.indexed,
            tokenizer=other.tokenizer if other.indexed else self.tokenizer,
            record=other.record if other.indexed else self.record,
            fieldnorms=self.fieldnorms and other.fieldnorms,
            stored=self.stored or other.stored,
            fast=self.fast or other.fast,
            fast_tokenizer=other.fast_tokenizer or self.fast_tokenizer,
        )

    __ror__ = __or__

    def set_stored(self) -> "TextOptions":
        return replace(self, stored=True)

    def set_fast(self, tokenizer: str | None = None) -> "TextOptions":
        return replace(self, fast=True, fast_tokenizer=tokenizer)

    def set_indexing_options(self, tokenizer: str, record: IndexRecordOption) -> "TextOptions":
        return replace(self, indexed=True, tokenizer=tokenizer, record=record)


@dataclass(frozen=True)
class NumericOptions:
    indexed: bool = False
    stored: bool = False
    fast: bool = False
    fieldnorms: bool = False

    def __or__(self, other: "NumericOptions"):
        if isinstance(other, TextOptions):
            return NotImplemented  # TextOptions.__ror__ handles the mix
        return NumericOptions(
            indexed=self.indexed or other.indexed,
            stored=self.stored or other.stored,
            fast=self.fast or other.fast,
            fieldnorms=self.fieldnorms or other.fieldnorms,
        )

    def set_stored(self) -> "NumericOptions":
        return replace(self, stored=True)

    def set_fast(self) -> "NumericOptions":
        return replace(self, fast=True)

    def set_indexed(self) -> "NumericOptions":
        return replace(self, indexed=True)


# Flag constants, composable with `|` like the reference's.
TEXT = TextOptions(indexed=True, tokenizer="default",
                   record=IndexRecordOption.WITH_FREQS_AND_POSITIONS)
STRING = TextOptions(indexed=True, tokenizer="raw", record=IndexRecordOption.BASIC)
STORED_TEXT = TextOptions(stored=True)
INDEXED = NumericOptions(indexed=True)
STORED = NumericOptions(stored=True)
FAST = NumericOptions(fast=True)


@dataclass(frozen=True)
class FieldEntry:
    """Reference `src/schema/field_entry.rs`."""

    name: str
    field_type: FieldType
    field_id: int
    options: Any

    def is_indexed(self) -> bool:
        return bool(getattr(self.options, "indexed", False))

    def is_stored(self) -> bool:
        return bool(getattr(self.options, "stored", False))

    def is_fast(self) -> bool:
        return bool(getattr(self.options, "fast", False))

    def has_fieldnorms(self) -> bool:
        return bool(getattr(self.options, "fieldnorms", False)) and self.is_indexed()

    def index_record_option(self) -> IndexRecordOption:
        if isinstance(self.options, TextOptions):
            return self.options.record
        return IndexRecordOption.BASIC

    def tokenizer_name(self) -> str:
        return getattr(self.options, "tokenizer", "raw")

    def to_json(self) -> dict:
        opts = {
            k: (v.value if isinstance(v, Enum) else v)
            for k, v in self.options.__dict__.items()
        }
        return {
            "name": self.name,
            "type": self.field_type.value,
            "field_id": self.field_id,
            "options": opts,
            "options_kind": type(self.options).__name__,
        }

    @classmethod
    def from_json(cls, d: dict) -> "FieldEntry":
        kind = d.get("options_kind", "NumericOptions")
        opts_d = dict(d["options"])
        if kind == "TextOptions":
            opts_d["record"] = IndexRecordOption(opts_d["record"])
            options = TextOptions(**opts_d)
        else:
            options = NumericOptions(**opts_d)
        return cls(
            name=d["name"],
            field_type=FieldType(d["type"]),
            field_id=d["field_id"],
            options=options,
        )


class Schema:
    """Immutable document schema (reference `src/schema/schema.rs:251`)."""

    def __init__(self, entries: list[FieldEntry]):
        self._entries = list(entries)
        self._by_name = {e.name: e for e in entries}

    def get_field(self, name: str) -> FieldEntry:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"The field does not exist: '{name}'") from None

    def get_field_entry(self, field_id: int) -> FieldEntry:
        return self._entries[field_id]

    def fields(self) -> list[FieldEntry]:
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def num_fields(self) -> int:
        return len(self._entries)

    def to_json(self) -> str:
        return _json.dumps([e.to_json() for e in self._entries])

    @classmethod
    def from_json(cls, payload: str) -> "Schema":
        return cls([FieldEntry.from_json(d) for d in _json.loads(payload)])

    @classmethod
    def builder(cls) -> "SchemaBuilder":
        return SchemaBuilder()


class SchemaBuilder:
    """Reference `src/schema/schema.rs:33`."""

    def __init__(self):
        self._entries: list[FieldEntry] = []

    def _add(self, name: str, ftype: FieldType, options) -> FieldEntry:
        if any(e.name == name for e in self._entries):
            raise ValueError(f"field already exists: {name}")
        entry = FieldEntry(name, ftype, len(self._entries), options)
        self._entries.append(entry)
        return entry

    def add_text_field(self, name: str, options: TextOptions = TEXT) -> FieldEntry:
        return self._add(name, FieldType.TEXT, options)

    def add_u64_field(self, name: str, options: NumericOptions = INDEXED) -> FieldEntry:
        return self._add(name, FieldType.U64, options)

    def add_i64_field(self, name: str, options: NumericOptions = INDEXED) -> FieldEntry:
        return self._add(name, FieldType.I64, options)

    def add_f64_field(self, name: str, options: NumericOptions = INDEXED) -> FieldEntry:
        return self._add(name, FieldType.F64, options)

    def add_bool_field(self, name: str, options: NumericOptions = INDEXED) -> FieldEntry:
        return self._add(name, FieldType.BOOL, options)

    def add_date_field(self, name: str, options: NumericOptions = INDEXED) -> FieldEntry:
        return self._add(name, FieldType.DATE, options)

    def add_bytes_field(self, name: str, options: NumericOptions = INDEXED) -> FieldEntry:
        return self._add(name, FieldType.BYTES, options)

    def add_facet_field(self, name: str, options: NumericOptions = INDEXED) -> FieldEntry:
        return self._add(name, FieldType.FACET, options)

    def add_json_field(self, name: str, options: TextOptions = TEXT) -> FieldEntry:
        return self._add(name, FieldType.JSON, options)

    def add_ip_addr_field(self, name: str, options: NumericOptions = INDEXED) -> FieldEntry:
        return self._add(name, FieldType.IP_ADDR, options)

    def build(self) -> Schema:
        return Schema(self._entries)
