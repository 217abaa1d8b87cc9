"""Query language parser — parity with reference `query-grammar/` +
`src/query/query_parser/query_parser.rs:204`.

Grammar (the reference's Lucene-style surface):
  query     := clause+
  clause    := [+|-] boosted | NOT boosted | boosted (AND|OR boosted)*
  boosted   := primary ['^' float]
  primary   := '(' query ')' | '*' | leaf
  leaf      := [field ':'] (phrase | range | set | term)
  phrase    := '"' text '"' ['~' int | '*']
  range     := ('['|'{') bound TO bound (']'|'}')
  set       := IN '[' term* ']'
  term      := word ['*']

Semantics parity with reference `query_parser.rs`:
* bare terms hit every default field (a multi-field OR),
* text is tokenized with the field's analyzer; multiple tokens from one
  quoted string form a PhraseQuery; a single token is a TermQuery,
* default occur is Should; `set_conjunction_by_default()` flips to Must,
* `-x` = MustNot, `+x` = Must, `NOT x` = MustNot,
* numeric/bool/date fields parse their literals (dates: ISO-8601 or epoch),
* trailing `*` = prefix (PhrasePrefixQuery / prefix expansion),
* `field:[a TO b]` / `{a TO b}` ranges with `*` as open bound,
* `field: IN [a b c]` term sets, `*` = AllQuery,
* unknown fields / parse failures raise QueryParserError, or are skipped in
  `parse_query_lenient` (errors returned alongside).
"""

from __future__ import annotations

import datetime as _dt
import re
from dataclasses import dataclass, field as dc_field

from ..schema import FieldType, IndexRecordOption, Schema
from ..schema.term import Term
from . import (
    AllQuery,
    BooleanQuery,
    BoostQuery,
    EmptyQuery,
    FuzzyTermQuery,
    Occur,
    PhrasePrefixQuery,
    PhraseQuery,
    Query,
    RangeQuery,
    TermQuery,
    TermSetQuery,
)


class QueryParserError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
    (?P<lparen>\() | (?P<rparen>\)) |
    (?P<quoted>(?:[+\-]?[\w.\-]+:)?"[^"]*"(~\d+|\*)?(\^\d+(?:\.\d+)?)?) |
    (?P<range>(?:[+\-]?[\w.\-]+:)?[\[{][^\]}]*\sTO\s[^\]}]*[\]}]) |
    (?P<setlit>(?:[+\-]?[\w.\-]+:\s*)?IN\s*\[[^\]]*\]) |
    (?P<word>[^\s()]+)
    """,
    re.VERBOSE,
)


@dataclass
class _Tok:
    kind: str
    text: str


def _tokenize_query(q: str) -> list[_Tok]:
    out = []
    for m in _TOKEN_RE.finditer(q):
        kind = m.lastgroup
        out.append(_Tok(kind, m.group(0)))
    return out


def _parse_date(text: str) -> int:
    """ISO-8601 (or epoch-seconds integer) -> epoch seconds."""
    try:
        return int(text)
    except ValueError:
        pass
    t = text.replace("Z", "+00:00")
    dt = _dt.datetime.fromisoformat(t)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int(dt.timestamp())


class QueryParser:
    def __init__(self, schema: Schema, default_fields: list[str], tokenizers):
        self.schema = schema
        self.default_fields = list(default_fields)
        self.tokenizers = tokenizers
        self.conjunction_by_default = False
        self._boosts: dict[str, float] = {}
        self._fuzzy: dict[str, tuple[bool, int, bool]] = {}

    @classmethod
    def for_index(cls, index, default_fields: list[str]) -> "QueryParser":
        return cls(index.schema, default_fields, index.tokenizers)

    def set_conjunction_by_default(self) -> None:
        self.conjunction_by_default = True

    def set_field_boost(self, field: str, boost: float) -> None:
        self._boosts[field] = boost

    def set_field_fuzzy(self, field: str, prefix: bool, distance: int,
                        transpose_cost_one: bool) -> None:
        self._fuzzy[field] = (prefix, distance, transpose_cost_one)

    # ------------------------------------------------------------------

    def parse_query(self, query_str: str) -> Query:
        query, errors = self._parse(query_str)
        if errors:
            raise QueryParserError("; ".join(str(e) for e in errors))
        return query

    def parse_query_lenient(self, query_str: str) -> tuple[Query, list[str]]:
        return self._parse(query_str, lenient=True)

    def _parse(self, query_str: str, lenient: bool = False):
        self._errors: list[str] = []
        self._lenient = lenient
        toks = _tokenize_query(query_str)
        self._toks = toks
        self._pos = 0
        clauses = self._parse_clauses(stop_at_rparen=False)
        errors = self._errors
        if not clauses:
            return EmptyQuery(), errors
        if len(clauses) == 1 and clauses[0][0] is None:
            return clauses[0][1], errors
        return self._combine(clauses), errors

    # -- token helpers -------------------------------------------------

    def _peek(self) -> _Tok | None:
        return self._toks[self._pos] if self._pos < len(self._toks) else None

    def _next(self) -> _Tok | None:
        t = self._peek()
        if t is not None:
            self._pos += 1
        return t

    def _err(self, msg: str):
        if self._lenient:
            self._errors.append(msg)
            return None
        raise QueryParserError(msg)

    # -- grammar -------------------------------------------------------

    def _combine(self, clauses: list[tuple[Occur | None, Query]]) -> Query:
        default = Occur.MUST if self.conjunction_by_default else Occur.SHOULD
        final = [(occ if occ is not None else default, q) for occ, q in clauses]
        return BooleanQuery(final)

    def _parse_clauses(self, stop_at_rparen: bool):
        clauses: list[tuple[Occur | None, Query]] = []
        while True:
            t = self._peek()
            if t is None:
                break
            if t.kind == "rparen":
                if stop_at_rparen:
                    break
                self._next()
                self._err("unmatched ')'")
                continue
            if t.kind == "word" and t.text in ("AND", "OR"):
                # binary operator gluing previous and next clause
                self._next()
                op = t.text
                nxt = self._parse_occur_clause()
                if nxt is None:
                    self._err(f"dangling {op}")
                    break
                if not clauses:
                    self._err(f"{op} without left operand")
                    clauses.append(nxt)
                    continue
                occ = Occur.MUST if op == "AND" else Occur.SHOULD
                prev_occ, prev_q = clauses[-1]
                if prev_occ is None:
                    clauses[-1] = (occ, prev_q)
                clauses.append((occ, nxt[1]))
                continue
            c = self._parse_occur_clause()
            if c is None:
                break
            clauses.append(c)
        return clauses

    def _parse_occur_clause(self):
        t = self._peek()
        if t is None:
            return None
        occur: Occur | None = None
        if t.kind == "word" and t.text == "NOT":
            self._next()
            occur = Occur.MUST_NOT
            t = self._peek()
            if t is None:
                self._err("dangling NOT")
                return None
        elif t.kind in ("word", "quoted", "range", "setlit") and t.text.startswith(
            "+"
        ) and len(t.text) > 1:
            occur = Occur.MUST
            t = _Tok(t.kind, t.text[1:])
            self._toks[self._pos] = t
        elif t.kind in ("word", "quoted", "range", "setlit") and t.text.startswith(
            "-"
        ) and len(t.text) > 1:
            occur = Occur.MUST_NOT
            t = _Tok(t.kind, t.text[1:])
            self._toks[self._pos] = t
        q = self._parse_boosted()
        if q is None:
            return None
        return (occur, q)

    def _parse_boosted(self) -> Query | None:
        q = self._parse_primary()
        if q is None:
            return None
        return q

    def _parse_primary(self) -> Query | None:
        t = self._next()
        if t is None:
            return None
        if t.kind == "lparen":
            clauses = self._parse_clauses(stop_at_rparen=True)
            closing = self._next()
            if closing is None or closing.kind != "rparen":
                self._err("expected ')'")
            if not clauses:
                return EmptyQuery()
            inner = (
                clauses[0][1]
                if len(clauses) == 1 and clauses[0][0] is None
                else self._combine(clauses)
            )
            return inner
        if t.kind == "word" and t.text == "*":
            return AllQuery()

        # split off "field:" prefix (attached to any literal kind)
        field = None
        text = t.text
        boost = None
        m = re.match(r"^([\w.\-]+):\s*(.*)$", text, re.UNICODE | re.DOTALL)
        if m:
            field = m.group(1)
            rest = m.group(2).lstrip()
            if rest == "":
                nxt = self._peek()
                if nxt is not None and nxt.kind in ("quoted", "range", "setlit"):
                    t = self._next()
                    text = t.text
                else:
                    return self._err(f"expected value after '{field}:'")
            else:
                text = rest
                t = _Tok(t.kind, rest)

        # boost suffix word^2 or "phrase"^2
        bm = re.match(r"^(.*)\^(\d+(?:\.\d+)?)$", text)
        if bm and t.kind in ("word", "quoted"):
            text = bm.group(1)
            boost = float(bm.group(2))
            t = _Tok(t.kind, text)

        q = self._parse_leaf(t, text, field)
        if q is None:
            return None
        if boost is not None:
            q = BoostQuery(q, boost)
        return q

    # -- leaves --------------------------------------------------------

    def _fields_for(self, field: str | None) -> list[str]:
        if field is not None:
            return [field]
        if not self.default_fields:
            self._err("no default field set")
            return []
        return self.default_fields

    def _parse_leaf(self, t: _Tok, text: str, field: str | None) -> Query | None:
        if t.kind == "quoted":
            return self._leaf_phrase(text, field)
        if t.kind == "range":
            return self._leaf_range(text, field)
        if t.kind == "setlit":
            return self._leaf_set(text, field)
        if t.kind == "word":
            if text == "IN":
                nxt = self._peek()
                self._err("IN requires [..] literal")
                return None
            return self._leaf_term(text, field)
        return self._err(f"unexpected token {text!r}")

    def _resolve_field(self, name: str):
        """Returns (entry, json_path or None)."""
        if name in self.schema:
            return self.schema.get_field(name), None
        if "." in name:
            head, rest = name.split(".", 1)
            if head in self.schema:
                entry = self.schema.get_field(head)
                if entry.field_type == FieldType.JSON:
                    return entry, rest
        self._err(f"The field does not exist: '{name}'")
        return None, None

    def _apply_field_boost(self, field: str, q: Query) -> Query:
        b = self._boosts.get(field)
        if b is not None and b != 1.0:
            return BoostQuery(q, b)
        return q

    def _leaf_term(self, text: str, field: str | None) -> Query | None:
        # `field:*` = field-presence (reference `query_grammar.rs:365`
        # UserInputLeaf::Exists)
        if text == "*" and field is not None:
            from .exists_query import ExistsQuery

            return ExistsQuery(field)
        # comparison shorthand `field:>5`, `>=`, `<`, `<=` — half-open
        # ranges (reference `query_grammar.rs:468-475`)
        m = re.match(r"^(>=|<=|>|<)(.+)$", text)
        if m:
            op, val = m.group(1), m.group(2).strip('"')
            subs = []
            for fname in self._fields_for(field):
                entry, _ = self._resolve_field(fname)
                if entry is None:
                    continue
                v = self._range_value(entry, val)
                lo, hi = (v, None) if op in (">", ">=") else (None, v)
                subs.append(RangeQuery(
                    entry.name, lo, hi,
                    include_lower=(op == ">="), include_upper=(op == "<="),
                ))
            if not subs:
                return EmptyQuery() if self._lenient else None
            if len(subs) == 1:
                return subs[0]
            return BooleanQuery([(Occur.SHOULD, q) for q in subs])
        prefix = False
        if text.endswith("*") and len(text) > 1:
            prefix = True
            text = text[:-1]
        subs = []
        for fname in self._fields_for(field):
            q = self._term_for_field(fname, text, prefix)
            if q is not None:
                subs.append(self._apply_field_boost(fname, q))
        if not subs:
            return EmptyQuery() if self._lenient else None
        if len(subs) == 1:
            return subs[0]
        return BooleanQuery([(Occur.SHOULD, q) for q in subs])

    def _term_for_field(self, fname: str, text: str, prefix: bool) -> Query | None:
        entry, json_path = self._resolve_field(fname)
        if entry is None:
            return None
        ftype = entry.field_type
        try:
            if ftype == FieldType.TEXT or ftype == FieldType.JSON:
                # bare term on a JSON field queries the root path
                if ftype == FieldType.JSON and json_path is None:
                    json_path = ""
                return self._text_query(entry, json_path, text, prefix, slop=0)
            if ftype == FieldType.U64:
                return TermQuery(Term.from_field_u64(entry.name, int(text)))
            if ftype == FieldType.I64:
                return TermQuery(Term.from_field_i64(entry.name, int(text)))
            if ftype == FieldType.F64:
                return TermQuery(Term.from_field_f64(entry.name, float(text)))
            if ftype == FieldType.BOOL:
                if text.lower() not in ("true", "false"):
                    raise ValueError(f"invalid bool literal {text!r}")
                return TermQuery(Term.from_field_bool(entry.name, text.lower() == "true"))
            if ftype == FieldType.DATE:
                return TermQuery(Term.from_field_date(entry.name, _parse_date(text)))
            if ftype == FieldType.FACET:
                return TermQuery(Term.from_facet(entry.name, text))
            if ftype == FieldType.BYTES:
                import base64

                return TermQuery(
                    Term.from_field_bytes(entry.name, base64.b64decode(text))
                )
            if ftype == FieldType.IP_ADDR:
                import ipaddress

                ip = ipaddress.ip_address(text)
                as_int = int(
                    ipaddress.IPv6Address(f"::ffff:{ip}") if ip.version == 4 else ip
                )
                return TermQuery(
                    Term.from_field_bytes(entry.name, as_int.to_bytes(16, "big"))
                )
        except (ValueError, TypeError) as e:
            self._err(f"invalid literal for field '{fname}': {e}")
            return None
        self._err(f"field type {ftype} not queryable as term")
        return None

    def _text_query(self, entry, json_path: str | None, text: str, prefix: bool,
                    slop: int) -> Query | None:
        analyzer = self.tokenizers.get(entry.tokenizer_name())
        tokens = [tok for tok in analyzer.token_stream(text)]
        path_prefix = b""
        if json_path is not None:
            from ..indexer.segment_writer import JSON_END_OF_PATH, JSON_PATH_SEP

            path_prefix = (
                json_path.replace(".", "\x01").encode("utf-8") + JSON_END_OF_PATH
            )
            # JSON numeric/bool inference (reference type order i64->f64->bool)
            if not prefix and len(tokens) <= 1:
                from ..schema.term import f64_to_u64, i64_to_u64, u64_to_bytes

                alts = []
                raw = text
                try:
                    alts.append(
                        TermQuery(
                            Term(
                                entry.name,
                                path_prefix[:-1] + JSON_END_OF_PATH + b"i"
                                + u64_to_bytes(i64_to_u64(int(raw))),
                            )
                        )
                    )
                except ValueError:
                    pass
                try:
                    float(raw)
                    alts.append(
                        TermQuery(
                            Term(
                                entry.name,
                                path_prefix[:-1] + JSON_END_OF_PATH + b"f"
                                + u64_to_bytes(f64_to_u64(float(raw))),
                            )
                        )
                    )
                except ValueError:
                    pass
                if raw.lower() in ("true", "false"):
                    alts.append(
                        TermQuery(
                            Term(
                                entry.name,
                                path_prefix[:-1] + JSON_END_OF_PATH + b"o"
                                + u64_to_bytes(1 if raw.lower() == "true" else 0),
                            )
                        )
                    )
                if tokens:
                    alts.append(
                        TermQuery(
                            Term(
                                entry.name,
                                path_prefix[:-1] + JSON_END_OF_PATH + b"s"
                                + tokens[0].text.encode("utf-8"),
                            )
                        )
                    )
                if not alts:
                    return EmptyQuery()
                if len(alts) == 1:
                    return alts[0]
                return BooleanQuery([(Occur.SHOULD, a) for a in alts])
            path_prefix = path_prefix[:-1] + JSON_END_OF_PATH + b"s"

        if not tokens:
            return EmptyQuery()
        term_bytes = [path_prefix + tok.text.encode("utf-8") for tok in tokens]
        if prefix:
            return PhrasePrefixQuery(entry.name, term_bytes)
        if len(term_bytes) == 1:
            fuzzy = self._fuzzy.get(entry.name)
            term = Term(entry.name, term_bytes[0])
            if fuzzy is not None:
                fprefix, distance, transpose = fuzzy
                return FuzzyTermQuery(term, distance, transpose, fprefix)
            return TermQuery(term)
        if entry.index_record_option() != IndexRecordOption.WITH_FREQS_AND_POSITIONS:
            self._err(
                f"field '{entry.name}' lacks positions; phrase queries need "
                "WITH_FREQS_AND_POSITIONS"
            )
            return None
        offsets = [tok.position for tok in tokens]
        return PhraseQuery(entry.name, term_bytes, slop=slop, offsets=offsets)

    def _leaf_phrase(self, text: str, field: str | None) -> Query | None:
        m = re.match(r'^"([^"]*)"(?:~(\d+)|(\*))?$', text)
        if not m:
            return self._err(f"bad phrase literal {text!r}")
        body, slop_s, star = m.group(1), m.group(2), m.group(3)
        slop = int(slop_s) if slop_s else 0
        prefix = star == "*"
        subs = []
        for fname in self._fields_for(field):
            entry, json_path = self._resolve_field(fname)
            if entry is None:
                continue
            if entry.field_type not in (FieldType.TEXT, FieldType.JSON):
                self._err(f"phrase query on non-text field '{fname}'")
                continue
            q = self._text_query(entry, json_path, body, prefix, slop)
            if q is not None:
                subs.append(self._apply_field_boost(fname, q))
        if not subs:
            return EmptyQuery() if self._lenient else None
        if len(subs) == 1:
            return subs[0]
        return BooleanQuery([(Occur.SHOULD, q) for q in subs])

    def _leaf_range(self, text: str, field: str | None) -> Query | None:
        m = re.match(r"^([\[{])\s*(.*?)\s+TO\s+(.*?)\s*([\]}])$", text)
        if not m:
            return self._err(f"bad range literal {text!r}")
        include_lower = m.group(1) == "["
        include_upper = m.group(4) == "]"
        lo_s, hi_s = m.group(2), m.group(3)
        fields = self._fields_for(field)
        subs = []
        for fname in fields:
            entry, _ = self._resolve_field(fname)
            if entry is None:
                continue
            lo = None if lo_s == "*" else self._range_value(entry, lo_s.strip('"'))
            hi = None if hi_s == "*" else self._range_value(entry, hi_s.strip('"'))
            subs.append(
                RangeQuery(entry.name, lo, hi, include_lower, include_upper)
            )
        if not subs:
            return EmptyQuery() if self._lenient else None
        if len(subs) == 1:
            return subs[0]
        return BooleanQuery([(Occur.SHOULD, q) for q in subs])

    def _range_value(self, entry, text: str):
        ftype = entry.field_type
        try:
            if ftype == FieldType.U64 or ftype == FieldType.I64:
                return int(text)
            if ftype == FieldType.F64:
                return float(text)
            if ftype == FieldType.DATE:
                return _parse_date(text)
            if ftype == FieldType.BOOL:
                return text.lower() == "true"
        except ValueError as e:
            self._err(f"invalid range bound {text!r} for '{entry.name}': {e}")
            return None
        return text

    def _leaf_set(self, text: str, field: str | None) -> Query | None:
        m = re.match(r"^IN\s*\[([^\]]*)\]$", text)
        if not m:
            return self._err(f"bad set literal {text!r}")
        elements = [e.strip('"') for e in m.group(1).split() if e]
        terms = []
        for fname in self._fields_for(field):
            entry, _ = self._resolve_field(fname)
            if entry is None:
                continue
            for el in elements:
                q = self._term_for_field(fname, el, prefix=False)
                if isinstance(q, TermQuery):
                    terms.append(q.term)
        if not terms:
            return EmptyQuery()
        return TermSetQuery(terms)
