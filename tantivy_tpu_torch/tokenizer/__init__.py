"""Text analysis — parity with reference `tokenizer-api/` + `src/tokenizer/`.

A `TextAnalyzer` is a tokenizer followed by a chain of token filters
(`src/tokenizer/tokenizer.rs:9`). The default registry matches
`src/tokenizer/tokenizer_manager.rs:58-75`:

* ``raw``        : whole input as one token (len-capped at 255... we keep all)
* ``default``    : SimpleTokenizer | RemoveLongFilter(40) | LowerCaser
* ``en_stem``    : default | Stemmer(English)
* ``whitespace`` : split on whitespace

Offsets are Python ``str`` character offsets (the reference uses UTF-8 byte
offsets; snippets and tests in this package consistently use char offsets).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

from .stemmer import porter2_stem


@dataclass
class Token:
    """Reference `tokenizer-api/src/lib.rs:15-29`."""

    text: str
    offset_from: int = 0
    offset_to: int = 0
    position: int = 0
    position_length: int = 1


@dataclass
class PreTokenizedString:
    """Caller-supplied tokenization for one text value (reference
    `tokenizer-api/src/tokenized_string.rs`): indexed as the given tokens
    verbatim (no analyzer runs), stored/displayed as `text`."""

    text: str
    tokens: list[Token] = field(default_factory=list)


class Tokenizer:
    def token_stream(self, text: str) -> Iterator[Token]:
        raise NotImplementedError


class SimpleTokenizer(Tokenizer):
    """Split on non-alphanumeric characters (reference
    `src/tokenizer/simple_tokenizer.rs`, `char::is_alphanumeric` boundaries)."""

    def token_stream(self, text: str) -> Iterator[Token]:
        position = 0
        start = None
        for i, ch in enumerate(text):
            if ch.isalnum():
                if start is None:
                    start = i
            else:
                if start is not None:
                    yield Token(text[start:i], start, i, position)
                    position += 1
                    start = None
        if start is not None:
            yield Token(text[start:], start, len(text), position)


class WhitespaceTokenizer(Tokenizer):
    def token_stream(self, text: str) -> Iterator[Token]:
        position = 0
        start = None
        for i, ch in enumerate(text):
            if not ch.isspace():
                if start is None:
                    start = i
            else:
                if start is not None:
                    yield Token(text[start:i], start, i, position)
                    position += 1
                    start = None
        if start is not None:
            yield Token(text[start:], start, len(text), position)


class RawTokenizer(Tokenizer):
    """The entire input as a single token (reference `raw_tokenizer.rs`)."""

    def token_stream(self, text: str) -> Iterator[Token]:
        yield Token(text, 0, len(text), 0)


class NgramTokenizer(Tokenizer):
    """Character n-grams (reference `src/tokenizer/ngram_tokenizer.rs`)."""

    def __init__(self, min_gram: int, max_gram: int, prefix_only: bool = False):
        if min_gram <= 0 or min_gram > max_gram:
            raise ValueError("invalid ngram bounds")
        self.min_gram, self.max_gram, self.prefix_only = min_gram, max_gram, prefix_only

    def token_stream(self, text: str) -> Iterator[Token]:
        n = len(text)
        starts = [0] if self.prefix_only else range(n)
        for start in starts:
            for size in range(self.min_gram, self.max_gram + 1):
                if start + size > n:
                    break
                yield Token(text[start : start + size], start, start + size, 0)


class RegexTokenizer(Tokenizer):
    """Tokens = regex matches (reference `src/tokenizer/regex_tokenizer.rs`)."""

    def __init__(self, pattern: str):
        import re

        self._re = re.compile(pattern)

    def token_stream(self, text: str) -> Iterator[Token]:
        for position, m in enumerate(self._re.finditer(text)):
            yield Token(m.group(0), m.start(), m.end(), position)


class FacetTokenizer(Tokenizer):
    """Emits one token per facet path prefix: `/a/b` -> `a`, `a\\x00b`
    (reference `src/tokenizer/facet_tokenizer.rs`)."""

    def token_stream(self, text: str) -> Iterator[Token]:
        parts = [p for p in text.split("/") if p != ""]
        acc: list[str] = []
        for part in parts:
            acc.append(part)
            yield Token("\x00".join(acc), 0, len(text), 0)


# ---------------------------------------------------------------------------
# Token filters


class TokenFilter:
    def transform(self, tokens: Iterable[Token]) -> Iterator[Token]:
        raise NotImplementedError


class LowerCaser(TokenFilter):
    def transform(self, tokens: Iterable[Token]) -> Iterator[Token]:
        for tok in tokens:
            tok.text = tok.text.lower()
            yield tok


class RemoveLongFilter(TokenFilter):
    """Removes tokens whose UTF-8 byte length is >= limit (reference
    `src/tokenizer/remove_long.rs`, `token.text.len() < limit`)."""

    def __init__(self, limit: int):
        self.limit = limit

    def transform(self, tokens: Iterable[Token]) -> Iterator[Token]:
        for tok in tokens:
            if len(tok.text.encode("utf-8")) < self.limit:
                yield tok


class Stemmer(TokenFilter):
    """English Porter2 stemmer (reference `src/tokenizer/stemmer.rs` uses
    rust-stemmers' Snowball English, which is Porter2)."""

    def __init__(self, language: str = "english"):
        if language not in ("english", "en"):
            raise ValueError(f"unsupported stemmer language: {language}")

    def transform(self, tokens: Iterable[Token]) -> Iterator[Token]:
        for tok in tokens:
            tok.text = porter2_stem(tok.text)
            yield tok


class StopWordFilter(TokenFilter):
    def __init__(self, words: Iterable[str]):
        self._words = frozenset(words)

    def transform(self, tokens: Iterable[Token]) -> Iterator[Token]:
        for tok in tokens:
            if tok.text not in self._words:
                yield tok


class AlphaNumOnlyFilter(TokenFilter):
    def transform(self, tokens: Iterable[Token]) -> Iterator[Token]:
        for tok in tokens:
            if all(c.isalnum() for c in tok.text):
                yield tok


#: Latin-script characters the reference's folding table maps but Unicode
#: NFD decomposition does not (no combining-mark decomposition exists):
#: ligatures, stroked/hooked letters, and their casings
#: (reference `ascii_folding_filter.rs` — its giant match statement reduces
#: to NFD + combining-mark strip for the decomposable majority; this table
#: supplies the rest for the Latin-1/Extended-A/B ranges).
_FOLD_SUPPLEMENT = {
    "ß": "ss", "ẞ": "SS", "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE",
    "ø": "o", "Ø": "O", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "TH", "ħ": "h", "Ħ": "H", "ı": "i", "ĸ": "q",
    "ł": "l", "Ł": "L", "ŋ": "n", "Ŋ": "N", "ŧ": "t", "Ŧ": "T",
    "ﬀ": "ff", "ﬁ": "fi", "ﬂ": "fl", "ﬃ": "ffi", "ﬄ": "ffl",
    "ﬅ": "st", "ﬆ": "st", "ƒ": "f", "Ƒ": "F", "ǳ": "dz", "ǆ": "dz",
    "Ǳ": "DZ", "Ǆ": "DZ", "ǲ": "Dz", "ǅ": "Dz", "ĳ": "ij", "Ĳ": "IJ",
}


class AsciiFoldingFilter(TokenFilter):
    """Fold accented/decorated Latin characters to their ASCII bases
    (reference `ascii_folding_filter.rs`): NFD-decompose and drop combining
    marks, plus the supplement table for non-decomposable letters. Tokens
    already pure-ASCII pass through untouched (the hot-path check the
    reference does with `is_ascii`)."""

    def transform(self, tokens: Iterable[Token]) -> Iterator[Token]:
        import unicodedata

        for tok in tokens:
            if tok.text.isascii():
                yield tok
                continue
            out = []
            for ch in tok.text:
                if ord(ch) < 128:
                    out.append(ch)
                    continue
                sup = _FOLD_SUPPLEMENT.get(ch)
                if sup is not None:
                    out.append(sup)
                    continue
                for d in unicodedata.normalize("NFD", ch):
                    if ord(d) < 128:
                        out.append(d)
                    elif not unicodedata.combining(d):
                        out.append(_FOLD_SUPPLEMENT.get(d, d))
            yield Token(
                "".join(out), tok.offset_from, tok.offset_to, tok.position
            )


class SplitCompoundWords(TokenFilter):
    """Minimal counterpart of reference `split_compound_words.rs`."""

    def __init__(self, dictionary: Iterable[str]):
        self._dict = sorted(set(dictionary), key=len, reverse=True)

    def transform(self, tokens: Iterable[Token]) -> Iterator[Token]:
        for tok in tokens:
            parts = self._split(tok.text)
            if parts is None:
                yield tok
            else:
                for p in parts:
                    yield Token(p, tok.offset_from, tok.offset_to, tok.position)

    def _split(self, text: str) -> list[str] | None:
        parts, rest = [], text
        while rest:
            for w in self._dict:
                if rest.startswith(w):
                    parts.append(w)
                    rest = rest[len(w) :]
                    break
            else:
                return None
        return parts if len(parts) > 1 else None


# ---------------------------------------------------------------------------
# Pipeline + registry


class TextAnalyzer:
    """tokenizer | filter | filter ... (reference `src/tokenizer/tokenizer.rs`)."""

    def __init__(self, tokenizer: Tokenizer, filters: list[TokenFilter] | None = None):
        self.tokenizer = tokenizer
        self.filters = list(filters or [])

    def filter(self, token_filter: TokenFilter) -> "TextAnalyzer":
        return TextAnalyzer(self.tokenizer, self.filters + [token_filter])

    def token_stream(self, text: str) -> Iterator[Token]:
        stream: Iterable[Token] = self.tokenizer.token_stream(text)
        for f in self.filters:
            stream = f.transform(stream)
        return iter(stream)

    @classmethod
    def builder(cls, tokenizer: Tokenizer) -> "TextAnalyzer":
        return cls(tokenizer)


class TokenizerManager:
    """Named-analyzer registry (reference `tokenizer_manager.rs:21`)."""

    def __init__(self):
        self._tokenizers: dict[str, TextAnalyzer] = {}

    @classmethod
    def default(cls) -> "TokenizerManager":
        m = cls()
        m.register("raw", TextAnalyzer(RawTokenizer()))
        m.register(
            "default",
            TextAnalyzer(SimpleTokenizer(), [RemoveLongFilter(40), LowerCaser()]),
        )
        m.register(
            "en_stem",
            TextAnalyzer(
                SimpleTokenizer(), [RemoveLongFilter(40), LowerCaser(), Stemmer()]
            ),
        )
        m.register("whitespace", TextAnalyzer(WhitespaceTokenizer()))
        m.register("facet", TextAnalyzer(FacetTokenizer()))
        return m

    def register(self, name: str, analyzer: TextAnalyzer | Tokenizer) -> None:
        if isinstance(analyzer, Tokenizer):
            analyzer = TextAnalyzer(analyzer)
        self._tokenizers[name] = analyzer

    def get(self, name: str) -> TextAnalyzer | None:
        return self._tokenizers.get(name)
