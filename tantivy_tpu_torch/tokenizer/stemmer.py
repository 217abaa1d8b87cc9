"""Porter2 (Snowball English) stemmer.

Implements the published Snowball "english" algorithm — the same algorithm the
reference's `rust-stemmers` crate uses for `Language::English`
(`src/tokenizer/stemmer.rs`). Pure Python; only runs at index/query time on the
host, never on device.

R1/R2 are fixed left positions computed once up front (suffix operations never
move them), per the Snowball definition. All suffix lists are matched
longest-first, and only the longest match's condition is tested.
"""

from __future__ import annotations

_VOWELS = frozenset("aeiouy")
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_VALID = frozenset("cdeghkmnrt")

_EXCEPTIONS1 = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie", "tying": "tie",
    "idly": "idl", "gently": "gentl", "ugly": "ugli", "early": "earli",
    "only": "onli", "singly": "singl",
    "sky": "sky", "news": "news", "howe": "howe", "atlas": "atlas",
    "cosmos": "cosmos", "bias": "bias", "andes": "andes",
}

_EXCEPTIONS2 = frozenset(
    ["inning", "outing", "canning", "herring", "earring", "proceed", "exceed", "succeed"]
)


def _is_vowel(word: str, i: int) -> bool:
    return word[i] in _VOWELS  # 'Y' (marked consonant) is uppercase, not in set


def _mark_ys(word: str) -> str:
    chars = list(word)
    if chars and chars[0] == "y":
        chars[0] = "Y"
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS:
            chars[i] = "Y"
    return "".join(chars)


def _r1_start(word: str) -> int:
    for prefix in ("gener", "commun", "arsen"):
        if word.startswith(prefix):
            return len(prefix)
    for i in range(1, len(word)):
        if not _is_vowel(word, i) and _is_vowel(word, i - 1):
            return i + 1
    return len(word)


def _r2_start(word: str, r1: int) -> int:
    for i in range(r1 + 1, len(word)):
        if not _is_vowel(word, i) and _is_vowel(word, i - 1):
            return i + 1
    return len(word)


def _contains_vowel(word: str, start: int, end: int) -> bool:
    return any(_is_vowel(word, i) for i in range(max(start, 0), min(end, len(word))))


def _ends_short_syllable(word: str) -> bool:
    """True if `word` ends in a short syllable (Snowball definition)."""
    n = len(word)
    if n == 2:
        return _is_vowel(word, 0) and not _is_vowel(word, 1)
    if n >= 3:
        return (
            _is_vowel(word, n - 2)
            and not _is_vowel(word, n - 1)
            and word[n - 1] not in "wxY"
            and not _is_vowel(word, n - 3)
        )
    return False


def _is_short_word(word: str, r1: int) -> bool:
    return r1 >= len(word) and _ends_short_syllable(word)


def _longest_suffix(word: str, suffixes) -> str | None:
    """Longest suffix of `word` among `suffixes` (iterable of strings)."""
    best = None
    for suf in suffixes:
        if word.endswith(suf) and (best is None or len(suf) > len(best)):
            best = suf
    return best


_STEP2 = {
    "ational": "ate", "tional": "tion", "enci": "ence", "anci": "ance",
    "abli": "able", "entli": "ent", "izer": "ize", "ization": "ize",
    "ation": "ate", "ator": "ate", "alism": "al", "aliti": "al",
    "alli": "al", "fulness": "ful", "ousli": "ous", "ousness": "ous",
    "iveness": "ive", "iviti": "ive", "biliti": "ble", "bli": "ble",
    "fulli": "ful", "lessli": "less", "ogi": None, "li": None,
}

_STEP3 = {
    "ational": "ate", "tional": "tion", "alize": "al", "icate": "ic",
    "iciti": "ic", "ical": "ic", "ful": "", "ness": "", "ative": None,
}

_STEP4 = (
    "ement", "ance", "ence", "able", "ible", "ment", "ant", "ent", "ism",
    "ate", "iti", "ous", "ive", "ize", "al", "er", "ic", "ion",
)


def porter2_stem(word: str) -> str:
    if len(word) <= 2:
        return word
    word = word.replace("’", "'").replace("‘", "'").replace("‛", "'")
    if word.startswith("'"):
        word = word[1:]
    if word in _EXCEPTIONS1:
        return _EXCEPTIONS1[word]
    if len(word) <= 2:
        return word

    word = _mark_ys(word)
    r1 = _r1_start(word)
    r2 = _r2_start(word, r1)

    # Step 0: strip 's' / 's / '
    suf = _longest_suffix(word, ("'s'", "'s", "'"))
    if suf:
        word = word[: -len(suf)]

    # Step 1a
    if word.endswith("sses"):
        word = word[:-2]
    elif word.endswith(("ied", "ies")):
        word = word[:-3] + ("i" if len(word) - 3 > 1 else "ie")
    elif word.endswith(("us", "ss")):
        pass
    elif word.endswith("s"):
        if _contains_vowel(word, 0, len(word) - 2):
            word = word[:-1]

    if word in _EXCEPTIONS2:
        return word.replace("Y", "y")

    # Step 1b
    suf = _longest_suffix(word, ("eedly", "ingly", "edly", "eed", "ing", "ed"))
    if suf in ("eed", "eedly"):
        if len(word) - len(suf) >= r1:
            word = word[: -len(suf)] + "ee"
    elif suf is not None:
        stem = word[: -len(suf)]
        if _contains_vowel(stem, 0, len(stem)):
            word = stem
            if word.endswith(("at", "bl", "iz")):
                word += "e"
            elif word.endswith(_DOUBLES):
                word = word[:-1]
            elif _is_short_word(word, r1):
                word += "e"

    # Step 1c: y/Y -> i after a non-vowel which is not the first letter
    if len(word) > 2 and word[-1] in "yY" and not _is_vowel(word, len(word) - 2):
        word = word[:-1] + "i"

    # Step 2 (longest match; condition: suffix in R1)
    suf = _longest_suffix(word, _STEP2.keys())
    if suf is not None and len(word) - len(suf) >= r1:
        if suf == "ogi":
            if len(word) >= 4 and word[-4] == "l":
                word = word[:-1]
        elif suf == "li":
            if len(word) >= 3 and word[-3] in _LI_VALID:
                word = word[:-2]
        else:
            word = word[: -len(suf)] + _STEP2[suf]

    # Step 3 (longest match; condition: suffix in R1, `ative` additionally R2)
    suf = _longest_suffix(word, _STEP3.keys())
    if suf is not None and len(word) - len(suf) >= r1:
        if suf == "ative":
            if len(word) - 5 >= r2:
                word = word[:-5]
        else:
            word = word[: -len(suf)] + _STEP3[suf]

    # Step 4 (longest match; condition: suffix in R2)
    suf = _longest_suffix(word, _STEP4)
    if suf is not None and len(word) - len(suf) >= r2:
        if suf == "ion":
            if len(word) >= 4 and word[-4] in "st":
                word = word[:-3]
        else:
            word = word[: -len(suf)]

    # Step 5
    if word.endswith("e"):
        if len(word) - 1 >= r2 or (
            len(word) - 1 >= r1 and not _ends_short_syllable(word[:-1])
        ):
            word = word[:-1]
    elif word.endswith("ll") and len(word) - 1 >= r2:
        word = word[:-1]

    return word.replace("Y", "y")
