"""Pure-Python English Snowball stemmer (Porter2).

The paper optionally integrates "a C-based implementation of the Snowball
stemmer" (PyStemmer). That C dependency is unavailable offline, so this is a
faithful pure-Python implementation of the Snowball *english* algorithm
(Porter2, https://snowballstem.org/algorithms/english/stemmer.html).

Stemming is applied to the *vocabulary*, not to every token occurrence
(exactly the trick the paper describes): the tokenizer stems each unique word
once and looks occurrences up through the vocab dict, so stemmer speed is
never on the hot path.
"""

from __future__ import annotations

from functools import lru_cache

_VOWELS = frozenset("aeiouy")
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_ENDING = frozenset("cdeghkmnrt")

_EXCEPTIONS1 = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl",
    # invariants
    "sky": "sky", "news": "news", "howe": "howe", "atlas": "atlas",
    "cosmos": "cosmos", "bias": "bias", "andes": "andes",
}

_EXCEPTIONS2 = frozenset(
    {"inning", "outing", "canning", "herring", "earring", "proceed",
     "exceed", "succeed"}
)

_STEP2_SUFFIXES = (
    ("ization", "ize"), ("ational", "ate"), ("ousness", "ous"),
    ("iveness", "ive"), ("fulness", "ful"), ("biliti", "ble"),
    ("tional", "tion"), ("lessli", "less"), ("entli", "ent"),
    ("ation", "ate"), ("alism", "al"), ("aliti", "al"),
    ("fulli", "ful"), ("ousli", "ous"), ("iviti", "ive"),
    ("enci", "ence"), ("anci", "ance"), ("abli", "able"),
    ("izer", "ize"), ("ator", "ate"), ("alli", "al"),
    ("bli", "ble"),
)

_STEP3_SUFFIXES = (
    ("ational", "ate"), ("tional", "tion"), ("alize", "al"),
    ("icate", "ic"), ("iciti", "ic"), ("ical", "ic"),
    ("ful", ""), ("ness", ""),
)

_STEP4_SUFFIXES = (
    "ement", "ance", "ence", "able", "ible", "ment",
    "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize",
    "al", "er", "ic",
)


def _is_vowel(word: str, i: int) -> bool:
    return word[i] in _VOWELS


def _regions(word: str) -> tuple[int, int]:
    """Compute R1 and R2 start offsets per the Snowball definition."""
    n = len(word)
    # special prefixes
    r1 = n
    for prefix in ("gener", "commun", "arsen"):
        if word.startswith(prefix):
            r1 = len(prefix)
            break
    else:
        for i in range(1, n):
            if not _is_vowel(word, i) and _is_vowel(word, i - 1):
                r1 = i + 1
                break
    r2 = n
    for i in range(r1 + 1, n):
        if not _is_vowel(word, i) and _is_vowel(word, i - 1):
            r2 = i + 1
            break
    return r1, r2


def _ends_short_syllable(word: str) -> bool:
    n = len(word)
    if n == 2:
        return _is_vowel(word, 0) and not _is_vowel(word, 1)
    if n >= 3:
        c1, v, c2 = word[-3], word[-2], word[-1]
        return (
            c1 not in _VOWELS
            and v in _VOWELS
            and c2 not in _VOWELS
            and c2 not in "wxY"
        )
    return False


def _is_short(word: str, r1: int) -> bool:
    return r1 >= len(word) and _ends_short_syllable(word)


def _preprocess(word: str) -> str:
    if word.startswith("'"):
        word = word[1:]
    if word.startswith("y"):
        word = "Y" + word[1:]
    chars = list(word)
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS:
            chars[i] = "Y"
    return "".join(chars)


def _step0(word: str) -> str:
    for suf in ("'s'", "'s", "'"):
        if word.endswith(suf):
            return word[: -len(suf)]
    return word


def _step1a(word: str) -> str:
    if word.endswith("sses"):
        return word[:-2]
    if word.endswith("ied") or word.endswith("ies"):
        return word[:-2] if len(word) > 4 else word[:-1]
    if word.endswith("us") or word.endswith("ss"):
        return word
    if word.endswith("s"):
        # delete if the preceding word part contains a vowel not
        # immediately before the s
        if any(ch in _VOWELS for ch in word[:-2].lower()):
            return word[:-1]
    return word


def _step1b(word: str, r1: int) -> str:
    for suf in ("eedly", "eed"):
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                return word[: -len(suf)] + "ee"
            return word
    for suf in ("ingly", "edly", "ing", "ed"):
        if word.endswith(suf):
            stem = word[: -len(suf)]
            if any(ch in _VOWELS for ch in stem.lower()):
                if stem.endswith(("at", "bl", "iz")):
                    return stem + "e"
                if stem.endswith(_DOUBLES):
                    return stem[:-1]
                if _is_short(stem, _regions(stem)[0]):
                    return stem + "e"
                return stem
            return word
    return word


def _step1c(word: str) -> str:
    if (
        len(word) > 2
        and word[-1] in "yY"
        and word[-2] not in _VOWELS
    ):
        return word[:-1] + "i"
    return word


def _step2(word: str, r1: int) -> str:
    for suf, repl in _STEP2_SUFFIXES:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                if suf == "bli":  # ogi / li special handling below
                    return word[:-3] + "ble"
                return word[: -len(suf)] + repl
            return word
    if word.endswith("ogi") and len(word) - 3 >= r1 and len(word) >= 4 and word[-4] == "l":
        return word[:-1]
    if word.endswith("li") and len(word) - 2 >= r1 and len(word) >= 3 and word[-3] in _LI_ENDING:
        return word[:-2]
    return word


def _step3(word: str, r1: int, r2: int) -> str:
    for suf, repl in _STEP3_SUFFIXES:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                return word[: -len(suf)] + repl
            return word
    if word.endswith("ative") and len(word) - 5 >= r2:
        return word[:-5]
    return word


def _step4(word: str, r2: int) -> str:
    if word.endswith("ion"):
        if len(word) - 3 >= r2 and len(word) >= 4 and word[-4] in "st":
            return word[:-3]
        return word
    for suf in _STEP4_SUFFIXES:
        if word.endswith(suf):
            if len(word) - len(suf) >= r2:
                return word[: -len(suf)]
            return word
    return word


def _step5(word: str, r1: int, r2: int) -> str:
    if word.endswith("e"):
        if len(word) - 1 >= r2:
            return word[:-1]
        if len(word) - 1 >= r1 and not _ends_short_syllable(word[:-1]):
            return word[:-1]
        return word
    if word.endswith("l") and len(word) - 1 >= r2 and len(word) >= 2 and word[-2] == "l":
        return word[:-1]
    return word


@lru_cache(maxsize=1 << 18)
def snowball_stem(word: str) -> str:
    """Stem one lowercase English word with the Snowball (Porter2) algorithm."""
    if len(word) <= 2:
        return word
    if word in _EXCEPTIONS1:
        return _EXCEPTIONS1[word]
    word = _preprocess(word)
    word = _step0(word)
    word = _step1a(word)
    if word.lower() in _EXCEPTIONS2:
        return word.lower()
    r1, r2 = _regions(word.lower())
    word = _step1b(word, r1)
    word = _step1c(word)
    r1, r2 = _regions(word.lower())
    word = _step2(word, r1)
    word = _step3(word, r1, r2)
    word = _step4(word, r2)
    word = _step5(word, r1, r2)
    return word.lower()


class SnowballStemmer:
    """Object façade matching PyStemmer's ``Stemmer('english')`` interface."""

    def __init__(self, language: str = "english") -> None:
        if language not in ("english", "en", "porter2", "snowball"):
            raise ValueError(f"only English is bundled, got {language!r}")

    def stemWord(self, word: str) -> str:  # noqa: N802 - PyStemmer API
        return snowball_stem(word)

    def stemWords(self, words: list[str]) -> list[str]:  # noqa: N802
        return [snowball_stem(w) for w in words]
