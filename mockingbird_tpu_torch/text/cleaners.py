"""Text cleaners (parity: `models/synthesizer/utils/cleaners.py`).

``transliteration_cleaners``' unidecode dependency is replaced by a
stdlib-based NFKD accent-stripping transliteration (covers Latin-script
languages; CJK goes through the pinyin frontend instead).
"""
from __future__ import annotations

import re
import unicodedata

from .numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

_abbreviations = [(re.compile(r"\b%s\." % abbr, re.IGNORECASE), full) for abbr, full in [
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
    ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
    ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
    ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
    ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
]]


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def convert_to_ascii(text: str) -> str:
    """Accent-stripping ASCII transliteration (unidecode replacement)."""
    nfkd = unicodedata.normalize("NFKD", text)
    return nfkd.encode("ascii", "ignore").decode("ascii")


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse; no transliteration (default for
    pinyin input, `hparams.py:30` tts_cleaner_names)."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    return collapse_whitespace(text)


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
}
