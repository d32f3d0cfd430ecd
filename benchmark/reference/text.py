"""Plain text frontend: hanzi text → symbol ids, as SV2TTS's synthesizer
reads it.

Hanzi are romanised to tone-numbered pinyin (greedy longest match over the
word table, then the character table; unknown hanzi dropped; runs of other
characters kept as one token), the tokens joined by spaces, lowercased, runs
of whitespace collapsed, each character mapped to its id in the symbol
inventory (pad, EOS, ASCII letters, digits, punctuation; anything else
dropped), and EOS appended.
"""
from __future__ import annotations

import re
from typing import List

from .pinyin_data import CHAR_PINYIN, WORD_PINYIN

PAD, EOS = "_", "~"
SYMBOLS = [PAD, EOS] + list(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz1234567890!'(),-.:;? ")
SYMBOL_ID = {s: i for i, s in enumerate(SYMBOLS)}
EOS_ID = SYMBOL_ID[EOS]

_CJK = re.compile(r"[㐀-䶿一-鿿豈-﫿]")
_MAX_WORD = max(len(w) for w in WORD_PINYIN)


def pinyin_tokens(text: str) -> List[str]:
    if not _CJK.search(text):
        return [text]
    out: List[str] = []
    other: List[str] = []
    i = 0
    while i < len(text):
        ch = text[i]
        if not _CJK.match(ch):
            other.append(ch)
            i += 1
            continue
        if "".join(other).strip():
            out.append("".join(other).strip())
        other = []
        for n in range(min(_MAX_WORD, len(text) - i), 1, -1):
            if text[i:i + n] in WORD_PINYIN:
                out.extend(WORD_PINYIN[text[i:i + n]].split())
                i += n
                break
        else:
            if ch in CHAR_PINYIN:
                out.append(CHAR_PINYIN[ch])
            i += 1
    if "".join(other).strip():
        out.append("".join(other).strip())
    return out


def symbol_ids(text: str) -> List[int]:
    """text → symbol ids ending in EOS."""
    cleaned = re.sub(r"\s+", " ", " ".join(pinyin_tokens(text)).lower())
    return [SYMBOL_ID[c] for c in cleaned if c in SYMBOL_ID and c not in (PAD, EOS)] + [EOS_ID]
