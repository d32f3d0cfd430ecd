"""Mandarin hanzi → tone-numbered pinyin romanisation.

The reference calls `pypinyin.lazy_pinyin(text, style=Style.TONE3)` at
inference and preprocessing time (`models/synthesizer/inference.py:100`,
`preprocess_audio.py:16-19`). pypinyin is optional here: when installed it is
used directly; otherwise an embedded table of the most frequent characters
(plus a polyphone word dictionary, `pinyin_data.py`) romanises hanzi with
greedy longest-match segmentation. Non-CJK text always passes through
unchanged, and tone-numbered pinyin input is first-class either way.
"""
from __future__ import annotations

import re
from typing import List

try:
    from pypinyin import Style, lazy_pinyin  # type: ignore
    HAVE_PYPINYIN = True
except ImportError:
    HAVE_PYPINYIN = False

_CJK_RE = re.compile(r"[㐀-䶿一-鿿豈-﫿]")


def contains_chinese(text: str) -> bool:
    return _CJK_RE.search(text) is not None


def _fallback_pinyin(text: str) -> List[str]:
    """Embedded-table romanisation: greedy longest-match over WORD_PINYIN,
    then per-character CHAR_PINYIN; non-CJK runs pass through as single
    tokens (lazy_pinyin(errors='ignore') drops unknowns — so do we)."""
    from .pinyin_data import CHAR_PINYIN, WORD_PINYIN

    max_word = max((len(w) for w in WORD_PINYIN), default=1)
    out: List[str] = []
    buf: List[str] = []  # pending non-CJK run
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if not _CJK_RE.match(ch):
            buf.append(ch)
            i += 1
            continue
        if buf:
            tok = "".join(buf).strip()
            if tok:
                out.append(tok)
            buf = []
        matched = False
        for L in range(min(max_word, n - i), 1, -1):
            word = text[i : i + L]
            if word in WORD_PINYIN:
                out.extend(WORD_PINYIN[word].split())
                i += L
                matched = True
                break
        if not matched:
            py = CHAR_PINYIN.get(ch)
            if py is not None:
                out.append(py)
            # unknown hanzi: dropped (errors='ignore' semantics)
            i += 1
    if buf:
        tok = "".join(buf).strip()
        if tok:
            out.append(tok)
    return out


def chinese_to_pinyin(text: str, errors: str = "ignore") -> List[str]:
    """Tone-3-style romanisation: "你好" → ["ni3", "hao3"].

    Non-CJK tokens pass through unchanged, matching lazy_pinyin(errors=...).
    """
    if HAVE_PYPINYIN:
        return lazy_pinyin(text, style=Style.TONE3, errors=errors)
    if contains_chinese(text):
        return _fallback_pinyin(text)
    return [text]


def romanize(text: str) -> str:
    """Full-string romanisation used by the synthesizer frontend."""
    return " ".join(chinese_to_pinyin(text))
