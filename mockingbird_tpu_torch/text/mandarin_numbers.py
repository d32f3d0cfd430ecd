"""Mandarin number reading → tone-numbered pinyin.

Replaces the reference's cn2an usage (`gen_voice.py:12,15-27`, which converts
digits to hanzi before pypinyin): here digits go straight to pinyin, so the
path needs no hanzi lookup at all.
"""
from __future__ import annotations

import re

_DIGITS = ["ling2", "yi1", "er4", "san1", "si4", "wu3", "liu4", "qi1", "ba1", "jiu3"]
_UNITS = ["", "shi2", "bai3", "qian1"]
_GROUPS = ["", "wan4", "yi4", "zhao4"]


def _four_digits_to_pinyin(n: int, has_higher: bool) -> list:
    """Read 0..9999 with proper ling2 handling."""
    if n == 0:
        return []
    out = []
    digits = [int(c) for c in str(n)]
    need_ling = has_higher and len(digits) < 4
    for i, d in enumerate(digits):
        unit = _UNITS[len(digits) - 1 - i]
        if d == 0:
            if out and out[-1] != _DIGITS[0] and any(digits[i + 1:]):
                out.append(_DIGITS[0])
            continue
        if need_ling and not out:
            out.append(_DIGITS[0])
        out.append(_DIGITS[d])
        if unit:
            out.append(unit)
    return out


def number_to_pinyin(n: int) -> str:
    """Integer → Mandarin reading in tone-3 pinyin ("105" → "yi1 bai3 ling2 wu3")."""
    if n < 0:
        return "fu4 " + number_to_pinyin(-n)
    if n == 0:
        return _DIGITS[0]
    if n < 20 and n >= 10:  # 10-19 read as shi2 X
        out = ["shi2"]
        if n % 10:
            out.append(_DIGITS[n % 10])
        return " ".join(out)
    groups = []
    while n > 0:
        groups.append(n % 10000)
        n //= 10000
    out = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            continue
        part = _four_digits_to_pinyin(g, has_higher=gi < len(groups) - 1 and bool(out))
        out.extend(part)
        if gi > 0:
            out.append(_GROUPS[gi])
    return " ".join(out)


def digits_to_pinyin(s: str) -> str:
    """Digit-string read digit-by-digit ("2024" → "er4 ling2 er4 si4")."""
    return " ".join(_DIGITS[int(c)] for c in s if c.isdigit())


_number_re = re.compile(r"\d+\.?\d*")


def normalize_numbers_mandarin(text: str) -> str:
    """Replace arabic numbers in mixed text with their pinyin reading."""
    def repl(m):
        s = m.group(0)
        if "." in s:
            a, b = s.split(".", 1)
            return (number_to_pinyin(int(a)) + " dian3 " + digits_to_pinyin(b)).strip()
        if len(s) >= 8:  # long digit strings (phone numbers, ids): digit-wise
            return digits_to_pinyin(s)
        return number_to_pinyin(int(s))
    return _number_re.sub(lambda m: " " + repl(m) + " ", text)
