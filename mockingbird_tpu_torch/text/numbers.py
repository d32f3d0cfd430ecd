"""English number → words normalisation.

Parity with `models/synthesizer/utils/numbers.py` (which uses
the `inflect` package); the number-to-words conversion here is self-contained.
"""
from __future__ import annotations

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"([0-9]+)(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
         "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"), (100, "hundred")]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, ones = divmod(n, 10)
        return _TENS[tens] + ("-" + _ONES[ones] if ones else "")
    for value, name in _SCALE:
        if n >= value:
            major, rest = divmod(n, value)
            out = number_to_words(major) + " " + name
            if rest:
                out += " " + number_to_words(rest)
            return out
    return _ONES[0]  # unreachable


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ") if " " in words else ("", "", words)
    if "-" in last:
        th, _, lw = last.rpartition("-")
        last_ord = th + "-" + _ordinalize_word(lw)
    else:
        last_ord = _ordinalize_word(last)
    return (head + " " + last_ord).strip()


def _ordinalize_word(w: str) -> str:
    if w in _ORDINAL_IRREGULAR:
        return _ORDINAL_IRREGULAR[w]
    if w.endswith("y"):
        return w[:-1] + "ieth"
    if w.endswith(("hundred", "thousand", "million", "billion")) or w in _TENS or w in _ONES:
        return w + "th"
    return w + "th"


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        return "%s %s, %s %s" % (number_to_words(dollars), "dollar" if dollars == 1 else "dollars",
                                 number_to_words(cents), "cent" if cents == 1 else "cents")
    if dollars:
        return "%s %s" % (number_to_words(dollars), "dollar" if dollars == 1 else "dollars")
    if cents:
        return "%s %s" % (number_to_words(cents), "cent" if cents == 1 else "cents")
    return "zero dollars"


def _expand_ordinal(m):
    return ordinal_to_words(int(m.group(1)))


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:  # year-style reading, as inflect produces
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        head = number_to_words(num // 100)
        tail = number_to_words(num % 100)
        if num % 100 < 10:
            tail = "oh " + tail
        return (head + " " + tail).replace("-", " ")
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
