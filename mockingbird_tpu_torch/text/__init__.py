"""Text frontend: string → symbol-ID sequence.

Parity with `models/synthesizer/utils/text.py:13-90` including
``{ARPABET}`` curly-brace passthrough and EOS termination.

A copy of ``mockingbird_tpu.text``: the port imports nothing of the JAX
package, so it carries the framework-free text frontend itself.
"""
from __future__ import annotations

import re
from typing import List, Sequence

from .cleaners import CLEANERS
from .pinyin import chinese_to_pinyin, contains_chinese, romanize  # noqa: F401
from .symbols import EOS, EOS_ID, ID_TO_SYMBOL, PAD, PAD_ID, SYMBOL_TO_ID, symbols  # noqa: F401

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def text_to_sequence(text: str, cleaner_names: Sequence[str] = ("basic_cleaners",)) -> List[int]:
    sequence: List[int] = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(_clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)
    sequence.append(EOS_ID)
    return sequence


def sequence_to_text(sequence: Sequence[int]) -> str:
    result = ""
    for sid in sequence:
        if sid in ID_TO_SYMBOL:
            s = ID_TO_SYMBOL[sid]
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            result += s
    return result.replace("}{", " ")


def _clean_text(text: str, cleaner_names: Sequence[str]) -> str:
    for name in cleaner_names:
        if name not in CLEANERS:
            raise ValueError(f"Unknown cleaner: {name}")
        text = CLEANERS[name](text)
    return text


def _symbols_to_sequence(syms) -> List[int]:
    return [SYMBOL_TO_ID[s] for s in syms if s in SYMBOL_TO_ID and s not in (PAD, EOS)]


def _arpabet_to_sequence(text: str) -> List[int]:
    return _symbols_to_sequence(["@" + s for s in text.split()])
