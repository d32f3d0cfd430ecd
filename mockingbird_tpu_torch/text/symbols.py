"""Symbol inventory for text input.

Parity with `models/synthesizer/utils/symbols.py:9-18`: pad,
EOS, ASCII letters, digits and punctuation. Mandarin text reaches the model as
tone-numbered pinyin romanisation (e.g. "ni3 hao3"), which this alphabet
covers.
"""

PAD = "_"
EOS = "~"
_characters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz1234567890!'(),-.:;? "

symbols = [PAD, EOS] + list(_characters)

SYMBOL_TO_ID = {s: i for i, s in enumerate(symbols)}
ID_TO_SYMBOL = {i: s for i, s in enumerate(symbols)}

PAD_ID = SYMBOL_TO_ID[PAD]
EOS_ID = SYMBOL_TO_ID[EOS]
