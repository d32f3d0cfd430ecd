"""The traffic generator: the same seed gives the same texts and voices,
another seed others, and every call pads its texts to the same length."""
import hashlib

import pytest

from benchmark.harness import check, registry, traffic
from benchmark.reference.text import symbol_ids

CELLS = ["tts-hifigan.b128-f800", "tts-wavernn.b16-f800"]


@pytest.mark.parametrize("cell", CELLS)
def test_texts_repeat_for_a_seed_and_differ_across_seeds(cell):
    mix = registry.cell(cell)["traffic"]
    seed = 2 ** 31 + 12345
    a = [traffic.texts(mix, seed, i) for i in range(3)]
    assert a == [traffic.texts(mix, seed, i) for i in range(3)]
    assert a[0] != a[1]
    assert a != [traffic.texts(mix, seed + 1, i) for i in range(3)]
    assert [traffic.voice_of(mix, seed, i) for i in range(20)] == \
        [traffic.voice_of(mix, seed, i) for i in range(20)]


@pytest.mark.parametrize("cell", CELLS)
def test_every_call_pads_to_the_same_length(cell):
    mix = registry.cell(cell)["traffic"]
    for i in range(4):
        texts = traffic.texts(mix, 7, i)
        assert len(texts) == mix["texts_per_call"]
        lengths = [len(symbol_ids(t)) for t in texts]
        assert check.bucket(max(lengths), 32) == mix["pad_to_symbols"]
        hanzi = [sum("一" <= ch <= "鿿" for ch in t) for t in texts]
        assert min(hanzi) >= mix["hanzi"][0] and max(hanzi) <= mix["hanzi"][1]


def test_voices_repeat_for_a_seed_and_differ_across_seeds(tmp_path):
    mix = dict(registry.cell(CELLS[0])["traffic"], voices=2)

    def digest(seed, sub):
        d = tmp_path / sub
        d.mkdir()
        return [hashlib.sha256(p.read_bytes()).hexdigest() for p in traffic.write_voices(mix, seed, d)]

    first = digest(5, "a")
    assert first == digest(5, "b")
    assert first != digest(6, "c")
