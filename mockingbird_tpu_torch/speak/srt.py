"""SRT subtitle parsing, formatting and text→SRT timing estimation.

A copy of ``mockingbird_tpu/speak/srt.py`` (the port imports nothing of the
JAX package).

Parity with the reference's speak skill (`skills/speak/scripts/text_to_srt.py`,
`render_timeline.py:54-88` SRT parsing): splits prose into sentences, assigns
durations from a characters-per-second rate, and round-trips standard SRT.
Pure host-side Python — no device work.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence, Tuple, Union

# Sentence boundary: CJK or latin terminal punctuation, or explicit newline.
_SENTENCE_SPLIT_RE = re.compile(r"(?<=[。！？.!?\n])\s*")
_TIMESTAMP_RE = re.compile(r"^(\d{2,}):(\d{2}):(\d{2})[,.](\d{3})$")


@dataclass
class Cue:
    """One subtitle cue: index, [start_ms, end_ms) window and its text."""
    index: int
    start_ms: int
    end_ms: int
    text: str

    @property
    def duration_ms(self) -> int:
        return max(1, self.end_ms - self.start_ms)


def split_sentences(text: str) -> List[str]:
    return [s.strip() for s in _SENTENCE_SPLIT_RE.split(text.strip()) if s.strip()]


def estimate_timings(sentences: Sequence[str], chars_per_second: float = 4.0,
                     gap_ms: int = 150, start_offset_ms: int = 0,
                     min_duration_ms: int = 500) -> List[Cue]:
    """Assign each sentence a duration ∝ its length at `chars_per_second`.

    Mirrors `text_to_srt.py:estimate_timings` semantics: a floor of
    `min_duration_ms` per cue and a fixed `gap_ms` of silence between cues.
    """
    if chars_per_second <= 0:
        raise ValueError("chars_per_second must be positive")
    cues: List[Cue] = []
    cursor = start_offset_ms
    for i, sentence in enumerate(sentences, start=1):
        duration = max(min_duration_ms, int(len(sentence) / chars_per_second * 1000))
        cues.append(Cue(index=i, start_ms=cursor, end_ms=cursor + duration,
                        text=sentence))
        cursor += duration + gap_ms
    return cues


def text_to_cues(text: str, **kwargs) -> List[Cue]:
    return estimate_timings(split_sentences(text), **kwargs)


# ── timestamps ────────────────────────────────────────────────────────

def parse_timestamp_ms(value: str) -> int:
    m = _TIMESTAMP_RE.match(value.strip())
    if not m:
        raise ValueError(f"Invalid SRT timestamp: {value!r}")
    hh, mm, ss, ms = (int(g) for g in m.groups())
    return ((hh * 60 + mm) * 60 + ss) * 1000 + ms


def ms_to_timestamp(ms: int) -> str:
    if ms < 0:
        raise ValueError("negative timestamp")
    total_sec, millis = divmod(int(ms), 1000)
    total_min, sec = divmod(total_sec, 60)
    hour, minute = divmod(total_min, 60)
    return f"{hour:02d}:{minute:02d}:{sec:02d},{millis:03d}"


# ── SRT serialization ────────────────────────────────────────────────

def format_srt(cues: Sequence[Cue]) -> str:
    blocks = []
    for cue in cues:
        blocks.append(f"{cue.index}\n"
                      f"{ms_to_timestamp(cue.start_ms)} --> {ms_to_timestamp(cue.end_ms)}\n"
                      f"{cue.text}")
    return "\n\n".join(blocks) + "\n"


def parse_srt_text(content: str) -> List[Cue]:
    """Tolerant SRT parser (same skip rules as the reference renderer):
    blocks need an integer index line, a `-->` timing line, and text."""
    cues: List[Cue] = []
    for block in re.split(r"\n\s*\n", content.strip()):
        lines = [ln.rstrip("\r") for ln in block.splitlines() if ln.strip()]
        if len(lines) < 3:
            continue
        try:
            idx = int(lines[0])
        except ValueError:
            continue
        if "-->" not in lines[1]:
            continue
        start_raw, end_raw = (s.strip() for s in lines[1].split("-->", 1))
        text = "\n".join(lines[2:]).strip()
        if not text:
            continue
        cues.append(Cue(index=idx, start_ms=parse_timestamp_ms(start_raw),
                        end_ms=parse_timestamp_ms(end_raw), text=text))
    if not cues:
        raise ValueError("No valid cues parsed from SRT")
    return cues


def parse_srt(path: Union[str, Path]) -> List[Cue]:
    return parse_srt_text(Path(path).read_text(encoding="utf-8", errors="replace"))


def write_srt(cues: Sequence[Cue], path: Union[str, Path]) -> None:
    Path(path).write_text(format_srt(cues), encoding="utf-8")


def text_to_srt(text: str, path: Union[str, Path], **kwargs) -> List[Cue]:
    cues = text_to_cues(text, **kwargs)
    write_srt(cues, path)
    return cues
