"""Timeline-accurate speech rendering from SRT cues.

A copy of ``mockingbird_tpu/speak/timeline.py`` whose ``PipelineBackend``
builds the port's ``VoiceCloningPipeline`` on ``device``.

Parity with the reference's `skills/speak/scripts/render_timeline.py`
(parse SRT → resolve per-segment voice config → TTS each cue → force exact
duration → delay to cue start → mix one track), redesigned for this
framework: the primary backend is the on-device `VoiceCloningPipeline`
(voice cloning from a per-segment reference wav), mixing and duration
forcing are in-process numpy (no ffmpeg), and external command / HTTP
backends are kept for interop.
"""
from __future__ import annotations

import json
import subprocess
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .srt import Cue, parse_srt
from .stretch import normalize_duration

# A backend maps (cue, resolved segment config) → (wav float32, sample_rate).
TtsBackend = Callable[[Cue, Dict[str, Any]], Tuple[np.ndarray, int]]


# ── voice-map resolution (render_timeline.py:93-109) ─────────────────

def parse_segment_key(key: str) -> Tuple[int, int]:
    """'3' → (3,3); '2-5' → (2,5)."""
    key = key.strip()
    if "-" in key:
        lo, hi = key.split("-", 1)
        return int(lo), int(hi)
    v = int(key)
    return v, v


def resolve_segment_cfg(index: int, voice_map: Dict[str, Any]) -> Dict[str, Any]:
    """Merge `default` with every `segments` entry whose range covers index."""
    merged = dict(voice_map.get("default", {}))
    for key, seg_cfg in voice_map.get("segments", {}).items():
        lo, hi = parse_segment_key(key)
        if lo <= index <= hi:
            merged.update(seg_cfg)
    return merged


def load_voice_map(path: Union[str, Path]) -> Dict[str, Any]:
    return json.loads(Path(path).read_text(encoding="utf-8"))


# ── backends ──────────────────────────────────────────────────────────

class PipelineBackend:
    """TTS via the port's own voice-cloning pipeline, on ``device`` (the
    card by default).

    Segment config keys: `reference_audio` (path, required — the voice to
    clone), `style_idx`, `steps`, `min_stop_token`. Replaces the reference's
    cloud voice-clone backend with on-device synthesis.
    """

    def __init__(self, pipeline=None, device="cuda", **pipeline_kwargs):
        if pipeline is None:
            from ..pipeline import VoiceCloningPipeline
            pipeline = VoiceCloningPipeline(verbose=False, device=device, **pipeline_kwargs)
        self.pipeline = pipeline

    def __call__(self, cue: Cue, cfg: Dict[str, Any]) -> Tuple[np.ndarray, int]:
        ref = cfg.get("reference_audio")
        if not ref:
            raise ValueError(f"Cue {cue.index}: voice map needs 'reference_audio'")
        kwargs = {}
        for k in ("style_idx", "steps", "min_stop_token"):
            if k in cfg and cfg[k] is not None:
                kwargs[k] = cfg[k]
        wav = self.pipeline.clone_voice(cue.text, ref, **kwargs)[0]
        sr = self.pipeline.audio_cfg.sample_rate
        return np.asarray(wav, dtype=np.float32), sr


class CommandBackend:
    """TTS via an external CLI: `<cmd> <text-file> <out.wav> [extra args]`.

    Parity with the reference's local-CLI backend (`render_timeline.py:
    _kokoro_tts`): text goes through a temp file; `voice`/`lang`/`speed`
    segment keys map to `--voice/--lang/--speed` flags.
    """

    def __init__(self, command: str, runner: Callable = subprocess.run):
        self.command = command
        self._run = runner

    def __call__(self, cue: Cue, cfg: Dict[str, Any]) -> Tuple[np.ndarray, int]:
        from ..dsp.audio import load_wav
        with tempfile.TemporaryDirectory() as td:
            txt = Path(td) / "cue.txt"
            out = Path(td) / "cue.wav"
            txt.write_text(cue.text, encoding="utf-8")
            cmd = [self.command, str(txt), str(out)]
            for key, flag in (("voice", "--voice"), ("lang", "--lang"),
                              ("speed", "--speed")):
                if cfg.get(key) is not None:
                    cmd += [flag, str(cfg[key])]
            proc = self._run(cmd, capture_output=True, text=True)
            if getattr(proc, "returncode", 1) != 0:
                raise RuntimeError(
                    f"{self.command} failed for cue {cue.index}: "
                    f"{getattr(proc, 'stderr', '')}")
            if not out.exists():
                raise RuntimeError(f"{self.command} produced no output for cue "
                                   f"{cue.index}")
            wav, sr = load_wav(out)
            return wav, sr


class HttpBackend:
    """TTS via a cloud text-to-speech HTTP API (reference's Noiz-style
    backend). Thin wrapper over `speak.api_client.TtsApiClient`."""

    def __init__(self, client):
        self.client = client

    def __call__(self, cue: Cue, cfg: Dict[str, Any]) -> Tuple[np.ndarray, int]:
        return self.client.synthesize_cue(cue, cfg)


# ── rendering ─────────────────────────────────────────────────────────

@dataclass
class RenderedSegment:
    cue: Cue
    raw_len: int          # samples before duration forcing
    final_len: int        # samples after duration forcing


@dataclass
class TimelineResult:
    wav: np.ndarray
    sample_rate: int
    segments: List[RenderedSegment] = field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return len(self.wav) / self.sample_rate


def mix_segments(segments: Sequence[Tuple[int, np.ndarray]], total_len: int,
                 peak: float = 0.95) -> np.ndarray:
    """Sum segments at their start offsets; rescale only if the mix clips
    (the reference's amix normalizes by overlap count — rescale-on-clip
    preserves level better for mostly non-overlapping speech)."""
    out = np.zeros(total_len, dtype=np.float32)
    for start, seg in segments:
        if start >= total_len:
            continue
        end = min(total_len, start + len(seg))
        out[start:end] += seg[:end - start]
    m = float(np.max(np.abs(out))) if len(out) else 0.0
    if m > peak:
        out *= peak / m
    return out


def render_timeline(cues: Sequence[Cue], backend: TtsBackend,
                    voice_map: Optional[Dict[str, Any]] = None,
                    sample_rate: Optional[int] = None,
                    duration_mode: str = "stretch",
                    tail_ms: int = 200,
                    on_progress: Optional[Callable[[int, int], None]] = None,
                    ) -> TimelineResult:
    """Synthesize every cue, force it to the cue's duration, and mix at the
    cue start offsets into one timeline-accurate track."""
    voice_map = voice_map or {}
    placed: List[Tuple[int, np.ndarray]] = []
    segments: List[RenderedSegment] = []
    sr = sample_rate

    for i, cue in enumerate(cues):
        cfg = resolve_segment_cfg(cue.index, voice_map)
        wav, seg_sr = backend(cue, cfg)
        wav = np.asarray(wav, dtype=np.float32)
        if sr is None:
            sr = seg_sr
        elif seg_sr != sr:
            from ..dsp.audio import resample
            wav = resample(wav, seg_sr, sr)
        target = int(round(cue.duration_ms * sr / 1000))
        mode = cfg.get("duration_mode", duration_mode)
        forced = normalize_duration(wav, target, sr, mode=mode)
        placed.append((int(round(cue.start_ms * sr / 1000)), forced))
        segments.append(RenderedSegment(cue=cue, raw_len=len(wav),
                                        final_len=len(forced)))
        if on_progress:
            on_progress(i + 1, len(cues))

    if sr is None:
        raise ValueError("no cues rendered")
    total_ms = max(c.end_ms for c in cues) + tail_ms
    wav = mix_segments(placed, int(round(total_ms * sr / 1000)))
    return TimelineResult(wav=wav, sample_rate=sr, segments=segments)


def render_timeline_file(srt_path: Union[str, Path], out_path: Union[str, Path],
                         backend: TtsBackend,
                         voice_map_path: Optional[Union[str, Path]] = None,
                         **kwargs) -> TimelineResult:
    from ..dsp.audio import save_wav
    cues = parse_srt(srt_path)
    if voice_map_path:
        kwargs.setdefault("voice_map", load_voice_map(voice_map_path))
    result = render_timeline(cues, backend, **kwargs)
    save_wav(result.wav, out_path, result.sample_rate)
    return result
