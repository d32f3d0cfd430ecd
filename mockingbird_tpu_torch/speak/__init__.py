"""speak — narration tooling: text→SRT and SRT→timeline-accurate audio.

Port of ``mockingbird_tpu/speak/``: host code, copied; the timeline's
``PipelineBackend`` drives the port's ``VoiceCloningPipeline``.

Parity with the reference's `skills/speak/` (text_to_srt.py,
render_timeline.py, noiz_tts.py), rebuilt around this framework: the default
timeline backend is the on-device voice-cloning pipeline; external CLI and
cloud HTTP backends are kept for interop; duration forcing and mixing are
in-process numpy instead of ffmpeg.
"""
from .srt import (Cue, estimate_timings, format_srt, ms_to_timestamp,
                  parse_srt, parse_srt_text, parse_timestamp_ms,
                  split_sentences, text_to_cues, text_to_srt, write_srt)
from .stretch import normalize_duration, pad_or_trim, wsola_stretch
from .timeline import (CommandBackend, HttpBackend, PipelineBackend,
                       RenderedSegment, TimelineResult, load_voice_map,
                       mix_segments, parse_segment_key, render_timeline,
                       render_timeline_file, resolve_segment_cfg)
from .api_client import (TtsApiClient, decode_wav_bytes, encode_multipart,
                         encode_wav_bytes, normalize_api_key_base64)

__all__ = [
    "Cue", "estimate_timings", "format_srt", "ms_to_timestamp", "parse_srt",
    "parse_srt_text", "parse_timestamp_ms", "split_sentences", "text_to_cues",
    "text_to_srt", "write_srt",
    "normalize_duration", "pad_or_trim", "wsola_stretch",
    "CommandBackend", "HttpBackend", "PipelineBackend", "RenderedSegment",
    "TimelineResult", "load_voice_map", "mix_segments", "parse_segment_key",
    "render_timeline", "render_timeline_file", "resolve_segment_cfg",
    "TtsApiClient", "decode_wav_bytes", "encode_multipart", "encode_wav_bytes",
    "normalize_api_key_base64",
]
