"""Cloud TTS HTTP client (reference `skills/speak/scripts/noiz_tts.py` parity).

A copy of ``mockingbird_tpu/speak/api_client.py`` (the port imports nothing
of the JAX package).

Generic client for a Noiz-style text-to-speech API: multipart/form-data
`/text-to-speech` with optional voice-clone reference audio, optional
`/emotion-enhance` text pre-pass, duration forcing, and base64 API-key
normalization. stdlib urllib only; the HTTP transport is injectable so it is
testable without network egress (this environment has none).
"""
from __future__ import annotations

import base64
import binascii
import io
import json
import uuid
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np

# Transport signature: (url, headers, body_bytes, timeout) -> (status, headers, body)
Transport = Callable[[str, Dict[str, str], Optional[bytes], int],
                     Tuple[int, Dict[str, str], bytes]]


def normalize_api_key_base64(api_key: str) -> str:
    """Return the key as canonical base64: already-base64 keys pass through,
    raw keys get encoded (same contract as `noiz_tts.py:19-31`)."""
    key = api_key.strip()
    if not key:
        return key
    padded = key + ("=" * (-len(key) % 4))
    try:
        decoded = base64.b64decode(padded, validate=True)
        canonical = base64.b64encode(decoded).decode("ascii").rstrip("=")
        if decoded and canonical == key.rstrip("="):
            return key
    except binascii.Error:
        pass
    return base64.b64encode(key.encode("utf-8")).decode("ascii")


def _urllib_transport(url: str, headers: Dict[str, str],
                      body: Optional[bytes], timeout: int):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:  # still carries a body
        return e.code, dict(e.headers), e.read()


def encode_multipart(fields: Dict[str, str],
                     files: Optional[Dict[str, Tuple[str, bytes]]] = None,
                     ) -> Tuple[bytes, str]:
    """RFC 2388 multipart/form-data. files: name → (filename, payload)."""
    boundary = f"----mockingbird-{uuid.uuid4().hex}"
    buf = io.BytesIO()
    for name, value in fields.items():
        buf.write(f"--{boundary}\r\n".encode())
        buf.write(f'Content-Disposition: form-data; name="{name}"\r\n\r\n'.encode())
        buf.write(str(value).encode("utf-8"))
        buf.write(b"\r\n")
    for name, (filename, payload) in (files or {}).items():
        buf.write(f"--{boundary}\r\n".encode())
        buf.write(('Content-Disposition: form-data; '
                   f'name="{name}"; filename="{filename}"\r\n').encode())
        buf.write(b"Content-Type: application/octet-stream\r\n\r\n")
        buf.write(payload)
        buf.write(b"\r\n")
    buf.write(f"--{boundary}--\r\n".encode())
    return buf.getvalue(), f"multipart/form-data; boundary={boundary}"


class TtsApiClient:
    """Client for a remote TTS service with voice cloning + emotion control."""

    def __init__(self, base_url: str, api_key: str = "",
                 transport: Transport = _urllib_transport, timeout: int = 120):
        self.base_url = base_url.rstrip("/")
        self.api_key = normalize_api_key_base64(api_key)
        self.transport = transport
        self.timeout = timeout

    # ── endpoints ─────────────────────────────────────────────────────
    def emotion_enhance(self, text: str) -> str:
        """Server-side emotion markup pass (`noiz_tts.py:34-49`)."""
        status, _, body = self.transport(
            f"{self.base_url}/emotion-enhance",
            {"Authorization": self.api_key, "Content-Type": "application/json"},
            json.dumps({"text": text}).encode("utf-8"), self.timeout)
        if status != 200:
            raise RuntimeError(f"/emotion-enhance failed: status={status}, "
                               f"body={body[:500]!r}")
        enhanced = json.loads(body).get("data", {}).get("emotion_enhance")
        if not enhanced:
            raise RuntimeError(f"/emotion-enhance returned no data: {body[:500]!r}")
        return enhanced

    def synthesize(self, text: str, *, voice_id: Optional[str] = None,
                   reference_audio: Optional[Union[str, Path, bytes]] = None,
                   output_format: str = "wav", speed: float = 1.0,
                   emo: Optional[Union[str, dict]] = None,
                   target_lang: Optional[str] = None,
                   similarity_enh: bool = False, save_voice: bool = False,
                   duration: Optional[float] = None) -> Tuple[bytes, float]:
        """POST /text-to-speech → (audio bytes, reported duration seconds or -1).

        Mirrors `noiz_tts.py:synthesize`: duration must lie in (0, 36]; either
        `voice_id` or `reference_audio` is required.
        """
        if duration is not None and not (0 < duration <= 36):
            raise ValueError("duration must be in range (0, 36] seconds")
        if not voice_id and reference_audio is None:
            raise ValueError("either voice_id or reference_audio is required")

        fields: Dict[str, str] = {"text": text, "output_format": output_format,
                                  "speed": str(speed)}
        if voice_id:
            fields["voice_id"] = voice_id
        if emo:
            fields["emo"] = emo if isinstance(emo, str) else json.dumps(emo)
        if target_lang:
            fields["target_lang"] = target_lang
        if similarity_enh:
            fields["similarity_enh"] = "true"
        if save_voice:
            fields["save_voice"] = "true"
        if duration is not None:
            fields["duration"] = f"{duration:.3f}"

        files = None
        if reference_audio is not None:
            if isinstance(reference_audio, (str, Path)):
                p = Path(reference_audio)
                if not p.exists():
                    raise FileNotFoundError(f"Reference audio not found: {p}")
                files = {"file": (p.name, p.read_bytes())}
            else:
                files = {"file": ("reference.wav", bytes(reference_audio))}

        body, content_type = encode_multipart(fields, files)
        status, headers, resp = self.transport(
            f"{self.base_url}/text-to-speech",
            {"Authorization": self.api_key, "Content-Type": content_type},
            body, self.timeout)
        if status != 200:
            raise RuntimeError(f"/text-to-speech failed: status={status}, "
                               f"body={resp[:500]!r}")
        dur = headers.get("X-Audio-Duration") or headers.get("x-audio-duration")
        return resp, (float(dur) if dur else -1.0)

    # ── timeline-backend adapter ──────────────────────────────────────
    def synthesize_cue(self, cue, cfg: Dict[str, Any]) -> Tuple[np.ndarray, int]:
        """`HttpBackend` hook: segment config keys follow the reference's
        voice-map schema (voice_id/reference_audio/speed/emo/target_lang/
        similarity_enh/save_voice, optional emotion_enhance)."""
        text = cue.text
        if cfg.get("emotion_enhance"):
            text = self.emotion_enhance(text)
        audio, _ = self.synthesize(
            text,
            voice_id=cfg.get("voice_id"),
            reference_audio=cfg.get("reference_audio"),
            speed=float(cfg.get("speed", 1.0)),
            emo=cfg.get("emo"),
            target_lang=cfg.get("target_lang"),
            similarity_enh=bool(cfg.get("similarity_enh", False)),
            save_voice=bool(cfg.get("save_voice", False)),
            duration=min(36.0, cue.duration_ms / 1000.0))
        return decode_wav_bytes(audio)


def decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode an in-memory RIFF/WAVE payload to (float32 mono wav, sr)."""
    import wave
    with wave.open(io.BytesIO(data), "rb") as wf:
        sr = wf.getframerate()
        n = wf.getnframes()
        width = wf.getsampwidth()
        channels = wf.getnchannels()
        raw = wf.readframes(n)
    if width == 2:
        wav = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        wav = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        wav = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width: {width}")
    if channels > 1:
        wav = wav.reshape(-1, channels).mean(axis=1)
    return wav, sr


def encode_wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    """Inverse of `decode_wav_bytes` (16-bit PCM) — used by tests/fakes."""
    import wave
    pcm = (np.clip(np.asarray(wav, dtype=np.float32), -1.0, 1.0)
           * 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(pcm.tobytes())
    return buf.getvalue()
