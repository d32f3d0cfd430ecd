"""HTTP serving layer (stdlib-only).

Port of ``mockingbird_tpu/serve/http.py``: the same endpoints, the same
request coalescer and the same locking, over the port's toolbox and
pipeline on ``device``. Replaces both reference control surfaces:
- the Streamlit mkgui (`control/mkgui/base/ui/streamlit_ui.py:847-861` —
  5 modes: synthesize, VC, preprocess, train, train-VC) as a JSON/wav API;
- the PyQt5 Toolbox (`control/toolbox/__init__.py:50-477`) as a browser
  console (`serve/console.py`) over the same API, with session state in
  `serve/toolbox.py`.

Endpoints:
  GET  /                 → HTML toolbox console
  GET  /api/health       → {"status": "ok"}
  GET  /api/datasets     → dataset browser (?dataset=&speaker= | ?random=1)
  GET  /api/audio?path=  → stream an utterance wav from datasets_root
  GET  /api/models       → checkpoint listing per family
  POST /api/embed        → multipart {ref, name} → embed + session projection
  POST /api/synthesize_mel → JSON {text, utterance, seed, style_idx} → mel
  POST /api/vocode       → JSON {vocoder} → audio/wav of current spec
  POST /api/synthesize   → multipart {text, ref} → audio/wav  (one-shot)
  POST /api/stream_tts   → multipart {text, ref} → streaming audio/wav
                           (sentence chunks; PCM flushed as each synthesizes)
  POST /api/convert      → multipart {ref, src[, vocoder]} → audio/wav
  POST /api/preprocess   → {"datasets_root", "dataset"} → job started
  POST /api/train        → {"kind", "syn_dir", "run_id", ...} → job started
  GET  /api/jobs         → background job states
"""
from __future__ import annotations

import io
import json
import threading
import time
import traceback
import urllib.parse
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from .. import resolve_device
from .console import INDEX_HTML
from .toolbox import WebToolbox, read_audio


class _TtsBatcher:
    """Coalesces concurrent /api/synthesize requests into ONE device batch:
    requests arriving within `window_s` of each other ride a single
    `tts_batch` dispatch with per-request speaker embeds, so 4-way
    concurrency costs about one batch dispatch, not 4 serialized syntheses.
    `dispatches` counts the `tts_batch` calls the worker made; `close()`
    ends the worker after the batch it is gathering and lets go of the
    pipeline.

    Only the stateless default flow coalesces (default vocoder/style/seed);
    anything touching session state stays on the locked path."""

    def __init__(self, pipeline, window_s: float = 0.015, max_batch: int = 16):
        import queue
        self.pipe = pipeline
        self.window_s = window_s
        self.max_batch = max_batch
        self.queue: "queue.Queue" = queue.Queue()
        self._embed_cache: dict = {}
        self.dispatches = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def embed_for(self, ref_bytes: bytes, wav: np.ndarray) -> np.ndarray:
        import hashlib
        key = hashlib.sha1(ref_bytes).hexdigest()
        if key not in self._embed_cache:
            if len(self._embed_cache) > 32:
                self._embed_cache.clear()
            self._embed_cache[key] = self.pipe.embed_reference(wav)
        return self._embed_cache[key]

    def submit(self, text: str, embed: np.ndarray, timeout: float = 600.0):
        """Blocks until the coalesced batch containing this request ran."""
        if self.pipe is None:
            raise RuntimeError("the tts batcher is closed")
        item = dict(text=text, embed=embed, event=threading.Event(),
                    result=None, error=None)
        self.queue.put(item)
        if not item["event"].wait(timeout):
            raise TimeoutError("tts batch timed out")
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker once the requests queued before this call have
        run, then drop the pipeline (so a stopped server frees the card)."""
        self.queue.put(None)
        self._thread.join(timeout)
        self.pipe = None

    def _worker(self):
        import queue
        import time as _time
        stop = False
        while not stop:
            first = self.queue.get()
            if first is None:
                return
            batch = [first]
            deadline = _time.time() + self.window_s
            while len(batch) < self.max_batch:
                left = deadline - _time.time()
                if left <= 0:
                    break
                try:
                    item = self.queue.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                batch.append(item)
            try:
                self.dispatches += 1
                embeds = np.stack([b["embed"] for b in batch])
                wavs = self.pipe.tts_batch([b["text"] for b in batch],
                                           None, embed=embeds)
                for b, w in zip(batch, wavs):
                    b["result"] = w
            except Exception as e:  # pragma: no cover - surfaced per request
                for b in batch:
                    b["error"] = e
            finally:
                for b in batch:
                    b["event"].set()


class _Jobs:
    def __init__(self):
        self.lock = threading.Lock()
        self.jobs = {}

    def start(self, name, fn, *a, **kw):
        with self.lock:
            self.jobs[name] = {"state": "running"}

        def run():
            try:
                fn(*a, **kw)
                self.jobs[name] = {"state": "done"}
            except Exception as e:  # pragma: no cover
                self.jobs[name] = {"state": "error", "error": str(e)}
        threading.Thread(target=run, daemon=True).start()

    def snapshot(self):
        with self.lock:
            return dict(self.jobs)


def _wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        peak = max(0.01, float(np.max(np.abs(wav))))
        w.writeframes((np.asarray(wav) * (32767 / peak)).astype(np.int16).tobytes())
    return buf.getvalue()


def _parse_multipart(handler) -> dict:
    import email
    from email import policy
    length = int(handler.headers.get("Content-Length", 0))
    body = handler.rfile.read(length)
    ctype = handler.headers.get("Content-Type", "")
    msg = email.message_from_bytes(
        b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body, policy=policy.default)
    fields = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        payload = part.get_payload(decode=True)
        if part.get_filename():
            fields[name] = payload
        else:
            fields[name] = payload.decode("utf-8", "replace")
    return fields


def make_handler(toolbox: WebToolbox, jobs: _Jobs, batcher_state: Optional[dict] = None):
    tb = toolbox
    if batcher_state is None:
        batcher_state = {}
    batcher_state.update(batcher=None, lock=threading.Lock())

    def get_batcher():
        """Coalescing batcher for the stateless one-shot flow; None when the
        pipeline lacks the fused on-device path (a WaveRNN vocoder or a VITS
        synthesizer: the session-locked flow handles the request)."""
        pipe = tb.pipeline
        if not (getattr(pipe, "synthesizer_kind", None) == "tacotron"
                and hasattr(getattr(pipe, "vocoder", None), "vocode_device")):
            return None
        with batcher_state["lock"]:
            if batcher_state["batcher"] is None:
                batcher_state["batcher"] = _TtsBatcher(pipe)
            return batcher_state["batcher"]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, code, body, ctype="application/json", headers=None):
            data = body if isinstance(body, bytes) else json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _json_body(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def _stream_tts(self, text: str, ref_wav: np.ndarray,
                        break_seconds: float = 0.15) -> None:
            """Chunked low-latency TTS: sentence chunks synthesize through the
            fused on-device path and their int16 PCM streams out as each
            finishes — first audio after one chunk, not the whole text. The
            WAV header uses the 0xFFFFFFFF streaming convention; connection
            close delimits the body (no Content-Length)."""
            import struct
            from ..text.long_text import normalize_text, split_text

            pipe = tb.pipeline
            embed = pipe.embed_reference(ref_wav)
            chunks = split_text(normalize_text(text)) or [text]
            sr = tb.sample_rate

            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("X-Sample-Rate", str(sr))
            self.send_header("X-Chunks", str(len(chunks)))
            self.end_headers()
            hdr = (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
                   + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
                   + b"data" + struct.pack("<I", 0xFFFFFFFF))
            self.wfile.write(hdr)
            self.wfile.flush()
            silence = np.zeros(int(sr * break_seconds), np.int16).tobytes()
            for i, chunk in enumerate(chunks):
                # embed short-circuits the fused path; ref_wav covers the
                # staged fallback (e.g. a VITS pipeline)
                # int16 on the device→host wire by default: a sentence
                # chunk is 1-2 s of audio (~32-64 KB), so the mu-law byte
                # halving saves ~nothing here while costing ~38 dB SNR.
                # Callers that ship large batches opt into "mulaw8" via
                # pipeline.tts_batch(pcm_format=...) where the transfer
                # actually dominates (see bench.py).
                pcm = pipe.tts_batch([chunk], ref_wav, embed=embed)[0]
                if pcm.dtype != np.int16:  # non-fused fallback (e.g. VITS)
                    pcm = np.round(np.clip(pcm, -1, 1) * 32767).astype(np.int16)
                self.wfile.write(pcm.tobytes())
                if i < len(chunks) - 1:
                    self.wfile.write(silence)
                self.wfile.flush()

        def do_GET(self):
            try:
                url = urllib.parse.urlparse(self.path)
                q = dict(urllib.parse.parse_qsl(url.query))
                if url.path == "/":
                    self._send(200, INDEX_HTML.encode(), "text/html")
                elif url.path == "/api/health":
                    self._send(200, {"status": "ok"})
                elif url.path == "/api/jobs":
                    self._send(200, jobs.snapshot())
                elif url.path == "/api/datasets":
                    if q.get("random"):
                        self._send(200, tb.random_utterance())
                    else:
                        self._send(200, tb.browse(q.get("dataset"), q.get("speaker")))
                elif url.path == "/api/audio":
                    p = tb.audio_path(q["path"])
                    if p.suffix.lower() == ".wav":
                        self._send(200, p.read_bytes(), "audio/wav")
                    else:
                        wav = read_audio(p, tb.sample_rate)
                        self._send(200, _wav_bytes(wav, tb.sample_rate), "audio/wav")
                elif url.path == "/api/models":
                    self._send(200, tb.list_models())
                else:
                    self._send(404, {"error": "not found"})
            except FileNotFoundError as e:
                self._send(404, {"error": str(e)})
            except Exception as e:
                traceback.print_exc()
                self._send(500, {"error": str(e)})

        def do_POST(self):
            try:
                if self.path == "/api/embed":
                    fields = _parse_multipart(self)
                    if "ref" in fields:
                        wav = read_audio(fields["ref"], tb.sample_rate)
                    elif "path" in fields:
                        wav = read_audio(tb.audio_path(fields["path"]), tb.sample_rate)
                    else:
                        return self._send(400, {"error": "need ref wav or path"})
                    name = fields.get("name") or "utt"
                    with tb.session_lock:
                        res = tb.embed_utterance(name, wav)
                    self._send(200, res)
                elif self.path == "/api/synthesize_mel":
                    req = self._json_body()
                    with tb.session_lock:
                        res = tb.synthesize(
                            req.get("text", ""), req.get("utterance"),
                            seed=req.get("seed"), style_idx=int(req.get("style_idx", 0)),
                            steps=int(req.get("steps", 1000)),
                            min_stop_token=int(req.get("min_stop_token", 5)))
                    self._send(200, res)
                elif self.path == "/api/vocode":
                    req = self._json_body()
                    with tb.session_lock:
                        res = tb.vocode(req.get("vocoder", "hifigan"))
                        body = _wav_bytes(tb.current_wav, tb.sample_rate)
                    self._send(200, body, "audio/wav", {"X-RTF": f"{res['rtf']:.1f}"})
                elif self.path == "/api/synthesize":
                    fields = _parse_multipart(self)
                    text = fields.get("text", "")
                    ref = fields.get("ref")
                    if not text or ref is None:
                        return self._send(400, {"error": "need text + ref wav"})
                    wav = read_audio(ref, tb.sample_rate)
                    # default one-shot requests (no seed/style/vocoder
                    # override) are STATELESS and ride the coalescing
                    # batcher: concurrent requests share one fused device
                    # dispatch instead of serialising on the session lock
                    default_flow = (not fields.get("seed")
                                    and int(fields.get("style_idx", 0)) == 0
                                    and fields.get("vocoder", "hifigan") == "hifigan")
                    batcher = get_batcher() if default_flow else None
                    if batcher is not None:
                        t0 = time.time()
                        pcm = batcher.submit(text, batcher.embed_for(ref, wav))
                        dt = time.time() - t0
                        out = (pcm.astype(np.float32) / 32767.0
                               if pcm.dtype == np.int16 else pcm)
                        body = _wav_bytes(out, tb.sample_rate)
                        rtf = len(out) / tb.sample_rate / max(dt, 1e-9)
                        return self._send(200, body, "audio/wav",
                                          {"X-RTF": f"{rtf:.1f}",
                                           "X-Coalesced": "1"})
                    # the embed→synthesize→vocode flow mutates session state
                    # (named embed, current_spec/current_wav): concurrent
                    # requests must not interleave their stages
                    with tb.session_lock:
                        tb.embed_utterance("api_ref", wav)
                        tb.synthesize(text, "api_ref",
                                      seed=int(fields["seed"]) if fields.get("seed") else None,
                                      style_idx=int(fields.get("style_idx", 0)))
                        res = tb.vocode(fields.get("vocoder", "hifigan"))
                        body = _wav_bytes(tb.current_wav, tb.sample_rate)
                    self._send(200, body, "audio/wav", {"X-RTF": f"{res['rtf']:.1f}"})
                elif self.path == "/api/stream_tts":
                    fields = _parse_multipart(self)
                    text = fields.get("text", "")
                    ref = fields.get("ref")
                    if not text or ref is None:
                        return self._send(400, {"error": "need text + ref wav"})
                    wav_ref = read_audio(ref, tb.sample_rate)
                    self._stream_tts(text, wav_ref)
                elif self.path == "/api/convert":
                    fields = _parse_multipart(self)
                    ref = read_audio(fields["ref"], tb.sample_rate)
                    src = read_audio(fields["src"], tb.sample_rate)
                    with tb.session_lock:
                        res = tb.convert(ref, src, fields.get("vocoder", "hifigan"))
                        body = _wav_bytes(tb.current_wav, tb.sample_rate)
                    self._send(200, body, "audio/wav", {"X-RTF": f"{res['rtf']:.2f}"})
                elif self.path == "/api/preprocess":
                    req = self._json_body()
                    from ..models.tacotron.preprocess import preprocess_dataset
                    root = Path(req["datasets_root"])
                    jobs.start("preprocess", preprocess_dataset, root,
                               root / "SV2TTS" / "synthesizer",
                               dataset=req.get("dataset", "aidatatang_200zh"),
                               device=tb.device)
                    self._send(200, {"job": "preprocess", "state": "running"})
                elif self.path == "/api/train":
                    req = self._json_body()
                    kind = req.get("kind", "synth")
                    if kind == "synth":
                        from ..models.tacotron.train import train as fn
                    elif kind == "vits":
                        from ..models.vits.train import train as fn
                    elif kind == "vc":
                        from ..models.ppg.train import train as fn
                    else:
                        return self._send(400, {"error": f"unknown kind {kind}"})
                    jobs.start(f"train-{kind}", fn, req.get("run_id", "serve_run"),
                               Path(req["syn_dir"]), Path(req.get("models_dir", "saved_models")),
                               total_steps=req.get("total_steps"), device=tb.device)
                    self._send(200, {"job": f"train-{kind}", "state": "running"})
                else:
                    self._send(404, {"error": "not found"})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:
                traceback.print_exc()
                self._send(500, {"error": str(e)})

    return Handler


class _Server(ThreadingHTTPServer):
    """Closing the server also closes its request coalescer."""

    def server_close(self):
        super().server_close()
        batcher = getattr(self, "batcher", {}).get("batcher")
        if batcher is not None:
            batcher.close()


def serve(port: int = 8080, encoder_fpath=None, synthesizer_fpath=None,
          vocoder_fpath=None, datasets_root=None, models_dir=None,
          seed=None, block: bool = True, toolbox: WebToolbox = None,
          device: Union[str, torch.device] = "cuda"):
    """Start the server on ``port`` (0: any free port). Without a
    ``toolbox``, one is built whose pipeline and voice converter load the
    given exports on ``device`` (the card unless the caller asks for the
    CPU; raises without one, before binding the port); a given ``toolbox``
    runs on its own device, and ``device`` is not read. ``block=False``
    serves from a daemon thread and returns the server, whose ``batcher``
    dict holds the request coalescer once the first default
    ``/api/synthesize`` request has made it; call ``shutdown()`` and
    ``server_close()`` to stop both."""
    from ..pipeline import VoiceCloningPipeline
    jobs = _Jobs()
    if toolbox is None:
        dev = resolve_device(device)
        toolbox = WebToolbox(
            datasets_root=datasets_root, models_dir=models_dir, seed=seed, device=dev,
            pipeline_factory=lambda: VoiceCloningPipeline(
                encoder_fpath, synthesizer_fpath, vocoder_fpath, verbose=False, device=dev))
    batcher_state: dict = {}
    handler = make_handler(toolbox, jobs, batcher_state)
    server = _Server(("0.0.0.0", port), handler)
    server.batcher = batcher_state
    print(f"Serving on http://0.0.0.0:{server.server_address[1]}")
    if block:
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
