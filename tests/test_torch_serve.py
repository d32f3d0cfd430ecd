"""The port's HTTP server (``mockingbird_tpu_torch.serve``) against the JAX
package's.

* Every case of ``tests/test_serve.py``, with the same fakes copied in,
  against the port's server.
* The same requests to the JAX server and to the port's, each with a
  toolbox of its own package built from the same fake factories and seed,
  give the same status, JSON (timings aside) and wav bytes.
* One tiny real port pipeline on the CPU, whose coalesced
  ``/api/synthesize`` responses, one alone and four concurrent, equal a
  direct ``tts_batch`` of the same dispatch's texts and embeddings.

Every ``urlopen`` has a timeout of at most 60 s; every fixture shuts its
server down and closes its socket.
"""
import concurrent.futures
import io
import json
import threading
import time
import urllib.error
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest

from mockingbird_tpu_torch.serve.http import _wav_bytes, serve
from mockingbird_tpu_torch.serve.toolbox import WebToolbox, read_audio

TIMEOUT = 60


def _write_wav(path: Path, seconds=0.5, sr=16000, freq=220.0):
    t = np.arange(int(sr * seconds)) / sr
    wav = (0.4 * np.sin(2 * np.pi * freq * t) * 32767).astype(np.int16)
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(wav.tobytes())


class _FakeEncoder:
    def preprocess_wav(self, wav, sr=None):
        return np.asarray(wav)

    def embed_utterance(self, wav):
        rng = np.random.default_rng(int(abs(float(np.sum(wav))) * 1e3) % 2**31)
        e = rng.standard_normal(256).astype(np.float32)
        return e / np.linalg.norm(e)


class _FakeSynth:
    seed = 0

    def synthesize_spectrograms(self, texts, embeds, style_idx=0, steps=1000,
                                min_stop_token=5, **kw):
        return [np.random.default_rng(self.seed).uniform(-4, 4, (80, 120)).astype(np.float32)
                for _ in texts]

    def griffin_lim(self, mel):
        return np.zeros(mel.shape[1] * 256, np.float32)


class _FakePipeline:
    def __init__(self):
        self.encoder = _FakeEncoder()
        self.synthesizer = _FakeSynth()

    def embed_reference(self, ref_wav, source_sr=None):
        return self.encoder.embed_utterance(np.asarray(ref_wav))

    def tts_batch(self, texts, ref_wav, embed=None, **kw):
        rng = np.random.default_rng(1)
        return [(rng.uniform(-1, 1, 4000) * 32767).astype(np.int16)
                for _ in texts]


class _FakeVocoder:
    def infer_waveform(self, mel):
        return np.random.default_rng(0).uniform(-1, 1, mel.shape[1] * 256).astype(np.float32)


class _FakeVC:
    def set_reference(self, path):
        pass

    def convert_wav(self, wav):
        return np.zeros((60, 80), np.float32), 0.05


def _roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    _write_wav(root / "LJSpeech-1.1" / "wavs" / "LJ001-0001.wav")
    _write_wav(root / "LJSpeech-1.1" / "wavs" / "LJ001-0002.wav", freq=440)
    models = tmp_path_factory.mktemp("models")
    for fam in ("default/encoder", "default/synthesizer", "default/vocoder_hifigan"):
        d = models / fam / "checkpoints"
        d.mkdir(parents=True)
        (models / fam / "config.json").write_text("{}")
    return root, models


def _start(toolbox, serve_fn=serve):
    srv = serve_fn(port=0, block=False, toolbox=toolbox)
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv):
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root, models = _roots(tmp_path_factory)
    tb = WebToolbox(datasets_root=root, models_dir=models,
                    pipeline_factory=_FakePipeline, vc_factory=_FakeVC,
                    vocoder_factory=lambda name: _FakeVocoder(), seed=0)
    srv, url = _start(tb)
    yield url
    _stop(srv)


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        ct = r.headers.get("Content-Type", "")
        body = r.read()
        return (json.loads(body) if "json" in ct else body), dict(r.headers)


def _post_json(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        ct = r.headers.get("Content-Type", "")
        body = r.read()
        return (json.loads(body) if "json" in ct else body), dict(r.headers)


def _multipart(fields):
    boundary = "xBOUNDARYx"
    parts = []
    for name, (fname, payload) in fields.items():
        head = f'Content-Disposition: form-data; name="{name}"'
        if fname:
            head += f'; filename="{fname}"'
        if isinstance(payload, str):
            payload = payload.encode()
        parts.append(f"--{boundary}\r\n{head}\r\n\r\n".encode() + payload + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def _post_multipart(url, fields):
    body, headers = _multipart(fields)
    req = urllib.request.Request(url, data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        ct = r.headers.get("Content-Type", "")
        data = r.read()
        return (json.loads(data) if "json" in ct else data), dict(r.headers)


def _wav_payload(freq=220.0):
    buf = io.BytesIO()
    t = np.arange(8000) / 16000
    pcm = (0.4 * np.sin(2 * np.pi * freq * t) * 32767).astype(np.int16)
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the cases of tests/test_serve.py, against the port's server
# ---------------------------------------------------------------------------

def test_console_page(server):
    body, _ = _get(server + "/")
    assert b"toolbox" in body and b"/api/synthesize_mel" in body


def test_dataset_browser(server):
    listing, _ = _get(server + "/api/datasets")
    assert "LJSpeech-1.1" in listing["datasets"]
    l2, _ = _get(server + "/api/datasets?dataset=LJSpeech-1.1")
    assert "wavs" in l2["speakers"]
    l3, _ = _get(server + "/api/datasets?dataset=LJSpeech-1.1&speaker=wavs")
    assert any(u.endswith("LJ001-0001.wav") for u in l3["utterances"])
    rnd, _ = _get(server + "/api/datasets?random=1")
    assert rnd["dataset"] == "LJSpeech-1.1" and rnd["utterance"].endswith(".wav")


def test_audio_fetch_and_traversal_guard(server):
    body, hdrs = _get(server + "/api/audio?path=LJSpeech-1.1/wavs/LJ001-0001.wav")
    assert hdrs["Content-Type"] == "audio/wav" and body[:4] == b"RIFF"
    with pytest.raises(urllib.error.HTTPError):
        _get(server + "/api/audio?path=../../etc/passwd")


def test_embed_and_projection(server):
    r1, _ = _post_multipart(server + "/api/embed",
                            {"ref": ("a.wav", _wav_payload(220)), "name": (None, "utt_a")})
    assert len(r1["embed"]) == 256
    r2, _ = _post_multipart(server + "/api/embed",
                            {"ref": ("b.wav", _wav_payload(440)), "name": (None, "utt_b")})
    assert set(r2["names"]) >= {"utt_a", "utt_b"}
    assert len(r2["projection"]) == len(r2["names"])


def test_synthesize_mel_then_vocode(server):
    res, _ = _post_json(server + "/api/synthesize_mel",
                        {"text": "ni3 hao3", "utterance": "utt_a", "seed": 7})
    assert res["mel_shape"][0] == 80 and res["seconds"] > 0
    assert len(res["mel"]) == 80  # canvas preview rows
    wav, hdrs = _post_json(server + "/api/vocode", {"vocoder": "hifigan"})
    assert wav[:4] == b"RIFF" and float(hdrs["X-RTF"]) > 0


def test_vocoder_hot_swap_and_griffinlim(server):
    for name in ("fregan", "wavernn", "griffinlim"):
        wav, _ = _post_json(server + "/api/vocode", {"vocoder": name})
        assert wav[:4] == b"RIFF"


def test_one_shot_synthesize(server):
    wav, hdrs = _post_multipart(server + "/api/synthesize", {
        "text": (None, "ni3 hao3"), "ref": ("r.wav", _wav_payload())})
    assert wav[:4] == b"RIFF" and "X-RTF" in hdrs


def test_convert_endpoint(server):
    wav, hdrs = _post_multipart(server + "/api/convert", {
        "ref": ("r.wav", _wav_payload(220)), "src": ("s.wav", _wav_payload(330))})
    assert wav[:4] == b"RIFF" and "X-RTF" in hdrs


def test_models_listing(server):
    res, _ = _get(server + "/api/models")
    assert res["encoder"] and res["synthesizer"] and res["vocoder"]


def test_synthesize_mel_without_embed_is_400(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_json(server + "/api/synthesize_mel",
                   {"text": "x", "utterance": "nope"})
    assert e.value.code == 400


def test_read_audio_bytes_roundtrip():
    wav = read_audio(_wav_payload(220), 16000)
    assert wav.dtype == np.float32 and 7900 < len(wav) <= 8000 + 1
    spec = np.abs(np.fft.rfft(wav))
    assert abs(np.argmax(spec) * 16000 / len(wav) - 220) < 5


def test_stream_tts(server):
    """Streaming endpoint: RIFF streaming header + one PCM run per chunk."""
    data, hdrs = _post_multipart(server + "/api/stream_tts", {
        "text": (None, "hello one. hello two. hello three."),
        "ref": ("ref.wav", _wav_payload())})
    assert hdrs.get("Content-Type") == "audio/wav"
    assert int(hdrs.get("X-Chunks", 0)) >= 1
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    n_chunks = int(hdrs["X-Chunks"])
    sr = int(hdrs["X-Sample-Rate"])
    silence = (n_chunks - 1) * int(sr * 0.15) * 2
    expect = 44 + n_chunks * 4000 * 2 + silence
    assert len(data) == expect


class _SlowSynth:
    """Output depends deterministically on the text; stage boundaries sleep
    so unserialised concurrent requests WOULD interleave and corrupt."""
    seed = 0

    def synthesize_spectrograms(self, texts, embeds, **kw):
        n = 40 + 13 * int(texts[0])  # text-determined mel width
        time.sleep(0.05)
        return [np.full((80, n), float(texts[0]) + 1.0, np.float32)]

    def griffin_lim(self, mel):
        return np.zeros(mel.shape[1] * 256, np.float32)


class _SlowVocoder:
    def infer_waveform(self, mel):
        time.sleep(0.05)
        return np.full(mel.shape[1] * 256, 0.5, np.float32)


class _SlowPipeline(_FakePipeline):
    def __init__(self):
        super().__init__()
        self.synthesizer = _SlowSynth()

    def tts_batch(self, texts, ref_wav, embed=None, **kw):
        time.sleep(0.05)
        # identity rides in the text LENGTH ("a"*k), which survives the
        # stream endpoint's text normalisation, unlike digits
        return [np.full(2000 * len(t.strip()), 1000 * len(t.strip()), np.int16)
                for t in texts]


@pytest.fixture(scope="module")
def slow_server():
    tb = WebToolbox(datasets_root=None, models_dir=None,
                    pipeline_factory=_SlowPipeline, vc_factory=_FakeVC,
                    vocoder_factory=lambda name: _SlowVocoder(), seed=0)
    srv, url = _start(tb)
    yield url
    _stop(srv)


def test_concurrent_synthesize_not_interleaved(slow_server):
    """8 simultaneous /api/synthesize requests with distinct texts: every
    response's waveform length must match ITS text's mel width."""
    def one(i):
        wav, hdrs = _post_multipart(slow_server + "/api/synthesize", {
            "text": (None, str(i)), "ref": ("r.wav", _wav_payload(200 + 10 * i))})
        return i, wav

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        results = list(ex.map(one, range(8)))
    for i, wav in results:
        assert wav[:4] == b"RIFF"
        with wave.open(io.BytesIO(wav)) as w:
            n = w.getnframes()
        expect = (40 + 13 * i) * 256
        assert n == expect, f"request {i}: got {n} frames, expected {expect}"


def test_concurrent_stream_tts(slow_server):
    """4 simultaneous /api/stream_tts requests: each stream's PCM payload
    must carry its own text's length and sample values end to end."""
    def one(i):
        data, hdrs = _post_multipart(slow_server + "/api/stream_tts", {
            "text": (None, "a" * (i + 1)), "ref": ("ref.wav", _wav_payload())})
        return i, data, hdrs

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        results = list(ex.map(one, range(4)))
    for i, data, hdrs in results:
        assert data[:4] == b"RIFF"
        pcm = np.frombuffer(data[44:], np.int16)
        assert len(pcm) == 2000 * (1 + i), (i, len(pcm))
        assert (pcm == 1000 * (1 + i)).all(), f"stream {i} carried foreign PCM"


def test_concurrent_mixed_load(slow_server):
    """synthesize + stream + embed fired together: no 500s, all correct."""
    def synth(i):
        wav, _ = _post_multipart(slow_server + "/api/synthesize", {
            "text": (None, str(i)), "ref": ("r.wav", _wav_payload())})
        with wave.open(io.BytesIO(wav)) as w:
            return ("synth", i, w.getnframes())

    def stream(i):
        data, _ = _post_multipart(slow_server + "/api/stream_tts", {
            "text": (None, "a" * (i + 1)), "ref": ("ref.wav", _wav_payload())})
        return ("stream", i, len(np.frombuffer(data[44:], np.int16)))

    def embed(i):
        res, _ = _post_multipart(slow_server + "/api/embed", {
            "name": (None, f"c{i}"), "ref": ("r.wav", _wav_payload(300 + i))})
        return ("embed", i, len(res["embed_preview"]) if "embed_preview" in res else 1)

    with concurrent.futures.ThreadPoolExecutor(6) as ex:
        futs = [ex.submit(synth, 0), ex.submit(stream, 1), ex.submit(embed, 2),
                ex.submit(synth, 3), ex.submit(stream, 2), ex.submit(embed, 5)]
        results = [f.result(timeout=TIMEOUT) for f in futs]
    for kind, i, val in results:
        if kind == "synth":
            assert val == (40 + 13 * i) * 256, (i, val)
        elif kind == "stream":
            assert val == 2000 * (1 + i), (i, val)


class _FusedVocoder:
    def vocode_device(self, mels, **kw):  # marks the fused surface
        raise NotImplementedError

    def infer_waveform(self, mel):
        return np.zeros(mel.shape[1] * 256, np.float32)


class _FusedPipeline(_FakePipeline):
    """Quacks like the real fused pipeline; tts_batch counts dispatches and
    encodes each text's identity in its PCM (length + value)."""
    synthesizer_kind = "tacotron"

    def __init__(self):
        super().__init__()
        self.vocoder = _FusedVocoder()
        self.dispatches = []
        self._lock = threading.Lock()

    def tts_batch(self, texts, ref_wav, embed=None, **kw):
        assert embed is not None and np.asarray(embed).ndim == 2
        assert np.asarray(embed).shape[0] == len(texts)
        with self._lock:
            self.dispatches.append(list(texts))
        time.sleep(0.05)  # one device dispatch's worth of wall time
        return [np.full(2000 * len(t.strip()), 1000 * len(t.strip()), np.int16)
                for t in texts]


@pytest.fixture()
def fused_server():
    tb = WebToolbox(datasets_root=None, models_dir=None,
                    pipeline_factory=_FusedPipeline, vc_factory=_FakeVC,
                    vocoder_factory=lambda name: _FakeVocoder(), seed=0)
    srv, url = _start(tb)
    yield url, tb, srv
    _stop(srv)


def test_synthesize_coalesces_concurrent_requests(fused_server):
    """8 simultaneous default one-shot requests: correct per-text audio,
    X-Coalesced header, and FEWER tts_batch dispatches than requests; the
    coalescer's own count agrees."""
    base, tb, srv = fused_server

    def one(i):
        wav, hdrs = _post_multipart(base + "/api/synthesize", {
            "text": (None, "a" * (i + 1)), "ref": ("r.wav", _wav_payload())})
        return i, wav, hdrs

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        results = list(ex.map(one, range(8)))
    for i, wav, hdrs in results:
        assert hdrs.get("X-Coalesced") == "1"
        pcm = np.frombuffer(wav[44:], np.int16)
        n = 2000 * (i + 1)
        assert len(pcm) == n, (i, len(pcm))
    n_dispatch = len(tb.pipeline.dispatches)
    n_texts = sum(len(d) for d in tb.pipeline.dispatches)
    assert n_texts == 8
    assert n_dispatch < 8, f"no coalescing happened ({n_dispatch} dispatches)"
    assert srv.batcher["batcher"].dispatches == n_dispatch


def test_synthesize_seed_request_stays_on_session_path(fused_server):
    """A seeded request must NOT ride the stateless batcher (seed changes
    the synthesis), falling back to the locked session flow."""
    base, tb, _ = fused_server
    wav, hdrs = _post_multipart(base + "/api/synthesize", {
        "text": (None, "3"), "ref": ("r.wav", _wav_payload()),
        "seed": (None, "7")})
    assert "X-Coalesced" not in hdrs
    assert wav[:4] == b"RIFF"


def test_http_server_health_and_jobs():
    """``tests/test_infra.py::test_http_server_health_and_jobs`` on a free
    port, with a fake toolbox (the default one needs a card)."""
    tb = WebToolbox(pipeline_factory=_FakePipeline, vc_factory=_FakeVC, seed=0)
    srv, url = _start(tb)
    try:
        assert _get(url + "/api/health")[0] == {"status": "ok"}
        assert _get(url + "/api/jobs")[0] == {}
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url + "/api/nothing")
        assert e.value.code == 404
    finally:
        _stop(srv)


# ---------------------------------------------------------------------------
# the same requests to the JAX server and to the port's
# ---------------------------------------------------------------------------

def _request(url, method, path, payload=None, kind="json"):
    """(status, content type, body) of one request; errors included."""
    if method == "GET":
        req = urllib.request.Request(url + path)
    elif kind == "json":
        req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
    else:
        body, headers = _multipart(payload)
        req = urllib.request.Request(url + path, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            status, ct, body = r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        status, ct, body = e.code, e.headers.get("Content-Type", ""), e.read()
    if "json" in ct:
        body = json.loads(body)
        if isinstance(body, dict):
            body.pop("elapsed", None)          # wall time of the call
    return status, ct, body


PARITY_REQUESTS = [
    ("GET", "/", None, None),
    ("GET", "/api/health", None, None),
    ("GET", "/api/jobs", None, None),
    ("GET", "/api/datasets", None, None),
    ("GET", "/api/datasets?dataset=LJSpeech-1.1", None, None),
    ("GET", "/api/datasets?dataset=LJSpeech-1.1&speaker=wavs", None, None),
    ("GET", "/api/datasets?random=1", None, None),
    ("GET", "/api/datasets?dataset=nope", None, None),
    ("GET", "/api/audio?path=LJSpeech-1.1/wavs/LJ001-0002.wav", None, None),
    ("GET", "/api/audio?path=../../etc/passwd", None, None),
    ("GET", "/api/audio?path=LJSpeech-1.1/wavs/missing.wav", None, None),
    ("GET", "/api/models", None, None),
    ("GET", "/api/unknown", None, None),
    ("POST", "/api/embed", {"ref": ("a.wav", _wav_payload(220)), "name": (None, "a")},
     "multipart"),
    ("POST", "/api/embed", {"path": (None, "LJSpeech-1.1/wavs/LJ001-0001.wav"),
                            "name": (None, "b")}, "multipart"),
    ("POST", "/api/embed", {"name": (None, "c")}, "multipart"),
    ("POST", "/api/synthesize_mel", {"text": "ni3 hao3", "utterance": "a", "seed": 7}, "json"),
    ("POST", "/api/synthesize_mel", {"text": "x", "utterance": "nope"}, "json"),
    ("POST", "/api/vocode", {"vocoder": "hifigan"}, "json"),
    ("POST", "/api/vocode", {"vocoder": "wavernn"}, "json"),
    ("POST", "/api/vocode", {"vocoder": "griffinlim"}, "json"),
    ("POST", "/api/synthesize", {"text": (None, "ni3 hao3"), "ref": ("r.wav", _wav_payload())},
     "multipart"),
    ("POST", "/api/synthesize", {"text": (None, "ni3"), "ref": ("r.wav", _wav_payload(330)),
                                 "seed": (None, "3")}, "multipart"),
    ("POST", "/api/synthesize", {"text": (None, "")}, "multipart"),
    ("POST", "/api/stream_tts", {"text": (None, "one. two."), "ref": ("r.wav", _wav_payload())},
     "multipart"),
    ("POST", "/api/convert", {"ref": ("r.wav", _wav_payload(220)),
                              "src": ("s.wav", _wav_payload(330))}, "multipart"),
    ("POST", "/api/train", {"kind": "nope", "syn_dir": "x"}, "json"),
    ("POST", "/api/nothing", {}, "json"),
]


def test_same_requests_same_responses(tmp_path_factory):
    from mockingbird_tpu.serve.http import serve as jserve
    from mockingbird_tpu.serve.toolbox import WebToolbox as JToolbox
    root, models = _roots(tmp_path_factory)
    servers = []
    try:
        for box, serve_fn in ((JToolbox, jserve), (WebToolbox, serve)):
            tb = box(datasets_root=root, models_dir=models, pipeline_factory=_FakePipeline,
                     vc_factory=_FakeVC, vocoder_factory=lambda name: _FakeVocoder(), seed=0)
            servers.append(_start(tb, serve_fn))
        (_, jurl), (_, url) = servers
        for method, path, payload, kind in PARITY_REQUESTS:
            want = _request(jurl, method, path, payload, kind)
            got = _request(url, method, path, payload, kind)
            assert got[:2] == want[:2], (path, got[:2], want[:2])
            if isinstance(want[2], bytes):
                assert got[2] == want[2], path
            else:
                assert json.dumps(got[2], sort_keys=True) == json.dumps(want[2],
                                                                        sort_keys=True), path
    finally:
        for srv, _ in servers:
            _stop(srv)


# ---------------------------------------------------------------------------
# a real (tiny) port pipeline on the CPU
# ---------------------------------------------------------------------------

TACO = dict(embed_dims=32, encoder_dims=16, decoder_dims=16, postnet_dims=32,
            lstm_dims=32, gst_E=16, gst_num_heads=4, gst_ref_filters=(4, 4),
            max_r=4, prenet_dropout=False)
GAN = dict(upsample_rates=[8, 8, 4], upsample_kernel_sizes=[16, 16, 8],
           upsample_initial_channel=32, resblock_kernel_sizes=[3, 7],
           resblock_dilation_sizes=[[1, 3], [1, 3]], hop_size=256)


def _real_pipeline():
    """A tiny seeded Tacotron → HiFi-GAN port pipeline on ``device="cpu"``."""
    from mockingbird_tpu_torch.models.tacotron import Synthesizer, tacotron_config
    from mockingbird_tpu_torch.models.vocoder import GanVocoder
    from mockingbird_tpu_torch.pipeline import VoiceCloningPipeline
    voc = GanVocoder("hifigan", cfg=GAN, verbose=False, half=False, device="cpu")
    pipe = VoiceCloningPipeline(vocoder=voc, verbose=False, device="cpu")
    pipe.synthesizer = Synthesizer(cfg=tacotron_config().merge(TACO), verbose=False,
                                   device="cpu")
    return pipe


def _pcm_diff(got: bytes, pcm: np.ndarray) -> int:
    """Max int16 difference between a served wav and a ``tts_batch`` PCM
    after ``_wav_bytes``' peak scaling; the headers must be equal."""
    want = _wav_bytes(pcm.astype(np.float32) / 32767.0, 16000)
    assert got[:44] == want[:44]
    g = np.frombuffer(got[44:], np.int16).astype(np.int32)
    w = np.frombuffer(want[44:], np.int16).astype(np.int32)
    assert len(g) == len(w) > 0
    return int(np.abs(g - w).max())


def test_real_pipeline_synthesize_equals_tts_batch():
    """A tiny seeded Tacotron → HiFi-GAN port pipeline on ``device="cpu"``:
    the default one-shot request rides the coalescer, and its wav equals a
    direct ``tts_batch`` of the same text and embedding, within one int16
    step after ``_wav_bytes``' peak scaling."""
    pipe = _real_pipeline()
    tb = WebToolbox(pipeline_factory=lambda: pipe, vc_factory=_FakeVC, seed=0, device="cpu")
    srv, url = _start(tb)
    text, ref = "ni3 hao3", _wav_payload(180)
    try:
        got, hdrs = _post_multipart(url + "/api/synthesize",
                                    {"text": (None, text), "ref": ("r.wav", ref)})
    finally:
        _stop(srv)
    assert hdrs.get("X-Coalesced") == "1" and srv.batcher["batcher"].dispatches == 1
    pcm = pipe.tts_batch([text], None, embed=pipe.embed_reference(read_audio(ref, 16000)))[0]
    assert _pcm_diff(got, pcm) <= 1


def test_real_pipeline_coalesced_burst_equals_tts_batch():
    """4 concurrent default requests with different texts on the tiny real
    pipeline ride fewer than 4 dispatches, and every response equals a
    direct ``tts_batch`` of its own dispatch (the same texts and embeddings
    in the same batch), within one int16 step after ``_wav_bytes``' peak
    scaling. Closing the server ends the coalescer's worker and lets go of
    the pipeline."""
    pipe = _real_pipeline()
    dispatched = []

    def recording(texts, ref_wav, embed=None, **kw):
        dispatched.append((list(texts), np.array(embed)))
        return type(pipe).tts_batch(pipe, texts, ref_wav, embed=embed, **kw)

    tb = WebToolbox(pipeline_factory=lambda: pipe, vc_factory=_FakeVC, seed=0, device="cpu")
    srv, url = _start(tb)
    texts, ref = ("ni3 hao3", "zai4 jian4", "xie4 xie4", "hello world"), _wav_payload(180)

    def one(text):
        return _post_multipart(url + "/api/synthesize", {"text": (None, text),
                                                         "ref": ("r.wav", ref)})

    try:
        one(texts[0])                          # builds the pipeline and caches the embed
        dispatched.clear()
        pipe.tts_batch = recording
        with concurrent.futures.ThreadPoolExecutor(len(texts)) as ex:
            results = list(ex.map(one, texts))
    finally:
        _stop(srv)
    del pipe.tts_batch
    batcher = srv.batcher["batcher"]
    assert not batcher._thread.is_alive() and batcher.pipe is None
    assert all(hdrs.get("X-Coalesced") == "1" for _, hdrs in results)
    assert 1 <= len(dispatched) < len(texts), [d for d, _ in dispatched]
    assert sorted(t for d, _ in dispatched for t in d) == sorted(texts)
    got = dict(zip(texts, (wav for wav, _ in results)))
    for batch, embeds in dispatched:
        for text, pcm in zip(batch, pipe.tts_batch(batch, None, embed=embeds)):
            assert _pcm_diff(got[text], pcm) <= 1, text


def test_closed_batcher_refuses_requests_and_finishes_queued_ones():
    """``_TtsBatcher.close`` runs what was queued before it, then stops the
    worker; a later ``submit`` raises at once instead of waiting."""
    from mockingbird_tpu_torch.serve.http import _TtsBatcher
    pipe = _FusedPipeline()
    b = _TtsBatcher(pipe, window_s=0.2)
    out = {}
    t = threading.Thread(target=lambda: out.update(r=b.submit("abc", np.zeros(4), timeout=30)))
    t.start()
    while b.queue.empty() and t.is_alive():
        time.sleep(0.001)
    b.close()
    t.join(TIMEOUT)
    assert len(out["r"]) == 2000 * 3 and pipe.dispatches == [["abc"]]
    assert not b._thread.is_alive() and b.pipe is None
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("x", np.zeros(4), timeout=1)


def test_lazy_members_are_built_once_under_contention():
    """32 threads (more than the cores) ask a fresh toolbox for its
    pipeline, its voice converter and one vocoder at once, with a short
    switch interval: each factory runs once and every thread gets the same
    object (a second build of a full-width pipeline on the card would
    double its memory)."""
    import sys
    calls = {"pipeline": 0, "vc": 0, "vocoder": 0}

    def slow(kind, make):
        def factory(*args):
            n = calls[kind]
            time.sleep(0.005)                # widen the window a race needs
            calls[kind] = n + 1
            return make()
        return factory

    tb = WebToolbox(pipeline_factory=slow("pipeline", _FakePipeline),
                    vc_factory=slow("vc", _FakeVC),
                    vocoder_factory=slow("vocoder", _FakeVocoder), seed=0)
    barrier = threading.Barrier(32)

    def grab(i):
        barrier.wait(timeout=TIMEOUT)
        return (tb.pipeline, tb.vc, tb.get_vocoder("wavernn"))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(32) as ex:
            got = [f.result(timeout=TIMEOUT) for f in [ex.submit(grab, i) for i in range(32)]]
    finally:
        sys.setswitchinterval(old)
    assert calls == {"pipeline": 1, "vc": 1, "vocoder": 1}
    assert all(g == got[0] for g in got)
