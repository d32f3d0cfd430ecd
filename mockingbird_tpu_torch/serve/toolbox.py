"""Web toolbox session logic — the reference's PyQt5 Toolbox, headless.

Port of ``mockingbird_tpu/serve/toolbox.py``: dataset browser, utterance
record/load, speaker-embedding projection, synthesize→vocode with seed
control, vocoder hot-swap by name and one-shot VC, as a plain object driven
by the HTTP layer (``serve/http.py``). No Qt; all visual artifacts are
returned as arrays/JSON for the browser-side canvas to draw.

Model-heavy members are created through injectable factories so the HTTP
endpoints are testable without the full pipeline. The default factories
build the port's ``VoiceCloningPipeline``, ``make_voice_converter``,
``GanVocoder`` and ``WaveRnnVocoder`` on the toolbox's ``device`` (the card
unless the caller asks for the CPU; they raise without one). A lock makes
each lazily built member be built once when concurrent requests ask for it
first: a second full-width pipeline on the card would double its memory.
"""
from __future__ import annotations

import io
import threading
import time
import wave
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union

import numpy as np

# Mirror of the reference's browser dataset layout list
# (`control/toolbox/__init__.py:20-45`).
RECOGNIZED_DATASETS = [
    "LibriSpeech/dev-clean",
    "LibriSpeech/dev-other",
    "LibriSpeech/test-clean",
    "LibriSpeech/test-other",
    "LibriSpeech/train-clean-100",
    "LibriSpeech/train-clean-360",
    "LibriSpeech/train-other-500",
    "LibriTTS/dev-clean",
    "LibriTTS/dev-other",
    "LibriTTS/test-clean",
    "LibriTTS/test-other",
    "LibriTTS/train-clean-100",
    "LibriTTS/train-clean-360",
    "LibriTTS/train-other-500",
    "LJSpeech-1.1",
    "VoxCeleb1/wav",
    "VoxCeleb1/test_wav",
    "VoxCeleb2/dev/aac",
    "VoxCeleb2/test/aac",
    "VCTK-Corpus/wav48",
    "aidatatang_200zh/corpus/test",
    "aidatatang_200zh/corpus/train",
    "aishell3/test/wav",
    "magicdata/train",
]

AUDIO_EXTS = (".wav", ".flac", ".mp3", ".m4a")

# Keep at most this many generated/loaded utterances in the session
# (`control/toolbox/__init__.py:48` MAX_WAVES).
MAX_UTTERANCES = 15


def _safe_join(root: Path, rel: str) -> Path:
    """Resolve rel under root, refusing path traversal."""
    p = (root / rel).resolve()
    if not str(p).startswith(str(root.resolve()) + "/") and p != root.resolve():
        raise ValueError(f"path escapes datasets root: {rel}")
    return p


def read_audio(path_or_bytes, target_sr: int = 16000) -> np.ndarray:
    """Load wav/flac/etc. as float32 mono at target_sr.

    scipy wav reader first; soundfile (if installed) for other containers.
    """
    from ..dsp.audio import load_wav, resample
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = io.BytesIO(bytes(path_or_bytes))
        try:
            with wave.open(buf, "rb") as w:
                sr = w.getframerate()
                n = w.getnframes()
                raw = w.readframes(n)
                width = w.getsampwidth()
                nch = w.getnchannels()
            dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
            data = np.frombuffer(raw, dtype=dtype).astype(np.float32)
            if width == 1:
                data = (data - 128.0) / 128.0
            else:
                data = data / float(2 ** (8 * width - 1))
            if nch > 1:
                data = data.reshape(-1, nch).mean(axis=1)
            wav = data
        except Exception:
            try:
                import soundfile as sf  # optional
                buf.seek(0)
                data, sr = sf.read(buf, dtype="float32")
                wav = data.mean(axis=1) if data.ndim == 2 else data
            except Exception as e:
                raise ValueError(f"cannot decode audio bytes: {e}")
        if sr != target_sr:
            wav = resample(wav, sr, target_sr)
        return wav.astype(np.float32)
    path = Path(path_or_bytes)
    if path.suffix.lower() == ".wav":
        wav, _ = load_wav(path, target_sr=target_sr)
        return wav
    import soundfile as sf  # raises ImportError if the optional dep is absent
    data, sr = sf.read(str(path), dtype="float32")
    wav = data.mean(axis=1) if data.ndim == 2 else data
    if sr != target_sr:
        wav = resample(wav, sr, target_sr)
    return wav.astype(np.float32)


class WebToolbox:
    """Session state + operations behind the HTTP console."""

    def __init__(self,
                 datasets_root: Optional[Path] = None,
                 models_dir: Optional[Path] = None,
                 pipeline_factory: Optional[Callable] = None,
                 vc_factory: Optional[Callable] = None,
                 vocoder_factory: Optional[Callable] = None,
                 seed: Optional[int] = None,
                 device: Union[str, "torch.device"] = "cuda"):
        self.datasets_root = Path(datasets_root) if datasets_root else None
        self.models_dir = Path(models_dir) if models_dir else None
        self._pipeline_factory = pipeline_factory
        self._vc_factory = vc_factory
        self._vocoder_factory = vocoder_factory
        self._pipeline = None
        self._vc = None
        self._vocoders: Dict[str, object] = {}
        self.seed = seed
        self.device = device
        self.rng = np.random.default_rng(seed)
        # session utterances: name → {"wav": float32[n], "embed": 256-d or None}
        self.utterances: Dict[str, dict] = {}
        self.current_spec: Optional[np.ndarray] = None  # (n_mels, T)
        self.current_wav: Optional[np.ndarray] = None
        self.sample_rate = 16000
        # serialises stateful request flows (embed→synthesize→vocode all
        # mutate the session: current_spec/current_wav/utterances). The
        # port's inference calls keep no per-call state on their objects
        # (generators are made per call); this lock is about session
        # consistency under ThreadingHTTPServer concurrency, not the device.
        self.session_lock = threading.RLock()
        # the lazily built members are built once, whichever thread asks first
        self._build_lock = threading.RLock()

    # -- lazy model access --------------------------------------------------
    @property
    def pipeline(self):
        with self._build_lock:
            if self._pipeline is None:
                if self._pipeline_factory is None:
                    from ..pipeline import VoiceCloningPipeline
                    self._pipeline_factory = lambda: VoiceCloningPipeline(
                        verbose=False, device=self.device)
                self._pipeline = self._pipeline_factory()
            return self._pipeline

    @property
    def vc(self):
        with self._build_lock:
            if self._vc is None:
                if self._vc_factory is None:
                    from ..pipeline import make_voice_converter
                    self._vc_factory = lambda: make_voice_converter(verbose=False,
                                                                    device=self.device)
                self._vc = self._vc_factory()
            return self._vc

    def get_vocoder(self, name: str):
        """Hot-swap vocoder by name (`control/toolbox/__init__.py:437-473`
        dispatches by checkpoint-filename substring; here by explicit name)."""
        name = (name or "hifigan").lower()
        if name in ("griffinlim", "griffin-lim", "gl"):
            return None
        with self._build_lock:
            if name not in self._vocoders:
                if self._vocoder_factory is not None:
                    self._vocoders[name] = self._vocoder_factory(name)
                elif name == "wavernn":
                    from ..models.vocoder import WaveRnnVocoder
                    self._vocoders[name] = WaveRnnVocoder(verbose=False, device=self.device)
                else:
                    from ..models.vocoder import GanVocoder
                    self._vocoders[name] = GanVocoder(name, verbose=False, device=self.device)
            return self._vocoders[name]

    # -- dataset browser ----------------------------------------------------
    def browse(self, dataset: Optional[str] = None,
               speaker: Optional[str] = None) -> dict:
        """Progressive listing: datasets → speakers → utterances.

        Mirrors `ui.populate_browser` levels 0/1/2 (`control/toolbox/ui.py`):
        a dataset is a recognized relative dir (or any dir with audio below
        it), a speaker is a first-level subdir, utterances are audio files
        under the speaker (recursive).
        """
        root = self.datasets_root
        if root is None or not root.exists():
            return {"datasets": [], "speakers": [], "utterances": [],
                    "error": "no datasets_root configured"}
        out = {"datasets": [], "speakers": [], "utterances": []}
        for rel in RECOGNIZED_DATASETS:
            if (root / rel).is_dir():
                out["datasets"].append(rel)
        if not out["datasets"]:
            # fall back: any first/second-level dir containing audio files
            for d in sorted(p for p in root.iterdir() if p.is_dir()):
                try:
                    next(f for f in d.rglob("*") if f.suffix.lower() in AUDIO_EXTS)
                    out["datasets"].append(str(d.relative_to(root)))
                except StopIteration:
                    pass
        if dataset is None:
            return out
        dpath = _safe_join(root, dataset)
        if not dpath.is_dir():
            return {**out, "error": f"no such dataset: {dataset}"}
        speakers = sorted(p.name for p in dpath.iterdir() if p.is_dir())
        if not speakers:
            speakers = ["."]  # flat dataset (e.g. LJSpeech wavs/)
        out["speakers"] = speakers
        if speaker is None:
            return out
        spath = _safe_join(root, f"{dataset}/{speaker}")
        utts = sorted(str(f.relative_to(root)) for f in spath.rglob("*")
                      if f.suffix.lower() in AUDIO_EXTS)
        out["utterances"] = utts[:500]
        return out

    def random_utterance(self) -> dict:
        """Random dataset/speaker/utterance pick (`random_func(level)` wiring,
        `control/toolbox/__init__.py:91-98`)."""
        listing = self.browse()
        if not listing["datasets"]:
            return {"error": "no datasets found"}
        dataset = str(self.rng.choice(listing["datasets"]))
        speakers = self.browse(dataset)["speakers"]
        if not speakers:
            return {"error": f"no speakers in {dataset}"}
        speaker = str(self.rng.choice(speakers))
        utts = self.browse(dataset, speaker)["utterances"]
        if not utts:
            return {"error": f"no utterances in {dataset}/{speaker}"}
        return {"dataset": dataset, "speaker": speaker,
                "utterance": str(self.rng.choice(utts))}

    def audio_path(self, rel: str) -> Path:
        if self.datasets_root is None:
            raise ValueError("no datasets_root configured")
        p = _safe_join(self.datasets_root, rel)
        if not p.is_file():
            raise FileNotFoundError(rel)
        return p

    # -- utterances & embeddings ---------------------------------------------
    def _remember(self, name: str, wav: np.ndarray, embed=None):
        self.utterances[name] = {"wav": wav, "embed": embed}
        while len(self.utterances) > MAX_UTTERANCES:
            self.utterances.pop(next(iter(self.utterances)))

    def embed_utterance(self, name: str, wav: np.ndarray) -> dict:
        """Embed + refresh the 2-D projection of all session embeds
        (the toolbox UMAP panel, `control/toolbox/__init__.py:206-229`)."""
        enc = self.pipeline.encoder
        wav_p = enc.preprocess_wav(wav, self.sample_rate)
        embed = np.asarray(enc.embed_utterance(wav_p))
        self._remember(name, wav, embed)
        return {"name": name, "embed": embed.tolist(),
                **self.projection_state()}

    def projection_state(self) -> dict:
        names = [n for n, u in self.utterances.items() if u["embed"] is not None]
        embeds = [self.utterances[n]["embed"] for n in names]
        if len(embeds) < 2:
            pts = [[0.5, 0.5]] * len(embeds)
            return {"names": names, "projection": pts}
        from ..train.visualizations import project_embeddings
        pts = project_embeddings(np.stack(embeds))
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        pts = (pts - lo) / np.maximum(hi - lo, 1e-6)
        return {"names": names, "projection": pts.tolist()}

    # -- synthesis / vocoding / VC -------------------------------------------
    def synthesize(self, text: str, utterance: str, seed: Optional[int] = None,
                   style_idx: int = 0, steps: int = 1000,
                   min_stop_token: int = 5) -> dict:
        """Text → mel with the selected utterance's voice; stores the spec
        for a following vocode() (toolbox synthesize button,
        `control/toolbox/__init__.py:231-263`)."""
        if utterance not in self.utterances:
            raise ValueError(f"unknown utterance {utterance!r}; embed one first")
        u = self.utterances[utterance]
        if u["embed"] is None:
            self.embed_utterance(utterance, u["wav"])
            u = self.utterances[utterance]
        pipe = self.pipeline
        if seed is not None:
            pipe.synthesizer.seed = int(seed)
        t0 = time.time()
        embeds = np.tile(u["embed"], (1, 1))
        specs = pipe.synthesizer.synthesize_spectrograms(
            [text], embeds, style_idx=style_idx, steps=steps,
            min_stop_token=min_stop_token)
        dt = time.time() - t0
        self.current_spec = np.asarray(specs[0])
        return {"mel_shape": list(self.current_spec.shape),
                "mel": _mel_preview(self.current_spec),
                "seconds": self.current_spec.shape[1] * 256 / self.sample_rate,
                "elapsed": dt}

    def vocode(self, vocoder: str = "hifigan") -> dict:
        """Current spec → waveform with the selected vocoder (toolbox vocode
        button + name dispatch, `control/toolbox/__init__.py:265-354`)."""
        if self.current_spec is None:
            raise ValueError("nothing synthesized yet")
        t0 = time.time()
        voc = self.get_vocoder(vocoder)
        if voc is None:  # griffin-lim
            wav = np.asarray(self.pipeline.synthesizer.griffin_lim(self.current_spec))
        else:
            wav = np.asarray(voc.infer_waveform(self.current_spec))
        dt = time.time() - t0
        self.current_wav = wav
        name = f"gen_{int(self.rng.integers(100000)):05d}"
        self._remember(name, wav)
        rtf = (len(wav) / self.sample_rate) / max(dt, 1e-9)
        return {"name": name, "seconds": len(wav) / self.sample_rate,
                "elapsed": dt, "rtf": rtf}

    def convert(self, ref_wav: np.ndarray, src_wav: np.ndarray,
                vocoder: str = "hifigan") -> dict:
        """One-shot VC (toolbox `convert()` / `run.py:31-94`)."""
        import tempfile
        from ..dsp.audio import save_wav
        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            save_wav(ref_wav, f.name, self.sample_rate)
            self.vc.set_reference(f.name)
        t0 = time.time()
        mel, rtf = self.vc.convert_wav(src_wav)
        voc = self.get_vocoder(vocoder)
        mel_t = np.asarray(mel).T
        if voc is None:
            wav = np.asarray(self.pipeline.synthesizer.griffin_lim(mel_t))
        else:
            wav = np.asarray(voc.infer_waveform(mel_t))
        dt = time.time() - t0
        self.current_spec, self.current_wav = mel_t, wav
        return {"seconds": len(wav) / self.sample_rate, "elapsed": dt,
                "rtf": rtf, "mel": _mel_preview(mel_t),
                "mel_shape": list(mel_t.shape)}

    # -- model browser --------------------------------------------------------
    def list_models(self) -> dict:
        """Checkpoint listing for the model combo boxes
        (`control/toolbox/__init__.py:165-199` init_* populate)."""
        out: Dict[str, List[str]] = {"encoder": [], "synthesizer": [],
                                     "vocoder": [], "vc": []}
        if self.models_dir is None or not self.models_dir.exists():
            return out
        for p in sorted(self.models_dir.rglob("*")):
            if not p.is_dir() or not (p / "checkpoints").exists() \
                    and not any(p.glob("*.json")):
                continue
            rel = str(p.relative_to(self.models_dir))
            low = rel.lower()
            if "encoder" in low:
                out["encoder"].append(rel)
            elif "vocoder" in low or "hifigan" in low or "fregan" in low \
                    or "wavernn" in low:
                out["vocoder"].append(rel)
            elif "ppg" in low or "vc" in low:
                out["vc"].append(rel)
            else:
                out["synthesizer"].append(rel)
        return out


def _mel_preview(mel: np.ndarray, max_width: int = 1024) -> list:
    """Quantized (n_mels, T≤max_width) preview for canvas drawing."""
    m = np.asarray(mel, dtype=np.float32)
    if m.shape[1] > max_width:
        idx = np.linspace(0, m.shape[1] - 1, max_width).astype(int)
        m = m[:, idx]
    lo, hi = float(m.min()), float(m.max())
    q = np.round((m - lo) / max(hi - lo, 1e-6) * 255).astype(int)
    return q.tolist()
