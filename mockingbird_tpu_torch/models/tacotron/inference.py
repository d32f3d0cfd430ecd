"""Tacotron inference: (text, speaker embedding) → mel spectrograms.

Port of ``mockingbird_tpu/models/tacotron/inference.py``: text buckets of 32,
step buckets of 200, the stop rule with ``done_at``, and the trailing-silence
trim at ``stop_threshold``. The decode loop runs in Python over a state kept
in tensors whose addresses stay fixed (``_Decoder``); on a CUDA device one
decoder step is captured in a CUDA graph and replayed once a step, so the
host issues a step in one launch. The loop reads the stop flags after every
``STOP_EVERY`` steps and after the last; when every item has stopped it
takes the frame count from ``done_at``, so the frames and ``done_at`` are
those of the JAX while-loop, which tests the flags after each step.
``synthesize_mels_device`` keeps the mels on the device for the fused
pipeline; ``griffin_lim`` inverts a mel without a vocoder. Under a profiler
session the decode records its spans (``tracing.py``): ``tacotron.decode``
with the steps asked and run, the steps replayed from a graph and the graphs
captured, each ``tacotron.step`` and each ``tacotron.step_wait`` on the stop
flags.
"""
from __future__ import annotations

import collections
import threading
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from ... import resolve_device, seeded, tracing
from ...config import Config, sv2tts_audio_config
from ...dsp import inv_mel_spectrogram, load_wav, melspectrogram
from ...text import romanize, text_to_sequence
from ...weights import load_flax, load_npz
from .model import Tacotron, tacotron_config


STOP_EVERY = 16
"""Decoder steps between two reads of the stop flags. A read waits until
the card has run every step issued, so a read after each step makes the
host wait out each step before it issues the next; after 16 the card has
work queued while the host waits, and a decode whose items have all
stopped runs at most 15 steps more (~9 ms at batch 128 on an H100)."""

DECODERS = 8
"""Decode shapes whose state, and on a CUDA device whose captured step, a
``Synthesizer`` keeps; the least recently used goes first."""


def _bucket(n: int, size: int) -> int:
    return max(size, ((n + size - 1) // size) * size)


def _leaves(carry) -> tuple:
    attn_hidden, (c1, h1), (c2, h2), context_vec, cumulative = carry
    return attn_hidden, c1, h1, c2, h2, context_vec, cumulative


class _Decoder:
    """Greedy decoding at one shape (batch, text bucket, steps, ``r``, stop
    threshold) over a state in tensors whose addresses stay fixed: the
    encoder's outputs, the carry, the last frame, the stop flags and
    ``done_at``, the step count ``t`` and the mel and attention buffers.
    ``step`` advances the state by one decoder step in place; on a CUDA
    device it replays the step captured in a CUDA graph at the first decode.

    The PreNet's dropout draws from ``gen``, which the graph reads, so that
    replay k draws what the k-th step run eagerly would. ``lock`` is held
    by one decode at a time, from its encoder's draws to ``finish``."""

    def __init__(self, model: Tacotron, r: int, min_stop_token: float, device: torch.device):
        self.model, self.r, self.min_stop_token, self.device = model, r, min_stop_token, device
        self.gen = torch.Generator(device=device)
        self.lock = threading.Lock()
        self.graph = None
        self.mels: Optional[torch.Tensor] = None

    def start(self, enc_seq: torch.Tensor, enc_proj: torch.Tensor, char_mask: torch.Tensor,
              n_groups: int) -> int:
        """Take the encoder's outputs and reset the rest of the state; on a
        CUDA device capture the step first if it is not captured yet.
        Returns the graphs captured: 0 or 1."""
        if self.mels is None:
            b, t_text = char_mask.shape
            dev, m = self.device, self.model.cfg.n_mels
            self.enc_seq, self.enc_proj, self.char_mask = (
                torch.zeros_like(x) for x in (enc_seq, enc_proj, char_mask))
            self.carry = self.model.init_carry(b, t_text, dev)
            self.prev = torch.zeros(b, m, device=dev)
            self.done = torch.zeros(b, dtype=torch.bool, device=dev)
            self.done_at = torch.zeros(b, dtype=torch.int64, device=dev)
            self.t = torch.zeros(1, dtype=torch.int64, device=dev)
            self.mels = torch.zeros(n_groups, b, self.r, m, device=dev)
            self.attn = torch.zeros(n_groups, b, t_text, device=dev)
        captures = 0
        if self.graph is None and self.device.type == "cuda" and n_groups:
            self.graph = self._capture()
            captures = int(self.graph is not None)
        for dst, src in ((self.enc_seq, enc_seq), (self.enc_proj, enc_proj),
                         (self.char_mask, char_mask)):
            dst.copy_(src)
        for x in (*_leaves(self.carry), self.prev, self.done, self.t, self.mels, self.attn):
            x.zero_()
        self.done_at.fill_(n_groups)
        return captures

    def _step(self, gen: torch.Generator) -> None:
        """One decoder step, the stop rule and the writes of its frames,
        in place."""
        carry, (mel_r, scores, stop) = self.model.decode_step(
            self.enc_seq, self.enc_proj, self.char_mask, self.carry, self.prev, self.r, gen)
        for dst, src in zip(_leaves(self.carry), _leaves(carry)):
            dst.copy_(src)
        self.mels.index_copy_(0, self.t, mel_r[None])
        self.attn.index_copy_(0, self.t, scores[None])
        # stop rule: stop*10 > min_stop_token, after t*r > 10
        newly_done = (stop * 10 > self.min_stop_token) & (self.t * self.r > 10)
        self.done_at.copy_(torch.where(newly_done & ~self.done, self.t + 1, self.done_at))
        self.done |= newly_done
        self.prev.copy_(mel_r[:, -1, :])
        self.t += 1

    def _capture(self):
        """The step captured in a CUDA graph. A step is run first on the
        capture's stream, as PyTorch advises, so that the libraries set up
        their handles and workspaces there; it draws from a generator of its
        own, so the decode's draws are not moved, and ``start`` resets the
        state it leaves. The capture registers PyTorch's default CUDA
        generator as well, so no other thread should draw from that
        generator while it lasts."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._step(torch.Generator(device=self.device).manual_seed(0))
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            self._step(self.gen)
        return graph

    def step(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self._step(self.gen)

    def stopped(self) -> Optional[int]:
        """``max(done_at)`` once every item has met the stop rule, else
        None: where a loop that read the flags after each step would
        have stopped. Waits for the card."""
        return int(self.done_at.max()) if bool(self.done.all()) else None

    def finish(self, t: int, issued: int):
        """The decode's outputs in tensors of their own, which no later
        decode writes: mels (B, S·r, M), attention (B, S, T_text), ``done_at``
        in frames. The frames of the ``issued`` steps past ``t`` are zeroed
        first."""
        if t < issued:
            self.mels[t:issued].zero_()
            self.attn[t:issued].zero_()
        b, m = self.mels.shape[1], self.mels.shape[-1]
        mels = self.mels.transpose(0, 1).clone(memory_format=torch.contiguous_format)
        attn = self.attn.transpose(0, 1).clone(memory_format=torch.contiguous_format)
        return mels.view(b, -1, m), attn, self.done_at * self.r


class Synthesizer:
    """Mel synthesizer with the reference's public surface.

    Weights come from ``variables`` (the flax tree, see ``weights.py``), from
    an ``.npz`` export at ``model_fpath`` (with its ``.json`` config
    sidecar), or else from ``seed``. A ``model_fpath`` that does not exist
    raises."""

    sample_rate = 16000

    def __init__(self, model_fpath: Optional[Union[str, Path]] = None,
                 verbose: bool = True, cfg=None, audio_cfg=None, seed: int = 0,
                 variables: Optional[dict] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or tacotron_config()
        self.audio_cfg = audio_cfg or sv2tts_audio_config()
        self.model_fpath = Path(model_fpath) if model_fpath is not None else None
        if self.model_fpath is not None and not self.model_fpath.is_file():
            raise FileNotFoundError(f"no synthesizer weights at {self.model_fpath}")
        self.verbose = verbose
        self.seed = seed
        self._variables = variables
        self._model: Optional[Tacotron] = None
        self._decoders: "collections.OrderedDict[tuple, _Decoder]" = collections.OrderedDict()
        self._decoders_lock = threading.Lock()

    def is_loaded(self) -> bool:
        return self._model is not None

    def load(self) -> None:
        variables = self._variables
        if self.model_fpath is not None:
            sidecar = self.model_fpath.with_suffix(".json")
            if sidecar.exists():
                self.cfg.merge(Config.from_json(sidecar))
            variables = load_npz(self.model_fpath)
            if self.verbose:
                print(f"Loaded synthesizer from {self.model_fpath}")
        elif variables is None and self.verbose:
            print("Synthesizer using fresh (untrained) weights")
        with seeded(self.seed):
            model = Tacotron(self.cfg)
        if variables is not None:
            load_flax(model, variables)
        self._model = model.to(self.device).eval()
        with self._decoders_lock:
            self._decoders.clear()

    def _decoder(self, b: int, t_text: int, n_groups: int, r: int,
                 min_stop_token: float) -> _Decoder:
        """The decoder of this shape, made on first use; the least recently
        used past ``DECODERS`` is dropped."""
        model = self._model
        key = (b, t_text, n_groups, r, min_stop_token, next(model.parameters()).dtype)
        with self._decoders_lock:
            dec = self._decoders.pop(key, None) or _Decoder(model, r, min_stop_token,
                                                             self.device)
            self._decoders[key] = dec
            if len(self._decoders) > DECODERS:
                self._decoders.popitem(last=False)
        return dec

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, texts: torch.Tensor, spk_embed: torch.Tensor, max_steps: int,
                 r: int, style_idx: int, style_mode: str, min_stop_token: float):
        """Greedy decode of one padded batch.

        Returns (mels (B, max_steps, M), attn (B, S, T_text), n_frames,
        done_at (B,) in frames): ``n_frames`` is where the loop stopped,
        ``done_at`` where each item first met the stop rule. The stop flags
        are read after every ``STOP_EVERY`` steps; steps run past the stop
        leave the frames after ``n_frames`` zero."""
        model = self._model
        b, t_text = texts.shape
        n_groups = max_steps // r
        with tracing.span("tacotron.decode") as decode:
            decode.set("batch", b)
            decode.set("steps_asked", n_groups)
            dec = self._decoder(b, t_text, n_groups, r, float(min_stop_token))
            with dec.lock:
                dec.gen.manual_seed(self.seed)
                decode.set("captures", dec.start(
                    *model.encode(texts, spk_embed, style_idx, style_mode, dec.gen), n_groups))
                issued, t = 0, None
                while t is None and issued < n_groups:
                    with tracing.span("tacotron.step"):
                        dec.step()
                        issued += 1
                        if issued % STOP_EVERY == 0 or issued == n_groups:
                            with tracing.span("tacotron.step_wait"):
                                t = dec.stopped()
                t = n_groups if t is None else t
                mels, attn, done_at = dec.finish(t, issued)
            decode.set("steps_run", issued)
            decode.set("graphed", issued if dec.graph is not None else 0)
        return mels, attn, t * r, done_at

    def _encode_texts(self, texts: List[str]):
        with tracing.span("tacotron.text"):
            sequences = [text_to_sequence(romanize(t)) for t in texts]
            t_text = _bucket(max(len(s) for s in sequences), 32)
            arr = np.zeros((len(sequences), t_text), np.int64)
            for j, s in enumerate(sequences):
                arr[j, : len(s)] = s
            return torch.from_numpy(arr).to(self.device)

    def synthesize_spectrograms(self, texts: List[str], embeddings: Union[np.ndarray, List[np.ndarray]],
                                return_alignments: bool = False, style_idx: int = 0,
                                min_stop_token: int = 5, steps: int = 2000,
                                batch_size: int = 16, r: int = 2) -> List[np.ndarray]:
        """texts + (B, 256) embeddings → list of (M, T) mel arrays
        (bin-major, as the reference returns them)."""
        if not self.is_loaded():
            self.load()
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.ndim == 1:
            embeddings = np.tile(embeddings, (len(texts), 1))
        steps = _bucket(steps, 200)
        style_mode = "token" if 0 <= style_idx < self.cfg.gst_token_num else "neutral"

        specs, aligns = [], []
        for i in range(0, len(texts), batch_size):
            texts_arr = self._encode_texts(texts[i : i + batch_size])
            emb = torch.from_numpy(embeddings[i : i + batch_size]).to(self.device)
            mels, attn, n_frames, _ = self.generate(
                texts_arr, emb, steps, r, max(style_idx, 0), style_mode,
                float(min_stop_token))
            with tracing.span("tacotron.to_host"):
                mels = mels[:, :n_frames].cpu().numpy()
                attn = attn.cpu().numpy()
                for j in range(texts_arr.shape[0]):
                    mel = mels[j].T                        # (M, T)
                    # trim trailing silence frames
                    keep = np.where(~(mel <= self.cfg.stop_threshold).all(axis=0))[0]
                    if len(keep):
                        mel = mel[:, : keep[-1] + 1]
                    specs.append(mel)
                    aligns.append(attn[j])
        return (specs, aligns) if return_alignments else specs

    def synthesize_mels_device(self, texts: List[str],
                               embeddings: Union[np.ndarray, List[np.ndarray]],
                               style_idx: int = 0, min_stop_token: int = 5,
                               steps: int = 2000, r: int = 2):
        """One padded batch → (mels (B, steps, M), frame lengths (B,)), both
        on the device, for the fused pipeline. The mels are the whole
        decode buffer: frames after the loop stopped stay zero. A frame
        length is where the item first met the stop rule (``steps`` if it
        never did)."""
        if not self.is_loaded():
            self.load()
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.ndim == 1:
            embeddings = np.tile(embeddings, (len(texts), 1))
        steps = _bucket(steps, 200)
        style_mode = "token" if 0 <= style_idx < self.cfg.gst_token_num else "neutral"
        mels, _, _, frame_lens = self.generate(
            self._encode_texts(texts), torch.from_numpy(embeddings).to(self.device), steps, r,
            max(style_idx, 0), style_mode, float(min_stop_token))
        return mels, frame_lens

    # ------------------------------------------------------------------
    @staticmethod
    def load_preprocess_wav(fpath) -> np.ndarray:
        """Load a wav at 16 kHz and denoise it (LogMMSE, the noise profiled
        on its first 0.2 s) when it is longer than 0.5 s."""
        from ...dsp.logmmse import denoise, profile_noise
        wav, _ = load_wav(fpath, target_sr=16000)
        if len(wav) > 16000 * 0.5:
            try:
                profile = profile_noise(wav[: int(16000 * 0.2)], 16000)
                wav = denoise(wav, profile)
            except Exception:
                pass
        return wav

    def make_spectrogram(self, fpath_or_wav) -> np.ndarray:
        """A wav (or a path, loaded and denoised) → SV2TTS mel (M, T)."""
        wav = (self.load_preprocess_wav(fpath_or_wav) if isinstance(fpath_or_wav, (str, Path))
               else np.asarray(fpath_or_wav, np.float32))
        return melspectrogram(torch.from_numpy(wav).to(self.device), self.audio_cfg).cpu().numpy().T

    def griffin_lim(self, mel: np.ndarray, generator: Optional[torch.Generator] = None,
                    angles: Optional[torch.Tensor] = None) -> np.ndarray:
        """mel (M, T) → waveform by Griffin-Lim on the device; the initial
        phase from ``generator`` (seeded with ``seed`` when not given) or
        handed in as ``angles``."""
        if generator is None and angles is None:
            generator = torch.Generator(device=self.device).manual_seed(self.seed)
        mel_t = torch.from_numpy(np.ascontiguousarray(np.asarray(mel, np.float32).T))
        return inv_mel_spectrogram(mel_t.to(self.device), self.audio_cfg, generator=generator,
                                   angles=angles).cpu().numpy()
