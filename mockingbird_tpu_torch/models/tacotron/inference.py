"""Tacotron inference: (text, speaker embedding) → mel spectrograms.

Port of ``mockingbird_tpu/models/tacotron/inference.py``: text buckets of 32,
step buckets of 200, the stop rule with ``done_at``, and the trailing-silence
trim at ``stop_threshold``. The decode loop runs in Python with the state on
the device; it reads the stop flags back once per step, as the JAX while-loop
tests them once per step. ``synthesize_mels_device`` keeps the mels on the
device for the fused pipeline; ``griffin_lim`` inverts a mel without a
vocoder.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from ... import resolve_device, seeded
from ...config import Config, sv2tts_audio_config
from ...dsp import inv_mel_spectrogram, load_wav, melspectrogram
from ...text import romanize, text_to_sequence
from ...weights import load_flax, load_npz
from .model import Tacotron, tacotron_config


def _bucket(n: int, size: int) -> int:
    return max(size, ((n + size - 1) // size) * size)


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

    # ------------------------------------------------------------------
    @torch.no_grad()
    def generate(self, texts: torch.Tensor, spk_embed: torch.Tensor, max_steps: int,
                 r: int, style_idx: int, style_mode: str, min_stop_token: float):
        """Greedy decode of one padded batch.

        Returns (mels (B, max_steps, M), attn (B, S, T_text), n_frames,
        done_at (B,) in frames): ``n_frames`` is where the loop stopped,
        ``done_at`` where each item first met the stop rule."""
        model = self._model
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        b, t_text = texts.shape
        enc_seq, enc_proj, char_mask = model.encode(texts, spk_embed, style_idx,
                                                    style_mode, gen)
        n_groups = max_steps // r
        m = self.cfg.n_mels
        mel_buf = torch.zeros(n_groups, b, r, m, device=self.device)
        attn_buf = torch.zeros(n_groups, b, t_text, device=self.device)
        carry = model.init_carry(b, t_text, self.device)
        prev = torch.zeros(b, m, device=self.device)
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        done_at = torch.full((b,), n_groups, dtype=torch.int64, device=self.device)
        t = 0
        while t < n_groups:
            carry, (mel_r, scores, stop) = model.decode_step(
                enc_seq, enc_proj, char_mask, carry, prev, r, gen)
            mel_buf[t] = mel_r
            attn_buf[t] = scores
            # stop rule: stop*10 > min_stop_token, after t*r > 10
            newly_done = (stop * 10 > min_stop_token) & (t * r > 10)
            done_at = torch.where(newly_done & ~done, t + 1, done_at)
            done = done | newly_done
            prev = mel_r[:, -1, :]
            t += 1
            if bool(done.all()):
                break
        mels = mel_buf.transpose(0, 1).reshape(b, max_steps, m)
        return mels, attn_buf.transpose(0, 1), t * r, done_at * r

    def _encode_texts(self, texts: List[str]):
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
            mels = mels[:, :n_frames].cpu().numpy()
            attn = attn.cpu().numpy()
            for j in range(texts_arr.shape[0]):
                mel = mels[j].T                            # (M, T)
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
