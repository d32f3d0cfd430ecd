"""GAN-vocoder dataset (host side).

Port of ``mockingbird_tpu/models/vocoder/dataset.py``: the file list from
the synthesizer's ``train.txt`` with a 95/5 train/validation split, random
fixed-size segment crops from ``random.Random(seed)`` in the JAX package's
order, and the input mel made on the fly from the crop (``mel_vits``, on
host CPU tensors) or, when fine-tuning, read from the GTA mels with the
audio cropped to match. Fixed segment sizes keep every batch one shape.
"""
from __future__ import annotations

import random
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...config import Config
from ...dsp import mel_vits, spec_to_mel_vits, spectrogram_vits


def get_dataset_filelist(syn_dir: Path, split: float = 0.95) -> Tuple[List, List]:
    """(audio ``.npy`` path, mel file name) pairs of ``train.txt``, split
    into the first ``split`` share (training) and the rest (validation)."""
    syn_dir = Path(syn_dir)
    with (syn_dir / "train.txt").open("r", encoding="utf-8") as f:
        rows = [line.strip().split("|") for line in f if line.strip()]
    files = [(syn_dir / "audio" / r[0], r[1]) for r in rows]
    n_train = int(len(files) * split)
    return files[:n_train], files[n_train:]


def mel_for_loss(wav: np.ndarray, cfg) -> np.ndarray:
    """The full-band log-mel the trainer's L1 loss compares (``fmax_for_loss``,
    or the Nyquist frequency when it is unset): (frames, num_mels)."""
    fmax = cfg.get("fmax_for_loss") or None
    with torch.no_grad():
        spec = spectrogram_vits(torch.from_numpy(np.asarray(wav, np.float32)), cfg.n_fft,
                                cfg.hop_size, cfg.win_size)
        return spec_to_mel_vits(spec, cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin,
                                fmax).numpy()


class MelDataset:
    """Random-segment (mel (frames, M), wav (segment_size,)) pairs.

    ``fine_tuning=False``: the input mel is the torch-dialect log-mel of the
    segment. ``fine_tuning=True``: the saved GTA mel (±4, SV2TTS dialect)
    under ``syn_dir/mels_gta``, the audio cropped to the matching frames.
    ``split=False`` keeps the whole utterance."""

    def __init__(self, files: List[Tuple[Path, str]], cfg: Config,
                 syn_dir: Optional[Path] = None, fine_tuning: bool = False,
                 split: bool = True, seed: int = 1234):
        self.files = list(files)
        self.cfg = cfg
        self.fine_tuning = fine_tuning
        self.syn_dir = Path(syn_dir) if syn_dir else None
        self.split = split
        self.rng = random.Random(seed)
        self.frames_per_seg = cfg.segment_size // cfg.hop_size

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        wav_path, mel_fname = self.files[index]
        wav = np.load(wav_path).astype(np.float32)

        if not self.fine_tuning:
            if self.split:
                if len(wav) >= cfg.segment_size:
                    start = self.rng.randint(0, len(wav) - cfg.segment_size)
                    wav = wav[start : start + cfg.segment_size]
                else:
                    wav = np.pad(wav, (0, cfg.segment_size - len(wav)))
            with torch.no_grad():
                mel = mel_vits(torch.from_numpy(wav), cfg).numpy().astype(np.float32)
            return mel, wav

        mel = np.load(self.syn_dir / "mels_gta" / mel_fname).astype(np.float32)
        if mel.shape[0] == cfg.num_mels and mel.shape[1] != cfg.num_mels:
            mel = mel.T                                   # (M, T) → (T, M)
        if self.split:
            fps = self.frames_per_seg
            if mel.shape[0] >= fps:
                ms = self.rng.randint(0, mel.shape[0] - fps)
                mel = mel[ms : ms + fps]
                wav = wav[ms * cfg.hop_size : (ms + fps) * cfg.hop_size]
            else:
                mel = np.pad(mel, ((0, fps - mel.shape[0]), (0, 0)))
            if len(wav) < cfg.segment_size:
                wav = np.pad(wav, (0, cfg.segment_size - len(wav)))
            wav = wav[: cfg.segment_size]
        return mel, wav


def collate_gan(batch) -> dict:
    mels, wavs = zip(*batch)
    return dict(mels=np.stack(mels).astype(np.float32),
                wavs=np.stack(wavs).astype(np.float32))
