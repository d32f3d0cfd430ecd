"""WaveRNN (fatchord alternating) vocoder, inference in RAW mode.

Port of ``mockingbird_tpu/models/vocoder/wavernn.py``: MelResNet with running
statistics + Stretch2d upsampler, 2×GRU + 3×FC → 512-class RAW softmax,
batched fold/overlap generation with equal-power crossfade, mu-law +
de-emphasis. Generation always takes the fused path of the JAX package:
upsample → fold on the device → the sampler of ``ops/wavernn_sample.py``
(the Hopper kernel on a card, its plain version on the CPU), with the mel
bucketed to 100-frame multiples and folds of 2000 + 2·200 samples.
The MOL head and the unbatched generator wait for a later slice.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import resolve_device, seeded
from ...config import Config
from ...dsp import decode_mu_law, inv_preemphasis_np
from ...ops.wavernn_sample import pack_wavernn_weights, wavernn_sample
from ...weights import load_flax, load_npz
from ..layers import FusedGRUCell


def wavernn_config() -> Config:
    return Config(
        mode="RAW",
        bits=9,
        mu_law=True,
        rnn_dims=512,
        fc_dims=512,
        pad=2,
        upsample_factors=[4, 8, 8],   # factorises hop 256
        feat_dims=80,
        compute_dims=128,
        res_out_dims=128,
        res_blocks=10,
        hop_size=256,
        sample_rate=16000,
        seq_len=256 * 5,
        batch_size=100,
        learning_rate=1e-4,
        gen_batched=True,
        gen_target=8000,
        gen_overlap=400,
        apply_preemphasis=True,
        preemphasis=0.97,
        mel_max_abs_value=4.0,
    )


class ResBlock(nn.Module):
    """1×1 conv + BN residual block. (B, C, T) layout."""

    def __init__(self, dims: int):
        super().__init__()
        self.conv1 = nn.Conv1d(dims, dims, 1, bias=False)
        self.bn1 = nn.BatchNorm1d(dims)
        self.conv2 = nn.Conv1d(dims, dims, 1, bias=False)
        self.bn2 = nn.BatchNorm1d(dims)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        return self.bn2(self.conv2(y)) + x


class MelResNet(nn.Module):
    """k=2·pad+1 valid conv + res stack: (B, T, M) → (B, T-2·pad, res_out)."""

    def __init__(self, c):
        super().__init__()
        self.res_blocks = c.res_blocks
        self.conv_in = nn.Conv1d(c.feat_dims, c.compute_dims, 2 * c.pad + 1, bias=False)
        self.bn = nn.BatchNorm1d(c.compute_dims)
        for i in range(c.res_blocks):
            self.add_module(f"res_{i}", ResBlock(c.compute_dims))
        self.conv_out = nn.Conv1d(c.compute_dims, c.res_out_dims, 1)

    def forward(self, x):
        x = torch.relu(self.bn(self.conv_in(x.transpose(1, 2))))
        for i in range(self.res_blocks):
            x = getattr(self, f"res_{i}")(x)
        return self.conv_out(x).transpose(1, 2)


class UpsampleNetwork(nn.Module):
    """Box-initialised smoothing convs over the stretched mel; nearest
    stretch for the MelResNet features. (B, T, M) → (B, (T-2p)·hop, M) and
    (B, (T-2p)·hop, res_out)."""

    def __init__(self, c):
        super().__init__()
        self.factors = list(c.upsample_factors)
        self.total = int(np.prod(self.factors))
        self.indent = c.pad * self.total
        self.resnet = MelResNet(c)
        for i, s in enumerate(self.factors):
            conv = nn.Conv2d(1, 1, (2 * s + 1, 1), padding=(s, 0), bias=False)
            nn.init.constant_(conv.weight, 1.0 / (2 * s + 1))
            self.add_module(f"up_conv_{i}", conv)

    def forward(self, m):
        aux = self.resnet(m).repeat_interleave(self.total, dim=1)
        x = m[:, None]                                  # (B, 1, T, M)
        for i, s in enumerate(self.factors):
            x = getattr(self, f"up_conv_{i}")(x.repeat_interleave(s, dim=2))
        return x[:, 0, self.indent:-self.indent, :], aux


class _RNN(nn.Module):
    """Holds a cell under the name flax ``nn.RNN`` gives it."""

    def __init__(self, cell: nn.Module):
        super().__init__()
        self.cell = cell


class WaveRNN(nn.Module):
    """Core net: the upsampler and the recurrent/FC weights the sampler uses."""

    def __init__(self, c):
        super().__init__()
        if c.mode != "RAW":
            raise NotImplementedError(f"WaveRNN mode {c.mode!r}: the port has RAW mode only")
        self.n_classes = 2 ** c.bits
        aux_dims = c.res_out_dims // 4
        self.upsample = UpsampleNetwork(c)
        self.I = nn.Linear(c.feat_dims + aux_dims + 1, c.rnn_dims)
        self.rnn1 = _RNN(FusedGRUCell(c.rnn_dims, c.rnn_dims))
        self.rnn2 = _RNN(FusedGRUCell(c.rnn_dims + aux_dims, c.rnn_dims))
        self.fc1 = nn.Linear(c.rnn_dims + aux_dims, c.fc_dims)
        self.fc2 = nn.Linear(c.fc_dims + aux_dims, c.fc_dims)
        self.fc3 = nn.Linear(c.fc_dims, self.n_classes)

    def upsample_features(self, mels):
        """Eval-mode conditioning features for generation."""
        return self.upsample(mels)


# ---------------------------------------------------------------------------
# Fold / crossfade-unfold (numpy, copied from the JAX package)
# ---------------------------------------------------------------------------

def fold_with_overlap(x: np.ndarray, target: int, overlap: int) -> np.ndarray:
    """(1, T, C) → (num_folds, target + 2*overlap, C)."""
    _, total_len, features = x.shape
    num_folds = (total_len - overlap) // (target + overlap)
    extended_len = num_folds * (overlap + target) + overlap
    remaining = total_len - extended_len
    if remaining != 0:
        num_folds += 1
        padding = target + 2 * overlap - remaining
        x = np.pad(x, ((0, 0), (0, padding), (0, 0)))
    folded = np.zeros((num_folds, target + 2 * overlap, features), x.dtype)
    for i in range(num_folds):
        start = i * (target + overlap)
        folded[i] = x[0, start : start + target + 2 * overlap]
    return folded


def xfade_and_unfold(y: np.ndarray, overlap: int) -> np.ndarray:
    """(num_folds, target + 2*overlap) → (total,) with equal-power crossfade."""
    num_folds, length = y.shape
    target = length - 2 * overlap
    total_len = num_folds * (target + overlap) + overlap

    silence_len = overlap // 2
    fade_len = overlap - silence_len
    t = np.linspace(-1, 1, fade_len, dtype=np.float64)
    fade_in = np.concatenate([np.zeros(silence_len), np.sqrt(0.5 * (1 + t))])
    fade_out = np.concatenate([np.sqrt(0.5 * (1 - t)), np.zeros(silence_len)])

    y = y.astype(np.float64).copy()
    y[:, :overlap] *= fade_in
    y[:, -overlap:] *= fade_out

    unfolded = np.zeros(total_len)
    for i in range(num_folds):
        start = i * (target + overlap)
        unfolded[start : start + length] += y[i]
    return unfolded


# ---------------------------------------------------------------------------
# Inference wrapper
# ---------------------------------------------------------------------------

class WaveRnnVocoder:
    """mel (M, T) ±4-normalised → waveform.

    Weights come from ``variables`` (the flax tree, see ``weights.py``), from
    an ``.npz`` export at ``model_fpath``, or else from ``seed``. The sampler
    runs with bf16 weights, as the JAX package's kernel does."""

    def __init__(self, model_fpath: Optional[Union[str, Path]] = None,
                 cfg=None, verbose: bool = True, seed: int = 0,
                 variables: Optional[dict] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.cfg = Config(wavernn_config()).merge(cfg or {})
        total = int(np.prod(self.cfg.upsample_factors))
        if total != self.cfg.hop_size:
            raise ValueError(f"upsample factors {self.cfg.upsample_factors} must "
                             f"factorise hop {self.cfg.hop_size}")
        with seeded(seed):
            self.model = WaveRNN(self.cfg)
        if model_fpath is not None and Path(model_fpath).exists():
            variables = load_npz(model_fpath)
            if verbose:
                print(f"Loaded WaveRNN from {model_fpath}")
        elif variables is None and verbose:
            print("WaveRNN: fresh (untrained) weights")
        if variables is not None:
            load_flax(self.model, variables)
        self.model.to(self.device).eval()
        self.packed = pack_wavernn_weights(self.model)

    @staticmethod
    def _fold_plan(t_up: int, target: int, overlap: int):
        """Fold starts, fold width and the tail padding for ``t_up`` samples
        (the device-side equivalent of ``fold_with_overlap``)."""
        width = target + 2 * overlap
        num_folds = max((t_up - overlap) // (target + overlap), 0)
        if t_up - (num_folds * (overlap + target) + overlap) > 0:
            num_folds += 1
        starts = np.arange(num_folds) * (target + overlap)
        pad = max(int(starts[-1]) + width - t_up, 0) if num_folds else 0
        return starts, width, pad

    @torch.no_grad()
    def _sample(self, mel_bp: np.ndarray, target: int, overlap: int, seed: int,
                greedy: bool) -> np.ndarray:
        """mel_bp (B, T+2p, M) → labels (B, folds, width): upsample → fold
        on the device → the sampler; only the labels come back."""
        mels_up, aux = self.model.upsample_features(
            torch.from_numpy(mel_bp).to(self.device))
        starts, width, pad = self._fold_plan(mels_up.shape[1], target, overlap)
        idx = torch.from_numpy(starts[:, None] + np.arange(width)[None, :]).to(self.device)
        num_folds = len(starts)
        mels_up = F.pad(mels_up, (0, 0, 0, pad))
        aux = F.pad(aux, (0, 0, 0, pad))
        b = mels_up.shape[0]
        mels_f = mels_up[:, idx].reshape(b * num_folds, idx.shape[1], mels_up.shape[-1])
        aux_f = aux[:, idx].reshape(b * num_folds, idx.shape[1], aux.shape[-1])
        labels = wavernn_sample(self.packed, mels_f, aux_f, seed,
                                self.model.n_classes, greedy=greedy)
        return labels.reshape(b, num_folds, -1).cpu().numpy()

    def _prepare(self, mel: np.ndarray, normalize: bool) -> np.ndarray:
        mel = np.asarray(mel, np.float32)
        if mel.shape[0] == self.cfg.feat_dims:
            mel = mel.T                                    # (T, M)
        return mel / self.cfg.mel_max_abs_value if normalize else mel

    def _stack(self, mels: List[np.ndarray]) -> np.ndarray:
        """Edge-pad every mel to the longest one's 100-frame bucket, then pad
        ``pad`` zero frames each side → (B, T+2p, M)."""
        bucket, p = 100, self.cfg.pad
        t_bucket = max(bucket, int(np.ceil(max(m.shape[0] for m in mels) / bucket)) * bucket)
        return np.stack([
            np.pad(np.pad(m, ((0, t_bucket - m.shape[0]), (0, 0)), mode="edge"),
                   ((p, p), (0, 0)))
            for m in mels])

    def infer_waveform(self, mel: np.ndarray, normalize: bool = True,
                       target: Optional[int] = None, overlap: Optional[int] = None,
                       seed: int = 0, greedy: bool = False) -> np.ndarray:
        return self.infer_waveform_batch([mel], normalize, target, overlap, seed, greedy)[0]

    def infer_waveform_batch(self, mels, normalize: bool = True,
                             target: Optional[int] = None, overlap: Optional[int] = None,
                             seed: int = 0, greedy: bool = False,
                             max_lanes: int = 256) -> list:
        """Batch of mels → list of waveforms: every utterance's folds of a
        group ride one sampler launch; ``max_lanes`` caps the folds of one
        launch."""
        cfg = self.cfg
        target = target or cfg.get("gen_target_tpu", 2000)
        overlap = overlap or cfg.get("gen_overlap_tpu", 200)
        preps = [self._prepare(m, normalize) for m in mels]
        wave_lens = [(m.shape[0] - 1) * cfg.hop_size for m in preps]
        stacked = self._stack(preps)
        t_up = (stacked.shape[1] - 2 * cfg.pad) * cfg.hop_size
        folds = len(self._fold_plan(t_up, target, overlap)[0])
        group = max(1, max_lanes // max(folds, 1))
        out = []
        for i in range(0, len(preps), group):
            labels = self._sample(stacked[i : i + group], target, overlap, seed + i, greedy)
            for lab in labels.astype(np.float64):
                samples = 2.0 * lab / (2 ** cfg.bits - 1.0) - 1.0
                out.append(self._finalize(samples, overlap, wave_lens[len(out)]))
        return out

    def _finalize(self, samples: np.ndarray, overlap: int, wave_len: int) -> np.ndarray:
        """Crossfade-unfold + mu-law decode + de-emphasis + trim + fade-out."""
        cfg = self.cfg
        output = xfade_and_unfold(samples, overlap)
        if cfg.mu_law:
            output = decode_mu_law(output, 2 ** cfg.bits, False)
        if cfg.apply_preemphasis:
            output = inv_preemphasis_np(output, cfg.preemphasis)
        output = output[:wave_len]
        fade = min(len(output), 20 * cfg.hop_size)
        output[-fade:] *= np.linspace(1, 0, fade)
        return output.astype(np.float32)
