"""WaveRNN (fatchord alternating) vocoder: the training forward, and
inference in RAW and MOL mode.

Port of ``mockingbird_tpu/models/vocoder/wavernn.py``: MelResNet (flax's
BatchNorm: batch statistics in training, running ones in eval) + Stretch2d
upsampler, 2×GRU + 3×FC → a 512-class RAW softmax or the 30-parameter
mixture-of-logistics (MOL) head, batched fold/overlap generation with
equal-power crossfade, mu-law (RAW) + de-emphasis. The training forward
(``forward``: ``features`` then ``head``) runs the GRUs over the whole
sequence through the fused GRU call on the very parameters ``gen_step``'s
cells use.

Two generators, as in the JAX package:
  * RAW mode takes the fused path by default: upsample → fold on the device
    → the sampler of ``ops/wavernn_sample.py`` (the Hopper kernel on a card,
    its plain version on the CPU), with the mel bucketed to 100-frame
    multiples and folds of 2000 + 2·200 samples;
  * MOL mode, and RAW when the caller asks ``use_sampler=False`` (the JAX
    package's ``use_pallas=False``, its CPU path), take the step-by-step
    generator, the port of ``_build_gen_fn``: a Python loop over the fold
    width on the device, every fold one row of each step's products, one
    sample fed back per step, folds of ``gen_target`` + 2·``gen_overlap``
    (8000 + 2·400). It runs as plain PyTorch ops on a card too: the JAX
    package has no kernel for it either (a ``lax.scan``).

Under a profiler session the fused path records its spans (``tracing.py``):
``wavernn.fold``, ``k1.launch`` (with the launch's F and T),
``wavernn.labels_wait`` and ``wavernn.finalize``.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import resolve_device, seeded, tracing
from ...config import Config
from ...dsp import decode_mu_law, inv_preemphasis_np
from ...ops.wavernn_sample import pack_wavernn_weights, tensor_core_launches, wavernn_sample
from ...weights import load_flax, load_npz
from ..layers import Dense, FlaxBatchNorm, FusedGRUCell, with_bias
from .distribution import sample_from_discretized_mix_logistic


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
        self.bn1 = FlaxBatchNorm(dims)
        self.conv2 = nn.Conv1d(dims, dims, 1, bias=False)
        self.bn2 = FlaxBatchNorm(dims)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        return self.bn2(self.conv2(y)) + x


class MelResNet(nn.Module):
    """k=2·pad+1 valid conv + res stack: (B, T, M) → (B, T-2·pad, res_out)."""

    def __init__(self, c):
        super().__init__()
        self.res_blocks = c.res_blocks
        self.conv_in = nn.Conv1d(c.feat_dims, c.compute_dims, 2 * c.pad + 1, bias=False)
        self.bn = FlaxBatchNorm(c.compute_dims)
        for i in range(c.res_blocks):
            self.add_module(f"res_{i}", ResBlock(c.compute_dims))
        self.conv_out = nn.Conv1d(c.compute_dims, c.res_out_dims, 1)

    def forward(self, x):
        x = torch.relu(self.bn(self.conv_in(x.transpose(1, 2))))
        for i in range(self.res_blocks):
            x = getattr(self, f"res_{i}")(x)
        # flax rounds the product below f32 before it adds the bias
        return with_bias(F.conv1d, x, self.conv_out.weight, self.conv_out.bias).transpose(1, 2)


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
    """Core net: the upsampler and the recurrent/FC weights. ``forward`` is
    the training forward (in ``train()`` mode the BatchNorms take batch
    statistics and move their running ones, as flax's ``train=True``);
    ``gen_step`` is one autoregressive step. ``cfg.remat``: the backward
    recomputes the GRUs instead of keeping their activations."""

    def __init__(self, c):
        super().__init__()
        if c.mode not in ("RAW", "MOL"):
            raise ValueError(f"WaveRNN mode {c.mode!r}: 'RAW' or 'MOL'")
        self.n_classes = 2 ** c.bits if c.mode == "RAW" else 30
        self.aux_dims = c.res_out_dims // 4
        self.remat = bool(c.get("remat", False))
        self.upsample = UpsampleNetwork(c)
        self.I = Dense(c.feat_dims + self.aux_dims + 1, c.rnn_dims)
        self.rnn1 = _RNN(FusedGRUCell(c.rnn_dims, c.rnn_dims))
        self.rnn2 = _RNN(FusedGRUCell(c.rnn_dims + self.aux_dims, c.rnn_dims))
        self.fc1 = Dense(c.rnn_dims + self.aux_dims, c.fc_dims)
        self.fc2 = Dense(c.fc_dims + self.aux_dims, c.fc_dims)
        self.fc3 = Dense(c.fc_dims, self.n_classes)

    def features(self, x: torch.Tensor, mels: torch.Tensor):
        """Everything before the FC head: x (B, T) in [-1, 1], mels (B,
        T/hop + 2·pad, M) → (h (B, T, rnn), a3, a4 (B, T, aux_d))."""
        d = self.aux_dims
        mels_up, aux = self.upsample(mels)
        a1, a2, a3, a4 = (aux[..., i * d:(i + 1) * d] for i in range(4))
        h = self.I(torch.cat([x[..., None], mels_up, a1], dim=-1))
        h = self.rnn1.cell.sequence(h, self.remat) + h
        h = self.rnn2.cell.sequence(torch.cat([h, a2], dim=-1), self.remat) + h
        return h, a3, a4

    def head(self, h: torch.Tensor, a3: torch.Tensor, a4: torch.Tensor) -> torch.Tensor:
        """FC head: (·, rnn) + aux → (·, n_classes) logits."""
        h = torch.relu(self.fc1(torch.cat([h, a3], dim=-1)))
        h = torch.relu(self.fc2(torch.cat([h, a4], dim=-1)))
        return self.fc3(h)

    def forward(self, x: torch.Tensor, mels: torch.Tensor) -> torch.Tensor:
        """x (B, T), mels (B, T/hop + 2·pad, M) → logits (B, T, n_classes)."""
        return self.head(*self.features(x, mels))

    def upsample_features(self, mels):
        """Eval-mode conditioning features for generation."""
        return self.upsample(mels)

    def gen_step(self, x, m_t, a1_t, a2_t, a3_t, a4_t, h1, h2):
        """One step, all (B, ·): previous sample ``x`` (B,), conditioning,
        hidden states → (logits (B, n_classes), h1, h2)."""
        u = self.I(torch.cat([x[:, None], m_t, a1_t], dim=1))
        h1 = self.rnn1.cell(h1, u)
        u = u + h1
        h2 = self.rnn2.cell(h2, torch.cat([u, a2_t], dim=1))
        u = u + h2
        u = torch.relu(self.fc1(torch.cat([u, a3_t], dim=1)))
        u = torch.relu(self.fc2(torch.cat([u, a4_t], dim=1)))
        return self.fc3(u), h1, h2


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
    an ``.npz`` export at ``model_fpath`` (which must exist), or else from
    ``seed``; ``load`` swaps them later. The fused sampler runs with bf16
    weights, as the JAX package's kernel does, packed from the model on
    first use (``packed``); ``load`` drops them, so the sampler never runs
    with stale weights."""

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
        if variables is not None:
            load_flax(self.model, variables)
        self.model.to(self.device).eval()
        self.packed: Optional[dict] = None
        if model_fpath is not None:
            self.load(model_fpath, verbose)
        elif variables is None and verbose:
            print("WaveRNN: fresh (untrained) weights")

    def load(self, model_fpath: Union[str, Path], verbose: bool = True) -> None:
        """(Re)load the weights of the ``.npz`` export at ``model_fpath``
        (which must exist) and drop the sampler's packed weights, which are
        packed anew from the new weights on the next sampler call."""
        load_flax(self.model, load_npz(model_fpath))
        self.packed = None
        if verbose:
            print(f"Loaded WaveRNN from {model_fpath}")

    def load_state_dict(self, state: dict) -> None:
        """Take a ``WaveRNN``'s state dict (a trainer's model at a
        checkpoint) and drop the packed weights, as ``load`` does."""
        self.model.load_state_dict(state)
        self.packed = None

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

    def _fold(self, mel_bp: np.ndarray, target: int, overlap: int):
        """mel_bp (B, T+2p, M) → the upsampled conditioning folded on the
        device: mels (B·folds, width, M), aux (B·folds, width, 4·aux_d)."""
        mels_up, aux = self.model.upsample_features(torch.from_numpy(mel_bp).to(self.device))
        starts, width, pad = self._fold_plan(mels_up.shape[1], target, overlap)
        idx = torch.from_numpy(starts[:, None] + np.arange(width)[None, :]).to(self.device)
        mels_up = F.pad(mels_up, (0, 0, 0, pad))
        aux = F.pad(aux, (0, 0, 0, pad))
        b, n = mels_up.shape[0], len(starts)
        return (mels_up[:, idx].reshape(b * n, width, mels_up.shape[-1]),
                aux[:, idx].reshape(b * n, width, aux.shape[-1]))

    @torch.no_grad()
    def _sample(self, mel_bp: np.ndarray, target: int, overlap: int, seed: int,
                greedy: bool) -> np.ndarray:
        """mel_bp (B, T+2p, M) → labels (B, folds, width): upsample → fold
        on the device → the sampler; only the labels come back."""
        with tracing.span("wavernn.fold"):
            mels_f, aux_f = self._fold(mel_bp, target, overlap)
        labels = self._run_sampler(mels_f, aux_f, seed, greedy)
        with tracing.span("wavernn.labels_wait"):
            return labels.reshape(mel_bp.shape[0], -1, labels.shape[-1]).cpu().numpy()

    def _run_sampler(self, mels_f: torch.Tensor, aux_f: torch.Tensor, seed: int,
                     greedy: bool) -> torch.Tensor:
        """The sampler over conditioning (F, T, ·) → labels (F, T), with the
        packed weights (packed on first use). The ``k1.launch`` span's
        ``tensor_core`` is 1 when the launch's products ran on the tensor
        cores, else 0 (the f32 parity mode, the plain version)."""
        with tracing.span("k1.launch") as launch:
            launch.set("F", mels_f.shape[0])
            launch.set("T", mels_f.shape[1])
            if self.packed is None:
                self.packed = pack_wavernn_weights(self.model)
            before = tensor_core_launches()
            labels = wavernn_sample(self.packed, mels_f, aux_f, seed, self.model.n_classes,
                                    greedy=greedy)
            launch.set("tensor_core", tensor_core_launches() - before)
            return labels

    @torch.no_grad()
    def generate(self, mels_f: torch.Tensor, aux_f: torch.Tensor, seed: int = 0,
                 greedy: bool = False, draws=None) -> torch.Tensor:
        """The step-by-step generator over folded conditioning: mels_f
        (F, L, M), aux_f (F, L, 4·aux_d) → samples (F, L) in [-1, 1]. Per
        step: ``gen_step`` on all folds, then a sample fed back — RAW:
        Gumbel-max over the logits (argmax with ``greedy``), mapped to
        [-1, 1]; MOL: ``sample_from_discretized_mix_logistic``. The draws
        come from a generator seeded with ``seed``, or are handed in (the
        JAX package's, for parity): RAW, Gumbel noise (L, F, n_classes);
        MOL, (Gumbel noise (L, F, 10), uniforms (L, F))."""
        model, c = self.model, self.cfg
        n_f, length, _ = mels_f.shape
        d = model.aux_dims
        a1, a2, a3, a4 = (aux_f[..., i * d:(i + 1) * d] for i in range(4))
        gen = torch.Generator(device=mels_f.device).manual_seed(seed) if draws is None else None
        x = mels_f.new_zeros(n_f)
        h1 = h2 = mels_f.new_zeros(n_f, c.rnn_dims)
        out = mels_f.new_empty(n_f, length)
        for t in range(length):
            logits, h1, h2 = model.gen_step(x, mels_f[:, t], a1[:, t], a2[:, t], a3[:, t],
                                            a4[:, t], h1, h2)
            if c.mode == "RAW":
                if not greedy:
                    logits = logits + (draws[t] if draws is not None else -torch.log(-torch.log(
                        torch.rand(logits.shape, generator=gen, device=logits.device)
                        .clamp(min=torch.finfo(logits.dtype).tiny))))
                x = 2.0 * torch.argmax(logits, dim=-1).float() / (model.n_classes - 1.0) - 1.0
            else:
                step_draws = None if draws is None else (draws[0][t][:, None], draws[1][t][:, None])
                x = sample_from_discretized_mix_logistic(logits[:, None, :], gen,
                                                         draws=step_draws)[:, 0]
            out[:, t] = x
        return out

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
                       seed: int = 0, greedy: bool = False,
                       use_sampler: Optional[bool] = None, draws=None,
                       batched: Optional[bool] = None) -> np.ndarray:
        """One mel → waveform. ``use_sampler`` (default: RAW mode) takes the
        fused sampler path; otherwise the step-by-step ``generate`` over
        folds of ``gen_target`` + 2·``gen_overlap`` of the unbucketed mel,
        with ``draws`` handed to it when given. ``batched=False`` (default
        ``cfg.gen_batched``) runs the whole unfolded sequence of the
        unbucketed mel as one fold, through the sampler (one launch at F=1)
        or ``generate``, with no crossfade."""
        cfg = self.cfg
        batched = cfg.gen_batched if batched is None else batched
        if use_sampler is None:
            use_sampler = cfg.mode == "RAW"
        if use_sampler and batched:
            return self.infer_waveform_batch([mel], normalize, target, overlap, seed, greedy)[0]
        target = target or cfg.gen_target
        overlap = overlap or cfg.gen_overlap
        mel = self._prepare(mel, normalize)
        wave_len = (mel.shape[0] - 1) * cfg.hop_size
        mel_p = np.pad(mel, ((cfg.pad, cfg.pad), (0, 0)))[None]
        with torch.no_grad():
            if batched:
                mels_f, aux_f = self._fold(mel_p, target, overlap)
            else:
                mels_f, aux_f = self.model.upsample_features(
                    torch.from_numpy(mel_p).to(self.device))
            if use_sampler:
                labels = self._run_sampler(mels_f, aux_f, seed, greedy)
                samples = 2.0 * labels.double() / (2 ** cfg.bits - 1.0) - 1.0
            else:
                samples = self.generate(mels_f, aux_f, seed, greedy, draws)
        return self._finalize(samples.cpu().numpy().astype(np.float64), overlap, wave_len,
                              batched)

    def infer_waveform_batch(self, mels, normalize: bool = True,
                             target: Optional[int] = None, overlap: Optional[int] = None,
                             seed: int = 0, greedy: bool = False,
                             max_lanes: int = 256) -> list:
        """Batch of mels → list of waveforms. RAW: every utterance's folds of
        a group ride one sampler launch; ``max_lanes`` caps the folds of one
        launch. MOL: ``infer_waveform`` per mel, each with ``seed``, as the
        JAX package does."""
        cfg = self.cfg
        if cfg.mode != "RAW":
            return [self.infer_waveform(m, normalize, target, overlap, seed) for m in mels]
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
            with tracing.span("wavernn.finalize"):
                for lab in labels.astype(np.float64):
                    samples = 2.0 * lab / (2 ** cfg.bits - 1.0) - 1.0
                    out.append(self._finalize(samples, overlap, wave_lens[len(out)]))
        return out

    def _finalize(self, samples: np.ndarray, overlap: int, wave_len: int,
                  batched: bool = True) -> np.ndarray:
        """Crossfade-unfold (the one fold as it is when not ``batched``) +
        mu-law decode (RAW) + de-emphasis + trim + fade-out."""
        cfg = self.cfg
        output = xfade_and_unfold(samples, overlap) if batched else samples[0]
        if cfg.mu_law and cfg.mode == "RAW":
            output = decode_mu_law(output, 2 ** cfg.bits, False)
        if cfg.apply_preemphasis:
            output = inv_preemphasis_np(output, cfg.preemphasis)
        output = output[:wave_len]
        fade = min(len(output), 20 * cfg.hop_size)
        output[-fade:] *= np.linspace(1, 0, fade)
        return output.astype(np.float32)
