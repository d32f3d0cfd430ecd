"""WaveRNN dataset and trainer.

Port of ``mockingbird_tpu/models/vocoder/wavernn_train.py``: GTA (or
ground-truth) mel + wav pairs (pre-emphasis, clip, mu-law or linear label
quantisation), random aligned windows from ``random.Random(seed)`` in the
JAX package's order, Adam 1e-4 with cross-entropy (RAW) or the discretized
mixture-of-logistics loss (MOL), the bf16 ``Policy``, checkpoints with
resume, and at every checkpoint ``gen_testset``: ground-truth and generated
wavs of the first utterances, the RAW ones through the fused sampler.

``remat=True`` (on by itself from batch 192) recomputes the GRUs in the
backward and takes the FC head and loss in checkpointed time chunks of
``head_chunk`` steps, so the (B, T, n_classes) logits are never held whole.
Data parallel across processes (``parallel.multihost``): every rank builds
the same global batch and takes its rows, the BatchNorms see the global
batch, the gradients are averaged over ranks, and rank 0 alone logs,
checkpoints and runs ``gen_testset``.
"""
from __future__ import annotations

import random
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ... import resolve_device, seeded
from ...config import Config
from ...dsp import (decode_mu_law, encode_mu_law, float_2_label, label_2_float, preemphasis_np,
                    save_wav)
from ...parallel import multihost
from ...train.checkpoint import CheckpointManager
from ...train.logging import TrainLogger
from ...train.precision import Policy
from ...train.step import to_device
from ..tacotron.dataset import DataLoader
from .distribution import discretized_mix_logistic_loss
from .wavernn import WaveRNN, WaveRnnVocoder, wavernn_config


class WaveRnnDataset:
    """(mel (M, T) scaled to ±1, labels (T·hop,) int64) of every utterance
    ``train.txt`` marks as used: mels from ``mel_dir`` (GTA or ground
    truth), wavs from ``wav_dir``."""

    def __init__(self, metadata_fpath: Path, mel_dir: Path, wav_dir: Path, cfg):
        with Path(metadata_fpath).open("r") as f:
            metadata = [line.split("|") for line in f if line.strip()]
        used = [x for x in metadata if int(x[4])]
        self.samples = [(Path(mel_dir) / x[1], Path(wav_dir) / x[0]) for x in used]
        self.cfg = cfg
        print(f"Found {len(self.samples)} vocoder samples")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        cfg = self.cfg
        mel_path, wav_path = self.samples[index]
        mel = np.load(mel_path).astype(np.float32)
        if mel.shape[0] != cfg.feat_dims:
            mel = mel.T                                   # (M, T)
        mel = mel / cfg.mel_max_abs_value

        wav = np.load(wav_path)
        if cfg.apply_preemphasis:
            wav = preemphasis_np(wav, cfg.preemphasis)
        wav = np.clip(wav, -1, 1)
        r_pad = (len(wav) // cfg.hop_size + 1) * cfg.hop_size - len(wav)
        wav = np.pad(wav, (0, r_pad))[: mel.shape[1] * cfg.hop_size]

        if cfg.mode == "RAW":
            quant = (encode_mu_law(wav, mu=2 ** cfg.bits) if cfg.mu_law
                     else float_2_label(wav, bits=cfg.bits))
        else:
            quant = float_2_label(wav, bits=16)
        return mel.astype(np.float32), quant.astype(np.int64)


def collate_wavernn(batch, cfg, rng: Optional[random.Random] = None) -> dict:
    """Random aligned (mel window, label window) crops → x (B, seq_len) in
    [-1, 1], y (B, seq_len) labels (RAW, int32) or samples (MOL, float32),
    mels (B, seq_len/hop + 2·pad, M)."""
    rng = rng or random
    mel_win = cfg.seq_len // cfg.hop_size + 2 * cfg.pad
    mels, labels = [], []
    for mel, quant in batch:
        max_offset = mel.shape[-1] - 2 - (mel_win + 2 * cfg.pad)
        mel_offset = rng.randint(0, max(max_offset, 1) - 1) if max_offset > 1 else 0
        sig_offset = (mel_offset + cfg.pad) * cfg.hop_size
        mels.append(mel[:, mel_offset : mel_offset + mel_win])
        lab = quant[sig_offset : sig_offset + cfg.seq_len + 1]
        if len(lab) < cfg.seq_len + 1:
            lab = np.pad(lab, (0, cfg.seq_len + 1 - len(lab)))
        labels.append(lab)
    mels = np.stack(mels).astype(np.float32).transpose(0, 2, 1)
    labels = np.stack(labels).astype(np.int32)

    bits = 16 if cfg.mode == "MOL" else cfg.bits
    x = label_2_float(labels[:, : cfg.seq_len].astype(np.float32), bits)
    y = labels[:, 1:]
    if cfg.mode == "MOL":
        y = label_2_float(y.astype(np.float32), bits)
    return dict(x=x.astype(np.float32), y=y, mels=mels)


def make_wavernn_step(model: WaveRNN, opt: torch.optim.Optimizer, mode: str,
                      precision: str = "fp32", remat: bool = False, head_chunk: int = 128):
    """One training step ``step(batch)`` → the loss (a tensor on the
    device): the forward in ``model``'s mode (``train()``: the BatchNorms'
    running statistics move), the mean negative log-likelihood, backward,
    ``opt``. ``batch`` is ``to_device`` of a collated batch. ``remat``
    (pair with ``cfg.remat``, which recomputes the GRUs) computes the head
    and loss per ``head_chunk`` steps under ``torch.utils.checkpoint``: the
    tail is padded with class 0 and masked out, and the loss is the sum
    over ``y.numel()``."""
    policy = Policy.from_name(precision)

    def nll(logits, y):
        """Per-element negative log-likelihood (B, T)."""
        if mode == "RAW":
            return F.cross_entropy(logits.transpose(1, 2), y, reduction="none")
        return discretized_mix_logistic_loss(logits, y[..., None], reduce=False)[..., 0]

    def chunk_loss(h, a3, a4, y, mask):
        # flax receives h, a3 and a4 uncast here: keyword arguments pass as they are
        logits = policy.apply(model, method="head", h=h, a3=a3, a4=a4)
        return (nll(logits, y) * mask[None, :]).sum()

    def loss_of(batch):
        x, mels, y = batch["x"], batch["mels"], batch["y"]
        if not remat:
            return torch.mean(nll(policy.apply(model, x, mels), y))
        h, a3, a4 = policy.apply(model, x, mels, method="features")
        t = y.shape[1]
        ck = min(head_chunk, t)
        n_chunks = -(-t // ck)
        pad = n_chunks * ck - t
        if pad:
            h, a3, a4 = (F.pad(v, (0, 0, 0, pad)) for v in (h, a3, a4))
            y = F.pad(y, (0, pad))
        mask = (torch.arange(n_chunks * ck, device=y.device) < t).float()
        total = 0.0
        for i in range(0, n_chunks * ck, ck):
            sl = slice(i, i + ck)
            total = total + checkpoint(chunk_loss, h[:, sl], a3[:, sl], a4[:, sl], y[:, sl],
                                       mask[sl], use_reentrant=False)
        return total / batch["y"].numel()

    params = list(model.parameters())

    def step(batch):
        with multihost.sharded():
            loss = loss_of(batch)
            opt.zero_grad(set_to_none=True)
            loss.backward()
        multihost.average_gradients(params)
        opt.step()
        return multihost.mean_over_ranks(loss.detach())

    return step


def gen_testset(model: WaveRNN, dataset: WaveRnnDataset, save_path: Path, cfg,
                samples: int = 2, step: int = 0, tb: Optional[TrainLogger] = None,
                vocoder: Optional[WaveRnnVocoder] = None,
                batched: Optional[bool] = None) -> WaveRnnVocoder:
    """Ground-truth and generated wavs of the first ``samples`` utterances of
    ``dataset`` into ``save_path`` (and to ``tb``), generated with
    ``model``'s weights as they are now: ``vocoder`` (made on ``model``'s
    device when None) takes them, and drops the sampler weights it packed
    from an earlier checkpoint. RAW mode samples through the fused sampler
    (one launch per utterance; with ``batched=False``, default
    ``cfg.gen_batched``, one fold of the whole utterance), MOL through the
    step-by-step generator. Returns the vocoder, for the next checkpoint."""
    if vocoder is None:
        vocoder = WaveRnnVocoder(cfg=cfg, verbose=False, device=next(model.parameters()).device)
    vocoder.load_state_dict(model.state_dict())
    save_path = Path(save_path)
    save_path.mkdir(parents=True, exist_ok=True)
    batched = cfg.gen_batched if batched is None else batched
    gen_str = (f"gen_batched_target{cfg.gen_target}_overlap{cfg.gen_overlap}" if batched
               else "gen_not_batched")
    bits = 16 if cfg.mode == "MOL" else cfg.bits
    for i in range(min(samples, len(dataset))):
        mel, quant = dataset[i]
        if cfg.mu_law and cfg.mode != "MOL":
            gt = decode_mu_law(quant, 2 ** bits, from_labels=True)
        else:
            gt = label_2_float(quant.astype(np.float32), bits)
        save_wav(gt.astype(np.float32), save_path / f"{step}_steps_{i}_target.wav",
                 cfg.sample_rate)
        # the dataset's mels are already ±1
        wav = vocoder.infer_waveform(mel, normalize=False, batched=batched)
        save_wav(wav, save_path / f"{step}_steps_{i}_{gen_str}.wav", cfg.sample_rate)
        if tb is not None:
            tb.audio(step, f"gen/sample_{i}", wav, cfg.sample_rate)
    return vocoder


def train(run_id: str, syn_dir: Path, models_dir: Path, ground_truth: bool = False,
          total_steps: Optional[int] = None, save_every: int = 1000, log_every: int = 10,
          cfg=None, seed: int = 0, gen_samples: int = 2, precision: str = "bf16",
          remat: Optional[bool] = None, device: Union[str, torch.device] = "cuda") -> WaveRNN:
    """Train WaveRNN on ``syn_dir`` (``train.txt``, ``audio/``, ``mels_gta/``
    or with ``ground_truth`` ``mels/``) from weights made from ``seed``, or
    resume the newest checkpoint under ``models_dir/run_id/ckpt_wavernn``;
    saves every ``save_every`` steps (0: never), each save followed by
    ``gen_testset`` of ``gen_samples`` utterances into
    ``models_dir/run_id/samples_wavernn``, and at the end. Data parallel
    under the ``MB_*`` environment (``parallel.multihost``): ``batch_size``
    is the global batch, split across the ranks."""
    multihost.initialize_from_env(device)
    dev = multihost.rank_device(resolve_device(device))
    syn_dir = Path(syn_dir)
    cfg = Config(wavernn_config()).merge(cfg or {})
    # the plain step's (B, T, ·) GRU activations and (B, T, n_classes)
    # logits outgrow one card past batch ~192
    if remat is None:
        remat = bool(cfg.batch_size >= 192)
    cfg.merge(dict(remat=remat))
    with seeded(seed):
        model = WaveRNN(cfg)
    model.to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)

    mel_dir = syn_dir / ("mels" if ground_truth else "mels_gta")
    dataset = WaveRnnDataset(syn_dir / "train.txt", mel_dir, syn_dir / "audio", cfg)

    run_dir = Path(models_dir) / run_id
    ckpt = CheckpointManager(run_dir / "ckpt_wavernn")
    tb = TrainLogger(run_dir / "logs_wavernn")
    step0, restored = ckpt.restore_latest(map_location=dev)
    step = 1
    if step0 is not None:
        model.load_state_dict(restored["model"])
        opt.load_state_dict(restored["opt"])
        step = step0 + 1
        print(f"Resumed WaveRNN at step {step0}")
    multihost.make_global(model, opt)

    rng = random.Random(seed)
    loader = DataLoader(dataset, cfg.batch_size, lambda b: collate_wavernn(b, cfg, rng),
                        seed=seed)
    step_fn = make_wavernn_step(model, opt, cfg.mode, precision, remat=remat)
    vocoder = None

    t0, acc = time.time(), []
    done = False
    while not done:
        for batch in loader:
            batch = multihost.shard_global_batch(batch)
            acc.append(float(step_fn(to_device(batch, dev))))
            if step % log_every == 0:
                dt = (time.time() - t0) / len(acc)
                print(f"step {step} | loss {np.mean(acc):.4f} | {dt * 1000:.0f} ms/step")
                tb.scalars(step, **{"train/loss": float(np.mean(acc)),
                                    "train/ms_per_step": dt * 1000})
                t0, acc = time.time(), []
            if save_every and step % save_every == 0:
                ckpt.save(step, {"model": model.state_dict(), "opt": opt.state_dict()})
                if gen_samples and multihost.is_primary():
                    vocoder = gen_testset(model, dataset, run_dir / "samples_wavernn", cfg,
                                          samples=gen_samples, step=step, tb=tb, vocoder=vocoder)
                multihost.barrier()
            step += 1
            if total_steps and step > total_steps:
                done = True
                break
        if len(loader) == 0:
            raise RuntimeError("dataset smaller than one batch")
    ckpt.save(step, {"model": model.state_dict(), "opt": opt.state_dict()}, force=True)
    multihost.barrier()
    return model
