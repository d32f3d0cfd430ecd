"""VITS trainer and dataset.

Port of ``mockingbird_tpu/models/vits/train.py``: two AdamW optimizers
(2e-4 decaying by 0.999875 every 1000 updates, betas 0.8/0.99, eps 1e-9,
weight decay 1e-4 as ``optax.adamw`` has it), the losses disc-LSGAN + gen
(adversarial + feature matching + mel L1×45 + KL×1 + duration), G/D
checkpoints, length-bucketed batches with static padded shapes, and the
bf16 ``Policy``. Single process.

One difference by design: the JAX step runs the generator forward twice,
once for the discriminator and once inside the generator's loss, with the
same key and so the same outputs; this step runs it once and reuses it, so
the alignment search (the MAS kernel on the card) runs once per step.
"""
from __future__ import annotations

import random
import time
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from ... import resolve_device, seeded
from ...config import Config
from ...dsp import spec_to_mel_vits, spectrogram_vits
from ...text import text_to_sequence
from ...train.checkpoint import CheckpointManager
from ...train.logging import TrainLogger
from ...train.precision import Policy
from ...train.step import to_device
from ..vocoder.gan_losses import discriminator_loss, feature_loss, generator_loss, kl_loss
from ..vocoder.hifigan import DiscriminatorP, DiscriminatorS, collect, real_and_generated
from .model import init_vits, vits_config
from .modules import slice_segments

C_MEL = 45.0
C_KL = 1.0

# spec-frame-length bucket boundaries
BUCKET_BOUNDARIES = (32, 300, 400, 500, 600, 700, 800, 900, 1000)


class VitsDiscriminator(nn.Module):
    """DiscriminatorS + periods (2, 3, 5, 7, 11). Real and generated audio
    go through each discriminator as one batch."""
    periods = (2, 3, 5, 7, 11)

    def __init__(self):
        super().__init__()
        self.disc_s = DiscriminatorS()
        for p in self.periods:
            self.add_module(f"disc_p{p}", DiscriminatorP(p))

    def forward(self, y, y_hat):
        return collect(real_and_generated(d, y, y_hat) for d in
                       [self.disc_s] + [getattr(self, f"disc_p{p}") for p in self.periods])


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------

class VitsDataset:
    """(text ids, linear spec, wav, sid, emo) tuples from a preprocessed
    synthesizer dir: ``train.txt`` rows ``audio-<spk>_<utt>.npy|...|...|...|
    <used>|<text>``, the audio under ``audio/``, emotion vectors
    ``emo/emo-<spk>_<utt>.npy`` (zeros where missing). Linear specs are
    computed once and cached as ``.spec.npy`` next to the audio."""

    def __init__(self, syn_dir: Path, cfg, cleaner_names=("basic_cleaners",)):
        syn_dir = Path(syn_dir)
        self.cfg = cfg
        self.audio_dir = syn_dir / "audio"
        self.emo_dir = syn_dir / "emo"
        with (syn_dir / "train.txt").open("r", encoding="utf-8") as f:
            rows = [line.strip().split("|") for line in f if line.strip()]
        self.items = []
        speakers = {}
        for r in rows:
            if not int(r[4]):
                continue
            spk = r[0].split("-", 1)[-1].rsplit("_", 1)[0]
            sid = speakers.setdefault(spk, len(speakers))
            self.items.append((r[0], sid, r[5].strip()))
        self.n_speakers = max(len(speakers), 1)
        self.cleaner_names = list(cleaner_names)
        self.lengths = [self._spec_len(i) for i in range(len(self.items))]
        print(f"VITS dataset: {len(self.items)} utts, {self.n_speakers} speakers")

    def _spec_len(self, index) -> int:
        n = np.load(self.audio_dir / self.items[index][0], mmap_mode="r").shape[0]
        return n // self.cfg.hop_size

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        wav_fname, sid, text = self.items[index]
        wav = np.load(self.audio_dir / wav_fname).astype(np.float32)
        spec_path = self.audio_dir / (wav_fname + ".spec.npy")
        if spec_path.exists():
            spec = np.load(spec_path)
        else:
            with torch.no_grad():
                spec = spectrogram_vits(torch.from_numpy(wav), self.cfg.n_fft,
                                        self.cfg.hop_size, self.cfg.win_size).numpy()
            np.save(spec_path, spec)
        emo_path = self.emo_dir / f"emo-{wav_fname.split('-', 1)[-1]}"
        if emo_path.exists():
            emo = np.load(emo_path).astype(np.float32)
        else:
            emo = np.zeros((self.cfg.emotion_channels,), np.float32)
        seq = np.asarray(text_to_sequence(text, self.cleaner_names), np.int32)
        return seq, spec, wav, sid, emo


def _ceil(n, m):
    return ((n + m - 1) // m) * m


class BucketBatcher:
    """Length-bucketed batches with static padded shapes: spec pad = the
    bucket's upper boundary, text pad = ``max(32, ceil16(longest text))``
    of the bucket. Shuffles with ``random.Random(seed)``, as the JAX
    batcher does, so both give the same batches."""

    def __init__(self, dataset: VitsDataset, batch_size: int, boundaries=BUCKET_BOUNDARIES,
                 seed: int = 1234):
        self.dataset = dataset
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.rng = random.Random(seed)
        buckets: List[List[int]] = [[] for _ in range(len(self.boundaries) - 1)]
        for idx, length in enumerate(dataset.lengths):
            for bi in range(len(self.boundaries) - 1):
                if self.boundaries[bi] < length <= self.boundaries[bi + 1]:
                    buckets[bi].append(idx)
                    break
        keep = [i for i, b in enumerate(buckets) if b]
        self.bucket_bounds = [self.boundaries[min(i + 1, len(self.boundaries) - 1)]
                              for i in keep]
        self.buckets = [buckets[i] for i in keep]
        self.bucket_t_text = [
            max(32, _ceil(max(len(text_to_sequence(dataset.items[i][2], dataset.cleaner_names))
                              for i in b), 16))
            for b in self.buckets]

    def __iter__(self):
        batches = []
        for bi, bucket in enumerate(self.buckets):
            order = bucket[:]
            self.rng.shuffle(order)
            for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
                batches.append((bi, order[i:i + self.batch_size]))
        self.rng.shuffle(batches)
        for bi, idxs in batches:
            yield self.collate([self.dataset[i] for i in idxs], bi)

    def __len__(self):
        return sum(len(b) // self.batch_size for b in self.buckets)

    def collate(self, batch, bucket_idx: int) -> dict:
        cfg = self.dataset.cfg
        t_spec = self.bucket_bounds[bucket_idx]
        t_wav = t_spec * cfg.hop_size
        t_text = self.bucket_t_text[bucket_idx]
        b = len(batch)
        texts = np.zeros((b, t_text), np.int32)
        specs = np.zeros((b, t_spec, cfg.spec_channels), np.float32)
        wavs = np.zeros((b, t_wav), np.float32)
        sids = np.zeros((b,), np.int32)
        emos = np.zeros((b, cfg.emotion_channels), np.float32)
        text_l = np.zeros((b,), np.int32)
        spec_l = np.zeros((b,), np.int32)
        for i, (seq, spec, wav, sid, emo) in enumerate(batch):
            texts[i, :len(seq)] = seq
            specs[i, :spec.shape[0]] = spec
            n = min(len(wav), t_wav)
            wavs[i, :n] = wav[:n]
            sids[i] = sid
            emos[i] = emo
            text_l[i] = len(seq)
            spec_l[i] = spec.shape[0]
        return dict(texts=texts, specs=specs, wavs=wavs, sids=sids, emos=emos,
                    text_lengths=text_l, spec_lengths=spec_l)


# ---------------------------------------------------------------------------
# Losses, optimizer, step
# ---------------------------------------------------------------------------

def mel_of(wav, cfg):
    spec = spectrogram_vits(wav, cfg.n_fft, cfg.hop_size, cfg.win_size)
    return spec_to_mel_vits(spec, cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax)


def d_loss_of(disc_out):
    """Discriminator LSGAN loss of ``VitsDiscriminator`` outputs."""
    rs, gs, _, _ = disc_out
    return discriminator_loss(rs, gs)[0]


def g_loss_of(cfg, out, batch, mel_full, disc_fn):
    """The generator's loss of one forward ``out`` of ``Vits``: (total,
    parts). ``disc_fn(y_real, y_hat)`` runs the discriminator."""
    y_hat, l_length, _, ids, _, y_mask, (_, z_p, m_p, logs_p, _, logs_q) = out
    seg_frames = cfg.segment_size // cfg.hop_size
    y_real = slice_segments(batch["wavs"], ids * cfg.hop_size, cfg.segment_size)
    y_mel = slice_segments(mel_full, ids, seg_frames)
    loss_mel = torch.mean(torch.abs(y_mel - mel_of(y_hat, cfg))) * C_MEL
    loss_dur = torch.sum(l_length)
    loss_kl = kl_loss(z_p, logs_q, m_p, logs_p, y_mask) * C_KL
    _, gs, frs, fgs = disc_fn(y_real, y_hat)
    loss_fm = feature_loss(frs, fgs)
    loss_gen, _ = generator_loss(gs)
    total = loss_gen + loss_fm + loss_mel + loss_dur + loss_kl
    return total, dict(mel=loss_mel, dur=loss_dur, kl=loss_kl, fm=loss_fm, adv=loss_gen)


def make_optimizer(params) -> torch.optim.AdamW:
    """``optax.adamw`` with the trainer's settings; ``set_lr`` sets its
    schedule before each update."""
    return torch.optim.AdamW(params, lr=2e-4, betas=(0.8, 0.99), eps=1e-9, weight_decay=1e-4)


def set_lr(opt: torch.optim.Optimizer) -> float:
    """lr = 2e-4 · 0.999875^(count/1000) (not staircase), read at the count
    of updates made before this one, as ``optax.exponential_decay``."""
    state = opt.state.get(opt.param_groups[0]["params"][0], {})
    count = float(state["step"]) if "step" in state else 0.0
    lr = 2e-4 * 0.999875 ** (count / 1000.0)
    for group in opt.param_groups:
        group["lr"] = lr
    return lr


def make_vits_step(model, disc, opt_g, opt_d, cfg, precision: str = "fp32"):
    """One training step ``step(batch, generator)`` → (g_loss, d_loss,
    parts), tensors on the device. ``batch`` is ``to_device`` of a collated
    batch; ``generator`` draws the dropout and the model's noise."""
    policy = Policy.from_name(precision)
    g_params = list(model.parameters())

    def disc_fn(y_r, y_g):
        return policy.apply(disc, y_r, y_g)

    def step(batch, generator):
        mel_full = spec_to_mel_vits(batch["specs"], cfg.sample_rate, cfg.n_fft, cfg.num_mels,
                                    cfg.fmin, cfg.fmax)
        out = policy.apply(model, batch["texts"], batch["text_lengths"], batch["specs"],
                           batch["spec_lengths"], batch["sids"], batch["emos"], train=True,
                           generator=generator)
        y_hat, ids = out[0], out[3]
        y = slice_segments(batch["wavs"], ids * cfg.hop_size, cfg.segment_size)

        d_loss = d_loss_of(disc_fn(y, y_hat.detach()))
        opt_d.zero_grad(set_to_none=True)
        d_loss.backward()
        set_lr(opt_d)
        opt_d.step()

        g_loss, parts = g_loss_of(cfg, out, batch, mel_full, disc_fn)
        opt_g.zero_grad(set_to_none=True)
        g_loss.backward(inputs=g_params)
        set_lr(opt_g)
        opt_g.step()
        return g_loss.detach(), d_loss.detach(), {k: v.detach() for k, v in parts.items()}

    return step


def train(run_id: str, syn_dir: Path, models_dir: Path, cfg=None, batch_size: int = 16,
          total_steps: Optional[int] = None, save_every: int = 2000, log_every: int = 10,
          eval_every: int = 1000, seed: int = 1234, precision: str = "bf16",
          device: Union[str, torch.device] = "cuda"):
    """Train VITS on ``syn_dir`` from weights made from ``seed`` (or resume
    the newest checkpoint under ``models_dir/run_id/ckpt_vits``); saves at
    every ``save_every`` steps (0: never) and at the end."""
    dev = resolve_device(device)
    cfg = Config(vits_config()).merge(cfg or {})
    dataset = VitsDataset(syn_dir, cfg)
    cfg.n_speakers = max(cfg.n_speakers, dataset.n_speakers)

    model = init_vits(seed, cfg).to(dev)
    with seeded(seed + 1):
        disc = VitsDiscriminator().to(dev)
    opt_g, opt_d = make_optimizer(model.parameters()), make_optimizer(disc.parameters())

    ckpt = CheckpointManager(Path(models_dir) / run_id / "ckpt_vits")
    tb = TrainLogger(Path(models_dir) / run_id / "logs_vits")
    step0, restored = ckpt.restore_latest(map_location=dev)
    step = 1
    if step0 is not None:
        model.load_state_dict(restored["g"])
        disc.load_state_dict(restored["d"])
        opt_g.load_state_dict(restored["g_opt"])
        opt_d.load_state_dict(restored["d_opt"])
        step = step0 + 1
        print(f"Resumed VITS at step {step0}")

    def state():
        return {"g": model.state_dict(), "d": disc.state_dict(),
                "g_opt": opt_g.state_dict(), "d_opt": opt_d.state_dict()}

    batcher = BucketBatcher(dataset, batch_size, seed=seed)
    step_fn = make_vits_step(model, disc, opt_g, opt_d, cfg, precision)

    def evaluate(step):
        """Full inference on the first training sample: generated and
        ground-truth audio and mels to the log."""
        seq, spec, wav_gt, sid, emo = dataset[0]
        x = np.zeros((1, _ceil(max(len(seq), 32), 16)), np.int64)
        x[0, :len(seq)] = seq
        with torch.no_grad():
            gen = torch.Generator(device=dev).manual_seed(seed + step)
            o, _, _, y_lengths = model.infer(
                torch.from_numpy(x).to(dev), torch.tensor([len(seq)], device=dev),
                torch.tensor([sid], device=dev), torch.from_numpy(emo[None]).to(dev),
                noise_scale=0.667, length_scale=1.0, noise_scale_w=0.8,
                max_len=cfg.get("eval_max_len", 1000), generator=gen)
            wav_hat = o[0, :int(y_lengths[0]) * cfg.hop_size].float()
            mel_gt = spec_to_mel_vits(torch.from_numpy(spec), cfg.sample_rate, cfg.n_fft,
                                      cfg.num_mels, cfg.fmin, cfg.fmax)
            mel_hat = mel_of(wav_hat, cfg)
        tb.audio(step, "eval/gen_audio", wav_hat.cpu().numpy(), cfg.sample_rate)
        tb.audio(step, "eval/gt_audio", wav_gt, cfg.sample_rate)
        for tag, m in (("eval/mel_gt", mel_gt), ("eval/mel_gen", mel_hat)):
            m = m.cpu().numpy().T
            tb.image(step, tag, (m - m.min()) / max(float(m.max() - m.min()), 1e-6))
        print(f"step {step} | eval: generated {len(wav_hat) / cfg.sample_rate:.2f}s audio")

    generator = torch.Generator(device=dev).manual_seed(seed)
    t0, acc = time.time(), []
    done = False
    while not done:
        n_batches = 0
        for batch in batcher:
            n_batches += 1
            g_loss, d_loss, parts = step_fn(to_device(batch, dev), generator)
            acc.append((float(g_loss), float(d_loss), float(parts["mel"])))
            if step % log_every == 0:
                g, d, m = np.mean(acc, axis=0)
                dt = (time.time() - t0) / len(acc)
                print(f"step {step} | gen {g:.3f} | disc {d:.3f} | mel {m / C_MEL:.4f} "
                      f"| {dt * 1000:.0f} ms/step")
                tb.scalars(step, **{"train/gen": g, "train/disc": d, "train/mel": m / C_MEL,
                                    "train/dur": float(parts["dur"]),
                                    "train/kl": float(parts["kl"]),
                                    "train/ms_per_step": dt * 1000})
                t0, acc = time.time(), []
            if eval_every and step % eval_every == 0:
                evaluate(step)
            if save_every and step % save_every == 0:
                ckpt.save(step, state())
            step += 1
            if total_steps and step > total_steps:
                done = True
                break
        if n_batches == 0:
            raise RuntimeError("no full batches; reduce batch_size")

    ckpt.save(step, state())
    return model, disc
