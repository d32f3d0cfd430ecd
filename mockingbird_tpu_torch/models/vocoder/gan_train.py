"""GAN-vocoder trainer, HiFi-GAN and Fre-GAN.

Port of ``mockingbird_tpu/models/vocoder/gan_train.py``: two AdamW
optimizers as ``optax.adamw(schedule, b1=0.8, b2=0.99)`` has them (eps
1e-8, weight decay 1e-4 on every leaf), each with the continuous schedule
lr · 0.999^(count/1000) of its own count of updates; the losses L1 mel ×45
(or Fre-GAN's multi-resolution STFT loss × ``lambda_aux`` with
``use_stft_loss``) + LSGAN adversarial + feature matching, the
discriminators joining from ``disc_start_step``; checkpoints of
{"g", "d", "g_opt", "d_opt"} with resume; validation on fixed segment
crops; the bf16 ``Policy``.

One step: the discriminators update on (y, ŷ.detach()) with ``train=True``
(the spectral-norm statistics move); the generator's loss then runs them
with the updated parameters and statistics and ``train=False`` (the power
iteration runs, nothing is stored). One difference by design: the JAX step
runs the generator forward twice, outside and inside its loss, on the same
parameters; this step runs it once and reuses it.

Data parallel across processes (``parallel.multihost``): every rank builds
the same global batch and takes its rows, each gradient is averaged over
ranks before its update (the STFT loss's norms are the global batch's),
and rank 0 alone validates, logs and checkpoints.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ... import resolve_device, seeded
from ...config import Config
from ...dsp import spec_to_mel_vits, spectrogram_vits
from ...parallel import multihost
from ...train.checkpoint import CheckpointManager
from ...train.logging import TrainLogger
from ...train.precision import Policy
from ...train.step import to_device
from ..tacotron.dataset import DataLoader
from .dataset import MelDataset, collate_gan, get_dataset_filelist
from .fregan import FreGanDiscriminators, FreGanGenerator, fregan_config
from .gan_losses import (discriminator_loss, feature_loss, generator_loss,
                         multi_resolution_stft_loss)
from .hifigan import Generator as HifiGenerator, HifiganDiscriminators, hifigan_config

ARCHS = {
    "hifigan": (HifiGenerator, HifiganDiscriminators, hifigan_config),
    "fregan": (FreGanGenerator, FreGanDiscriminators, fregan_config),
}
C_MEL = 45.0


def mel_loss_fn(wav: torch.Tensor, cfg) -> torch.Tensor:
    """The log-mel of a wav (B, T) for the L1 mel loss, on its device."""
    fmax = cfg.get("fmax_for_loss") or None
    spec = spectrogram_vits(wav, cfg.n_fft, cfg.hop_size, cfg.win_size)
    return spec_to_mel_vits(spec, cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, fmax)


def make_optimizer(params, cfg) -> torch.optim.AdamW:
    """``optax.adamw(schedule, b1, b2)`` with optax's defaults; ``set_lr``
    sets the schedule's rate before each update."""
    return torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(cfg.adam_b1, cfg.adam_b2),
                             eps=1e-8, weight_decay=1e-4)


def _lr_schedule(cfg):
    """``optax.exponential_decay(lr, 1000, lr_decay)``, not staircase: the
    reference decays once per epoch, whose length depends on the data, so
    the JAX package decays smoothly per 1000 updates instead."""
    return lambda count: cfg.learning_rate * cfg.lr_decay ** (count / 1000.0)


def set_lr(opt: torch.optim.Optimizer, schedule) -> float:
    """The schedule's rate at the count of updates ``opt`` has made."""
    state = opt.state.get(opt.param_groups[0]["params"][0], {})
    lr = schedule(float(state["step"]) if "step" in state else 0.0)
    for group in opt.param_groups:
        group["lr"] = lr
    return lr


def make_gan_step(gen, disc, opt_g, opt_d, cfg, precision: str = "fp32"):
    """One training step ``step(batch, disc_active=True)`` → (generator
    loss, discriminator loss, mel term), tensors on the device. ``batch``
    holds ``mels`` (B, frames, M) and ``wavs`` (B, segment) on the device.
    Without ``disc_active`` the discriminators neither run nor update and
    the generator's loss is the mel term."""
    policy = Policy.from_name(precision)
    schedule = _lr_schedule(cfg)
    g_params = list(gen.parameters())
    d_params = list(disc.parameters())

    def step(batch, disc_active: bool = True):
        mels, y = batch["mels"], batch["wavs"]
        with multihost.sharded():
            y_hat = policy.apply(gen, mels)

            if disc_active:
                mpd, msd = policy.apply(disc, y, y_hat.detach(), True)
                d_loss = (discriminator_loss(mpd[0], mpd[1])[0]
                          + discriminator_loss(msd[0], msd[1])[0])
                opt_d.zero_grad(set_to_none=True)
                d_loss.backward()
                multihost.average_gradients(d_params)
                set_lr(opt_d, schedule)
                opt_d.step()
            else:
                d_loss = torch.zeros((), device=y.device)

            if cfg.get("use_stft_loss", False):
                sc, mag = multi_resolution_stft_loss(y_hat, y)
                loss_mel = cfg.get("lambda_aux", 45.0) * (sc + mag)
            else:
                loss_mel = torch.mean(torch.abs(mel_loss_fn(y, cfg)
                                                - mel_loss_fn(y_hat, cfg))) * C_MEL
            g_loss = loss_mel
            if disc_active:
                mpd, msd = policy.apply(disc, y, y_hat, False)
                g_loss = (loss_mel + feature_loss(mpd[2], mpd[3]) + feature_loss(msd[2], msd[3])
                          + generator_loss(mpd[1])[0] + generator_loss(msd[1])[0])
            opt_g.zero_grad(set_to_none=True)
            g_loss.backward(inputs=g_params)
            multihost.average_gradients(g_params)
            set_lr(opt_g, schedule)
            opt_g.step()
        losses = multihost.mean_over_ranks(
            torch.stack([t.detach().float() for t in (g_loss, d_loss, loss_mel)]))
        return losses[0], losses[1], losses[2]

    return step


def train(run_id: str, syn_dir: Path, models_dir: Path, arch: str = "hifigan",
          fine_tuning: bool = False, total_steps: Optional[int] = None,
          save_every: int = 5000, log_every: int = 10, val_every: int = 1000,
          cfg=None, seed: int = 1234, precision: str = "bf16",
          device: Union[str, torch.device] = "cuda"):
    """Train ``arch`` ("hifigan" or "fregan") on ``syn_dir`` (``train.txt``,
    ``audio/``, and ``mels_gta/`` when ``fine_tuning``) from weights made
    from ``seed``, or resume the newest checkpoint under
    ``models_dir/run_id/ckpt_<arch>``; validates every ``val_every`` steps,
    saves every ``save_every`` steps (0: never) and at the end. Returns
    (generator, discriminators). Data parallel under the ``MB_*``
    environment (``parallel.multihost``): ``cfg.batch_size`` is the global
    batch, split across the ranks."""
    multihost.initialize_from_env(device)
    dev = multihost.rank_device(resolve_device(device))
    gen_cls, disc_cls, cfg_fn = ARCHS[arch]
    cfg = Config(cfg_fn()).merge(cfg or {})
    with seeded(seed):
        gen = gen_cls(cfg).to(dev)
    with seeded(seed + 1):
        disc = disc_cls().to(dev)
    opt_g, opt_d = make_optimizer(gen.parameters(), cfg), make_optimizer(disc.parameters(), cfg)

    model_dir = Path(models_dir) / run_id
    ckpt = CheckpointManager(model_dir / f"ckpt_{arch}")
    tb = TrainLogger(model_dir / f"logs_{arch}")
    step0, restored = ckpt.restore_latest(map_location=dev)
    step = 1
    if step0 is not None:
        gen.load_state_dict(restored["g"])
        disc.load_state_dict(restored["d"])
        opt_g.load_state_dict(restored["g_opt"])
        opt_d.load_state_dict(restored["d_opt"])
        step = step0 + 1
        print(f"Resumed {arch} at step {step0}")
    multihost.make_global(gen, disc, opt_g, opt_d)

    def state():
        return {"g": gen.state_dict(), "d": disc.state_dict(),
                "g_opt": opt_g.state_dict(), "d_opt": opt_d.state_dict()}

    train_files, val_files = get_dataset_filelist(syn_dir)
    dataset = MelDataset(train_files, cfg, syn_dir=syn_dir, fine_tuning=fine_tuning, seed=seed)
    loader = DataLoader(dataset, cfg.batch_size, collate_gan, seed=seed)
    # validation: the held-out mel error on fixed segment crops (at most 4
    # batches, the index taken modulo the set) and the first generated wav
    val_dataset = MelDataset(val_files, cfg, syn_dir=syn_dir, fine_tuning=fine_tuning,
                             split=True, seed=seed)

    def validate(step):
        n = len(val_dataset)
        if n == 0:
            return
        b = cfg.batch_size
        errs, first_audio = [], None
        with torch.no_grad():
            for bi in range(min(4, max(1, n // b))):
                vb = to_device(collate_gan([val_dataset[(bi * b + j) % n] for j in range(b)]),
                               dev)
                y_hat = gen(vb["mels"])
                errs.append(float(torch.mean(torch.abs(mel_loss_fn(vb["wavs"], cfg)
                                                       - mel_loss_fn(y_hat, cfg)))))
                if first_audio is None:
                    first_audio = y_hat[0].float().cpu().numpy()
        tb.scalars(step, **{"val/mel_err": float(np.mean(errs))})
        tb.audio(step, "val/gen_audio", first_audio, cfg.sample_rate)
        print(f"step {step} | val mel err {np.mean(errs):.4f}")

    step_fn = make_gan_step(gen, disc, opt_g, opt_d, cfg, precision)
    t0, accs = time.time(), []
    done = False
    while not done:
        for batch in loader:
            batch = multihost.shard_global_batch(batch)
            g_loss, d_loss, mel_l = step_fn(to_device(batch, dev),
                                            disc_active=step >= cfg.disc_start_step)
            accs.append((float(g_loss), float(d_loss), float(mel_l)))
            if step % log_every == 0:
                g, d, ml = np.mean(accs, axis=0)
                dt = (time.time() - t0) / len(accs)
                print(f"step {step} | gen {g:.3f} | disc {d:.3f} | mel {ml / C_MEL:.4f} | "
                      f"{dt * 1000:.0f} ms/step")
                tb.scalars(step, **{"train/gen": g, "train/disc": d, "train/mel": ml / C_MEL,
                                    "train/ms_per_step": dt * 1000})
                t0, accs = time.time(), []
            if val_every and step % val_every == 0 and multihost.is_primary():
                validate(step)
            if save_every and step % save_every == 0:
                ckpt.save(step, state())
                multihost.barrier()
            step += 1
            if total_steps and step > total_steps:
                done = True
                break
        if len(loader) == 0:
            raise RuntimeError("dataset smaller than one batch")

    ckpt.save(step, state(), force=True)
    multihost.barrier()
    return gen, disc
