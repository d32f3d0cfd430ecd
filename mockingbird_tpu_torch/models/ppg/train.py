"""One-shot VC trainer (ppg2mel) and its data pipeline.

Port of ``mockingbird_tpu/models/ppg/train.py``: ``OneshotVcDataset`` joins
{PPG, lf0/uv, mel, speaker d-vector} per utterance of a preprocessed VC
directory (``convert.preprocess_vc_dataset``), ``collate_vc`` pads a batch
to a bucket of frames with stop targets, the loss is the masked mel MSE of
the decoder and of the postnet plus the stop BCE, and the optimizer is
optax's chain of ``clip_by_global_norm(5)`` and ``adamw`` (weight decay
1e-4) under ``warmup_cosine_decay_schedule(0, lr, 1000, 500_000)``, from
``train.optim``: the first update runs at a learning rate of 0.

The training forward is ``model.train()`` (``ppg2mel.py``): attention and
postnet dropout, flax's training BatchNorm. Its draws come from one
``torch.Generator`` per (seed, step), as the Tacotron trainer keys them,
where JAX folds the step into its key. Under bf16 the model computes as the
JAX step's ``Policy`` casts it and the loss is f32.

Validation (``make_vc_val_fn``) runs in eval mode, as JAX's ``train=False``;
the prenet's dropout, which is on at inference too, still draws there: JAX
passes ``PRNGKey(0)``, the port a fixed ``Generator`` seeded with 0.

Data parallel across processes (``parallel.multihost``): every rank builds
the same global batch and takes its rows; the dropout draws, the postnet's
BatchNorm statistics and the masked MSE's count are the global batch's; the
gradients are averaged over ranks before the clip; rank 0 alone validates,
logs and checkpoints.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ... import resolve_device, seeded
from ...config import Config
from ...parallel import multihost
from ...train.checkpoint import CheckpointManager
from ...train.logging import TrainLogger
from ...train.optim import adamw, clip_by_global_norm, warmup_cosine_decay
from ...train.precision import Policy
from ...train.step import step_generator, to_device
from ...train.visualizations import have_matplotlib, plot_alignment
from ..tacotron.dataset import DataLoader
from ..vits.modules import sequence_mask
from .ppg2mel import MelDecoderMOLv2, ppg2mel_config


class OneshotVcDataset:
    """fid → (ppg, lf0_uv, mel, spk_embed) from a preprocessed VC directory
    (``bnf/ f0/ embed/ mel/`` and ``<split>_fidlist.txt``)."""

    def __init__(self, vc_dir: Path, split: str = "train"):
        vc_dir = Path(vc_dir)
        self.bnf_dir = vc_dir / "bnf"
        self.f0_dir = vc_dir / "f0"
        self.embed_dir = vc_dir / "embed"
        self.mel_dir = vc_dir / "mel"
        with (vc_dir / f"{split}_fidlist.txt").open() as f:
            self.fids = [line.strip() for line in f if line.strip()]
        print(f"VC dataset [{split}]: {len(self.fids)} utterances")

    def __len__(self):
        return len(self.fids)

    def __getitem__(self, index):
        fid = self.fids[index]
        ppg = np.load(self.bnf_dir / f"{fid}.npy").astype(np.float32)
        lf0_uv = np.load(self.f0_dir / f"{fid}.npy").astype(np.float32)
        mel = np.load(self.mel_dir / f"{fid}.npy").astype(np.float32)
        embed = np.load(self.embed_dir / f"{fid}.npy").astype(np.float32)
        n = min(len(ppg), len(lf0_uv), len(mel))        # the three may differ by a frame
        return ppg[:n], lf0_uv[:n], mel[:n], embed


def collate_vc(batch, frames_per_step: int = 2, down: int = 4, bucket: int = 64) -> dict:
    """Pad to a multiple of ``bucket`` frames, then of lcm(frames_per_step,
    down); stop targets 1 from ``frames_per_step`` frames before each end."""
    n_max = max(x[0].shape[0] for x in batch)
    lcm = int(np.lcm(frames_per_step, down))
    n_pad = ((n_max + bucket - 1) // bucket) * bucket
    n_pad = ((n_pad + lcm - 1) // lcm) * lcm
    b = len(batch)
    ppgs = np.zeros((b, n_pad, batch[0][0].shape[1]), np.float32)
    lf0s = np.zeros((b, n_pad, 2), np.float32)
    mels = np.zeros((b, n_pad, batch[0][2].shape[1]), np.float32)
    stops = np.ones((b, n_pad), np.float32)
    embeds = np.zeros((b, batch[0][3].shape[-1]), np.float32)
    lengths = np.zeros((b,), np.int32)
    for i, (ppg, lf0, mel, emb) in enumerate(batch):
        n = ppg.shape[0]
        ppgs[i, :n] = ppg
        lf0s[i, :n] = lf0
        mels[i, :n] = mel
        stops[i, : max(n - frames_per_step, 0)] = 0.0
        embeds[i] = emb
        lengths[i] = n
    return dict(ppgs=ppgs, lf0s=lf0s, mels=mels, stops=stops, embeds=embeds,
                lengths=lengths)


def masked_mse(pred, target, mask):
    return (torch.sum(((pred - target) ** 2) * mask)
            / multihost.global_count(torch.sum(mask), minimum=1.0))


def mel_loss(out, batch):
    """Masked MSE of the decoder's and the postnet's mels."""
    mel, post = out[0], out[1]
    mask = sequence_mask(batch["lengths"], batch["mels"].shape[1])[..., None]
    return masked_mse(mel, batch["mels"], mask) + masked_mse(post, batch["mels"], mask)


def vc_loss(out, batch):
    """(mel loss + stop BCE, mel loss, stop BCE), in f32."""
    l_mel = mel_loss(out, batch)
    eps = 1e-7
    s = torch.clamp(torch.sigmoid(out[2]), eps, 1 - eps)
    st = batch["stops"]
    l_stop = -torch.mean(st * torch.log(s) + (1 - st) * torch.log(1 - s))
    return l_mel + l_stop, l_mel, l_stop


def make_optimizer(model: torch.nn.Module, learning_rate: float):
    """(AdamW, its ``LambdaLR``): ``optax.adamw(warmup_cosine_decay_schedule(0,
    learning_rate, 1000, 500_000))``; step the scheduler once after every
    ``opt.step()``."""
    opt = adamw(model.parameters(), learning_rate)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, warmup_cosine_decay(1000, 500_000))


def make_vc_step(model: MelDecoderMOLv2, opt: torch.optim.Optimizer, scheduler,
                 precision: str = "fp32"):
    """One training step ``step(batch, generator, masks=None)`` → (loss,
    mel loss, stop loss), tensors on the device: the training forward
    (``model`` in training mode) in the policy's dtype, the loss, backward,
    the clip at 5, the optimizer and the scheduler. ``batch`` is
    ``to_device`` of a ``collate_vc`` batch; ``masks`` hands the dropout
    draws in (``MelDecoderMOLv2.forward``)."""
    policy = Policy.from_name(precision)
    params = list(model.parameters())

    def step(batch, generator=None, masks=None):
        with multihost.sharded():
            out = policy.apply(model, batch["ppgs"], batch["lengths"], batch["mels"],
                               batch["lengths"], batch["lf0s"], batch["embeds"],
                               generator=generator, masks=masks)
            loss, l_mel, l_stop = vc_loss(out, batch)
            opt.zero_grad(set_to_none=True)
            loss.backward()
        multihost.average_gradients(params)
        clip_by_global_norm([p.grad for p in params], 5.0)
        opt.step()
        scheduler.step()
        losses = multihost.mean_over_ranks(
            torch.stack([t.detach().float() for t in (loss, l_mel, l_stop)]))
        return losses[0], losses[1], losses[2]

    return step


def make_vc_val_fn(model: MelDecoderMOLv2):
    """``val(batch)`` → (masked mel loss, alignments): the eval-mode forward
    in f32 (running BatchNorm statistics, no attention or postnet dropout);
    the prenet's dropout draws from a ``Generator`` seeded with 0, where
    JAX's validation passes ``PRNGKey(0)``. The model's mode is restored."""

    @torch.no_grad()
    def val(batch):
        was_training = model.training
        model.eval()
        try:
            gen = torch.Generator(device=batch["mels"].device).manual_seed(0)
            out = model(batch["ppgs"], batch["lengths"], batch["mels"], batch["lengths"],
                        batch["lf0s"], batch["embeds"], generator=gen)
        finally:
            model.train(was_training)
        return mel_loss(out, batch), out[3]

    return val


def train(run_id: str, vc_dir: Path, models_dir: Path, cfg=None,
          batch_size: int = 8, learning_rate: float = 5e-4,
          total_steps: Optional[int] = None, save_every: int = 2000,
          log_every: int = 10, val_every: int = 500, seed: int = 0,
          precision: str = "bf16",
          device: Union[str, torch.device] = "cuda") -> MelDecoderMOLv2:
    """Train ppg2mel on the preprocessed ``vc_dir`` from weights made from
    ``seed``, or resume the newest checkpoint under
    ``models_dir/run_id/ckpt_ppg2mel``. Every ``val_every`` steps the dev
    split (when ``dev_fidlist.txt`` exists) is scored on up to 4 batches,
    its first attention map drawn under ``attn/``, and the best dev loss
    checkpointed under ``ckpt_ppg2mel_best``; checkpoints every
    ``save_every`` steps and at the end. Data parallel under the ``MB_*``
    environment (``parallel.multihost``): ``batch_size`` is the global
    batch, split across the ranks."""
    multihost.initialize_from_env(device)
    dev = multihost.rank_device(resolve_device(device))
    cfg = Config(ppg2mel_config()).merge(cfg or {})
    with seeded(seed):
        model = MelDecoderMOLv2(cfg)
    model.to(dev).train()
    opt, sched = make_optimizer(model, learning_rate)

    run_dir = Path(models_dir) / run_id
    ckpt = CheckpointManager(run_dir / "ckpt_ppg2mel")
    tb = TrainLogger(run_dir / "logs_ppg2mel")
    step0, state = ckpt.restore_latest(map_location=dev)
    step = 1
    if step0 is not None:
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["opt"])
        sched.load_state_dict(state["sched"])
        step = step0 + 1
        print(f"Resumed ppg2mel at step {step0}")
    multihost.make_global(model, opt)

    def state_now():
        return {"model": model.state_dict(), "opt": opt.state_dict(),
                "sched": sched.state_dict()}

    dataset = OneshotVcDataset(vc_dir, "train")
    down = int(np.prod(cfg.encoder_downsample_rates))
    loader = DataLoader(dataset, batch_size,
                        lambda b: collate_vc(b, cfg.frames_per_step, down), seed=seed)
    if len(loader) == 0:
        raise RuntimeError("dataset smaller than one batch")
    step_fn = make_vc_step(model, opt, sched, precision)

    dev_set = (OneshotVcDataset(vc_dir, "dev")
               if (Path(vc_dir) / "dev_fidlist.txt").exists() else None)
    val_fn = make_vc_val_fn(model)
    best_ckpt = CheckpointManager(run_dir / "ckpt_ppg2mel_best")
    best_loss = np.inf
    attn_dir = run_dir / "attn"

    def validate(step):
        nonlocal best_loss
        if dev_set is None or len(dev_set) == 0:
            return
        losses, first_attn = [], None
        n = min(len(dev_set), 4 * batch_size)
        for i0 in range(0, n, batch_size):
            vb = collate_vc([dev_set[j] for j in range(i0, min(i0 + batch_size, n))],
                            cfg.frames_per_step, down)
            loss, aligns = val_fn(to_device(vb, dev))
            losses.append(float(loss))
            if first_attn is None:
                first_attn = aligns[0].cpu().numpy()
        v = float(np.mean(losses))
        print(f"step {step} | dev mel loss {v:.4f}" + (" (best)" if v < best_loss else ""))
        tb.scalars(step, **{"dev/mel": v})
        tb.alignment(step, "dev/attention", first_attn)
        if have_matplotlib():
            attn_dir.mkdir(parents=True, exist_ok=True)
            plot_alignment(first_attn, attn_dir / f"attention_{step:06d}.png")
        else:
            print(f"step {step} | matplotlib is not installed: attention PNG skipped")
        if v < best_loss:
            best_loss = v
            best_ckpt.save(step, state_now(), force=True)

    t0, acc = time.time(), []
    done = False
    while not done:
        for batch in loader:
            batch = multihost.shard_global_batch(batch)
            loss, l_mel, _ = step_fn(to_device(batch, dev), step_generator(seed, step, dev))
            acc.append(torch.stack([loss, l_mel]))
            if step % log_every == 0:
                l, m = torch.stack(acc).mean(0).tolist()
                dt = (time.time() - t0) / len(acc)
                print(f"step {step} | loss {l:.4f} | mel {m:.4f} | {dt * 1000:.0f} ms/step")
                tb.scalars(step, **{"train/loss": l, "train/mel": m,
                                    "train/ms_per_step": dt * 1000})
                t0, acc = time.time(), []
            if val_every and step % val_every == 0 and multihost.is_primary():
                validate(step)
            if save_every and step % save_every == 0:
                ckpt.save(step, state_now())
                multihost.barrier()
            step += 1
            if total_steps and step > total_steps:
                done = True
                break
    ckpt.save(step, state_now(), force=True)
    multihost.barrier()
    return model
