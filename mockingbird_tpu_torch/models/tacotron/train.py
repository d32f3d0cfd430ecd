"""Tacotron trainer: schedule-driven sessions, then GTA synthesis.

Port of ``mockingbird_tpu/models/tacotron/train.py``: per-session
(r, lr, final step, batch size) schedule, the loss MSE+L1 on the decoder's
mels + MSE on the postnet's + BCE on the stop token (+ the optional guided
attention penalty), the global-norm clip at 1.0 then Adam (0.9, 0.999,
eps 1e-8), finetuning of chosen top-level layers, periodic checkpoints,
backups and eval artifacts, the bf16 ``Policy``, and ground-truth-aligned
(GTA) mel synthesis for the vocoder.

As in the JAX package:
  * the clip divides by the global norm itself (optax's
    ``clip_by_global_norm``; ``clip_grad_norm_`` divides by norm + 1e-6);
  * with ``finetune_layers`` the norm is taken over all gradients, frozen
    layers' included, and Adam updates its moments for every parameter;
    the frozen layers' updates are then discarded (optax masks the updates
    after the clip and after Adam);
  * the random draws of step ``step`` (PreNet dropout, always on, and the
    zoneout masks) come from one ``torch.Generator`` keyed by
    (seed, step), as the JAX step's key is ``fold_in(PRNGKey(seed), step)``;
  * under bf16 the running BatchNorm statistics are read rounded to bf16
    and written back in f32 (``layers.FlaxBatchNorm``).

Data parallel across processes (``parallel.multihost``): every rank builds
the same global batch and takes its rows (the session's batch size rounded
down to a multiple of the ranks, as the JAX trainer rounds it to the data
axis); the dropout and zoneout draws, the BatchNorm statistics and the
guided-attention count are the global batch's; the gradients are averaged
over ranks before the clip; rank 0 alone logs, checkpoints and writes the
eval artifacts. Eval artifacts are the
attention ``.npz``, the predicted mel ``.npy`` and its Griffin-Lim wav; the
JAX trainer's matplotlib PNGs are left out.
"""
from __future__ import annotations

import json
import time
from functools import partial
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ... import resolve_device, seeded
from ...config import Config, sv2tts_audio_config
from ...dsp import inv_mel_spectrogram, save_wav
from ...parallel import multihost
from ...train.checkpoint import CheckpointManager
from ...train.logging import TrainLogger
from ...train.optim import clip_by_global_norm
from ...train.precision import Policy
from ...train.step import step_generator, to_device
from .dataset import DataLoader, SynthesizerDataset, collate_synthesizer
from .model import Tacotron, tacotron_config

# (r, lr, final_step, batch_size)
DEFAULT_SCHEDULE = (
    (2, 1e-3, 10_000, 12), (2, 5e-4, 15_000, 12), (2, 2e-4, 20_000, 12),
    (2, 1e-4, 30_000, 12), (2, 5e-5, 40_000, 12), (2, 1e-5, 60_000, 12),
    (2, 5e-6, 160_000, 12), (2, 3e-6, 320_000, 12), (2, 1e-6, 640_000, 12),
)


def tacotron_loss(out, batch):
    """m1 = MSE+L1(decoder, mel); m2 = MSE(postnet, mel); stop BCE. Padded
    frames carry the silence value in the target and count, unmasked."""
    mel_out, post_out, _, stop_out = out
    mels, stop_t = batch["mels"], batch["stop"]
    m1 = torch.mean((mel_out - mels) ** 2) + torch.mean(torch.abs(mel_out - mels))
    m2 = torch.mean((post_out - mels) ** 2)
    eps = 1e-7
    s = torch.clamp(stop_out, eps, 1 - eps)
    stop_l = -torch.mean(stop_t * torch.log(s) + (1 - stop_t) * torch.log(1 - s))
    return m1 + m2 + stop_l, dict(m1=m1, m2=m2, stop=stop_l)


def guided_attention_loss(attn, text_lengths, mel_lengths, r: int, g: float = 0.2):
    """Guided-attention penalty (DC-TTS eq. 12): W[s,t] = 1 − exp(−(t/T −
    s/S)²/2g²) over the real (step, char) region, summed and divided by the
    real decoder steps. Off by default."""
    _, s_max, t_max = attn.shape
    steps = torch.ceil(mel_lengths.float() / r)                       # (B,)
    tl = text_lengths.float()
    s_idx = torch.arange(s_max, dtype=torch.float32, device=attn.device)[None, :, None]
    t_idx = torch.arange(t_max, dtype=torch.float32, device=attn.device)[None, None, :]
    sn = s_idx / torch.clamp(steps[:, None, None], min=1.0)
    tn = t_idx / torch.clamp(tl[:, None, None], min=1.0)
    w = 1.0 - torch.exp(-((tn - sn) ** 2) / (2.0 * g * g))
    mask = (s_idx < steps[:, None, None]) & (t_idx < tl[:, None, None])
    return torch.sum(attn * w * mask) / multihost.global_count(torch.sum(steps), minimum=1.0)


def finetune_mask(model: torch.nn.Module, layers: Sequence[str]) -> dict:
    """{parameter name: trainable} for partial finetuning: a parameter is
    trainable when its top-level layer (encoder, encoder_proj, gst, decoder,
    postnet, post_proj) is in ``layers``; empty ``layers``: all are."""
    return {name: (not layers) or name.split(".")[0] in set(layers)
            for name, _ in model.named_parameters()}


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr, b1=0.9, b2=0.999)``."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def loss_of(model, batch: dict, r: int, policy: Policy, generator=None, zo_masks=None,
            guided_attn_weight: float = 0.0, guided_attn_g: float = 0.2):
    """The training forward and its loss: (loss, parts, out), ``out`` the
    model's four outputs in f32."""
    out = policy.apply(model, batch["texts"], batch["mels"], batch["embeds"], r,
                       generator=generator, zo_masks=zo_masks)
    loss, parts = tacotron_loss(out, batch)
    if guided_attn_weight:
        g_l = guided_attention_loss(out[2], batch["text_lengths"], batch["mel_lengths"], r,
                                    guided_attn_g)
        loss = loss + guided_attn_weight * g_l
        parts = dict(parts, guided=g_l)
    return loss, parts, out


def make_train_step(model: Tacotron, opt: torch.optim.Optimizer, r: int,
                    precision: str = "fp32", guided_attn_weight: float = 0.0,
                    guided_attn_g: float = 0.2, finetune_layers: Sequence[str] = ()):
    """One training step ``step(batch, generator, zo_masks=None)`` →
    (loss, parts, attn, postnet mels), tensors on the device: forward and
    loss, backward, the global-norm clip over all gradients, Adam, then the
    frozen layers (not in ``finetune_layers``, when given) put back.
    ``batch`` is ``to_device`` of a collated batch."""
    policy = Policy.from_name(precision)
    params = list(model.parameters())
    trainable = finetune_mask(model, finetune_layers)
    frozen = [p for name, p in model.named_parameters() if not trainable[name]]

    def step(batch, generator, zo_masks=None):
        with multihost.sharded():
            loss, parts, out = loss_of(model, batch, r, policy, generator, zo_masks,
                                       guided_attn_weight, guided_attn_g)
            opt.zero_grad(set_to_none=True)
            loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        multihost.average_gradients(params)
        clip_by_global_norm([p.grad for p in params], 1.0)
        kept = [p.detach().clone() for p in frozen]
        opt.step()
        with torch.no_grad():
            for p, k in zip(frozen, kept):
                p.copy_(k)
        losses = multihost.mean_over_ranks(
            torch.stack([t.detach().float() for t in (loss, *parts.values())]))
        return losses[0], dict(zip(parts, losses[1:])), out[2].detach(), out[1].detach()

    return step


def _dataset(syn_dir: Path) -> SynthesizerDataset:
    return SynthesizerDataset(syn_dir / "train.txt", syn_dir / "mels", syn_dir / "embeds")


def train(run_id: str, syn_dir: Path, models_dir: Path,
          schedule=DEFAULT_SCHEDULE, save_every: int = 1000,
          backup_every: int = 25_000, log_every: int = 10,
          eval_every: int = 500, force_restart: bool = False,
          total_steps: Optional[int] = None, cfg=None, audio_cfg=None, seed: int = 0,
          finetune_layers: Sequence[str] = (), precision: str = "bf16",
          guided_attn_weight: float = 0.0,
          device: Union[str, torch.device] = "cuda") -> Tacotron:
    """Train Tacotron on the preprocessed ``syn_dir`` from weights made from
    ``seed``, or resume the newest checkpoint under
    ``models_dir/run_id/ckpt`` (unless ``force_restart``); saves every
    ``save_every`` steps and at the end, eval artifacts every
    ``eval_every`` steps under ``models_dir/run_id/eval``. Data parallel
    under the ``MB_*`` environment (``parallel.multihost``)."""
    multihost.initialize_from_env(device)
    dev = multihost.rank_device(resolve_device(device))
    syn_dir = Path(syn_dir)
    cfg = Config(tacotron_config()).merge(cfg or {})
    audio_cfg = audio_cfg or sv2tts_audio_config()
    dataset = _dataset(syn_dir)
    with seeded(seed):
        model = Tacotron(cfg)
    model.to(dev).train()

    model_dir = Path(models_dir) / run_id
    model_dir.mkdir(parents=True, exist_ok=True)
    if multihost.is_primary():
        (model_dir / "config.json").write_text(json.dumps(cfg.to_dict(), indent=2))
    ckpt = CheckpointManager(model_dir / "ckpt", backup_every=backup_every)
    tb = TrainLogger(model_dir / "logs")
    eval_dir = model_dir / "eval"
    eval_dir.mkdir(exist_ok=True)

    step, restored, opt = 1, False, None
    for session_i, (r, lr, max_step, batch_size) in enumerate(schedule):
        if step >= max_step:
            continue
        opt = make_optimizer(model, lr)
        if not force_restart and not restored:
            restored = True
            step0, state = ckpt.restore_latest(map_location=dev)
            if step0 is not None:
                model.load_state_dict(state["model"])
                opt.load_state_dict(state["opt"])
                for group in opt.param_groups:   # the session's rate, not the saved one
                    group["lr"] = lr
                step = step0 + 1
                print(f"Resumed {run_id} at step {step0}")
            if step >= max_step:
                continue
        multihost.make_global(model, opt)

        n_proc = multihost.process_count()
        if batch_size % n_proc:
            batch_size = max(n_proc, batch_size - batch_size % n_proc)
        loader = DataLoader(dataset, batch_size,
                            partial(collate_synthesizer, r=r,
                                    max_abs_value=audio_cfg.max_abs_value), seed=seed)
        if len(loader) == 0:
            raise RuntimeError("dataset smaller than one batch")
        step_fn = make_train_step(model, opt, r, precision, guided_attn_weight=guided_attn_weight,
                                  finetune_layers=finetune_layers)
        print(f"Session {session_i}: r={r} lr={lr} batch={batch_size} until step {max_step}")

        t0, loss_acc = time.time(), []
        done = False
        while not done:
            for batch in loader:
                batch = multihost.shard_global_batch(batch)
                loss, parts, attn, post = step_fn(to_device(batch, dev),
                                                  step_generator(seed, step, dev))
                loss_acc.append(float(loss))
                if step % log_every == 0:
                    dt = (time.time() - t0) / len(loss_acc)
                    print(f"step {step} | loss {np.mean(loss_acc):.4f} | {dt * 1000:.0f} ms/step")
                    tb.scalars(step, **{"train/loss": np.mean(loss_acc),
                                        "train/m1": float(parts["m1"]),
                                        "train/m2": float(parts["m2"]),
                                        "train/stop": float(parts["stop"]),
                                        "train/ms_per_step": dt * 1000})
                    t0, loss_acc = time.time(), []
                if save_every and step % save_every == 0:
                    ckpt.save(step, {"model": model.state_dict(), "opt": opt.state_dict()})
                    multihost.barrier()
                if eval_every and step % eval_every == 0 and multihost.is_primary():
                    _save_eval_artifacts(eval_dir, step, batch, attn, post, audio_cfg, tb,
                                         float(loss))
                step += 1
                if step >= max_step or (total_steps and step > total_steps):
                    done = True
                    break
        if total_steps and step > total_steps:
            break

    if opt is not None:
        ckpt.save(step, {"model": model.state_dict(), "opt": opt.state_dict()}, force=True)
        multihost.barrier()
    return model


def _save_eval_artifacts(eval_dir: Path, step: int, batch: dict, attn: torch.Tensor,
                         post: torch.Tensor, audio_cfg, tb: TrainLogger, loss: float) -> None:
    """Sample 0 of the training batch: its attention (``.npz`` with the text
    and mel lengths), the postnet mel (``.npy``, (T, M)) and that mel
    inverted by Griffin-Lim (a wav), each also to the log."""
    a0 = attn[0].float().cpu().numpy()
    t_len = int((batch["texts"][0] != 0).sum())
    m_len = int(batch["mel_lengths"][0])
    np.savez(eval_dir / f"attention_{step:06d}.npz", attn=a0, text_len=t_len, mel_len=m_len)
    tb.alignment(step, "train/attention", a0.T)
    pred = post[0, :m_len].float()
    pred_np = pred.cpu().numpy()
    np.save(eval_dir / f"mel-prediction-step-{step:06d}.npy", pred_np, allow_pickle=False)
    gen = torch.Generator(device=pred.device).manual_seed(step)
    with torch.no_grad():
        wav = inv_mel_spectrogram(pred, audio_cfg, generator=gen).cpu().numpy()
    save_wav(wav, eval_dir / f"step-{step:06d}-wave-from-mel.wav", audio_cfg.sample_rate)
    tb.audio(step, "eval/griffin_lim", wav, audio_cfg.sample_rate)
    span = max(float(pred_np.max() - pred_np.min()), 1e-6)
    tb.image(step, "eval/mel_predicted", (pred_np.T - pred_np.min()) / span)
    print(f"step {step} | eval artifacts written (loss {loss:.4f})")


def run_gta_synthesis(run_id: str, syn_dir: Path, models_dir: Path, r: int = 2,
                      batch_size: int = 16, cfg=None, seed: int = 0,
                      device: Union[str, torch.device] = "cuda") -> int:
    """Ground-truth-aligned mels for vocoder training: the teacher-forced
    eval-mode forward (running BatchNorm statistics, no zoneout, PreNet
    dropout on) over the whole training set, in order, with the newest
    checkpoint under ``models_dir/run_id/ckpt`` (else weights made from
    ``seed``). Writes ``mels_gta/<mel file>`` as (M, T) and
    ``synthesized.txt``; returns the number of mels written."""
    dev = resolve_device(device)
    syn_dir = Path(syn_dir)
    cfg = Config(tacotron_config()).merge(cfg or {})
    with seeded(seed):
        model = Tacotron(cfg)
    step0, state = CheckpointManager(Path(models_dir) / run_id / "ckpt").restore_latest(
        map_location="cpu")
    if step0 is not None:
        model.load_state_dict(state["model"])
        print(f"GTA with checkpoint step {step0}")
    model.to(dev).eval()

    dataset = _dataset(syn_dir)
    loader = DataLoader(dataset, batch_size, partial(collate_synthesizer, r=r),
                        shuffle=False, drop_last=False, seed=seed)
    out_dir = syn_dir / "mels_gta"
    out_dir.mkdir(exist_ok=True)
    meta_lines = []
    for bi, batch in enumerate(loader):
        b = to_device(batch, dev)
        with torch.no_grad():
            mels = model(b["texts"], b["mels"], b["embeds"], r,
                         generator=step_generator(seed, bi, dev))[0].cpu().numpy()
        for j, di in enumerate(batch["indices"]):
            length = int(batch["mel_lengths"][j])
            fname = Path(dataset.mel_fpaths[int(di)]).name
            np.save(out_dir / fname, mels[j, :length].T)  # (M, T), as the reference stores it
            meta_lines.append(fname)
    (syn_dir / "synthesized.txt").write_text("\n".join(meta_lines))
    print(f"Wrote {len(meta_lines)} GTA mels to {out_dir}")
    return len(meta_lines)
