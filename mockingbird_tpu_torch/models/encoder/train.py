"""GE2E speaker-encoder trainer.

Port of ``mockingbird_tpu/models/encoder/train.py``: the GE2E loss over a
(speakers × utterances × partial frames) batch; the similarity parameters'
gradients scaled by 0.01, then the global-norm clip at 3 over all gradients
(optax's semantics, ``train.optim.clip_by_global_norm``), then Adam at 1e-4
(eps 1e-8); periodic checkpoints and backups, loss/EER logs and projection
PNGs of the embeddings. The LSTMs and the linear layer run in the policy's
dtype (bf16 by default; ``train.precision.Policy``), the embeddings come
back in f32 and the loss and EER are computed in f32. The step returns its
loss, EER and embeddings as tensors: the host reads them only when it logs
or draws.

Single process: the JAX trainer's mesh and ``multihost`` calls wait for the
port's data parallelism. The trained parameters are also written as an
``.npz`` export (``weights.to_flax``) that ``SpeakerEncoderInference``
loads.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Optional, Union

import torch

from ... import resolve_device
from ...train.checkpoint import CheckpointManager
from ...train.logging import TrainLogger
from ...train.optim import clip_by_global_norm
from ...train.precision import Policy
from ...train.visualizations import draw_projections, have_matplotlib
from ...weights import save_npz, to_flax
from .dataset import SpeakerBatchSampler, SpeakerVerificationDataset
from .model import equal_error_rate, ge2e_loss, init_params

LEARNING_RATE_INIT = 1e-4
SPEAKERS_PER_BATCH = 64
UTTERANCES_PER_SPEAKER = 10
PARTIALS_N_FRAMES = 160


def make_optimizer(params: torch.nn.Module, lr: float = LEARNING_RATE_INIT) -> torch.optim.Adam:
    """``optax.adam(lr)``."""
    return torch.optim.Adam(params.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(params: torch.nn.ModuleDict, opt: torch.optim.Optimizer,
                    speakers_per_batch: int, utterances_per_speaker: int,
                    precision: str = "fp32"):
    """One step ``step(batch)`` → (loss, eer, embeds), tensors on the
    device, for ``params`` = ``init_params(...)``: the forward in the
    policy's dtype, the GE2E loss in f32, backward, the similarity
    gradients ×0.01, the clip at 3, the optimizer. ``batch`` (S, U, T, 40)
    on the device; ``embeds`` (S, U, D)."""
    policy = Policy.from_name(precision)
    model, sim = params["model"], params["similarity"]
    leaves = list(params.parameters())

    def step(batch: torch.Tensor):
        s, u = batch.shape[:2]
        frames = batch.reshape(s * u, *batch.shape[2:])
        embeds = policy.apply(model, frames).reshape(s, u, -1)
        loss, sim_matrix = ge2e_loss(embeds, sim["weight"], sim["bias"])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for p in sim.parameters():
            p.grad.mul_(0.01)
        clip_by_global_norm([p.grad for p in leaves], 3.0)
        opt.step()
        eer = equal_error_rate(sim_matrix, speakers_per_batch, utterances_per_speaker)
        return loss.detach(), eer, embeds.detach()

    return step


def train(run_id: str, clean_data_root: Path, models_dir: Path,
          save_every: int = 500, backup_every: int = 7500,
          total_steps: Optional[int] = None,
          speakers_per_batch: int = SPEAKERS_PER_BATCH,
          utterances_per_speaker: int = UTTERANCES_PER_SPEAKER,
          learning_rate: float = LEARNING_RATE_INIT,
          force_restart: bool = False, log_every: int = 10,
          vis_every: int = 100, precision: str = "bf16", seed: int = 0,
          remat: Optional[bool] = None,
          device: Union[str, torch.device] = "cuda") -> torch.nn.ModuleDict:
    """Train GE2E on the speaker directories of ``clean_data_root`` from
    weights made from ``seed``, or resume the newest checkpoint under
    ``models_dir/run_id/ckpt`` (unless ``force_restart``). Checkpoints every
    ``save_every`` steps and at ``total_steps``, logs every ``log_every``,
    projection PNGs under ``umap/`` every ``vis_every``; at the end writes
    ``encoder.npz``. ``remat`` defaults to on at 4096 partials a batch or
    more, as in the JAX trainer. Returns ``init_params``' tree, trained."""
    dev = resolve_device(device)
    dataset = SpeakerVerificationDataset(Path(clean_data_root))
    sampler = SpeakerBatchSampler(dataset, speakers_per_batch, utterances_per_speaker,
                                  PARTIALS_N_FRAMES, seed=seed)
    if remat is None:
        remat = speakers_per_batch * utterances_per_speaker >= 4096
    params = init_params(seed, remat=remat).to(dev).train()
    opt = make_optimizer(params, learning_rate)

    model_dir = Path(models_dir) / run_id
    ckpt = CheckpointManager(model_dir / "ckpt", backup_every=backup_every)
    tb = TrainLogger(model_dir / "logs")
    init_step = 1
    if not force_restart:
        step0, state = ckpt.restore_latest(map_location=dev)
        if step0 is not None:
            params.load_state_dict(state["params"])
            opt.load_state_dict(state["opt"])
            init_step = step0 + 1
            print(f"Resumed encoder run {run_id} at step {step0}")
    step_fn = make_train_step(params, opt, speakers_per_batch, utterances_per_speaker,
                              precision)

    vis_dir = model_dir / "umap"
    t0, losses, eers = time.time(), [], []
    for step, batch in enumerate(sampler, init_step):
        loss, eer, embeds = step_fn(torch.from_numpy(batch).to(dev))
        losses.append(loss)
        eers.append(eer)

        if vis_every and step % vis_every == 0:
            if have_matplotlib():
                vis_dir.mkdir(parents=True, exist_ok=True)
                draw_projections(embeds.reshape(-1, embeds.shape[-1]).cpu().numpy(),
                                 utterances_per_speaker, step,
                                 vis_dir / f"umap_{step:06d}.png")
            else:
                print(f"step {step} | matplotlib is not installed: projection PNG skipped")

        if step % log_every == 0:
            dt = (time.time() - t0) / len(losses)
            loss_m, eer_m = (float(torch.stack(v).mean()) for v in (losses, eers))
            print(f"step {step} | loss {loss_m:.4f} | EER {eer_m:.4f} | {dt * 1000:.0f} ms/step")
            tb.scalars(step, **{"train/loss": loss_m, "train/eer": eer_m,
                                "train/ms_per_step": dt * 1000})
            t0, losses, eers = time.time(), [], []
        saved = save_every and step % save_every == 0
        if saved:
            ckpt.save(step, {"params": params.state_dict(), "opt": opt.state_dict()})
        if total_steps is not None and step >= total_steps:
            if not saved:
                ckpt.save(step, {"params": params.state_dict(), "opt": opt.state_dict()},
                          force=True)
            break
    save_npz(model_dir / "encoder.npz", to_flax(params))
    return params
