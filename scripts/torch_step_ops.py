"""Count the ATen operations one training step dispatches, on the CPU, at a
tiny width: the host work a step asks of PyTorch, which sets the time of
the port's host-bound trainer loops on the card. Run it on two checkouts to
compare what a change adds to each step:

    python scripts/torch_step_ops.py --root PARENT_CHECKOUT
    python scripts/torch_step_ops.py --root .

Prints ``STEP_OPS <family> <total>`` and the ten most frequent operations
for the Tacotron and VITS steps (the second step of each; the first warms
up). Imports the package from ``--root``; no JAX.
"""
from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def tacotron_step():
    from mockingbird_tpu_torch import seeded
    from mockingbird_tpu_torch.models.tacotron.model import Tacotron, tacotron_config
    from mockingbird_tpu_torch.models.tacotron.train import make_optimizer, make_train_step
    from mockingbird_tpu_torch.train.step import step_generator, to_device

    cfg = tacotron_config().merge(dict(
        embed_dims=32, encoder_dims=16, decoder_dims=32, postnet_dims=16, encoder_K=2,
        lstm_dims=32, postnet_K=2, num_highways=2, speaker_embedding_size=16, use_gst=False))
    with seeded(0):
        model = Tacotron(cfg)
    model.train()
    step = make_train_step(model, make_optimizer(model, 1e-3), 2, "fp32",
                           guided_attn_weight=0.2)
    rng = np.random.RandomState(0)
    b, t_text, t_mel = 4, 12, 200
    batch = to_device(dict(
        texts=rng.randint(1, 40, (b, t_text)).astype(np.int32),
        mels=rng.randn(b, t_mel, 80).astype(np.float32),
        embeds=rng.randn(b, 16).astype(np.float32),
        stop=(np.arange(t_mel)[None] >= rng.randint(100, t_mel, (b, 1))).astype(np.float32),
        text_lengths=rng.randint(6, t_text + 1, (b,)).astype(np.int32),
        mel_lengths=rng.randint(100, t_mel + 1, (b,)).astype(np.int32)), "cpu")
    return lambda i: float(step(batch, step_generator(7, i, "cpu"))[0])


def vits_step():
    from mockingbird_tpu_torch import seeded
    from mockingbird_tpu_torch.config import Config
    from mockingbird_tpu_torch.dsp import spectrogram_vits
    from mockingbird_tpu_torch.models.vits.model import init_vits, vits_config
    from mockingbird_tpu_torch.models.vits.train import (VitsDiscriminator, make_optimizer,
                                                         make_vits_step)
    from mockingbird_tpu_torch.train.step import to_device

    cfg = Config(vits_config()).merge(dict(
        inter_channels=32, hidden_channels=32, filter_channels=64, n_heads=2, n_layers=2,
        upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=64,
        resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], spec_channels=65,
        segment_size=128, hop_size=16, n_speakers=8, gin_channels=16, emotion_channels=8,
        n_fft=128, win_size=128, num_mels=20))
    model = init_vits(0, cfg)
    with seeded(1):
        disc = VitsDiscriminator()
    step = make_vits_step(model, disc, make_optimizer(model.parameters()),
                          make_optimizer(disc.parameters()), cfg)
    rng = np.random.RandomState(0)
    b, t_x, t_spec = 8, 12, 40
    t = np.arange(t_spec * 16) / 16000
    wavs = np.stack([0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t)
                     for i in range(b)]).astype(np.float32)
    with torch.no_grad():
        specs = spectrogram_vits(torch.from_numpy(wavs), 128, 16, 128).numpy()
    batch = to_device(dict(
        texts=rng.randint(1, 60, (b, t_x)).astype(np.int32),
        text_lengths=rng.randint(7, t_x + 1, (b,)).astype(np.int32),
        specs=specs, spec_lengths=rng.randint(24, t_spec + 1, (b,)).astype(np.int32),
        wavs=wavs, sids=(np.arange(b) % 8).astype(np.int32),
        emos=rng.randn(b, 8).astype(np.float32)), "cpu")
    gen = torch.Generator().manual_seed(0)
    return lambda i: float(step(batch, gen)[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="the checkout whose package to import")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    torch.set_num_threads(1)
    for family, make in (("tacotron", tacotron_step), ("vits", vits_step)):
        run = make()
        run(0)
        with _Count() as count:
            run(1)
        print(f"STEP_OPS {family} {sum(count.ops.values())}")
        for op, n in count.ops.most_common(10):
            print(f"  {op} {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
