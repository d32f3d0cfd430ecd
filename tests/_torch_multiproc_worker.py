"""Worker for the port's multi-process tests (started as a subprocess by
tests/test_torch_parallel.py; not itself a test module).

Trains 3 steps of each requested family at a tiny width, f32, on the CPU.
With ``num_processes`` > 1 it joins a gloo process group through
``parallel.multihost.initialize_from_env`` (the ``MB_*`` environment) and
feeds each rank its rows of one global batch, as the trainers do; with one
process there is no group. Every rank prints ``LOSSES <json>`` (the global
batch's losses of each step), which must equal one process's on the whole
batch. The port only: no JAX, nothing of the JAX package.
"""
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mockingbird_tpu_torch import seeded  # noqa: E402
from mockingbird_tpu_torch.config import Config  # noqa: E402
from mockingbird_tpu_torch.parallel import multihost  # noqa: E402
from mockingbird_tpu_torch.parallel.mesh import make_mesh, shard_batch  # noqa: E402
from mockingbird_tpu_torch.train.step import step_generator, to_device  # noqa: E402

STEPS = 3


def floats(*ts):
    return [float(t) for t in ts]


def run_tacotron(mesh):
    from mockingbird_tpu_torch.models.tacotron.model import Tacotron, tacotron_config
    from mockingbird_tpu_torch.models.tacotron.train import make_optimizer, make_train_step

    cfg = tacotron_config().merge(dict(
        embed_dims=32, encoder_dims=16, decoder_dims=32, postnet_dims=16, encoder_K=2,
        lstm_dims=32, postnet_K=2, num_highways=2, speaker_embedding_size=16, use_gst=False))
    with seeded(0):
        model = Tacotron(cfg)
    model.train()
    opt = make_optimizer(model, 1e-3)
    multihost.make_global(model, opt)
    step = make_train_step(model, opt, 2, "fp32", guided_attn_weight=0.2)
    rng = np.random.RandomState(0)
    b, t_text, t_mel = 8, 12, 16
    batch = dict(texts=rng.randint(1, 40, (b, t_text)).astype(np.int32),
                 mels=rng.randn(b, t_mel, 80).astype(np.float32),
                 embeds=rng.randn(b, 16).astype(np.float32),
                 stop=(np.arange(t_mel)[None] >= rng.randint(8, t_mel, (b, 1))).astype(np.float32),
                 text_lengths=rng.randint(6, t_text + 1, (b,)).astype(np.int32),
                 mel_lengths=rng.randint(8, t_mel + 1, (b,)).astype(np.int32))
    losses = []
    for i in range(STEPS):
        loss, parts, _, _ = step(to_device(shard_batch(mesh, batch), "cpu"),
                                 step_generator(7, i, "cpu"))
        losses += floats(loss, parts["guided"])
    return losses


def run_ge2e(mesh):
    from mockingbird_tpu_torch.models.encoder.model import init_params
    from mockingbird_tpu_torch.models.encoder.train import make_optimizer, make_train_step

    s, u, f = 8, 3, 16
    params = init_params(0, 32, 16).train()
    opt = make_optimizer(params)
    multihost.make_global(params, opt)
    step = make_train_step(params, opt, s, u, "fp32")
    rng = np.random.RandomState(1)
    losses = []
    for _ in range(STEPS):
        batch = rng.randn(s, u, f, 40).astype(np.float32)
        loss, eer, embeds = step(torch.from_numpy(shard_batch(mesh, batch)))
        assert embeds.shape[0] == s, embeds.shape
        losses += floats(loss, eer)
    return losses


def vits_cfg():
    from mockingbird_tpu_torch.models.vits.model import vits_config
    return Config(vits_config()).merge(dict(
        inter_channels=32, hidden_channels=32, filter_channels=64, n_heads=2, n_layers=2,
        upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=64,
        resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], spec_channels=65,
        segment_size=16 * 8, hop_size=16, n_speakers=8, gin_channels=16,
        emotion_channels=8, n_fft=128, win_size=128, num_mels=20))


def vits_batch(b=8, t_x=12, t_spec=40, seed=0):
    from mockingbird_tpu_torch.dsp import spectrogram_vits
    rng = np.random.RandomState(seed)
    t = np.arange(t_spec * 16) / 16000
    wavs = np.stack([0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t)
                     for i in range(b)]).astype(np.float32)
    wavs += 0.01 * rng.randn(*wavs.shape).astype(np.float32)
    with torch.no_grad():
        specs = spectrogram_vits(torch.from_numpy(wavs), 128, 16, 128).numpy()
    return dict(texts=rng.randint(1, 60, (b, t_x)).astype(np.int32),
                text_lengths=rng.randint(7, t_x + 1, (b,)).astype(np.int32),
                specs=specs, spec_lengths=rng.randint(24, t_spec + 1, (b,)).astype(np.int32),
                wavs=wavs, sids=(np.arange(b) % 8).astype(np.int32),
                emos=rng.randn(b, 8).astype(np.float32))


def run_vits(mesh):
    from mockingbird_tpu_torch.models.vits.model import init_vits
    from mockingbird_tpu_torch.models.vits.train import (VitsDiscriminator, make_optimizer,
                                                         make_vits_step)
    cfg = vits_cfg()
    model = init_vits(0, cfg)
    with seeded(1):
        disc = VitsDiscriminator()
    opt_g, opt_d = make_optimizer(model.parameters()), make_optimizer(disc.parameters())
    multihost.make_global(model, disc, opt_g, opt_d)
    step = make_vits_step(model, disc, opt_g, opt_d, cfg)
    batch = vits_batch()
    # each rank's own rows as the trainer's BucketBatcher deals them
    n, pid = multihost.process_count(), multihost.process_index()
    local = {k: v[pid::n] for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(STEPS):
        g, d, parts = step(to_device(multihost.assemble_local_batch(local), "cpu"), gen)
        losses += floats(g, d, parts["kl"], parts["dur"])
    return losses


def run_hifigan(mesh, arch="hifigan"):
    from mockingbird_tpu_torch.models.vocoder.gan_train import (ARCHS, make_gan_step,
                                                                make_optimizer, mel_loss_fn)
    gen_cls, disc_cls, cfg_fn = ARCHS[arch]
    cfg = Config(cfg_fn()).merge(dict(
        upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=32,
        resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], segment_size=512,
        hop_size=16, n_fft=128, win_size=128, num_mels=20, fmin=0.0, fmax=None))
    if arch == "fregan":   # four x2 stages, and the STFT loss of the global batch
        cfg.merge(dict(upsample_rates=[2, 2, 2, 2], upsample_kernel_sizes=[4, 4, 4, 4], top_k=3,
                       use_stft_loss=True))
    # float64: in float32 a few discriminator elements' gradients are
    # rounding noise whose sign the batch split decides, and Adam moves each
    # of them by its full lr (the GAN trainer's tests hold two steps in
    # float64 for the same reason)
    with seeded(0):
        gen = gen_cls(cfg).double()
    with seeded(1):
        disc = disc_cls().double()
    opt_g, opt_d = make_optimizer(gen.parameters(), cfg), make_optimizer(disc.parameters(), cfg)
    multihost.make_global(gen, disc, opt_g, opt_d)
    step = make_gan_step(gen, disc, opt_g, opt_d, cfg)
    b = 8
    t = np.arange(cfg.segment_size) / 16000
    wavs = np.stack([0.3 * np.sin(2 * np.pi * (200 + 30 * i) * t)
                     for i in range(b)]).astype(np.float32)
    with torch.no_grad():
        mels = mel_loss_fn(torch.from_numpy(wavs), cfg).numpy()
    batch = dict(mels=mels.astype(np.float64), wavs=wavs.astype(np.float64))
    losses = []
    for _ in range(STEPS):
        losses += floats(*step(to_device(shard_batch(mesh, batch), "cpu")))
    return losses


def run_fregan(mesh):
    return run_hifigan(mesh, "fregan")


def run_wavernn(mesh):
    from mockingbird_tpu_torch.models.vocoder.wavernn import WaveRNN, wavernn_config
    from mockingbird_tpu_torch.models.vocoder.wavernn_train import make_wavernn_step

    cfg = Config(wavernn_config()).merge(dict(
        rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16, res_blocks=2,
        upsample_factors=[4, 4], hop_size=16, seq_len=16 * 4, feat_dims=20, pad=2))
    with seeded(0):
        model = WaveRNN(cfg)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    multihost.make_global(model, opt)
    step = make_wavernn_step(model, opt, cfg.mode)
    rng = np.random.RandomState(3)
    b = 8
    mel_win = cfg.seq_len // cfg.hop_size + 2 * cfg.pad
    batch = dict(x=rng.uniform(-1, 1, (b, cfg.seq_len)).astype(np.float32),
                 y=rng.randint(0, 2 ** cfg.bits, (b, cfg.seq_len)).astype(np.int32),
                 mels=rng.randn(b, mel_win, cfg.feat_dims).astype(np.float32))
    losses = []
    for _ in range(STEPS):
        losses += floats(step(to_device(shard_batch(mesh, batch), "cpu")))
    # the BatchNorms' running statistics are the global batch's
    losses += [float(v.double().sum()) for k, v in model.state_dict().items()
               if k.endswith(("running_mean", "running_var"))]
    return losses


def run_ppg(mesh):
    from mockingbird_tpu_torch.models.ppg.ppg2mel import MelDecoderMOLv2, ppg2mel_config
    from mockingbird_tpu_torch.models.ppg.train import collate_vc, make_optimizer, make_vc_step

    cfg = Config(ppg2mel_config()).merge(dict(
        spk_embed_dim=16, bottle_neck_feature_dim=12, encoder_dim=16, attention_rnn_dim=32,
        decoder_rnn_dim=32, prenet_dims=[16, 8], num_mixtures=2, num_mels=20))
    with seeded(0):
        model = MelDecoderMOLv2(cfg)
    model.train()
    opt, sched = make_optimizer(model, 1e-3)
    multihost.make_global(model, opt)
    step = make_vc_step(model, opt, sched)
    rng = np.random.RandomState(5)
    b = 8
    down = int(np.prod(cfg.encoder_downsample_rates))
    items = []
    for _ in range(b):
        t = int(rng.randint(12, 25))
        items.append((rng.randn(t, 12).astype(np.float32), rng.randn(t, 2).astype(np.float32),
                      rng.randn(t, 20).astype(np.float32), rng.randn(16).astype(np.float32)))
    batch = collate_vc(items, cfg.frames_per_step, down, bucket=8)
    losses = []
    for i in range(STEPS + 1):    # the first update runs at a learning rate of 0
        losses += floats(*step(to_device(shard_batch(mesh, batch), "cpu"),
                               step_generator(3, i, "cpu")))
    return losses


def shardings_tree():
    """A parameter tree whose leaves take each branch of ``param_spec``."""
    g = torch.Generator().manual_seed(0)
    shapes = {"dense": {"kernel": (64, 32), "bias": (32,)}, "conv": (5, 48, 40),
              "odd": (31, 67), "tall": (200, 9), "small": (8, 8)}
    return {k: ({n: torch.randn(sh, generator=g) for n, sh in v.items()} if isinstance(v, dict)
                else torch.randn(v, generator=g)) for k, v in shapes.items()}


def run_shardings(mesh):
    """``shard_params`` on a (data 1, model 2) device mesh of the gloo ranks:
    each leaf's placements and this rank's local shard, held against the
    full tensor."""
    from mockingbird_tpu_torch.parallel.shardings import (device_mesh, params_sharding_tree,
                                                          shard_params)
    tp_mesh = make_mesh(data=1, model=2)
    tree = shardings_tree()
    placed = shard_params(tree, tp_mesh, device_mesh_=device_mesh(tp_mesh, "cpu"))
    rules = params_sharding_tree(tree, tp_mesh)
    out = []
    for path, full, dt, rule in ((("dense", "kernel"), tree["dense"]["kernel"],
                                  placed["dense"]["kernel"], rules["dense"]["kernel"]),
                                 (("dense", "bias"), tree["dense"]["bias"],
                                  placed["dense"]["bias"], rules["dense"]["bias"]),
                                 *(((k,), tree[k], placed[k], rules[k])
                                   for k in ("conv", "odd", "tall", "small"))):
        assert list(dt.placements) == rule, (path, dt.placements, rule)
        local = dt.to_local()
        torch.testing.assert_close(dt.full_tensor(), full, rtol=0, atol=0)
        out.append(["/".join(path), [str(p) for p in dt.placements], list(local.shape)])
    return out


FAMILIES = {"shardings": run_shardings, "tacotron": run_tacotron, "ge2e": run_ge2e,
            "vits": run_vits, "hifigan": run_hifigan, "fregan": run_fregan,
            "wavernn": run_wavernn, "ppg": run_ppg}


def main():
    cfg = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    if cfg["num_processes"] > 1:
        os.environ["MB_COORDINATOR"] = f"localhost:{cfg['port']}"
        os.environ["MB_NUM_PROCESSES"] = str(cfg["num_processes"])
        os.environ["MB_PROCESS_ID"] = str(cfg["process_id"])
    started = multihost.initialize_from_env("cpu")
    assert started == (cfg["num_processes"] > 1)
    assert multihost.process_count() == cfg["num_processes"]
    mesh = make_mesh()
    assert mesh.shape == {"data": cfg["num_processes"], "model": 1}
    out = {fam: FAMILIES[fam](mesh) for fam in cfg["families"]}
    print("LOSSES " + json.dumps(out), flush=True)
    multihost.shutdown()


if __name__ == "__main__":
    main()
