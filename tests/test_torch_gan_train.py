"""The port's GAN-vocoder training (HiFi-GAN and Fre-GAN) against the JAX
package: both discriminator bundles at their full widths, Fre-GAN's
multi-resolution STFT loss, the dataset and its batches, the weight bridge
of both discriminator trees, and ``train`` end to end with validation, a
checkpoint and a resume. flax parameters are drawn from numpy at the shapes
of ``jax.eval_shape``; the JAX side is jitted. float32 unless stated;
tolerances stated per test. flax's ``SpectralNorm`` and the trainer's step
are held in ``test_torch_gan_train_steps.py`` and
``test_torch_gan_train_grads.py``, which import the setup helpers here."""
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mockingbird_tpu.config import Config as JConfig
from mockingbird_tpu.models.vocoder import dataset as jdata
from mockingbird_tpu.models.vocoder import fregan as jfregan
from mockingbird_tpu.models.vocoder import gan_losses as jlosses
from mockingbird_tpu.models.vocoder import hifigan as jhifigan
from mockingbird_tpu.models.tacotron import dataset as jtaco_data
from mockingbird_tpu_torch.models.tacotron import dataset as ttaco_data
from mockingbird_tpu_torch.models.vocoder import dataset as tdata
from mockingbird_tpu_torch.models.vocoder import fregan as tfregan
from mockingbird_tpu_torch.models.vocoder import gan_losses as tlosses
from mockingbird_tpu_torch.models.vocoder import hifigan as thifigan
from mockingbird_tpu_torch.train.checkpoint import CheckpointManager
from mockingbird_tpu_torch.weights import WeightMismatch, flatten_tree, load_flax, to_flax
from test_torch_vits import random_params

jtrain = importlib.import_module("mockingbird_tpu.models.vocoder.gan_train")
ttrain = importlib.import_module("mockingbird_tpu_torch.models.vocoder.gan_train")

# a small generator (as tests/test_vocoders.py's GAN step) before the full
# discriminators, at segment 512 and hop 16
SMALL = dict(upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=32,
             resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], segment_size=512,
             hop_size=16, n_fft=128, win_size=128, num_mels=20, fmin=0.0, fmax=None,
             batch_size=2)
# Fre-GAN's: four ×2 stages, the mel conditioning all but the first
FRE_SMALL = dict(SMALL, upsample_rates=[2, 2, 2, 2], upsample_kernel_sizes=[4, 4, 4, 4], top_k=3)
SEG = 512


def _jcfg(arch="hifigan", **kw):
    if arch == "hifigan":
        return JConfig(jhifigan.hifigan_config()).merge(SMALL).merge(kw).freeze()
    return JConfig(jfregan.fregan_config()).merge(FRE_SMALL).merge(kw).freeze()


def _tcfg(arch="hifigan", **kw):
    if arch == "hifigan":
        return thifigan.hifigan_config().merge(SMALL).merge(kw)
    return tfregan.fregan_config().merge(FRE_SMALL).merge(kw)


def _variables(jmod, *args, seed=0):
    """flax variables at ``init``'s shapes, drawn from numpy: params as
    ``random_params``, spectral-norm ``u`` N(0, 1), ``sigma`` 1 + N(0, 0.1²)."""
    shapes = jax.eval_shape(lambda k: jmod.init(k, *args), jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    out = {"params": random_params(shapes["params"], rng, 0.1)}
    if "batch_stats" in shapes:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, s: np.asarray(rng.randn(*s.shape) if path[-1].key.endswith("/u")
                                       else 1 + 0.1 * rng.randn(*s.shape), np.float32),
            shapes["batch_stats"])
    return out


def _max_diff(a, b):
    fa, fb = flatten_tree(jax.tree.map(np.asarray, a)), flatten_tree(b)
    assert set(fa) == set(fb)
    return max(float(np.abs(fa[k] - fb[k]).max(initial=0.0)) for k in fa)


# ---------------------------------------------------------------------------
# the discriminators, the STFT loss, the weight bridge
# ---------------------------------------------------------------------------

BUNDLES = {"hifigan": (jhifigan.HifiganDiscriminators, thifigan.HifiganDiscriminators),
           "fregan": (jfregan.FreGanDiscriminators, tfregan.FreGanDiscriminators)}


def _flat_outputs(out):
    """(mpd, msd) outputs → every score and feature map, channels-last."""
    flat = []
    for rs, gs, frs, fgs in out:
        flat += list(rs) + list(gs)
        for fm in list(frs) + list(fgs):
            flat += list(fm)
    return flat


@pytest.fixture(scope="module")
def disc_vars():
    """Each bundle's flax variables at (1, 4000) init shapes, drawn once."""
    zeros = np.zeros((1, 4000), np.float32)
    return {arch: _variables(jcls(), zeros, zeros) for arch, (jcls, _) in BUNDLES.items()}


def _channels_last(g: torch.Tensor) -> np.ndarray:
    g = g.numpy()
    return g.transpose(0, 2, 3, 1) if g.ndim == 4 else g.transpose(0, 2, 1) if g.ndim == 3 else g


@pytest.mark.parametrize("arch", ["hifigan", "fregan"])
def test_discriminators_match_jax(arch, disc_vars):
    """Both bundles at their full widths on (2, 2048) real and generated
    wavs, with ``train`` off, then on (as the generator's and the
    discriminators' losses call them): every score and feature map within
    1e-4 relative L2 (measured ~2e-6); the spectral-norm statistics
    unmoved, then within 1e-6 of flax's."""
    jcls, tcls = BUNDLES[arch]
    rng = np.random.RandomState(0)
    y, y_hat = (0.3 * rng.randn(2, 2, 2048)).astype(np.float32)
    jmod, var = jcls(), disc_vars[arch]

    @jax.jit
    def run(v, a, b):
        return jmod.apply(v, a, b, False), jmod.apply(v, a, b, True, mutable=["batch_stats"])

    want_eval, (want_train, mut) = run(var, y, y_hat)
    tmod = load_flax(tcls(), var)
    for train, want in ((False, want_eval), (True, want_train)):
        with torch.no_grad():
            got = tmod(torch.from_numpy(y), torch.from_numpy(y_hat), train)
        want_flat, got_flat = _flat_outputs(want), _flat_outputs(got)
        assert len(want_flat) == len(got_flat) == 124
        for w, g in zip(want_flat, got_flat):
            w, g = np.asarray(w), _channels_last(g)
            assert w.shape == g.shape
            assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)
        stats = to_flax(tmod)["batch_stats"]
        if train:
            assert _max_diff(mut["batch_stats"], stats) <= 1e-6
        else:
            assert _max_diff(var["batch_stats"], stats) == 0.0


@pytest.mark.parametrize("arch,n_params,n_leaves", [("hifigan", 70724591, 154),
                                                    ("fregan", 70824253, 268)])
def test_discriminator_trees_round_trip(arch, n_params, n_leaves, disc_vars):
    """A flax tree of each bundle (params and the 16 spectral-norm
    ``.../kernel/u`` and ``.../kernel/sigma`` leaves) loads strictly and
    comes back from ``to_flax`` exactly; a missing or an extra leaf raises."""
    tcls = BUNDLES[arch][1]
    var = disc_vars[arch]
    params, stats = flatten_tree(var["params"]), flatten_tree(var["batch_stats"])
    assert len(params) == n_leaves and len(stats) == 16
    assert sum(v.size for v in params.values()) == n_params
    assert all(k.startswith("msd/disc_0/") and k.endswith(("/kernel/u", "/kernel/sigma"))
               for k in stats)
    tmod = load_flax(tcls(), var)
    assert _max_diff(var, to_flax(tmod)) == 0.0
    disc0 = dict(var["batch_stats"]["msd"]["disc_0"])
    del disc0["conv_post"]
    short = {"params": var["params"],
             "batch_stats": {"msd": dict(var["batch_stats"]["msd"], disc_0=disc0)}}
    with pytest.raises(WeightMismatch, match="conv_post"):
        load_flax(tmod, short)
    extra = {"params": dict(var["params"], stray={"kernel": np.zeros(1, np.float32)}),
             "batch_stats": var["batch_stats"]}
    with pytest.raises(WeightMismatch, match="stray"):
        load_flax(tmod, extra)


@pytest.mark.parametrize("n", [4096, 512])
def test_multi_resolution_stft_loss_matches_jax(n):
    """Fre-GAN's auxiliary loss at the default three resolutions on (2, n)
    wavs: both terms within 1e-5 relative. At 512 samples the centring pad
    of the 1024- and 2048-point frames outgrows the signal, and the
    reflection repeats, as numpy's does."""
    rng = np.random.RandomState(3)
    t = np.arange(n) / 16000
    y = np.stack([0.4 * np.sin(2 * np.pi * 220 * t), 0.3 * np.sin(2 * np.pi * 330 * t)])
    x = (y + 0.05 * rng.randn(*y.shape)).astype(np.float32)
    y = y.astype(np.float32)
    want = jlosses.multi_resolution_stft_loss(jnp.asarray(x), jnp.asarray(y))
    got = tlosses.multi_resolution_stft_loss(torch.from_numpy(x), torch.from_numpy(y))
    for g, w in zip(got, want):
        assert abs(float(g) / float(w) - 1) <= 1e-5


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def syn_dir(tmp_path_factory):
    """``train.txt``, ``audio/`` (seeded noisy tones of 300 to 1200 samples)
    and ``mels_gta/`` ((20, frames) stored bin-major, some shorter than a
    segment) for 24 utterances."""
    root = tmp_path_factory.mktemp("gan_syn")
    (root / "audio").mkdir()
    (root / "mels_gta").mkdir()
    rng = np.random.RandomState(0)
    rows = []
    for i in range(24):
        n = int(rng.randint(300, 1200))
        t = np.arange(n) / 16000
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t) + 0.02 * rng.randn(n)
        np.save(root / "audio" / f"audio-{i:03d}.npy", wav.astype(np.float32))
        frames = n // 16
        np.save(root / "mels_gta" / f"mel-{i:03d}.npy",
                np.clip(rng.randn(20, frames) * 2, -4, 4).astype(np.float32))
        rows.append(f"audio-{i:03d}.npy|mel-{i:03d}.npy|embed-{i:03d}.npy|{n}|{frames}|text")
    (root / "train.txt").write_text("\n".join(rows) + "\n")
    return root


@pytest.mark.parametrize("fine_tuning", [False, True])
def test_dataset_and_batches_match_jax(syn_dir, fine_tuning):
    """``get_dataset_filelist`` (the 95/5 split), ``MelDataset``'s crops
    from the same seed (wavs exactly equal; mels within 1e-5: the port's
    ``mel_vits`` on the host, or the GTA mels as stored), the whole-utterance
    branch, and the ``DataLoader`` over ``collate_gan`` giving the same
    batches."""
    want_files = jdata.get_dataset_filelist(syn_dir)
    got_files = tdata.get_dataset_filelist(syn_dir)
    assert got_files == want_files and [len(f) for f in got_files] == [22, 2]
    jcfg, tcfg = _jcfg(), _tcfg()
    for split, idx in ((True, list(range(22)) + [3, 3]), (False, [0, 5])):
        jds = jdata.MelDataset(want_files[0], jcfg, syn_dir, fine_tuning, split, seed=7)
        tds = tdata.MelDataset(got_files[0], tcfg, syn_dir, fine_tuning, split, seed=7)
        for i in idx:
            (jm, jw), (tm, tw) = jds[i], tds[i]
            np.testing.assert_array_equal(tw, jw)
            assert tm.shape == jm.shape and tm.dtype == np.float32
            np.testing.assert_allclose(tm, jm, atol=1e-5)
            if split:
                assert tw.shape == (SEG,) and tm.shape[0] == SEG // 16
    jds = jdata.MelDataset(want_files[0], jcfg, syn_dir, fine_tuning, seed=3)
    tds = tdata.MelDataset(got_files[0], tcfg, syn_dir, fine_tuning, seed=3)
    jl = jtaco_data.DataLoader(jds, 4, jdata.collate_gan, seed=3)
    tl_ = ttaco_data.DataLoader(tds, 4, tdata.collate_gan, seed=3)
    for _ in range(2):
        for jb, tb in zip(jl, tl_, strict=True):
            np.testing.assert_array_equal(tb["wavs"], jb["wavs"])
            np.testing.assert_allclose(tb["mels"], jb["mels"], atol=1e-5)
    wav = np.load(want_files[0][0][0])
    np.testing.assert_allclose(tdata.mel_for_loss(wav, tcfg), jdata.mel_for_loss(wav, jcfg),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the training step's setup (its tests: test_torch_gan_train_steps.py and
# test_torch_gan_train_grads.py import it)
# ---------------------------------------------------------------------------

def _step_setup(arch="hifigan", seed=0, dtype=np.float32):
    """JAX generator + discriminators, their numpy-drawn variables, and a
    batch of two noisy tones with their log-mels, in ``dtype``."""
    jc = _jcfg(arch)
    gen = (jhifigan.Generator if arch == "hifigan" else jfregan.FreGanGenerator)(jc)
    disc = BUNDLES[arch][0]()
    seg = np.zeros((1, SEG), np.float32)
    gvar = _variables(gen, np.zeros((1, SEG // 16, 20), np.float32), seed=seed)
    dvar = _variables(disc, seg, seg, seed=seed + 1)
    rng = np.random.RandomState(seed + 2)
    t = np.arange(SEG) / 16000
    wavs = np.stack([0.3 * np.sin(2 * np.pi * 220 * t), 0.3 * np.sin(2 * np.pi * 330 * t)])
    wavs = (wavs + 0.02 * rng.randn(*wavs.shape)).astype(dtype)
    mels = np.asarray(jtrain.mel_loss_fn(jnp.asarray(wavs), jc), dtype)
    cast = lambda tree: jax.tree.map(lambda a: np.asarray(a, dtype), tree)  # noqa: E731
    return jc, gen, disc, cast(gvar["params"]), cast(dvar), dict(mels=mels, wavs=wavs)


def _port(arch, gp, dvar, dtype=torch.float32, **cfg):
    tc = _tcfg(arch, **cfg)
    gen_cls = thifigan.Generator if arch == "hifigan" else tfregan.FreGanGenerator
    tg = load_flax(gen_cls(tc), gp).to(dtype)
    td = load_flax(BUNDLES[arch][1](), dvar).to(dtype)
    og, od = ttrain.make_optimizer(tg.parameters(), tc), ttrain.make_optimizer(td.parameters(), tc)
    return tc, tg, td, og, od


def _to_torch(batch, dtype=torch.float64):
    return {k: torch.from_numpy(v).to(dtype) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def test_train_validates_saves_and_resumes(syn_dir, tmp_path):
    """``train`` at the small width in bf16: 3 steps of batch 2 with
    validation and a checkpoint at step 2 and the final save at 4; the
    validation error and audio logged; a resume that picks up at step 4
    with both optimizers' counts and runs to step 5; Fre-GAN with its STFT
    loss for one step."""
    kw = dict(val_every=2, save_every=2, log_every=1, device="cpu", seed=3)
    gen, disc = ttrain.train("run", syn_dir, tmp_path, total_steps=3, cfg=SMALL, **kw)
    ckpt = CheckpointManager(tmp_path / "run" / "ckpt_hifigan")
    assert ckpt.steps() == [2, 4]
    step, state = ckpt.restore_latest()
    for k, v in disc.state_dict().items():
        assert torch.equal(state["d"][k], v), k
    logs = tmp_path / "run" / "logs_hifigan"
    recs = [json.loads(line) for line in (logs / "scalars.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "train/gen" in r] == [1, 2, 3]
    assert [r["step"] for r in recs if "val/mel_err" in r] == [2]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    assert (logs / "val_gen_audio_0000002.wav").exists()
    assert state["d_opt"]["state"][0]["step"] == 3

    gen2, disc2 = ttrain.train("run", syn_dir, tmp_path, total_steps=5, cfg=SMALL, **kw)
    assert ckpt.steps() == [2, 4, 6]
    _, state = ckpt.restore_latest()
    assert state["d_opt"]["state"][0]["step"] == 4 and state["g_opt"]["state"][0]["step"] == 4
    assert not torch.equal(state["g"]["conv_pre.weight"], gen.state_dict()["conv_pre.weight"])

    ttrain.train("fre", syn_dir, tmp_path, arch="fregan", total_steps=1, val_every=0,
                 save_every=0, log_every=1, device="cpu",
                 cfg=dict(FRE_SMALL, use_stft_loss=True))
    rec = json.loads((tmp_path / "fre/logs_fregan/scalars.jsonl").read_text().splitlines()[0])
    assert np.isfinite(rec["train/mel"]) and rec["train/mel"] > 0
