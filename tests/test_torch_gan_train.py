"""The port's GAN-vocoder training (HiFi-GAN and Fre-GAN) against the JAX
package: flax's ``SpectralNorm`` semantics, both discriminator bundles at
their full widths, Fre-GAN's multi-resolution STFT loss, the dataset and
its batches, two f32 steps of the trainer against the JAX ``step_fn`` with
``optax.adamw`` and its schedule (a small generator, the full
discriminators), the bf16 step's losses and gradients, the weight bridge of
both discriminator trees, and ``train`` end to end with validation, a
checkpoint and a resume. flax parameters are drawn from numpy at the shapes
of ``jax.eval_shape``; the JAX side is jitted. float32 unless stated;
tolerances stated per test."""
import importlib
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mockingbird_tpu.config import Config as JConfig
from mockingbird_tpu.models.vocoder import dataset as jdata
from mockingbird_tpu.models.vocoder import fregan as jfregan
from mockingbird_tpu.models.vocoder import gan_losses as jlosses
from mockingbird_tpu.models.vocoder import hifigan as jhifigan
from mockingbird_tpu.models.tacotron import dataset as jtaco_data
from mockingbird_tpu.train.precision import Policy as JPolicy
from mockingbird_tpu_torch.models import layers as tl
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
# SpectralNorm
# ---------------------------------------------------------------------------

class _JSNConv(fnn.Module):
    """flax ``SpectralNorm(Conv)`` called ``n_calls`` times in one apply."""
    n_calls: int = 1

    @fnn.compact
    def __call__(self, x, update_stats: bool):
        sn = fnn.SpectralNorm(fnn.Conv(6, (5,), strides=(2,), padding="SAME",
                                       feature_group_count=2, name="conv_conv"), name="conv")
        return [sn(x, update_stats=update_stats) for _ in range(self.n_calls)]


class _TSNConv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = tl.SpectralNorm(tl.Conv1d(4, 6, 5, stride=2, groups=2))


@pytest.mark.parametrize("n_calls", [1, 2])
@pytest.mark.parametrize("update", [False, True])
def test_spectral_norm_matches_flax(update, n_calls):
    """flax's ``SpectralNorm`` around a strided grouped conv, (2, 9, 4)
    input: the outputs of one or two chained calls, the stored ``u`` and
    ``sigma`` (moved only with ``update_stats``, the second call starting
    from the first one's) within 1e-6, and the kernel's gradient through
    ``sigma`` within 1e-6 of its largest element (measured ~4e-7)."""
    x = np.random.RandomState(1).randn(2, 9, 4).astype(np.float32)
    jmod = _JSNConv(n_calls)
    var = _variables(jmod, x, False)
    tmod = load_flax(_TSNConv(), var)

    def f(params):
        outs, mut = jmod.apply({"params": params, "batch_stats": var["batch_stats"]}, x,
                               update, mutable=["batch_stats"])
        return sum(jnp.sum(o * o) for o in outs), (outs, mut["batch_stats"])

    (_, (outs, stats)), grads = jax.value_and_grad(f, has_aux=True)(var["params"])
    got = [tmod.conv(torch.from_numpy(x), update) for _ in range(n_calls)]
    for g, want in zip(got, outs):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(want), atol=1e-6)
    assert _max_diff(stats, to_flax(tmod)["batch_stats"]) <= 1e-6
    if not update:
        assert _max_diff(var["batch_stats"], to_flax(tmod)["batch_stats"]) == 0.0
    sum(torch.sum(g * g) for g in got).backward()
    want = np.transpose(np.asarray(grads["conv_conv"]["kernel"]), (2, 1, 0))
    np.testing.assert_allclose(tmod.conv.layer.weight.grad.numpy(), want,
                               atol=1e-6 * float(np.abs(want).max()))


def test_spectral_norm_bf16_matches_flax():
    """bf16 parameters and ``u`` (the JAX step casts its ``batch_stats``):
    the output within 2e-2 of flax's largest (bf16 keeps 8 bits; measured
    ~4e-3), the stored ``u`` and ``sigma`` within 1e-2 (measured 0)."""
    x = np.random.RandomState(1).randn(2, 9, 4).astype(np.float32)
    jmod = _JSNConv(2)
    var = _variables(jmod, x, False)
    pol = JPolicy.from_name("bf16")
    outs, mut = jmod.apply(pol.cast(jax.tree.map(jnp.asarray, var)), pol.cast(jnp.asarray(x)),
                           True, mutable=["batch_stats"])
    tmod = load_flax(_TSNConv(), var)
    conv = tmod.conv
    with torch.no_grad():
        conv.layer.weight.data = conv.layer.weight.data.bfloat16()
        conv.layer.bias.data = conv.layer.bias.data.bfloat16()
        got = [conv(torch.from_numpy(x).bfloat16(), True) for _ in range(2)]
    for g, want in zip(got, outs):
        want = np.asarray(want, np.float32)
        assert float(np.abs(g.float().numpy() - want).max()) <= 2e-2 * float(np.abs(want).max())
    stats = jax.tree.map(lambda a: np.asarray(a, np.float32), pol.uncast(mut["batch_stats"]))
    assert _max_diff(stats, to_flax(tmod)["batch_stats"]) <= 1e-2


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
# the training step
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


@pytest.fixture(scope="module")
def two_steps():
    """Two steps of the JAX trainer's ``step_fn`` (``optax.adamw`` with the
    trainer's schedule) from the same state with the discriminators on, and
    one step with them off, in float64; the two steps in float32 too."""
    out = {}
    for dtype, runs in ((np.float64, ((True, 2), (False, 1))), (np.float32, ((True, 2),))):
        with jax.enable_x64(dtype == np.float64):
            jc, gen, disc, gp, dvar, batch = _step_setup(dtype=dtype)
            tx = optax.adamw(jtrain._lr_schedule(jc), b1=jc.adam_b1, b2=jc.adam_b2)
            step_fn = jtrain.make_gan_step(gen, disc, tx, tx, jc, "fp32")
            jb = jax.tree.map(jnp.asarray, batch)
            for active, n in runs:
                g = jax.tree.map(jnp.asarray, gp)
                d = jax.tree.map(jnp.asarray, dvar)
                g_opt, d_opt = tx.init(g), tx.init(d["params"])
                losses = []
                for i in range(n):
                    g, d, g_opt, d_opt, *ls = step_fn(g, d, g_opt, d_opt, jb,
                                                      jnp.asarray(i + 1), active)
                    losses.append([float(v) for v in ls])
                out[dtype, active] = (gp, dvar, batch, losses, jax.tree.map(np.asarray, g),
                                      jax.tree.map(np.asarray, d))
    return out


def test_two_steps_match_jax(two_steps):
    """Two steps of ``make_gan_step`` against the JAX step's: the losses
    within 1e-5 relative, the generator's and the discriminators' parameters
    and the spectral-norm ``u``/``sigma`` within 1e-5, both optimizers'
    counts at 2. In float64 on both sides (measured ~1e-12): in float32 an
    element whose first-step gradient sits under Adam's eps (1e-8), or
    behind a leaky-ReLU input within rounding of 0 (the full discriminators
    hold millions), moves by ±lr on either side as rounding decides (a
    float32 run of this test: ~4e-4 on such elements, ~5e-7 elsewhere). The
    float32 steps and the float32 and bf16 gradients are held below."""
    gp, dvar, batch, losses, jg, jd = two_steps[np.float64, True]
    tc, tg, td, og, od = _port("hifigan", gp, dvar, torch.float64)
    step = ttrain.make_gan_step(tg, td, og, od, tc, "fp32")
    tb = _to_torch(batch)
    for want in losses:
        got = [float(v) for v in step(tb)]
        for g, w in zip(got, want):
            assert abs(g / w - 1) <= 1e-5, (got, want)
    assert _max_diff(jg, to_flax(tg)["params"]) <= 1e-5
    assert _max_diff(jd, to_flax(td)) <= 1e-5
    for opt, module in ((og, tg), (od, td)):
        assert all(float(opt.state[p]["step"]) == 2 for p in module.parameters())


def test_step_without_discriminators_matches_jax(two_steps):
    """Before ``disc_start_step`` (float64, as above): the generator's loss
    is the mel term alone, the discriminators and their optimizer do not
    move (no state, so the schedule's count stays 0), and the generator's
    step matches JAX's within 1e-5."""
    gp, dvar, batch, losses, jg, jd = two_steps[np.float64, False]
    tc, tg, td, og, od = _port("hifigan", gp, dvar, torch.float64)
    step = ttrain.make_gan_step(tg, td, og, od, tc, "fp32")
    g_loss, d_loss, mel = (float(v) for v in step(_to_torch(batch), False))
    assert d_loss == 0.0 and g_loss == mel
    assert abs(g_loss / losses[0][0] - 1) <= 1e-5 and abs(mel / losses[0][2] - 1) <= 1e-5
    assert _max_diff(jg, to_flax(tg)["params"]) <= 1e-5
    assert _max_diff(dvar, to_flax(td)) == 0.0 and not od.state


def test_two_f32_steps_match_jax(two_steps):
    """The two steps in float32, the trainer's own dtype: the losses within
    1e-5 relative; the generator's parameters within 1e-5 on every element
    (measured 1.1e-6); the discriminators' parameters within 1e-5 on all but
    1e-4 of their 70.7 M elements (measured 1185, 1.7e-5 of them, all in the
    period-5 discriminator), every element within 4·lr + 1e-5 (Adam moves
    one by at most ~lr a step; the 1185 differ by up to 2·lr); the
    spectral-norm ``u``/``sigma`` within 1e-5. The elements that differ have
    first-step gradients that agree between the packages (median
    |difference| 9e-11 against a median |gradient| of 1.5e-4) and are not
    small: their second-step gradients differ, as a leaky-ReLU input of the
    second step's forward that sits within float32 rounding of 0 takes the
    other slope on one side. A threshold on the first step's gradient
    leaves the largest difference at 2·lr, so none is applied."""
    gp, dvar, batch, losses, jg, jd = two_steps[np.float32, True]
    tc, tg, td, og, od = _port("hifigan", gp, dvar)
    step = ttrain.make_gan_step(tg, td, og, od, tc, "fp32")
    tb = _to_torch(batch, torch.float32)
    for want in losses:
        got = [float(v) for v in step(tb)]
        for g, w in zip(got, want):
            assert abs(g / w - 1) <= 1e-5, (got, want)
    assert _max_diff(jg, to_flax(tg)["params"]) <= 1e-5
    have, want = flatten_tree(to_flax(td)), flatten_tree(jax.tree.map(np.asarray, jd))
    assert set(have) == set(want)
    stats = [k for k in want if k.startswith("batch_stats/")]
    assert max(float(np.abs(have[k] - want[k]).max()) for k in stats) <= 1e-5
    diff = np.concatenate([np.abs(have[k] - want[k]).ravel() for k in want if k not in stats])
    assert (diff > 1e-5).mean() <= 1e-4 and diff.max() <= 4 * tc.learning_rate + 1e-5


def _port_grads(module):
    """The gradients a step left in ``module``, as its flax tree."""
    ref = type(module)(module.cfg) if hasattr(module, "cfg") else type(module)()
    with torch.no_grad():
        for (_, p), (_, q) in zip(module.named_parameters(), ref.named_parameters()):
            q.copy_(p.grad)
    return flatten_tree(to_flax(ref)["params"])


def _jax_losses_and_grads(jc, gen, disc, gp, dvar, batch, precision):
    """The JAX step's losses and gradients before any update, as
    ``make_gan_step`` computes them under ``precision``'s policy: the
    discriminators' on (y, ŷ) with ``train=True``, the generator's through
    the discriminators at the statistics that pass stored; and the
    generator's gradient of its loss without the mel term."""
    pol = JPolicy.from_name(precision)
    mels, y = jnp.asarray(batch["mels"]), jnp.asarray(batch["wavs"])

    def gen_apply(p):
        return pol.uncast(gen.apply({"params": pol.cast(p)}, pol.cast(mels)))

    def disc_apply(dp, stats, a, b, train):
        out = disc.apply({"params": pol.cast(dp), "batch_stats": pol.cast(stats)},
                         pol.cast(a), pol.cast(b), train,
                         mutable=["batch_stats"] if train else False)
        return pol.uncast(out)

    @jax.jit
    def run(gp, dp, stats):
        y_hat = gen_apply(gp)

        def d_loss_fn(dp):
            (mpd, msd), mut = disc_apply(dp, stats, y, jax.lax.stop_gradient(y_hat), True)
            loss = (jlosses.discriminator_loss(mpd[0], mpd[1])[0]
                    + jlosses.discriminator_loss(msd[0], msd[1])[0])
            return loss, mut["batch_stats"]

        (d_loss, new_stats), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(dp)

        def g_loss_fn(gp):
            y_hat = gen_apply(gp)
            mel = jnp.mean(jnp.abs(jtrain.mel_loss_fn(y, jc) - jtrain.mel_loss_fn(y_hat, jc))) * 45
            mpd, msd = disc_apply(dp, new_stats, y, y_hat, False)
            total = (mel + jlosses.feature_loss(mpd[2], mpd[3])
                     + jlosses.feature_loss(msd[2], msd[3])
                     + jlosses.generator_loss(mpd[1])[0] + jlosses.generator_loss(msd[1])[0])
            return total, mel

        (g_loss, mel), g_grads = jax.value_and_grad(g_loss_fn, has_aux=True)(gp)
        disc_grads = jax.grad(lambda gp: jnp.subtract(*g_loss_fn(gp)))(gp)
        return (g_loss, d_loss, mel), g_grads, d_grads, disc_grads

    losses, *grads = run(gp, dvar["params"], dvar["batch_stats"])
    return [[float(v) for v in losses]] + [flatten_tree(jax.tree.map(np.asarray, g))
                                           for g in grads]


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    return float(np.sqrt(num / sum(float((w ** 2).sum()) for w in want.values())))


@pytest.fixture(scope="module")
def one_step():
    """One step's losses and gradients, JAX's and the port's (the gradients
    its step leaves behind at a learning rate of 0), in f32 and in bf16:
    (losses, generator, discriminators, generator without the mel term).
    The port's last one from a step whose mel term weighs 0 (the STFT loss
    in its place, with ``lambda_aux`` 0)."""
    jc, gen, disc, gp, dvar, batch = _step_setup()
    out = {}
    for precision in ("fp32", "bf16"):
        want = _jax_losses_and_grads(jc, gen, disc, gp, dvar, batch, precision)
        tc, tg, td, og, od = _port("hifigan", gp, dvar, learning_rate=0.0)
        step = ttrain.make_gan_step(tg, td, og, od, tc, precision)
        got = [[float(v) for v in step(_to_torch(batch, torch.float32))],
               _port_grads(tg), _port_grads(td)]
        tc, tg, td, og, od = _port("hifigan", gp, dvar, learning_rate=0.0, use_stft_loss=True,
                                   lambda_aux=0.0)
        ttrain.make_gan_step(tg, td, og, od, tc, precision)(_to_torch(batch, torch.float32))
        out[precision] = want, got + [_port_grads(tg)]
    return out


def test_f32_losses_and_gradients_match_jax(one_step):
    """float32: the losses within 1e-5 relative, the gradients of the
    generator and of the discriminators within 1e-4 relative L2 (measured
    2.2e-5 and 9.1e-6: a leaky-ReLU input within rounding of 0 takes the
    other slope on one side)."""
    (want, g_want, d_want, _), (got, g_got, d_got, _) = one_step["fp32"]
    for g, w in zip(got, want):
        assert abs(g / w - 1) <= 1e-5, (got, want)
    assert _rel_l2(g_got, g_want) <= 1e-4
    assert _rel_l2(d_got, d_want) <= 1e-4


def test_bf16_losses_and_gradients_match_jax(one_step):
    """bf16, the trainer's default, against the JAX step under its bf16
    ``Policy`` (both with the spectral-norm ``u`` rounded to bf16): the
    losses within 3e-3 relative (measured 1.6e-3), the discriminators'
    gradients within 2.5e-2 relative L2 (measured 8.8e-3), and the
    generator's gradient through the discriminators (its loss without the
    mel term) within 2.5e-2 (measured 1.4e-2; JAX's own bf16 and f32 are
    2.8e-2 apart). The mel term's gradient is bf16 rounding noise at these
    random weights in both packages: the mel loss takes the log of the
    generated audio's mel power, so bins with little energy divide the
    rounding of the bf16 waveform by a small number (JAX's own bf16 and f32
    gradients of that term alone are 0.45 apart). With it, the generator's
    gradient is held to JAX's own rounding: within JAX's bf16-to-f32
    distance of JAX's bf16 gradient (measured 0.33 against 0.42), its norm
    within 10% of JAX's (measured 1.048 of it)."""
    (want, g_want, d_want, disc_want), (got, g_got, d_got, disc_got) = one_step["bf16"]
    for g, w in zip(got, want):
        assert abs(g / w - 1) <= 3e-3, (got, want)
    assert _rel_l2(d_got, d_want) <= 2.5e-2
    assert _rel_l2(disc_got, disc_want) <= 2.5e-2
    g_f32 = one_step["fp32"][0][1]
    assert _rel_l2(g_got, g_want) <= _rel_l2(g_want, g_f32)

    def norm(tree):
        return np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in tree.values()))
    assert abs(norm(g_got) / norm(g_want) - 1) <= 0.1


def test_transposed_conv_bf16_gradient_on_cpu():
    """HiFi-GAN's first upsampling layer (32 → 16 channels, kernel 8, stride
    4) in bf16 on the CPU: its input gradient within 1e-2 relative L2 of the
    same bf16 values' float64 gradient (measured 1.7e-3). oneDNN's bf16
    convolution with stride 4, which computes that gradient when the layer
    calls the transposed conv in bf16, returns sums 1.15 (relative L2) away
    from it at this shape; the layer runs in float32 on the CPU and rounds
    once."""
    rng = np.random.RandomState(0)
    layer = tl.ConvTranspose1d(32, 16, 8, 4).to(torch.bfloat16)
    x = torch.from_numpy(rng.randn(2, 32, 32).astype(np.float32)).bfloat16().requires_grad_()
    y = layer(x)
    ct = torch.from_numpy(rng.randn(*y.shape).astype(np.float32)).bfloat16()
    y.backward(ct)
    w = layer.kernel().detach().to(torch.bfloat16).double()
    x64 = x.detach().double().requires_grad_()
    torch.nn.functional.conv_transpose1d(x64, w, None, 4).backward(ct.double())
    err = float((x.grad.double() - x64.grad).norm() / x64.grad.norm())
    assert err <= 1e-2, err


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
