"""Parity of the port's GAN vocoders with the JAX package: the HiFi-GAN
``Generator`` (small, stock, sidecar and odd rates, the interpolation
branch, ResBlock2, an even resblock kernel, a sliced transposed window; in
bf16 too) and ``FreGanGenerator`` (small and stock rates) at 32 channels,
``dwt_haar``,
the committed ``saved_models/gan_run`` export at full width, ``GanVocoder``
(f32 and ``half=True``), its PCM formats, and the mu-law helpers. flax
parameters are drawn from a numpy seed at the shapes flax's ``init`` gives,
and carried across with ``weights.load_flax``. Tolerances per test: f32
generators max abs 1e-4, the full-width export 1e-3, bf16 a relative L2
(measured 5.9e-3 at small width, 9.0e-3 at full width) under 2e-2."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mockingbird_tpu.config import Config as JConfig
from mockingbird_tpu.dsp import decode_mulaw8_to_int16 as j_decode8
from mockingbird_tpu.dsp import encode_mu_law as j_encode_mu_law
from mockingbird_tpu.dsp import encode_mulaw8_device as j_encode8
from mockingbird_tpu.dsp import float_2_label as j_float_2_label
from mockingbird_tpu.models.vocoder import GanVocoder as JGanVocoder
from mockingbird_tpu.models.vocoder import fregan as jf
from mockingbird_tpu.models.vocoder import hifigan as jh
from mockingbird_tpu_torch import dsp as tdsp
from mockingbird_tpu_torch.config import Config
from mockingbird_tpu_torch.models.vocoder import GanVocoder, fregan as tf, hifigan as th
from mockingbird_tpu_torch.weights import flatten_tree, load_flax

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4
SMALL = dict(upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=32,
             resblock_kernel_sizes=[3, 7], resblock_dilation_sizes=[[1, 3], [1, 3]],
             segment_size=1600, hop_size=16)
SIDECAR = dict(SMALL, upsample_rates=[8, 8, 4], upsample_kernel_sizes=[16, 16, 8],
               hop_size=256)
# odd rates (output_padding 1), one block a stage
ODD_RATES = dict(upsample_rates=[5, 3], upsample_kernel_sizes=[10, 6],
                 resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3, 5]], hop_size=15)
# ResBlock2, an even resblock kernel, and a transposed kernel (k=5, u=2)
# whose window the conv's own padding cannot take: the output is sliced
SLICED_WINDOW = dict(upsample_rates=[4, 2], upsample_kernel_sizes=[8, 5], resblock="2",
                     resblock_kernel_sizes=[3, 4], resblock_dilation_sizes=[[1, 3], [1, 3]],
                     hop_size=8)
FREGAN = dict(upsample_rates=[4, 2, 2], upsample_kernel_sizes=[8, 4, 4],
              upsample_initial_channel=32, resblock_kernel_sizes=[3, 5],
              resblock_dilation_sizes=[[1, 3], [1, 3]], top_k=2, hop_size=16)


def random_params(shapes, rng, sd=0.1):
    """A param tree at flax's shapes: kernels N(0, 1/fan_in), weight-norm
    gains 1 + N(0, sd²), biases N(0, sd²)."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = random_params(v, rng, sd)
        elif k == "kernel":
            out[k] = (rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
        elif k.endswith("scale"):
            out[k] = (1.0 + sd * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = (sd * rng.randn(*v.shape)).astype(np.float32)
    return out


def flax_params(jmod, x, seed=0):
    shapes = jax.eval_shape(lambda k: jmod.init(k, x), jax.random.PRNGKey(0))
    return random_params(shapes["params"], np.random.RandomState(seed))


def to_numpy(tree):
    return ({k: to_numpy(v) for k, v in tree.items()} if isinstance(tree, dict)
            else np.asarray(tree, np.float32))


def mel_batch(b=2, t=13, seed=1):
    return (np.random.RandomState(seed).randn(b, t, 80) - 1.0).astype(np.float32)


def pair(jcls, tcls, jcfg, tcfg, mel):
    """JAX module and its variables, the port module with the same weights."""
    jmod = jcls(jcfg.freeze())
    params = flax_params(jmod, mel)
    tmod = load_flax(tcls(tcfg), params)
    return jmod, {"params": jax.tree.map(jnp.asarray, params)}, tmod.eval(), params


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name,extra", [
    ("small rates", {}),
    ("stock rates", dict(upsample_rates=[5, 5, 4, 2], upsample_kernel_sizes=[10, 10, 8, 4],
                         hop_size=200)),
    ("sidecar rates", SIDECAR),
    ("interpolation", dict(use_interpolation=True)),
    ("24 kHz", dict(sample_rate=24000)),
    ("resblock 2", dict(resblock="2")),
    # flax SAME pads an even kernel one more on the right; the port computes
    # flax's padding rather than assume a symmetric one
    ("even resblock kernel", dict(resblock_kernel_sizes=[4], resblock_dilation_sizes=[[1, 2]])),
    ("odd rates", ODD_RATES),
    ("sliced window", SLICED_WINDOW),
])
def test_generator_matches_jax(name, extra):
    cfg = dict(SMALL, **extra)
    mel = mel_batch()
    jmod, v, tmod, _ = pair(jh.Generator, th.Generator,
                            JConfig(jh.hifigan_config()).merge(cfg),
                            Config(th.hifigan_config()).merge(cfg), mel)
    ref = np.asarray(jmod.apply(v, mel))
    with torch.no_grad():
        out = tmod(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,extra", [
    ("small rates", {}),
    ("odd rates", ODD_RATES),
    ("sliced window", SLICED_WINDOW),
    ("interpolation", dict(use_interpolation=True)),
])
def test_half_generator_matches_jax_half(name, extra):
    """Every weight and the mel in bf16 on both sides (jitted on the JAX
    side, as ``GanVocoder(half=True)`` runs it): relative L2 under 2e-2,
    the tolerance of ``test_half_vocoder_matches_jax_half``."""
    cfg = dict(SMALL, **extra)
    mel = mel_batch()
    jmod = jh.Generator(JConfig(jh.hifigan_config()).merge(cfg).freeze())
    params = flax_params(jmod, mel)
    fwd = jax.jit(lambda p, m: jmod.apply({"params": p}, m.astype(jnp.bfloat16))
                  .astype(jnp.float32))
    ref = np.asarray(fwd(jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params), mel))
    voc = GanVocoder("hifigan", cfg=cfg, variables=params, verbose=False, device="cpu")
    out = voc._fwd(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape
    assert rel_l2(out, ref) < 2e-2, rel_l2(out, ref)


@pytest.mark.parametrize("name,extra", [
    ("small, top_k 2", {}),
    # the stock rates and four conditioning levels, at 32 channels
    ("stock rates", dict(upsample_rates=[5, 5, 2, 2, 2], upsample_kernel_sizes=[10, 10, 4, 4, 4],
                         top_k=4, hop_size=200)),
])
def test_fregan_generator_matches_jax(name, extra):
    cfg = dict(FREGAN, **extra)
    mel = mel_batch()
    jmod, v, tmod, _ = pair(jf.FreGanGenerator, tf.FreGanGenerator,
                            JConfig(jf.fregan_config()).merge(cfg),
                            Config(tf.fregan_config()).merge(cfg), mel)
    ref = np.asarray(jmod.apply(v, mel))
    with torch.no_grad():
        out = tmod(torch.from_numpy(mel)).numpy()
    assert out.shape == (2, 13 * cfg["hop_size"])
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [64, 65])
def test_dwt_haar_matches_jax(t):
    x = np.random.RandomState(0).randn(2, 3, t).astype(np.float32)
    for got, ref in zip(tf.dwt_haar(torch.from_numpy(x)), jf.dwt_haar(jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def export():
    """The committed HiFi-GAN export (its generator tree) and its sidecar."""
    from mockingbird_tpu.train.checkpoint import load_single
    tree = load_single(ROOT / "saved_models/gan_run/vocoder_hifigan.ckpt")
    cfg = json.loads((ROOT / "saved_models/gan_run/vocoder_hifigan.json").read_text())
    return to_numpy(tree.get("g", tree.get("params", tree))), cfg


@pytest.mark.parametrize("half", [False, True])
def test_committed_export_matches_jax(export, half):
    """Full width (512 channels, rates 8/8/4), 16 frames: f32 max abs 1e-3;
    ``half=True`` on both sides (every weight and the mel in bf16, jitted on
    the JAX side, as ``GanVocoder`` runs it) relative L2 under 2e-2."""
    g, cfg = export
    jmod = jh.Generator(JConfig(cfg).freeze())
    mel = mel_batch(1, 16, seed=3)
    cast = (lambda x: x.astype(jnp.bfloat16)) if half else (lambda x: x)
    fwd = jax.jit(lambda p, m: jmod.apply({"params": p}, cast(m)).astype(jnp.float32))
    ref = np.asarray(fwd(jax.tree.map(lambda x: cast(jnp.asarray(x)), g), mel))
    voc = GanVocoder("hifigan", cfg=cfg, variables=g, half=half, verbose=False, device="cpu")
    out = voc._fwd(torch.from_numpy(mel)).numpy()
    assert out.shape == (1, 16 * 256)
    if half:
        assert rel_l2(out, ref) < 2e-2, rel_l2(out, ref)
    else:
        np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def vocoders():
    """JAX ``GanVocoder`` at small width (weights from its init), and the
    port's with the same weights, f32 and ``half=True`` each."""
    out = {}
    for half in (False, True):
        jv = JGanVocoder("hifigan", cfg=SMALL, verbose=False, half=half)
        tv = GanVocoder("hifigan", cfg=SMALL, variables=to_numpy(jv.params), half=half,
                        verbose=False, device="cpu")
        out[half] = jv, tv
    return out


def test_infer_waveform_matches_jax(vocoders):
    """(M, T) mels of ragged lengths, padded with each mel's minimum to a
    64-frame bucket and trimmed to T·hop."""
    jv, tv = vocoders[False]
    rng = np.random.RandomState(5)
    mels = [(rng.randn(80, t) - 2).astype(np.float32) for t in (37, 70)]
    for got, ref in zip(tv.infer_waveform_batch(mels), jv.infer_waveform_batch(mels)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    got, ref = tv.infer_waveform(mels[0]), jv.infer_waveform(mels[0])
    assert got.shape == (37 * 16,)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_half_vocoder_matches_jax_half(vocoders):
    jv, tv = vocoders[True]
    assert all(p.dtype == torch.bfloat16 for p in tv.model.parameters())
    mel = mel_batch(2, 21, seed=7)
    ref = np.asarray(jv.vocode_device(jnp.asarray(mel), pcm_format="float32"))
    out = tv.vocode_device(torch.from_numpy(mel), pcm_format="float32")
    assert out.dtype == torch.float32
    assert rel_l2(out.numpy(), ref) < 2e-2, rel_l2(out.numpy(), ref)


def _near_boundary(v, tol):
    """Per sample, whether ``v`` (in units of the quantisation step, rounded
    half up or to even) lies within ``tol`` of a rounding boundary, where an
    f32 difference in the last bits may flip the result."""
    v = np.asarray(v, np.float64)
    return np.abs(v - np.floor(v) - 0.5) < tol


def _mulaw_index(wav, mu=255.0):
    """The companded value in label units, before ``floor(· + 0.5)``."""
    x = np.clip(np.asarray(wav, np.float64), -1, 1)
    return (np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu) + 1) / 2 * mu


def test_vocode_device_pcm_formats_match_jax(vocoders):
    """int16 and mulaw8 from the same f32 weights and mel: equal except at
    most one sample, and only one whose value lies next to a rounding
    boundary in JAX's f32 wave (int16: within 1e-6 of it; mulaw8: the
    companded value within 1e-5); float32 within 1e-4."""
    jv, tv = vocoders[False]
    mel = mel_batch(2, 21, seed=9)
    wav = np.asarray(jv.vocode_device(jnp.asarray(mel), pcm_format="float32"))
    np.testing.assert_allclose(tv.vocode_device(torch.from_numpy(mel), pcm16=False).numpy(),
                               wav, atol=ATOL, rtol=0)
    near = {"int16": _near_boundary(np.clip(wav, -1, 1) * 32767.0, 1e-6 * 32767.0),
            "mulaw8": _near_boundary(_mulaw_index(wav), 1e-5 * 255.0 / 2)}
    for fmt, dtype in (("int16", np.int16), ("mulaw8", np.uint8)):
        ref = np.asarray(jv.vocode_device(jnp.asarray(mel), pcm_format=fmt))
        out = tv.vocode_device(torch.from_numpy(mel), pcm_format=fmt).numpy()
        assert out.dtype == ref.dtype == dtype
        differ = out != ref
        assert not (differ & ~near[fmt]).any(), fmt
        assert differ.sum() <= 1, (fmt, int(differ.sum()))
    with pytest.raises(KeyError):
        tv.vocode_device(torch.from_numpy(mel), pcm_format="mp3")


def test_mulaw_helpers_match_jax():
    """On one f32 wave (with the exact ends ±1 and 0, and values beyond
    them): the 8-bit labels equal JAX's except at most one whose companded
    value lies within 1e-5 of a label boundary; ``encode_mu_law`` (numpy and
    torch), ``float_2_label`` and the 256-entry decode table equal."""
    rng = np.random.RandomState(0)
    wav = np.concatenate([np.tanh(rng.randn(20000) * 0.5), [-1.0, 0.0, 1.0, 1.5, -2.0]])
    wav = wav.astype(np.float32)
    ref = np.asarray(j_encode8(jnp.asarray(wav)))
    out = tdsp.encode_mulaw8_device(torch.from_numpy(wav)).numpy()
    assert out.dtype == np.uint8
    differ = out != ref
    assert not (differ & ~_near_boundary(_mulaw_index(wav), 1e-5 * 255.0 / 2)).any()
    assert differ.sum() <= 1
    clipped = np.clip(wav, -1, 1)
    np.testing.assert_array_equal(tdsp.encode_mu_law(clipped, 512),
                                  j_encode_mu_law(clipped, 512))
    np.testing.assert_array_equal(
        tdsp.encode_mu_law(torch.from_numpy(clipped), 512).numpy(),
        np.asarray(j_encode_mu_law(jnp.asarray(clipped), 512)))
    np.testing.assert_array_equal(tdsp.float_2_label(wav, 9), j_float_2_label(wav, 9))
    labels = np.arange(256, dtype=np.uint8)
    lut = tdsp.decode_mulaw8_to_int16(labels)
    assert lut.dtype == np.int16
    np.testing.assert_array_equal(lut, j_decode8(labels))
    np.testing.assert_array_equal(tdsp.decode_mulaw8_to_int16(out.reshape(5, -1)),
                                  j_decode8(out).reshape(5, -1))


def test_npz_export_with_sidecar_loads(tmp_path, vocoders):
    """An ``.npz`` of the JAX tree under ``g`` with a ``.json`` sidecar: the
    sidecar replaces the stock config and the weights load strictly."""
    jv, _ = vocoders[False]
    np.savez(tmp_path / "vocoder_hifigan.npz", **flatten_tree({"g": to_numpy(jv.params)}))
    (tmp_path / "vocoder_hifigan.json").write_text(json.dumps(dict(jv.cfg)))
    voc = GanVocoder("hifigan", tmp_path / "vocoder_hifigan.npz", half=False, verbose=False,
                     device="cpu")
    assert voc.cfg.upsample_rates == SMALL["upsample_rates"] and voc.cfg.hop_size == 16
    mel = mel_batch(1, 10)
    np.testing.assert_allclose(voc.vocode_device(torch.from_numpy(mel), pcm16=False).numpy(),
                               np.asarray(jv.vocode_device(jnp.asarray(mel), pcm16=False)),
                               atol=ATOL, rtol=0)
