"""Parity of the port's Griffin-Lim path with the JAX package on the CPU:
``istft``, ``inv_preemphasis``, ``linearspectrogram``, ``denormalize_db``/
``db_to_amp``, ``spsi``, ``griffin_lim`` and ``inv_mel_spectrogram`` (JAX's
initial angles handed in), the ``Synthesizer``'s ``griffin_lim``,
``make_spectrogram`` and ``load_preprocess_wav``, and the LogMMSE copy.
The SV2TTS audio config (n_fft 1024, hop 256). Tolerance: relative L2 1e-3
for the Griffin-Lim outputs, stated per test otherwise."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mockingbird_tpu.config import sv2tts_audio_config as j_audio_cfg
from mockingbird_tpu.dsp import logmmse as jlogmmse
from mockingbird_tpu.models.tacotron import Synthesizer as JSynth
from mockingbird_tpu_torch.config import sv2tts_audio_config
from mockingbird_tpu_torch.dsp import logmmse as tlogmmse
from mockingbird_tpu_torch.models.tacotron import Synthesizer as TSynth

# the ``stft`` function shadows the submodule of that name in both packages
js = importlib.import_module("mockingbird_tpu.dsp.stft")
ts = importlib.import_module("mockingbird_tpu_torch.dsp.stft")
REF_WAV = "saved_models/gan_run/eval/ground_truth.wav"
RTOL = 1e-3


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def t(a):
    return torch.from_numpy(np.array(a))


def speech(seconds=0.6):
    """A harmonic tone with vibrato and noise at 16 kHz, from a numpy seed."""
    rng = np.random.RandomState(0)
    tt = np.arange(int(16000 * seconds)) / 16000
    f0 = 140 * (1 + 0.05 * np.sin(2 * np.pi * 5 * tt))
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    wav = sum(0.2 / k * np.sin(k * phase) for k in range(1, 6)) + 0.01 * rng.randn(len(tt))
    return wav.astype(np.float32)


@pytest.fixture(scope="module")
def mel():
    """The SV2TTS mel of ``speech()`` (T, 80), from the JAX package."""
    return np.asarray(js.melspectrogram(jnp.asarray(speech()), j_audio_cfg()))


@pytest.mark.parametrize("n_fft,hop,win", [(1024, 256, 1024), (800, 200, 640), (512, 160, 512)])
def test_istft_matches_jax(n_fft, hop, win):
    """Both overlap-add routes (hop divides n_fft, and a scatter-add where it
    does not), a window shorter than n_fft, and a batch axis."""
    rng = np.random.RandomState(1)
    re, im = (rng.randn(2, 12, n_fft // 2 + 1).astype(np.float32) for _ in range(2))
    ref = np.asarray(js.istft(jnp.asarray(re), jnp.asarray(im), n_fft, hop, win, length=1500))
    out = ts.istft(t(re), t(im), n_fft, hop, win, length=1500).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [100, 256, 257, 70000])
def test_inv_preemphasis_matches_jax(n):
    """The blocked IIR against JAX's scan: one block, its edge, and three
    levels of blocks; relative L2 1e-5, and ``preemphasis`` inverts it."""
    x = np.random.RandomState(2).randn(2, n).astype(np.float32) * 0.1
    ref = np.asarray(js.inv_preemphasis(jnp.asarray(x), 0.97))
    out = ts.inv_preemphasis(t(x), 0.97)
    assert rel_l2(out.numpy(), ref) < 1e-5, rel_l2(out.numpy(), ref)
    np.testing.assert_allclose(ts.preemphasis(out, 0.97).numpy(), x, atol=1e-5, rtol=0)


def test_spectrogram_helpers_match_jax():
    """The linear spectrogram in normalised dB (±4) within 1e-3 (f32
    rounding of the smallest magnitudes grows through the log); the dB
    helpers within 1e-4 and 1e-5 relative."""
    cfg, jcfg = sv2tts_audio_config(), j_audio_cfg()
    wav = speech()
    np.testing.assert_allclose(ts.linearspectrogram(t(wav), cfg).numpy(),
                               np.asarray(js.linearspectrogram(jnp.asarray(wav), jcfg)),
                               atol=1e-3, rtol=0)
    d = np.random.RandomState(3).uniform(-5, 5, (20, 80)).astype(np.float32)
    for symmetric in (True, False):
        got = ts.denormalize_db(t(d), -100.0, 4.0, symmetric)
        ref = js.denormalize_db(jnp.asarray(d), -100.0, 4.0, symmetric)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
        np.testing.assert_allclose(ts.db_to_amp(got).numpy(), np.asarray(js.db_to_amp(ref)),
                                   rtol=1e-5, atol=0)


def test_spsi_matches_jax(mel):
    """Single-pass inversion of a linear magnitude: relative L2 1e-3."""
    s = np.abs(np.asarray(js.stft_magnitude(jnp.asarray(speech()), 1024, 256, 1024)))
    ref = np.asarray(js.spsi(jnp.asarray(s), 1024, 256, 1024))
    out = ts.spsi(t(s), 1024, 256, 1024).numpy()
    assert out.shape == ref.shape
    assert rel_l2(out, ref) < RTOL, rel_l2(out, ref)


def _jax_angles(shape, seed=0):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=0.0,
                                         maxval=2 * np.pi))


def test_griffin_lim_matches_jax():
    """20 iterations from JAX's angles: relative L2 1e-3."""
    s = np.asarray(js.stft_magnitude(jnp.asarray(speech()), 1024, 256, 1024))
    angles = _jax_angles(s.shape, 4)
    ref = np.asarray(js.griffin_lim(jnp.asarray(s), 1024, 256, 1024, n_iters=20,
                                    key=jax.random.PRNGKey(4)))
    out = ts.griffin_lim(t(s), 1024, 256, 1024, n_iters=20, angles=t(angles)).numpy()
    assert out.shape == ref.shape == (256 * (s.shape[0] - 1),)
    assert rel_l2(out, ref) < RTOL, rel_l2(out, ref)
    # without angles the phase comes from the generator: repeatable
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    a = ts.griffin_lim(t(s), 1024, 256, 1024, n_iters=2, generator=gen())
    np.testing.assert_array_equal(a.numpy(), ts.griffin_lim(t(s), 1024, 256, 1024, n_iters=2,
                                                            generator=gen()).numpy())


@pytest.mark.parametrize("fast_phase", [False, True])
def test_inv_mel_spectrogram_matches_jax(mel, fast_phase):
    """The whole inversion (denormalise, pinv, GL with 60 iterations or
    SPSI, inverse preemphasis), JAX's default key's angles handed in:
    relative L2 1e-3."""
    cfg, jcfg = sv2tts_audio_config(), j_audio_cfg()
    cfg.use_fast_phase = jcfg.use_fast_phase = fast_phase
    ref = np.asarray(js.inv_mel_spectrogram(jnp.asarray(mel), jcfg))
    angles = _jax_angles((mel.shape[0], cfg.n_fft // 2 + 1))
    out = ts.inv_mel_spectrogram(t(mel), cfg, angles=t(angles)).numpy()
    assert out.shape == ref.shape
    assert rel_l2(out, ref) < RTOL, rel_l2(out, ref)


def test_synthesizer_wav_helpers_match_jax():
    """``load_preprocess_wav`` (LogMMSE denoise) and ``make_spectrogram``
    on the committed reference wav, and ``griffin_lim`` on its mel with
    JAX's angles: relative L2 1e-3 (the denoised wav 1e-5)."""
    jsyn = JSynth(verbose=False)
    tsyn = TSynth(verbose=False, device="cpu")
    ref_wav = jsyn.load_preprocess_wav(REF_WAV)
    wav = tsyn.load_preprocess_wav(REF_WAV)
    assert wav.shape == ref_wav.shape and wav.dtype == np.float32
    assert rel_l2(wav, ref_wav) < 1e-5
    ref_mel = jsyn.make_spectrogram(REF_WAV)
    got_mel = tsyn.make_spectrogram(REF_WAV)
    assert got_mel.shape == ref_mel.shape and got_mel.shape[0] == 80
    np.testing.assert_allclose(got_mel, ref_mel, atol=1e-3, rtol=0)
    ref = jsyn.griffin_lim(ref_mel)
    angles = _jax_angles((ref_mel.shape[1], 513))
    out = tsyn.griffin_lim(ref_mel, angles=t(angles))
    assert out.shape == ref.shape
    assert rel_l2(out, ref) < RTOL, rel_l2(out, ref)


def test_logmmse_copy_matches_jax():
    wav = speech(1.0) + 0.02 * np.random.RandomState(5).randn(16000).astype(np.float32)
    jp, tp = (m.profile_noise(wav[:3200], 16000) for m in (jlogmmse, tlogmmse))
    np.testing.assert_array_equal(tp.noise_mu2, jp.noise_mu2)
    np.testing.assert_array_equal(tlogmmse.denoise(wav, tp), jlogmmse.denoise(wav, jp))
