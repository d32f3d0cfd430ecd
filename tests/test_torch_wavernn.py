"""Parity of the port's WaveRNN vocoder with the JAX package at small widths
(rnn 32, 2 res blocks, hop 16): the upsampler with running statistics, the
packed sampler weights, the sampler's plain version against the Pallas
kernel in interpret mode (greedy, f32 packed weights: labels identical, as
``test_infra.py`` holds the scan), the sampler's Philox noise, and the fused
vocoder end to end."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mockingbird_tpu.config import Config as JConfig
from mockingbird_tpu.models.vocoder.wavernn import WaveRNN as JWaveRNN
from mockingbird_tpu.models.vocoder.wavernn import WaveRnnVocoder as JVocoder
from mockingbird_tpu.models.vocoder.wavernn import wavernn_config as jconfig
from mockingbird_tpu.ops.wavernn_sample import pack_wavernn_weights as jpack
from mockingbird_tpu.ops.wavernn_sample import wavernn_sample_pallas
from mockingbird_tpu_torch.models.vocoder import WaveRnnVocoder as TVocoder
from mockingbird_tpu_torch.models.vocoder import fold_with_overlap, xfade_and_unfold
from mockingbird_tpu_torch.ops import wavernn_sample as wavernn_sample_module
from mockingbird_tpu_torch.ops.wavernn_sample import (gumbel_noise, pack_wavernn_weights,
                                                      philox4x32_10, wavernn_sample,
                                                      wavernn_sample_plain)

SMALL = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16, res_blocks=2,
             upsample_factors=[4, 4], hop_size=16, seq_len=16 * 4, pad=2)


def to_numpy(tree):
    return ({k: to_numpy(v) for k, v in tree.items()} if isinstance(tree, dict)
            else np.asarray(tree, np.float32))


@pytest.fixture(scope="module")
def vocoders():
    jvoc = JVocoder(cfg=JConfig(jconfig()).merge(SMALL), verbose=False)
    variables = to_numpy(jvoc.variables)
    rng = np.random.RandomState(0)
    for name, stats in variables["batch_stats"]["upsample"]["resnet"].items():
        for bn in ([stats] if "mean" in stats else stats.values()):
            bn["mean"] = (rng.randn(*bn["mean"].shape) * 0.2).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    jvoc.variables = jax.tree.map(jnp.asarray, variables)
    tvoc = TVocoder(cfg=SMALL, verbose=False, variables=variables, device="cpu")
    # f32 sampler weights on both sides (both vocoders default to bf16, whose
    # rounding would turn 1e-6 differences upstream into label flips)
    jvoc._packed_w = jpack(jvoc.variables["params"], dtype=jnp.float32)
    tvoc.packed = pack_wavernn_weights(tvoc.model, torch.float32)
    return jvoc, tvoc


def test_upsample_features_match_jax(vocoders):
    jvoc, tvoc = vocoders
    mel = np.random.RandomState(1).randn(2, 24, 80).astype(np.float32) / 4
    ref = jax.jit(functools.partial(jvoc.model.apply, jvoc.variables,
                                    method=JWaveRNN.upsample_features))(jnp.asarray(mel))
    with torch.no_grad():
        out = tvoc.model.upsample_features(torch.from_numpy(mel))
    assert out[0].shape == (2, 20 * 16, 80) and out[1].shape == (2, 20 * 16, 16)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4)


def test_packed_weights_match_jax(vocoders):
    jvoc, tvoc = vocoders
    ref = jpack(jvoc.variables["params"], dtype=jnp.float32)
    out = pack_wavernn_weights(tvoc.model, torch.float32)
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))


def test_sampler_plain_matches_pallas_interpret(vocoders):
    """Greedy labels identical to the Pallas kernel (interpret mode, f32)."""
    jvoc, tvoc = vocoders
    rng = np.random.RandomState(2)
    mels = rng.randn(3, 150, 80).astype(np.float32) * 0.5
    aux = rng.randn(3, 150, 16).astype(np.float32) * 0.5
    ref = np.asarray(wavernn_sample_pallas(
        jpack(jvoc.variables["params"], dtype=jnp.float32), jnp.asarray(mels),
        jnp.asarray(aux), 0, 512, greedy=True, interpret=True, chunk=64))
    out = wavernn_sample(pack_wavernn_weights(tvoc.model, torch.float32),
                         torch.from_numpy(mels), torch.from_numpy(aux), 0, 512, greedy=True)
    assert out.dtype == torch.int32 and out.shape == (3, 150)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sampler_plain_sampled_mode_is_seeded(vocoders):
    """Sampled mode: same seed → same labels, other seed → other labels, and
    the labels spread over many classes (Gumbel-max, not argmax)."""
    _, tvoc = vocoders
    rng = np.random.RandomState(3)
    mels = torch.from_numpy(rng.randn(2, 64, 80).astype(np.float32))
    aux = torch.from_numpy(rng.randn(2, 64, 16).astype(np.float32))
    w = pack_wavernn_weights(tvoc.model, torch.float32)
    a = wavernn_sample_plain(w, mels, aux, 7)
    b = wavernn_sample_plain(w, mels, aux, 7)
    c = wavernn_sample_plain(w, mels, aux, 8)
    greedy = wavernn_sample_plain(w, mels, aux, 7, greedy=True)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, greedy)
    assert len(torch.unique(a)) > 20


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2, (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    """The plain sampler's Philox4x32-10 against the generator's published
    known-answer vectors (Random123), exact."""
    out = philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in counter), *key)
    assert tuple(int(o) for o in out) == want


def test_sampler_plain_noise_is_per_step(vocoders, monkeypatch):
    """The Gumbel noise depends on (seed, step, fold, class) alone: the plain
    sampler gives the same labels whatever the chunk of steps it draws at
    once, and a seed's high word changes the draw."""
    _, tvoc = vocoders
    rng = np.random.RandomState(6)
    mels = torch.from_numpy(rng.randn(3, 40, 80).astype(np.float32))
    aux = torch.from_numpy(rng.randn(3, 40, 16).astype(np.float32))
    w = pack_wavernn_weights(tvoc.model, torch.float32)
    whole = wavernn_sample_plain(w, mels, aux, 5)
    monkeypatch.setattr(wavernn_sample_module, "_NOISE_CHUNK", 3 * 512 * 7)
    assert torch.equal(wavernn_sample_plain(w, mels, aux, 5), whole)
    a = gumbel_noise(5, 3, 9, 3, 512, "cpu")
    assert torch.equal(a, gumbel_noise(5, 0, 40, 3, 512, "cpu")[3:9])
    assert not torch.equal(a, gumbel_noise(5 + 2**32, 3, 9, 3, 512, "cpu"))


def test_fold_helpers_match_jax():
    from mockingbird_tpu.models.vocoder import wavernn as jw
    x = np.random.RandomState(4).randn(1, 5000, 3)
    np.testing.assert_array_equal(fold_with_overlap(x, 1000, 100),
                                  jw.fold_with_overlap(x, 1000, 100))
    y = np.random.RandomState(5).randn(4, 1200)
    np.testing.assert_array_equal(xfade_and_unfold(y, 100), jw.xfade_and_unfold(y, 100))


def test_infer_waveform_batch_matches_jax_fused(vocoders):
    """Bucketed mel → upsample → device fold → sampler → crossfade, greedy,
    against the JAX package's fused path with the kernel in interpret mode."""
    jvoc, tvoc = vocoders
    rng = np.random.RandomState(6)
    mels = [rng.randn(80, 30).astype(np.float32), rng.randn(80, 45).astype(np.float32)]
    ref = jvoc.infer_waveform_batch(mels, target=600, overlap=100, greedy=True,
                                    interpret=True)
    out = tvoc.infer_waveform_batch(mels, target=600, overlap=100, greedy=True)
    assert [o.shape for o in out] == [r.shape for r in ref] == [(29 * 16,), (44 * 16,)]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, atol=1e-6)
