"""Parity of the port's Tacotron with the JAX package at small widths:
encode (CBHG, GST, speaker concat), N decode steps with LSA, the stop rule
with ``done_at``, the postnet, and ``Synthesizer.synthesize_spectrograms``.
Prenet dropout is off on both sides; BatchNorm running statistics are
perturbed from a numpy seed so that they matter. float32, atol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mockingbird_tpu.models.tacotron import Synthesizer as JSynth, Tacotron as JTaco
from mockingbird_tpu.models.tacotron import tacotron_config as jconfig
from mockingbird_tpu_torch.models.tacotron import Synthesizer as TSynth
from mockingbird_tpu_torch.models.tacotron import tacotron_config as tconfig

SMALL = dict(embed_dims=32, encoder_dims=16, decoder_dims=16, postnet_dims=32,
             lstm_dims=32, gst_E=16, gst_num_heads=4, gst_ref_filters=(4, 4),
             speaker_embedding_size=8, max_r=4, n_mels=20, fft_bins=20,
             prenet_dropout=False)
ATOL = 1e-4


def to_numpy(tree):
    return ({k: to_numpy(v) for k, v in tree.items()} if isinstance(tree, dict)
            else np.asarray(tree, np.float32))


def perturb_stats(tree, rng):
    """Random BatchNorm running statistics (mean ±0.2, var in [0.5, 1.5])."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb_stats(v, rng)
        elif k == "mean":
            out[k] = (rng.randn(*v.shape) * 0.2).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def synths():
    jsyn = JSynth(cfg=jconfig().merge(SMALL), verbose=False)
    jsyn.load()
    variables = to_numpy(jsyn._variables)
    variables["batch_stats"] = perturb_stats(variables["batch_stats"], np.random.RandomState(0))
    jsyn._variables = jax.tree.map(jnp.asarray, variables)
    tsyn = TSynth(cfg=tconfig().merge(SMALL), verbose=False, variables=variables, device="cpu")
    tsyn.load()
    return jsyn, tsyn


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    texts = np.zeros((2, 32), np.int64)
    texts[0, :20] = rng.randint(1, 75, 20)
    texts[1, :9] = rng.randint(1, 75, 9)
    spk = rng.randn(2, 8).astype(np.float32)
    spk /= np.linalg.norm(spk, axis=1, keepdims=True)
    return texts, spk


@pytest.mark.parametrize("style_mode,style_idx", [("token", 3), ("neutral", 0), ("train", 0)])
def test_encode_matches_jax(synths, style_mode, style_idx):
    jsyn, tsyn = synths
    texts, spk = _inputs()
    ref = jsyn._model.apply(jsyn._variables, jnp.asarray(texts, jnp.int32), jnp.asarray(spk),
                            False, style_idx, style_mode, method=JTaco.encode)
    with torch.no_grad():
        out = tsyn._model.encode(torch.from_numpy(texts), torch.from_numpy(spk),
                                 style_idx, style_mode)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)


def test_decode_steps_and_postnet_match_jax(synths):
    """Encode, then 12 decode steps fed their own last frame, then the postnet."""
    jsyn, tsyn = synths
    texts, spk = _inputs(1)
    jm, tm, v = jsyn._model, tsyn._model, jsyn._variables
    enc = jm.apply(v, jnp.asarray(texts, jnp.int32), jnp.asarray(spk), False, 0, "token",
                   method=JTaco.encode)
    carry = jm.apply(v, 2, 32, method=JTaco.init_carry)
    prev = jnp.zeros((2, 20))
    with torch.no_grad():
        tenc = tm.encode(torch.from_numpy(texts), torch.from_numpy(spk), 0, "token")
        tcarry = tm.init_carry(2, 32)
        tprev = torch.zeros(2, 20)
        jmels, tmels = [], []
        for _ in range(12):
            carry, (mel, scores, stop) = jm.apply(v, *enc, carry, prev, 2,
                                                  method=JTaco.decode_step)
            tcarry, (tmel, tscores, tstop) = tm.decode_step(*tenc, tcarry, tprev, 2)
            np.testing.assert_allclose(tmel.numpy(), np.asarray(mel), atol=ATOL)
            np.testing.assert_allclose(tscores.numpy(), np.asarray(scores), atol=ATOL)
            np.testing.assert_allclose(tstop.numpy(), np.asarray(stop), atol=ATOL)
            prev, tprev = mel[:, -1], tmel[:, -1]
            jmels.append(np.asarray(mel))
            tmels.append(tmel)
        jm_all = np.concatenate(jmels, axis=1)
        post = tm.postnet_apply(torch.cat(tmels, dim=1)).numpy()
    ref_post = np.asarray(jm.apply(v, jnp.asarray(jm_all), False, method=JTaco.postnet_apply))
    assert post.shape == (2, 24, 20)
    np.testing.assert_allclose(post, ref_post, atol=ATOL)


@pytest.mark.parametrize("min_stop_token", [5.0, 4.0, -1.0])
def test_stop_rule_matches_jax(synths, min_stop_token):
    """Frames generated, the per-item ``done_at`` and the mels themselves."""
    jsyn, tsyn = synths
    texts, spk = _inputs(2)
    gen = jsyn._generate_fn(32, 200, 2, "token")
    jm, _, _, jn, jdone = gen(jsyn._variables, jnp.asarray(texts, jnp.int32),
                              jnp.asarray(spk), jax.random.PRNGKey(0), jnp.asarray(0),
                              jnp.asarray(min_stop_token))
    tm, _, tn, tdone = tsyn.generate(torch.from_numpy(texts), torch.from_numpy(spk),
                                     200, 2, 0, "token", min_stop_token)
    assert tn == int(jn)
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(tm[:, :tn].numpy(), np.asarray(jm)[:, :tn], atol=ATOL)


def test_synthesize_spectrograms_matches_jax(synths):
    jsyn, tsyn = synths
    texts = ["ni3 hao3", "你好，世界"]
    spk = np.random.RandomState(3).randn(2, 8).astype(np.float32)
    ref = jsyn.synthesize_spectrograms(texts, spk, steps=60)
    out = tsyn.synthesize_spectrograms(texts, spk, steps=60)
    assert [o.shape for o in out] == [r.shape for r in ref]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, r, atol=ATOL)

