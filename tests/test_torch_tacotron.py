"""Parity of the port's Tacotron with the JAX package at small widths:
encode (CBHG, GST, speaker concat), N decode steps with LSA, the stop rule
with ``done_at``, the postnet, and ``Synthesizer.synthesize_spectrograms``.
Prenet dropout is off on both sides; BatchNorm running statistics are
perturbed from a numpy seed so that they matter. float32, atol 1e-4. And
the decode loop's stop flags, read once every 16 steps, against a loop that
reads them after each step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mockingbird_tpu.models.tacotron import Synthesizer as JSynth, Tacotron as JTaco
from mockingbird_tpu.models.tacotron import tacotron_config as jconfig
from mockingbird_tpu_torch.models.tacotron import Synthesizer as TSynth, Tacotron as TTaco
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



# the step (counted from 1, as ``done_at`` counts) at which each of four
# items first meets the stop rule, 0 for never; of the 40 steps asked the
# flags are read after steps 16, 32 and 40, and the rule holds from step 7
# (t·r > 10 at r = 2)
STOPS = {
    "inside_first_16": [9, 7, 12, 10],
    "on_a_boundary": [16, 9, 7, 12],
    "after_a_boundary": [17, 9, 16, 7],
    "on_the_second_boundary": [32, 17, 9, 16],
    "never": [9, 0, 17, 16],
}


def _per_step_loop(model, texts, spk, seed, max_steps, r, min_stop_token):
    """The decode loop reading the stop flags after every step."""
    gen = torch.Generator().manual_seed(seed)
    enc = model.encode(texts, spk, 0, "token", gen)
    b, n, m = texts.shape[0], max_steps // r, model.cfg.n_mels
    mel_buf = torch.zeros(n, b, r, m)
    carry, prev = model.init_carry(b, texts.shape[1]), torch.zeros(b, m)
    done = torch.zeros(b, dtype=torch.bool)
    done_at = torch.full((b,), n, dtype=torch.int64)
    t = 0
    while t < n:
        carry, (mel_r, _, stop) = model.decode_step(*enc, carry, prev, r, gen)
        mel_buf[t] = mel_r
        newly_done = (stop * 10 > min_stop_token) & (t * r > 10)
        done_at = torch.where(newly_done & ~done, t + 1, done_at)
        done = done | newly_done
        prev = mel_r[:, -1, :]
        t += 1
        if bool(done.all()):
            break
    return mel_buf.transpose(0, 1).reshape(b, max_steps, m), t * r, done_at * r


@pytest.mark.parametrize("case", list(STOPS))
def test_stop_flags_read_every_16_steps_match_a_per_step_loop(monkeypatch, case):
    """Frames, ``done_at`` and the mels (zero after the stop) equal those of
    a loop that reads the flags after each step, with dropout on; the stop
    head's output is replaced by a schedule so that items stop where
    ``STOPS`` says."""
    stops = STOPS[case]
    step, calls = TTaco.decode_step, [0]

    def scheduled(self, *args):
        carry, (mel_r, scores, _) = step(self, *args)
        calls[0] += 1
        return carry, (mel_r, scores, torch.tensor([float(0 < s <= calls[0]) for s in stops]))
    monkeypatch.setattr(TTaco, "decode_step", scheduled)
    syn = TSynth(cfg=tconfig().merge(dict(SMALL, prenet_dropout=True)), verbose=False,
                 seed=7, device="cpu")
    syn.load()
    rng = np.random.RandomState(4)
    texts = torch.from_numpy(rng.randint(1, 75, (4, 32)))
    texts[1:, 20:] = 0
    spk = torch.from_numpy(rng.randn(4, 8).astype(np.float32))
    with torch.no_grad():
        ref_mels, ref_n, ref_done = _per_step_loop(syn._model, texts, spk, 7, 80, 2, 5.0)
        calls[0] = 0
        mels, _, n, done_at = syn.generate(texts, spk, 80, 2, 0, "token", 5.0)
    last = max(stops) if 0 not in stops else 40
    assert ref_n == n == 2 * last
    want = [2 * (s or 40) for s in stops]
    assert ref_done.tolist() == done_at.tolist() == want
    np.testing.assert_array_equal(mels.numpy(), ref_mels.numpy())
    assert not mels[:, n:].any() and mels[:, :n].any(dim=-1).all()
