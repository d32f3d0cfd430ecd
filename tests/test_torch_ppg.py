"""The PPG voice-conversion slice against the JAX package at small widths
(output 24, 2 heads, 2 blocks; decoder 32 wide, 20 mels): the f0 copy, the
frontend, the relative-position attention, the Conformer with both input
layers, the extractor, the ppg2mel building blocks, the teacher-forced
decoder, ``decode_step`` and ``VoiceConverter.convert_wavs``. Weights are the
JAX side's, carried across by ``load_flax``; BatchNorm running statistics
and the attention's u/v biases are drawn from a numpy seed so that they
matter; inputs come from a numpy seed. Prenet dropout is off on both sides
unless a test says otherwise. float32; each test states its tolerance.

The committed trained ppg2mel export (read through the JAX package's
``load_single``, in the test only) is carried across at full width and
scored on its dev probe as the JAX trainer scores it."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mockingbird_tpu.config import Config as JConfig
from mockingbird_tpu.dsp import f0 as jf0
from mockingbird_tpu.models.encoder import SpeakerEncoderInference as JEncoder
from mockingbird_tpu.models.ppg import extractor as jext
from mockingbird_tpu.models.ppg import ppg2mel as jp2m
from mockingbird_tpu.models.ppg.convert import VoiceConverter as JVC
from mockingbird_tpu_torch.dsp import f0 as tf0
from mockingbird_tpu_torch.models.encoder import SpeakerEncoderInference as TEncoder
from mockingbird_tpu_torch.models.ppg import extractor as text
from mockingbird_tpu_torch.models.ppg import ppg2mel as tp2m
from mockingbird_tpu_torch.models.ppg.convert import VoiceConverter as TVC
from mockingbird_tpu_torch.weights import flatten_tree, load_flax

ATOL = 1e-4
SMALL_PPG = dict(output_size=24, attention_heads=2, linear_units=48, num_blocks=2,
                 cnn_kernel=7)
SMALL_P2M = dict(encoder_dim=32, attention_rnn_dim=32, decoder_rnn_dim=32,
                 prenet_dims=[32, 16], spk_embed_dim=16, bottle_neck_feature_dim=24,
                 num_mels=20, prenet_always_dropout=False)
REF_WAV = "saved_models/gan_run/eval/ground_truth.wav"
ENCODER_CKPT = "saved_models/encoder_run/encoder.ckpt"
PPG_CKPT = "saved_models/ppg_run/ppg2mel.ckpt"
PROBE = "saved_models/ppg_run/eval_probe.npz"


def to_numpy(tree):
    return ({k: to_numpy(v) for k, v in tree.items()} if isinstance(tree, dict)
            else np.asarray(tree, np.float32))


def randomise(tree, rng, keys=("mean", "var", "pos_bias_u", "pos_bias_v")):
    """Draw the leaves named in ``keys`` from ``rng``: BatchNorm means ±0.2,
    variances in [0.5, 1.5], attention biases ±0.3 (flax inits them at 0
    and 1, where a swapped or missing leaf would not show)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomise(v, rng, keys)
        elif k in keys:
            out[k] = (rng.uniform(0.5, 1.5, v.shape) if k == "var"
                      else rng.randn(*v.shape) * (0.2 if k == "mean" else 0.3)
                      ).astype(np.float32)
        else:
            out[k] = v
    return out


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def tone(n, rng, sr=16000):
    """A voiced test signal: harmonics of a wandering f0 with noise."""
    t = np.arange(n) / sr
    f0 = rng.uniform(110, 240) * (1 + 0.05 * np.sin(2 * np.pi * rng.uniform(2, 5) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(0.3 / k * np.sin(k * phase) for k in range(1, 5))
    return (wav + 0.01 * rng.randn(n)).astype(np.float32)


def jppg_cfg(**kw):
    return JConfig(jext.ppg_config()).merge(SMALL_PPG).merge(kw)


def tppg_cfg(**kw):
    return text.ppg_config().merge(SMALL_PPG).merge(kw)


def jp2m_cfg(**kw):
    return JConfig(jp2m.ppg2mel_config()).merge(SMALL_P2M).merge(kw)


def tp2m_cfg(**kw):
    return tp2m.ppg2mel_config().merge(SMALL_P2M).merge(kw)


# ---------------------------------------------------------------------------
# f0 and the frontend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["tone", "noise", "silence"])
def test_f0_copy_equals_jax(kind):
    """Exactly equal: the same numpy on the same input."""
    rng = np.random.RandomState(1)
    wav = {"tone": tone(23_456, rng), "noise": (0.1 * rng.randn(9_000)).astype(np.float32),
           "silence": np.zeros(4_000, np.float32)}[kind]
    f0 = jf0.compute_f0(wav)
    np.testing.assert_array_equal(tf0.compute_f0(wav), f0)
    lf0 = jf0.f02lf0(f0)
    np.testing.assert_array_equal(tf0.f02lf0(f0), lf0)
    assert tf0.compute_mean_std(lf0) == jf0.compute_mean_std(lf0)
    for a, b in zip(tf0.convert_continuous_f0(f0), jf0.convert_continuous_f0(f0)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tf0.get_cont_lf0(f0), jf0.get_cont_lf0(f0)):
        np.testing.assert_array_equal(a, b)
    for convert in (True, False):
        np.testing.assert_array_equal(tf0.get_converted_lf0uv(wav, 5.1, 0.2, convert),
                                      jf0.get_converted_lf0uv(wav, 5.1, 0.2, convert))


def test_frontend_and_mvn_match_jax():
    """Log-mel at n_fft 512, hop 160, win 400 and the per-utterance MVN over
    ragged lengths: atol 1e-4; padded frames exactly 0."""
    rng = np.random.RandomState(2)
    ns = [16_000, 11_111, 3_200]
    wav = np.zeros((3, 16_000), np.float32)
    for i, n in enumerate(ns):
        wav[i, :n] = tone(n, rng)
    lengths = np.asarray(ns) // 160 + 1
    jcfg, tcfg = jext.ppg_config(), text.ppg_config()
    want = jext.logmel_frontend(jnp.asarray(wav), jcfg, jnp.asarray(lengths))
    want_mvn = np.asarray(jext.utterance_mvn(want, jnp.asarray(lengths)))
    got = text.logmel_frontend(torch.from_numpy(wav), tcfg, torch.from_numpy(lengths))
    got_mvn = text.utterance_mvn(got, torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_mvn, want_mvn, atol=ATOL)
    for i, n in enumerate(lengths):
        assert not got_mvn[i, n:].any()


# ---------------------------------------------------------------------------
# the Conformer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 7, 96])
def test_rel_pos_table_and_shift_are_exact(t):
    """Both are index arithmetic: exactly equal."""
    np.testing.assert_array_equal(text.legacy_rel_pos(t, 24), jext.legacy_rel_pos(t, 24))
    np.testing.assert_array_equal(text.legacy_rel_pos(6000, 8)[:t],
                                  jext.legacy_rel_pos(6000, 8)[:t])
    x = np.random.RandomState(t).randn(2, 3, t, t).astype(np.float32)
    np.testing.assert_array_equal(text._legacy_rel_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(jext._legacy_rel_shift(jnp.asarray(x))))


def test_rel_pos_attention_matches_jax():
    """Masked relative-position attention, learned u/v biases non-zero:
    atol 1e-4."""
    rng = np.random.RandomState(3)
    b, t, d = 3, 17, 24
    x = rng.randn(b, t, d).astype(np.float32)
    pos = text.legacy_rel_pos(t, d)[None]
    lengths = np.array([17, 9, 1])
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)[:, None, None, :]
    att = jext.RelPositionMultiHeadAttention(2, d)
    params = randomise(to_numpy(att.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                         jnp.asarray(pos))["params"]), rng)
    want = att.apply({"params": jtree(params)}, jnp.asarray(x), jnp.asarray(pos),
                     jnp.asarray(mask))
    tatt = load_flax(text.RelPositionMultiHeadAttention(2, d), params)
    with torch.no_grad():
        got = tatt(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("input_layer", ["linear", "conv2d_nosub"])
def test_conformer_encoder_matches_jax(input_layer):
    """Both input layers, ragged lengths: atol 1e-4; padded frames exactly 0."""
    rng = np.random.RandomState(4)
    b, t = 3, 40
    feats = rng.randn(b, t, 80).astype(np.float32)
    lengths = np.array([40, 23, 5])
    jcfg = jppg_cfg(input_layer=input_layer).freeze()
    enc = jext.ConformerEncoder(jcfg)
    v = to_numpy(enc.init(jax.random.PRNGKey(1), jnp.asarray(feats), jnp.asarray(lengths)))
    v = randomise(v, rng)
    want = enc.apply(jtree(v), jnp.asarray(feats), jnp.asarray(lengths))
    tenc = load_flax(text.ConformerEncoder(tppg_cfg(input_layer=input_layer)), v).eval()
    with torch.no_grad():
        got = tenc(torch.from_numpy(feats), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    for i, n in enumerate(lengths):
        assert not got[i, n:].any()


@pytest.fixture(scope="module")
def extractors():
    """The JAX extractor at small width (seed 0), its variables with random
    BatchNorm statistics and u/v biases, and the port's carrying them."""
    jx = jext.PPGExtractor(cfg=jppg_cfg(), verbose=False)
    variables = randomise(to_numpy(jx.variables), np.random.RandomState(5))
    jx.variables = jtree(variables)
    tx = text.PPGExtractor(cfg=tppg_cfg(), variables=variables, verbose=False, device="cpu")
    return jx, tx, variables


def test_extractor_matches_jax(extractors):
    """``extract_from_wavs`` on two wavs of different lengths (one 1 s
    bucket of padding between them): same frame counts, atol 1e-4."""
    jx, tx, _ = extractors
    rng = np.random.RandomState(6)
    wavs = [tone(25_000, rng), tone(9_876, rng)]
    want = jx.extract_from_wavs(wavs)
    got = tx.extract_from_wavs(wavs)
    for g, w, wav in zip(got, want, wavs):
        assert g.shape == w.shape == (len(wav) // 160 + 1, 24)
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_extractor_npz_round_trip(extractors, tmp_path):
    """An ``.npz`` export (``flatten_tree``) loads through ``model_fpath``
    and gives the same PPGs: exactly equal."""
    _, tx, variables = extractors
    np.savez(tmp_path / "ppg_extractor.npz", **flatten_tree(variables))
    tx2 = text.PPGExtractor(tmp_path / "ppg_extractor.npz", cfg=tppg_cfg(), verbose=False,
                            device="cpu")
    wav = tone(7_000, np.random.RandomState(7))
    np.testing.assert_array_equal(tx2.extract_from_wav(wav), tx.extract_from_wav(wav))


def test_ppg_config_equals_jax():
    assert dict(text.ppg_config()) == dict(jext.ppg_config())
    assert dict(tp2m.ppg2mel_config()) == dict(jp2m.ppg2mel_config())


# ---------------------------------------------------------------------------
# ppg2mel building blocks
# ---------------------------------------------------------------------------

def test_mol_attention_matches_jax():
    """Context, alignment and mean positions over 6 steps, the last memory
    rows masked: atol 1e-4. The seeded init sets ``query_fc2``'s bias as the
    JAX init does."""
    rng = np.random.RandomState(8)
    b, t, d, qd = 2, 20, 8, 12
    mem = rng.randn(b, t, d).astype(np.float32)
    mask = (np.arange(t)[None] < np.array([[20], [13]])).astype(np.float32)
    att = jp2m.MOLAttention(M=5, r=0.5)
    q0 = jnp.asarray(rng.randn(b, qd), jnp.float32)
    params = to_numpy(att.init(jax.random.PRNGKey(2), q0, jnp.asarray(mem),
                               jnp.zeros((b, 5)))["params"])
    tatt = tp2m.MOLAttention(qd, 5, 0.5)
    np.testing.assert_array_equal(tatt.query_fc2.bias.detach().numpy(),
                                  params["query_fc2"]["bias"])
    load_flax(tatt, params)
    mu_j = jnp.zeros((b, 5))
    mu_t = torch.zeros(b, 5)
    for _ in range(6):
        q = rng.randn(b, qd).astype(np.float32)
        ctx_j, al_j, mu_j = att.apply({"params": jtree(params)}, jnp.asarray(q),
                                      jnp.asarray(mem), mu_j, jnp.asarray(mask))
        with torch.no_grad():
            ctx_t, al_t, mu_t = tatt(torch.from_numpy(q), torch.from_numpy(mem), mu_t,
                                     torch.from_numpy(mask))
        for g, w in ((ctx_t, ctx_j), (al_t, al_j), (mu_t, mu_j)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_downsample_stack_and_postnet_match_jax():
    """The downsampling stack (stride-2 convs with explicit (1, 1) pads,
    instance norm over the whole padded axis) and the postnet with random
    BatchNorm statistics: atol 1e-4."""
    rng = np.random.RandomState(9)
    x = rng.randn(2, 36, 24).astype(np.float32)
    ds = jp2m.DownsampleConvStack(32, (2, 2))
    p = to_numpy(ds.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])
    want = ds.apply({"params": jtree(p)}, jnp.asarray(x))
    tds = load_flax(tp2m.DownsampleConvStack(24, 32, [2, 2]), p)
    with torch.no_grad():
        got = tds(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 9, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    mel = rng.randn(2, 30, 20).astype(np.float32)
    pn = jp2m.Postnet(20, hidden=48)
    v = randomise(to_numpy(pn.init(jax.random.PRNGKey(4), jnp.asarray(mel), False)), rng)
    want = pn.apply(jtree(v), jnp.asarray(mel), False)
    tpn = load_flax(tp2m.Postnet(20, hidden=48), v).eval()
    with torch.no_grad():
        got = tpn(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.fixture(scope="module")
def decoders():
    """The small MelDecoderMOLv2 (prenet dropout off) on both sides, JAX's
    variables with random BatchNorm statistics carried across."""
    jmodel, v = jp2m.init_ppg2mel(jax.random.PRNGKey(5), jp2m_cfg())
    variables = randomise(to_numpy(v), np.random.RandomState(10))
    tmodel = load_flax(tp2m.MelDecoderMOLv2(tp2m_cfg()), variables).eval()
    return jmodel, tmodel, variables


def _tf_batch(rng, b=3, t=48):
    lengths = np.array([48, 36, 20])[:b]
    return dict(ppgs=rng.randn(b, t, 24).astype(np.float32),
                lf0s=np.stack([rng.randn(b, t), rng.rand(b, t) > 0.3], -1).astype(np.float32),
                mels=(rng.randn(b, t, 20) * 0.5).astype(np.float32),
                embeds=rng.randn(b, 16).astype(np.float32), lengths=lengths)


def test_teacher_forced_forward_matches_jax(decoders):
    """Eval-mode teacher-forced forward over ragged lengths: mel, mel after
    the postnet, stop logits and alignments within atol 1e-4."""
    jmodel, tmodel, v = decoders
    bt = _tf_batch(np.random.RandomState(11))
    want = jmodel.apply(jtree(v), *(jnp.asarray(bt[k]) for k in
                                    ("ppgs", "lengths", "mels", "lengths", "lf0s", "embeds")),
                        False)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(bt[k]) for k in
                       ("ppgs", "lengths", "mels", "lengths", "lf0s", "embeds")))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_decode_steps_match_jax(decoders):
    """``encode_inputs`` then 10 ``decode_step`` calls fed their own last
    frame, then ``postnet_apply``: atol 1e-4 at every step."""
    jmodel, tmodel, v = decoders
    bt = _tf_batch(np.random.RandomState(12))
    M = jp2m.MelDecoderMOLv2
    vj = jtree(v)
    mem_j = jmodel.apply(vj, jnp.asarray(bt["ppgs"]), jnp.asarray(bt["lf0s"]),
                         jnp.asarray(bt["embeds"]), method=M.encode_inputs)
    with torch.no_grad():
        mem_t = tmodel.encode_inputs(torch.from_numpy(bt["ppgs"]), torch.from_numpy(bt["lf0s"]),
                                     torch.from_numpy(bt["embeds"]))
    np.testing.assert_allclose(mem_t.numpy(), np.asarray(mem_j), atol=ATOL)
    mask = (np.arange(12)[None] < (bt["lengths"] // 4)[:, None]).astype(np.float32)
    carry_j = jmodel.apply(vj, 3, method=M.init_carry)
    carry_t = tmodel.init_carry(3, "cpu")
    prev_j, prev_t = jnp.zeros((3, 20)), torch.zeros(3, 20)
    mels_j, mels_t = [], []
    for _ in range(10):
        carry_j, (mel_j, stop_j, al_j) = jmodel.apply(vj, mem_j, jnp.asarray(mask), carry_j,
                                                      prev_j, method=M.decode_step)
        with torch.no_grad():
            carry_t, (mel_t, stop_t, al_t) = tmodel.decode_step(mem_t, torch.from_numpy(mask),
                                                                carry_t, prev_t)
        for g, w in ((mel_t, mel_j), (stop_t, stop_j), (al_t, al_j), (carry_t[3], carry_j[3])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
        prev_j, prev_t = mel_j.reshape(3, 2, 20)[:, -1], mel_t.reshape(3, 2, 20)[:, -1]
        mels_j.append(mel_j)
        mels_t.append(mel_t)
    post_j = jmodel.apply(vj, jnp.stack(mels_j, 1).reshape(3, 20, 20), method=M.postnet_apply)
    with torch.no_grad():
        post_t = tmodel.postnet_apply(torch.stack(mels_t, 1).reshape(3, 20, 20))
    np.testing.assert_allclose(post_t.numpy(), np.asarray(post_j), atol=ATOL)


def test_ppg2mel_npz_round_trip(decoders, tmp_path):
    """``VoiceConverter(ppg2mel_fpath=<.npz>)`` holds exactly the tree it
    was exported from."""
    _, tmodel, v = decoders
    np.savez(tmp_path / "ppg2mel.npz", **flatten_tree(v))
    vc = TVC(tmp_path / "ppg2mel.npz", cfg=tp2m_cfg(), verbose=False, device="cpu",
             extractor=object(), encoder=object())
    for (name, a), b in zip(vc.model.state_dict().items(), tmodel.state_dict().values()):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# the whole conversion
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def converters(extractors):
    """JAX's and the port's ``VoiceConverter`` on the same weights: the
    small extractor and decoder (speaker width 256, the encoder's), the
    committed GE2E export, the reference set from the committed
    ``ground_truth.wav`` on both sides."""
    jx, tx, _ = extractors
    jenc = JEncoder.from_checkpoint(ENCODER_CKPT)
    tenc = TEncoder(to_numpy(jenc.params), device="cpu")
    kw = dict(spk_embed_dim=256)
    jvc = JVC(cfg=jp2m_cfg(**kw), extractor=jx, encoder=jenc, verbose=False)
    variables = randomise(to_numpy(jvc.variables), np.random.RandomState(13))
    jvc.variables = jtree(variables)
    tvc = TVC(cfg=tp2m_cfg(**kw), extractor=tx, encoder=tenc, variables=variables,
              verbose=False, device="cpu")
    jvc.set_reference(REF_WAV)
    tvc.set_reference(REF_WAV)
    return jvc, tvc, variables


def test_set_reference_matches_jax(converters):
    """The d-vector within atol 1e-4, the lf0 statistics exactly."""
    jvc, tvc, _ = converters
    np.testing.assert_allclose(tvc.ref_embed, jvc.ref_embed, atol=ATOL)
    assert (tvc.ref_lf0_mean, tvc.ref_lf0_std) == (jvc.ref_lf0_mean, jvc.ref_lf0_std)


# 2.0 is never met (sigmoid <= 1); at 0.565 the three rows stop at
# different steps (2, 6 and 8; the test checks that they differ), each
# crossing it by more than 1e-3, and the padding row never does
@pytest.mark.parametrize("stop_threshold", [2.0, 0.565])
def test_convert_wavs_matches_jax(converters, stop_threshold):
    """Three ragged sources (batch padded to 4, memory to 64 groups):
    the same per-row lengths, mels within atol 1e-4."""
    jvc, tvc, _ = converters
    rng = np.random.RandomState(14)
    srcs = [tone(n, rng) for n in (14_000, 6_100, 10_500)]
    want = jvc.convert_wavs(srcs, max_steps=64, stop_threshold=stop_threshold)
    got = tvc.convert_wavs(srcs, max_steps=64, stop_threshold=stop_threshold)
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        assert g.shape[1] == 20
        np.testing.assert_allclose(g, w, atol=ATOL)
    lens = [len(w) for w in want]
    if stop_threshold > 1:
        # never stopped: each row trimmed only at its source's frames
        assert lens == [min(64, (len(s) // 160 + 1) // 4 * 4) for s in srcs]
    else:
        assert len(set(lens)) > 1 and min(lens) < 64, lens


def test_convert_wav_and_prenet_dropout(converters):
    """``convert_wav`` is ``convert_wavs`` of one; with the prenet's
    always-on dropout (the default) the draws follow ``seed``."""
    _, tvc, variables = converters
    src = tone(8_000, np.random.RandomState(15))
    mel, rtf = tvc.convert_wav(src, max_steps=32, stop_threshold=2.0)
    np.testing.assert_array_equal(mel, tvc.convert_wavs([src], max_steps=32,
                                                        stop_threshold=2.0)[0])
    assert rtf > 0
    drop = TVC(cfg=tp2m_cfg(spk_embed_dim=256, prenet_always_dropout=True),
               extractor=tvc.extractor, encoder=tvc.encoder, variables=variables,
               verbose=False, device="cpu")
    drop.ref_embed, drop.ref_lf0_mean, drop.ref_lf0_std = (tvc.ref_embed, tvc.ref_lf0_mean,
                                                           tvc.ref_lf0_std)
    a, b, c = (drop.convert_wavs([src], max_steps=32, stop_threshold=2.0, seed=s)[0]
               for s in (0, 0, 1))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-3 and np.abs(a - mel).max() > 1e-3


# ---------------------------------------------------------------------------
# the trained export
# ---------------------------------------------------------------------------

def _masked_mse(pred, target, mask):
    return float(((pred - target) ** 2 * mask).sum() / max(float(mask.sum()), 1.0))


@pytest.fixture(scope="module")
def trained():
    from mockingbird_tpu.train.checkpoint import load_single
    tree = load_single(PPG_CKPT)
    probe = dict(np.load(PROBE))
    return to_numpy(tree), probe


def _port_dev_mse(tree, probe, dropout: bool) -> float:
    cfg = tp2m.ppg2mel_config().merge(dict(prenet_always_dropout=dropout))
    model = load_flax(tp2m.MelDecoderMOLv2(cfg), tree).eval()
    t = {k: torch.from_numpy(v) for k, v in probe.items()}
    gen = torch.Generator().manual_seed(0) if dropout else None
    with torch.no_grad():
        mel, post, _, _ = model(t["ppgs"], t["lengths"], t["mels"], t["lengths"], t["lf0s"],
                                t["embeds"], gen)
    mask = (torch.arange(t["mels"].shape[1])[None] < t["lengths"][:, None]).float()[..., None]
    return _masked_mse(mel, t["mels"], mask) + _masked_mse(post, t["mels"], mask)


def test_trained_export_dev_mse_matches_jax(trained):
    """The committed trained ppg2mel on its dev probe (2 utterances of 128
    frames, lengths 48 and 93), as the JAX trainer's ``make_vc_val_fn``
    scores it: with prenet dropout off, the port's masked mel MSE equals
    JAX's within 1e-4 relative; with the reference's always-on dropout
    drawn from the port's generator, it stays under ``bench.py``'s gate of
    120."""
    from mockingbird_tpu.models.ppg.train import make_vc_val_fn
    tree, probe = trained
    jmodel = jp2m.MelDecoderMOLv2(JConfig(jp2m.ppg2mel_config()).merge(
        dict(prenet_always_dropout=False)).freeze())
    want, _ = make_vc_val_fn(jmodel)(jtree(tree["params"]), jtree(tree["batch_stats"]),
                                     {k: jnp.asarray(v) for k, v in probe.items()})
    want = float(want)
    got = _port_dev_mse(tree, probe, dropout=False)
    print(f"dev-probe masked mel MSE, prenet dropout off: port {got:.6f}, JAX {want:.6f}")
    assert math.isclose(got, want, rel_tol=1e-4)
    with_dropout = _port_dev_mse(tree, probe, dropout=True)
    print(f"dev-probe masked mel MSE, prenet dropout on (port generator, seed 0): "
          f"{with_dropout:.6f}")
    assert with_dropout < 120

