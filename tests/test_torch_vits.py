"""Parity of the port's VITS with the JAX package at small widths (the
``small_cfg`` of ``tests/test_vits.py``): every module against its flax
counterpart (the decoder in bf16 too), the ``Vits`` training forward (``train=False``, JAX's own
draws handed in), ``infer`` (held at JAX's durations past the ceil, which
is checked by itself on identical inputs) and ``reconstruct``, the
VITS spectrogram, and the committed export. flax parameters are drawn from
a numpy seed at the shapes flax's ``init`` gives (so zero-initialised layers
and unit weight-norm gains are not left at their init). float32; tolerances
stated per test."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn
from mockingbird_tpu.config import Config as JConfig
from mockingbird_tpu.dsp.stft import mel_vits, spec_to_mel_vits, spectrogram_vits
from mockingbird_tpu.models.vits import model as jmodel
from mockingbird_tpu.models.vits import modules as jm
from mockingbird_tpu.models.vocoder import hifigan as jh
from mockingbird_tpu_torch.config import Config
from mockingbird_tpu_torch import dsp as tdsp
from mockingbird_tpu_torch.models import layers as tl
from mockingbird_tpu_torch.models.vits import model as tmodel
from mockingbird_tpu_torch.models.vits import modules as tm
from mockingbird_tpu_torch.models.vocoder import hifigan as th
from mockingbird_tpu_torch.weights import WeightMismatch, load_flax

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4
SMALL = dict(inter_channels=32, hidden_channels=32, filter_channels=64, n_heads=2,
             n_layers=2, upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
             upsample_initial_channel=64, resblock_kernel_sizes=[3],
             resblock_dilation_sizes=[[1, 3]], spec_channels=65, segment_size=16 * 8,
             hop_size=16, n_speakers=4, gin_channels=16, emotion_channels=8, n_fft=128,
             win_size=128, num_mels=20)


def jcfg():
    return JConfig(jmodel.vits_config()).merge(SMALL)


def tcfg():
    return tmodel.vits_config().merge(SMALL)


def to_numpy(tree):
    return ({k: to_numpy(v) for k, v in tree.items()} if isinstance(tree, dict)
            else np.asarray(tree, np.float32))


def random_params(shapes, rng, sd=0.1):
    """A param tree at flax's shapes: kernels N(0, 1/fan_in), gains (LayerNorm
    and weight-norm ``scale``) 1 + N(0, sd²), every other leaf N(0, sd²)."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = random_params(v, rng, sd)
        elif k == "kernel":
            out[k] = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        elif k.endswith("scale"):
            out[k] = 1.0 + sd * rng.randn(*v.shape)
        else:
            out[k] = sd * rng.randn(*v.shape)
        if not isinstance(v, dict):
            out[k] = out[k].astype(np.float32)
    return out


def flax_params(jmod, *args, seed=0, sd=0.1, method=None, **kw):
    shapes = jax.eval_shape(lambda k: jmod.init({"params": k, "dropout": k}, *args,
                                                method=method, **kw), jax.random.PRNGKey(0))
    return random_params(shapes["params"], np.random.RandomState(seed), sd)


def pair(jmod, tmod, *args, seed=0, sd=0.1, **kw):
    """Random flax params of ``jmod`` (shapes from ``init`` on ``args``),
    loaded into ``tmod``; returns (jax variables, torch module)."""
    params = flax_params(jmod, *args, seed=seed, sd=sd, **kw)
    load_flax(tmod, params)
    return {"params": jax.tree.map(jnp.asarray, params)}, tmod


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def mask_np(lengths, t_len):
    return (np.arange(t_len)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_ddsconv_wn_and_layernorm():
    x, mask = rnd(2, 10, 16), mask_np([10, 6], 10)
    g = rnd(2, 1, 8, seed=1)
    v, mod = pair(jm.DDSConv(16, 3, 3), tm.DDSConv(16, 3, 3), x, mask)
    close(mod(t(x), t(mask)), jm.DDSConv(16, 3, 3).apply(v, x, mask))
    v, mod = pair(jm.WN(16, 5, 1, 4, gin_channels=8), tm.WN(16, 5, 1, 4, 8), x, mask, g=g)
    close(mod(t(x), t(mask), g=t(g)), jm.WN(16, 5, 1, 4, gin_channels=8).apply(v, x, mask, g=g))
    v, mod = pair(jm.ChannelLayerNorm(16), tm.ChannelLayerNorm(16), x)
    close(mod(t(x)), jm.ChannelLayerNorm(16).apply(v, x))


@pytest.mark.parametrize("reverse", [False, True])
def test_flows(reverse):
    x, mask = rnd(2, 10, 8), mask_np([10, 7], 10)
    g = rnd(2, 1, 6, seed=2)
    cases = [(jm.ElementwiseAffine(8), tm.ElementwiseAffine(8), {}),
             (jm.ResidualCouplingLayer(8, 16, 3, 1, 2, gin_channels=6),
              tm.ResidualCouplingLayer(8, 16, 3, 1, 2, gin_channels=6), {"g": g}),
             (jm.ConvFlow(8, 16, 3, 3), tm.ConvFlow(8, 16, 3, 3), {"g": rnd(2, 10, 16)})]
    for jmod, tmod, kw in cases:
        v, mod = pair(jmod, tmod, x, mask, **kw, sd=0.3)
        ref = jmod.apply(v, x, mask, reverse=reverse, **kw)
        got = mod(t(x), t(mask), reverse=reverse, **{k: t(a) for k, a in kw.items()})
        if reverse:
            close(got, ref)
        else:
            close(got[0], ref[0])
            close(got[1], ref[1], atol=1e-3)
    xp = np.abs(x) + 0.1
    close(tm.Log()(t(xp), t(mask))[1], jm.Log()(xp, mask)[1])
    close(tm.Log()(t(x), t(mask), reverse=True), jm.Log()(x, mask, reverse=True))
    close(tm.Flip()(t(x), t(mask), reverse=True), jm.Flip()(x, mask, reverse=True))


@pytest.mark.parametrize("inverse", [False, True])
def test_spline_tails_and_bin_edges(inverse):
    """Inputs in both tails, at ±tail_bound, on the knots themselves and
    inside bins; ``searchsorted``-style bin indices, linear tails (bound
    5), min bin widths and heights."""
    rng = np.random.RandomState(0)
    n = 40
    uw, uh, ud = rng.randn(n, 10) * 2, rng.randn(n, 10) * 2, rng.randn(n, 9)
    uw[:4] = 0.0                                      # uniform bins: knots at -5 + k
    uh[:4] = 0.0
    x = rng.uniform(-4.9, 4.9, n)
    x[:4] = [-3.0, 0.0, 2.0, -5.0]                   # exactly on knots
    x[4:8] = [-7.0, 5.0, 6.5, -5.0001]
    args = [a.astype(np.float32) for a in (x, uw, uh, ud)]
    ref_y, ref_ld = jm.rational_quadratic_spline(*map(jnp.asarray, args), inverse=inverse)
    y, ld = tm.rational_quadratic_spline(*map(t, args), inverse=inverse)
    close(y, ref_y, atol=1e-5)
    # |logabsdet| reaches 10 where a bin is steep: f32 relative rounding
    close(ld, ref_ld, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(y.numpy()[4:8][[0, 2]], args[0][4:8][[0, 2]])


@pytest.mark.parametrize("t_len", [3, 4, 5, 9])
def test_relative_attention_and_helpers(t_len):
    """Window 4: T below, at and past the window (the pad/slice of the
    relative table and the pad-reshape tricks)."""
    x = rnd(2, t_len, 16, seed=t_len)
    rel = rnd(2, 2, t_len, 2 * t_len - 1, seed=1)
    ab = rnd(2, 2, t_len, t_len, seed=2)
    close(tm._relative_to_absolute(t(rel)), jm._relative_to_absolute(jnp.asarray(rel)), 0)
    close(tm._absolute_to_relative(t(ab)), jm._absolute_to_relative(jnp.asarray(ab)), 0)
    emb = rnd(1, 9, 8, seed=3)
    close(tm._relative_embeddings(t(emb), t_len, 4),
          jm._relative_embeddings(jnp.asarray(emb), t_len, 4), 0)
    m = mask_np([t_len, max(1, t_len - 2)], t_len)[..., 0]
    attn_mask = m[:, None, :, None] * m[:, None, None, :]
    jmod = jm.RelativeMultiHeadAttention(16, 16, 2)
    v, mod = pair(jmod, tm.RelativeMultiHeadAttention(16, 16, 2), x, attn_mask)
    close(mod(t(x), t(attn_mask)), jmod.apply(v, x, attn_mask))


def test_transformer_encoder_ffn():
    x, mask = rnd(2, 11, 16), mask_np([11, 6], 11)
    jmod = jm.TransformerEncoder(16, 32, 2, 2, 3)
    v, mod = pair(jmod, tm.TransformerEncoder(16, 32, 2, 2, 3), x, mask)
    close(mod(t(x), t(mask)), jmod.apply(v, x, mask))
    jf = jm.FFN(24, 16, 3)
    v, mod = pair(jf, tm.FFN(16, 24, 16, 3), x, mask)
    close(mod(t(x), t(mask)), jf.apply(v, x, mask))


def test_segments_path_and_mask():
    x = np.arange(48, dtype=np.float32).reshape(2, 12, 2)
    ids = np.array([2, 5], np.int32)
    close(tm.slice_segments(t(x), t(ids), 4), jm.slice_segments(x, ids, 4), 0)
    close(tm.slice_segments(t(x[..., 0]), t(ids), 4), jm.slice_segments(x[..., 0], ids, 4), 0)
    dur = np.array([[[2.0, 3.0, 0.0, 1.0]], [[1.0, 1.0, 4.0, 0.0]]], np.float32)
    mask = np.ones((2, 1, 7, 4), np.float32)
    mask[1, :, 5:] = 0
    close(tm.generate_path(t(dur), t(mask)), jm.generate_path(dur, mask), 0)
    lengths = np.array([3, 0, 5])
    close(tm.sequence_mask(t(lengths), 6), jm.sequence_mask(jnp.asarray(lengths), 6), 0)


# ---------------------------------------------------------------------------
# HiFi-GAN pieces (the hazards: transposed-conv flip, SAME with stride,
# weight norm per output feature, NHWC vs NCHW)
# ---------------------------------------------------------------------------

def test_conv_transpose_matches_flax():
    class WNT(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.WeightNorm(fnn.ConvTranspose(6, (8,), strides=(4,), padding="VALID",
                                                    name="ups_conv"), name="ups")(x)

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ups = tl.ConvTranspose1d(5, 6, 8, 4)

    x = rnd(2, 7, 5)
    v, mod = pair(WNT(), Holder(), x, sd=0.3)
    got = mod.ups(t(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape == (2, 6 * 4 + 8, 6)
    close(got, WNT().apply(v, x))


@pytest.mark.parametrize("t_len", [64, 77])
def test_discriminators(t_len):
    y = rnd(2, t_len, scale=0.3)
    jd = jh.DiscriminatorS()
    v, mod = pair(jd, th.DiscriminatorS(), y, sd=0.02)
    score, fmap = mod(t(y))
    ref_score, ref_fmap = jd.apply(v, y)
    close(score, ref_score)
    for a, b in zip(fmap, ref_fmap):
        close(a.transpose(1, 2), b)
    jp = jh.DiscriminatorP(3)
    v, mod = pair(jp, th.DiscriminatorP(3), y, sd=0.02)
    score, fmap = mod(t(y))
    ref_score, ref_fmap = jp.apply(v, y)
    close(score, ref_score)
    for a, b in zip(fmap, ref_fmap):
        close(a.permute(0, 2, 3, 1), b)


def test_resblocks():
    x = rnd(2, 20, 8)
    for jcls, tcls, dil in ((jh.ResBlock1, th.ResBlock1, (1, 3, 5)),
                            (jh.ResBlock2, th.ResBlock2, (1, 3))):
        v, mod = pair(jcls(8, 3, dil), tcls(8, 3, dil), x, sd=0.05)
        close(mod(t(x).transpose(1, 2)).transpose(1, 2), jcls(8, 3, dil).apply(v, x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("speaker", [True, False], ids=["speaker", "no_speaker"])
def test_decoder_matches_jax(speaker, dtype):
    """``VitsGenerator`` against the JAX package's, with the speaker
    conditioning (``cond``) and without it (``gin_channels`` 0): float32 to
    ``ATOL``; bf16 weights and inputs on both sides (jitted on the JAX side)
    to a relative L2 under 2e-2, HiFi-GAN's bf16 tolerance."""
    cfg = dict(SMALL, gin_channels=16 if speaker else 0)
    z = rnd(2, 11, 32, seed=4)
    g = rnd(2, 1, 16, seed=5) if speaker else None
    jd = jmodel.VitsGenerator(JConfig(jmodel.vits_config()).merge(cfg).freeze())
    v, dec = pair(jd, tmodel.VitsGenerator(tmodel.vits_config().merge(cfg)), z, g, sd=0.05)
    dt = jnp.dtype(dtype)
    v = jax.tree.map(lambda a: a.astype(dt), v)
    ref = np.asarray(jax.jit(lambda v, z, g: jd.apply(v, z, g).astype(jnp.float32))(
        v, z.astype(dt), None if g is None else g.astype(dt)))
    dec = dec.to(getattr(torch, dtype)).eval()
    with torch.no_grad():
        got = dec(t(z).to(getattr(torch, dtype)),
                  None if g is None else t(g).to(getattr(torch, dtype))).float()
    assert got.shape == ref.shape == (2, 11 * 16)
    if dtype == "float32":
        close(got, ref)
    else:
        err = float(np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref))
        assert err < 2e-2, err


# ---------------------------------------------------------------------------
# spectrogram
# ---------------------------------------------------------------------------

def test_vits_spectrogram():
    wav = rnd(2, 1000, scale=0.3)
    spec = tdsp.spectrogram_vits(t(wav), 128, 16, 128)
    ref = spectrogram_vits(jnp.asarray(wav), 128, 16, 128)
    close(spec, ref, atol=1e-4)
    mel = tdsp.spec_to_mel_vits(spec, 16000, 128, 20, 0.0, None)
    close(mel, spec_to_mel_vits(ref, 16000, 128, 20, 0.0, None), atol=1e-3)
    close(tdsp.mel_vits(t(wav), tcfg()), mel_vits(jnp.asarray(wav), jcfg()), atol=1e-3)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jmod = jmodel.Vits(jcfg().freeze())
    params = flax_params(jmod, *_batch(), key=jax.random.PRNGKey(0), train=False, seed=1,
                         sd=0.05)
    tmod = load_flax(tmodel.Vits(tcfg()), params).eval()
    return jmod, {"params": jax.tree.map(jnp.asarray, params)}, tmod


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(1, 60, (2, 12)).astype(np.int32)
    y = np.abs(rng.randn(2, 40, 65)).astype(np.float32)
    return (x, np.array([12, 8], np.int32), y, np.array([40, 30], np.int32),
            np.array([0, 3], np.int32), rng.randn(2, 8).astype(np.float32))


def _tt(*arrays):
    return [torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a) for a in arrays]


def train_draws(key, b, t_y, t_x, y_lengths, cfg):
    """JAX's own draws of ``Vits.__call__``: the posterior noise, the
    duration posterior's e_q and the decoder window."""
    k_post, k_dur, k_slice = jax.random.split(key, 3)
    eps = jax.random.normal(k_post, (b, t_y, cfg.inter_channels))
    e_q = jax.random.normal(jax.random.split(k_dur)[0], (b, t_x, 2))
    seg = cfg.segment_size // cfg.hop_size
    ids = (jax.random.uniform(k_slice, (b,))
           * jnp.maximum(jnp.asarray(y_lengths) - seg + 1, 1)).astype(jnp.int32)
    return [np.asarray(a) for a in (eps, e_q, ids)]


def test_forward_matches_jax(models):
    """``train=False`` with JAX's draws; the alignment the port searches on
    its own scores equals JAX's exactly, and every output agrees."""
    jmod, v, tmod = models
    batch = _batch()
    key = jax.random.PRNGKey(1)
    ref = jax.jit(lambda v, *b: jmod.apply(v, *b, key=key, train=False))(v, *batch)
    eps, e_q, ids = train_draws(key, 2, 40, 12, batch[3], tcfg())
    with torch.no_grad():
        out = tmod(*_tt(*batch), train=False, eps=t(eps), e_q=t(e_q), ids_slice=t(ids))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))     # attn
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))     # ids_slice
    close(out[0], ref[0])                                                 # wav
    close(out[1], ref[1], atol=1e-3, rtol=1e-4)                           # l_length
    for a, b in zip(out[6], ref[6]):                                      # z .. logs_q
        close(a, b, atol=1e-3, rtol=1e-5)     # z_p reaches |1e3|: f32 relative rounding


def test_infer_matches_jax(models):
    """Durations (logw) agree; the ceil is held exactly on identical
    inputs; past it the port runs at JAX's durations and the audio agrees."""
    jmod, v, tmod = models
    x, xl, _, _, sid, emo = _batch(1)
    key = jax.random.PRNGKey(3)
    k_dur, k_z = jax.random.split(key)
    ns, ls, nsw, max_len = 0.667, 1.1, 0.8, 60
    o_ref, _, _, yl_ref = jax.jit(lambda v, *a: jmod.apply(
        v, *a, noise_scale=ns, length_scale=ls, noise_scale_w=nsw, max_len=max_len, key=key,
        method=jmodel.Vits.infer))(v, x, xl, sid, emo)

    def durations(m, x, xl, sid, emo):
        hx, m_p, logs_p, x_mask = m.enc_p(x, xl, emo, False)
        return m.dp(hx, x_mask, g=m._speaker(sid), reverse=True, noise_scale=nsw,
                    key=k_dur), x_mask

    logw_ref, x_mask_ref = jax.jit(lambda v, *a: jmod.apply(v, *a, method=durations))(
        v, x, xl, sid, emo)
    w_ceil_ref = jnp.ceil(jnp.exp(logw_ref) * x_mask_ref * ls)
    dur_noise = np.asarray(jax.random.normal(k_dur, (2, 12, 2)))
    prior = np.asarray(jax.random.normal(k_z, (2, max_len, 32)))
    tx, txl, tsid, temo = _tt(x, xl, sid, emo)
    with torch.no_grad():
        hx, m_p, logs_p, x_mask = tmod.enc_p(tx, txl, temo)
        g = tmod._speaker(tsid)
        logw = tmod.dp(hx, x_mask, g=g, reverse=True, noise_scale=nsw, noise=t(dur_noise))
        close(logw, logw_ref)
        w_ceil = torch.ceil(torch.exp(t(logw_ref)) * t(x_mask_ref) * ls)
        np.testing.assert_array_equal(w_ceil.numpy(), np.asarray(w_ceil_ref))
        # the port's own durations, where no value sits within 1e-4 of a step
        w = np.asarray(jnp.exp(logw_ref) * x_mask_ref * ls)
        safe = np.abs(w - np.round(w)) > 1e-4
        own = torch.ceil(torch.exp(logw) * x_mask * ls).numpy()
        np.testing.assert_array_equal(own[safe], np.asarray(w_ceil_ref)[safe])
        o, _, _, yl = tmod.infer_from_durations(w_ceil, m_p, logs_p, x_mask, g, ns, max_len,
                                                prior_noise=t(prior))
    np.testing.assert_array_equal(yl.numpy(), np.asarray(yl_ref))
    close(o, o_ref)


def test_reconstruct_and_synthesizer(models):
    """``reconstruct`` against JAX; ``VitsSynthesizer`` on the CPU: text
    buckets of 16, lengths y_lengths·hop, int16 on the device."""
    from mockingbird_tpu_torch.models.vits import VitsSynthesizer
    jmod, v, tmod = models
    _, _, y, yl, sid, _ = _batch(2)
    ref = jax.jit(lambda v, *a: jmod.apply(v, *a, key=jax.random.PRNGKey(0),
                                           method=jmodel.Vits.reconstruct))(v, y, yl, sid)
    with torch.no_grad():
        close(tmod.reconstruct(*_tt(y, yl, sid)), ref)
    syn = VitsSynthesizer(cfg=SMALL, verbose=False, device="cpu",
                          variables=to_numpy(v["params"]))
    texts = ["ni3 hao3 shi4 jie4", "hello there, how are you today my friend"]
    f32 = syn.synthesize(texts, max_frames=40)
    i16 = syn.synthesize(texts, max_frames=40, pcm16=True)
    _, lengths = syn.synthesize_device(texts, max_frames=40)
    assert syn._texts(texts)[0].shape[1] == 48
    for a, b, n in zip(f32, i16, lengths.numpy()):
        assert a.dtype == np.float32 and b.dtype == np.int16 and np.isfinite(a).all()
        assert len(a) == len(b) == n * 16
        q = np.round(np.clip(a, -1, 1) * 32767).astype(np.int32)
        assert np.abs(q - b.astype(np.int32)).max() <= 1
    wav = (0.4 * np.sin(2 * np.pi * 220 * np.arange(4000) / 16000)).astype(np.float32)
    rec = syn.reconstruct(wav)
    assert rec.dtype == np.float32 and np.isfinite(rec).all()
    half = VitsSynthesizer(cfg=SMALL, verbose=False, device="cpu", half=True,
                           variables=to_numpy(v["params"]))
    assert next(half.model.parameters()).dtype == torch.bfloat16
    out = half.synthesize(texts[:1], max_frames=40)[0]
    assert out.dtype == np.float32 and np.isfinite(out).all() and len(out) % 16 == 0


def _half(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
                        tree)


def test_half_synthesizer_matches_jax_half(models):
    """``VitsSynthesizer(half=True)`` against the JAX package's ``half=True``
    (f32 parameters cast to bf16, the emotion vectors and the spectrogram
    handed in as f32, flax's dtype promotion): ``synthesize_device`` with
    the noise scales at 0 (so neither side's random draws matter) and
    ``reconstruct``. Both sides compute in f32 with bf16-rounded weights
    wherever a float32 input or mask meets a layer, so they agree to f32
    rounding: 1e-4, the f32 tests' tolerance. A bf16 input where JAX has an
    f32 one rounds it to 8 bits of mantissa and misses that by orders of
    magnitude."""
    from mockingbird_tpu_torch.models.vits import VitsSynthesizer
    jmod, v, _ = models
    syn = VitsSynthesizer(cfg=SMALL, verbose=False, device="cpu", half=True,
                          variables=to_numpy(v["params"]))
    vh = _half(v)
    texts = ["ni3 hao3 shi4 jie4", "hello there, how are you today my friend"]
    x, xl = syn._texts(texts)
    sids = np.array([1, 3], np.int32)
    emos = rnd(2, 8, seed=5, scale=2.0)
    o_ref, yl_ref = jax.jit(lambda v, *a: jmod.apply(
        v, *a, noise_scale=0.0, length_scale=1.0, noise_scale_w=0.0, max_len=40,
        key=jax.random.PRNGKey(0), method=jmodel.Vits.infer,
        rngs={"dropout": jax.random.PRNGKey(1)}))(
        vh, x.astype(np.int32), xl.astype(np.int32), sids, emos)[::3]
    o, yl = syn.synthesize_device(texts, sids=sids, emos=emos, noise_scale=0.0,
                                  noise_scale_w=0.0, max_frames=40)
    np.testing.assert_array_equal(yl.numpy(), np.asarray(yl_ref))
    close(o, np.asarray(o_ref, np.float32))

    wav = (0.4 * np.sin(2 * np.pi * 220 * np.arange(4000) / 16000)).astype(np.float32)
    spec = np.asarray(spectrogram_vits(jnp.asarray(wav), 128, 16, 128))
    y = np.zeros((1, 256, 65), np.float32)
    y[0, :len(spec)] = spec
    ref = jax.jit(lambda v, *a: jmod.apply(v, *a, key=jax.random.PRNGKey(0),
                                           method=jmodel.Vits.reconstruct))(
        vh, y, np.array([len(spec)], np.int32), np.array([0], np.int32))
    got = syn.reconstruct(wav)
    close(torch.from_numpy(got), np.asarray(ref, np.float32)[0, :len(spec) * 16])


def test_trained_export_carries_across():
    """The committed VITS export loads strictly (no missing or extra leaf)
    into the full-width port, and the full-width ``reconstruct`` of a short
    clip matches the JAX package's."""
    from mockingbird_tpu.train.checkpoint import load_single
    from mockingbird_tpu_torch.models.vits import VitsSynthesizer
    path = ROOT / "saved_models/vits_run/synthesizer_vits.ckpt"
    cfg = Config.from_json(ROOT / "saved_models/vits_run/config.json")
    tree = to_numpy(load_single(path)["g"])
    syn = VitsSynthesizer(cfg=cfg, verbose=False, device="cpu", variables=tree)
    full = tmodel.vits_config().merge(cfg)
    with pytest.raises(WeightMismatch, match="stray"):
        load_flax(tmodel.Vits(full), dict(tree, stray={"kernel": np.zeros((1, 1))}))
    with pytest.raises(WeightMismatch, match="ups_1_conv/kernel/scale"):
        dec = dict(tree["dec"], ups_1={})
        load_flax(tmodel.Vits(full), dict(tree, dec=dec))
    rng = np.random.RandomState(0)
    tt = np.arange(3000) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 180 * tt) + 0.05 * rng.randn(3000)).astype(np.float32)
    # the JAX synthesizer's reconstruct: spectrogram, padded to 64 frames
    jcf = JConfig(jmodel.vits_config()).merge(JConfig.from_json(
        ROOT / "saved_models/vits_run/config.json")).freeze()
    spec = np.asarray(spectrogram_vits(jnp.asarray(wav), 1024, 256, 1024))
    y = np.zeros((1, 64, 513), np.float32)
    y[0, :len(spec)] = spec
    ref = jax.jit(lambda v, *a: jmodel.Vits(jcf).apply(
        v, *a, key=jax.random.PRNGKey(0), method=jmodel.Vits.reconstruct))(
        {"params": tree}, y, np.array([len(spec)], np.int32), np.array([0], np.int32))
    got = syn.reconstruct(wav)
    assert got.shape == (len(spec) * 256,)
    close(torch.from_numpy(got), np.asarray(ref)[0, :len(spec) * 256], atol=1e-3)


def test_vits_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """``VitsSynthesizer`` and ``train`` ask for ``cuda`` by default and
    raise without a card; a weights path that does not exist raises."""
    import inspect
    from mockingbird_tpu_torch.models.vits import VitsSynthesizer, train
    for fn in (VitsSynthesizer, train):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    with pytest.raises(FileNotFoundError):
        VitsSynthesizer(tmp_path / "missing.npz", verbose=False, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VitsSynthesizer(verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train("run", tmp_path, tmp_path)
