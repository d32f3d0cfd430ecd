"""The whole slice against the JAX package: text + reference wav → int16
waveform through GE2E (full width), Tacotron and WaveRNN (small widths),
greedy sampling with f32 sampler weights, prenet dropout off. The port's
pipeline is built from ``.npz`` exports of the JAX side's param trees, as a
user of the port loads weights. The int16 waveforms must be equal."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mockingbird_tpu.config import Config as JConfig
from mockingbird_tpu.models.encoder import SpeakerEncoderInference as JEncoder
from mockingbird_tpu.models.encoder.model import init_params
from mockingbird_tpu.models.tacotron import Synthesizer as JSynth
from mockingbird_tpu.models.tacotron import tacotron_config as jtaco_config
from mockingbird_tpu.models.vocoder.wavernn import WaveRnnVocoder as JVocoder
from mockingbird_tpu.models.vocoder.wavernn import wavernn_config as jvoc_config
from mockingbird_tpu.ops.wavernn_sample import pack_wavernn_weights as jpack
from mockingbird_tpu_torch.models.vocoder import WaveRnnVocoder as TVocoder
from mockingbird_tpu_torch.ops.wavernn_sample import pack_wavernn_weights
from mockingbird_tpu_torch.pipeline import VoiceCloningPipeline
from mockingbird_tpu_torch.weights import flatten_tree

REF_WAV = "saved_models/gan_run/eval/ground_truth.wav"
TACO = dict(embed_dims=32, encoder_dims=16, decoder_dims=16, postnet_dims=32,
            lstm_dims=32, gst_E=16, gst_num_heads=4, gst_ref_filters=(4, 4),
            max_r=4, prenet_dropout=False)
VOC = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16, res_blocks=2,
           upsample_factors=[4, 4], hop_size=16, seq_len=16 * 4, pad=2)
TEXTS = ["ni3 hao3, shi4 jie4", "你好，欢迎使用语音克隆", "hello world"]


def to_numpy(tree):
    return ({k: to_numpy(v) for k, v in tree.items()} if isinstance(tree, dict)
            else np.asarray(tree, np.float32))


@pytest.fixture(scope="module")
def jax_side():
    enc = JEncoder(to_numpy(init_params(jax.random.PRNGKey(0))["model"]))
    syn = JSynth(cfg=jtaco_config().merge(TACO), verbose=False)
    syn.load()
    voc = JVocoder(cfg=JConfig(jvoc_config()).merge(VOC), verbose=False)
    # f32 sampler weights: bf16 rounding would turn the 1e-6 differences of
    # the mels into label flips at near-ties
    voc._packed_w = jpack(voc.variables["params"], dtype=jnp.float32)
    return enc, syn, voc


def jax_slice(enc, syn, voc, texts, steps):
    embed = enc.embed_utterance(enc.preprocess_wav(REF_WAV))
    specs = syn.synthesize_spectrograms(texts, np.tile(embed, (len(texts), 1)), steps=steps)
    wavs = voc.infer_waveform_batch(specs, greedy=True, interpret=True)
    return [np.round(np.clip(w, -1.0, 1.0) * 32767).astype(np.int16) for w in wavs]


def port_pipeline(jax_side, tmp_path):
    enc, syn, voc = jax_side
    np.savez(tmp_path / "encoder.npz", **flatten_tree(to_numpy(enc.params)))
    np.savez(tmp_path / "synthesizer.npz", **flatten_tree(to_numpy(syn._variables)))
    np.savez(tmp_path / "vocoder_wavernn.npz", **flatten_tree(to_numpy(voc.variables)))
    # the JAX package reads a Tacotron config sidecar beside the weights
    (tmp_path / "synthesizer.json").write_text(json.dumps(TACO))
    voc = TVocoder(tmp_path / "vocoder_wavernn.npz", cfg=VOC, verbose=False, device="cpu")
    pipe = VoiceCloningPipeline(tmp_path / "encoder.npz", tmp_path / "synthesizer.npz",
                                verbose=False, device="cpu", vocoder=voc)
    # f32 sampler weights, as the JAX side's in `jax_side`
    pipe.vocoder.packed = pack_wavernn_weights(pipe.vocoder.model, torch.float32)
    # greedy sampling, so that both sides draw no random numbers
    pipe.vocoder.infer_waveform_batch = functools.partial(
        pipe.vocoder.infer_waveform_batch, greedy=True)
    return pipe


def test_tts_batch_matches_jax(jax_side, tmp_path):
    ref = jax_slice(*jax_side, TEXTS, steps=60)
    pipe = port_pipeline(jax_side, tmp_path)
    out = pipe.tts_batch(TEXTS, REF_WAV, steps=60)
    assert [o.dtype for o in out] == [np.int16] * 3
    assert [o.shape for o in out] == [r.shape for r in ref]
    assert all(len(o) > 0 for o in out)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)


def test_embed_reference_matches_jax(jax_side, tmp_path):
    enc = jax_side[0]
    ref = enc.embed_utterance(enc.preprocess_wav(REF_WAV))
    out = port_pipeline(jax_side, tmp_path).embed_reference(REF_WAV)
    np.testing.assert_allclose(out, ref, atol=1e-4)


# ---------------------------------------------------------------------------
# the fused branch: Tacotron → HiFi-GAN on the device (small widths, f32
# generator on both sides, prenet dropout off)
# ---------------------------------------------------------------------------

GAN = dict(upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8], upsample_initial_channel=32,
           resblock_kernel_sizes=[3, 7], resblock_dilation_sizes=[[1, 3], [1, 3]],
           segment_size=1600, hop_size=16)


@pytest.fixture(scope="module")
def fused(jax_side, tmp_path_factory):
    """The JAX pipeline and the port's, both Tacotron → HiFi-GAN
    (``half=False``) with the same weights."""
    from mockingbird_tpu.config import sv2tts_audio_config as j_audio_cfg
    from mockingbird_tpu.models.vocoder import GanVocoder as JGan
    from mockingbird_tpu.pipeline import VoiceCloningPipeline as JPipe
    from mockingbird_tpu_torch.models.vocoder import GanVocoder
    enc, syn, _ = jax_side
    jpipe = object.__new__(JPipe)
    jpipe.encoder, jpipe.synthesizer, jpipe.synthesizer_kind = enc, syn, "tacotron"
    jpipe.vocoder = JGan("hifigan", cfg=GAN, verbose=False, half=False)
    jpipe.audio_cfg, jpipe._embed_cache = j_audio_cfg(), {}
    tmp = tmp_path_factory.mktemp("fused")
    np.savez(tmp / "encoder.npz", **flatten_tree(to_numpy(enc.params)))
    np.savez(tmp / "synthesizer.npz", **flatten_tree(to_numpy(syn._variables)))
    (tmp / "synthesizer.json").write_text(json.dumps(TACO))
    voc = GanVocoder("hifigan", cfg=GAN, variables=to_numpy(jpipe.vocoder.params), half=False,
                     verbose=False, device="cpu")
    pipe = VoiceCloningPipeline(tmp / "encoder.npz", tmp / "synthesizer.npz", verbose=False,
                                device="cpu", vocoder=voc)
    return jpipe, pipe


def _labels_of(pcm16):
    """int16 mu-law PCM back to its 8-bit labels (the table is monotonic)."""
    from mockingbird_tpu_torch.dsp import decode_mulaw8_to_int16
    lut = decode_mulaw8_to_int16(np.arange(256, dtype=np.uint8)).astype(np.int32)
    return np.searchsorted(lut, pcm16.astype(np.int32))


def _hold_pcm(out, ref, fmt):
    """Trim lengths equal; float32 within 1e-4; int16 within one step;
    mulaw8-decoded int16 within one label (a last-bit difference of the
    wave may cross a rounding boundary)."""
    assert [o.shape for o in out] == [r.shape for r in ref]
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype == (np.float32 if fmt == "float32" else np.int16)
        if fmt == "float32":
            np.testing.assert_allclose(o, r, atol=1e-4, rtol=0)
        elif fmt == "int16":
            assert int(np.abs(o.astype(np.int32) - r).max(initial=0)) <= 1
        else:
            assert int(np.abs(_labels_of(o) - _labels_of(r)).max(initial=0)) <= 1


@pytest.mark.parametrize("fmt", ["int16", "mulaw8", "float32"])
def test_fused_tts_batch_matches_jax(fused, fmt):
    """Three texts in chunks of 2 (so the last chunk holds one), one voice
    from the reference wav."""
    jpipe, pipe = fused
    kw = dict(steps=60, batch_size=2, pcm_format=fmt, pcm16=fmt != "float32")
    ref = jpipe.tts_batch(TEXTS, REF_WAV, **kw)
    out = pipe.tts_batch(TEXTS, REF_WAV, **kw)
    assert all(len(o) > 0 and len(o) % 16 == 0 for o in out)
    _hold_pcm(out, ref, fmt)


def _voices(seed=0):
    rng = np.random.RandomState(seed)
    embeds = rng.randn(len(TEXTS), 256).astype(np.float32)
    return embeds / np.linalg.norm(embeds, axis=1, keepdims=True)


def test_fused_tts_batch_per_text_voices_match_jax(fused):
    """A (B, 256) ``embed``: one voice per text, no reference wav. With
    these voices the stop scores (×10) of the three items sit near 5.04,
    4.95 rising and 4.77, so ``min_stop_token`` 4.95 stops them at
    different steps (margins of 2e-4 and more): the trim lengths differ."""
    jpipe, pipe = fused
    embeds = _voices()
    kw = dict(steps=60, batch_size=2, min_stop_token=4.95, embed=embeds)
    ref = jpipe.tts_batch(TEXTS, None, **kw)
    out = pipe.tts_batch(TEXTS, None, **kw)
    _hold_pcm(out, ref, "int16")
    assert len({len(o) for o in out}) == 3, [len(o) for o in out]
    # a (256,) embed is tiled: text 1 in voice 0 differs from text 1 in voice 1
    tiled = pipe.tts_batch(TEXTS, None, steps=60, batch_size=2, embed=embeds[0])
    assert len(tiled[1]) != len(out[1]) or not np.array_equal(tiled[1], out[1])
    with pytest.raises(AssertionError, match="per-text embeds"):
        pipe.tts_batch(TEXTS, None, steps=60, embed=embeds[:2])


def test_synthesize_mels_device_matches_jax(fused):
    """The whole (B, steps, M) decode buffer and the per-item frame lengths;
    with ``min_stop_token`` 4.75 every item stops at the first step the
    rule allows, so the frames after it stay zero."""
    jpipe, pipe = fused
    embeds = _voices()
    ref_mels, ref_lens = jpipe.synthesizer.synthesize_mels_device(TEXTS, embeds, steps=60,
                                                                  min_stop_token=4.75)
    mels, lens = pipe.synthesizer.synthesize_mels_device(TEXTS, embeds, steps=60,
                                                         min_stop_token=4.75)
    assert tuple(mels.shape) == ref_mels.shape == (3, 200, 80)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_lens))
    assert lens.tolist() == [14, 14, 14]
    assert not mels[:, 14:].any() and mels[:, :14].abs().min() > 0
    np.testing.assert_allclose(mels.numpy(), np.asarray(ref_mels), atol=1e-4, rtol=0)


def test_clone_voice_long_matches_jax(fused):
    """Numbers read out, split at punctuation, chunks of at most 40
    characters, joined by silences: the same chunks and lengths, samples
    within one int16 step."""
    from mockingbird_tpu.text.long_text import normalize_text as j_norm, split_text as j_split
    from mockingbird_tpu_torch.text.long_text import normalize_text, split_text
    jpipe, pipe = fused
    text = "你好，今天是2024年。hello world, this is a test! ni3 hao3; 第3章，共128页"
    assert normalize_text(text) == j_norm(text)
    for max_chars in (10, 40, 140):
        assert split_text(normalize_text(text), max_chars) == j_split(j_norm(text), max_chars)
    ref = jpipe.clone_voice_long(text, REF_WAV, max_chars=40, steps=60)
    out = pipe.clone_voice_long(text, REF_WAV, max_chars=40, steps=60)
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1.01 / 32767, rtol=0)


def test_griffin_lim_and_tts_to_file(fused, tmp_path):
    """``clone_voice(use_griffin_lim=True)`` and ``tts_to_file`` (short text
    through ``clone_voice``, long text through ``clone_voice_long``) run on
    the port and write what they synthesise."""
    from mockingbird_tpu_torch.dsp import load_wav
    _, pipe = fused
    hop = pipe.audio_cfg.hop_size
    specs = pipe.synthesizer.synthesize_spectrograms(TEXTS[:1], np.tile(
        pipe.embed_reference(REF_WAV), (1, 1)), steps=60)
    (gl,) = pipe.clone_voice(TEXTS[:1], REF_WAV, steps=60, use_griffin_lim=True)
    assert gl.shape == ((specs[0].shape[1] - 1) * hop,) and np.isfinite(gl).all()
    for text, name in ((TEXTS[2], "short.wav"), ("hello world. " * 12, "long.wav")):
        rtf = pipe.tts_to_file(text, REF_WAV, tmp_path / name, steps=60)
        wav, sr = load_wav(tmp_path / name)
        assert sr == 16000 and rtf > 0 and len(wav) > 0
    rtf = pipe.tts_to_file(TEXTS[2], REF_WAV, tmp_path / "gl.wav", steps=60,
                           use_griffin_lim=True)
    (gl2,) = pipe.clone_voice(TEXTS[2], REF_WAV, steps=60, use_griffin_lim=True)
    assert rtf > 0 and len(load_wav(tmp_path / "gl.wav")[0]) == len(gl2)


def test_vits_pipeline_routes_to_vits():
    """``synthesizer="vits"`` builds the port's ``VitsSynthesizer``;
    ``clone_voice`` returns its ``synthesize`` output and ``tts_batch`` (its
    VITS branch) the same waveforms as int16, warning that ``pcm_format``
    did not apply."""
    from test_torch_vits import SMALL as VITS_SMALL
    from mockingbird_tpu_torch.models.vits import VitsSynthesizer
    pipe = VoiceCloningPipeline(synthesizer="vits", verbose=False, device="cpu")
    assert isinstance(pipe.synthesizer, VitsSynthesizer)
    pipe.synthesizer = VitsSynthesizer(cfg=VITS_SMALL, verbose=False, seed=1, device="cpu")
    want = pipe.synthesizer.synthesize(TEXTS[:2])
    got = pipe.clone_voice(TEXTS[:2], REF_WAV)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.warns(UserWarning, match="mulaw8"):
        pcm = pipe.tts_batch(TEXTS[:2], REF_WAV, pcm_format="mulaw8")
    for p, w in zip(pcm, want):
        np.testing.assert_array_equal(p, np.round(np.clip(w, -1, 1) * 32767).astype(np.int16))


VITS_STEPS = 40


@pytest.fixture(scope="module")
def vits_pipe():
    from test_torch_vits import SMALL as VITS_SMALL
    from mockingbird_tpu_torch.models.vits import VitsSynthesizer
    pipe = VoiceCloningPipeline(synthesizer="vits", verbose=False, device="cpu")
    pipe.synthesizer = VitsSynthesizer(cfg=VITS_SMALL, verbose=False, seed=3, device="cpu")
    return pipe


def test_vits_tts_batch_chunks_steps_and_int16(vits_pipe):
    """The VITS branch of ``tts_batch`` runs chunks of ``batch_size`` texts,
    each for ``steps`` frames; every text's int16 is the float path's
    waveform of its chunk quantised on the host, within one 16-bit step,
    and is ``y_lengths · hop`` samples long; without ``pcm16`` it is that
    float waveform."""
    syn = vits_pipe.synthesizer
    texts = TEXTS + TEXTS[:2]
    chunks = []
    inner = syn.synthesize_device

    def recorded(chunk, **kw):
        chunks.append((list(chunk), kw["max_frames"], kw["pcm16"]))
        return inner(chunk, **kw)
    syn.synthesize_device = recorded
    try:
        pcm = vits_pipe.tts_batch(texts, REF_WAV, steps=VITS_STEPS, batch_size=2)
        floats = vits_pipe.tts_batch(texts, REF_WAV, steps=VITS_STEPS, batch_size=2,
                                     pcm16=False)
    finally:
        syn.synthesize_device = inner
    assert [(c, f) for c, f, _ in chunks[:3]] == [(texts[0:2], VITS_STEPS),
                                                  (texts[2:4], VITS_STEPS),
                                                  (texts[4:5], VITS_STEPS)]
    assert [q for _, _, q in chunks] == [True] * 3 + [False] * 3
    hop = syn.cfg.hop_size
    want, lengths = [], []
    for i in range(0, len(texts), 2):
        o, yl = inner(texts[i:i + 2], max_frames=VITS_STEPS)
        for j in range(o.shape[0]):
            want.append(o[j, :int(yl[j]) * hop].numpy())
            lengths.append(int(yl[j]))
    assert len(pcm) == len(texts) and all(p.dtype == np.int16 for p in pcm)
    assert [len(p) for p in pcm] == [n * hop for n in lengths]
    assert all(0 < n <= VITS_STEPS for n in lengths)
    for p, f, w in zip(pcm, floats, want):
        host = np.round(np.clip(w, -1, 1) * 32767).astype(np.int16)
        assert np.abs(p.astype(np.int32) - host).max() <= 1
        np.testing.assert_array_equal(f, w)


def test_vits_sidecar_sets_the_widths(tmp_path):
    """``VitsSynthesizer`` reads the ``.json`` sidecar beside an ``.npz``:
    small-width weights load with it, and the strict load refuses them at
    the stock widths without it."""
    from test_torch_vits import SMALL as VITS_SMALL
    from mockingbird_tpu_torch.models.vits import VitsSynthesizer, init_vits, vits_config
    from mockingbird_tpu_torch.weights import WeightMismatch, save_npz, to_flax
    model = init_vits(5, vits_config().merge(VITS_SMALL))
    save_npz(tmp_path / "vits.npz", to_flax(model))
    with pytest.raises(WeightMismatch):
        VitsSynthesizer(tmp_path / "vits.npz", verbose=False, device="cpu")
    (tmp_path / "vits.json").write_text(json.dumps(VITS_SMALL))
    syn = VitsSynthesizer(tmp_path / "vits.npz", verbose=False, device="cpu")
    assert syn.cfg.hidden_channels == VITS_SMALL["hidden_channels"]
    assert syn.cfg.upsample_rates == VITS_SMALL["upsample_rates"]
    np.testing.assert_array_equal(syn.model.dec.conv_pre.weight.detach().numpy(),
                                  model.dec.conv_pre.weight.detach().numpy())
