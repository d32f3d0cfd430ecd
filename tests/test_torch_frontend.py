"""Parity of the port's front end with the JAX package: DSP (mel_encoder,
melspectrogram), host preprocessing, the text frontend and the GE2E speaker
encoder. Inputs come from numpy seeds; the JAX side's params are carried
across with ``mockingbird_tpu_torch.weights``. Tolerances are stated per
test (default float32, atol 1e-4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mockingbird_tpu import dsp as jdsp
from mockingbird_tpu.config import encoder_audio_config, sv2tts_audio_config
from mockingbird_tpu_torch import dsp as tdsp

REF_WAV = "saved_models/gan_run/eval/ground_truth.wav"


def to_numpy(tree):
    return ({k: to_numpy(v) for k, v in tree.items()} if isinstance(tree, dict)
            else np.asarray(tree, np.float32))


def test_mel_encoder_matches_jax():
    # power-2 mel reaches ~1e2 on speech-level input: compare relative to the peak
    wav = (np.random.RandomState(0).randn(2, 6000) * 0.3).astype(np.float32)
    ref = np.asarray(jdsp.mel_encoder(jnp.asarray(wav), encoder_audio_config()))
    out = tdsp.mel_encoder(torch.from_numpy(wav), encoder_audio_config()).numpy()
    assert out.shape == ref.shape == (2, 38, 40)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_melspectrogram_matches_jax():
    wav = (np.random.RandomState(1).randn(4000) * 0.3).astype(np.float32)
    ref = np.asarray(jdsp.melspectrogram(jnp.asarray(wav), sv2tts_audio_config()))
    out = tdsp.melspectrogram(torch.from_numpy(wav), sv2tts_audio_config()).numpy()
    assert out.shape == ref.shape == (16, 80)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_preprocess_wav_and_text_match_jax():
    """The copied host modules give identical results (exact)."""
    from mockingbird_tpu.text import romanize as jrom, text_to_sequence as jseq
    from mockingbird_tpu_torch.text import romanize as trom, text_to_sequence as tseq
    for s in ["ni3 hao3, shi4 jie4!", "你好世界，银行长大", "Dr. Smith paid $12."]:
        assert trom(s) == jrom(s)
        assert tseq(trom(s)) == jseq(jrom(s))
    cfg = encoder_audio_config()
    np.testing.assert_array_equal(tdsp.preprocess_wav(REF_WAV, cfg),
                                  jdsp.preprocess_wav(REF_WAV, cfg))


@pytest.fixture(scope="module")
def encoders():
    from mockingbird_tpu.models.encoder import SpeakerEncoderInference as J
    from mockingbird_tpu.models.encoder.model import init_params
    from mockingbird_tpu_torch.models.encoder import SpeakerEncoderInference as T
    params = to_numpy(init_params(jax.random.PRNGKey(3))["model"])
    return J(params), T(params, device="cpu")


def test_encoder_frames_batch_matches_jax(encoders):
    jenc, tenc = encoders
    frames = np.abs(np.random.RandomState(2).randn(3, 50, 40)).astype(np.float32)
    ref = jenc.embed_frames_batch(frames)
    out = tenc.embed_frames_batch(frames)
    assert out.shape == (3, 256)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_embed_utterance_matches_jax(encoders):
    jenc, tenc = encoders
    wav = tenc.preprocess_wav(REF_WAV)
    wav = np.concatenate([wav] * 12)              # several partials
    ref, ref_parts, _ = jenc.embed_utterance(wav, return_partials=True)
    out, parts, _ = tenc.embed_utterance(wav, return_partials=True)
    assert parts.shape == ref_parts.shape and parts.shape[0] > 1
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert abs(np.linalg.norm(out) - 1.0) < 1e-5
