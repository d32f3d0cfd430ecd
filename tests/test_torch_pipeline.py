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
