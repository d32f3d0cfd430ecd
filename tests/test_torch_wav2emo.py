"""The wav2vec2 emotion extractor of the port against the JAX package.

The same seed-made inputs go through ``mockingbird_tpu``'s flax model (or
extractor) and the port's, at the tiny random config of
``tests/test_wav2emo.py`` (weights of a tiny HF ``Wav2Vec2Model``, converted
by each package's converter). Both encoder variants: pre-LN with the
layer-norm feature extractor, and post-LN with the group-norm one, where the
padding bucket changes the result. Tolerances: 1e-4 max abs against JAX,
5e-4 against the HF torch model (JAX's own bound for that comparison).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import Wav2Vec2Config
from transformers.models.wav2vec2.modeling_wav2vec2 import Wav2Vec2Model

from mockingbird_tpu.interop.torch_weights import convert_wav2vec2_emotion as jconvert
from mockingbird_tpu.models.wav2emo import EmotionExtractorModel as JModel
from mockingbird_tpu.models.wav2emo import wav2emo_config as jconfig
from mockingbird_tpu_torch.interop.torch_weights import convert_wav2vec2_emotion
from mockingbird_tpu_torch.models.tacotron import emotion
from mockingbird_tpu_torch.models.tacotron.emotion import EMOTION_DIM, EmotionExtractor
from mockingbird_tpu_torch.models.wav2emo import (EmotionExtractorModel, frame_mask_of,
                                                  init_wav2emo, normalize_wav, wav2emo_config)
from mockingbird_tpu_torch.weights import flatten_tree, load_flax, save_npz, to_flax

TINY = dict(conv_dim=(8, 8), conv_stride=(5, 2), conv_kernel=(10, 3),
            hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=32, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4)
VARIANTS = [(True, "layer"), (False, "group")]
TOL = 1e-4


def _cfg(stable, norm):
    return dict(feat_extract_norm=norm, do_stable_layer_norm=stable, num_labels=3, **TINY)


def _hf_state_dict(stable, norm, seed=0):
    """A tiny HF Wav2Vec2Model with a random regression head, as the
    reference's EmotionExtractorModel state_dict (``wav2vec2.*`` and
    ``classifier.*``), and the HF model itself."""
    tc = Wav2Vec2Config(conv_bias=True, feat_extract_norm=norm, do_stable_layer_norm=stable,
                        feat_extract_activation="gelu", hidden_act="gelu",
                        hidden_dropout=0.0, attention_dropout=0.0, feat_proj_dropout=0.0,
                        layerdrop=0.0, apply_spec_augment=False, **TINY)
    torch.manual_seed(seed)
    hf = Wav2Vec2Model(tc).eval()
    dense, out_proj = torch.nn.Linear(16, 16), torch.nn.Linear(16, 3)
    sd = {f"wav2vec2.{k}": v for k, v in hf.state_dict().items()}
    sd.update({"classifier.dense.weight": dense.weight, "classifier.dense.bias": dense.bias,
               "classifier.out_proj.weight": out_proj.weight,
               "classifier.out_proj.bias": out_proj.bias})
    return {k: v.detach().clone() for k, v in sd.items()}, hf, (dense, out_proj)


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _jax_forward(tree, cfg, wav, fmask=None):
    with jax.default_matmul_precision("highest"):
        emb, logits = JModel(jconfig().merge(cfg).freeze()).apply(
            {"params": tree}, jnp.asarray(wav), None if fmask is None else jnp.asarray(fmask))
    return np.asarray(emb), np.asarray(logits)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("stable,norm", VARIANTS, ids=["preLN-layer", "postLN-group"])
def test_model_matches_jax(stable, norm, masked):
    """EmotionExtractorModel: JAX's params loaded by ``load_flax``; masked
    batches include a row whose every frame is masked (pooled to 0, no
    NaN)."""
    cfg = _cfg(stable, norm)
    tree = jconvert(_np(_hf_state_dict(stable, norm)[0]), jconfig().merge(cfg))
    model = load_flax(EmotionExtractorModel(wav2emo_config().merge(cfg)), tree).eval()
    rng = np.random.default_rng(1)
    wav = rng.standard_normal((3, 900)).astype(np.float32)
    fmask = frame_mask_of(np.array([900, 450, 5]), 900, model.cfg) if masked else None
    assert not masked or not fmask[2].any()
    want = _jax_forward(tree, cfg, wav, fmask)
    with torch.no_grad():
        got = model(torch.from_numpy(wav), None if fmask is None else torch.from_numpy(fmask))
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL)


def test_normalize_wav_matches_jax():
    from mockingbird_tpu.models.wav2emo import normalize_wav as jnormalize
    rng = np.random.default_rng(2)
    wav = (rng.standard_normal((3, 1500)) * 0.3).astype(np.float32)
    n = np.array([1500, 1200, 1])
    for n_valid in (None, n):
        want = np.asarray(jnormalize(jnp.asarray(wav),
                                     None if n_valid is None else jnp.asarray(n_valid)))
        got = normalize_wav(torch.from_numpy(wav),
                            None if n_valid is None else torch.from_numpy(n_valid)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_extract_batch_matches_jax(tmp_path):
    """Group variant, ragged wavs in one 1 s bucket, one of 5 samples
    (valid frames ≤ 0): embeddings and logits within 1e-4 of JAX's, both
    read from the same torch checkpoint."""
    from mockingbird_tpu.models.tacotron.emotion import EmotionExtractor as JExtractor
    sd, _, _ = _hf_state_dict(False, "group", seed=3)
    fp = tmp_path / "emotion.pt"
    torch.save(sd, fp)
    cfg = _cfg(False, "group")
    jex = JExtractor(weights_path=fp, cfg=cfg)
    ex = EmotionExtractor(weights_path=fp, cfg=cfg, device="cpu")
    assert jex.available and ex.available
    rng = np.random.default_rng(4)
    wavs = [rng.standard_normal(n).astype(np.float32) for n in (5, 900, 7000, 15000)]
    with jax.default_matmul_precision("highest"):
        want = jex.extract_batch(wavs)
    got = ex.extract_batch(wavs)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    # the bucket is part of the result: unpadded, the group norm's
    # statistics differ
    alone = ex.extract_batch([wavs[1][:900]])[0][0]
    with torch.no_grad():
        x = normalize_wav(torch.from_numpy(wavs[1][None]))
        unpadded = ex.model(x)[0][0].numpy()
    assert np.abs(alone - unpadded).max() > 10 * TOL
    np.testing.assert_allclose(alone, got[0][1], rtol=0, atol=TOL)


@pytest.mark.parametrize("storage", ["parametrizations", "weight_g"])
@pytest.mark.parametrize("stable,norm", VARIANTS, ids=["preLN-layer", "postLN-group"])
def test_converter_matches_jax(stable, norm, storage):
    """The port's converter gives JAX's tree exactly, from either weight-norm
    storage and with or without the ``wav2vec2.`` prefix and head; the
    loaded model is held against the HF torch model itself."""
    sd, hf, (dense, out_proj) = _hf_state_dict(stable, norm)
    sd = _np(sd)
    if storage == "weight_g":
        pc = "wav2vec2.encoder.pos_conv_embed.conv"
        sd[f"{pc}.weight_g"] = sd.pop(f"{pc}.parametrizations.weight.original0")
        sd[f"{pc}.weight_v"] = sd.pop(f"{pc}.parametrizations.weight.original1")
    cfg = _cfg(stable, norm)
    bare = {k[len("wav2vec2."):]: v for k, v in sd.items() if k.startswith("wav2vec2.")}
    for state, prefix in ((sd, "wav2vec2"), (bare, "")):
        want = flatten_tree(jconvert(state, jconfig().merge(cfg), prefix=prefix))
        got = flatten_tree(convert_wav2vec2_emotion(state, wav2emo_config().merge(cfg),
                                                    prefix=prefix))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = load_flax(EmotionExtractorModel(wav2emo_config().merge(cfg)),
                      convert_wav2vec2_emotion(sd, wav2emo_config().merge(cfg))).eval()
    wav = np.random.default_rng(5).standard_normal((2, 1100)).astype(np.float32)
    with torch.no_grad():
        hidden = hf(torch.from_numpy(wav)).last_hidden_state
        pooled = hidden.mean(1)
        logits = out_proj(torch.tanh(dense(pooled)))
        emb, lg = model(torch.from_numpy(wav))
    np.testing.assert_allclose(emb.numpy(), pooled.numpy(), rtol=0, atol=5e-4)
    np.testing.assert_allclose(lg.numpy(), logits.numpy(), rtol=0, atol=5e-4)


def _synth_root(root, n=5, seed=6):
    (root / "audio").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    meta = []
    for i in range(n):
        fname = f"audio-spk_utt{i}.npy"
        np.save(root / "audio" / fname, rng.standard_normal(600 + 2500 * i).astype(np.float32))
        meta.append(f"{fname}|mel-spk_utt{i}.npy|embed-spk_utt{i}.npy|800|100|text")
    (root / "train.txt").write_text("\n".join(meta))


def test_create_emotion_embeddings_matches_jax(tmp_path, monkeypatch):
    """The port's ``emo/`` files, from an ``.npz`` export with its config
    sidecar, equal JAX's from the torch checkpoint within 1e-4, batches of 2
    over ragged lengths; the port's ``VitsDataset`` reads them back. JAX's
    ``create_emotion_embeddings`` takes no config, so the tiny config is
    patched into its extractor here."""
    import functools
    from mockingbird_tpu.models.tacotron import emotion as jemotion
    from mockingbird_tpu.models.tacotron.preprocess import (
        create_emotion_embeddings as jcreate)
    from mockingbird_tpu_torch.models.tacotron.preprocess import create_emotion_embeddings
    from mockingbird_tpu_torch.models.vits.model import vits_config
    from mockingbird_tpu_torch.models.vits.train import VitsDataset

    sd, _, _ = _hf_state_dict(False, "group", seed=7)
    fp = tmp_path / "emotion.pt"
    torch.save(sd, fp)
    cfg = _cfg(False, "group")
    monkeypatch.setattr(jemotion, "EmotionExtractor",
                        functools.partial(jemotion.EmotionExtractor, cfg=cfg))
    _synth_root(tmp_path / "jax")
    with jax.default_matmul_precision("highest"):
        jcreate(tmp_path / "jax", weights_path=fp, batch_size=2)

    model = load_flax(EmotionExtractorModel(wav2emo_config().merge(cfg)),
                      convert_wav2vec2_emotion(_np(sd), wav2emo_config().merge(cfg)))
    save_npz(tmp_path / "emotion.npz", to_flax(model)["params"])
    (tmp_path / "emotion.json").write_text(
        __import__("json").dumps(wav2emo_config().merge(cfg).to_dict()))
    _synth_root(tmp_path / "port")
    create_emotion_embeddings(tmp_path / "port", weights_path=tmp_path / "emotion.npz",
                              batch_size=2, device="cpu")
    names = sorted(p.name for p in (tmp_path / "jax" / "emo").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port" / "emo").iterdir())
    assert len(names) == 5
    for name in names:
        got = np.load(tmp_path / "port" / "emo" / name)
        assert got.shape == (16,)
        np.testing.assert_allclose(got, np.load(tmp_path / "jax" / "emo" / name),
                                   rtol=0, atol=TOL)
    # the VITS dataset reads each utterance's emotion vector back
    ds = VitsDataset(tmp_path / "port", vits_config())
    for i, (fname, _, _) in enumerate(ds.items):
        np.testing.assert_array_equal(
            ds[i][4], np.load(tmp_path / "port" / "emo" / f"emo-{fname.split('-', 1)[-1]}"))


def test_weights_files_agree(tmp_path):
    """A torch checkpoint (the reference's layout), a ``.safetensors`` file
    and an ``.npz`` export with its sidecar load into the same extractor."""
    from safetensors.torch import save_file
    sd, _, _ = _hf_state_dict(True, "layer", seed=8)
    cfg = _cfg(True, "layer")
    torch.save({"state_dict": sd}, tmp_path / "emotion.bin")
    save_file({k: v.contiguous() for k, v in sd.items()}, str(tmp_path / "emotion.safetensors"))
    ref = EmotionExtractor(tmp_path / "emotion.bin", cfg=cfg, device="cpu")
    save_npz(tmp_path / "emotion.npz", to_flax(ref.model)["params"])
    (tmp_path / "emotion.json").write_text(
        __import__("json").dumps(wav2emo_config().merge(cfg).to_dict()))
    wavs = [np.random.default_rng(9).standard_normal(3000).astype(np.float32)]
    want = ref.extract_batch(wavs)
    for name in ("emotion.safetensors", "emotion.npz"):
        ex = EmotionExtractor(tmp_path / name, cfg=None if name.endswith("npz") else cfg,
                              device="cpu")
        for g, w in zip(ex.extract_batch(wavs), want):
            np.testing.assert_array_equal(g, w)


def test_missing_path_raises_and_no_cache_gives_zeros(tmp_path, monkeypatch):
    """An explicit path that does not exist raises (JAX returns zeros there,
    ``tests/test_wav2emo.py::test_extractor_fallback_and_api``); with no
    path and no cached model the extractor warns and returns JAX's neutral
    zeros. The empty HF cache is simulated: ``from_pretrained`` raises as
    it does without local files."""
    import transformers
    with pytest.raises(FileNotFoundError, match="missing.bin"):
        EmotionExtractor(weights_path=tmp_path / "missing.bin", device="cpu")

    def no_local_files(*a, **k):
        raise OSError("no local files for this model")

    monkeypatch.setattr(transformers.AutoConfig, "from_pretrained", no_local_files)
    monkeypatch.setattr(emotion, "_singleton", {})
    with pytest.warns(UserWarning, match="fall back to zeros"):
        ex = EmotionExtractor(device="cpu")
    assert not ex.available
    emb, logits = ex.extract(np.zeros(16000, np.float32))
    assert emb.shape == (EMOTION_DIM,) and not emb.any() and logits.shape == (3,)
    e2, l2 = ex.extract_batch([np.zeros(100, np.float32), np.zeros(200, np.float32)])
    assert e2.shape == (2, EMOTION_DIM) and not e2.any() and not l2.any()
    with pytest.warns(UserWarning):
        assert not emotion.available("cpu")
    assert not emotion.extract_emo(np.zeros(1600, np.float32), device="cpu").any()
    assert emotion.extract_emo(np.zeros(1600, np.float32), embeddings=False,
                               device="cpu").shape == (3,)


def test_seeded_extractor(tmp_path):
    """``seed=`` gives weights made from it: available, non-zero, the same
    for the same seed, as ``init_wav2emo`` builds them."""
    cfg = _cfg(True, "layer")
    a = EmotionExtractor(cfg=cfg, seed=3, device="cpu")
    b = EmotionExtractor(cfg=cfg, seed=3, device="cpu")
    assert a.available
    wav = np.random.default_rng(10).standard_normal(2000).astype(np.float32)
    emb, _ = a.extract(wav)
    assert np.abs(emb).max() > 0
    np.testing.assert_array_equal(emb, b.extract(wav)[0])
    ref = init_wav2emo(3, cfg)
    for (k, v), (k2, v2) in zip(a.model.state_dict().items(), ref.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(v, v2, rtol=0, atol=0)
