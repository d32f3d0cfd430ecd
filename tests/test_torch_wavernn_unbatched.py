"""WaveRNN's unbatched generator (``batched=False``: the whole unfolded
sequence as one fold, no crossfade) against the JAX package at small widths
(the fixture of ``test_torch_wavernn.py``: running statistics drawn, f32
sampler weights on both sides): through the sampler (one call at F=1)
against JAX's ``use_pallas=True, interpret=True, batched=False``, and the
step-by-step generator against JAX's ``_gen_fn`` path, both greedy, so the
labels and the waveforms are the same (1e-6); ``gen_testset(batched=False)``
writes JAX's file names."""
import importlib

import numpy as np
import pytest

from mockingbird_tpu_torch.ops import wavernn_sample as sampler_module
from test_torch_wavernn import SMALL, vocoders  # noqa: F401  (the fixture)

jtrain = importlib.import_module("mockingbird_tpu.models.vocoder.wavernn_train")
ttrain = importlib.import_module("mockingbird_tpu_torch.models.vocoder.wavernn_train")


@pytest.mark.parametrize("frames", [7, 23])
def test_sampler_unbatched_matches_jax_interpret(vocoders, monkeypatch, frames):  # noqa: F811
    jvoc, tvoc = vocoders
    mel = np.random.RandomState(frames).randn(80, frames).astype(np.float32)
    calls = []
    real = sampler_module.wavernn_sample_plain

    def counting(w, mels, aux, *a, **k):
        calls.append(tuple(mels.shape))
        return real(w, mels, aux, *a, **k)

    monkeypatch.setattr(sampler_module, "wavernn_sample_plain", counting)
    ref = jvoc.infer_waveform(mel, batched=False, use_pallas=True, interpret=True, greedy=True)
    out = tvoc.infer_waveform(mel, batched=False, greedy=True)
    # one sampler call over the whole upsampled utterance: F = 1
    assert calls == [(1, frames * 16, 80)]
    assert out.shape == ref.shape == ((frames - 1) * 16,)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    # batched is the vocoder's default (cfg.gen_batched); unbatched differs
    assert tvoc.cfg.gen_batched
    batched = tvoc.infer_waveform(mel, greedy=True, target=40, overlap=8)
    assert batched.shape == out.shape and not np.allclose(batched, out)


def test_step_by_step_unbatched_matches_jax_cpu_path(vocoders):  # noqa: F811
    jvoc, tvoc = vocoders
    mel = np.random.RandomState(4).randn(80, 9).astype(np.float32)
    ref = jvoc.infer_waveform(mel, batched=False, use_pallas=False, greedy=True)
    out = tvoc.infer_waveform(mel, batched=False, use_sampler=False, greedy=True)
    assert out.shape == ref.shape == (8 * 16,)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    # the sampler and the step-by-step generator agree, greedy
    np.testing.assert_allclose(tvoc.infer_waveform(mel, batched=False, greedy=True), out,
                               atol=1e-6)


def test_gen_batched_config_is_the_default(vocoders):  # noqa: F811
    """``batched=None`` reads ``cfg.gen_batched``, as JAX's does."""
    from mockingbird_tpu_torch.models.vocoder import WaveRnnVocoder
    _, tvoc = vocoders
    voc = WaveRnnVocoder(cfg=dict(SMALL, gen_batched=False), verbose=False, device="cpu")
    voc.model.load_state_dict(tvoc.model.state_dict())
    voc.packed = tvoc.packed
    mel = np.random.RandomState(8).randn(80, 12).astype(np.float32)
    np.testing.assert_array_equal(voc.infer_waveform(mel, greedy=True),
                                  tvoc.infer_waveform(mel, batched=False, greedy=True))


def _dataset(root, n=2, frames=(10, 14)):
    rng = np.random.RandomState(0)
    (root / "mels").mkdir(parents=True)
    (root / "audio").mkdir()
    rows = []
    for i in range(n):
        t = frames[i % len(frames)]
        np.save(root / "mels" / f"mel-{i}.npy", rng.randn(80, t).astype(np.float32))
        np.save(root / "audio" / f"audio-{i}.npy",
                (0.3 * rng.randn(t * 16)).astype(np.float32))
        rows.append(f"audio-{i}.npy|mel-{i}.npy|embed-{i}.npy|{t * 16}|1|x")
    (root / "train.txt").write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("batched", [False, True])
def test_gen_testset_writes_jax_file_names(vocoders, tmp_path, batched):  # noqa: F811
    jvoc, tvoc = vocoders
    _dataset(tmp_path / "syn")
    syn = tmp_path / "syn"
    tds = ttrain.WaveRnnDataset(syn / "train.txt", syn / "mels", syn / "audio", tvoc.cfg)
    jds = jtrain.WaveRnnDataset(syn / "train.txt", syn / "mels", syn / "audio", jvoc.cfg)
    ttrain.gen_testset(tvoc.model, tds, tmp_path / "port", tvoc.cfg, samples=2, step=5,
                       batched=batched)
    jtrain.gen_testset(jvoc.variables, jds, tmp_path / "jax", jvoc.cfg, samples=2, step=5,
                       batched=batched)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    tag = ("gen_not_batched" if not batched
           else f"gen_batched_target{tvoc.cfg.gen_target}_overlap{tvoc.cfg.gen_overlap}")
    assert names == sorted([f"5_steps_{i}_{kind}.wav" for i in range(2)
                            for kind in ("target", tag)])
