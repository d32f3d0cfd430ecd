"""The port's Tacotron data path and trainer end to end, against the JAX
package on the CPU: ``preprocess_dataset`` and ``create_embeddings`` on a
4-utterance tone corpus laid out as an aidatatang_200zh corpus (2 speakers
× 2 utterances of 1.2 s, as ``tests/test_e2e.py`` lays one out), the
committed GE2E export on both sides; ``collate_synthesizer`` and the
``DataLoader``'s batches; then the port's ``train`` for 2 steps, a resume
and ``run_gta_synthesis`` at tiny widths. Tolerances stated per test."""
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

from mockingbird_tpu.config import sv2tts_audio_config as jaudio
from mockingbird_tpu.models.tacotron import dataset as jdata
from mockingbird_tpu.models.tacotron import preprocess as jpre
from mockingbird_tpu.train.checkpoint import load_single
from mockingbird_tpu_torch.config import sv2tts_audio_config
from mockingbird_tpu_torch.models.tacotron import dataset as tdata
from mockingbird_tpu_torch.models.tacotron import preprocess as tpre
from mockingbird_tpu_torch.train.checkpoint import CheckpointManager
from mockingbird_tpu_torch.weights import flatten_tree
from test_torch_tacotron import SMALL

ENCODER_EXPORT = Path(__file__).resolve().parents[1] / "saved_models/encoder_run/encoder.ckpt"

ttrain = importlib.import_module("mockingbird_tpu_torch.models.tacotron.train")
TINY = dict(SMALL, n_mels=80, fft_bins=80, speaker_embedding_size=256)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    ds = root / "aidatatang_200zh"
    (ds / "transcript").mkdir(parents=True)
    lines, rng, sr = [], np.random.RandomState(0), 16000
    for spk, f_base in (("G0001", 150), ("G0002", 250)):
        spk_dir = ds / "corpus" / "train" / spk
        spk_dir.mkdir(parents=True)
        for i in range(2):
            utt = f"T0055{spk}S{i:04d}"
            t = np.arange(int(sr * 1.2)) / sr
            f0 = f_base * (1 + 0.05 * np.sin(2 * np.pi * 3 * t + i))
            wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(2 * np.pi * 2 * f0 * t)
            wav += 0.01 * rng.randn(len(t))
            wavfile.write(spk_dir / f"{utt}.wav", sr, (wav * 32767).astype(np.int16))
            lines.append(f"{utt} ni3 hao3 shi4 jie4 {i}")
    (ds / "transcript" / "aidatatang_200_zh_transcript.txt").write_text("\n".join(lines))
    return root


@pytest.fixture(scope="module")
def syn_dirs(corpus, tmp_path_factory):
    """(JAX's synthesizer dir, the port's), both with embeddings of the
    committed GE2E export (orbax for JAX, its ``.npz`` for the port)."""
    enc_npz = tmp_path_factory.mktemp("enc") / "encoder.npz"
    np.savez(enc_npz, **flatten_tree(load_single(ENCODER_EXPORT)))
    jdir, tdir = tmp_path_factory.mktemp("syn_jax"), tmp_path_factory.mktemp("syn_torch")
    jpre.preprocess_dataset(corpus, jdir, n_processes=2,
                            audio_cfg=jaudio().merge(dict(utterance_min_duration=0.3)))
    jpre.create_embeddings(jdir, ENCODER_EXPORT, n_processes=2)
    tpre.preprocess_dataset(corpus, tdir, n_processes=2, device="cpu",
                            audio_cfg=sv2tts_audio_config().merge(
                                dict(utterance_min_duration=0.3)))
    tpre.create_embeddings(tdir, enc_npz, n_processes=2, device="cpu")
    return jdir, tdir


def _rows(d):
    return sorted((d / "train.txt").read_text().splitlines())


def test_preprocess_matches_jax(syn_dirs):
    """The same ``train.txt`` rows (names, lengths, pinyin); the audio equal
    (host numpy on both sides); the mels within 1e-3 (the DFT-matmul mel in
    f32, in another order of sums, through log10 ×20 dB); the embeddings of
    the committed GE2E export within 1e-4."""
    jdir, tdir = syn_dirs
    rows = _rows(tdir)
    assert rows == _rows(jdir) and len(rows) == 4
    for row in rows:
        wav_name, mel_name, embed_name = row.split("|")[:3]
        np.testing.assert_array_equal(np.load(tdir / "audio" / wav_name),
                                      np.load(jdir / "audio" / wav_name))
        mel = np.load(tdir / "mels" / mel_name)
        assert mel.shape[0] == 80
        np.testing.assert_allclose(mel, np.load(jdir / "mels" / mel_name), atol=1e-3)
        emb = np.load(tdir / "embeds" / embed_name)
        assert emb.shape == (256,) and abs(np.linalg.norm(emb) - 1) < 1e-5
        np.testing.assert_allclose(emb, np.load(jdir / "embeds" / embed_name), atol=1e-4)


def _datasets(syn_dir):
    args = (syn_dir / "train.txt", syn_dir / "mels", syn_dir / "embeds")
    return jdata.SynthesizerDataset(*args), tdata.SynthesizerDataset(*args)


def test_collate_and_loader_match_jax(syn_dirs):
    """On the port's preprocessed data: ``collate_synthesizer`` equal to
    JAX's (texts padded to 32, mels to 100 frames with the silence value,
    stop targets, lengths), and the ``DataLoader`` giving the same batches
    for the same seed over two passes."""
    jds, tds = _datasets(syn_dirs[1])
    batch = [tds[i] for i in range(4)]
    want = jdata.collate_synthesizer([jds[i] for i in range(4)], r=2)
    got = tdata.collate_synthesizer(batch, r=2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["mels"].shape[1] % 100 == 0 and got["texts"].shape[1] % 32 == 0

    def passes(mod, ds):
        loader = mod.DataLoader(ds, 2, lambda b: mod.collate_synthesizer(b, r=2), seed=5)
        return [b["indices"].tolist() for _ in range(2) for b in loader]
    assert passes(tdata, tds) == passes(jdata, jds)


def test_train_resume_and_gta(syn_dirs, tmp_path):
    """The port's ``train`` in its default precision (bf16) at tiny widths:
    2 steps (a checkpoint at step 2 and the final one at 3, eval artifacts
    at step 2), then a resume that runs step 3 to 4 from the checkpoint, and
    ``run_gta_synthesis``: one (80, T) GTA mel per utterance, T its mel
    length, and ``synthesized.txt`` naming them."""
    syn = syn_dirs[1]
    sched = ((2, 1e-3, 100, 2),)
    model = ttrain.train("run", syn, tmp_path, schedule=sched, save_every=2, eval_every=2,
                         log_every=1, total_steps=2, cfg=TINY, device="cpu")
    ckpt = CheckpointManager(tmp_path / "run" / "ckpt")
    assert ckpt.steps() == [2, 3]
    ev = tmp_path / "run" / "eval"
    for name in ("attention_000002.npz", "mel-prediction-step-000002.npy",
                 "step-000002-wave-from-mel.wav"):
        assert (ev / name).exists(), name
    assert np.load(ev / "mel-prediction-step-000002.npy").shape[1] == 80
    step, state = ckpt.restore_latest()
    for k, v in model.state_dict().items():
        assert (state["model"][k] == v).all(), k

    ttrain.train("run", syn, tmp_path, schedule=sched, save_every=0, eval_every=0,
                 log_every=1, total_steps=4, cfg=TINY, device="cpu")
    assert ckpt.steps() == [2, 3, 5]
    logged = (tmp_path / "run" / "logs" / "scalars.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in logged] == [1, 2, 4]

    n = ttrain.run_gta_synthesis("run", syn, tmp_path, batch_size=3, cfg=TINY, device="cpu")
    rows = [r.split("|") for r in _rows(syn)]
    assert n == 4
    assert sorted((syn / "synthesized.txt").read_text().splitlines()) == sorted(
        r[1] for r in rows)
    for r in rows:
        gta = np.load(syn / "mels_gta" / r[1])
        assert gta.shape == (80, int(r[4])) and np.isfinite(gta).all()
