"""The port's ppg2mel trainer against the JAX package on the CPU, at the small
config of ``tests/test_ppg.py`` (decoder 32 wide, 20 mels; the prenet's
dropout on): ``collate_vc``, ``masked_mse``, the corpus mel against JAX's
``melspectrogram_bucketed``, the training-mode forward, loss, f32 gradients and BatchNorm statistics,
three steps of the trainer's optimizer (clip 5, AdamW under the warmup and
cosine schedule), the bf16 step, ``preprocess_vc_dataset`` and ``train``.

Dropout draws are handed in: ``jax.random.bernoulli`` is patched to return
one keep mask per dropout site (by shape; the four postnet layers' masks in
order), and the port takes the same masks through ``masks=``. JAX's
``nn.scan`` traces its body once, so there one mask per site serves every
decoder step; the port's loop uses it at every step too. The JAX side runs
the JAX package's own functions, jitted; weights are JAX's, BatchNorm
statistics drawn from a numpy seed, carried across by ``load_flax``.
Tolerances are stated per test."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mockingbird_tpu.config import sv2tts_audio_config as jaudio
from mockingbird_tpu.dsp import melspectrogram_bucketed as jmel_bucketed
from mockingbird_tpu.models.encoder import SpeakerEncoderInference as JEncoder
from mockingbird_tpu.models.ppg import extractor as jext
from mockingbird_tpu.models.ppg import ppg2mel as jp2m
from mockingbird_tpu.train.precision import Policy as JPolicy
from mockingbird_tpu_torch.config import sv2tts_audio_config
from mockingbird_tpu_torch.dsp import melspectrogram
from mockingbird_tpu_torch.models.encoder import SpeakerEncoderInference as TEncoder
from mockingbird_tpu_torch.models.ppg import extractor as text
from mockingbird_tpu_torch.models.ppg import ppg2mel as tp2m
from mockingbird_tpu_torch.train.optim import adamw, warmup_cosine_decay
from mockingbird_tpu_torch.weights import flatten_tree, load_flax, to_flax
from test_torch_ppg import (ENCODER_CKPT, jp2m_cfg, jppg_cfg, jtree, randomise, to_numpy,
                            tone, tp2m_cfg, tppg_cfg)

# both packages' ``models.ppg`` export a ``train`` function of that name
jtrain = importlib.import_module("mockingbird_tpu.models.ppg.train")
ttrain = importlib.import_module("mockingbird_tpu_torch.models.ppg.train")
jconvert = importlib.import_module("mockingbird_tpu.models.ppg.convert")
tconvert = importlib.import_module("mockingbird_tpu_torch.models.ppg.convert")

DROP = dict(prenet_always_dropout=True)
LR, WARMUP, DECAY = 1e-3, 2, 10
KEYS = ("ppgs", "lengths", "mels", "lengths", "lf0s", "embeds")


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def vc_items(rng, lengths=(48, 36, 21), d_ppg=24, n_mels=20, d_spk=16):
    return [(rng.randn(n, d_ppg).astype(np.float32),
             np.stack([rng.randn(n), rng.rand(n) > 0.3], -1).astype(np.float32),
             (rng.randn(n, n_mels) * 0.5).astype(np.float32),
             rng.randn(d_spk).astype(np.float32)) for n in lengths]


def test_collate_and_masked_mse_equal_jax():
    """``collate_vc`` exactly JAX's (several buckets and steps);
    ``masked_mse`` within 1e-6 relative (f32 sums of 3840 terms)."""
    rng = np.random.RandomState(0)
    for lengths, fps, bucket in (((48, 36, 21), 2, 64), ((70, 3), 3, 16), ((5,), 2, 64)):
        items = vc_items(rng, lengths)
        a = ttrain.collate_vc(items, fps, 4, bucket)
        b = jtrain.collate_vc(items, fps, 4, bucket)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    pred, target = rng.randn(3, 64, 20).astype(np.float32), rng.randn(3, 64, 20).astype(np.float32)
    mask = (rng.rand(3, 64, 1) > 0.4).astype(np.float32)
    got = ttrain.masked_mse(*(torch.from_numpy(x) for x in (pred, target, mask)))
    want = jtrain.masked_mse(*(jnp.asarray(x) for x in (pred, target, mask)))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(ttrain.masked_mse(*(torch.zeros(2, 3, 1),) * 3)) == 0.0


@pytest.mark.parametrize("n", [200, 5000, 16384, 16385, 40001, 70000])
def test_vc_mel_matches_jax_bucketed(n):
    """The corpus mel of ``preprocess_vc_dataset`` (the port's
    ``melspectrogram``) has JAX's ``melspectrogram_bucketed`` frame count
    at lengths on both sides of its 16384-sample buckets, and is within the
    JAX test's 2e-4 of it."""
    wav = (np.random.RandomState(n).randn(n) * 0.1).astype(np.float32)
    got = melspectrogram(torch.from_numpy(wav), sv2tts_audio_config()).numpy()
    want = jmel_bucketed(wav, jaudio())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_schedule_factor_equals_optax():
    """``warmup_cosine_decay`` × the peak equals optax's schedule at the
    trainer's settings within 1e-6 of the peak (optax computes in f32), and
    is 0 at the first update."""
    f = warmup_cosine_decay(1000, 500_000)
    sched = optax.warmup_cosine_decay_schedule(0.0, 5e-4, 1000, 500_000)
    assert f(0) == 0.0
    for c in (1, 2, 500, 999, 1000, 1001, 250_000, 400_000, 499_000, 600_000):
        assert 5e-4 * f(c) == pytest.approx(float(sched(c)), rel=0, abs=1e-6 * 5e-4), c


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _masks(rng, b, t, cfg):
    """One keep mask per dropout site, by site."""
    def keep(*shape):
        return rng.rand(*shape) >= 0.5
    return {"prenet": [keep(b, d) for d in cfg["prenet_dims"]],
            "attention": keep(b, cfg.get("num_mixtures", 5)),
            "postnet": [keep(b, t, 512) for _ in range(4)] + [keep(b, t, cfg["num_mels"])]}


@pytest.fixture(scope="module")
def case():
    """JAX's variables (random BatchNorm statistics), a collated batch and
    the masks; JAX's training forward, loss, gradients and new statistics
    in f32 and bf16; the variables after three steps of JAX's
    ``make_vc_step`` with the trainer's optimizer chain."""
    cfg = jp2m_cfg(**DROP)
    model, v = jp2m.init_ppg2mel(jax.random.PRNGKey(5), cfg)
    variables = randomise(to_numpy(v), np.random.RandomState(10))
    rng = np.random.RandomState(11)
    batch = jtrain.collate_vc(vc_items(rng), cfg.frames_per_step, 4)
    b, t = batch["mels"].shape[:2]
    masks = _masks(rng, b, t, dict(cfg))
    by_shape = {}
    for m in (masks["prenet"] + [masks["attention"]] + masks["postnet"]):
        by_shape.setdefault(m.shape, []).append(m)
    calls = {}
    bernoulli = jax.random.bernoulli

    def handed_in(key, p=0.5, shape=None):
        shape = tuple(shape)
        if shape not in by_shape:
            return bernoulli(key, p, shape)
        i = calls[shape] = calls.get(shape, -1) + 1
        return jnp.asarray(by_shape[shape][i % len(by_shape[shape])])

    jb = jtree(batch)
    out = dict(variables=variables, batch=batch, masks=masks)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", handed_in)

        def loss_fn(params, stats, policy):
            o, mut = model.apply(
                {"params": policy.cast(params), "batch_stats": policy.cast(stats)},
                policy.cast(jb["ppgs"]), jb["lengths"], policy.cast(jb["mels"]), jb["lengths"],
                policy.cast(jb["lf0s"]), policy.cast(jb["embeds"]), True,
                rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
            o, stats = policy.uncast(o), policy.uncast(mut["batch_stats"])
            mask = (jnp.arange(t)[None] < jb["lengths"][:, None]).astype(jnp.float32)[..., None]
            l_mel = (jtrain.masked_mse(o[0], jb["mels"], mask)
                     + jtrain.masked_mse(o[1], jb["mels"], mask))
            s = jnp.clip(jax.nn.sigmoid(o[2]), 1e-7, 1 - 1e-7)
            l_stop = -jnp.mean(jb["stops"] * jnp.log(s) + (1 - jb["stops"]) * jnp.log(1 - s))
            return l_mel + l_stop, (o, stats, l_mel, l_stop)

        for prec in ("fp32", "bf16"):
            vg = jax.jit(jax.value_and_grad(lambda p, s, pol=JPolicy.from_name(prec):
                                            loss_fn(p, s, pol), has_aux=True))
            (loss, (o, stats, l_mel, l_stop)), grads = vg(jtree(variables["params"]),
                                                          jtree(variables["batch_stats"]))
            out[prec] = dict(loss=float(loss), l_mel=float(l_mel), l_stop=float(l_stop),
                             out=[np.asarray(x) for x in o], grads=jax.tree.map(np.asarray, grads),
                             stats=jax.tree.map(np.asarray, stats))

        tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(
            optax.warmup_cosine_decay_schedule(0.0, LR, WARMUP, DECAY)))
        step = jtrain.make_vc_step(model, tx, "fp32")
        params, stats = jtree(variables["params"]), jtree(variables["batch_stats"])
        opt_state = tx.init(params)
        losses = []
        for k in range(3):
            params, stats, opt_state, loss, _, _ = step(params, stats, opt_state, jb,
                                                        jax.random.PRNGKey(k))
            losses.append(float(loss))
        out["steps"] = (losses, {"params": jax.tree.map(np.asarray, params),
                                 "batch_stats": jax.tree.map(np.asarray, stats)})
    return out


def _port(case):
    model = load_flax(tp2m.MelDecoderMOLv2(tp2m_cfg(**DROP)), case["variables"])
    return model.train()


def _tensors(case):
    batch = ttrain.to_device(case["batch"], "cpu")
    masks = {k: ([torch.from_numpy(m) for m in v] if isinstance(v, list) else torch.from_numpy(v))
             for k, v in case["masks"].items()}
    return batch, masks


def _forward_and_grads(case, precision):
    from mockingbird_tpu_torch.train.precision import Policy
    model = _port(case)
    batch, masks = _tensors(case)
    out = Policy.from_name(precision).apply(model, *(batch[k] for k in KEYS), masks=masks)
    loss, l_mel, l_stop = ttrain.vc_loss(out, batch)
    loss.backward()
    return model, out, (loss.item(), l_mel.item(), l_stop.item())


def _flax_grads(model):
    """The port's gradients in the flax layout (``to_flax`` of a copy)."""
    g = tp2m.MelDecoderMOLv2(tp2m_cfg(**DROP))
    with torch.no_grad():
        for (_, p), (_, q) in zip(model.named_parameters(), g.named_parameters()):
            q.copy_(p.grad)
    return flatten_tree(to_flax(g)["params"])


def test_training_forward_loss_and_f32_gradients_match_jax(case):
    """Training mode with the masks handed in: the four outputs within atol
    1e-4, the losses within 1e-5 relative, every gradient leaf within 1e-3
    relative L2 (all leaves together within 1e-4), and the new BatchNorm
    statistics (batch mean, biased variance, momentum 0.9) within 1e-5. The
    postnet convs' biases feed a BatchNorm in batch-statistics mode, so
    their gradient is 0 in exact arithmetic: both are rounding noise, within
1e-5 of each other (the largest gradients are of order 1)."""
    model, out, losses = _forward_and_grads(case, "fp32")
    want = case["fp32"]
    for g, w in zip(out, want["out"]):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-4)
    for got, key in zip(losses, ("loss", "l_mel", "l_stop")):
        assert got == pytest.approx(want[key], rel=1e-5), key
    got, jflat = _flax_grads(model), flatten_tree(want["grads"])
    assert got.keys() == jflat.keys()
    for k in got:
        if k.startswith("postnet/conv") and k.endswith("bias"):
            np.testing.assert_allclose(got[k], jflat[k], rtol=0, atol=1e-5, err_msg=k)
        else:
            assert rel_l2(got[k], jflat[k]) <= 1e-3, k
    keys = sorted(got)
    assert rel_l2(np.concatenate([got[k].ravel() for k in keys]),
                  np.concatenate([jflat[k].ravel() for k in keys])) <= 1e-4
    stats = flatten_tree(to_flax(model)["batch_stats"])
    for k, w in flatten_tree(want["stats"]).items():
        np.testing.assert_allclose(stats[k], w, atol=1e-5, err_msg=k)


def test_three_steps_match_jax(case):
    """Three steps of ``make_vc_step`` with the trainer's AdamW and schedule
    (warmup 2, decay 10, so that the steps reach the cosine part) against
    JAX's with optax's chain. The first update runs at a
    learning rate of 0 and leaves every parameter as it was. The losses
    within 1e-4 relative. Adam's early steps move an element by about its
    learning rate whatever the gradient's size, so an element whose
    gradient is rounding noise may move either way: the postnet convs'
    biases (0 in exact arithmetic, before a BatchNorm in batch-statistics
    mode) and a few elements with tiny gradients. Every element is within
    twice the learning rates summed, all but 0.1% of each other leaf's
    within 1e-6 + 1% of the peak rate; the statistics within 1e-5 + a tenth
    of that bound (a bias reaches its BatchNorm's running mean with weight
    0.1)."""
    model = _port(case)
    batch, masks = _tensors(case)
    opt = adamw(model.parameters(), LR)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, warmup_cosine_decay(WARMUP, DECAY))
    step = ttrain.make_vc_step(model, opt, sched, "fp32")
    before = {k: v.clone() for k, v in model.named_parameters()}
    losses = []
    for k in range(3):
        losses.append(float(step(batch, None, masks)[0]))
        if k == 0:
            for n, p in model.named_parameters():
                assert torch.equal(p, before[n]), n
    jlosses, want = case["steps"]
    assert losses == pytest.approx(jlosses, rel=1e-4)
    factor = warmup_cosine_decay(WARMUP, DECAY)
    flip = 2 * LR * sum(factor(c) for c in range(3))
    got = to_flax(model)
    g, w = flatten_tree(got["params"]), flatten_tree(want["params"])
    assert g.keys() == w.keys()
    for k in g:
        diff = np.abs(g[k] - w[k])
        assert diff.max() <= flip, k
        if not (k.startswith("postnet/conv") and k.endswith("bias")):
            assert np.mean(diff > 1e-6 + 0.01 * LR) <= 1e-3, k
    g, w = flatten_tree(got["batch_stats"]), flatten_tree(want["batch_stats"])
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5 + 0.1 * flip, err_msg=k)


def test_bf16_step_matches_jax(case):
    """Under the bf16 policy: the loss within 1e-2 relative of JAX's bf16
    loss, the gradients within 5e-2 relative L2 over all leaves, the new
    statistics (read through bf16, momentum 0.8984375) within 1e-2."""
    model, _, losses = _forward_and_grads(case, "bf16")
    want = case["bf16"]
    assert losses[0] == pytest.approx(want["loss"], rel=1e-2)
    got, jflat = _flax_grads(model), flatten_tree(want["grads"])
    keys = sorted(got)
    assert rel_l2(np.concatenate([got[k].ravel() for k in keys]),
                  np.concatenate([jflat[k].ravel() for k in keys])) <= 5e-2
    stats = flatten_tree(to_flax(model)["batch_stats"])
    for k, w in flatten_tree(want["stats"]).items():
        np.testing.assert_allclose(stats[k], w, atol=1e-2, rtol=1e-2, err_msg=k)


def test_generator_dropout_is_seeded_and_eval_has_none(case):
    """With a generator every site draws: two generators of one seed give
    one result, another seed another; in eval mode the attention and
    postnet draw nothing (only the prenet's always-on dropout)."""
    batch, _ = _tensors(case)
    args = [batch[k] for k in KEYS]
    with torch.no_grad():
        a, b, c = (_port(case)(*args, generator=torch.Generator().manual_seed(s))[1]
                   for s in (1, 1, 2))
        assert torch.equal(a, b) and not torch.equal(a, c)
        on = _port(case).eval()
        off = load_flax(tp2m.MelDecoderMOLv2(tp2m_cfg()), case["variables"]).eval()
        gen = torch.Generator().manual_seed(3)
        np.testing.assert_array_equal(on(*args)[1].numpy(), off(*args, generator=gen)[1].numpy())


# ---------------------------------------------------------------------------
# preprocess and train
# ---------------------------------------------------------------------------

def test_preprocess_vc_dataset_matches_jax(tmp_path):
    """Four 0.5-1 s tones (one too short to keep) through both packages'
    ``preprocess_vc_dataset`` with the same small extractor and the
    committed GE2E export: the same fid lists (split by the id's last
    digit), f0 exactly equal, PPGs within atol 1e-4, d-vectors within 1e-4,
    mels within the JAX test's 2e-4."""
    from scipy.io import wavfile
    rng = np.random.RandomState(2)
    wav_dir = tmp_path / "wavs"
    (wav_dir / "sub").mkdir(parents=True)
    for fid, n in (("a_0001", 12000), ("a_0006", 9000), ("sub/b_0008", 16000),
                   ("b_0003", 1000)):
        wavfile.write(wav_dir / f"{fid}.wav", 16000, (tone(n, rng) * 32767).astype(np.int16))
    jx = jext.PPGExtractor(cfg=jppg_cfg(), verbose=False)
    variables = randomise(to_numpy(jx.variables), np.random.RandomState(5))
    jx.variables = jtree(variables)
    tx = text.PPGExtractor(cfg=tppg_cfg(), variables=variables, verbose=False, device="cpu")
    jenc = JEncoder.from_checkpoint(ENCODER_CKPT)
    tenc = TEncoder(to_numpy(jenc.params), device="cpu")
    jconvert.preprocess_vc_dataset(wav_dir, tmp_path / "jax", jx, jenc)
    tconvert.preprocess_vc_dataset(wav_dir, tmp_path / "port", tx, tenc, device="cpu")
    for split, fids in (("train", "a_0001"), ("dev", "a_0006"), ("eval", "b_0008")):
        name = f"{split}_fidlist.txt"
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
        assert (tmp_path / "port" / name).read_text().split() == [fids]
    for fid in ("a_0001", "a_0006", "b_0008"):
        got = {s: np.load(tmp_path / "port" / s / f"{fid}.npy") for s in ("bnf", "f0", "embed",
                                                                           "mel")}
        want = {s: np.load(tmp_path / "jax" / s / f"{fid}.npy") for s in got}
        np.testing.assert_array_equal(got["f0"], want["f0"])
        for s, atol in (("bnf", 1e-4), ("embed", 1e-4), ("mel", 2e-4)):
            assert got[s].shape == want[s].shape and got[s].dtype == np.float32
            np.testing.assert_allclose(got[s], want[s], atol=atol, err_msg=s)


def test_train_with_dev_validation(tmp_path, capsys):
    """``train`` for 2 steps with a dev split, as the JAX test drives it:
    the dev loss printed, the best checkpoint and the attention PNG
    written, a checkpoint at the end (labelled one past the last step, as
    JAX's); a second call resumes from it and runs one more step."""
    vc = tmp_path / "vc"
    for sub in ("bnf", "f0", "embed", "mel"):
        (vc / sub).mkdir(parents=True)
    rng = np.random.RandomState(0)
    fids = [f"u{i}" for i in range(4)]
    for fid, (ppg, lf0, mel, emb) in zip(fids, vc_items(rng, (24, 30, 17, 24))):
        for sub, a in zip(("bnf", "f0", "mel", "embed"), (ppg, lf0, mel, emb)):
            np.save(vc / sub / f"{fid}.npy", a)
    (vc / "train_fidlist.txt").write_text("\n".join(fids[:2]))
    (vc / "dev_fidlist.txt").write_text("\n".join(fids[2:]))
    kw = dict(cfg=tp2m_cfg(**DROP), batch_size=2, save_every=0, log_every=1, val_every=2,
              device="cpu")
    ttrain.train("vc_run", vc, tmp_path, total_steps=2, **kw)
    ttrain.train("vc_run", vc, tmp_path, total_steps=3, **kw)
    out = capsys.readouterr().out
    assert "dev mel loss" in out and "Resumed ppg2mel at step 3" in out
    run = tmp_path / "vc_run"
    assert sorted(int(p.stem) for p in (run / "ckpt_ppg2mel").glob("*.pt")) == [3, 5]
    assert list((run / "ckpt_ppg2mel_best").glob("*.pt"))
    assert (run / "attn/attention_000002.png").stat().st_size > 0
    state = torch.load(run / "ckpt_ppg2mel/5.pt")
    assert state["sched"]["last_epoch"] == 3
