"""The port's VITS training against the JAX package at small widths: the GAN
losses, the generator and discriminator losses and gradients of one step
(``train=False`` with JAX's draws handed in: the JAX forward always has
dropout), AdamW against ``optax.adamw`` with the trainer's schedule, the
bucketed batches, the step reducing the mel loss, and ``train`` end to end
in bf16 with its checkpoint. float32 unless stated; tolerances stated per
test."""
import importlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mockingbird_tpu.dsp.stft import spec_to_mel_vits, spectrogram_vits
from mockingbird_tpu.models.vits import model as jmodel
from mockingbird_tpu.models.vits import modules as jm
from mockingbird_tpu.models.vocoder import gan_losses as jl
from mockingbird_tpu.train import precision as jprecision
from mockingbird_tpu_torch.models.vits import model as tmodel
from mockingbird_tpu_torch.models.vocoder import gan_losses as tlosses
from mockingbird_tpu_torch.train.checkpoint import CheckpointManager
from mockingbird_tpu_torch.train.precision import Policy
from mockingbird_tpu_torch.weights import load_flax
from test_torch_vits import SMALL, flax_params, jcfg, t, tcfg, train_draws

# both packages' ``models.vits`` export a ``train`` function of that name
jtrain = importlib.import_module("mockingbird_tpu.models.vits.train")
ttrain = importlib.import_module("mockingbird_tpu_torch.models.vits.train")


def rel_close(got, ref, rtol, atol=1e-6, what=""):
    ref = np.asarray(ref)
    err = float(np.abs(got.detach().numpy() - ref).max(initial=0.0))
    bound = rtol * float(np.abs(ref).max(initial=0.0)) + atol
    assert err <= bound, f"{what}: max |diff| {err:.3g} > {bound:.3g}"


def test_gan_losses():
    rng = np.random.RandomState(0)
    fr = [[rng.randn(2, 5, 3).astype(np.float32) for _ in range(3)] for _ in range(2)]
    fg = [[rng.randn(2, 5, 3).astype(np.float32) for _ in range(3)] for _ in range(2)]
    ds = [rng.randn(2, 7).astype(np.float32) for _ in range(3)]
    tt = lambda tree: [[t(a) for a in x] for x in tree]  # noqa: E731
    np.testing.assert_allclose(float(tlosses.feature_loss(tt(fr), tt(fg))),
                               float(jl.feature_loss(fr, fg)), rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.discriminator_loss([t(a) for a in ds],
                                                                [t(-a) for a in ds])[0]),
                               float(jl.discriminator_loss(ds, [-a for a in ds])[0]), rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.generator_loss([t(a) for a in ds])[0]),
                               float(jl.generator_loss(ds)[0]), rtol=1e-6)
    z = [rng.randn(2, 6, 4).astype(np.float32) for _ in range(4)]
    mask = (np.arange(6)[None, :, None] < np.array([6, 3])[:, None, None]).astype(np.float32)
    got = tlosses.kl_loss(*[t(a).bfloat16() for a in z], t(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(tlosses.kl_loss(*map(t, z), t(mask))),
                               float(jl.kl_loss(*z, mask)), rtol=1e-6)


def _wav_batch(seed=0):
    rng = np.random.RandomState(seed)
    tt = np.arange(40 * 16) / 16000
    wavs = np.stack([0.3 * np.sin(2 * np.pi * 220 * tt),
                     0.3 * np.sin(2 * np.pi * 330 * tt)]).astype(np.float32)
    wavs += 0.01 * rng.randn(*wavs.shape).astype(np.float32)
    specs = np.array(spectrogram_vits(jnp.asarray(wavs), 128, 16, 128), np.float32)
    return dict(texts=rng.randint(1, 60, (2, 12)).astype(np.int32),
                text_lengths=np.array([12, 10], np.int32), specs=specs,
                spec_lengths=np.array([40, 34], np.int32), wavs=wavs,
                sids=np.array([0, 1], np.int32), emos=rng.randn(2, 8).astype(np.float32))


def _step_against_jax(precision):
    """One step's generator loss (with its parts) and discriminator loss,
    and their gradients, from the port and from ``jax.value_and_grad`` of
    the JAX trainer's loss functions, both under ``precision``'s policy
    (parameters and floating inputs cast, outputs uncast). Returns the
    relative differences of the losses (of a part, against |part| + 0.1)
    and, per module, {parameter: (port gradient, JAX gradient)}."""
    cfg = jcfg().freeze()
    jmod, jdisc = jmodel.Vits(cfg), jtrain.VitsDiscriminator()
    jpol, tpol = jprecision.Policy.from_name(precision), Policy.from_name(precision)
    batch = _wav_batch()
    order = ("texts", "text_lengths", "specs", "spec_lengths", "sids", "emos")
    gp = flax_params(jmod, *(batch[k] for k in order), key=jax.random.PRNGKey(0),
                     train=False, seed=3, sd=0.05)
    seg = np.zeros((2, cfg.segment_size), np.float32)
    dp = flax_params(jdisc, seg, seg, seed=4, sd=0.05)
    key = jax.random.PRNGKey(7)
    seg_frames = cfg.segment_size // cfg.hop_size

    def mel(x):
        return spec_to_mel_vits(x, cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax)

    def disc_apply(dp, y_r, y_g, train):
        return jpol.uncast(jdisc.apply({"params": jpol.cast(dp)}, jpol.cast(y_r),
                                       jpol.cast(y_g), train))

    def g_loss_fn(gp, dp):
        out = jpol.uncast(jmod.apply({"params": jpol.cast(gp)}, batch["texts"],
                                     batch["text_lengths"], jpol.cast(batch["specs"]),
                                     batch["spec_lengths"], batch["sids"],
                                     jpol.cast(batch["emos"]), key=key, train=False))
        y_hat, l_length, attn, ids, x_mask, y_mask, (z, z_p, m_p, logs_p, m_q, logs_q) = out
        y_real = jm.slice_segments(batch["wavs"], ids * cfg.hop_size, cfg.segment_size)
        y_mel = jm.slice_segments(mel(batch["specs"]), ids, seg_frames)
        y_hat_mel = mel(spectrogram_vits(y_hat, cfg.n_fft, cfg.hop_size, cfg.win_size))
        parts = dict(mel=jnp.mean(jnp.abs(y_mel - y_hat_mel)) * 45.0, dur=jnp.sum(l_length),
                     kl=jl.kl_loss(z_p, logs_q, m_p, logs_p, y_mask))
        rs, gs, frs, fgs = disc_apply(dp, y_real, y_hat, False)
        parts["fm"] = jl.feature_loss(frs, fgs)
        parts["adv"] = jl.generator_loss(gs)[0]
        return sum(parts.values()), (parts, y_hat, y_real, attn)

    def d_loss_fn(dp, y, y_hat):
        rs, gs, _, _ = disc_apply(dp, y, y_hat, True)
        return jl.discriminator_loss(rs, gs)[0]

    (g_ref, (parts_ref, y_hat_ref, y_ref, attn_ref)), g_grads = jax.jit(
        jax.value_and_grad(g_loss_fn, has_aux=True))(gp, dp)
    d_ref, d_grads = jax.jit(jax.value_and_grad(d_loss_fn))(dp, y_ref, y_hat_ref)

    tcf = tcfg()
    tmod = load_flax(tmodel.Vits(tcf), gp)
    tdisc = load_flax(ttrain.VitsDiscriminator(), dp)
    tb = ttrain.to_device(batch, "cpu")
    eps, e_q, ids = train_draws(key, 2, 40, 12, batch["spec_lengths"], tcf)
    out = tpol.apply(tmod, *(tb[k] for k in order), train=False, eps=t(eps), e_q=t(e_q),
                     ids_slice=t(ids))
    np.testing.assert_array_equal(out[2].detach().numpy(), np.asarray(attn_ref))
    mel_full = ttrain.spec_to_mel_vits(tb["specs"], 16000, 128, 20, 0.0, None)
    g_loss, parts = ttrain.g_loss_of(tcf, out, tb, mel_full,
                                     lambda a, b: tpol.apply(tdisc, a, b))
    y = ttrain.slice_segments(tb["wavs"], out[3] * tcf.hop_size, tcf.segment_size)
    d_loss = ttrain.d_loss_of(tpol.apply(tdisc, y, out[0].detach()))
    errs = {"g_loss": abs(g_loss.item() / float(g_ref) - 1),
            "d_loss": abs(d_loss.item() / float(d_ref) - 1)}
    for k, v in parts.items():
        errs[k] = abs(v.item() - float(parts_ref[k])) / (abs(float(parts_ref[k])) + 1e-1)
    g_loss.backward(inputs=list(tmod.parameters()))
    d_loss.backward()

    grads = {}
    for module, jgrads in ((tmod, g_grads), (tdisc, d_grads)):
        ref = load_flax(type(module)(tcf) if module is tmod else type(module)(),
                        jax.tree.map(np.asarray, jgrads))
        ref_params = dict(ref.named_parameters())
        grads[type(module).__name__] = {name: (prm.grad.numpy(),
                                               ref_params[name].detach().numpy())
                                        for name, prm in module.named_parameters()}
    return errs, grads


def _rel_l2(pairs):
    """‖port − JAX‖ / ‖JAX‖ over a set of (port, JAX) gradient pairs."""
    num = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
    return float(np.sqrt(num / sum(float((b ** 2).sum()) for _, b in pairs)))


def test_losses_and_grads_match_jax():
    """float32: the losses agree to 1e-4 and each gradient tensor to 1e-3 of
    its largest JAX gradient (f32 sums through ~40 layers in other orders;
    measured up to 2.3e-4), plus 1e-8 of the module's largest gradient: the
    attention key biases have a gradient that is zero in exact arithmetic
    (softmax is shift-invariant), so both sides hold only rounding there."""
    errs, grads = _step_against_jax("fp32")
    assert max(errs.values()) <= 1e-4, errs
    for pairs in grads.values():
        scale = max(float(np.abs(b).max()) for _, b in pairs.values())
        for name, (got, ref) in pairs.items():
            rel_close(torch.from_numpy(got), ref, 1e-3, 1e-8 * scale, name)


def test_bf16_losses_and_grads_match_jax():
    """The trainer's default precision, bf16, against the JAX step under its
    bf16 ``Policy``: the layers before the first float32 mask, and the
    discriminators, run in bf16, the rest in float32, as flax's dtype
    promotion decides. The losses agree to 1e-2 (measured up to 2.9e-3; a
    port that kept bf16 past the masks was 8e-2 off). Gradients are held by
    relative L2 norm: the whole generator's, and those of the text and
    posterior encoders and the speaker table, at 2e-2 (measured up to
    1.0e-2, where the JAX step's own bf16 and float32 gradients are 3.6e-2
    to 3.9e-2 apart), and each discriminator's at 3e-2 (measured up to
    1.1e-2). The decoder, flow and duration predictor are held within the
    whole generator only: their gradients pass through the bf16
    discriminators' backward or are ill-conditioned at these random
    weights, and the JAX step's own bf16 and float32 gradients there are
    0.12 to 0.72 apart (measured against the port: 0.10 to 0.26)."""
    errs, grads = _step_against_jax("bf16")
    assert max(errs.values()) <= 1e-2, errs
    groups = {"Vits": (list(grads["Vits"].values()), 2e-2)}
    for module, pairs in grads.items():
        for name, pair in pairs.items():
            head = name.split(".")[0]
            if module == "VitsDiscriminator" or head in ("enc_p", "enc_q", "emb_g"):
                tol = 3e-2 if module == "VitsDiscriminator" else 2e-2
                groups.setdefault(f"{module}.{head}", ([], tol))[0].append(pair)
    errs = {k: (_rel_l2(v), tol) for k, (v, tol) in groups.items()}
    assert all(e <= tol for e, tol in errs.values()), errs


def test_adamw_matches_optax():
    """Three updates of ``make_optimizer`` + ``set_lr`` against
    ``optax.adamw(exponential_decay(2e-4, 1000, 0.999875), b1=0.8, b2=0.99,
    eps=1e-9)`` on the same gradients; the schedule is read at the count
    before each update, and optax's default weight decay is 1e-4."""
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    sched = optax.exponential_decay(2e-4, transition_steps=1000, decay_rate=0.999875)
    tx = optax.adamw(sched, b1=0.8, b2=0.99, eps=1e-9)
    jp, state = dict(p0), tx.init(p0)
    tp = {k: torch.nn.Parameter(t(v).clone()) for k, v in p0.items()}
    opt = ttrain.make_optimizer(list(tp.values()))
    for g in grads:
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in tp.items():
            v.grad = t(g[k]).clone()
        ttrain.set_lr(opt)
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-8)
    first = next(iter(opt.state.values()))
    for count in (0, 1000, 123456):
        first["step"] = torch.tensor(float(count))
        # optax evaluates the schedule in f32
        assert ttrain.set_lr(opt) == pytest.approx(float(sched(count)), rel=1e-5)


def _dataset(root, lengths, texts):
    (root / "audio").mkdir(parents=True)
    (root / "emo").mkdir()
    rng = np.random.RandomState(0)
    rows = []
    for i, (n, text) in enumerate(zip(lengths, texts)):
        name = f"audio-spk{i % 2}_{i:03d}.npy"
        np.save(root / "audio" / name, (0.2 * rng.randn(n)).astype(np.float32))
        rows.append(f"{name}|mel-{i}.npy|embed-{i}.npy|{n}|1|{text}")
    np.save(root / "emo" / "emo-spk0_000.npy", rng.randn(8).astype(np.float32))
    (root / "train.txt").write_text("\n".join(rows) + "\n", encoding="utf-8")
    return root


def test_bucket_batcher_matches_jax(tmp_path):
    """Same buckets, same order of batches, same collated arrays (specs
    computed by each package into its own copy of the dataset)."""
    lengths = [16 * 20, 16 * 25, 16 * 40, 16 * 33, 16 * 38, 16 * 31]
    texts = ["hello there", "a much longer sentence of text " * 2, "short", "ni3 hao3",
             "another one", "the last"]
    cfg = tcfg()
    tdir = _dataset(tmp_path / "t", lengths, texts)
    jdir = tmp_path / "j"
    shutil.copytree(tdir, jdir)
    tb = ttrain.BucketBatcher(ttrain.VitsDataset(tdir, cfg), 2, boundaries=(16, 32, 48), seed=3)
    jb = jtrain.BucketBatcher(jtrain.VitsDataset(jdir, jcfg()), 2, boundaries=(16, 32, 48),
                              seed=3)
    assert tb.bucket_bounds == jb.bucket_bounds and tb.bucket_t_text == jb.bucket_t_text
    assert len(tb) == len(jb) == 2
    for _ in range(2):                                  # two epochs: the shuffles stay in step
        for a, b in zip(tb, jb):
            assert a.keys() == b.keys()
            for k in a:
                if k == "specs":
                    np.testing.assert_allclose(a[k], b[k], atol=1e-4)
                else:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_step_reduces_loss():
    """The full step (dropout on, the port's own draws, fp32): six steps on
    one batch lower the mel loss, as the JAX package's test holds it."""
    cfg = tcfg()
    model = tmodel.init_vits(0, cfg)
    disc = ttrain.VitsDiscriminator()
    step = ttrain.make_vits_step(model, disc, ttrain.make_optimizer(model.parameters()),
                                 ttrain.make_optimizer(disc.parameters()), cfg)
    batch = ttrain.to_device(_wav_batch(), "cpu")
    gen = torch.Generator().manual_seed(0)
    mels = []
    for _ in range(6):
        g_loss, d_loss, parts = step(batch, gen)
        assert torch.isfinite(g_loss) and torch.isfinite(d_loss)
        mels.append(float(parts["mel"]))
    assert mels[-1] < mels[0], mels


def test_train_bf16_end_to_end(tmp_path):
    """``train`` on the CPU in its default precision (bf16: the parameters
    and inputs cast, master weights and optimizer state f32), with eval and
    logging on; the final checkpoint loads back through ``restore_latest``
    and a second call resumes from it."""
    lengths = [16 * 40, 16 * 36, 16 * 45, 16 * 38]
    texts = ["hello there", "one two three", "ni3 hao3", "the end"]
    data = _dataset(tmp_path / "data", lengths, texts)
    cfg = dict(SMALL, eval_max_len=40)
    model, disc = ttrain.train("run", data, tmp_path / "models", cfg=cfg, batch_size=2,
                               total_steps=2, save_every=0, log_every=1, eval_every=2,
                               seed=5, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    ckpt = CheckpointManager(tmp_path / "models/run/ckpt_vits")
    step, state = ckpt.restore_latest()
    assert step == 3 and set(state) == {"g", "d", "g_opt", "d_opt"}
    for k, v in model.state_dict().items():
        assert torch.equal(state["g"][k], v), k
    logs = tmp_path / "models/run/logs_vits"
    assert (logs / "scalars.jsonl").read_text().count("\n") == 2
    assert len(list(logs.glob("eval_gen_audio_*.wav"))) == 1
    ttrain.train("run", data, tmp_path / "models", cfg=cfg, batch_size=2, total_steps=4,
                 save_every=0, log_every=10, eval_every=0, seed=5, device="cpu")
    assert ckpt.steps() == [3, 5]


def test_policy_casts_and_uncasts():
    pol = Policy.from_name("bf16")
    lin = torch.nn.Linear(3, 2)
    out = pol.apply(lin, torch.randn(4, 3))
    assert out.dtype == torch.float32 and lin.weight.dtype == torch.float32
    out.sum().backward()
    assert lin.weight.grad.dtype == torch.float32
    assert Policy.from_name("fp32").apply(lin, torch.randn(1, 3)).dtype == torch.float32
    with pytest.raises(ValueError):
        Policy.from_name("fp8")
