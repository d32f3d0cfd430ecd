"""The port's GE2E trainer against the JAX package on the CPU: the similarity
matrix, loss and EER (also against the numpy oracles of ``test_encoder``),
the sampler's batches, the f32 step (loss, gradients, the parameters after
two Adam steps) at a tiny width (4 speakers × 3 utterances × 20 frames,
hidden 32, embedding 16), remat, the bf16 step, the L2 norm's gradient at a
zero row, ``preprocess_speaker_dirs`` and ``train``. The JAX side runs the
JAX package's own functions on the CPU; weights are JAX's ``init_params``
carried across by ``weights.load_flax``. Tolerances are stated per test."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mockingbird_tpu.models.encoder import model as jmodel
from mockingbird_tpu.models.encoder.dataset import SpeakerBatchSampler as JSampler
from mockingbird_tpu.models.encoder.dataset import SpeakerVerificationDataset as JDataset
from mockingbird_tpu.train.precision import Policy as JPolicy
from mockingbird_tpu_torch.models.encoder import model as tmodel
from mockingbird_tpu_torch.models.encoder.dataset import SpeakerBatchSampler as TSampler
from mockingbird_tpu_torch.models.encoder.dataset import SpeakerVerificationDataset as TDataset
from mockingbird_tpu_torch.models.encoder.inference import SpeakerEncoderInference
from mockingbird_tpu_torch.train.precision import Policy
from mockingbird_tpu_torch.weights import flatten_tree, load_flax, to_flax
from test_encoder import _naive_similarity

# both packages' ``models.encoder`` export a ``train`` function of that name
jtrain = importlib.import_module("mockingbird_tpu.models.encoder.train")
ttrain = importlib.import_module("mockingbird_tpu_torch.models.encoder.train")
jprep = importlib.import_module("mockingbird_tpu.models.encoder.preprocess")
tprep = importlib.import_module("mockingbird_tpu_torch.models.encoder.preprocess")

S, U, T = 4, 3, 20
HIDDEN, EMBED = 32, 16


def unit_embeds(s, u, d, seed=0, clustered=False):
    rng = np.random.RandomState(seed)
    e = rng.randn(s, u, d)
    if clustered:
        e = rng.randn(s, 1, d) + 0.01 * e
    return (e / np.linalg.norm(e, axis=2, keepdims=True)).astype(np.float32)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# similarity, loss, EER
# ---------------------------------------------------------------------------

def test_similarity_matrix_matches_jax_and_oracle():
    """Within 1e-5 of the numpy loop (as the JAX test holds JAX) and of JAX."""
    e = unit_embeds(6, 4, 16)
    got = tmodel.similarity_matrix(torch.from_numpy(e), torch.tensor([10.0]),
                                   torch.tensor([-5.0])).numpy()
    np.testing.assert_allclose(got, _naive_similarity(e, 10.0, -5.0), rtol=1e-5, atol=1e-5)
    want = jmodel.similarity_matrix(jnp.asarray(e), jnp.asarray([10.0]), jnp.asarray([-5.0]))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("clustered", [True, False])
def test_loss_and_eer_match_jax(clustered):
    """Loss within 1e-6 relative of JAX's, the similarity matrix within
    1e-5, the EER equal; clustered speakers give an EER under 0.05 and
    random ones over 0.2, as the JAX test holds."""
    e = unit_embeds(8, 5, 64, seed=1, clustered=clustered)
    w, b = torch.tensor([10.0]), torch.tensor([-5.0])
    loss, sim = tmodel.ge2e_loss(torch.from_numpy(e), w, b)
    eer = tmodel.equal_error_rate(sim, 8, 5)
    jloss, jsim = jmodel.ge2e_loss(jnp.asarray(e), jnp.asarray([10.0]), jnp.asarray([-5.0]))
    assert isinstance(eer, torch.Tensor) and eer.ndim == 0
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), rtol=1e-5, atol=1e-5)
    assert float(eer) == float(jmodel.equal_error_rate(jsim, 8, 5))
    assert (float(eer) < 0.05) if clustered else (float(eer) > 0.2)


@pytest.mark.parametrize("ties", [False, True])
def test_eer_matches_numpy_oracle_and_jax(ties):
    """Exactly the numpy threshold sweep of ``test_encoder`` (a stable
    sort) and JAX's value, also when scores tie across positives and
    negatives (``argsort(stable=True)``, as ``jnp.argsort`` is stable)."""
    s, u = 4, 3
    rng = np.random.RandomState(1)
    sim = rng.randn(s * u, s).astype(np.float32)
    if ties:
        sim = np.round(sim * 2) / 2
    target = np.repeat(np.arange(s), u)
    labels = (np.arange(s)[None, :] == target[:, None]).flatten()
    order = np.argsort(-sim.flatten(), kind="stable")
    ls = labels[order]
    far = np.cumsum(~ls) / (~labels).sum()
    frr = 1 - np.cumsum(ls) / labels.sum()
    i = np.argmin(np.abs(far - frr))
    oracle = np.float32((far[i] + frr[i]) / 2)
    got = float(tmodel.equal_error_rate(torch.from_numpy(sim), s, u))
    assert got == pytest.approx(float(oracle), abs=1e-6)
    assert got == float(jmodel.equal_error_rate(jnp.asarray(sim), s, u))


def test_norm_gradient_at_a_zero_row_differs_by_design():
    """A row whose ReLU output is all zero. The gradient of the model's
    normalisation ``raw / (‖raw‖ + 1e-5)`` with respect to that row is NaN
    in JAX (``jnp.linalg.norm``) and 0 in the port (``torch.linalg.norm``).
    Neither reaches the parameters: the ReLU's gradient is a select in JAX,
    so both give finite, equal (zero) gradients for the layers below
    (ROADMAP, differences by design)."""
    raw = np.zeros((2, EMBED), np.float32)
    raw[1, :3] = (1.0, 2.0, 0.5)

    def jnorm(r):
        return jnp.sum((r / (jnp.linalg.norm(r, axis=1, keepdims=True) + 1e-5)) ** 2)
    jg = np.asarray(jax.grad(jnorm)(jnp.asarray(raw)))
    t = torch.from_numpy(raw).requires_grad_()
    ((t / (torch.linalg.norm(t, dim=1, keepdim=True) + 1e-5)) ** 2).sum().backward()
    assert np.isnan(jg[0]).all() and not t.grad[0].any()
    np.testing.assert_allclose(t.grad[1].numpy(), jg[1], rtol=1e-5, atol=1e-12)

    jenc = jmodel.SpeakerEncoder(HIDDEN, EMBED)
    params = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 8, 40)))["params"])
    params["linear"]["bias"] = np.full_like(params["linear"]["bias"], -100.0)
    x = np.random.RandomState(0).rand(2, 8, 40).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(jenc.apply({"params": p}, jnp.asarray(x)) ** 2))(
        jax.tree.map(jnp.asarray, params))
    model = load_flax(tmodel.SpeakerEncoder(HIDDEN, EMBED), params)
    out = model(torch.from_numpy(x))
    assert not out.any()
    (out ** 2).sum().backward()
    for leaf in jax.tree.leaves(jgrads):
        assert np.isfinite(np.asarray(leaf)).all() and not np.asarray(leaf).any()
    for p in model.parameters():
        assert torch.isfinite(p.grad).all() and not p.grad.any()


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def _frames_tree(root, n_speakers=5, n_utts=4, seed=0, manifest=False):
    rng = np.random.RandomState(seed)
    for spk in range(n_speakers):
        d = root / f"spk{spk}"
        d.mkdir(parents=True)
        base = rng.randn(1, 40) * 2
        names = []
        for utt in range(n_utts):
            name = f"utt{utt}.npy"
            n = rng.randint(T - 4, T + 30)              # some shorter than a partial
            np.save(d / name, (base + rng.randn(n, 40) * 0.3).astype(np.float32))
            names.append(name)
        if manifest:
            (d / "_sources.txt").write_text("".join(f"{n},src/{n}\n" for n in names[::-1]))


@pytest.mark.parametrize("manifest", [False, True])
def test_sampler_batches_equal_jax(tmp_path, manifest):
    """With one seed the port's sampler yields JAX's batches exactly."""
    _frames_tree(tmp_path, manifest=manifest)
    ours = TSampler(TDataset(tmp_path), S, U, T, seed=7)
    theirs = JSampler(JDataset(tmp_path), S, U, T, seed=7)
    for _ in range(5):
        a, b = ours.next_batch(), theirs.next_batch()
        assert a.shape == (S, U, T, 40)
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_case():
    """JAX's init_params at the tiny width, a batch, JAX's loss and raw
    gradients in f32 and bf16, and the parameters after two steps of the
    JAX trainer's own step."""
    jparams = jmodel.init_params(jax.random.PRNGKey(0), HIDDEN, EMBED)
    rng = np.random.RandomState(3)
    batch = np.abs(rng.randn(S, U, T, 40) * 0.3 + rng.randn(S, 1, 1, 40)).astype(np.float32)
    jenc = jmodel.SpeakerEncoder(HIDDEN, EMBED)

    def loss_fn(params, policy):
        frames = jnp.asarray(batch).reshape(S * U, T, 40)
        embeds = policy.uncast(jenc.apply({"params": policy.cast(params["model"])},
                                          policy.cast(frames))).reshape(S, U, -1)
        return jmodel.ge2e_loss(embeds, params["similarity"]["weight"],
                                params["similarity"]["bias"])[0]

    out = {"params": jax.tree.map(np.asarray, jparams), "batch": batch}
    for prec in ("fp32", "bf16"):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, pol=JPolicy.from_name(prec): loss_fn(p, pol)))(jparams)
        out[prec] = (float(loss), jax.tree.map(np.asarray, grads))
    tx = optax.chain(optax.clip_by_global_norm(3.0), optax.adam(1e-4))
    step = jtrain.make_train_step(jenc, tx, S, U, "fp32")
    params, opt_state = jax.tree.map(jnp.array, jparams), tx.init(jparams)
    for _ in range(2):
        params, opt_state, loss, eer, embeds = step(params, opt_state, jnp.asarray(batch))
    out["two_steps"] = (jax.tree.map(np.asarray, params), float(loss), float(eer),
                        np.asarray(embeds))
    return out


def _port(jax_case, remat=False):
    params = tmodel.init_params(0, HIDDEN, EMBED, remat=remat)
    load_flax(params, jax_case["params"])
    return params


def _loss_and_grads(params, batch, precision):
    frames = torch.from_numpy(batch).reshape(S * U, T, 40)
    embeds = Policy.from_name(precision).apply(params["model"], frames).reshape(S, U, -1)
    sim = params["similarity"]
    loss, _ = tmodel.ge2e_loss(embeds, sim["weight"], sim["bias"])
    params.zero_grad(set_to_none=True)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in params.named_parameters()}
    for n, p in params.named_parameters():
        p.grad = grads[n]
    return loss.item(), flatten_tree(to_flax(_as_grads(params))["params"])


def _as_grads(params):
    """A copy of ``params`` holding their gradients, for ``to_flax``."""
    g = tmodel.init_params(0, HIDDEN, EMBED)
    with torch.no_grad():
        for (_, p), (_, q) in zip(params.named_parameters(), g.named_parameters()):
            q.copy_(p.grad)
    return g


def test_f32_loss_and_gradients_match_jax(jax_case):
    """Loss within 1e-5 relative; every gradient leaf within 1e-4 relative
    L2 of JAX's, but the similarity bias's, which is 0 in exact arithmetic
    (each row's softmax sums to 1): within 1e-6 of JAX's."""
    loss, grads = _loss_and_grads(_port(jax_case), jax_case["batch"], "fp32")
    jloss, jgrads = jax_case["fp32"]
    assert loss == pytest.approx(jloss, rel=1e-5)
    jflat = flatten_tree(jgrads)
    assert grads.keys() == jflat.keys()
    for k in grads:
        if k == "similarity/bias":
            np.testing.assert_allclose(grads[k], jflat[k], rtol=0, atol=1e-6)
        else:
            assert rel_l2(grads[k], jflat[k]) <= 1e-4, k


def test_two_steps_match_jax(jax_case):
    """Two steps of the port's ``make_train_step`` (similarity gradients
    ×0.01, clip at 3, Adam 1e-4) against two of JAX's: the last loss within
    1e-5 relative, the EER equal, the embeddings within 1e-5, and every
    parameter within 1e-6 + 1% of the learning rate (Adam's first steps
    move each element by about ±lr, so a sign that f32 rounding flips would
    show as 2e-4)."""
    params = _port(jax_case)
    opt = ttrain.make_optimizer(params)
    step = ttrain.make_train_step(params, opt, S, U, "fp32")
    for _ in range(2):
        loss, eer, embeds = step(torch.from_numpy(jax_case["batch"]))
    jparams, jloss, jeer, jembeds = jax_case["two_steps"]
    assert float(loss) == pytest.approx(jloss, rel=1e-5)
    assert float(eer) == jeer
    np.testing.assert_allclose(embeds.numpy(), jembeds, atol=1e-5)
    got, want = flatten_tree(to_flax(params)["params"]), flatten_tree(jparams)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6 + 0.01 * 1e-4,
                                   err_msg=k)


def test_remat_equals_plain(jax_case):
    """``SpeakerEncoder(remat=True)``: loss and gradients equal to the plain
    model's, in f32 and through the bf16 policy's cast weights."""
    for precision in ("fp32", "bf16"):
        plain = _loss_and_grads(_port(jax_case), jax_case["batch"], precision)
        remat = _loss_and_grads(_port(jax_case, remat=True), jax_case["batch"], precision)
        assert remat[0] == plain[0]
        for k in plain[1]:
            np.testing.assert_array_equal(remat[1][k], plain[1][k], err_msg=k)


def test_bf16_step_matches_jax(jax_case):
    """The bf16 policy's loss within 2e-3 relative of JAX's bf16 loss and
    the gradients within 5e-2 relative L2 over all leaves (both run the
    LSTMs in bf16; XLA and PyTorch round the recurrence at other places).
    The parameters stay f32."""
    params = _port(jax_case)
    loss, grads = _loss_and_grads(params, jax_case["batch"], "bf16")
    jloss, jgrads = jax_case["bf16"]
    jflat = flatten_tree(jgrads)
    assert loss == pytest.approx(jloss, rel=2e-3)
    keys = sorted(grads)
    assert rel_l2(np.concatenate([grads[k].ravel() for k in keys]),
                  np.concatenate([jflat[k].ravel() for k in keys])) <= 5e-2
    assert all(p.dtype == torch.float32 for p in params.parameters())


# ---------------------------------------------------------------------------
# preprocess and train
# ---------------------------------------------------------------------------

def _wav_tree(root, n_speakers=2, n_utts=2, seed=0):
    """Speaker directories of 2-2.6 s 16 kHz wavs: a per-speaker tone in
    bursts of 3 a second (so the energy VAD finds speech) over noise; one a
    directory down, one too short to keep."""
    from scipy.io import wavfile
    rng = np.random.RandomState(seed)
    for spk in range(n_speakers):
        f0 = 120 + 40 * spk
        for utt in range(n_utts + 1):
            d = root / f"s{spk}" / ("book" if utt == 1 else "")
            d.mkdir(parents=True, exist_ok=True)
            n = 4000 if utt == n_utts else int(16000 * rng.uniform(2.0, 2.6))
            t = np.arange(n) / 16000
            bursts = np.sin(2 * np.pi * 3 * t) > -0.3
            wav = 0.3 * bursts * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.randn(n)
            wavfile.write(d / f"u{utt}.wav", 16000, (wav * 32767).astype(np.int16))


def test_preprocess_speaker_dirs_matches_jax(tmp_path):
    """The port's ``.npy`` mels within 1e-4 relative L2 of JAX's (same
    host preprocessing, DFT-matmul mels on both sides), the same files and
    the same ``_sources.txt``; a second run with ``skip_existing`` adds
    nothing."""
    _wav_tree(tmp_path / "raw")
    speakers = sorted((tmp_path / "raw").iterdir())
    for prep, out in ((jprep, "jax"), (tprep, "port")):
        kw = {} if prep is jprep else {"device": "cpu"}
        prep.preprocess_speaker_dirs(speakers, "corpus", tmp_path, tmp_path / out,
                                     n_workers=2, **kw)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.npy"))
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.npy"))
    assert len(files) == 4          # the 0.25 s wavs are under one partial
    for f in files:
        a, b = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        assert a.shape == b.shape and a.shape[0] >= 160
        assert rel_l2(a, b) <= 1e-4, f
    for spk in speakers:
        name = f"corpus_{spk.name}/_sources.txt"
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    before = (tmp_path / "port/corpus_s0/_sources.txt").read_text()
    tprep.preprocess_speaker_dirs(speakers, "corpus", tmp_path, tmp_path / "port",
                                  skip_existing=True, n_workers=2, device="cpu")
    assert (tmp_path / "port/corpus_s0/_sources.txt").read_text() == before


def test_train_two_steps_checkpoint_projection_and_export(tmp_path, capsys):
    """``train`` for 2 steps at full width (160-frame partials, the short
    utterances zero-padded): a checkpoint per step, the projection PNG, an
    ``encoder.npz`` that ``SpeakerEncoderInference`` loads (its embeddings
    equal the trained model's); a second call resumes at step 3."""
    data = tmp_path / "clean"
    _frames_tree(data, n_utts=3)
    models = tmp_path / "models"
    kw = dict(save_every=1, speakers_per_batch=S, utterances_per_speaker=U, log_every=1,
              vis_every=2, precision="fp32", device="cpu")
    params = ttrain.train("enc", data, models, total_steps=2, **kw)
    ttrain.train("enc", data, models, total_steps=3, **kw)
    out = capsys.readouterr().out
    assert "step 2 | loss" in out and "Resumed encoder run enc at step 2" in out
    run = models / "enc"
    assert sorted(int(p.stem) for p in (run / "ckpt").glob("*.pt")) == [1, 2, 3]
    assert (run / "umap/umap_000002.png").stat().st_size > 0
    enc = SpeakerEncoderInference.from_checkpoint(run / "encoder.npz", device="cpu")
    x = np.random.RandomState(0).rand(2, T, 40).astype(np.float32)
    params3 = tmodel.init_params(0, remat=False)
    params3.load_state_dict(torch.load(run / "ckpt/3.pt")["params"])
    with torch.no_grad():
        want = params3["model"](torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(enc.embed_frames_batch(x), want)
    assert not np.array_equal(want, params["model"](torch.from_numpy(x)).detach().numpy())


def test_visualizations_project_like_jax_and_write_pngs(tmp_path):
    """``project_embeddings`` equals JAX's (both PCA by numpy's SVD where
    ``umap`` is absent); every plot writes its PNG."""
    from mockingbird_tpu.train.visualizations import project_embeddings as jproject
    from mockingbird_tpu_torch.train import visualizations as vis
    e = unit_embeds(4, 3, 16).reshape(12, 16)
    np.testing.assert_array_equal(vis.project_embeddings(e), jproject(e))
    assert vis.have_matplotlib()
    vis.draw_projections(e, 3, 5, tmp_path / "proj.png")
    vis.plot_alignment(np.random.RandomState(1).rand(20, 8), tmp_path / "attn.png")
    for name in ("proj", "attn"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0
