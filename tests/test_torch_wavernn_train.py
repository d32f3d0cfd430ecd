"""The port's WaveRNN training against the JAX package at small widths
(``test_torch_wavernn.SMALL``): the training forward (batch-statistics
BatchNorms moving their running statistics as flax's ``train=True``) in RAW
and MOL mode, two Adam steps of the trainer's step, plain and with
``remat`` (the chunked head), against the JAX step, the zero GRU bias
slots, the dataset and its aligned crops, and ``train`` end to end with
``gen_testset`` sampling each checkpoint's own weights. flax variables are
drawn from numpy at the shapes of ``jax.eval_shape``; the JAX side is
jitted. float32; tolerances stated per test."""
import importlib
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mockingbird_tpu.config import Config as JConfig
from mockingbird_tpu.models.tacotron import dataset as jtaco_data
from mockingbird_tpu.models.vocoder.wavernn import WaveRNN as JWaveRNN
from mockingbird_tpu.models.vocoder.wavernn import wavernn_config as jconfig
from mockingbird_tpu_torch.models.tacotron import dataset as ttaco_data
from mockingbird_tpu_torch.models.tacotron.train import to_device
from mockingbird_tpu_torch.models.vocoder.wavernn import WaveRNN, wavernn_config
from mockingbird_tpu_torch.ops.wavernn_sample import pack_wavernn_weights
from mockingbird_tpu_torch.train.checkpoint import CheckpointManager
from mockingbird_tpu_torch.weights import flatten_tree, load_flax, to_flax
from test_torch_wavernn import SMALL
from test_torch_wavernn_mol import random_variables

jtrain = importlib.import_module("mockingbird_tpu.models.vocoder.wavernn_train")
ttrain = importlib.import_module("mockingbird_tpu_torch.models.vocoder.wavernn_train")

B, FRAMES = 3, 8                # seq_len 64 = 4 frames of hop 16; + 2·pad each side
LR = 1e-4


def _cfgs(mode="RAW", **kw):
    extra = dict(SMALL, mode=mode, **kw)
    return JConfig(jconfig()).merge(extra).freeze(), wavernn_config().merge(extra)


def _batch(mode, seed=0, t_frames=FRAMES):
    """x (B, T) in [-1, 1], y labels (RAW) or samples (MOL), mels
    (B, frames + 2·pad, 80), T = 16·frames."""
    rng = np.random.RandomState(seed)
    t = t_frames * 16
    x = rng.uniform(-1, 1, (B, t)).astype(np.float32)
    y = (rng.randint(0, 512, (B, t)).astype(np.int32) if mode == "RAW"
         else rng.uniform(-0.9, 0.9, (B, t)).astype(np.float32))
    mels = (rng.randn(B, t_frames + 4, 80) * 0.5).astype(np.float32)
    return dict(x=x, y=y, mels=mels)


def _model(tcfg, variables):
    return load_flax(WaveRNN(tcfg), variables).train()


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_training_forward_matches_jax(mode):
    """``WaveRNN.forward`` in train mode against ``model.apply(train=True,
    mutable=["batch_stats"])``: the logits (B, T, 512 or 30) and the moved
    running statistics (flax's momentum 0.9, biased variance) within 1e-5
    (measured ~1e-6); with ``remat`` the same to the last bit."""
    jcfg, tcfg = _cfgs(mode)
    var = random_variables(jcfg, seed=2)
    batch = _batch(mode)
    jmod = JWaveRNN(jcfg)
    logits, mut = jax.jit(lambda v, x, m: jmod.apply(v, x, m, True, mutable=["batch_stats"]))(
        var, batch["x"], batch["mels"])
    for remat in (False, True):
        _, tcfg = _cfgs(mode, remat=remat)
        model = _model(tcfg, var)
        got = model(torch.from_numpy(batch["x"]), torch.from_numpy(batch["mels"]))
        assert got.shape == logits.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits), atol=1e-5)
        want = flatten_tree(jax.tree.map(np.asarray, mut["batch_stats"]))
        have = flatten_tree(to_flax(model)["batch_stats"])
        assert set(want) == set(have)
        for k in want:
            np.testing.assert_allclose(have[k], want[k], atol=1e-5, err_msg=k)
        if not remat:
            plain = got.detach()
        else:
            assert torch.equal(got.detach(), plain)


# RAW runs in float32; MOL in float64: its likelihood takes the difference
# of two sigmoids 2/65535 apart, so its float32 gradients sit ~8e-4 (of the
# largest) from float64 in both packages, and Adam's first update (≈ lr·sign
# g) then moves small-gradient elements ±lr on either side as rounding
# decides. flax's GRU carry is made in the cells' float32 ``param_dtype``;
# the float64 run makes it in float64.
STEP_DTYPES = {"RAW": (np.float32, torch.float32), "MOL": (np.float64, torch.float64)}


def _f64_carry(self, rng, input_shape):
    return jnp.zeros(tuple(input_shape[:-1]) + (self.features,), jnp.float64)


@pytest.fixture(scope="module")
def jax_steps():
    """Two steps of the JAX trainer's ``make_wavernn_step`` with
    ``optax.adam``, plain and with ``remat`` (head chunks of 48 over 128
    steps: the tail padded and masked), from the same variables; MOL also
    its float32 losses."""
    out = {}
    for mode in ("RAW", "MOL", "MOL-f32"):
        ndt = np.float32 if mode == "MOL-f32" else STEP_DTYPES[mode][0]
        mode = mode.split("-")[0]
        with jax.enable_x64(ndt == np.float64), pytest.MonkeyPatch.context() as mp:
            if ndt == np.float64:
                mp.setattr(fnn.GRUCell, "initialize_carry", _f64_carry)
            batch = {k: v.astype(ndt) if v.dtype == np.float32 else v
                     for k, v in _batch(mode, seed=1).items()}
            jb = jax.tree.map(jnp.asarray, batch)
            var = jax.tree.map(lambda a: np.asarray(a, ndt),
                               random_variables(_cfgs(mode)[0], seed=3))
            for remat in (False, True):
                jcfg, _ = _cfgs(mode, remat=remat)
                tx = optax.adam(LR)
                step = jtrain.make_wavernn_step(JWaveRNN(jcfg), tx, mode, "fp32", remat=remat,
                                                head_chunk=48)
                p = jax.tree.map(jnp.asarray, var["params"])
                s = jax.tree.map(jnp.asarray, var["batch_stats"])
                opt, losses = tx.init(p), []
                for _ in range(2):
                    p, s, opt, loss = step(p, s, opt, jb)
                    losses.append(float(loss))
                out[mode, ndt, remat] = (var, batch, losses, jax.tree.map(
                    np.asarray, {"params": p, "batch_stats": s}))
    return out


def _port_steps(var, batch, mode, remat, dtype):
    _, tcfg = _cfgs(mode, remat=remat)
    model = _model(tcfg, var).to(dtype)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = ttrain.make_wavernn_step(model, opt, mode, "fp32", remat=remat, head_chunk=48)
    tb = {k: v.to(dtype) if v.is_floating_point() else v
          for k, v in to_device(batch, "cpu").items()}
    return model, [float(step(tb)) for _ in range(2)]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_two_steps_match_jax(jax_steps, mode, remat):
    """Two Adam steps of ``make_wavernn_step`` against JAX's (RAW in
    float32, MOL in float64, see ``STEP_DTYPES``): the losses within 1e-5
    relative, the parameters and running statistics after them within 1e-5
    (measured ~1e-7 and ~1e-6); the remat losses equal to the plain ones
    within 1e-6; the GRUs' hidden r/z bias slots still exactly 0 and no
    parameter. MOL in float32 as well: the losses within 1e-5 relative, and
    the parameters and statistics within 1e-5 on all but 0.2% of the
    elements (measured 22 and 23 of 27072, 0.08%, plain and remat), every
    element within 4·lr + 1e-5 (Adam moves one by at most ~lr a step; the
    22 differ by 2·lr, a sign that float32 rounding decided). A threshold
    on the first step's gradient does not pick them out: with every element
    whose gradient is under 1e-6 left out (0.35%) the largest difference is
    still 2·lr."""
    ndt, tdt = STEP_DTYPES[mode]
    var, batch, want, want_tree = jax_steps[mode, ndt, remat]
    model, got = _port_steps(var, batch, mode, remat, tdt)
    for g, w in zip(got, want):
        assert abs(g / w - 1) <= 1e-5, (got, want)
    have = flatten_tree(to_flax(model))
    for k, w in flatten_tree(want_tree).items():
        np.testing.assert_allclose(have[k], w, atol=1e-5, err_msg=k)
    plain = jax_steps[mode, ndt, False][2]
    assert max(abs(a / b - 1) for a, b in zip(got, plain)) <= 1e-6
    for cell in (model.rnn1.cell, model.rnn2.cell):
        assert torch.equal(cell.bias_hh_rz, torch.zeros_like(cell.bias_hh_rz))
    assert not any("bias_hh_rz" in n for n, _ in model.named_parameters())
    if mode == "MOL":
        var, batch, want, want_tree = jax_steps[mode, np.float32, remat]
        model, got = _port_steps(var, batch, mode, remat, torch.float32)
        for g, w in zip(got, want):
            assert abs(g / w - 1) <= 1e-5, (got, want)
        have = flatten_tree(to_flax(model))
        diff = np.concatenate([np.abs(have[k] - w).ravel()
                               for k, w in flatten_tree(want_tree).items()])
        assert (diff > 1e-5).mean() <= 2e-3 and diff.max() <= 4 * LR + 1e-5


def _capture_grads():
    """An optax transformation that leaves the parameters where they are
    and keeps the gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g))


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    return float(np.sqrt(num / sum(float((w ** 2).sum()) for w in want.values())))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_bf16_step_matches_jax(mode, remat):
    """The trainer's default precision against JAX's bf16 ``step_fn``
    (the model, its parameters and ``batch_stats`` and its inputs in bf16,
    float32 master weights; the remat head chunks take their inputs
    uncast), from the same state and batch: the loss within 3e-3 relative
    (measured 7.5e-8 RAW, 4e-6 MOL), the gradients within 2.5e-2 relative
    L2 (measured 8.5e-3 RAW, 8.8e-3 to 9.3e-3 MOL; JAX's own bf16 and f32
    gradients are 7.9e-2 and 3.4e-2 apart) and the moved running statistics
    within 1e-2 relative L2 (measured 2e-8). JAX's step is compiled with XLA's excess
    precision off, so that every bf16 result is rounded to bf16 as the
    program states it and as the card's bf16 kernels store it; XLA's CPU
    compiler otherwise keeps some bf16 products in float32 into the next
    op (a conv's output into the BatchNorm after it), which moves the
    gradients by 5e-2 from the same program's."""
    jcfg, tcfg = _cfgs(mode, remat=remat)
    var = random_variables(_cfgs(mode)[0], seed=3)
    batch = _batch(mode, seed=1)
    tx = _capture_grads()
    step = jtrain.make_wavernn_step(JWaveRNN(jcfg), tx, mode, "bf16", remat=remat,
                                    head_chunk=48)
    p = jax.tree.map(jnp.asarray, var["params"])
    args = (p, jax.tree.map(jnp.asarray, var["batch_stats"]), tx.init(p),
            jax.tree.map(jnp.asarray, batch))
    compiled = step.lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})
    _, stats, grads, loss = compiled(*args)
    model = _model(tcfg, var)
    port = ttrain.make_wavernn_step(model, torch.optim.SGD(model.parameters(), lr=0.0), mode,
                                    "bf16", remat=remat, head_chunk=48)
    got = float(port(to_device(batch, "cpu")))
    assert abs(got / float(loss) - 1) <= 3e-3, (got, float(loss))
    ref = WaveRNN(tcfg)
    with torch.no_grad():
        for (_, a), (_, b) in zip(model.named_parameters(), ref.named_parameters()):
            b.copy_(a.grad)
    assert _rel_l2(flatten_tree(to_flax(ref)["params"]),
                   flatten_tree(jax.tree.map(np.asarray, grads))) <= 2.5e-2
    assert _rel_l2(flatten_tree(to_flax(model)["batch_stats"]),
                   flatten_tree(jax.tree.map(np.asarray, stats))) <= 1e-2


def test_bf16_step_runs_through_the_policy():
    """The trainer's default precision: the bf16 step (plain and remat) runs
    the model in bf16 with float32 master weights and optimizer state,
    gives a finite loss within 2e-2 of the f32 step's from the same state,
    and its remat loss equals the plain one within 1e-3."""
    jcfg, tcfg = _cfgs("RAW")
    var = random_variables(jcfg, seed=3)
    tb = to_device(_batch("RAW", seed=1), "cpu")
    losses = {}
    for precision in ("fp32", "bf16"):
        for remat in (False, True):
            model = _model(wavernn_config().merge(dict(SMALL, remat=remat)), var)
            opt = torch.optim.Adam(model.parameters(), lr=LR)
            step = ttrain.make_wavernn_step(model, opt, "RAW", precision, remat=remat,
                                            head_chunk=48)
            losses[precision, remat] = float(step(tb))
            assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(np.isfinite(v) for v in losses.values())
    assert abs(losses["bf16", False] / losses["fp32", False] - 1) <= 2e-2
    assert abs(losses["bf16", True] / losses["bf16", False] - 1) <= 1e-3


@pytest.fixture(scope="module")
def syn_dir(tmp_path_factory):
    """``train.txt`` (one row unused), ``audio/`` and ``mels_gta/`` ((80, T)
    bin-major, ±4) for 9 utterances of 12 to 30 frames of hop 16."""
    root = tmp_path_factory.mktemp("wavernn_syn")
    (root / "audio").mkdir()
    (root / "mels_gta").mkdir()
    rng = np.random.RandomState(0)
    rows = []
    for i in range(9):
        frames = int(rng.randint(12, 31))
        n = frames * 16 - int(rng.randint(0, 16))
        t = np.arange(n) / 16000
        wav = 0.5 * np.sin(2 * np.pi * rng.uniform(100, 400) * t) + 0.05 * rng.randn(n)
        np.save(root / "audio" / f"audio-{i:03d}.npy", wav.astype(np.float32))
        np.save(root / "mels_gta" / f"mel-{i:03d}.npy",
                np.clip(rng.randn(80, frames) * 2, -4, 4).astype(np.float32))
        rows.append(f"audio-{i:03d}.npy|mel-{i:03d}.npy|embed-{i:03d}.npy|{n}|"
                    f"{0 if i == 4 else frames}|text")
    (root / "train.txt").write_text("\n".join(rows) + "\n")
    return root


@pytest.mark.parametrize("mode", ["RAW", "MOL"])
def test_dataset_and_batches_match_jax(syn_dir, mode):
    """``WaveRnnDataset`` (pre-emphasis, clip, mu-law or 16-bit labels; the
    unused row skipped) and ``collate_wavernn``'s aligned crops from the
    same seeded ``random.Random``, through the ``DataLoader`` over two
    passes: labels exactly equal, ``x`` and mels within 1e-6."""
    jcfg, tcfg = _cfgs(mode)
    args = (syn_dir / "train.txt", syn_dir / "mels_gta", syn_dir / "audio")
    jds, tds = jtrain.WaveRnnDataset(*args, jcfg), ttrain.WaveRnnDataset(*args, tcfg)
    assert len(jds) == len(tds) == 8
    for i in range(len(jds)):
        (jm, jq), (tm, tq) = jds[i], tds[i]
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_allclose(tm, jm, atol=1e-6)
    import random
    jr, tr = random.Random(5), random.Random(5)
    jl = jtaco_data.DataLoader(jds, 3, lambda b: jtrain.collate_wavernn(b, jcfg, jr), seed=5)
    tl = ttaco_data.DataLoader(tds, 3, lambda b: ttrain.collate_wavernn(b, tcfg, tr), seed=5)
    for _ in range(2):
        for jb, tb in zip(jl, tl, strict=True):
            assert tb["mels"].shape == (3, 64 // 16 + 4, 80)
            for k in ("x", "mels"):
                np.testing.assert_allclose(tb[k], jb[k], atol=1e-6, err_msg=k)
            if mode == "RAW":
                np.testing.assert_array_equal(tb["y"], jb["y"])
            else:
                np.testing.assert_allclose(tb["y"], jb["y"], atol=1e-6)


def test_train_samples_each_checkpoint(syn_dir, tmp_path, monkeypatch):
    """``train`` at the small width in bf16: 4 steps of batch 3 with a
    checkpoint every 2, each followed by ``gen_testset`` of 2 utterances
    (target and generated wavs written, the generated ones through the
    fused sampler's plain version here); the vocoder of the second
    checkpoint samples with that checkpoint's weights (its packed weights
    are those of the trained model, not the first checkpoint's), and the
    final checkpoint holds the model; a resume continues at step 6."""
    vocoders = []
    gen_testset = ttrain.gen_testset

    def recording(*args, **kw):
        voc = gen_testset(*args, **kw)
        vocoders.append((voc, pack_wavernn_weights(voc.model), dict(voc.packed)))
        return voc

    monkeypatch.setattr(ttrain, "gen_testset", recording)
    cfg = dict(SMALL, batch_size=3, gen_target_tpu=200, gen_overlap_tpu=20)
    model = ttrain.train("run", syn_dir, tmp_path, total_steps=4, save_every=2, log_every=1,
                         cfg=cfg, device="cpu")
    run = tmp_path / "run"
    assert CheckpointManager(run / "ckpt_wavernn").steps() == [2, 4, 5]
    names = sorted(p.name for p in (run / "samples_wavernn").iterdir())
    assert names == sorted(f"{s}_steps_{i}_{kind}.wav" for s in (2, 4) for i in range(2)
                           for kind in ("target", "gen_batched_target8000_overlap400"))
    assert len(vocoders) == 2 and vocoders[0][0] is vocoders[1][0]
    fresh = pack_wavernn_weights(model)
    for name, w in vocoders[1][2].items():
        assert torch.equal(w, fresh[name]), name
        assert torch.equal(w, vocoders[1][1][name]), name
    assert not all(torch.equal(w, vocoders[0][2][k]) for k, w in vocoders[1][2].items())
    recs = [json.loads(line) for line in (run / "logs_wavernn/scalars.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(np.isfinite(r["train/loss"]) for r in recs)
    step, state = CheckpointManager(run / "ckpt_wavernn").restore_latest()
    for k, v in model.state_dict().items():
        assert torch.equal(state["model"][k], v), k
    ttrain.train("run", syn_dir, tmp_path, total_steps=6, save_every=0, log_every=1, cfg=cfg,
                 device="cpu")
    recs = [json.loads(line) for line in (run / "logs_wavernn/scalars.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in recs][4:] == [6]
