"""The port's Tacotron training step against the JAX package at small widths
(``test_torch_tacotron.SMALL``, prenet dropout off): the teacher-forced
forward with zoneout on, JAX's masks handed to both sides; the losses; the
f32 gradients, the parameters and BatchNorm statistics after two Adam steps
(compared through ``weights.to_flax``); a finetuning step; and the bf16
step. The JAX side runs the JAX package's own functions (``Tacotron.apply``,
``tacotron_loss``, ``make_train_step``, optax) jitted, with parameters drawn
from numpy at the shapes of ``jax.eval_shape(init_tacotron)``.
Tolerances are stated per test."""
import copy
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mockingbird_tpu.models.tacotron.model import Tacotron as JTaco
from mockingbird_tpu.models.tacotron.model import init_tacotron
from mockingbird_tpu.models.tacotron.model import tacotron_config as jconfig
from mockingbird_tpu.train.precision import Policy as JPolicy
from mockingbird_tpu_torch.models.tacotron.model import Tacotron
from mockingbird_tpu_torch.models.tacotron.model import tacotron_config as tconfig
from mockingbird_tpu_torch.train.precision import Policy
from mockingbird_tpu_torch.weights import flatten_tree, load_flax, to_flax
from test_torch_tacotron import SMALL

# both packages' ``models.tacotron`` export a ``train`` function of that name
jtrain = importlib.import_module("mockingbird_tpu.models.tacotron.train")
ttrain = importlib.import_module("mockingbird_tpu_torch.models.tacotron.train")

B, T_TEXT, T_MEL, R = 3, 16, 20, 2
S = T_MEL // R
LR = 1e-3


def random_variables(cfg, seed=0):
    """flax variables at ``init_tacotron``'s shapes, drawn from numpy:
    kernels N(0, 1/fan_in), biases N(0, 0.1²), BatchNorm scales 1 ± 0.1,
    running means N(0, 0.2²) and variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: init_tacotron(jax.random.PRNGKey(0), cfg, T_TEXT, T_MEL)[1])
    rng = np.random.RandomState(seed)

    def fill(tree, name=""):
        if isinstance(tree, dict):
            return {k: fill(v, k) for k, v in tree.items()}
        sh = tree.shape
        draw = {"kernel": lambda: rng.randn(*sh) / np.sqrt(max(np.prod(sh[:-1]), 1)),
                "scale": lambda: 1 + 0.1 * rng.randn(*sh),
                "mean": lambda: 0.2 * rng.randn(*sh),
                "var": lambda: rng.uniform(0.5, 1.5, sh),
                "embedding": lambda: rng.randn(*sh),
                "embed": lambda: 0.5 * rng.randn(*sh)}.get(name, lambda: 0.1 * rng.randn(*sh))
        return draw().astype(np.float32)
    return fill(dict(shapes))


def make_batch(seed=0):
    rng = np.random.RandomState(seed)
    texts = np.zeros((B, T_TEXT), np.int32)
    for i, n in enumerate((16, 11, 7)):
        texts[i, :n] = rng.randint(1, 75, n)
    mels = np.clip(rng.randn(B, T_MEL, 20) * 2, -4, 4).astype(np.float32)
    spk = rng.randn(B, 8).astype(np.float32)
    spk /= np.linalg.norm(spk, axis=1, keepdims=True)
    mel_lens = np.array([20, 15, 9], np.int32)
    stop = (np.arange(T_MEL)[None] >= mel_lens[:, None] - 1).astype(np.float32)
    zo = rng.rand(S, 2, B, SMALL["lstm_dims"]) < 0.1
    return dict(texts=texts, mels=mels, embeds=spk, stop=stop,
                text_lengths=np.array([16, 11, 7], np.int32), mel_lengths=mel_lens), zo


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference of this file, computed once with
    ``jax.random.bernoulli`` returning the handed-in zoneout masks."""
    cfg = jconfig().merge(SMALL).merge(dict(scan_unroll=1)).freeze()
    model, var = JTaco(cfg), random_variables(cfg)
    batch, zo = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    bernoulli = jax.random.bernoulli

    def handed_in(key, p=0.5, shape=None):
        return jnp.asarray(zo) if tuple(shape) == zo.shape else bernoulli(key, p, shape)

    out = dict(var=var, batch=batch, zo=zo)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", handed_in)

        def loss_fn(params, stats, policy):
            o, mut = model.apply({"params": policy.cast(params), "batch_stats": policy.cast(stats)},
                                 jb["texts"], policy.cast(jb["mels"]), policy.cast(jb["embeds"]),
                                 R, True, rngs={"dropout": jax.random.PRNGKey(1),
                                                "zoneout": jax.random.PRNGKey(2)},
                                 mutable=["batch_stats"])
            o = policy.uncast(o)
            loss, parts = jtrain.tacotron_loss(o, jb)
            g_l = jtrain.guided_attention_loss(o[2], jb["text_lengths"], jb["mel_lengths"], R)
            return loss, (parts, o, policy.uncast(mut["batch_stats"]), g_l)

        for prec in ("fp32", "bf16"):
            vg = jax.jit(jax.value_and_grad(lambda p, s, pol=JPolicy.from_name(prec):
                                            loss_fn(p, s, pol), has_aux=True))
            (loss, (parts, o, stats, g_l)), grads = vg(var["params"], var["batch_stats"])
            out[prec] = dict(loss=loss, parts=parts, out=o, stats=stats, guided=g_l,
                             grads=grads)
            if prec == "fp32":
                vg32 = vg

        # two steps of the JAX trainer's own step function
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR, b1=0.9, b2=0.999))
        step_fn = jtrain.make_train_step(model, tx, R, "fp32")
        state = (var["params"], var["batch_stats"])
        opt_state = tx.init(var["params"])
        for k in (1, 2):
            state, opt_state, *_ = step_fn(state, opt_state, jb,
                                           jax.random.fold_in(jax.random.PRNGKey(0), k))
        out["two_steps"] = jax.tree.map(np.asarray, {"params": state[0],
                                                     "batch_stats": state[1]})

        # finetuning: the JAX trainer's optimizer chain with its mask, two
        # updates from the gradients of the (already compiled) f32 loss
        mask = jtrain.finetune_mask(var["params"], ("decoder", "postnet"))
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR, b1=0.9, b2=0.999),
                         optax.masked(optax.set_to_zero(), jax.tree.map(lambda t: not t, mask)))

        @jax.jit
        def update(grads, opt_state, params):
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, optax.global_norm(grads)

        params, stats, opt_state, norms = var["params"], var["batch_stats"], jax.jit(tx.init)(
            var["params"]), []
        for _ in range(2):
            (_, (_, _, stats, _)), grads = vg32(params, stats)
            params, opt_state, norm = update(grads, opt_state, params)
            norms.append(float(norm))
        out["finetune"] = dict(params=jax.tree.map(np.asarray, params), norms=norms)
    return out


def port_model(var):
    model = load_flax(Tacotron(tconfig().merge(SMALL)), copy.deepcopy(var))
    return model.train()


def port_batch(batch):
    return ttrain.to_device(batch, "cpu")


def grads_tree(model):
    """The model's gradients as a flax tree, through the inverse weight map."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(g.parameters(), model.parameters()):
            p.copy_(q.grad)
    return flatten_tree(to_flax(g)["params"])


def zero_gradient(leaf: str) -> bool:
    """The GST reference encoder's conv biases feed a BatchNorm in
    batch-statistics mode, which takes out every per-channel constant: their
    gradient is zero in exact arithmetic and rounding noise on both sides.
    That BatchNorm's running mean follows them (0.1 of each move)."""
    return re.fullmatch(r"gst/encoder/(conv_\d+/bias|bn_\d+/mean)", leaf) is not None


def assert_trees_close(got, want, atol, what, noise_atol=None):
    """Same leaves; max |diff| of every leaf within ``atol`` (the
    ``zero_gradient`` leaves within ``noise_atol`` when given)."""
    want = flatten_tree(jax.tree.map(np.asarray, want))
    assert set(got) == set(want), f"{what}: leaves differ: {set(got) ^ set(want)}"
    for k in want:
        bound = noise_atol if noise_atol is not None and zero_gradient(k) else atol
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= bound, f"{what}: {k} differs by {err:.3g} > {bound:.3g}"


def test_teacher_forced_forward_and_losses_match_jax(ref):
    """Zoneout on with JAX's masks, BatchNorm in batch-statistics mode:
    the four outputs within 1e-5, the loss, its parts and the guided
    attention loss within 1e-5 relative (measured: 6e-7 on the outputs)."""
    model = port_model(ref["var"])
    tb = port_batch(ref["batch"])
    with torch.no_grad():
        loss, parts, out = ttrain.loss_of(model, tb, R, Policy.from_name("fp32"),
                                          zo_masks=torch.from_numpy(ref["zo"]))
        g_l = ttrain.guided_attention_loss(out[2], tb["text_lengths"], tb["mel_lengths"], R)
    want = ref["fp32"]
    for name, got, r in zip(("mel", "postnet", "attention", "stop"), out, want["out"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), atol=1e-5, err_msg=name)
    assert float(loss) == pytest.approx(float(want["loss"]), rel=1e-5)
    for k, v in parts.items():
        assert float(v) == pytest.approx(float(want["parts"][k]), rel=1e-5), k
    assert float(g_l) == pytest.approx(float(want["guided"]), rel=1e-5)


def test_zoneout_masks_change_the_forward(ref):
    """The masks handed in are used: without zoneout (eval mode, running
    statistics) the decoder's mels differ from the training forward's."""
    model = port_model(ref["var"])
    tb = port_batch(ref["batch"])
    with torch.no_grad():
        train_out = model(tb["texts"], tb["mels"], tb["embeds"], R,
                          zo_masks=torch.from_numpy(ref["zo"]))[0]
        eval_out = model.eval()(tb["texts"], tb["mels"], tb["embeds"], R)[0]
    assert float((train_out - eval_out).abs().max()) > 1e-2


def test_f32_gradients_match_jax(ref):
    """Every parameter's gradient, mapped to the flax tree by the inverse
    weight map (the same leaves as JAX's), within 1e-5 of the largest JAX
    gradient (measured 1.3e-7 against 0.36); and the BatchNorm statistics
    the forward leaves behind within 1e-6."""
    model = port_model(ref["var"])
    loss, _, _ = ttrain.loss_of(model, port_batch(ref["batch"]), R, Policy.from_name("fp32"),
                                zo_masks=torch.from_numpy(ref["zo"]))
    loss.backward()
    want = ref["fp32"]["grads"]
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jax.tree.leaves(want))
    assert_trees_close(grads_tree(model), want, 1e-5 * scale, "gradients")
    assert_trees_close(flatten_tree(to_flax(model)["batch_stats"]), ref["fp32"]["stats"], 1e-6,
                       "batch_stats")


def test_two_adam_steps_match_jax(ref):
    """``make_train_step`` twice (global-norm clip, Adam 1e-3) against the
    JAX trainer's ``make_train_step``: parameters within 1e-5 (two Adam
    steps move a parameter by up to 2e-3) and BatchNorm statistics within
    1e-6, through the inverse weight map. Adam scales each gradient to a
    step of about the learning rate whatever its size, so the
    ``zero_gradient`` leaves, whose gradients are rounding noise on both
    sides, are held only within the two steps' reach, 2e-3 (measured
    6.1e-4), and the running means behind them within 0.1 of one step's,
    1e-4 (measured 1.8e-5)."""
    model = port_model(ref["var"])
    opt = ttrain.make_optimizer(model, LR)
    step = ttrain.make_train_step(model, opt, R, "fp32")
    tb = port_batch(ref["batch"])
    for _ in range(2):
        step(tb, None, torch.from_numpy(ref["zo"]))
    got = to_flax(model)
    assert_trees_close(flatten_tree(got["params"]), ref["two_steps"]["params"], 1e-5, "params",
                       noise_atol=2 * LR)
    assert_trees_close(flatten_tree(got["batch_stats"]), ref["two_steps"]["batch_stats"], 1e-6,
                       "batch_stats", noise_atol=0.1 * LR)


def test_finetune_step_matches_jax(ref):
    """``finetune_layers=("decoder", "postnet")``: two steps against optax's
    masked chain. The frozen layers stay exactly put; the trained ones match
    JAX's within 1e-5, which they do only if the clip's global norm counts
    the frozen layers' gradients too (the norms are above the clip's 1.0,
    and Adam's second step depends on the ratio of the two clips)."""
    assert min(ref["finetune"]["norms"]) > 1.0
    model = port_model(ref["var"])
    before = flatten_tree(to_flax(model)["params"])
    opt = ttrain.make_optimizer(model, LR)
    step = ttrain.make_train_step(model, opt, R, "fp32", finetune_layers=("decoder", "postnet"))
    tb = port_batch(ref["batch"])
    for _ in range(2):
        step(tb, None, torch.from_numpy(ref["zo"]))
    got = flatten_tree(to_flax(model)["params"])
    assert_trees_close(got, ref["finetune"]["params"], 1e-5, "finetuned params")
    for k, v in got.items():
        if k.split("/")[0] not in ("decoder", "postnet"):
            np.testing.assert_array_equal(v, before[k], err_msg=k)
        else:
            assert k.startswith(("decoder", "postnet"))


def test_bf16_loss_and_gradients_match_jax(ref):
    """The trainer's default precision against the JAX step's bf16 loss
    function (parameters, ``batch_stats``, mels and embeddings cast to bf16;
    flax promotion runs the decoder, the GRUs' hidden gates and the postnet
    in f32 from bf16-rounded weights). Loss within 2.9e-3 relative
    (measured 1.3e-5). Gradients by relative L2 norm over the whole model
    within 2.5e-2 (measured 1.8e-2): at these random weights the gradients
    are ill-conditioned, and the JAX step's own bf16 and f32 gradients are
    0.13 apart, so one bf16 rounding taken in another place (XLA keeps some
    fused elementwise chains in f32) moves them by about 1e-2. The
    BatchNorm statistics, read rounded to bf16 and written back in f32,
    within 1e-2 relative L2."""
    model = port_model(ref["var"])
    loss, _, _ = ttrain.loss_of(model, port_batch(ref["batch"]), R, Policy.from_name("bf16"),
                                zo_masks=torch.from_numpy(ref["zo"]))
    loss.backward()
    want = ref["bf16"]
    assert loss.item() == pytest.approx(float(want["loss"]), rel=2.9e-3)

    def rel_l2(got, want):
        want = flatten_tree(jax.tree.map(np.asarray, want))
        num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
        return np.sqrt(num / sum(float((w ** 2).sum()) for w in want.values()))
    assert rel_l2(grads_tree(model), want["grads"]) <= 2.5e-2
    assert rel_l2(flatten_tree(to_flax(model)["batch_stats"]), want["stats"]) <= 1e-2
