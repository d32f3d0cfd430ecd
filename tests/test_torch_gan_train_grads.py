"""The GAN trainer's step (``make_gan_step``) against the JAX step: one
step's losses and gradients in float32 and bf16.

These two tests and their fixture are ``tests/test_torch_gan_train.py``'s,
moved unchanged into a file of their own so that the test runner's workers
can run them beside the rest of that file (its slowest file set the whole
run's wall time); the setup helpers stay there and are imported.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mockingbird_tpu.models.vocoder import gan_losses as jlosses
from mockingbird_tpu.train.precision import Policy as JPolicy
from mockingbird_tpu_torch.weights import flatten_tree, to_flax
from test_torch_gan_train import _port, _step_setup, _to_torch, jtrain, ttrain


def _port_grads(module):
    """The gradients a step left in ``module``, as its flax tree."""
    ref = type(module)(module.cfg) if hasattr(module, "cfg") else type(module)()
    with torch.no_grad():
        for (_, p), (_, q) in zip(module.named_parameters(), ref.named_parameters()):
            q.copy_(p.grad)
    return flatten_tree(to_flax(ref)["params"])


def _jax_losses_and_grads(jc, gen, disc, gp, dvar, batch, precision):
    """The JAX step's losses and gradients before any update, as
    ``make_gan_step`` computes them under ``precision``'s policy: the
    discriminators' on (y, ŷ) with ``train=True``, the generator's through
    the discriminators at the statistics that pass stored; and the
    generator's gradient of its loss without the mel term."""
    pol = JPolicy.from_name(precision)
    mels, y = jnp.asarray(batch["mels"]), jnp.asarray(batch["wavs"])

    def gen_apply(p):
        return pol.uncast(gen.apply({"params": pol.cast(p)}, pol.cast(mels)))

    def disc_apply(dp, stats, a, b, train):
        out = disc.apply({"params": pol.cast(dp), "batch_stats": pol.cast(stats)},
                         pol.cast(a), pol.cast(b), train,
                         mutable=["batch_stats"] if train else False)
        return pol.uncast(out)

    @jax.jit
    def run(gp, dp, stats):
        y_hat = gen_apply(gp)

        def d_loss_fn(dp):
            (mpd, msd), mut = disc_apply(dp, stats, y, jax.lax.stop_gradient(y_hat), True)
            loss = (jlosses.discriminator_loss(mpd[0], mpd[1])[0]
                    + jlosses.discriminator_loss(msd[0], msd[1])[0])
            return loss, mut["batch_stats"]

        (d_loss, new_stats), d_grads = jax.value_and_grad(d_loss_fn, has_aux=True)(dp)

        def g_loss_fn(gp):
            y_hat = gen_apply(gp)
            mel = jnp.mean(jnp.abs(jtrain.mel_loss_fn(y, jc) - jtrain.mel_loss_fn(y_hat, jc))) * 45
            mpd, msd = disc_apply(dp, new_stats, y, y_hat, False)
            total = (mel + jlosses.feature_loss(mpd[2], mpd[3])
                     + jlosses.feature_loss(msd[2], msd[3])
                     + jlosses.generator_loss(mpd[1])[0] + jlosses.generator_loss(msd[1])[0])
            return total, mel

        (g_loss, mel), g_grads = jax.value_and_grad(g_loss_fn, has_aux=True)(gp)
        disc_grads = jax.grad(lambda gp: jnp.subtract(*g_loss_fn(gp)))(gp)
        return (g_loss, d_loss, mel), g_grads, d_grads, disc_grads

    losses, *grads = run(gp, dvar["params"], dvar["batch_stats"])
    return [[float(v) for v in losses]] + [flatten_tree(jax.tree.map(np.asarray, g))
                                           for g in grads]


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    return float(np.sqrt(num / sum(float((w ** 2).sum()) for w in want.values())))


@pytest.fixture(scope="module")
def one_step():
    """One step's losses and gradients, JAX's and the port's (the gradients
    its step leaves behind at a learning rate of 0), in f32 and in bf16:
    (losses, generator, discriminators, generator without the mel term).
    The port's last one from a step whose mel term weighs 0 (the STFT loss
    in its place, with ``lambda_aux`` 0)."""
    jc, gen, disc, gp, dvar, batch = _step_setup()
    out = {}
    for precision in ("fp32", "bf16"):
        want = _jax_losses_and_grads(jc, gen, disc, gp, dvar, batch, precision)
        tc, tg, td, og, od = _port("hifigan", gp, dvar, learning_rate=0.0)
        step = ttrain.make_gan_step(tg, td, og, od, tc, precision)
        got = [[float(v) for v in step(_to_torch(batch, torch.float32))],
               _port_grads(tg), _port_grads(td)]
        tc, tg, td, og, od = _port("hifigan", gp, dvar, learning_rate=0.0, use_stft_loss=True,
                                   lambda_aux=0.0)
        ttrain.make_gan_step(tg, td, og, od, tc, precision)(_to_torch(batch, torch.float32))
        out[precision] = want, got + [_port_grads(tg)]
    return out


def test_f32_losses_and_gradients_match_jax(one_step):
    """float32: the losses within 1e-5 relative, the gradients of the
    generator and of the discriminators within 1e-4 relative L2 (measured
    2.2e-5 and 9.1e-6: a leaky-ReLU input within rounding of 0 takes the
    other slope on one side)."""
    (want, g_want, d_want, _), (got, g_got, d_got, _) = one_step["fp32"]
    for g, w in zip(got, want):
        assert abs(g / w - 1) <= 1e-5, (got, want)
    assert _rel_l2(g_got, g_want) <= 1e-4
    assert _rel_l2(d_got, d_want) <= 1e-4


def test_bf16_losses_and_gradients_match_jax(one_step):
    """bf16, the trainer's default, against the JAX step under its bf16
    ``Policy`` (both with the spectral-norm ``u`` rounded to bf16): the
    losses within 3e-3 relative (measured 1.6e-3), the discriminators'
    gradients within 2.5e-2 relative L2 (measured 8.8e-3), and the
    generator's gradient through the discriminators (its loss without the
    mel term) within 2.5e-2 (measured 1.4e-2; JAX's own bf16 and f32 are
    2.8e-2 apart). The mel term's gradient is bf16 rounding noise at these
    random weights in both packages: the mel loss takes the log of the
    generated audio's mel power, so bins with little energy divide the
    rounding of the bf16 waveform by a small number (JAX's own bf16 and f32
    gradients of that term alone are 0.45 apart). With it, the generator's
    gradient is held to JAX's own rounding: within JAX's bf16-to-f32
    distance of JAX's bf16 gradient (measured 0.33 against 0.42), its norm
    within 10% of JAX's (measured 1.048 of it)."""
    (want, g_want, d_want, disc_want), (got, g_got, d_got, disc_got) = one_step["bf16"]
    for g, w in zip(got, want):
        assert abs(g / w - 1) <= 3e-3, (got, want)
    assert _rel_l2(d_got, d_want) <= 2.5e-2
    assert _rel_l2(disc_got, disc_want) <= 2.5e-2
    g_f32 = one_step["fp32"][0][1]
    assert _rel_l2(g_got, g_want) <= _rel_l2(g_want, g_f32)

    def norm(tree):
        return np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in tree.values()))
    assert abs(norm(g_got) / norm(g_want) - 1) <= 0.1
