"""flax's ``SpectralNorm`` semantics and two steps of the GAN trainer's
``make_gan_step`` against the JAX ``step_fn`` with ``optax.adamw`` and its
schedule (a small generator, the full discriminators), in float64 and
float32, and the bf16 transposed conv's gradient on the CPU.

These tests, their fixture and the SpectralNorm modules are
``tests/test_torch_gan_train.py``'s, moved unchanged into a file of their
own so that the test runner's workers can run them beside the rest of that
file (its slowest file set the whole run's wall time); the setup helpers
stay there and are imported.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mockingbird_tpu.train.precision import Policy as JPolicy
from mockingbird_tpu_torch.models import layers as tl
from mockingbird_tpu_torch.weights import flatten_tree, load_flax, to_flax
from test_torch_gan_train import (_max_diff, _port, _step_setup, _to_torch, _variables, jtrain,
                                  ttrain)


# ---------------------------------------------------------------------------
# SpectralNorm
# ---------------------------------------------------------------------------

class _JSNConv(fnn.Module):
    """flax ``SpectralNorm(Conv)`` called ``n_calls`` times in one apply."""
    n_calls: int = 1

    @fnn.compact
    def __call__(self, x, update_stats: bool):
        sn = fnn.SpectralNorm(fnn.Conv(6, (5,), strides=(2,), padding="SAME",
                                       feature_group_count=2, name="conv_conv"), name="conv")
        return [sn(x, update_stats=update_stats) for _ in range(self.n_calls)]


class _TSNConv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = tl.SpectralNorm(tl.Conv1d(4, 6, 5, stride=2, groups=2))


@pytest.mark.parametrize("n_calls", [1, 2])
@pytest.mark.parametrize("update", [False, True])
def test_spectral_norm_matches_flax(update, n_calls):
    """flax's ``SpectralNorm`` around a strided grouped conv, (2, 9, 4)
    input: the outputs of one or two chained calls, the stored ``u`` and
    ``sigma`` (moved only with ``update_stats``, the second call starting
    from the first one's) within 1e-6, and the kernel's gradient through
    ``sigma`` within 1e-6 of its largest element (measured ~4e-7)."""
    x = np.random.RandomState(1).randn(2, 9, 4).astype(np.float32)
    jmod = _JSNConv(n_calls)
    var = _variables(jmod, x, False)
    tmod = load_flax(_TSNConv(), var)

    def f(params):
        outs, mut = jmod.apply({"params": params, "batch_stats": var["batch_stats"]}, x,
                               update, mutable=["batch_stats"])
        return sum(jnp.sum(o * o) for o in outs), (outs, mut["batch_stats"])

    (_, (outs, stats)), grads = jax.value_and_grad(f, has_aux=True)(var["params"])
    got = [tmod.conv(torch.from_numpy(x), update) for _ in range(n_calls)]
    for g, want in zip(got, outs):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(want), atol=1e-6)
    assert _max_diff(stats, to_flax(tmod)["batch_stats"]) <= 1e-6
    if not update:
        assert _max_diff(var["batch_stats"], to_flax(tmod)["batch_stats"]) == 0.0
    sum(torch.sum(g * g) for g in got).backward()
    want = np.transpose(np.asarray(grads["conv_conv"]["kernel"]), (2, 1, 0))
    np.testing.assert_allclose(tmod.conv.layer.weight.grad.numpy(), want,
                               atol=1e-6 * float(np.abs(want).max()))


def test_spectral_norm_bf16_matches_flax():
    """bf16 parameters and ``u`` (the JAX step casts its ``batch_stats``):
    the output within 2e-2 of flax's largest (bf16 keeps 8 bits; measured
    ~4e-3), the stored ``u`` and ``sigma`` within 1e-2 (measured 0)."""
    x = np.random.RandomState(1).randn(2, 9, 4).astype(np.float32)
    jmod = _JSNConv(2)
    var = _variables(jmod, x, False)
    pol = JPolicy.from_name("bf16")
    outs, mut = jmod.apply(pol.cast(jax.tree.map(jnp.asarray, var)), pol.cast(jnp.asarray(x)),
                           True, mutable=["batch_stats"])
    tmod = load_flax(_TSNConv(), var)
    conv = tmod.conv
    with torch.no_grad():
        conv.layer.weight.data = conv.layer.weight.data.bfloat16()
        conv.layer.bias.data = conv.layer.bias.data.bfloat16()
        got = [conv(torch.from_numpy(x).bfloat16(), True) for _ in range(2)]
    for g, want in zip(got, outs):
        want = np.asarray(want, np.float32)
        assert float(np.abs(g.float().numpy() - want).max()) <= 2e-2 * float(np.abs(want).max())
    stats = jax.tree.map(lambda a: np.asarray(a, np.float32), pol.uncast(mut["batch_stats"]))
    assert _max_diff(stats, to_flax(tmod)["batch_stats"]) <= 1e-2


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_steps():
    """Two steps of the JAX trainer's ``step_fn`` (``optax.adamw`` with the
    trainer's schedule) from the same state with the discriminators on, and
    one step with them off, in float64; the two steps in float32 too."""
    out = {}
    for dtype, runs in ((np.float64, ((True, 2), (False, 1))), (np.float32, ((True, 2),))):
        with jax.enable_x64(dtype == np.float64):
            jc, gen, disc, gp, dvar, batch = _step_setup(dtype=dtype)
            tx = optax.adamw(jtrain._lr_schedule(jc), b1=jc.adam_b1, b2=jc.adam_b2)
            step_fn = jtrain.make_gan_step(gen, disc, tx, tx, jc, "fp32")
            jb = jax.tree.map(jnp.asarray, batch)
            for active, n in runs:
                g = jax.tree.map(jnp.asarray, gp)
                d = jax.tree.map(jnp.asarray, dvar)
                g_opt, d_opt = tx.init(g), tx.init(d["params"])
                losses = []
                for i in range(n):
                    g, d, g_opt, d_opt, *ls = step_fn(g, d, g_opt, d_opt, jb,
                                                      jnp.asarray(i + 1), active)
                    losses.append([float(v) for v in ls])
                out[dtype, active] = (gp, dvar, batch, losses, jax.tree.map(np.asarray, g),
                                      jax.tree.map(np.asarray, d))
    return out


def test_two_steps_match_jax(two_steps):
    """Two steps of ``make_gan_step`` against the JAX step's: the losses
    within 1e-5 relative, the generator's and the discriminators' parameters
    and the spectral-norm ``u``/``sigma`` within 1e-5, both optimizers'
    counts at 2. In float64 on both sides (measured ~1e-12): in float32 an
    element whose first-step gradient sits under Adam's eps (1e-8), or
    behind a leaky-ReLU input within rounding of 0 (the full discriminators
    hold millions), moves by ±lr on either side as rounding decides (a
    float32 run of this test: ~4e-4 on such elements, ~5e-7 elsewhere). The
    float32 steps and the float32 and bf16 gradients are held below."""
    gp, dvar, batch, losses, jg, jd = two_steps[np.float64, True]
    tc, tg, td, og, od = _port("hifigan", gp, dvar, torch.float64)
    step = ttrain.make_gan_step(tg, td, og, od, tc, "fp32")
    tb = _to_torch(batch)
    for want in losses:
        got = [float(v) for v in step(tb)]
        for g, w in zip(got, want):
            assert abs(g / w - 1) <= 1e-5, (got, want)
    assert _max_diff(jg, to_flax(tg)["params"]) <= 1e-5
    assert _max_diff(jd, to_flax(td)) <= 1e-5
    for opt, module in ((og, tg), (od, td)):
        assert all(float(opt.state[p]["step"]) == 2 for p in module.parameters())


def test_step_without_discriminators_matches_jax(two_steps):
    """Before ``disc_start_step`` (float64, as above): the generator's loss
    is the mel term alone, the discriminators and their optimizer do not
    move (no state, so the schedule's count stays 0), and the generator's
    step matches JAX's within 1e-5."""
    gp, dvar, batch, losses, jg, jd = two_steps[np.float64, False]
    tc, tg, td, og, od = _port("hifigan", gp, dvar, torch.float64)
    step = ttrain.make_gan_step(tg, td, og, od, tc, "fp32")
    g_loss, d_loss, mel = (float(v) for v in step(_to_torch(batch), False))
    assert d_loss == 0.0 and g_loss == mel
    assert abs(g_loss / losses[0][0] - 1) <= 1e-5 and abs(mel / losses[0][2] - 1) <= 1e-5
    assert _max_diff(jg, to_flax(tg)["params"]) <= 1e-5
    assert _max_diff(dvar, to_flax(td)) == 0.0 and not od.state


def test_two_f32_steps_match_jax(two_steps):
    """The two steps in float32, the trainer's own dtype: the losses within
    1e-5 relative; the generator's parameters within 1e-5 on every element
    (measured 1.1e-6); the discriminators' parameters within 1e-5 on all but
    1e-4 of their 70.7 M elements (measured 1185, 1.7e-5 of them, all in the
    period-5 discriminator), every element within 4·lr + 1e-5 (Adam moves
    one by at most ~lr a step; the 1185 differ by up to 2·lr); the
    spectral-norm ``u``/``sigma`` within 1e-5. The elements that differ have
    first-step gradients that agree between the packages (median
    |difference| 9e-11 against a median |gradient| of 1.5e-4) and are not
    small: their second-step gradients differ, as a leaky-ReLU input of the
    second step's forward that sits within float32 rounding of 0 takes the
    other slope on one side. A threshold on the first step's gradient
    leaves the largest difference at 2·lr, so none is applied."""
    gp, dvar, batch, losses, jg, jd = two_steps[np.float32, True]
    tc, tg, td, og, od = _port("hifigan", gp, dvar)
    step = ttrain.make_gan_step(tg, td, og, od, tc, "fp32")
    tb = _to_torch(batch, torch.float32)
    for want in losses:
        got = [float(v) for v in step(tb)]
        for g, w in zip(got, want):
            assert abs(g / w - 1) <= 1e-5, (got, want)
    assert _max_diff(jg, to_flax(tg)["params"]) <= 1e-5
    have, want = flatten_tree(to_flax(td)), flatten_tree(jax.tree.map(np.asarray, jd))
    assert set(have) == set(want)
    stats = [k for k in want if k.startswith("batch_stats/")]
    assert max(float(np.abs(have[k] - want[k]).max()) for k in stats) <= 1e-5
    diff = np.concatenate([np.abs(have[k] - want[k]).ravel() for k in want if k not in stats])
    assert (diff > 1e-5).mean() <= 1e-4 and diff.max() <= 4 * tc.learning_rate + 1e-5


def test_transposed_conv_bf16_gradient_on_cpu():
    """HiFi-GAN's first upsampling layer (32 → 16 channels, kernel 8, stride
    4) in bf16 on the CPU: its input gradient within 1e-2 relative L2 of the
    same bf16 values' float64 gradient (measured 1.7e-3). oneDNN's bf16
    convolution with stride 4, which computes that gradient when the layer
    calls the transposed conv in bf16, returns sums 1.15 (relative L2) away
    from it at this shape; the layer runs in float32 on the CPU and rounds
    once."""
    rng = np.random.RandomState(0)
    layer = tl.ConvTranspose1d(32, 16, 8, 4).to(torch.bfloat16)
    x = torch.from_numpy(rng.randn(2, 32, 32).astype(np.float32)).bfloat16().requires_grad_()
    y = layer(x)
    ct = torch.from_numpy(rng.randn(*y.shape).astype(np.float32)).bfloat16()
    y.backward(ct)
    w = layer.kernel().detach().to(torch.bfloat16).double()
    x64 = x.detach().double().requires_grad_()
    torch.nn.functional.conv_transpose1d(x64, w, None, 4).backward(ct.double())
    err = float((x.grad.double() - x64.grad).norm() / x64.grad.norm())
    assert err <= 1e-2, err
