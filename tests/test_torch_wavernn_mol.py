"""The rest of the port's WaveRNN against the JAX package at small widths
(``test_torch_wavernn.SMALL``): the mixture-of-logistics loss and sampler
(``distribution.py``) with JAX's draws handed in, the MOL head, the
step-by-step generator against JAX's ``_build_gen_fn`` with JAX's key chain
reproduced here, ``infer_waveform`` end to end in MOL mode and in RAW mode
with ``use_sampler=False`` (JAX's ``use_pallas=False``, its CPU path), and
``load``, the weight hot-swap that drops the sampler's packed weights.
float32; tolerances stated per test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mockingbird_tpu.config import Config as JConfig
from mockingbird_tpu.models.vocoder import distribution as jdist
from mockingbird_tpu.models.vocoder.wavernn import WaveRNN as JWaveRNN
from mockingbird_tpu.models.vocoder.wavernn import WaveRnnVocoder as JVocoder
from mockingbird_tpu.models.vocoder.wavernn import wavernn_config as jconfig
from mockingbird_tpu_torch.models.vocoder import WaveRnnVocoder
from mockingbird_tpu_torch.models.vocoder import distribution as tdist
from mockingbird_tpu_torch.ops.wavernn_sample import pack_wavernn_weights
from mockingbird_tpu_torch.weights import save_npz, to_flax
from test_torch_wavernn import SMALL

TARGET, OVERLAP = 40, 8


def t(a):
    return torch.from_numpy(np.array(a))


def random_variables(cfg, seed):
    """flax variables at the JAX WaveRNN's shapes, drawn from numpy
    (kernels N(0, 1/fan_in) — the box-initialised upsampling convs kept
    at 1/k — biases N(0, 0.1²), running statistics perturbed)."""
    model = JWaveRNN(cfg)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2 * cfg.hop_size)),
        jnp.zeros((1, 2 + 2 * cfg.pad, cfg.feat_dims))))
    rng = np.random.RandomState(seed)

    def fill(tree, path=()):
        if isinstance(tree, dict):
            return {k: fill(v, path + (k,)) for k, v in tree.items()}
        sh, name = tree.shape, path[-1]
        if name == "kernel" and path[-2].startswith("up_conv"):
            return np.full(sh, 1.0 / sh[0], np.float32)
        draw = {"kernel": lambda: rng.randn(*sh) / np.sqrt(max(np.prod(sh[:-1]), 1)),
                "scale": lambda: 1 + 0.1 * rng.randn(*sh),
                "mean": lambda: 0.2 * rng.randn(*sh),
                "var": lambda: rng.uniform(0.5, 1.5, sh)}.get(name, lambda: 0.1 * rng.randn(*sh))
        return draw().astype(np.float32)
    return fill(dict(shapes))


@pytest.fixture(scope="module", params=["MOL", "RAW"])
def vocoders(request):
    cfg = JConfig(jconfig()).merge(SMALL).merge(dict(mode=request.param))
    variables = random_variables(cfg.freeze(), seed=1)
    jvoc = JVocoder(cfg=cfg, verbose=False, variables=jax.tree.map(jnp.asarray, variables))
    tvoc = WaveRnnVocoder(cfg=dict(SMALL, mode=request.param), verbose=False,
                          variables=variables, device="cpu")
    return jvoc, tvoc, variables


def _mol_params(seed=0, shape=(3, 50)):
    rng = np.random.RandomState(seed)
    y_hat = rng.randn(*shape, 30).astype(np.float32)
    y_hat[..., 20:] = rng.uniform(-7, 3, shape + (10,))     # log scales, both branches
    y = np.clip(rng.uniform(-1.05, 1.05, shape + (1,)), -1, 1).astype(np.float32)
    return y_hat, y


@pytest.mark.parametrize("reduce", [True, False])
def test_mol_loss_matches_jax(reduce):
    """The inputs reach the three branches (both edges, and the narrow-bin
    log-density). Reduced: within 1e-5 relative. Per element: within 1e-5
    relative plus 6e-3 absolute, since the bin mass is a difference of two
    sigmoids, which cancels where both are near 1: PyTorch's and XLA's
    sigmoids differ by one f32 ulp (6e-8) in 0.4% of inputs, and over the
    smallest mass whose log is taken (1e-5) that moves the log by up to
    6e-3 (measured 4.5e-3 on 3 of 150 elements)."""
    y_hat, y = _mol_params()
    assert (y == 1).any() and (y == -1).any()
    ref = np.asarray(jdist.discretized_mix_logistic_loss(jnp.asarray(y_hat), jnp.asarray(y),
                                                         reduce=reduce))
    got = tdist.discretized_mix_logistic_loss(t(y_hat), t(y), reduce=reduce).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 if reduce else 6e-3)


def _jax_mol_draws(key, lead):
    """The draws ``sample_from_discretized_mix_logistic`` makes from ``key``."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.gumbel(k1, lead + (10,), jnp.float32)),
            np.asarray(jax.random.uniform(k2, lead, minval=1e-5, maxval=1.0 - 1e-5)))


def test_mol_sampler_matches_jax_with_its_draws():
    """JAX's draws handed in: equal to JAX's samples within 1e-6; from a
    seeded generator: in [-1, 1] and reproducible."""
    y_hat, _ = _mol_params(1)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jdist.sample_from_discretized_mix_logistic(key, jnp.asarray(y_hat)))
    g, u = _jax_mol_draws(key, y_hat.shape[:-1])
    got = tdist.sample_from_discretized_mix_logistic(t(y_hat), draws=(t(g), t(u))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    a, b = (tdist.sample_from_discretized_mix_logistic(
        t(y_hat), torch.Generator().manual_seed(5)) for _ in range(2))
    assert torch.equal(a, b) and float(a.abs().max()) <= 1.0


def _gen_draws(seed, mode, n_f, length, n_classes):
    """JAX's key chain in ``_build_gen_fn``: per step ``key, sub =
    split(key)``, then the sampler's draws from ``sub``."""
    def body(key, _):
        key, sub = jax.random.split(key)
        if mode == "RAW":
            return key, jax.random.gumbel(sub, (n_f, n_classes), jnp.float32)
        k1, k2 = jax.random.split(sub)
        return key, (jax.random.gumbel(k1, (n_f, 1, 10), jnp.float32)[:, 0],
                     jax.random.uniform(k2, (n_f, 1), minval=1e-5, maxval=1.0 - 1e-5)[:, 0])
    _, draws = jax.jit(lambda k: jax.lax.scan(body, k, None, length=length))(
        jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: t(np.asarray(a)), draws)


def _folded(tvoc, mel):
    c = tvoc.cfg
    mel_p = np.pad(mel.T / c.mel_max_abs_value, ((c.pad, c.pad), (0, 0)))[None]
    with torch.no_grad():
        return tvoc._fold(mel_p.astype(np.float32), TARGET, OVERLAP)


def test_gen_step_matches_jax(vocoders):
    """One step of the head (MOL: 30 mixture parameters) within 1e-5."""
    jvoc, tvoc, _ = vocoders
    rng = np.random.RandomState(2)
    n, c = 4, tvoc.cfg
    d = c.res_out_dims // 4
    args = [rng.uniform(-1, 1, n).astype(np.float32), rng.randn(n, 80).astype(np.float32)]
    args += [rng.randn(n, d).astype(np.float32) for _ in range(4)]
    args += [rng.randn(n, c.rnn_dims).astype(np.float32) * 0.5 for _ in range(2)]
    ref = jvoc.model.apply(jvoc.variables, *map(jnp.asarray, args), method=JWaveRNN.gen_step)
    with torch.no_grad():
        got = tvoc.model.gen_step(*map(t, args))
    assert got[0].shape == (n, 30 if c.mode == "MOL" else 2 ** c.bits)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_generator_matches_jax_build_gen_fn(vocoders):
    """``generate`` over the same folded conditioning, with JAX's key chain
    handed in, against ``_build_gen_fn``: samples within 1e-4 (MOL; the
    f32 feedback over 56 steps) and within 1e-6 (RAW: the same labels, 2/511
    apart, mapped to [-1, 1] in another order)."""
    jvoc, tvoc, _ = vocoders
    mel = np.random.RandomState(3).randn(80, 9).astype(np.float32)
    mels_f, aux_f = _folded(tvoc, mel)
    n_f, length = mels_f.shape[:2]
    assert n_f >= 2
    ref = np.asarray(jvoc._build_gen_fn(n_f, length)(jnp.asarray(mels_f.numpy()),
                                                      jnp.asarray(aux_f.numpy()),
                                                      jax.random.PRNGKey(4)))
    draws = _gen_draws(4, tvoc.cfg.mode, n_f, length, tvoc.model.n_classes)
    got = tvoc.generate(mels_f, aux_f, draws=draws).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 if tvoc.cfg.mode == "MOL" else 1e-6)
    assert not np.allclose(got, tvoc.generate(mels_f, aux_f, seed=9).numpy())


def test_infer_waveform_matches_jax_cpu_path(vocoders):
    """``infer_waveform`` on the step-by-step generator (MOL's only path;
    RAW with ``use_sampler=False``) against the JAX package's
    ``infer_waveform`` on the CPU (``use_pallas=False``): same length,
    samples within 1e-4 (MOL) or 1e-6 (RAW: the same labels)."""
    jvoc, tvoc, _ = vocoders
    mel = np.random.RandomState(5).randn(80, 11).astype(np.float32)
    ref = jvoc.infer_waveform(mel, target=TARGET, overlap=OVERLAP, seed=6, use_pallas=False)
    mels_f = _folded(tvoc, mel)[0]
    draws = _gen_draws(6, tvoc.cfg.mode, *mels_f.shape[:2], tvoc.model.n_classes)
    got = tvoc.infer_waveform(mel, target=TARGET, overlap=OVERLAP, use_sampler=False,
                              draws=draws)
    assert got.shape == ref.shape == (10 * 16,)
    np.testing.assert_allclose(got, ref, atol=1e-4 if tvoc.cfg.mode == "MOL" else 1e-6)


def test_mol_vocoder_serves_a_batch():
    """MOL ``infer_waveform_batch`` is ``infer_waveform`` per mel with one
    seed, as the JAX package's (the sampler is RAW only): the same audio,
    of the mel's length, and no packed sampler weights."""
    voc = WaveRnnVocoder(cfg=dict(SMALL, mode="MOL"), verbose=False, seed=3, device="cpu")
    rng = np.random.RandomState(7)
    mels = [rng.randn(80, 6).astype(np.float32), rng.randn(80, 9).astype(np.float32)]
    out = voc.infer_waveform_batch(mels, target=TARGET, overlap=OVERLAP, seed=2)
    for o, m in zip(out, mels):
        want = voc.infer_waveform(m, target=TARGET, overlap=OVERLAP, seed=2)
        assert o.shape == ((m.shape[1] - 1) * 16,) and np.array_equal(o, want)
        assert np.isfinite(o).all() and float(np.abs(o).max()) > 0
    assert voc.packed is None


def test_load_swaps_the_weights_and_drops_the_packed_ones(tmp_path, vocoders):
    """After ``load`` of another export the vocoder equals a fresh one built
    from that export: the same weights, and (RAW) the sampler's packed
    weights rebuilt, so that its labels equal the fresh vocoder's."""
    _, tvoc, variables = vocoders
    mode = tvoc.cfg.mode
    voc = WaveRnnVocoder(cfg=dict(SMALL, mode=mode), verbose=False, variables=variables,
                         device="cpu")
    other = WaveRnnVocoder(cfg=dict(SMALL, mode=mode), verbose=False, seed=11, device="cpu")
    path = tmp_path / "other.npz"
    save_npz(path, to_flax(other.model))
    mel = np.random.RandomState(8).randn(80, 12).astype(np.float32)
    if mode == "RAW":
        voc.infer_waveform(mel, greedy=True)
        stale = voc.packed
        assert stale is not None
    voc.load(path, verbose=False)
    assert voc.packed is None
    fresh = WaveRnnVocoder(path, cfg=dict(SMALL, mode=mode), verbose=False, device="cpu")
    for (n, a), (_, b) in zip(voc.model.state_dict().items(), fresh.model.state_dict().items()):
        assert torch.equal(a, b), n
    if mode == "RAW":
        np.testing.assert_array_equal(voc.infer_waveform(mel, seed=3),
                                      fresh.infer_waveform(mel, seed=3))
        for k, v in pack_wavernn_weights(fresh.model).items():
            assert torch.equal(voc.packed[k], v) and not torch.equal(stale[k], v), k
    else:
        np.testing.assert_array_equal(voc.infer_waveform(mel, target=TARGET, overlap=OVERLAP),
                                      fresh.infer_waveform(mel, target=TARGET, overlap=OVERLAP))
