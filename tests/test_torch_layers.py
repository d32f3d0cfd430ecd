"""The port's recurrent layers under an optimizer, against flax.

flax's ``GRUCell`` has no hidden r/z biases and its LSTM cells no input
biases; PyTorch's fused calls take both. The port hands those slots to the
call as zero buffers, so training cannot move them and ``parameters()`` are
flax's leaves. Each layer here is loaded from flax parameters drawn from
numpy, takes two Adam steps (lr 1e-2) on a seeded loss, and is held against
two ``optax.adam`` steps of the flax layer: outputs after the steps within
1e-5, the bias slots exactly 0, and the inverse weight map giving back the
flax tree (same leaves, values within 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import flax.linen as fnn

from mockingbird_tpu.models.encoder.model import FusedLSTMLayer as JFusedLSTM
from mockingbird_tpu_torch.models.layers import FusedLSTMLayer, GRULayer, LSTMCell
from mockingbird_tpu_torch.weights import WeightMismatch, flatten_tree, load_flax, to_flax

B, T, D, H = 3, 7, 5, 4
LR = 1e-2


class JGRU(fnn.Module):
    """flax ``nn.RNN(nn.GRUCell)``, forward or reversed (as the CBHG runs it)."""
    reverse: bool = False

    @fnn.compact
    def __call__(self, x):
        return fnn.RNN(fnn.GRUCell(H, name="cell"), reverse=self.reverse, keep_order=True)(x)


class JLSTMSteps(fnn.Module):
    """flax ``OptimizedLSTMCell`` stepped over T inputs from a zero carry,
    the hidden states stacked (as the Tacotron decoder steps its cells)."""

    @fnn.compact
    def __call__(self, x):
        cell = fnn.OptimizedLSTMCell(H, name="cell")
        carry = (jnp.zeros((x.shape[0], H)), jnp.zeros((x.shape[0], H)))
        hs = []
        for t in range(x.shape[1]):
            carry, h = cell(carry, x[:, t])
            hs.append(h)
        return jnp.stack(hs, axis=1)


class LSTMSteps(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.cell = LSTMCell(D, H)

    def forward(self, x):
        carry = (x.new_zeros(x.shape[0], H), x.new_zeros(x.shape[0], H))
        hs = []
        for t in range(x.shape[1]):
            carry = self.cell(carry, x[:, t])
            hs.append(carry[1])
        return torch.stack(hs, dim=1)


def _draw(shapes, rng):
    return jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.5).astype(np.float32), shapes)


CASES = {
    "gru": (lambda: JGRU(), lambda: GRULayer(D, H), lambda p: p["cell"]),
    "gru_reverse": (lambda: JGRU(reverse=True), lambda: GRULayer(D, H, reverse=True),
                    lambda p: p["cell"]),
    "lstm_cell": (lambda: JLSTMSteps(), lambda: LSTMSteps(), lambda p: p),
    "fused_lstm_layer": (lambda: JFusedLSTM(H), lambda: FusedLSTMLayer(D, H), lambda p: p),
}


def _slots(module):
    """The bias slots flax does not have, as the port holds them."""
    return [buf for name, buf in module.named_buffers()
            if name.endswith(("bias_hh_rz", "bias_ih", "bias_ih_l0"))]


def _train_both(case):
    make_j, make_t, inner = CASES[case]
    rng = np.random.RandomState(0)
    x = rng.randn(B, T, D).astype(np.float32)
    target = rng.randn(B, T, H).astype(np.float32)
    jmod = make_j()
    params = _draw(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x))["params"], rng)

    def loss_fn(p):
        return jnp.mean((jmod.apply({"params": p}, x) - target) ** 2)

    tx = optax.adam(LR)
    opt_state, p = tx.init(params), params
    for _ in range(2):
        grads = jax.grad(loss_fn)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)

    tmod = make_t()
    load_flax(tmod, inner(jax.tree.map(np.asarray, params)))
    opt = torch.optim.Adam(tmod.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(2):
        opt.zero_grad()
        torch.mean((tmod(torch.from_numpy(x)) - torch.from_numpy(target)) ** 2).backward()
        opt.step()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    return tmod, got, np.asarray(jmod.apply({"params": p}, x)), inner(jax.tree.map(np.asarray, p))


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_adam_steps_match_flax(case):
    tmod, got, want, _ = _train_both(case)
    np.testing.assert_allclose(got, want, atol=1e-5)
    slots = _slots(tmod)
    assert slots, "no bias slot found"
    for buf in slots:
        assert not bool(buf.ne(0).any())
    assert not any(b is p for b in slots for p in tmod.parameters())


@pytest.mark.parametrize("case", sorted(CASES))
def test_inverse_map_gives_back_the_flax_tree(case):
    tmod, _, _, want = _train_both(case)
    got = flatten_tree(to_flax(tmod)["params"])
    want = flatten_tree(want)
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def test_inverse_map_refuses_a_nonzero_slot():
    layer = GRULayer(D, H)
    layer.bias_hh_rz[0] = 1.0
    with pytest.raises(WeightMismatch, match="not zero"):
        to_flax(layer)
