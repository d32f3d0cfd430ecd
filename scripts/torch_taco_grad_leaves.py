"""Which gradient leaves carry the port's f32 Tacotron difference between the
card and the CPU, and whether cuDNN's recurrent layers are where it comes from.

The configuration is ``tests/test_torch_cuda.py::test_tacotron_f32_step_on_card_matches_cpu[full]``:
``tacotron_config()`` made from ``torch.manual_seed(0)``, batch 2, 32 text
symbols, 40 mel frames at r = 2 (20 decoder steps), dropout and zoneout off,
BatchNorm in batch-statistics mode, TF32 off. One loss and backward runs on
the CPU and three times on the card: everything as PyTorch picks it, cuDNN
off in the recurrent layers only (their forward, and so their backward,
take PyTorch's own kernels), cuDNN on with its recurrent layers' f32
precision set to "ieee", and cuDNN off everywhere; the CPU also runs
the model in float64, the yardstick of f32 rounding. For each run the
script prints the relative L2 of all gradients against the CPU's f32 and
f64 ones, then the leaves with the largest share of the squared difference
from the CPU's f32, each with its own relative L2, and the relative L2
with cuDNN off in one recurrent layer at a time. Before them, on the CPU,
how far a seeded relative perturbation of each encoder GRU's output moves
the gradients; then each recurrent layer type alone against the CPU in
f64, under the same settings as the card runs. It is kept so that the
answer recorded in PERF.md's open questions can be reproduced.

    python scripts/torch_taco_grad_leaves.py [--top 8] [--device cuda]
"""
from __future__ import annotations

import argparse
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mockingbird_tpu_torch import resolve_device  # noqa: E402
from mockingbird_tpu_torch.models.layers import (FusedGRUCell, FusedLSTMLayer,  # noqa: E402
                                                 GRULayer, LSTMCell)
from mockingbird_tpu_torch.models.tacotron import Tacotron, tacotron_config  # noqa: E402
from mockingbird_tpu_torch.models.tacotron.train import loss_of  # noqa: E402
from mockingbird_tpu_torch.train.precision import Policy  # noqa: E402

RECURRENT = (GRULayer, FusedGRUCell, FusedLSTMLayer, LSTMCell)


def batch(cfg, b=2, t_text=32, t_mel=40, seed=0) -> dict:
    """The card test's batch (``_taco_batch``)."""
    rng = np.random.RandomState(seed)
    texts = np.zeros((b, t_text), np.int64)
    for i, n in enumerate(rng.randint(8, t_text + 1, b)):
        texts[i, :n] = rng.randint(1, 75, n)
    spk = rng.randn(b, cfg.speaker_embedding_size).astype(np.float32)
    stop = np.zeros((b, t_mel), np.float32)
    stop[:, -3:] = 1
    return dict(texts=texts, embeds=spk / np.linalg.norm(spk, axis=1, keepdims=True),
                mels=np.clip(rng.randn(b, t_mel, cfg.n_mels) * 2, -4, 4).astype(np.float32),
                stop=stop)


@contextmanager
def cudnn_off_in(model: torch.nn.Module, types):
    """cuDNN disabled inside the forward of every submodule of ``types``."""
    saved = []

    def pre(*_):
        saved.append(torch.backends.cudnn.enabled)
        torch.backends.cudnn.enabled = False

    def post(*_):
        torch.backends.cudnn.enabled = saved.pop()

    hooks = [h for m in model.modules() if isinstance(m, types)
             for h in (m.register_forward_pre_hook(pre), m.register_forward_hook(post))]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def grads(model, host, device) -> dict:
    b = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    zo = torch.zeros((host["mels"].shape[1] // 2, 2, 2, model.cfg.lstm_dims), dtype=torch.bool,
                     device=device)
    model.zero_grad(set_to_none=True)
    loss, _, _ = loss_of(model, b, 2, Policy.from_name("fp32"), zo_masks=zo)
    loss.backward()
    return {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}


def rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    return (num / sum(float((w ** 2).sum()) for w in want.values())) ** 0.5


def report(name: str, got: dict, want: dict, exact: dict, top: int) -> None:
    sq = {k: float(((got[k] - want[k]) ** 2).sum()) for k in want}
    total = sum(sq.values())
    print(f"{name}: gradients relative L2 {rel_l2(got, want):.3g} against the CPU's f32, "
          f"{rel_l2(got, exact):.3g} against its f64")
    for k in sorted(sq, key=lambda k: -sq[k])[:top]:
        own = float(want[k].norm())
        rel = (sq[k] ** 0.5) / own if own else float("inf")
        print(f"  {k}: {100 * sq[k] / max(total, 1e-300):.1f}% of the squared difference, "
              f"own relative L2 {rel:.3g}, |g| {own:.3g}")


@contextmanager
def rnn_ieee():
    """cuDNN's recurrent layers in full f32 (``torch.backends.cudnn.rnn.
    fp32_precision = "ieee"``, where this PyTorch has that setting)."""
    rnn = getattr(torch.backends.cudnn, "rnn", None)
    if rnn is None or not hasattr(rnn, "fp32_precision"):
        print("  (this PyTorch has no torch.backends.cudnn.rnn.fp32_precision)")
        yield
        return
    saved = rnn.fp32_precision
    rnn.fp32_precision = "ieee"
    try:
        yield
    finally:
        rnn.fp32_precision = saved


def layers_alone(dev) -> None:
    """Each recurrent layer type at the Tacotron CBHG's and the GE2E's
    widths, batch 2 × 40 steps, inputs N(0, scale²), seeded: output and
    gradients (input and weights) on the card against the CPU in f64, under
    each setting."""
    cases = [(f"GRULayer {i} -> {h}{', reverse' if r else ''}, input scale {sc}",
              GRULayer(i, h, reverse=r), sc)
             for i, h in ((512, 256), (256, 128)) for r in (False, True) for sc in (1.0, 5.0)]
    cases.append(("FusedLSTMLayer 256 -> 256 (GE2E), input scale 1.0",
                  FusedLSTMLayer(256, 256), 1.0))
    for name, layer, scale in cases:
        torch.manual_seed(1)
        x = scale * torch.randn(2, 40, layer.weight_ih_l0.shape[1])
        w = torch.randn(2, 40, layer.weight_hh_l0.shape[1])

        def run(m, d, dtype):
            m = m.to(d, dtype).train()
            xi = x.to(d, dtype).clone().requires_grad_()
            y = m(xi)
            (y * w.to(d, dtype)).sum().backward()
            out = [y.detach(), xi.grad] + [p.grad for p in m.parameters()]
            m.zero_grad(set_to_none=True)
            return [t.detach().cpu().double() for t in out]

        exact = run(layer, "cpu", torch.float64)
        layer.float()

        def err(got):
            return (f"output {float((got[0] - exact[0]).norm() / exact[0].norm()):.3g}, "
                    f"gradients {rel_l2(dict(enumerate(got[1:])), dict(enumerate(exact[1:]))):.3g}")
        print(f"{name}, relative L2 against the CPU in f64:")
        print(f"  CPU f32: {err(run(layer, 'cpu', torch.float32))}")
        print(f"  card, cuDNN, allow_tf32 False: {err(run(layer, dev, torch.float32))}")
        with rnn_ieee():
            print(f"  card, cuDNN, allow_tf32 False, RNN fp32_precision ieee: "
                  f"{err(run(layer, dev, torch.float32))}")
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
            print(f"  card, cuDNN deterministic: {err(run(layer, dev, torch.float32))}")
        with torch.backends.cudnn.flags(enabled=False):
            print(f"  card, cuDNN off: {err(run(layer, dev, torch.float32))}")
        layer.cpu()


def sensitivity(cpu, host, want) -> None:
    """The CPU's f32 gradients when one encoder GRU's output is multiplied
    by 1 + scale·N(0, 1) (seeded): how far a perturbation of that size
    moves them."""
    for name in ("encoder.cbhg.gru_fwd", "encoder.cbhg.gru_bwd"):
        layer = dict(cpu.named_modules())[name]
        for scale in (1e-7, 1e-6, 4.5e-6, 1e-5, 1e-4):
            gen = torch.Generator().manual_seed(0)
            h = layer.register_forward_hook(
                lambda m, i, out: out * (1 + scale * torch.randn(out.shape, generator=gen)))
            got = grads(cpu, host, "cpu")
            h.remove()
            print(f"CPU f32, {name} output perturbed by {scale:g} relative: gradients "
                  f"relative L2 {rel_l2(got, want):.3g}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = tacotron_config()
    torch.manual_seed(0)
    cpu = Tacotron(cfg).train()
    card = Tacotron(cfg).to(dev).train()
    card.load_state_dict(cpu.state_dict())
    host = batch(cfg)
    want = grads(cpu, host, "cpu")
    sensitivity(cpu, host, want)
    exact = grads(cpu.double(), {k: v.astype(np.float64) if v.dtype == np.float32 else v
                                 for k, v in host.items()}, "cpu")
    print(f"CPU f32 against f64: gradients relative L2 {rel_l2(want, exact):.3g}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers_alone(dev)
    report("card, cuDNN on", grads(card, host, dev), want, exact, args.top)
    with rnn_ieee():
        report("card, cuDNN on, RNN fp32_precision ieee", grads(card, host, dev), want, exact,
               args.top)
    with cudnn_off_in(card, RECURRENT):
        report("card, cuDNN off in the recurrent layers", grads(card, host, dev), want, exact,
               args.top)
    for name, m in card.named_modules():
        if isinstance(m, GRULayer):
            with cudnn_off_in(m, GRULayer):
                got = grads(card, host, dev)
            print(f"card, cuDNN off in {name} only: gradients relative L2 "
                  f"{rel_l2(got, want):.3g} against the CPU's f32")
    with torch.backends.cudnn.flags(enabled=False):
        report("card, cuDNN off everywhere", grads(card, host, dev), want, exact, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
