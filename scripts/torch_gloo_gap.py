"""What sets the gap of chip_smoke.py's two-gloo-rank VITS hold, on one card.

1. ``--repeats`` runs of ``phase_parallel_gloo`` as the smoke runs it (one
   rank on the whole batch against two gloo ranks on its halves, 2 f32
   steps, TF32 off, deterministic algorithms): each run's largest relative
   difference of the logged losses, and each loss's own, per step.
2. One step of each side, then the two final checkpoints side by side: the
   step's gradients (Adam's first moment over 1 - beta1), how far apart
   they are, how many change sign, and how many parameters the first
   update moved apart by more than half the learning rate (Adam's first
   step is lr * g / (|g| + eps), so a gradient whose sign is rounding
   noise moves its parameter a whole lr one way or the other), by tensor.
3. Two in-process runs of the same 3 f32 steps on one rank, under
   PyTorch's defaults and then with deterministic algorithms: how far
   apart the card's own repeats are (why the smoke's holds turn
   deterministic algorithms on).

    python scripts/torch_gloo_gap.py --repeats 5 --parts grads,repeats,determinism

Imports chip_smoke.py from the checkout it lies in; no JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from mockingbird_tpu_torch.config import Config  # noqa: E402
from mockingbird_tpu_torch.models.vits.model import init_vits, vits_config  # noqa: E402
from mockingbird_tpu_torch.models.vits.train import VitsDiscriminator  # noqa: E402
from mockingbird_tpu_torch.ops import build  # noqa: E402

KEYS = ("gen", "disc", "mel", "dur", "kl")
LR, BETA1 = 2e-4, 0.8


def repeats(dev, n: int) -> None:
    errs = []
    for i in range(n):
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            try:
                cs.phase_parallel_gloo(dev, tmp)
                ok = True
            except RuntimeError as exc:
                ok = False
                print(f"  run {i}: the phase failed: {exc}")
            one, _ = cs._logged(tmp / "m1", "one")
            two, _ = cs._logged(tmp / "m2", "gloo")
        per = [{k: float(abs(b - a) / abs(a)) for k, a, b in zip(KEYS, x, y)}
               for x, y in zip(one, two)]
        err = cs._rel_err(two, one)
        errs.append(err)
        print(f"GLOO_RUN {i}: largest {err:.4g} (held: {ok}); per step and loss "
              + "; ".join(", ".join(f"{k} {v:.3g}" for k, v in p.items()) for p in per))
    print(f"GLOO_RUNS {n}: largest relative difference min {min(errs):.4g}, "
          f"max {max(errs):.4g}, all {[f'{e:.4g}' for e in errs]} (bound 1e-5)")


def _names(cfg) -> dict:
    model, disc = init_vits(0, cfg), VitsDiscriminator()
    return {"g": [n for n, _ in model.named_parameters()],
            "d": [n for n, _ in disc.named_parameters()]}


def _state(path: Path) -> dict:
    (ckpt,) = sorted((path / "ckpt_vits").glob("*.pt"))
    return torch.load(ckpt, map_location="cpu", weights_only=True)


def one_step_gradients(dev) -> None:
    cfg = Config(vits_config()).merge(Config.from_json(cs.VITS_JSON)).merge(cs.VITS_CFG)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cs._write_dataset(tmp / "data", cfg)
        with cs.full_f32(), cs.deterministic():
            cs._vits_run("one", tmp / "data", tmp / "m1", cfg, cs.TRAIN_BATCH, 1, dev)
        cs.gloo_vits_ranks(tmp, cfg, 1, dev)
        one, two = _state(tmp / "m1" / "one"), _state(tmp / "m2" / "gloo")
    names = _names(Config(cfg.to_dict()))
    for part in ("g", "d"):
        opt1, opt2 = one[f"{part}_opt"]["state"], two[f"{part}_opt"]["state"]
        rows, tot = [], dict(n=0, flips=0, moved=0, dg2=0.0, g2=0.0)
        for i, name in enumerate(names[part]):
            if i not in opt1:
                continue
            g1 = opt1[i]["exp_avg"].double() / (1 - BETA1)
            g2 = opt2[i]["exp_avg"].double() / (1 - BETA1)
            p1, p2 = one[part][name].double(), two[part][name].double()
            flips = int(((torch.sign(g1) != torch.sign(g2)) & ((g1 != 0) | (g2 != 0))).sum())
            moved = int(((p1 - p2).abs() > LR / 2).sum())
            dg2, g2n = float(((g1 - g2) ** 2).sum()), float((g1 ** 2).sum())
            tot["n"] += g1.numel()
            tot["flips"] += flips
            tot["moved"] += moved
            tot["dg2"] += dg2
            tot["g2"] += g2n
            if moved:
                rms = float(g1.pow(2).mean().sqrt())
                mask = (p1 - p2).abs() > LR / 2
                rows.append((moved, name, g1.numel(), flips,
                             float(g1[mask].abs().max()) / max(rms, 1e-30),
                             (dg2 / max(g2n, 1e-300)) ** 0.5))
        print(f"GRADS {part}: {tot['n']} parameters; gradients apart by "
              f"{(tot['dg2'] / tot['g2']) ** 0.5:.3g} (relative 2-norm); {tot['flips']} "
              f"change sign; {tot['moved']} moved apart by more than lr/2 in the first update")
        for moved, name, n, flips, worst, rel in sorted(rows, reverse=True)[:10]:
            print(f"  {name}: {moved} of {n} moved apart, {flips} sign changes, the largest "
                  f"such |g| {worst:.3g} of the tensor's RMS, its gradient apart by {rel:.3g}")


def determinism(dev) -> None:
    cfg = Config(vits_config()).merge(Config.from_json(cs.VITS_JSON)).merge(cs.VITS_CFG)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cs._write_dataset(tmp / "data", cfg)
        for label, ctx in (("defaults", cs.nullcontext), ("deterministic", cs.deterministic)):
            runs = []
            for i in range(2):
                with ctx():
                    cs._vits_run(f"{label}{i}", tmp / "data", tmp / "m", cfg, cs.TRAIN_BATCH,
                                 cs.PAR_STEPS, dev)
                runs.append(cs._logged(tmp / "m", f"{label}{i}")[0])
            print(f"REPEAT {label} ({cs.tf32_state()}): two in-process runs of "
                  f"{cs.PAR_STEPS} f32 steps differ by {cs._rel_err(runs[1], runs[0]):.4g} "
                  f"(largest relative difference of the logged losses)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--parts", default="grads,repeats,determinism",
                    help="comma-separated: grads, repeats, determinism")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gloo_gap: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    for name in cs.KERNELS:
        build.build(name)
    dev = torch.device("cuda")
    parts = args.parts.split(",")
    if "grads" in parts:
        one_step_gradients(dev)
    if "repeats" in parts:
        repeats(dev, args.repeats)
    if "determinism" in parts:
        determinism(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
