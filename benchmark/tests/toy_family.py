"""A toy model family (the interface: ``benchmark/families/__init__.py``),
which ``test_bench_family.py`` adds to a copy of the benchmark as
``families/toy.py``: a seeded one-layer system that turns texts into int16
PCM, one frame of ``hop`` samples a letter (an embedding, one dense layer,
tanh, a gain), with its plain reference beside it.

``toy_lsb``, the number compared, is the largest difference in 16-bit
steps between the PCM a call returned and the reference's in float64 for
the same texts, over every text of the window: 1 at most, as float32 and
float64 round a few samples to neighbouring steps.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..harness import system as harness_system, weights

LETTERS = "abcdefghijklmnopqrstuvwxyz "


def _gain(view: torch.Tensor, shape) -> None:
    view.abs_().mul_(0.5).add_(0.5)


SHAPES = {"gain": _gain}      # a kind that ``weights._shape`` lacks


def parts(cfg: dict) -> list:
    c = cfg["toy"]
    return [("toy", "toy.npz", [("embed", (len(LETTERS), c["dim"]), "embed"),
                                ("out/kernel", (c["dim"], c["hop"]), "kernel"),
                                ("out/bias", (c["hop"],), "bias"),
                                ("out/gain", (c["hop"],), "gain")])]


class Toy(torch.nn.Module):
    def __init__(self, w: Dict[str, torch.Tensor]):
        super().__init__()
        self.embed = torch.nn.Embedding.from_pretrained(w["embed"])
        self.out = torch.nn.Linear(*w["out/kernel"].shape)
        with torch.no_grad():
            self.out.weight.copy_(w["out/kernel"].T)
            self.out.bias.copy_(w["out/bias"])
        self.register_buffer("gain", w["out/gain"])

    @torch.no_grad()
    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """Letter ids (B, L) → int16 PCM (B, L·hop)."""
        x = torch.tanh(self.out(self.embed(ids))) * self.gain
        return torch.round(x.clamp(-1.0, 1.0) * 32767.0).to(torch.int16).flatten(1)


@dataclass
class CallOut:
    texts: List[str]
    pcm: List[np.ndarray]


@dataclass
class System:
    model: Toy
    rec: harness_system.Recorder
    device: torch.device
    hop: int


def write_inputs(mix: dict, seed: int, out_dir: Path) -> list:
    return []


def build(cfg, mix, paths, inputs, device, seed, rec) -> System:
    model = Toy(weights.read(paths["toy"], device)).to(device)

    def layer(inner, *args, **kwargs):
        with rec.span("toy"):
            return inner(*args, **kwargs)
    harness_system.wrap(model, "forward", layer)
    return System(model, rec, device, cfg["toy"]["hop"])


def kernels(cfg: dict, device) -> None:
    pass


def warm(s: System) -> None:
    pass


def draw(mix: dict, seed: int, i: int) -> List[str]:
    rng = random.Random(f"{seed}/{i}")
    return ["".join(rng.choice(LETTERS) for _ in range(rng.randint(*mix["letters"])))
            for _ in range(mix["texts_per_call"])]


def _ids(texts: List[str]) -> np.ndarray:
    ids = np.zeros((len(texts), max(map(len, texts))), dtype=np.int64)
    for j, t in enumerate(texts):
        ids[j, :len(t)] = [LETTERS.index(c) for c in t]
    return ids


def call(s: System, texts: List[str], i: int) -> CallOut:
    with s.rec.span("call"):
        pcm = s.model(torch.from_numpy(_ids(texts)).to(s.device)).cpu().numpy()
    return CallOut(texts, [pcm[j, :len(t) * s.hop] for j, t in enumerate(texts)])


def attempted(out: CallOut) -> int:
    return len(out.texts)


def samples(out: CallOut) -> int:
    return sum(len(w) for w in out.pcm)


def sample_rate(cfg: dict) -> int:
    return cfg["toy"]["sample_rate"]


def model_flops(run) -> float:
    c = run.cfg["toy"]
    return float(sum(2 * len(out.texts) * max(map(len, out.texts)) * c["dim"] * c["hop"]
                     for out in run.calls))


def counters() -> Dict[str, int]:
    return {}


def failed(cfg: dict, mix: dict, calls: List[CallOut]) -> int:
    hop = cfg["toy"]["hop"]
    return sum(int(j >= len(out.pcm) or out.pcm[j].dtype != np.int16
                   or out.pcm[j].shape != (len(t) * hop,))
               for out in calls for j, t in enumerate(out.texts))


def reference_pcm(w: Dict[str, np.ndarray], text: str) -> np.ndarray:
    """The plain reference: one text's PCM in float64."""
    x = np.tanh(w["embed"][_ids([text])[0]] @ w["out/kernel"] + w["out/bias"]) * w["out/gain"]
    return np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16).reshape(-1)


def numbers(cfg: dict) -> set:
    return {"toy_lsb"}


def readings(cfg, mix, paths, device, calls: List[CallOut], seed: int) -> Dict[str, float]:
    w = {k: v.double().cpu().numpy() for k, v in weights.read(paths["toy"], "cpu").items()}
    lsb = 0.0
    for out in calls:
        for t, got in zip(out.texts, out.pcm):
            want = reference_pcm(w, t)
            lsb = max(lsb, np.inf if got.shape != want.shape else
                      float(np.abs(got.astype(np.int64) - want.astype(np.int64)).max()))
    return {"toy_lsb": lsb}
