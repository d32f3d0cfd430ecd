"""One run of one cell: set-up, the measured window, the metrics, the check.

What depends on the model is the cell's family's
(``benchmark/families/<family>.py``, named by the configuration's
``"family"`` key); this module is the same for every family.

Set-up (counted in ``setup_s``, from the process's start to the first
measured call): import the port, initialise the device, write the seeded
weights (``weights.write``, the family's parts) and the family's input files,
build the family's system (which loads the weights) and the kernels it
needs, and warm up: the family's warm-up, then one call of the cell's own
shape.

The window: calls back to back, each with new inputs (drawn before the
window for as many calls as the warm-up call's time says it will hold),
from the start of the first to the end of the last one that started before
``seconds`` had passed. ``audio_s_per_s`` is the audio all of them returned over all that
time. A traced run takes the same window under the profiler, with a span
around each call and each layer call, each ended by a synchronise.
"""
from __future__ import annotations

import gc
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

from . import check, registry, system, trace as tracing, weights

BANNED = ("jax", "jaxlib", "flax", "orbax", "mockingbird_tpu")


@dataclass
class Run:
    """What the metric readers read (``benchmark/metrics/``)."""
    name: str
    cfg: dict
    mix: dict
    device: torch.device
    setup_s: float
    window_s: float = 0.0
    audio_s: float = 0.0
    calls: List[object] = field(default_factory=list)     # the family's call outputs
    spans: List[tuple] = field(default_factory=list)
    trace: Optional[dict] = None
    counters: Dict[str, int] = field(default_factory=dict)  # the family's, over the window
    window_peak_bytes: int = 0

    @property
    def family(self) -> ModuleType:
        return registry.family(self.cfg)

    @property
    def sample_rate(self) -> int:
        return self.family.sample_rate(self.cfg)

    def span_s(self, name: str) -> float:
        return sum(s[2] - s[1] for s in self.spans if s[0] == name)

    def decode_steps(self) -> int:
        return self.family.decode_steps(self)

    def model_flops(self) -> float:
        """FLOP of every call in the window."""
        return self.family.model_flops(self)


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", spec: Optional[dict] = None,
             override: Optional[dict] = None, split: Optional[Dict[str, float]] = None) -> dict:
    """The run's result line as a dict. ``override`` replaces parts of the
    cell (``config``, ``traffic``) for rehearsals at small sizes; ``split``
    holds the parts of set-up timed before the call."""
    cell = registry.cell(name, spec)
    for key, value in (override or {}).items():
        cell[key] = value
    cfg, mix = cell["config"], cell["traffic"]
    split = dict(split or {})
    t = time.perf_counter()

    import mockingbird_tpu_torch  # noqa: F401  (the port; its import is set-up)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
    split["import_and_init"] = time.perf_counter() - t
    tmp = Path(tempfile.mkdtemp(prefix="bench-"))
    try:
        return _run(name, cfg, mix, dev, seed, seconds, trace, t_start, split, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(name, cfg, mix, dev, seed, seconds, trace, t_start, split, tmp) -> dict:
    fam = registry.family(cfg)
    t = time.perf_counter()
    paths = weights.write(cfg, seed, tmp, dev)
    inputs = fam.write_inputs(mix, seed, tmp)
    split["weights_and_inputs"] = time.perf_counter() - t

    t = time.perf_counter()
    rec = system.Recorder(dev, trace)
    sut = fam.build(cfg, mix, paths, inputs, dev, seed, rec)
    split["load"] = time.perf_counter() - t
    t = time.perf_counter()
    fam.kernels(cfg, dev)
    split["kernel_build"] = time.perf_counter() - t

    t = time.perf_counter()
    planned: Dict[int, object] = {}

    def call(i: int):
        drawn = planned.pop(i) if i in planned else fam.draw(mix, seed, i)
        return fam.call(sut, drawn, i)

    fam.warm(sut)
    t_call = time.perf_counter()
    call(-1)
    rec.sync()
    rec.reset()
    # the inputs of the calls the window is expected to hold are drawn
    # before it, so that the caller's own work between calls stays out
    expected = int(seconds / max(time.perf_counter() - t_call, 1e-3)) + 2
    planned.update({i: fam.draw(mix, seed, i) for i in range(expected)})
    split["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    _log("setup_s split: " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
         + f", other {setup_s - sum(split.values()):.3f} s")

    run = Run(name, cfg, mix, dev, setup_s)
    before = fam.counters()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prof = None
    if trace:
        # device activity only; a rehearsal on the CPU has none to record
        activity = (torch.profiler.ProfilerActivity.CUDA if dev.type == "cuda"
                    else torch.profiler.ProfilerActivity.CPU)
        prof = torch.profiler.profile(activities=[activity])
        prof.__enter__()
    with rec.span("window"):
        t0 = time.perf_counter()
        while not run.calls or time.perf_counter() - t0 < seconds:
            run.calls.append(call(len(run.calls)))
        run.window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    run.spans = list(rec.spans)
    run.counters = {k: v - before[k] for k, v in fam.counters().items()}
    if dev.type == "cuda":
        run.window_peak_bytes = torch.cuda.max_memory_allocated(dev)
    run.audio_s = sum(fam.samples(out) for out in run.calls) / fam.sample_rate(cfg)
    if prof is not None:
        t = time.perf_counter()
        spans = [(s[0], s[3], s[4]) for s in run.spans]
        window = next(s for s in spans if s[0] == "window")
        run.trace = tracing.reduce(tracing.device_ops(prof), spans, window[1], window[2])
        del prof
        _log(f"trace read in {time.perf_counter() - t:.3f} s")

    # the program's state goes before the reference runs; its outputs stay
    del sut
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = fam.readings(cfg, mix, paths, dev, run.calls, seed)
    failed = fam.failed(cfg, mix, run.calls)
    _log(f"check took {time.perf_counter() - t:.3f} s")
    correct, checks = check.judge(numbers, failed, cfg["limits"])

    metrics = {}
    for m in registry.metrics_of(name, trace):
        value = registry.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(run.window_peak_bytes)}
    result = {"correct": bool(correct), "attempted": sum(fam.attempted(c) for c in run.calls),
              "failed": failed, "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = checks
    for k, v in checks.items():
        _log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    return result


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
