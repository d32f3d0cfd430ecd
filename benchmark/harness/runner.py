"""One run of one cell: set-up, the measured window, the metrics, the check.

Set-up (counted in ``setup_s``, from the process's start to the first
measured call): import the port, initialise the device, write the seeded
weights and the reference voices, build the pipeline (which loads the
weights), build K1 where the configuration samples through it, and warm up:
every voice's embedding (the pipeline caches it, as it would for a
returning user) and one call of the cell's own shape.

The window: calls back to back, each with new texts (drawn before the
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
from typing import Dict, List, Optional

import torch

from . import check, registry, system, trace as tracing, traffic, weights
from .. import flops

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
    calls: List[check.CallOut] = field(default_factory=list)
    spans: List[tuple] = field(default_factory=list)
    trace: Optional[dict] = None
    k1_launches: Optional[int] = None
    window_peak_bytes: int = 0

    @property
    def sample_rate(self) -> int:
        return self.cfg["vocoder"]["sample_rate"]

    def span_s(self, name: str) -> float:
        return sum(s[2] - s[1] for s in self.spans if s[0] == name)

    def decode_steps(self) -> int:
        steps = check.bucket(self.mix["tts_batch"]["steps"], 200)
        return len(self.calls) * steps // self.cfg["synthesizer"]["r"]

    def model_flops(self) -> float:
        """FLOP of every call in the window (``benchmark/flops``)."""
        syn, voc = self.cfg["synthesizer"], self.cfg["vocoder"]
        steps = check.bucket(self.mix["tts_batch"]["steps"], 200)
        total = 0.0
        for out in self.calls:
            b = len(out.texts)
            t_text = check.bucket(max(len(traffic.symbol_ids(t)) for t in out.texts), 32)
            total += flops.tacotron(syn, b, t_text, steps // syn["r"])
            if voc["arch"] == "hifigan":
                total += flops.hifigan(voc, b, steps)
            else:
                total += flops.wavernn_upsampler(voc, b, check.bucket(steps, 100))
                total += sum(flops.k1(voc, lab.shape[0], lab.shape[1])[0]
                             for _, lab in out.launches)
        return total


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
    t = time.perf_counter()
    paths = weights.write(cfg, seed, tmp, dev)
    voices = traffic.write_voices(mix, seed, tmp)
    split["weights_and_voices"] = time.perf_counter() - t

    t = time.perf_counter()
    rec = system.Recorder(dev, trace)
    dropout_seed = weights.seed_of(seed, 3)
    pipe = system.build(cfg, paths, dev, dropout_seed, rec)
    split["load"] = time.perf_counter() - t
    t = time.perf_counter()
    if cfg["vocoder"]["arch"] == "wavernn" and dev.type == "cuda":
        from mockingbird_tpu_torch.ops import build
        build.load("wavernn_sample")
    split["kernel_build"] = time.perf_counter() - t

    t = time.perf_counter()
    kwargs = traffic.call_args(mix)

    planned: Dict[int, list] = {}

    def call(i: int) -> check.CallOut:
        texts = planned.pop(i) if i in planned else traffic.texts(mix, seed, i)
        voice = voices[traffic.voice_of(mix, seed, i)]
        n_mels, n_launches = len(rec.mels), len(rec.launches)
        with rec.span("call"):
            pcm = pipe.tts_batch(texts, str(voice), **kwargs)
        return check.CallOut(texts, voice, pcm, rec.mels[n_mels] if len(rec.mels) > n_mels else None,
                             rec.launches[n_launches:])

    for v in voices:
        pipe.embed_reference(str(v))
    t_call = time.perf_counter()
    call(-1)
    rec.sync()
    rec.reset()
    # the texts of the calls the window is expected to hold are drawn
    # before it, so that the caller's own work between calls stays out
    expected = int(seconds / max(time.perf_counter() - t_call, 1e-3)) + 2
    planned.update({i: traffic.texts(mix, seed, i) for i in range(expected)})
    split["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    _log("setup_s split: " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
         + f", other {setup_s - sum(split.values()):.3f} s")

    run = Run(name, cfg, mix, dev, setup_s)
    k1_before = system.k1_launches()
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
    run.k1_launches = system.k1_launches() - k1_before
    if dev.type == "cuda":
        run.window_peak_bytes = torch.cuda.max_memory_allocated(dev)
    run.audio_s = sum(len(w) for out in run.calls for w in out.pcm) / run.sample_rate
    if prof is not None:
        t = time.perf_counter()
        spans = [(s[0], s[3], s[4]) for s in run.spans]
        window = next(s for s in spans if s[0] == "window")
        run.trace = tracing.reduce(tracing.device_ops(prof), spans, window[1], window[2])
        del prof
        _log(f"trace read in {time.perf_counter() - t:.3f} s")

    # the program's state goes before the reference runs; its outputs stay
    del pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = check.Reference(cfg, paths, dev)
    numbers = check.readings(ref, mix, run.calls, seed, dropout_seed)
    failed = check.count_failed(cfg, mix, run.calls)
    _log(f"check took {time.perf_counter() - t:.3f} s")
    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and all(v <= limits[k] for k, v in numbers.items())

    metrics = {}
    for m in registry.metrics_of(name, trace):
        value = registry.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(run.window_peak_bytes)}
    result = {"correct": bool(correct), "attempted": sum(len(c.texts) for c in run.calls),
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
