"""Profiling and timing utilities.

Port of ``mockingbird_tpu/train/profiler.py``: ``Profiler.tick`` with a
device synchronisation, the rd/fw/bw ``Timer``, the real-time-factor
``RTFMeter`` (copies), and ``trace``, a ``torch.profiler`` Chrome trace.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch


def _sync(value) -> None:
    """Wait for the CUDA device of every tensor in ``value`` (a tensor or a
    nest of lists, tuples and dicts of them)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _sync(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _sync(v)


class Profiler:
    """Per-stage wall times, each tick synchronised on its ``sync_value``'s
    device."""

    def __init__(self, summarize_every: int = 5, disabled: bool = False):
        self.summarize_every = summarize_every
        self.disabled = disabled
        self.tick_time = time.perf_counter()
        self.logs = defaultdict(list)

    def tick(self, name: str, sync_value=None):
        if self.disabled:
            return
        if sync_value is not None:
            _sync(sync_value)
        now = time.perf_counter()
        self.logs[name].append(now - self.tick_time)
        self.tick_time = now
        if len(self.logs[name]) >= self.summarize_every:
            self.summarize()

    def summarize(self):
        items = [(name, sum(v) / len(v)) for name, v in self.logs.items()]
        total = sum(t for _, t in items) or 1e-9
        print("Average execution time over last summaries:")
        for name, t in items:
            print(f"  {name:24s} {t*1000:8.2f} ms   ({100*t/total:4.1f}%)")
        self.logs.clear()


class Timer:
    """rd/fw/bw breakdown timer."""

    def __init__(self):
        self.prev_t = time.time()
        self.clear()

    def set(self):
        self.prev_t = time.time()

    def cnt(self, mode: str):
        self.time_table[mode] += time.time() - self.prev_t
        self.set()

    def show(self) -> str:
        total = sum(self.time_table.values()) or 1e-9
        msg = " | ".join(f"{k} {100*v/total:.0f}%" for k, v in self.time_table.items())
        self.clear()
        return msg

    def clear(self):
        self.time_table = {"rd": 0.0, "fw": 0.0, "bw": 0.0}


class RTFMeter:
    """Real-time-factor accumulator."""

    def __init__(self, sample_rate: int = 16000):
        self.sample_rate = sample_rate
        self.audio_seconds = 0.0
        self.wall_seconds = 0.0

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.wall_seconds += time.perf_counter() - t0

    def add_audio(self, n_samples: int):
        self.audio_seconds += n_samples / self.sample_rate

    @property
    def rtf(self) -> float:
        return self.audio_seconds / max(self.wall_seconds, 1e-9)

    def report(self) -> str:
        return (f"{self.audio_seconds:.2f}s audio in {self.wall_seconds:.2f}s "
                f"→ RTF {self.rtf:.1f}x")


@contextlib.contextmanager
def trace(log_dir="mb_profile"):
    """``torch.profiler`` over the block (CPU, and CUDA when a card is
    there), written as a Chrome trace ``log_dir/trace.json`` (open it in
    Perfetto or chrome://tracing). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
