"""What the harness gives every family's system under test: a ``Recorder``
of the benchmark's own spans and of the captures a family's wrappers keep
for the check after the window, and ``wrap``, which puts such a wrapper on a
method of one instance. The systems themselves are built by the families
(``benchmark/families/<family>.py`` ``build``).
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List

import torch


class Recorder:
    """Captures and spans of the calls made since ``reset``."""

    def __init__(self, device: torch.device, trace: bool):
        self.device, self.trace = device, trace
        self.reset()

    def reset(self) -> None:
        self.captures: Dict[str, List[object]] = defaultdict(list)   # by the family's names
        self.spans: List[tuple] = []        # (name, start s, end s, start ns, end ns)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        """A span around a block: (name, start, end) on the host's
        monotonic clock in s and on its wall clock in ns (the profiler's
        clock); in a traced run ended by a synchronise."""
        rec = self

        class _Span:
            def __enter__(self):
                self.t0, self.ns0 = time.perf_counter(), time.time_ns()

            def __exit__(self, *exc):
                if rec.trace:
                    rec.sync()
                rec.spans.append((name, self.t0, time.perf_counter(), self.ns0, time.time_ns()))
        return _Span()


def wrap(obj, method: str, around) -> None:
    """Replace ``obj.method`` on this instance by ``around(inner, *args,
    **kwargs)``."""
    inner = getattr(obj, method)

    def wrapped(*args, **kwargs):
        return around(inner, *args, **kwargs)
    setattr(obj, method, wrapped)
