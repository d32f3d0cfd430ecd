"""The profiler trace of a traced run's window, reduced to what the
per-layer metrics read: the device's busy time (the union of the intervals
in which a kernel, a copy or a fill ran), the device time of each kernel by
name, and the idle gaps between device operations, each named by the
innermost benchmark span open on the host at its start and at its end
("call to call": the host's work between one call's last device operation
and the next call's first). The profiler records
device activity only (no host operators, whose recording would slow the
host-bound decode loop severalfold); its timestamps and the spans' are both
the host's wall clock in ns.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import torch

def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1000)


def device_ops(prof) -> List[tuple]:
    """The device operations of a finished ``torch.profiler`` session:
    (name, start ns, end ns) of every kernel, copy and fill."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            start = _ns(e, "start")
            out.append((e.name(), start, start + _ns(e, "duration")))
    return out


def reduce(dev: List[tuple], spans: List[tuple], t0: int, t1: int, top: int = 10) -> dict:
    """Busy seconds, per-kernel seconds and the longest idle gaps within
    [t0, t1] (ns)."""
    dev = sorted((max(s, t0), min(e, t1), n) for n, s, e in dev if e > t0 and s < t1)
    busy, by_name = 0, defaultdict(int)
    gaps = []
    cursor = t0
    for s, e, n in dev:
        by_name[n] += e - s
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if t1 > cursor:
        gaps.append((cursor, t1))

    def host_at(t: int):
        open_ = [(e - s, k) for k, (n, s, e) in enumerate(spans) if s <= t <= e]
        return min(open_)[1] if open_ else None

    def name(a: int, b: int) -> str:
        first, last = host_at(a), host_at(b)
        names = ["outside any span" if k is None else spans[k][0] for k in (first, last)]
        return names[0] if first == last else f"{names[0]} to {names[1]}"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"busy_s": busy / 1e9, "window_s": (t1 - t0) / 1e9,
            "kernel_s": {n: v / 1e9 for n, v in by_name.items()},
            "device_ops": [[n, v / 1e9] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[name(a, b), (b - a) / 1e9] for a, b in longest]}


def kernel_seconds(summary: Dict, fragment: str) -> float:
    """Device seconds of the kernels whose name contains ``fragment``."""
    return sum(v for n, v in summary["kernel_s"].items() if fragment in n)
