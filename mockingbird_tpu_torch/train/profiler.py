"""``trace``: a ``torch.profiler`` Chrome trace of a block, with the
program's own spans (``tracing.py``) on the same timeline as the host's
operators and the card's kernels.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path

import torch

from .. import tracing


def _span_events(spans, base_ns: int) -> list:
    """Chrome ``X`` events of ``spans`` (microseconds from ``base_ns``) in
    this process, one row per thread named "program spans"."""
    pid = os.getpid()
    rows = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
             "args": {"name": "program spans"}} for tid in sorted({s.thread for s in spans})]
    return rows + [{"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                    "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": s.duration_ns / 1e3,
                    "args": {"id": s.id, "parent": s.parent, "call": s.call,
                             **(s.attrs or {})}}
                   for s in spans]


@contextlib.contextmanager
def trace(log_dir="mb_profile"):
    """``torch.profiler`` over the block (CPU, and CUDA when a card is
    there), written as a Chrome trace ``log_dir/trace.json`` (open it in
    Perfetto or chrome://tracing) that also holds the program spans
    recorded in the block. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    # the profiler's timestamps are microseconds after its base time (ns)
    base = int(doc.get("baseTimeNanoseconds", 0))
    doc["traceEvents"].extend(_span_events(tracing.within(tracing.spans(), t0, time.time_ns()),
                                           base))
    path.write_text(json.dumps(doc))
