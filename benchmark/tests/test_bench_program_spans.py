"""The readers of the program's spans on hand-made span lists: what lies
outside the window is left out, and a run with nothing recorded reads
None."""
import pytest
import torch

from benchmark.harness import registry, runner
from mockingbird_tpu_torch import tracing

MS = 1_000_000
READERS = ("tacotron.step_host_ms", "tacotron.step_wait_ms", "pipeline.host_ms_per_call",
           "wavernn.host_ms_per_launch")


def _run(window=(100 * MS, 1000 * MS)):
    cell = registry.cell("tts-wavernn.b16-f800")
    run = runner.Run("tts-wavernn.b16-f800", cell["config"], cell["traffic"],
                     torch.device("cpu"), 1.0)
    # the benchmark's own spans: (name, start s, end s, start ns, end ns)
    run.spans = [("call", 0.1, 0.5, 100 * MS, 500 * MS), ("window", 0.1, 1.0, *window)]
    return run


class _Calls:
    """Hand-made ``tts_batch`` trees, each at ``t0`` (ms): two decoder steps
    of 3 ms, each waiting 1 ms; 5 ms of host work in the four host spans;
    two K1 launches, each followed by a 4 ms finalize."""

    def __init__(self):
        self.spans, self.next_id = [], 1

    def add(self, name, t0, t1, parent=None, call=None, **attrs):
        s = tracing.Span(name, int(t0 * MS), int(t1 * MS), id=self.next_id, parent=parent,
                         call=call or self.next_id, attrs=attrs or None)
        self.next_id += 1
        self.spans.append(s)
        return s

    def call(self, t0, steps_run=2):
        root = self.add("tts_batch", t0, t0 + 100, texts=16, fused=0)
        kid = dict(parent=root.id, call=root.id)
        self.add("pipeline.embed", t0 + 1, t0 + 2, **kid)
        self.add("tacotron.text", t0 + 2, t0 + 4, **kid)
        decode = self.add("tacotron.decode", t0 + 4, t0 + 20, batch=16, steps_asked=2,
                          steps_run=steps_run, **kid)
        for k in range(2):
            step = self.add("tacotron.step", t0 + 5 + 3 * k, t0 + 8 + 3 * k, parent=decode.id,
                            call=root.id)
            self.add("tacotron.step_wait", t0 + 7 + 3 * k, t0 + 8 + 3 * k, parent=step.id,
                     call=root.id)
        self.add("tacotron.to_host", t0 + 20, t0 + 21, **kid)
        for k in range(2):
            self.add("k1.launch", t0 + 30 + 20 * k, t0 + 31 + 20 * k, F=186, T=2400, **kid)
            self.add("wavernn.finalize", t0 + 40 + 20 * k, t0 + 44 + 20 * k, **kid)
        self.add("pipeline.unpack", t0 + 90, t0 + 91, **kid)
        return self


def _read(monkeypatch, found, run=None):
    monkeypatch.setattr(tracing, "spans", lambda: list(found))
    run = run or _run()
    return {m: registry.reader(m).read(run) for m in READERS}


def test_readers_on_hand_made_calls(monkeypatch):
    found = _Calls().call(200).call(400).spans
    got = _read(monkeypatch, found)
    assert got["tacotron.step_host_ms"] == pytest.approx(2.0)     # 3 ms less 1 ms of wait
    assert got["tacotron.step_wait_ms"] == pytest.approx(1.0)
    assert got["pipeline.host_ms_per_call"] == pytest.approx(5.0)  # 1 + 2 + 1 + 1
    assert got["wavernn.host_ms_per_launch"] == pytest.approx(4.0)


def test_spans_outside_the_window_are_left_out(monkeypatch):
    inside = _Calls().call(200).call(400)
    # a call before the window and one after it, with other numbers
    outside = _Calls()
    outside.next_id = 1000
    for t0 in (0, 1100):
        outside.call(t0)
    for s in outside.spans:
        if s.name in ("tacotron.step_wait", "wavernn.finalize", "pipeline.embed"):
            s.end_ns += 5 * MS
    got = _read(monkeypatch, inside.spans + outside.spans)
    assert got == pytest.approx(_read(monkeypatch, inside.spans))
    assert got["tacotron.step_host_ms"] == pytest.approx(2.0)


def test_nothing_recorded_reads_none(monkeypatch):
    assert _read(monkeypatch, []) == dict.fromkeys(READERS)
    # spans, but all of them before the window
    assert _read(monkeypatch, _Calls().call(0).spans, _run((500 * MS, 1000 * MS))) == \
        dict.fromkeys(READERS)
    # no window span: a run that was not traced
    run = _run()
    run.spans = []
    assert _read(monkeypatch, _Calls().call(200).spans, run) == dict.fromkeys(READERS)


def test_a_flagship_call_has_no_launch_to_read(monkeypatch):
    found = [s for s in _Calls().call(200).spans
             if s.name not in ("k1.launch", "wavernn.finalize", "tacotron.to_host")]
    got = _read(monkeypatch, found)
    assert got["wavernn.host_ms_per_launch"] is None
    assert got["pipeline.host_ms_per_call"] == pytest.approx(4.0)


def test_steps_counted_against_steps_run(monkeypatch):
    """A lost step span (the buffer overflowed) leaves the per-step host
    time unread rather than wrong."""
    found = _Calls().call(200, steps_run=3).spans
    got = _read(monkeypatch, found)
    assert got["tacotron.step_host_ms"] is None
    assert got["tacotron.step_wait_ms"] == pytest.approx(1.0)


def test_the_readers_read_nothing_without_the_recorder(monkeypatch):
    """On a tree without ``mockingbird_tpu_torch.tracing`` every reader
    returns None and raises nothing."""
    import builtins
    real = builtins.__import__

    def blocked(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "mockingbird_tpu_torch" and fromlist and "tracing" in fromlist:
            raise ImportError("no tracing here")
        return real(name, globals, locals, fromlist, level)
    monkeypatch.setattr(builtins, "__import__", blocked)
    run = _run()
    assert {m: registry.reader(m).read(run) for m in READERS} == dict.fromkeys(READERS)
