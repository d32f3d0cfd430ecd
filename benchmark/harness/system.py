"""The system under test: the port's ``VoiceCloningPipeline`` built from the
written weights, and the benchmark's own wrappers on its instances.

Every run keeps what the timed path hands from one layer to the next, for
the check after the window: the mels the synthesizer returns (on the
device; the fused branch never copies them) and, through WaveRNN, the
labels of each sampler launch with its seed. A traced run also records a
span around each call into the synthesizer and the vocoder, ended by a
synchronise.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch


class Recorder:
    """Captures and spans of the calls made since ``reset``."""

    def __init__(self, device: torch.device, trace: bool):
        self.device, self.trace = device, trace
        self.reset()

    def reset(self) -> None:
        self.mels: List[object] = []        # per synthesizer call: device mels or host specs
        self.launches: List[tuple] = []     # per sampler launch: (seed, labels)
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


def _wrap(obj, method: str, around):
    inner = getattr(obj, method)

    def wrapped(*args, **kwargs):
        return around(inner, *args, **kwargs)
    setattr(obj, method, wrapped)


def build(cfg: dict, paths: Dict[str, object], device: torch.device, dropout_seed: int,
          rec: Recorder):
    """The pipeline of configuration ``cfg`` on ``device``, its weights
    loaded from ``paths``; ``rec`` gets the captures and spans."""
    from mockingbird_tpu_torch.pipeline import VoiceCloningPipeline

    vocoder = None
    if cfg["vocoder"]["arch"] == "wavernn":
        from mockingbird_tpu_torch.models.vocoder.wavernn import WaveRnnVocoder
        vocoder = WaveRnnVocoder(paths["vocoder"], cfg=cfg["vocoder"], verbose=False,
                                 device=device)
    pipe = VoiceCloningPipeline(encoder_fpath=paths["encoder"],
                                synthesizer_fpath=paths["synthesizer"],
                                vocoder_fpath=None if vocoder else paths["vocoder"],
                                vocoder=vocoder, verbose=False, seed=dropout_seed,
                                device=device)
    pipe.synthesizer.load()
    syn, voc = pipe.synthesizer, pipe.vocoder

    def synthesizer(inner, *args, **kwargs):
        with rec.span("tacotron"):
            out = inner(*args, **kwargs)
        rec.mels.append(out[0] if isinstance(out, tuple) else out)
        return out

    def vocoder_span(inner, *args, **kwargs):
        with rec.span("vocoder"):
            return inner(*args, **kwargs)

    def sampler(inner, mels_f, aux_f, seed, greedy):
        labels = inner(mels_f, aux_f, seed, greedy)
        rec.launches.append((seed, labels))
        return labels

    if hasattr(voc, "vocode_device"):
        _wrap(syn, "synthesize_mels_device", synthesizer)
        _wrap(voc, "vocode_device", vocoder_span)
    else:
        _wrap(syn, "synthesize_spectrograms", synthesizer)
        _wrap(voc, "infer_waveform_batch", vocoder_span)
        _wrap(voc, "_run_sampler", sampler)
    return pipe


def k1_launches() -> int:
    """The port's count of WaveRNN sampler launches (time-major layout)."""
    from mockingbird_tpu_torch.ops.wavernn_sample import wavernn_sample
    return int(wavernn_sample.launches)
