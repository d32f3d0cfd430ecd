"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds:
  1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` gives it;
  2. the build of every CUDA kernel of the path with ``nvcc`` (sm_90a);
  3. the main path at the full width of the committed configurations, with
     weights made from a seed: ``VoiceCloningPipeline.tts_batch`` for three
     texts (English, Mandarin hanzi, tone-numbered pinyin) cloned from
     ``saved_models/gan_run/eval/ground_truth.wav`` through GE2E, Tacotron
     and the WaveRNN vocoder, ``steps`` capped at 200 (random weights never
     meet the stop rule). Every kernel's launch count is set to 0 just
     before and read just after; each kernel must have launched. Then a
     second, warm pass times each stage of the path;
  4. each kernel held against its plain PyTorch version on the card, on the
     very inputs the main path gave it, with the stated tolerance, and
     timed beside its plain version and a PyTorch yardstick;
  5. one ``kernels`` JSON line, then the contract line
     ``{"ok": true, "device": {...}}`` last.

Any failure raises and the script exits non-zero without the last line. It
needs a CUDA card; without one it exits non-zero before any phase.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mockingbird_tpu_torch.config import Config
from mockingbird_tpu_torch.models.vocoder import WaveRnnVocoder
from mockingbird_tpu_torch.models.vocoder import wavernn as wavernn_module
from mockingbird_tpu_torch.ops import build
from mockingbird_tpu_torch.ops.wavernn_sample import (pack_wavernn_weights, wavernn_sample,
                                                      wavernn_sample_plain)
from mockingbird_tpu_torch.pipeline import VoiceCloningPipeline

ROOT = Path(__file__).resolve().parent
REF_WAV = ROOT / "saved_models/gan_run/eval/ground_truth.wav"
TACOTRON_JSON = ROOT / "saved_models/attention_run/synthesizer.json"
WAVERNN_JSON = ROOT / "saved_models/wavernn_run/vocoder_wavernn.json"
TEXTS = ["this voice was cloned from a short reference recording",
         "欢迎使用语音克隆，今天天气很好",
         "ni3 hao3, zhe4 shi4 yi2 ge4 ce4 shi4"]
STEPS = 200
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# agreement, greedy and sampled: the first label where kernel and plain
# differ must fall on a step whose top-2 score gap (noise included) in the
# plain run is under this bound
GAP_F32 = 1e-3
GAP_BF16 = 5e-2


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"== {self.name}", flush=True)
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s", flush=True)
        return False


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def hold_labels(kernel: torch.Tensor, plain: torch.Tensor, gaps: torch.Tensor,
                bound: float, n_classes: int):
    """Per fold, the first step where the labels differ must be one whose
    plain top-2 gap (noise included) is under ``bound``. Returns (steps
    compared before the first difference, folds that never differ, the
    largest plain top-2 gap at a first difference, max |x_kernel - x_plain|
    over the steps before each fold's first near-tie, gap < ``bound``)."""
    diff = (kernel != plain).cpu().numpy()
    gaps = gaps.cpu().numpy()
    k, p = kernel.cpu().numpy(), plain.cpu().numpy()
    compared, full, worst, err = 0, 0, 0.0, 0.0
    for f in range(diff.shape[0]):
        where = np.flatnonzero(diff[f])
        end = int(where[0]) if len(where) else diff.shape[1]
        compared += end
        full += not len(where)
        if len(where):
            worst = max(worst, float(gaps[f, end]))
        near = np.flatnonzero(gaps[f] < bound)
        tie = int(near[0]) if len(near) else diff.shape[1]
        x_k = 2.0 * k[f, :tie].astype(np.float64) / (n_classes - 1) - 1.0
        x_p = 2.0 * p[f, :tie].astype(np.float64) / (n_classes - 1) - 1.0
        err = max(err, float(np.abs(x_k - x_p).max(initial=0.0)))
    check(worst < bound, f"a kernel label differs from the plain one at a step whose "
                         f"top-2 gap is {worst:.3g} >= {bound}")
    return compared, full, worst, err


def tv_distance(a: torch.Tensor, b: torch.Tensor, n_classes: int) -> float:
    ha = torch.bincount(a.flatten().long() * 64 // n_classes, minlength=64).double()
    hb = torch.bincount(b.flatten().long() * 64 // n_classes, minlength=64).double()
    return 0.5 * float((ha / ha.sum() - hb / hb.sum()).abs().sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # the plain versions are the reference: full float32 in matmuls and cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    with Phase("card"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        print(smi)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    with Phase("build"):
        report = build.build("wavernn_sample")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    with Phase("main path: VoiceCloningPipeline.tts_batch, full width"):
        pipe = VoiceCloningPipeline(vocoder=WaveRnnVocoder(verbose=False, seed=0, device=dev),
                                    verbose=False, seed=0, device=dev)
        pipe.synthesizer.load()
        for key, want in Config.from_json(TACOTRON_JSON).items():
            got = pipe.synthesizer.cfg[key]
            check(list(got) == list(want) if isinstance(want, list) else got == want,
                  f"Tacotron {key}={got}, committed config says {want}")
        for key, want in Config.from_json(WAVERNN_JSON).items():
            got = pipe.vocoder.cfg[key]
            check(list(got) == list(want) if isinstance(want, list) else got == want,
                  f"WaveRNN {key}={got}, committed config says {want}")
        # record the sampler's inputs for phase 4; the count stays the wrapper's
        captured = []

        def recording(weights, mels, aux, seed, n_classes=512, greedy=False):
            captured.append((mels, aux, seed, n_classes, greedy))
            return wavernn_sample(weights, mels, aux, seed, n_classes, greedy)

        wavernn_module.wavernn_sample = recording
        wavernn_sample.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs = pipe.tts_batch(TEXTS, REF_WAV, steps=STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"wavernn_sample": wavernn_sample.launches}
        wavernn_module.wavernn_sample = wavernn_sample
        print(f"  launches on the main path: {launches}")
        for name, n in launches.items():
            check(n > 0, f"kernel {name} was not launched on the main path")
        hop = pipe.vocoder.cfg.hop_size
        for text, w in zip(TEXTS, wavs):
            check(w.dtype == np.int16, f"waveform dtype {w.dtype}")
            check(0 < len(w) <= (STEPS - 1) * hop and len(w) % hop == 0,
                  f"waveform length {len(w)} for {text!r}")
            check(int(np.abs(w.astype(np.int32)).max()) > 0, "silent waveform")
        audio_s = sum(len(w) for w in wavs) / pipe.audio_cfg.sample_rate
        print(f"  {len(wavs)} int16 waveforms, samples {[len(w) for w in wavs]}, "
              f"{audio_s:.2f} s of audio in {wall:.2f} s wall")
        embed = pipe.embed_reference(REF_WAV)
        check(embed.shape == (256,) and abs(np.linalg.norm(embed) - 1) < 1e-4,
              "GE2E embedding is not a unit 256-vector")

    with Phase("stage breakdown: a second, warm pass of the main path's stages"):
        stages = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stages[name] = time.perf_counter() - t0
            return out

        pipe._embed_cache.clear()
        embed = timed("embed_reference", lambda: pipe.embed_reference(REF_WAV))
        specs = timed("synthesize_spectrograms", lambda: pipe.synthesizer.synthesize_spectrograms(
            TEXTS, np.tile(embed, (len(TEXTS), 1)), steps=STEPS))
        timed("infer_waveform_batch", lambda: pipe.vocoder.infer_waveform_batch(specs))
        for name, sec in stages.items():
            print(f"  {name}: {sec:.3f} s")
        print(f"  mel frames {[s.shape[1] for s in specs]}; "
              f"{stages['synthesize_spectrograms'] / (STEPS // 2) * 1e3:.2f} ms per decode "
              f"step if all {STEPS // 2} ran")

    with Phase("GE2E on the card against the CPU"):
        from mockingbird_tpu_torch.models.encoder import SpeakerEncoderInference
        cpu_enc = SpeakerEncoderInference(seed=0, device="cpu")
        cpu_enc.model.load_state_dict({k: v.cpu() for k, v in
                                       pipe.encoder.model.state_dict().items()})
        ref = cpu_enc.embed_utterance(cpu_enc.preprocess_wav(REF_WAV))
        err = float(np.abs(embed - ref).max())
        print(f"  max |card - cpu| = {err:.3g} (tolerance 1e-4)")
        check(err < 1e-4, f"GE2E embedding on the card differs from the CPU by {err}")

    with Phase("K1 wavernn_sample: kernel against its plain version"):
        check(len(captured) == 1, f"expected one sampler call, got {len(captured)}")
        mels, aux, seed, n_classes, _ = captured[0]
        f, t, _ = mels.shape
        print(f"  shapes from the main path: F={f} folds x T={t} steps, "
              f"mels {tuple(mels.shape)}, aux {tuple(aux.shape)}")
        model = pipe.vocoder.model
        w_bf16 = pipe.vocoder.packed
        w_f32 = pack_wavernn_weights(model, torch.float32)
        # the plain version draws the kernel's own Philox noise, so sampled
        # labels are held step by step as greedy ones are; the last mode is
        # the main path's own (bf16 weights, sampled, the main path's seed)
        max_abs_err = 0.0
        for label, w, greedy, bound in (("greedy f32", w_f32, True, GAP_F32),
                                        ("greedy bf16", w_bf16, True, GAP_BF16),
                                        ("sampled f32", w_f32, False, GAP_F32),
                                        ("sampled bf16", w_bf16, False, GAP_BF16)):
            k = wavernn_sample(w, mels, aux, seed, n_classes, greedy=greedy)
            p, gaps = wavernn_sample_plain(w, mels, aux, seed, n_classes, greedy=greedy,
                                           return_gaps=True)
            compared, full, worst, err = hold_labels(k, p, gaps, bound, n_classes)
            max_abs_err = max(max_abs_err, err)
            print(f"  {label}: {compared}/{f * t} steps equal before the first "
                  f"difference, {full}/{f} folds equal throughout, largest gap at a "
                  f"first difference {worst:.3g} (bound {bound})")
        print(f"  max |x_kernel - x_plain| before each fold's first near-tie: "
              f"{max_abs_err}")
        check(max_abs_err == 0.0, "labels differ before a fold's first near-tie")
        ks2 = wavernn_sample(w_bf16, mels, aux, seed + 1, n_classes)
        print(f"  sampled bf16 label histograms (64 bins), total variation: kernel/plain "
              f"{tv_distance(k, p, n_classes):.4f}, kernel seed/seed+1 "
              f"{tv_distance(k, ks2, n_classes):.4f}")
        check(torch.equal(k, wavernn_sample(w_bf16, mels, aux, seed, n_classes)),
              "sampled kernel is not deterministic for a fixed seed")

        # timings at the main path's shape and configuration (bf16, sampled)
        ms = cuda_ms(lambda: wavernn_sample(w_bf16, mels, aux, seed, n_classes), reps=3)
        plain_ms = cuda_ms(lambda: wavernn_sample_plain(w_bf16, mels, aux, seed, n_classes))
        # yardstick: one cuDNN GRU call over the same T x F with the sampler's
        # hidden width, teacher-forced (no sampling, no feedback)
        rnn = w_bf16["g1_wh"].shape[0]
        gru = torch.nn.GRU(rnn, rnn, device=dev, dtype=torch.bfloat16)
        xs = torch.randn(t, f, rnn, device=dev, dtype=torch.bfloat16)
        with torch.no_grad():
            library_ms = cuda_ms(lambda: gru(xs), reps=3)
        mm_params = sum(w_bf16[k].numel() for k in w_bf16 if k.endswith(("_w", "_wi", "_wh")))
        flops = 2.0 * mm_params * f * t
        n_bytes = (sum(v.numel() * v.element_size() for v in w_bf16.values())
                   + f * t * (mels.shape[2] + aux.shape[2]) * 2 + f * t * 4)
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        # blocks of 4 folds run side by side: one utterance's folds (a third
        # of the blocks) should take about as long per step as all of them
        f1 = f // len(TEXTS)
        ms_one = cuda_ms(lambda: wavernn_sample(w_bf16, mels[:f1], aux[:f1], seed, n_classes),
                         reps=3)
        print(f"  kernel with F={f1} (one utterance): {ms_one:.3f} ms")
        print(f"  kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN GRU yardstick "
              f"{library_ms:.3f} ms; bound {bound_ms:.4f} ms ({flops:.4g} FLOP, "
              f"{n_bytes:.4g} B); per step {ms / t * 1e3:.2f} us")

    kernels = [{
        "name": "wavernn_sample", "route": "cuda",
        "source": "mockingbird_tpu_torch/ops/csrc/wavernn_sample.cu",
        "replaces": "mockingbird_tpu/ops/wavernn_sample.py:138",
        "launches": launches["wavernn_sample"], "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }]
    print(f"== total: {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
