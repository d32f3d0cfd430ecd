"""The vits family: MockingBird's VITS, text to waveform in one
non-autoregressive pass, driven through the port's
``VoiceCloningPipeline(synthesizer="vits").tts_batch`` (the family
interface: ``benchmark/families/__init__.py``).

Weights: the generator's leaves in the flax layout (``leaves`` below, the
keys ``reference/vits.py`` reads), drawn by ``harness/weights.py`` at each
leaf's initialisation scale. The text embedding is N(0, 1/hidden) and the
relative-position embeddings N(0, 1/head width), as the model initialises
them; layers initialised to zero (the spline flows' and the couplings'
output projections) are drawn as any convolution, so that no flow is the
identity. One leaf is pinned: the duration predictor's last reverse flow,
the element-wise affine, gets log-scale 0 and shift −ln d, with d the
configuration's ``duration_scale``, so that the durations come out at a
speaking pace (``"fill=<value>"`` kinds, ``SHAPES``).

The system: the pipeline built from the written files, with the
benchmark's wrappers on the model's instances: spans around the text
encoder, the duration predictor and the flows (``front``) and around the
decoder (``decoder``), each ended by a synchronise in a traced run; and
captures of what the timed path hands on, kept on the device for the
check: the generator's state at each ``infer`` (from which the duration
and prior noise are drawn), the log-durations, and the durations the frames
were expanded with.

The comparison that decides ``correct``: two calls of the window drawn
from the seed, every text, against the plain reference
(``reference/vits.py``, float32 with TF32 off), which reads the same
weight file, works the symbol ids out itself and gets the program's noise
(drawn again from the captured generator state: duration noise (B, T_x,
2) first, then prior noise (B, max_frames, inter)).

* ``logw_err``: RMS(program − reference) / RMS(reference) of the
  log-durations over the real symbols of the sampled calls.
* ``dur_gap``: over the symbols whose duration (the ceil) differs between
  program and reference, the largest distance the reference's duration
  exp(logw) would have to move to take the program's ceil; 0 when none
  differ. A near-tie rule: the program's own rounding may flip a symbol
  whose duration lies within its error of an integer.
* ``wav_err``: the reference teacher-forced on the program's durations
  and prior noise, quantised to 16 bits as the program quantises:
  RMS(program − reference) / RMS(reference) over every returned sample of
  the sampled calls (a text whose length differs reads infinity).

A text whose PCM is not int16, is empty, or is not a whole number of hops
up to ``steps``·hop counts as failed. The control (``control.py``) is the
reference in bfloat16 in the program's place.
"""
from __future__ import annotations

import math
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..flops import vits as vits_flops
from ..harness import system as harness_system, traffic, weights
from ..harness.check import bucket
from ..reference import text as ref_text
from ..reference.hifigan import to_pcm16
from ..reference.ops import Prec
from ..reference.vits import Vits, infer

CHECK_CALLS = 2        # calls whose every text the reference checks
REF_CHUNK = 8          # texts the reference decodes at a time
TEXT_BUCKET = 16       # the port pads a batch's symbols to a multiple of this
LOWER = {"float32": "bfloat16"}
# the widths of the rehearsals on the CPU
TINY_VITS = dict(inter_channels=16, hidden_channels=16, filter_channels=32, n_heads=2,
                 n_layers=2, upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
                 upsample_initial_channel=32, resblock_kernel_sizes=[3],
                 resblock_dilation_sizes=[[1, 3]], spec_channels=65, hop_size=16,
                 n_speakers=4, gin_channels=16, emotion_channels=8, n_fft=128, win_size=128)


# -- weights ----------------------------------------------------------------

class _Shapes(dict):
    """The kinds ``weights._shape`` lacks. Two take a number: ``"fill=<v>"``
    sets every element to v; ``"kernel*<s>"`` and ``"bias*<s>"`` draw a
    kernel or a bias at s times their usual scale."""

    def __contains__(self, kind) -> bool:
        return str(kind).startswith(("fill=", "kernel*", "bias*")) or dict.__contains__(self, kind)

    def __getitem__(self, kind):
        if str(kind).startswith("fill="):
            value = float(kind[5:])
            return lambda view, shape: view.fill_(value)
        if str(kind).startswith("kernel*"):
            s = float(kind[7:])
            return lambda view, shape: view.mul_(s * float(np.prod(shape[:-1])) ** -0.5)
        if str(kind).startswith("bias*"):
            s = float(kind[5:])
            return lambda view, shape: view.mul_(0.05 * s)
        return dict.__getitem__(self, kind)


SHAPES = _Shapes({
    "text_embed": lambda view, shape: view.mul_(shape[-1] ** -0.5),
    "rel_embed": lambda view, shape: view.mul_(shape[-1] ** -0.5),
    "ln_scale": lambda view, shape: view.mul_(0.1).add_(1.0),
    "ln_bias": lambda view, shape: view.mul_(0.1),
})


def _conv(out: list, key: str, k: int, c_in: int, c_out: int, bias: bool = True) -> None:
    out.append((f"params/{key}/kernel", (k, c_in, c_out), "kernel"))
    if bias:
        out.append((f"params/{key}/bias", (c_out,), "bias"))


def _wn(out: list, key: str, k: int, c_in: int, c_out: int) -> None:
    base = key.rsplit("/", 1)[-1]
    out += [(f"params/{key}_conv/kernel", (k, c_in, c_out), "wn_kernel"),
            (f"params/{key}_conv/bias", (c_out,), "bias"),
            (f"params/{key}/{base}_conv/kernel/scale", (c_out,), "wn_scale")]


def _norm(out: list, key: str, ch: int) -> None:
    out += [(f"params/{key}/scale", (ch,), "ln_scale"), (f"params/{key}/bias", (ch,), "ln_bias")]


def _wavenet(out: list, key: str, h: int, taps: int, layers: int, gin: int) -> None:
    _wn(out, f"{key}/cond_layer", 1, gin, 2 * h * layers)
    for i in range(layers):
        _wn(out, f"{key}/in_layers_{i}", taps, h, 2 * h)
        _wn(out, f"{key}/res_skip_layers_{i}", 1, h, 2 * h if i < layers - 1 else h)


def _dds(out: list, key: str, h: int, k: int, layers: int) -> None:
    for i in range(layers):
        _conv(out, f"{key}/convs_sep_{i}", k, 1, h)
        _norm(out, f"{key}/norm1_{i}", h)
        _conv(out, f"{key}/convs_1x1_{i}", 1, h, h)
        _norm(out, f"{key}/norm2_{i}", h)


def leaves(c: dict, duration_scale: float, spline_scale: float) -> list:
    """(key, shape, kind) of every leaf of the generator ``Vits`` (the text
    encoder, the posterior encoder, which inference does not run but the
    strict load asks for, the flows, the duration predictor, the decoder,
    the speaker table)."""
    out: list = []
    h, f, k, inter, gin = (c["hidden_channels"], c["filter_channels"], c["kernel_size"],
                           c["inter_channels"], c["gin_channels"])
    out.append(("params/enc_p/emb/embedding", (c["n_vocab"], h), "text_embed"))
    out += [("params/enc_p/emo_proj/kernel", (c["emotion_channels"], h), "kernel"),
            ("params/enc_p/emo_proj/bias", (h,), "bias")]
    for i in range(c["n_layers"]):
        key = f"enc_p/encoder/attn_{i}"
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _conv(out, f"{key}/{name}", 1, h, h)
        for name in ("emb_rel_k", "emb_rel_v"):
            out.append((f"params/{key}/{name}", (1, 9, h // c["n_heads"]), "rel_embed"))
        _norm(out, f"enc_p/encoder/norm1_{i}", h)
        _conv(out, f"enc_p/encoder/ffn_{i}/conv_1", k, h, f)
        _conv(out, f"enc_p/encoder/ffn_{i}/conv_2", k, f, h)
        _norm(out, f"enc_p/encoder/norm2_{i}", h)
    _conv(out, "enc_p/proj", 1, h, 2 * inter)
    _conv(out, "enc_q/pre", 1, c["spec_channels"], h)
    _wavenet(out, "enc_q/enc", h, 5, 16, gin)
    _conv(out, "enc_q/proj", 1, h, 2 * inter)
    for i in range(4):
        _conv(out, f"flow/coupling_{i}/pre", 1, inter // 2, h)
        _wavenet(out, f"flow/coupling_{i}/enc", h, 5, 4, gin)
        _conv(out, f"flow/coupling_{i}/post", 1, h, inter // 2)
    _conv(out, "dp/pre", 1, h, h)
    _conv(out, "dp/proj", 1, h, h)
    _dds(out, "dp/convs", h, k, 3)
    _conv(out, "dp/cond", 1, gin, h)
    out += [("params/dp/flow_affine/m", (2,), f"fill={-math.log(duration_scale)!r}"),
            ("params/dp/flow_affine/logs", (2,), "fill=0.0")]
    for prefix in ("flow", "post"):
        for i in range(4):
            key = f"dp/{prefix}_conv_{i}"
            _conv(out, f"{key}/pre", 1, 1, h)
            _dds(out, f"{key}/convs", h, k, 3)
            if prefix == "flow":
                out += [(f"params/{key}/proj/kernel", (1, h, 29), f"kernel*{spline_scale!r}"),
                        (f"params/{key}/proj/bias", (29,), f"bias*{spline_scale!r}")]
            else:
                _conv(out, f"{key}/proj", 1, h, 29)
    _conv(out, "dp/post_pre", 1, 1, h)
    _conv(out, "dp/post_proj", 1, h, h)
    _dds(out, "dp/post_convs", h, k, 3)
    out += [("params/dp/post_affine/m", (2,), "bias"), ("params/dp/post_affine/logs", (2,), "bias")]
    ch = c["upsample_initial_channel"]
    _conv(out, "dec/conv_pre", 7, inter, ch)
    _conv(out, "dec/cond", 1, gin, ch)
    for i, taps in enumerate(c["upsample_kernel_sizes"]):
        _wn(out, f"dec/ups_{i}", taps, ch, ch // 2)
        ch //= 2
        for j, (rk, rd) in enumerate(zip(c["resblock_kernel_sizes"], c["resblock_dilation_sizes"])):
            for n in range(len(rd)):
                _wn(out, f"dec/resblock_{i}_{j}/convs1_{n}", rk, ch, ch)
                _wn(out, f"dec/resblock_{i}_{j}/convs2_{n}", rk, ch, ch)
    _conv(out, "dec/conv_post", 7, ch, 1, bias=False)
    out.append(("params/emb_g/embedding", (c["n_speakers"], gin), "embed"))
    return out


def parts(cfg: dict) -> list:
    return [("vits", "synthesizer_vits.npz",
             leaves(cfg["vits"], cfg["duration_scale"], cfg["spline_scale"]))]


# -- the system -------------------------------------------------------------

@dataclass
class Chunk:
    """What one ``infer`` of the timed path handed on: the generator's
    state before its draws, the log-durations (B, T_x) and the durations
    (B, T_x) it expanded the prior with, and its frame count."""
    state: torch.Tensor
    logw: torch.Tensor
    durations: torch.Tensor
    max_frames: int


@dataclass
class CallOut:
    texts: List[str]
    voice: Path
    pcm: List[np.ndarray]
    chunks: List[Chunk] = field(default_factory=list)


@dataclass
class System:
    pipe: object
    rec: harness_system.Recorder
    voices: List[Path]
    mix: dict
    seed: int
    kwargs: dict


def write_inputs(mix: dict, seed: int, out_dir: Path) -> List[Path]:
    """The mix's reference voices."""
    return traffic.write_voices(mix, seed, out_dir)


def build(cfg: dict, mix: dict, paths: Dict[str, object], voices: List[Path],
          device: torch.device, seed: int, rec: harness_system.Recorder) -> System:
    """The VITS pipeline on ``device``, its weights loaded from ``paths``;
    ``rec`` gets the captures and spans."""
    from mockingbird_tpu_torch.pipeline import VoiceCloningPipeline

    pipe = VoiceCloningPipeline(synthesizer="vits", synthesizer_fpath=paths["vits"],
                                verbose=False, seed=weights.seed_of(seed, 3), device=device)
    model = pipe.synthesizer.model

    def span(name):
        def around(inner, *args, **kwargs):
            with rec.span(name):
                return inner(*args, **kwargs)
        return around

    def duration(inner, *args, **kwargs):
        with rec.span("front"):
            logw = inner(*args, **kwargs)
        rec.captures["logw"].append(logw[..., 0])
        return logw

    def infer(inner, *args, **kwargs):
        gen = kwargs.get("generator")
        rec.captures["infer"].append((gen.get_state(), kwargs.get("max_len")))
        return inner(*args, **kwargs)

    def expand(inner, w_ceil, *args, **kwargs):
        rec.captures["durations"].append(w_ceil[..., 0])
        return inner(w_ceil, *args, **kwargs)

    harness_system.wrap(model.enc_p, "forward", span("front"))
    harness_system.wrap(model.dp, "forward", duration)
    harness_system.wrap(model.flow, "forward", span("front"))
    harness_system.wrap(model.dec, "forward", span("decoder"))
    harness_system.wrap(model, "infer", infer)
    harness_system.wrap(model, "infer_from_durations", expand)
    return System(pipe, rec, voices, mix, seed, dict(mix["tts_batch"]))


def kernels(cfg: dict, device: torch.device) -> None:
    """None: VITS inference launches none of the port's own kernels."""


# -- warm-up and call -------------------------------------------------------

def warm(s: System) -> None:
    """Every voice's embedding, cached by the pipeline."""
    for v in s.voices:
        s.pipe.embed_reference(str(v))


def draw(mix: dict, seed: int, i: int) -> List[str]:
    return traffic.texts(mix, seed, i)


def call(s: System, texts: List[str], i: int) -> CallOut:
    """One ``tts_batch`` call of ``texts`` in call ``i``'s voice."""
    rec = s.rec
    voice = s.voices[traffic.voice_of(s.mix, s.seed, i)]
    n = len(rec.captures["infer"])
    with rec.span("call"):
        pcm = s.pipe.tts_batch(texts, str(voice), **s.kwargs)
    chunks = [Chunk(state, logw, dur, frames) for (state, frames), logw, dur in
              zip(rec.captures["infer"][n:], rec.captures["logw"][n:],
                  rec.captures["durations"][n:])]
    return CallOut(texts, voice, pcm, chunks)


# -- accounting -------------------------------------------------------------

def attempted(out: CallOut) -> int:
    return len(out.texts)


def samples(out: CallOut) -> int:
    return sum(len(w) for w in out.pcm)


def sample_rate(cfg: dict) -> int:
    return cfg["vits"]["sample_rate"]


def _batches(run):
    """(texts, symbols padded, frames) of every batch the window's calls
    ran, as the pipeline chunks them."""
    tb = run.mix["tts_batch"]
    size = tb.get("batch_size", 32)
    for out in run.calls:
        for a in range(0, len(out.texts), size):
            texts = out.texts[a:a + size]
            t_text = bucket(max(len(traffic.symbol_ids(t)) for t in texts), TEXT_BUCKET)
            yield len(texts), t_text, tb["steps"]


def decoder_flops(run) -> float:
    """The decoder's convolution FLOP of every call in the window."""
    return sum(vits_flops.decoder(run.cfg["vits"], b, frames) for b, _, frames in _batches(run))


def model_flops(run) -> float:
    """FLOP of every call in the window (``benchmark/flops/vits.py``)."""
    return sum(vits_flops.call(run.cfg["vits"], b, t, frames) for b, t, frames in _batches(run))


def counters() -> Dict[str, int]:
    """The port's frame counters (none in a port that lacks them)."""
    try:
        from mockingbird_tpu_torch.models.vits import inference
    except ImportError:
        return {}
    if not hasattr(inference, "counts"):
        return {}
    return {f"vits_{k}": int(v) for k, v in inference.counts().items()}


def failed(cfg: dict, mix: dict, calls: List[CallOut]) -> int:
    hop = cfg["vits"]["hop_size"]
    most = mix["tts_batch"]["steps"] * hop
    n = 0
    for out in calls:
        for j in range(len(out.texts)):
            w = out.pcm[j] if j < len(out.pcm) else None
            n += int(w is None or w.dtype != np.int16 or w.ndim != 1 or not 0 < len(w) <= most
                     or len(w) % hop != 0)
    return n


# -- checking ---------------------------------------------------------------

def _inputs(texts: List[str], t_text: int, cfg: dict, device):
    ids = torch.zeros(len(texts), t_text, dtype=torch.int64)
    lengths = []
    for j, t in enumerate(texts):
        s = ref_text.symbol_ids(t)
        ids[j, :len(s)] = torch.tensor(s)
        lengths.append(len(s))
    c = cfg["vits"]
    return (ids.to(device), torch.tensor(lengths, device=device),
            torch.zeros(len(texts), dtype=torch.int64, device=device),
            torch.zeros(len(texts), c["emotion_channels"], device=device))


def _noise(state: torch.Tensor, b: int, t_text: int, frames: int, inter: int, device):
    """The duration and prior noise an ``infer`` drew from ``state``."""
    gen = torch.Generator(device=device)
    gen.set_state(state)
    dur = torch.randn((b, t_text, 2), generator=gen, device=device)
    return dur, torch.randn((b, frames, inter), generator=gen, device=device)


def numbers(cfg: dict) -> set:
    return {"logw_err", "dur_gap", "wav_err"}


def readings(cfg: dict, mix: dict, paths: Dict[str, Path], device, calls: List[CallOut],
             seed: int) -> Dict[str, float]:
    """The numbers compared with the configuration's limits."""
    c, inf = cfg["vits"], cfg["inference"]
    net = Vits(weights.read(paths["vits"], device), c, Prec("float32"))
    hop = c["hop_size"]
    rng = random.Random(f"{seed}/check")
    picked = sorted(rng.sample(range(len(calls)), min(CHECK_CALLS, len(calls))))
    sq = {"logw": 0.0, "logw_ref": 0.0, "wav": 0.0, "wav_ref": 0.0}
    gap, bad = 0.0, False
    t = time.perf_counter()
    texts_done = 0
    for i in picked:
        call = calls[i]
        start = 0
        for ch in call.chunks:
            b, t_text = ch.logw.shape
            texts = call.texts[start:start + b]
            ids, lengths, sid, emo = _inputs(texts, t_text, cfg, device)
            dur_noise, prior = _noise(ch.state, b, t_text, ch.max_frames, c["inter_channels"],
                                      device)
            with torch.no_grad():
                hidden, m_p, logs_p, mask = net.encode(ids, lengths, emo)
                g = net.speaker(sid)
                logw = net.log_durations(hidden, mask, g, dur_noise, inf["noise_scale_w"])
            real = mask > 0
            prog = ch.logw.float().to(device)
            sq["logw"] += float(((prog - logw)[real] ** 2).sum())
            sq["logw_ref"] += float((logw[real] ** 2).sum())
            d_ref = torch.exp(logw) * inf["length_scale"]
            c_ref = torch.ceil(d_ref)
            c_prog = ch.durations.float().to(device)
            diff = real & (c_ref != c_prog)
            if diff.any():
                move = torch.where(c_prog > c_ref, (c_prog - 1) - d_ref, d_ref - c_prog)
                gap = max(gap, float(move[diff].max()))
            for a in range(0, b, REF_CHUNK):
                sl = slice(a, a + REF_CHUNK)
                with torch.no_grad():
                    m_f, logs_f, frames = net.expand(m_p[sl], logs_p[sl], c_prog[sl],
                                                     ch.max_frames)
                    wav = net.waveform(m_f, logs_f, frames, prior[sl], inf["noise_scale"],
                                       g[sl])
                want = to_pcm16(wav).cpu().numpy().astype(np.float64)
                for j, n in enumerate(frames.tolist()):
                    got = call.pcm[start + a + j]
                    if got.shape != (n * hop,):
                        bad = True
                        continue
                    sq["wav"] += float(np.sum((got - want[j, :n * hop]) ** 2))
                    sq["wav_ref"] += float(np.sum(want[j, :n * hop] ** 2))
            start += b
            texts_done += b
    print(f"check: VITS reference of {texts_done} texts in {time.perf_counter() - t:.3f} s",
          file=sys.stderr)
    return {"logw_err": math.sqrt(sq["logw"] / max(sq["logw_ref"], 1e-30)),
            "dur_gap": gap,
            "wav_err": math.inf if bad else math.sqrt(sq["wav"] / max(sq["wav_ref"], 1e-30))}


def control_calls(cfg: dict, mix: dict, seed: int, n_calls: int, device, paths, voices):
    """The calls' outputs from the reference in bfloat16, with the noise
    the program would draw (the pipeline's seeded generator)."""
    c, inf = cfg["vits"], cfg["inference"]
    low = Vits(weights.read(paths["vits"], device), c, Prec(LOWER[cfg["precision"]["vits"]]))
    tb = mix["tts_batch"]
    size, frames = tb.get("batch_size", 32), tb["steps"]
    hop = c["hop_size"]
    calls = []
    for i in range(n_calls):
        texts = traffic.texts(mix, seed, i)
        voice = voices[traffic.voice_of(mix, seed, i)]
        out = CallOut(texts, voice, [])
        for a in range(0, len(texts), size):
            chunk = texts[a:a + size]
            t_text = bucket(max(len(ref_text.symbol_ids(t)) for t in chunk), TEXT_BUCKET)
            ids, lengths, sid, emo = _inputs(chunk, t_text, cfg, device)
            gen = torch.Generator(device=device).manual_seed(weights.seed_of(seed, 3))
            state = gen.get_state()
            dur_noise, prior = _noise(state, len(chunk), t_text, frames, c["inter_channels"],
                                      device)
            with torch.no_grad():
                logw, durations, counts, wav = infer(
                    low, ids, lengths, sid, emo, dur_noise, prior, frames,
                    inf["noise_scale"], inf["noise_scale_w"], inf["length_scale"])
            pcm = to_pcm16(wav).cpu().numpy()
            out.pcm += [pcm[j, :n * hop] for j, n in enumerate(counts.tolist())]
            out.chunks.append(Chunk(state, logw, durations, frames))
        calls.append(out)
    return calls


def tiny(cfg: dict, mix: dict, texts: int, steps: int):
    """``cfg`` and ``mix`` cut in place for a rehearsal on the CPU: every
    width, a few texts of ``steps`` frames a call, two voices."""
    cfg["vits"].update(TINY_VITS)
    mix["texts_per_call"], mix["voices"] = texts, 2
    mix["tts_batch"]["steps"] = steps
    mix["tts_batch"]["batch_size"] = texts
    return cfg, mix
