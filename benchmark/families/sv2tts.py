"""The sv2tts family: GE2E, Tacotron and a vocoder (HiFi-GAN, or WaveRNN
sampled by K1), driven through the port's ``VoiceCloningPipeline.tts_batch``
(the family interface: ``benchmark/families/__init__.py``).

Weights: GE2E, Tacotron and the vocoder in the flax layout of
``reference/layout.py``. The system: the pipeline built from them, with the
benchmark's wrappers on its instances, which keep what the timed path hands
from one layer to the next, for the check after the window: the mels the
synthesizer returns (on the device; the fused branch never copies them)
and, through WaveRNN, the labels of each sampler launch with its seed. A
traced run also records a span around each call into the synthesizer and
the vocoder, ended by a synchronise. Set-up builds K1 where the
configuration samples through it, and the warm-up embeds every voice (the
pipeline caches it, as it would for a returning user) before one call of
the cell's own shape.

The comparison that decides ``correct``: after the window, a sample of the
window's calls drawn from the seed is judged against the plain reference
(``benchmark/reference/``), which reads the same weight files and voice
wavs and works out everything else itself: symbol ids, speaker embeddings,
dropout masks, conditioning, fold plans and sampling noise.

* ``mel_err``: Tacotron, teacher-forced on the program's own frames (each
  step fed the frame the program fed itself), against those frames: the
  largest, over the sampled calls' texts, RMS(program − reference) /
  RMS(reference). It holds the text frontend, the speaker embedding, the
  encoder, the style token, the dropout draws and every decoder step.
* HiFi-GAN, ``pcm_err_excess``: the reference generator on the program's
  mels of a sample of texts, quantised to 16 bits, twice: in float32, the
  judge, and in bfloat16, the precision the configuration states for the
  generator (its weights held in bfloat16, the weight norm rounded as
  flax rounds it). The number is by how much the program's error against
  the float32 output exceeds the bfloat16 computation's: RMS(program −
  float32) / RMS(bfloat16 − float32) − 1, over all the sampled texts. The
  rounding the stated precision makes sets the error's size (13-38
  16-bit steps of RMS, as each seed's weights have it), so the error alone
  does not separate a sound program from one a step lower in precision.
* WaveRNN, ``label_gap``: one sampler launch of the sampled calls,
  teacher-forced on the program's labels: the widest gap by which a label's
  score (logits + the launch's Gumbel noise) lies below the best score of
  its step. ``pcm_lsb``: the reference output stage (crossfade, mu-law,
  de-emphasis, fade, 16 bits) on the program's labels of every sampled
  utterance, against the returned PCM: the largest difference in 16-bit
  steps; an exact comparison.

A text whose audio is missing or of the wrong length counts as failed.

The control (``control.py``) is the reference in the program's place one
precision below the configuration's: float32 parts in bfloat16, bfloat16
parts with float8 e4m3 products.
"""
from __future__ import annotations

import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import flops
from ..harness import system as harness_system, traffic, weights
from ..harness.check import bucket
from ..reference import audio, ge2e, hifigan, layout, text as ref_text, wavernn
from ..reference.ops import Prec, no_tf32
from ..reference.philox import gumbel
from ..reference.tacotron import Tacotron

HIFIGAN_ITEMS = 16     # texts vocoded by the reference per run
TACOTRON_CALLS = 2     # calls whose every text is decoded by the reference
CHECK_CALLS = TACOTRON_CALLS
LOWER = {"float32": "bfloat16", "bfloat16": "float8"}
# the widths of the rehearsals on the CPU (WaveRNN's folds 500 samples wide)
TINY_SYNTHESIZER = dict(embed_dims=32, encoder_dims=16, decoder_dims=16, lstm_dims=32,
                        postnet_dims=16, gst_E=16, gst_token_num=4, gst_num_heads=2,
                        gst_ref_filters=[4, 4, 8, 8, 8, 8])
TINY_HIFIGAN = dict(upsample_initial_channel=16)
TINY_WAVERNN = dict(rnn_dims=32, fc_dims=32, compute_dims=16, res_out_dims=16, res_blocks=1,
                    bits=5, gen_target_tpu=400, gen_overlap_tpu=50)


# -- weights ----------------------------------------------------------------

def parts(cfg: dict) -> list:
    """(part, file name, leaves) of a configuration."""
    voc = cfg["vocoder"]
    vocoder = layout.hifigan(voc) if voc["arch"] == "hifigan" else layout.wavernn(voc)
    return [("encoder", "encoder.npz", layout.ge2e(**cfg["encoder"])),
            ("synthesizer", "synthesizer.npz", layout.tacotron(cfg["synthesizer"])),
            ("vocoder", f"vocoder_{voc['arch']}.npz", vocoder)]


# -- the system -------------------------------------------------------------

@dataclass
class CallOut:
    """One call's texts and voice and what the timed path produced for it."""
    texts: List[str]
    voice: Path
    pcm: List[np.ndarray]
    mels: object                       # device mels (B, S, M), or specs [(M, T)]
    launches: List[tuple] = field(default_factory=list)   # (seed, labels (F, T))


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
                                vocoder=vocoder, verbose=False, seed=weights.seed_of(seed, 3),
                                device=device)
    pipe.synthesizer.load()
    syn, voc = pipe.synthesizer, pipe.vocoder

    def synthesizer(inner, *args, **kwargs):
        with rec.span("tacotron"):
            out = inner(*args, **kwargs)
        rec.captures["mels"].append(out[0] if isinstance(out, tuple) else out)
        return out

    def vocoder_span(inner, *args, **kwargs):
        with rec.span("vocoder"):
            return inner(*args, **kwargs)

    def sampler(inner, mels_f, aux_f, seed, greedy):
        labels = inner(mels_f, aux_f, seed, greedy)
        rec.captures["launches"].append((seed, labels))
        return labels

    if hasattr(voc, "vocode_device"):
        harness_system.wrap(syn, "synthesize_mels_device", synthesizer)
        harness_system.wrap(voc, "vocode_device", vocoder_span)
    else:
        harness_system.wrap(syn, "synthesize_spectrograms", synthesizer)
        harness_system.wrap(voc, "infer_waveform_batch", vocoder_span)
        harness_system.wrap(voc, "_run_sampler", sampler)
    return System(pipe, rec, voices, mix, seed, dict(mix["tts_batch"]))


def kernels(cfg: dict, device: torch.device) -> None:
    """K1, where the configuration samples through it."""
    if cfg["vocoder"]["arch"] == "wavernn" and device.type == "cuda":
        from mockingbird_tpu_torch.ops import build
        build.load("wavernn_sample")


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
    mels, launches = rec.captures["mels"], rec.captures["launches"]
    n_mels, n_launches = len(mels), len(launches)
    with rec.span("call"):
        pcm = s.pipe.tts_batch(texts, str(voice), **s.kwargs)
    return CallOut(texts, voice, pcm, mels[n_mels] if len(mels) > n_mels else None,
                   launches[n_launches:])


# -- accounting -------------------------------------------------------------

def attempted(out: CallOut) -> int:
    return len(out.texts)


def samples(out: CallOut) -> int:
    return sum(len(w) for w in out.pcm)


def sample_rate(cfg: dict) -> int:
    return cfg["vocoder"]["sample_rate"]


def decode_steps(run) -> int:
    """Tacotron's decoder steps in the window's calls."""
    steps = bucket(run.mix["tts_batch"]["steps"], 200)
    return len(run.calls) * steps // run.cfg["synthesizer"]["r"]


def model_flops(run) -> float:
    """FLOP of every call in the window (``benchmark/flops``)."""
    syn, voc = run.cfg["synthesizer"], run.cfg["vocoder"]
    steps = bucket(run.mix["tts_batch"]["steps"], 200)
    total = 0.0
    for out in run.calls:
        b = len(out.texts)
        t_text = bucket(max(len(traffic.symbol_ids(t)) for t in out.texts), 32)
        total += flops.tacotron(syn, b, t_text, steps // syn["r"])
        if voc["arch"] == "hifigan":
            total += flops.hifigan(voc, b, steps)
        else:
            total += flops.wavernn_upsampler(voc, b, bucket(steps, 100))
            total += sum(flops.k1(voc, lab.shape[0], lab.shape[1])[0]
                         for _, lab in out.launches)
    return total


def counters() -> Dict[str, int]:
    """The port's count of WaveRNN sampler launches (time-major layout)."""
    from mockingbird_tpu_torch.ops.wavernn_sample import wavernn_sample
    return {"k1_launches": int(wavernn_sample.launches)}


def failed(cfg: dict, mix: dict, calls: List[CallOut]) -> int:
    hop = cfg["vocoder"]["hop_size"]
    steps = bucket(mix["tts_batch"]["steps"], 200)
    n = 0
    for out in calls:
        specs = None if isinstance(out.mels, torch.Tensor) else out.mels
        for j in range(len(out.texts)):
            if j >= len(out.pcm) or out.pcm[j].dtype != np.int16:
                n += 1
                continue
            want = steps * hop if specs is None else (specs[j].shape[1] - 1) * hop
            n += int(out.pcm[j].shape != (want,))
    return n


# -- checking ---------------------------------------------------------------

class Reference:
    """The reference's weights, its per-part precisions (``p``: float32
    unless a control asks for lower) and the precisions the configuration
    states (``stated``)."""

    def __init__(self, cfg: dict, paths: Dict[str, Path], device, precision: Optional[dict] = None):
        no_tf32()
        self.cfg, self.device = cfg, device
        prec = precision or {}
        self.p = {k: Prec(prec.get(k, "float32")) for k in cfg["precision"]}
        self.stated = {k: Prec(v) for k, v in cfg["precision"].items()}
        self.w = {part: weights.read(path, device) for part, path in paths.items()}
        self._embeds: Dict[str, torch.Tensor] = {}

    def embed(self, voice: Path) -> torch.Tensor:
        if str(voice) not in self._embeds:
            self._embeds[str(voice)] = ge2e.embed_wav(self.w["encoder"], audio.read_wav(voice),
                                                      self.p["encoder"], self.device,
                                                      self.cfg["encoder"]["layers"])
        return self._embeds[str(voice)]

    def tacotron(self, texts: List[str], voice: Path, dropout_seed: int, steps: int,
                 teacher: Optional[torch.Tensor]) -> torch.Tensor:
        """Frames (B, steps, M); teacher-forced on ``teacher`` if given."""
        c = self.cfg["synthesizer"]
        ids = [ref_text.symbol_ids(t) for t in texts]
        arr = torch.zeros(len(ids), bucket(max(map(len, ids)), 32), dtype=torch.int64)
        for j, s in enumerate(ids):
            arr[j, :len(s)] = torch.tensor(s)
        net = Tacotron(self.w["synthesizer"], c, self.p["synthesizer"])
        spk = self.embed(voice)[None].expand(len(texts), -1)
        gen = torch.Generator(device=self.device).manual_seed(dropout_seed)
        memory, proj, mask = net.encode(arr.to(self.device), spk, gen)
        r = c["r"]
        return net.decode(memory, proj, mask, steps // r, r, gen, teacher)

    def wavernn_plan(self, frames: List[int]):
        """For one call's mel lengths: the folds of an utterance, the
        utterances of a sampler launch, and the frames every mel is padded
        to (the port's fold plan: folds of target + 2·overlap samples, at
        most ``max_lanes`` folds a launch, mels padded to 100-frame
        buckets)."""
        v = self.cfg["vocoder"]
        t_bucket = bucket(max(frames), 100)
        t_up = t_bucket * v["hop_size"]
        target, overlap = v["gen_target_tpu"], v["gen_overlap_tpu"]
        n = max((t_up - overlap) // (target + overlap), 0)
        n += int(t_up - (n * (target + overlap) + overlap) > 0)
        group = max(1, v["max_lanes"] // max(n, 1))
        return n, group, t_bucket

    def wavernn_cond(self, spec: np.ndarray, t_bucket: int):
        v = self.cfg["vocoder"]
        mel = (spec / v["mel_max_abs_value"]).T
        mel = np.pad(np.pad(mel, ((0, t_bucket - mel.shape[0]), (0, 0)), mode="edge"),
                     ((v["pad"], v["pad"]), (0, 0)))
        m, a = wavernn.conditioning(self.w["vocoder"], v, mel, self.p["upsampler"], self.device)
        return (wavernn.fold(m, v["gen_target_tpu"], v["gen_overlap_tpu"]),
                wavernn.fold(a, v["gen_target_tpu"], v["gen_overlap_tpu"]))

    def noise(self, seed: int, n_folds: int):
        c = 2 ** self.cfg["vocoder"]["bits"]
        return lambda t0, t1: gumbel(seed, t0, t1, 0, n_folds, c, self.device)


def _mels_of(out: CallOut, steps: int, n_mels: int, device):
    """The program's frames as (B, steps, M) on the device, and the frames
    each text kept."""
    if isinstance(out.mels, torch.Tensor):
        m = out.mels.float().to(device)
        return m, [m.shape[1]] * m.shape[0]
    full = torch.zeros(len(out.mels), steps, n_mels, device=device)
    kept = []
    for j, s in enumerate(out.mels):
        full[j, :s.shape[1]] = torch.from_numpy(np.ascontiguousarray(s.T)).to(device)
        kept.append(s.shape[1])
    return full, kept


def numbers(cfg: dict) -> set:
    """The names of the numbers ``readings`` compares."""
    return {"mel_err"} | ({"pcm_err_excess"} if cfg["vocoder"]["arch"] == "hifigan"
                          else {"label_gap", "pcm_lsb"})


def readings(cfg: dict, mix: dict, paths: Dict[str, Path], device, calls: List[CallOut],
             seed: int) -> Dict[str, float]:
    """The numbers compared with the configuration's limits."""
    ref = Reference(cfg, paths, device)
    return _readings(ref, mix, calls, seed, weights.seed_of(seed, 3))


def _readings(ref: Reference, mix: dict, calls: List[CallOut], seed: int,
              dropout_seed: int) -> Dict[str, float]:
    cfg, dev = ref.cfg, ref.device
    tb = mix["tts_batch"]
    if tb["min_stop_token"] < 10:
        raise ValueError("the reference decodes to the full length: min_stop_token must be >= 10")
    steps = bucket(tb["steps"], 200)
    rng = random.Random(f"{seed}/check")
    picked = sorted(rng.sample(range(len(calls)), min(TACOTRON_CALLS, len(calls))))
    out: Dict[str, float] = {"mel_err": 0.0}
    mels = {}
    t = time.perf_counter()
    for i in picked:
        call = calls[i]
        prog, kept = _mels_of(call, steps, cfg["synthesizer"]["n_mels"], dev)
        mine = ref.tacotron(call.texts, call.voice, dropout_seed, steps, prog)
        for j, k in enumerate(kept):
            d = prog[j, :k] - mine[j, :k]
            err = float(d.pow(2).mean().sqrt() / mine[j, :k].pow(2).mean().sqrt().clamp(min=1e-12))
            out["mel_err"] = max(out["mel_err"], err)
        mels[i] = (prog, kept)
    print(f"check: Tacotron of {len(picked)} calls in {time.perf_counter() - t:.3f} s",
          file=sys.stderr)
    t = time.perf_counter()
    voc = cfg["vocoder"]
    if voc["arch"] == "hifigan":
        items = [(i, j) for i in picked for j in range(len(calls[i].texts))]
        longest = max(items, key=lambda ij: len(calls[ij[0]].texts[ij[1]]))
        items = sorted({longest, *rng.sample(items, min(HIFIGAN_ITEMS, len(items)) - 1)})
        sq = {"program": 0.0, "bf16": 0.0}
        for a in range(0, len(items), 4):
            block = items[a:a + 4]
            mel = torch.stack([mels[i][0][j] for i, j in block])
            judge = hifigan.to_pcm16(hifigan.generate(ref.w["vocoder"], voc, mel, ref.p["vocoder"]))
            judge = judge.cpu().numpy().astype(np.float64)
            stated = hifigan.to_pcm16(hifigan.generate(ref.w["vocoder"], voc, mel,
                                                       ref.stated["vocoder"]))
            sq["bf16"] += float(np.sum((stated.cpu().numpy() - judge) ** 2))
            for (i, j), r in zip(block, judge):
                got = calls[i].pcm[j].astype(np.float64)
                sq["program"] += np.inf if got.shape != r.shape else float(np.sum((got - r) ** 2))
        out["pcm_err_excess"] = float(np.sqrt(sq["program"] / max(sq["bf16"], 1e-12)) - 1.0)
        print(f"check: HiFi-GAN of {len(items)} texts in {time.perf_counter() - t:.3f} s",
              file=sys.stderr)
        return out
    out["label_gap"], out["pcm_lsb"] = 0.0, 0.0
    launches = []
    for i in picked:
        call = calls[i]
        kept = mels[i][1]
        n_folds, group, t_bucket = ref.wavernn_plan(kept)
        width = voc["gen_target_tpu"] + 2 * voc["gen_overlap_tpu"]
        shapes = [(min(group, len(call.texts) - k) * n_folds, width)
                  for k in range(0, len(call.texts), group)]
        if [tuple(lab.shape) for _, lab in call.launches] != shapes:
            out["pcm_lsb"] = np.inf          # launches the fold plan does not make
            continue
        for k, (_, labels) in enumerate(call.launches):
            lab = labels.reshape(-1, n_folds, width).cpu().numpy()
            for u, utt in enumerate(range(k * group, min((k + 1) * group, len(call.texts)))):
                pcm = audio.wavernn_pcm(lab[u], voc["gen_overlap_tpu"], voc["bits"],
                                        (kept[utt] - 1) * voc["hop_size"], voc["hop_size"],
                                        voc["preemphasis"])
                got = call.pcm[utt]
                diff = (np.inf if got.shape != pcm.shape else
                        float(np.abs(got.astype(np.int64) - pcm.astype(np.int64)).max()))
                out["pcm_lsb"] = max(out["pcm_lsb"], diff)
            # the port seeds launch k with the index of its first utterance
            launches.append((i, k, k * group, labels, t_bucket, group))
    print(f"check: WaveRNN output stage in {time.perf_counter() - t:.3f} s", file=sys.stderr)
    t = time.perf_counter()
    if not launches:
        out["label_gap"] = np.inf
        return out
    i, k, lseed, labels, t_bucket, group = rng.choice(launches)
    call = calls[i]
    conds = [ref.wavernn_cond(call.mels[u], t_bucket)
             for u in range(k * group, min((k + 1) * group, len(call.texts)))]
    m = torch.cat([c[0] for c in conds])
    a = torch.cat([c[1] for c in conds])
    gaps = wavernn.run(ref.w["vocoder"], voc, m, a, ref.p["sampler"],
                       ref.noise(lseed, m.shape[0]), labels.to(dev))
    out["label_gap"] = float(gaps.max())
    print(f"check: one sampler launch of {m.shape[0]} folds in {time.perf_counter() - t:.3f} s",
          file=sys.stderr)
    return out


def control_calls(cfg: dict, mix: dict, seed: int, n_calls: int, device, paths, voices):
    """The calls' outputs from the reference at the lower precisions."""
    low = Reference(cfg, paths, device, {k: LOWER[v] for k, v in cfg["precision"].items()})
    voc = cfg["vocoder"]
    steps = bucket(mix["tts_batch"]["steps"], 200)
    calls = []
    for i in range(n_calls):
        texts = traffic.texts(mix, seed, i)
        voice = voices[traffic.voice_of(mix, seed, i)]
        mels = low.tacotron(texts, voice, weights.seed_of(seed, 3), steps, None)
        if voc["arch"] == "hifigan":
            pcm = []
            for a in range(0, len(texts), 8):
                wav = hifigan.generate(low.w["vocoder"], voc, mels[a:a + 8], low.p["vocoder"])
                pcm += list(hifigan.to_pcm16(wav).cpu().numpy())
            calls.append(CallOut(texts, voice, pcm, mels))
            continue
        specs = [m.T.cpu().numpy() for m in mels]
        n_folds, group, t_bucket = low.wavernn_plan([s.shape[1] for s in specs])
        launches, pcm = [], []
        for start in range(0, len(specs), group):
            conds = [low.wavernn_cond(s, t_bucket) for s in specs[start:start + group]]
            m = torch.cat([c[0] for c in conds])
            a = torch.cat([c[1] for c in conds])
            labels = wavernn.run(low.w["vocoder"], voc, m, a, low.p["sampler"],
                                 low.noise(start, m.shape[0]))
            launches.append((start, labels.to(torch.int32)))
            lab = labels.reshape(-1, n_folds, labels.shape[-1]).cpu().numpy()
            for u, s in enumerate(specs[start:start + group]):
                pcm.append(audio.wavernn_pcm(lab[u], voc["gen_overlap_tpu"], voc["bits"],
                                             (s.shape[1] - 1) * voc["hop_size"],
                                             voc["hop_size"], voc["preemphasis"]))
        calls.append(CallOut(texts, voice, pcm, specs, launches))
    return calls


def tiny(cfg: dict, mix: dict, texts: int, steps: int):
    """``cfg`` and ``mix`` cut in place for a rehearsal on the CPU: every
    width, a few texts of ``steps`` frames a call, two voices."""
    cfg["synthesizer"].update(TINY_SYNTHESIZER)
    cfg["vocoder"].update(TINY_HIFIGAN if cfg["vocoder"]["arch"] == "hifigan" else TINY_WAVERNN)
    mix["texts_per_call"], mix["voices"] = texts, 2
    mix["tts_batch"]["steps"] = steps
    if "batch_size" in mix["tts_batch"]:
        mix["tts_batch"]["batch_size"] = texts
    return cfg, mix
