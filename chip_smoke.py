"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds:
  1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` gives it;
  2. the build of every CUDA kernel with ``nvcc`` (sm_90a), one ``nvcc`` per
     source, all started together;
  3. the TTS path at the full width of the committed configurations, with
     weights made from a seed: ``VoiceCloningPipeline.tts_batch`` for three
     texts (English, Mandarin hanzi, tone-numbered pinyin) cloned from
     ``saved_models/gan_run/eval/ground_truth.wav`` through GE2E, Tacotron
     and the WaveRNN vocoder, ``steps`` capped at 200 (random weights never
     meet the stop rule); then a second, warm pass times each stage;
  4. the flagship path, Tacotron → HiFi-GAN through ``tts_batch``'s fused
     branch: ``VoiceCloningPipeline(vocoder_fpath=None)`` (checked to build
     a HiFi-GAN ``GanVocoder``), its generator rebuilt from a seed at the
     width of ``saved_models/gan_run/vocoder_hifigan.json``, bf16 as
     ``GanVocoder`` defaults. Run 1: the three texts, int16, mulaw8 and
     float32 output. Run 2: ``bench.py``'s headline shape (batch 128,
     ``steps`` 400, ``min_stop_token`` 11), warm stage times ``ar_decode``,
     ``vocode``, ``d2h_fetch`` and ``e2e`` per format as ``bench.py`` takes
     them, then ``tts_batch`` in chunks of 32; RTF, peak device memory and
     the generator's FLOP count against the bf16 dense peak. Then the f32
     generator on the card (TF32 off) against the same model on the CPU,
     one Fre-GAN call at its stock config, and one
     ``VoiceCloningPipeline(synthesizer="vits").tts_batch`` call. No kernel
     is launched on this path;
  5. PPG one-shot voice conversion: ``make_voice_converter()`` at
     ``ppg_config()`` and the width of ``saved_models/ppg_run/ppg2mel.json``,
     seeded weights, the reference set from ``ground_truth.wav``, HiFi-GAN
     as in 4. Run A is ``bench.py``'s ``bench_ppg_vc`` workload where its
     sample recording is absent (8 crops of a 3 s 220 Hz tone), run B 8
     utterance-length sources (the reference wav tiled to 4.0-7.5 s: 400
     decode steps over a 192-group memory), both at ``stop_threshold`` 2.0:
     ``convert_wavs`` timed warm, then by stage (extract, host f0, encode,
     decode loop with the card's busy share, postnet, vocode). Then the
     f32 extractor (on run B's speech; run A's pure tone is shown beside
     the CPU's own f32-against-f64 spread, not held) and the teacher-forced
     decoder on the card against the CPU, and ``convert_files`` through
     HiFi-GAN into a temp dir, every wav read back. No kernel is launched;
  6. VITS serving: ``VitsSynthesizer`` at the width of
     ``saved_models/vits_run/config.json``, seeded weights, the three texts,
     ``max_frames`` 1000, float and int16 output, a warm pass by stage;
  7. VITS training: ``train`` for ``TRAIN_STEPS`` steps of batch 16 in bf16
     on a synthetic dataset whose one bucket is (900, 1000] frames with
     texts of 100-160 symbols, so the alignment search runs at its largest
     training shape (T_y 1000, T_x 160); the checkpoint it writes loads
     back; then the trainer's own step (``make_vits_step``) timed by part
     through module and optimizer hooks;
  8. Tacotron training at the width of
     ``saved_models/attention_run/synthesizer.json``, seeded weights, on a
     synthetic synthesizer dataset (24 utterances of 801-900 frames: one
     900-frame bucket, S = 450 decoder steps at r = 2; tone-numbered pinyin
     texts of 150-200 symbols, bucket 224; unit-norm 256-d embeddings):
     ``train`` for ``TACO_STEPS`` steps of batch 12 in bf16 (checkpoints,
     eval artifacts, the trained model exported by ``weights.to_flax`` and
     loaded by ``Synthesizer``), ``run_gta_synthesis`` over the 24
     utterances (every GTA mel's shape), the trainer's own step
     (``make_train_step``) timed warm by part through hooks, with the peak
     memory and the card's busy share in the decoder loop from a profiler
     trace, then one f32 batch (dropout and zoneout off, TF32 off) on the
     card against the CPU: loss and gradients. No kernel is launched;
  9. WaveRNN MOL at the width of ``saved_models/wavernn_run/vocoder_wavernn.json``
     with ``mode="MOL"``, seeded weights: ``infer_waveform`` of a 200-frame
     mel (7 folds of 8000 + 2·400, the step-by-step generator) timed warm,
     the generator on the card against the CPU with handed-in draws in f32,
     then ``load`` of a second export into a RAW vocoder: K1's output
     after the swap equals a fresh vocoder's. No kernel on the MOL path;
  10. GAN vocoder training at the width of ``vocoder_hifigan.json`` (rates
     8/8/4, 512 initial channels, hop 256, segment 8192, batch 16), seeded
     weights, bf16: ``gan_train.train(arch="hifigan")`` for ``GAN_STEPS``
     steps on a synthetic dataset of 40 utterances of 1-3 s (validation and
     a checkpoint at step 3; the checkpoint loads back), the trainer's step
     timed warm by part through hooks (generator forward; the
     discriminators' forward, backward and AdamW; the generator's mel loss,
     the discriminators' forward, backward and AdamW) with the peak memory
     and the convolutions' FLOPs (counted by hooks on the meta device)
     against the bf16 peak, one f32 step at batch 2 (learning rate 0, TF32
     off) on the card against the CPU (losses, gradients, spectral-norm
     ``u``/``sigma``), then ``train(arch="fregan")`` for ``FREGAN_STEPS``
     steps at ``fregan_config()``. No kernel on this path;
  11. WaveRNN training at the width of ``vocoder_wavernn.json`` (RAW 9-bit,
     rnn/fc 512, batch 100, ``seq_len`` 1280), seeded weights, bf16:
     ``wavernn_train.train`` for ``WAVERNN_STEPS`` steps on 100 synthetic
     utterances with GTA-style mels at hop 256, a checkpoint every 2 steps,
     each followed by ``gen_testset`` of 2 samples through K1 (its launches
     counted: at least one per sample); the last checkpoint's sampler
     weights are the trained model's, not the first's; K1 held against its
     plain version on the last sampler call of this path (its own folds,
     greedy and sampled, f32 and bf16 weights, bounds as in 21) and timed;
     one MOL step; the
     ``remat`` step against the plain one in f32 (TF32 off); the RAW step
     timed warm with its peak memory;
  12. GE2E training: ``preprocess_speaker_dirs`` over a synthetic corpus
     (64 speakers x 12 utterances of 2-4 s of a tone in bursts), then
     ``encoder.train.train`` at full width (3 x LSTM 256) and the default
     batch (64 speakers x 10 partials x 160 frames), bf16, seeded weights,
     for ``ENC_STEPS`` steps (checkpoints load back; the ``encoder.npz``
     export loads into ``SpeakerEncoderInference`` with equal embeddings);
     the trainer's step timed warm with its peak memory and busy share, the
     host sampler's time per batch; one f32 step at 8 x 5 (TF32 off) on the
     card against the CPU (loss, EER, gradients), and ``remat=True``
     against plain. No kernel on this path;
  13. ppg2mel training: ``preprocess_vc_dataset`` over 16 synthetic 2-5 s
     wavs through the card's seeded extractor and encoder (12 train, 2 dev,
     2 eval), then ``ppg.train.train`` at the width of
     ``saved_models/ppg_run/ppg2mel.json`` (10.34 M parameters), bf16,
     batch 8, ``PPG_STEPS`` steps with dev validation and the best
     checkpoint every 2; the trainer's step timed warm by part through
     hooks (the decoder loop's share), with its peak memory and busy share;
     one f32 training step (batch 2, dropout masks handed in, TF32 off) on
     the card against the CPU. No kernel on this path;
  14. the wav2vec2 emotion extractor at ``wav2emo_config()`` (12 x 1024
     pre-LN, 7 conv layers, about 164 M parameters), seeded weights, f32:
     ``extract_batch`` of 8 wavs of 2-6 s timed warm (s per batch, audio s
     per wall s, peak memory), one f32 hold of the card (TF32 off) against
     the CPU on 2 x 2 s by relative L2, then ``create_emotion_embeddings``
     over a synthetic 16-utterance synthesizer root, one file read back by
     the port's ``VitsDataset``. No kernel on this path;
  15. the server: the port's ``serve(port=0, block=False)`` on the card over
     a ``WebToolbox`` whose pipeline is seeded at the committed Tacotron and
     HiFi-GAN widths, with a small datasets root. ``/api/health``,
     ``/api/embed``, ``/api/synthesize_mel`` (200 steps), ``/api/vocode``
     with HiFi-GAN, WaveRNN (K1, launches counted) and Griffin-Lim; one
     ``/api/synthesize`` held against a direct ``tts_batch`` of the same
     text and embedding; 8 concurrent default ``/api/synthesize`` requests
     (the coalescer's dispatch count, each request's wall time, requests per
     second), every response held against a direct ``tts_batch`` of its own
     dispatch; ``/api/stream_tts`` (first chunk's latency, chunk count);
     ``/api/convert`` (PPG-VC); the peak memory. Every request has a
     timeout; the server is shut down after, and its coalescer with it. K1's
     call on the WaveRNN vocode is held against its plain version, greedy
     and sampled, f32 and bf16, as on the trainer's path; its error feeds
     K1's ``max_abs_err``;
  16. the CLI: ``python -m mockingbird_tpu_torch.cli tts`` in a subprocess
     with a timeout, seeded weights and the flagship's HiFi-GAN as an
     ``.npz`` export: the wav's sample rate and the CLI's RTF;
  17. data parallelism, one NCCL rank: ``python -m mockingbird_tpu_torch.cli
     launch --nprocs 1 -- train-vits`` in a subprocess with a timeout (the
     ``MB_*`` environment; ``--hparams`` give the committed VITS config) on
     phase 7's synthetic dataset, f32, ``PAR_STEPS`` steps of batch 16; the
     rank reports its K2 launches (``MB_RUN_REPORT``: one per step) and its
     logged losses are held against the same steps in this process within
     1e-5 relative, both runs with deterministic algorithms (under the
     defaults two runs of the same steps differ by ~1e-4 after 3); the
     step times of both;
  18. data parallelism, two ranks on the one card over gloo (NCCL refuses
     two ranks on one device), CUDA tensors, TF32 off, deterministic
     algorithms: ``GLOO_STEPS`` VITS
     steps of 8 rows per rank (``BucketBatcher``'s rank-strided rows) against
     one rank on the batch of 16, within 1e-5 relative; K2 once per step on
     each rank; the step times of both;
  19. the checkpoint importer: a reference-layout HiFi-GAN ``state_dict``
     (``weight_g``/``weight_v``, in a ``{"generator": ...}`` container) made
     from the flagship generator's seeded weights, ``cli import-checkpoint
     --family hifigan`` in a subprocess, the ``.npz`` (and its ``.json``
     sidecar) in ``GanVocoder`` on the card against the same generator from
     its flax tree, one mel, TF32 off, within 1e-5 of the output's peak;
  20. the unbatched WaveRNN generator: ``infer_waveform(batched=False)`` at
     the committed RAW width, seeded, on a mel of ``UNBATCHED_SECONDS``: one
     K1 launch at F=1 over the whole utterance (its launches counted), the
     call held against the plain version as in 11, and K1 timed at F=1 (ms
     and µs per step);
  21. each kernel held against its plain PyTorch version on the card, with
     the stated tolerance, and timed beside it: K1 (WaveRNN sampler) and K1b
     (its fold-major layout) on the TTS path's own inputs, then timed at
     one utterance's folds and at 4 folds per SM, with the launch plan, the
     cuDNN GRU yardstick as built and after ``flatten_parameters()``; K2
     (alignment search, exactly equal) on the training step's own inputs
     and on ragged, tied and band-less cases, timed per call with CUDA
     events, the kernel's own device time from a profiler trace beside it;
  22. one ``kernels`` JSON line (each kernel's launches summed over the
     paths that count them, the ranks' reports included), then the
     contract line
     ``{"ok": true, "device": {...}}`` last.

Every path is timed under PyTorch's defaults, which is what a caller of the
port gets (the port sets no global flag; cuDNN convolutions run in TF32);
the VITS paths are timed once more with TF32 off. TF32 is off only inside
``full_f32()``, around the holds against plain versions and the parity
checks. Every path is driven with the kernels' launch counts set to 0 just
before and read just after; each kernel of a path must have launched. Any
failure raises and the script exits non-zero without the last line. It
needs a CUDA card; without one it exits non-zero before any phase.
"""
from __future__ import annotations

import gc
import importlib
import io
import json
import random
import subprocess
import sys
import tempfile
import time
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

from mockingbird_tpu_torch.config import Config
from mockingbird_tpu_torch.models.tacotron import (Synthesizer, SynthesizerDataset, Tacotron,
                                                   collate_synthesizer, tacotron_config)
from mockingbird_tpu_torch.models.tacotron.train import (loss_of, make_train_step,
                                                         run_gta_synthesis)
from mockingbird_tpu_torch.models.tacotron.train import make_optimizer as taco_optimizer
from mockingbird_tpu_torch.models.tacotron.train import train as taco_train
from mockingbird_tpu_torch.models.tacotron import create_emotion_embeddings
from mockingbird_tpu_torch.models.tacotron.emotion import EmotionExtractor
from mockingbird_tpu_torch.models.wav2emo import wav2emo_config
from mockingbird_tpu_torch.models.vits import VitsSynthesizer, train as vits_train
from mockingbird_tpu_torch.models.vits import model as vits_model_module
from mockingbird_tpu_torch.models.vits.model import vits_config
from mockingbird_tpu_torch.models.vits.train import (BUCKET_BOUNDARIES, BucketBatcher,
                                                     VitsDataset, make_optimizer, make_vits_step)
from mockingbird_tpu_torch.dsp import decode_mulaw8_to_int16, load_wav, save_wav
from mockingbird_tpu_torch.models.encoder import SpeakerEncoderInference
from mockingbird_tpu_torch.models.encoder import model as encoder_model
from mockingbird_tpu_torch.models.encoder.dataset import (SpeakerBatchSampler,
                                                          SpeakerVerificationDataset)
from mockingbird_tpu_torch.models.ppg import MelDecoderMOLv2, PPGExtractor, ppg2mel_config
from mockingbird_tpu_torch.models.ppg.convert import preprocess_vc_dataset
from mockingbird_tpu_torch.models.layers import Conv1d, Conv2d, ConvTranspose1d
from mockingbird_tpu_torch.models.vocoder import (FreGanDiscriminators, GanVocoder, Generator,
                                                  HifiganDiscriminators, WaveRNN, WaveRnnVocoder,
                                                  fregan_config, hifigan_config, init_generator,
                                                  wavernn_config)
from mockingbird_tpu_torch.models.vocoder import wavernn as wavernn_module
from mockingbird_tpu_torch.models.vocoder.dataset import (MelDataset, collate_gan,
                                                          get_dataset_filelist)
from mockingbird_tpu_torch.models.vocoder.gan_train import make_gan_step
from mockingbird_tpu_torch.models.vocoder.gan_train import make_optimizer as gan_optimizer
from mockingbird_tpu_torch.models.vocoder.gan_train import train as gan_train
from mockingbird_tpu_torch.models.vocoder.wavernn_train import (WaveRnnDataset, collate_wavernn,
                                                                gen_testset, make_wavernn_step)
from mockingbird_tpu_torch.models.vocoder.wavernn_train import train as wavernn_train
from mockingbird_tpu_torch.ops import build
from mockingbird_tpu_torch.ops.monotonic_align import (maximum_path, maximum_path_cuda,
                                                       maximum_path_plain)
from mockingbird_tpu_torch.ops.wavernn_sample import (pack_wavernn_weights, plan, resident_blocks,
                                                      wavernn_sample, wavernn_sample_plain)
from mockingbird_tpu_torch.pipeline import VoiceCloningPipeline, make_voice_converter
from mockingbird_tpu_torch.serve import serve
from mockingbird_tpu_torch.serve.http import _wav_bytes
from mockingbird_tpu_torch.serve.toolbox import WebToolbox, read_audio
from mockingbird_tpu_torch.text import text_to_sequence
from mockingbird_tpu_torch.train.checkpoint import CheckpointManager
from mockingbird_tpu_torch.train.optim import clip_by_global_norm
from mockingbird_tpu_torch.train.precision import Policy
from mockingbird_tpu_torch.train.step import to_device
from mockingbird_tpu_torch.weights import save_npz, to_flax

taco_train_module = importlib.import_module("mockingbird_tpu_torch.models.tacotron.train")
enc_train = importlib.import_module("mockingbird_tpu_torch.models.encoder.train")
enc_preprocess = importlib.import_module("mockingbird_tpu_torch.models.encoder.preprocess")
ppg_train = importlib.import_module("mockingbird_tpu_torch.models.ppg.train")
wavernn_train_module = importlib.import_module("mockingbird_tpu_torch.models.vocoder.wavernn_train")

ROOT = Path(__file__).resolve().parent
REF_WAV = ROOT / "saved_models/gan_run/eval/ground_truth.wav"
TACOTRON_JSON = ROOT / "saved_models/attention_run/synthesizer.json"
WAVERNN_JSON = ROOT / "saved_models/wavernn_run/vocoder_wavernn.json"
VITS_JSON = ROOT / "saved_models/vits_run/config.json"
GAN_JSON = ROOT / "saved_models/gan_run/vocoder_hifigan.json"
PPG_JSON = ROOT / "saved_models/ppg_run/ppg2mel.json"
TEXTS = ["this voice was cloned from a short reference recording",
         "欢迎使用语音克隆，今天天气很好",
         "ni3 hao3, zhe4 shi4 yi2 ge4 ce4 shi4"]
STEPS = 200
DEVICE = "cuda"
KERNELS = ("wavernn_sample", "monotonic_align")
# VITS training: 16 utterances of 900-1000 frames (bucket (900, 1000]),
# texts of 100-160 symbols, the longest 160: T_y = 1000, T_x = 160
TRAIN_STEPS = 3
TRAIN_BATCH = 16
TRAIN_FRAMES = (901, 1000)
TRAIN_SYMBOLS = (100, 160)
VITS_CFG: dict = {}          # overrides of the committed config (none on the card)
# Tacotron training: 24 utterances of 801-900 frames (one 900-frame bucket,
# S = 450 decoder steps at r = 2), texts of 150-200 symbols (bucket 224)
TACO_UTTS = 24
TACO_FRAMES = (801, 900)
TACO_SYMBOLS = (150, 200)
TACO_SCHEDULE = ((2, 1e-3, 10_000, 12),)
TACO_STEPS = 4
TACO_CFG: dict = {}          # overrides of the committed config (none on the card)
MOL_FRAMES = 200
# bench.py's headline shape: batch 128 of one text, 400 decode steps with a
# stop threshold random weights never meet, tts_batch in chunks of 32
BENCH_TEXT = "ni3 hao3 shi4 jie4 zhe4 shi4 yi2 ge4 ce4 shi4 ju4 zi3"
BENCH_BATCH = 128
BENCH_STEPS = 400
BENCH_MIN_STOP = 11
BENCH_CHUNK = 32
GAN_CFG: dict = {}           # overrides of the committed sidecar (none on the card)
# PPG voice conversion: bench.py's bench_ppg_vc batch, and utterance-length
# sources of 4.0 to 7.5 s (800 decode frames over a 192-group memory)
VC_BATCH = 8
VC_REPS = 3
VC_B_SECONDS = tuple(4.0 + 0.5 * i for i in range(8))
# GAN vocoder training: 40 utterances of 1-3 s (a 95/5 split leaves 2 for
# validation), 4 steps with validation and a checkpoint at step 3; Fre-GAN
# 2 steps at its stock config
GAN_UTTS = 40
GAN_STEPS = 4
FREGAN_STEPS = 2
# WaveRNN training: 100 utterances of 1-2 s with GTA-style mels at hop 256,
# 4 steps, a checkpoint every 2 with gen_testset of 2 samples
WAVERNN_UTTS = 100
WAVERNN_SECONDS = (1.0, 2.0)
WAVERNN_STEPS = 4
WAVERNN_SAVE_EVERY = 2
WAVERNN_SAMPLES = 2
WAVERNN_TRAIN_CFG: dict = {}  # overrides of the committed config (none on the card)
# the GE2E trainer: a synthetic corpus of 64 speakers x 12 utterances of 2-4 s,
# the trainer's default batch (64 speakers x 10 partials of 160 frames)
ENC_SPEAKERS = 64
ENC_UTTS = 12
ENC_SECONDS = (2.0, 4.0)
ENC_BATCH = (64, 10)
ENC_STEPS = 4
ENC_F32_BATCH = (8, 5)
# the ppg2mel trainer: 16 synthetic utterances of 2-5 s (12 train, 2 dev,
# 2 eval by the id's last digit), batch 8
PPG_UTTS = 16
PPG_SECONDS = (2.0, 5.0)
PPG_BATCH = 8
PPG_STEPS = 4
# the emotion extractor: 8 wavs of 2-6 s per batch, warm batches timed; a
# 16-utterance synthesizer root for create_emotion_embeddings
EMO_SECONDS = tuple(2.0 + 4.0 * i / 7 for i in range(8))
EMO_REPS = 3
EMO_UTTS = 16
# the server: concurrent default /api/synthesize requests, one text each,
# and a /api/stream_tts text of three sentences of over 100 characters (the
# stream packs sentences into chunks of at most 140)
SERVE_CONCURRENT = 8
SERVE_TEXTS = ("ni3 hao3", "zai4 jian4", "xie4 xie4 ni3", "hello world", "good morning",
               "shi4 jie4 ni3 hao3", "this voice was cloned", "wo3 men5 zou3 ba5")
SERVE_STREAM_TEXT = (
    "this voice was cloned from a short reference recording and streamed back one sentence "
    "at a time. the first chunk of audio should arrive long before the whole text has been "
    "synthesized by the server! and the last sentence closes the stream, so that the client "
    "hears every chunk in the order it was written?")
# data parallelism: the VITS training phase's data and config, f32; 3 steps
# of one NCCL rank under launch, 2 steps of two gloo ranks on the one card;
# the unbatched WaveRNN generator on a mel of about 0.5 s
PAR_STEPS = 3
GLOO_STEPS = 2
UNBATCHED_SECONDS = 0.5
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# them, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# agreement, greedy and sampled: the first label where kernel and plain
# differ must fall on a step whose top-2 score gap (noise included) in the
# plain run is under this bound
GAP_F32 = 1e-3
GAP_BF16 = 5e-2


@contextmanager
def full_f32():
    """TF32 off in matmuls and cuDNN, restored after: the kernel-versus-plain
    holds and the parity checks compare against full f32. Every timed path
    runs under PyTorch's defaults, which is what a caller of the port gets
    (the port sets no global flag)."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=torch.backends.cudnn.deterministic,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


@contextmanager
def deterministic():
    """PyTorch's and cuDNN's deterministic algorithms, restored after, for
    the data-parallel holds: under the defaults two runs of the same 3 f32
    VITS steps in one process differ by ~1e-4 relative (atomics in the
    backward, Adam's normalised steps amplifying them), with these on by
    0 (``scripts/torch_gloo_gap.py --parts determinism``). Warn only: reflection padding's backward has no deterministic
    kernel, and its atomics add at most two values per element, which
    commute."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        benchmark=torch.backends.cudnn.benchmark,
                                        deterministic=True,
                                        allow_tf32=torch.backends.cudnn.allow_tf32):
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


# the same switch at the start of a process the smoke starts (a
# ``sitecustomize`` on its ``PYTHONPATH``)
DETERMINISTIC_SITE = """import torch
torch.use_deterministic_algorithms(True, warn_only=True)
torch.backends.cudnn.deterministic = True
"""


def tf32_state() -> str:
    return (f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
            f"cuDNN {torch.backends.cudnn.allow_tf32}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def zero_counts() -> None:
    wavernn_sample.launches = wavernn_sample.launches_fold_major = 0
    maximum_path_cuda.launches = 0


def read_counts() -> dict:
    """Each kernel's launches since ``zero_counts``."""
    return {"wavernn_sample": wavernn_sample.launches,
            "wavernn_sample(time_major=False)": wavernn_sample.launches_fold_major,
            "maximum_path": maximum_path_cuda.launches}


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


def device_ms(fn, kernel: str, reps: int = 20):
    """Device time of the CUDA kernels whose name contains ``kernel``, per
    call of ``fn``, from a ``torch.profiler`` trace of ``reps`` calls after
    one warm-up; None when the trace holds no such kernel. Unlike
    ``cuda_ms`` it leaves out the host's time between launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                 for e in events if kernel in e.key)
        if us > 0:
            return us / reps / 1e3
        print(f"  device_ms: no {kernel} in trace {attempt + 1} of 2, which holds "
              f"{len(events)} names: {[e.key[:40] for e in events][:8]}")
    return None


class Stages:
    """Host-clock seconds of named stages, each ended by a synchronise."""

    def __init__(self):
        self.s = {}

    def __call__(self, name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0
        return out

    def show(self):
        for name, sec in self.s.items():
            print(f"  {name}: {sec:.4f} s")


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


def hold_k1_call(w_f32, w_bf16, mels, aux, seed, n_classes) -> float:
    """K1 at one path's call against its plain version, greedy and sampled,
    in f32 and in bf16, with the near-tie rule of ``hold_labels``; prints
    each mode and returns K1's max |x_kernel - x_plain|, which must be 0."""
    f, t, _ = mels.shape
    k1_err = 0.0
    with full_f32():
        for label, w, greedy, bound in (("greedy f32", w_f32, True, GAP_F32),
                                        ("greedy bf16", w_bf16, True, GAP_BF16),
                                        ("sampled f32", w_f32, False, GAP_F32),
                                        ("sampled bf16", w_bf16, False, GAP_BF16)):
            p, gaps = wavernn_sample_plain(w, mels, aux, seed, n_classes, greedy=greedy,
                                           return_gaps=True)
            k = wavernn_sample(w, mels, aux, seed, n_classes, greedy=greedy)
            compared, full, worst, e = hold_labels(k, p, gaps, bound, n_classes)
            k1_err = max(k1_err, e)
            print(f"  K1 {label}: {compared}/{f * t} steps equal before the first "
                  f"difference, {full}/{f} folds equal throughout, largest gap at a first "
                  f"difference {worst:.3g} (bound {bound})")
    print(f"  max |x_kernel - x_plain| before each fold's first near-tie: {k1_err}")
    check(k1_err == 0.0, "labels differ before a fold's first near-tie")
    return k1_err


def tv_distance(a: torch.Tensor, b: torch.Tensor, n_classes: int) -> float:
    ha = torch.bincount(a.flatten().long() * 64 // n_classes, minlength=64).double()
    hb = torch.bincount(b.flatten().long() * 64 // n_classes, minlength=64).double()
    return 0.5 * float((ha / ha.sum() - hb / hb.sum()).abs().sum())


def check_config(name: str, got, committed) -> None:
    """Every key of the committed config (a path to its ``.json``, or the
    config itself) has its value in ``got``."""
    if not isinstance(committed, dict):
        committed = Config.from_json(committed)
    for key, want in committed.items():
        check(list(got[key]) == list(want) if isinstance(want, list) else got[key] == want,
              f"{name} {key}={got[key]}, committed config says {want}")


# ---------------------------------------------------------------------------
# the TTS path
# ---------------------------------------------------------------------------

def phase_tts(dev):
    with Phase("TTS path: VoiceCloningPipeline.tts_batch, full width"):
        pipe = VoiceCloningPipeline(vocoder=WaveRnnVocoder(verbose=False, seed=0, device=dev),
                                    verbose=False, seed=0, device=dev)
        pipe.synthesizer.load()
        check_config("Tacotron", pipe.synthesizer.cfg, TACOTRON_JSON)
        check_config("WaveRNN", pipe.vocoder.cfg, WAVERNN_JSON)
        # record the sampler's inputs for the K1 phase; the count stays the wrapper's
        captured = []

        def recording(weights, mels, aux, seed, n_classes=512, greedy=False):
            captured.append((mels, aux, seed, n_classes, greedy))
            return wavernn_sample(weights, mels, aux, seed, n_classes, greedy)

        wavernn_module.wavernn_sample = recording
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wavs = pipe.tts_batch(TEXTS, REF_WAV, steps=STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        wavernn_module.wavernn_sample = wavernn_sample
        print(f"  launches on the TTS path: {launches}")
        check(launches["wavernn_sample"] > 0, "K1 was not launched on the TTS path")
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

    with Phase("TTS stage breakdown: a second, warm pass"):
        st = Stages()
        pipe._embed_cache.clear()
        embed = st("embed_reference", lambda: pipe.embed_reference(REF_WAV))
        specs = st("synthesize_spectrograms", lambda: pipe.synthesizer.synthesize_spectrograms(
            TEXTS, np.tile(embed, (len(TEXTS), 1)), steps=STEPS))
        st("infer_waveform_batch", lambda: pipe.vocoder.infer_waveform_batch(specs))
        st.show()
        print(f"  mel frames {[s.shape[1] for s in specs]}; "
              f"{st.s['synthesize_spectrograms'] / (STEPS // 2) * 1e3:.2f} ms per decode "
              f"step if all {STEPS // 2} ran")

    with Phase("GE2E on the card against the CPU"):
        from mockingbird_tpu_torch.models.encoder import SpeakerEncoderInference
        cpu_enc = SpeakerEncoderInference(seed=0, device="cpu")
        cpu_enc.model.load_state_dict({k: v.cpu() for k, v in
                                       pipe.encoder.model.state_dict().items()})
        ref = cpu_enc.embed_utterance(cpu_enc.preprocess_wav(REF_WAV))
        with full_f32():
            pipe._embed_cache.clear()
            embed32 = pipe.embed_reference(REF_WAV)
        err = float(np.abs(embed32 - ref).max())
        print(f"  max |card - cpu| = {err:.3g} with TF32 off (tolerance 1e-4); under the "
              f"defaults {float(np.abs(embed - ref).max()):.3g}")
        check(err < 1e-4, f"GE2E embedding on the card differs from the CPU by {err}")
    return pipe, captured, launches


# ---------------------------------------------------------------------------
# the flagship path: Tacotron → HiFi-GAN through tts_batch's fused branch
# ---------------------------------------------------------------------------

def conv_flops(module, *inputs) -> float:
    """FLOPs of the convolutions of one ``module(*inputs)`` call (2 per
    multiply-add), counted by hooks from each conv's shapes: a conv's output
    elements times its kernel's (in/groups)·taps, a transposed conv's input
    elements times its out·taps. Run on the meta device it costs nothing."""
    total = [0.0]

    def hook(m, args, out):
        w = m.weight
        if isinstance(m, ConvTranspose1d):
            total[0] += 2.0 * args[0].numel() * w.shape[1] * w.shape[2]
        else:
            total[0] += 2.0 * out.numel() * float(np.prod(w.shape[1:]))

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (Conv1d, Conv2d, ConvTranspose1d))]
    with torch.no_grad():
        module(*inputs)
    for h in handles:
        h.remove()
    return total[0]


def mulaw_labels(pcm16: np.ndarray) -> np.ndarray:
    """mu-law-decoded int16 PCM back to its 8-bit labels (the table rises)."""
    lut = decode_mulaw8_to_int16(np.arange(256, dtype=np.uint8)).astype(np.int32)
    return np.searchsorted(lut, pcm16.astype(np.int32))


def device_split(fn, top: int = 4) -> str:
    """One warm call of ``fn`` traced by ``torch.profiler``: its CUDA
    kernels' device time by kind (cuDNN/cuBLAS products, cuDNN's layout
    transposes around them, element-wise, other), the top kernels, and the
    busy share of an untraced call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    if not kernels:
        return "device time not measured (the profiler trace holds no CUDA kernel)"
    kinds = {"products": 0.0, "layout transposes": 0.0, "element-wise": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        kind = ("layout transposes" if "nhwctonchw" in low or "nchwtonhwc" in low
                else "products" if any(w in low for w in ("gemm", "xmma", "conv", "cudnn",
                                                          "cutlass", "dgrad", "fprop"))
                else "element-wise" if "elementwise" in low else "other")
        kinds[kind] += ms
    busy = sum(kinds.values())
    tops = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return (f"device {busy:.2f} ms of {wall * 1e3:.2f} ms wall (busy {100 * busy / 1e3 / wall:.0f}%"
            f"): " + ", ".join(f"{k} {v:.2f} ms" for k, v in kinds.items())
            + "; top: " + "; ".join(f"{n[:60]} {ms:.2f} ms" for n, ms in tops))


def phase_hifigan_tts(dev):
    pipe = VoiceCloningPipeline(vocoder_fpath=None, verbose=False, seed=0, device=dev)
    check(isinstance(pipe.vocoder, GanVocoder) and pipe.vocoder.arch == "hifigan"
          and pipe.vocoder.half, "the default pipeline's vocoder is not a bf16 HiFi-GAN")
    # seeded weights at the trained export's width (its sidecar's config)
    pipe.vocoder = voc = GanVocoder("hifigan", cfg=dict(Config.from_json(GAN_JSON), **GAN_CFG),
                                    verbose=False, seed=0, device=dev)
    syn = pipe.synthesizer
    hop, sr = voc.cfg.hop_size, pipe.audio_cfg.sample_rate

    def staged(texts, embeds, steps, min_stop, fmt):
        """bench.py's fenced stages: one decode of the whole batch, one
        generator call, one copy (mulaw8 decoded on the host inside it)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mels_dev, frame_lens = syn.synthesize_mels_device(texts, embeds,
                                                          min_stop_token=min_stop, steps=steps)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pcm_dev = voc.vocode_device(mels_dev, pcm_format=fmt)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pcm = pcm_dev.cpu().numpy()
        if fmt == "mulaw8":
            pcm = decode_mulaw8_to_int16(pcm)
        lens = frame_lens.cpu().numpy()
        t3 = time.perf_counter()
        wavs = [pcm[j, : int(lens[j]) * hop] for j in range(len(texts))]
        return dict(ar_decode=t1 - t0, vocode=t2 - t1, d2h_fetch=t3 - t2, e2e=t3 - t0), wavs

    def show(st, audio_s):
        return (", ".join(f"{k} {v:.4f} s" for k, v in st.items())
                + f"; RTF {audio_s / st['e2e']:.1f}, compute RTF "
                f"{audio_s / (st['ar_decode'] + st['vocode']):.1f}")

    with Phase("HiFi-GAN TTS path: VoiceCloningPipeline(vocoder_fpath=None).tts_batch, fused"):
        check_config("HiFi-GAN", voc.cfg, GAN_JSON)
        n_params = sum(p.numel() for p in voc.model.parameters())
        print(f"  generator: rates {voc.cfg.upsample_rates}, kernels "
              f"{voc.cfg.upsample_kernel_sizes}, {voc.cfg.upsample_initial_channel} initial "
              f"channels, hop {hop}, {n_params} parameters in "
              f"{next(voc.model.parameters()).dtype}")
        zero_counts()
        outs = {}
        for fmt in ("int16", "mulaw8", "float32"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[fmt] = pipe.tts_batch(TEXTS, REF_WAV, steps=STEPS, pcm_format=fmt)
            torch.cuda.synchronize()
            print(f"  run 1, {fmt}: {time.perf_counter() - t0:.3f} s (the first includes "
                  f"the first calls), samples {[len(w) for w in outs[fmt]]}")
        for i16, mu8, f32 in zip(outs["int16"], outs["mulaw8"], outs["float32"]):
            check(i16.dtype == mu8.dtype == np.int16 and f32.dtype == np.float32,
                  "output dtypes")
            check(len(i16) == len(mu8) == len(f32) and 0 < len(i16) <= STEPS * hop
                  and len(i16) % hop == 0, f"output lengths {len(i16)}, {len(mu8)}, {len(f32)}")
            check(bool(np.isfinite(f32).all()) and float(np.abs(f32).max()) > 0,
                  "float output not finite or silent")
            q = np.round(np.clip(f32, -1, 1) * 32767).astype(np.int16)
            check(int(np.abs(q.astype(np.int32) - i16).max()) <= 1,
                  "int16 output differs from the float one")
            check(int(np.abs(mulaw_labels(mu8) - mulaw_labels(q)).max()) <= 1,
                  "mulaw8 output differs from the float one by more than one label")
        pipe._embed_cache.clear()
        embed = pipe.embed_reference(REF_WAV)
        embeds = np.tile(embed, (len(TEXTS), 1))
        audio_s = sum(len(w) for w in outs["int16"]) / sr
        for fmt in ("mulaw8", "int16"):
            staged(TEXTS, embeds, STEPS, 5, fmt)                              # warm
            st, _ = staged(TEXTS, embeds, STEPS, 5, fmt)
            print(f"  warm, {fmt}: {show(st, audio_s)} ({audio_s:.2f} s of audio)")
        launches = read_counts()
        print(f"  launches on the HiFi-GAN path: {launches} (the path needs no kernel)")
        check(not any(launches.values()), f"a kernel launched on the HiFi-GAN path: {launches}")

    with Phase(f"HiFi-GAN TTS path at bench.py's shape: batch {BENCH_BATCH}, steps "
               f"{BENCH_STEPS}, min_stop_token {BENCH_MIN_STOP}, bf16"):
        texts = [BENCH_TEXT] * BENCH_BATCH
        embeds = np.tile(embed, (BENCH_BATCH, 1))
        zero_counts()
        for fmt in ("mulaw8", "int16"):
            staged(texts, embeds, BENCH_STEPS, BENCH_MIN_STOP, fmt)       # warm
        torch.cuda.reset_peak_memory_stats(dev)
        times = {}
        audio_s = BENCH_BATCH * BENCH_STEPS * hop / sr
        for fmt in ("mulaw8", "int16"):
            times[fmt], wavs = staged(texts, embeds, BENCH_STEPS, BENCH_MIN_STOP, fmt)
            check(len(wavs) == BENCH_BATCH and all(len(w) == BENCH_STEPS * hop for w in wavs),
                  f"bench-shape lengths {sorted({len(w) for w in wavs})}")
            print(f"  {fmt}: {show(times[fmt], audio_s)}")
        peak = torch.cuda.max_memory_allocated(dev)
        frames = BENCH_BATCH * BENCH_STEPS
        with torch.device("meta"):
            flops = conv_flops(Generator(voc.cfg), torch.empty(BENCH_BATCH, BENCH_STEPS,
                                                               voc.cfg.num_mels))
        vocode = min(st["vocode"] for st in times.values())
        print(f"  {audio_s:.1f} s of audio; decode "
              f"{times['int16']['ar_decode'] / (BENCH_STEPS // 2) * 1e3:.2f} ms per step "
              f"({BENCH_STEPS // 2} steps of r=2); peak device memory "
              f"{peak / 2**30:.2f} GiB ({tf32_state()})")
        print(f"  generator: {flops:.4g} FLOP for {frames} frames, {flops / vocode / 1e12:.1f} "
              f"TFLOP/s in its best vocode stage, {100 * flops / vocode / PEAK_BF16_FLOPS:.1f}% "
              f"of the {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 dense peak")
        kw = dict(steps=BENCH_STEPS, min_stop_token=BENCH_MIN_STOP, batch_size=BENCH_CHUNK,
                  embed=embeds)
        pipe.tts_batch(texts, None, **kw)                                    # warm
        for fmt in ("mulaw8", "int16"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wavs = pipe.tts_batch(texts, None, pcm_format=fmt, **kw)
            wall = time.perf_counter() - t0
            check(len(wavs) == BENCH_BATCH and all(len(w) == BENCH_STEPS * hop for w in wavs),
                  "tts_batch lengths at the bench shape")
            print(f"  tts_batch(batch_size={BENCH_CHUNK}, {fmt}): {wall:.4f} s, RTF "
                  f"{audio_s / wall:.1f}")
        launches = read_counts()
        check(not any(launches.values()), f"a kernel launched on the HiFi-GAN path: {launches}")
        mels_dev, _ = syn.synthesize_mels_device(texts, embeds, min_stop_token=BENCH_MIN_STOP,
                                                 steps=BENCH_STEPS)
        print("  ar_decode, " + device_split(lambda: syn.synthesize_mels_device(
            texts, embeds, min_stop_token=BENCH_MIN_STOP, steps=BENCH_STEPS)))
        print("  vocode (int16), " + device_split(lambda: voc.vocode_device(mels_dev)))
        # later phases read their own peak
        torch.cuda.reset_peak_memory_stats(dev)

    with Phase("HiFi-GAN generator on the card against the CPU, Fre-GAN, VITS pipeline"):
        mel = torch.from_numpy(np.random.RandomState(0).randn(1, 64, 80).astype(np.float32) - 2)
        card32 = GanVocoder("hifigan", cfg=dict(voc.cfg), verbose=False, seed=0, half=False,
                            device=dev)
        cpu32 = GanVocoder("hifigan", cfg=dict(voc.cfg), verbose=False, seed=0, half=False,
                           device="cpu")
        with full_f32():
            got = card32.vocode_device(mel.to(dev), pcm16=False).cpu().numpy()
        want = cpu32.vocode_device(mel, pcm16=False).numpy()
        err = float(np.abs(got - want).max())
        with_tf32 = float(np.abs(card32.vocode_device(mel.to(dev), pcm16=False).cpu().numpy()
                                 - want).max())
        print(f"  f32 generator, one mel of 64 frames: max |card - cpu| = {err:.3g} with TF32 "
              f"off (tolerance 1e-4); under the defaults {with_tf32:.3g}")
        check(err <= 1e-4, f"the f32 generator on the card differs from the CPU by {err}")
        fre = GanVocoder("fregan", verbose=False, seed=0, device=dev)
        mel_f = torch.randn(len(TEXTS), STEPS, 80, device=dev) - 2
        ms = cuda_ms(lambda: fre.vocode_device(mel_f), reps=3)
        out = fre.vocode_device(mel_f, pcm16=False)
        check(tuple(out.shape) == (len(TEXTS), STEPS * fre.cfg.hop_size)
              and bool(torch.isfinite(out).all()), "Fre-GAN output")
        print(f"  Fre-GAN (stock config, rates {fre.cfg.upsample_rates}, bf16): "
              f"{tuple(mel_f.shape)} → {tuple(out.shape)} in {ms:.3f} ms per call (CUDA events); "
              + device_split(lambda: fre.vocode_device(mel_f)))
        vits_pipe = VoiceCloningPipeline(synthesizer="vits", verbose=False, seed=0, device=dev)
        zero_counts()
        t0 = time.perf_counter()
        vw = vits_pipe.tts_batch(TEXTS, REF_WAV)
        wall = time.perf_counter() - t0
        check(not any(read_counts().values()), "a kernel launched in VITS serving")
        check(len(vw) == len(TEXTS) and all(w.dtype == np.int16 and len(w) > 0 for w in vw),
              "VITS pipeline output")
        print(f"  VoiceCloningPipeline(synthesizer='vits').tts_batch: samples "
              f"{[len(w) for w in vw]} in {wall:.3f} s (the first call)")


# ---------------------------------------------------------------------------
# PPG one-shot voice conversion
# ---------------------------------------------------------------------------

def vc_sources_a() -> list:
    """``bench.py``'s ``bench_ppg_vc`` workload where its sample recording is
    absent: a 3 s 220 Hz tone at 16 kHz, ``VC_BATCH`` crops of half its
    length at offsets of n/16."""
    t = np.arange(16000 * 3) / 16000
    wav = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    n = len(wav)
    return [wav[int(i * n / (2 * VC_BATCH)): int(i * n / (2 * VC_BATCH)) + n // 2]
            for i in range(VC_BATCH)]


def vc_sources_b(seed: int = 0) -> list:
    """Utterance-length sources: ``ground_truth.wav`` tiled from a seeded
    offset to each of ``VC_B_SECONDS``."""
    ref, _ = load_wav(REF_WAV, target_sr=16000)
    rng = np.random.RandomState(seed)
    out = []
    for sec in VC_B_SECONDS:
        n, off = int(sec * 16000), rng.randint(len(ref))
        out.append(np.tile(ref, (n + off) // len(ref) + 1)[off : off + n])
    return out


def run_vc(name: str, vc, voc, srcs, dev) -> dict:
    """One workload through ``convert_wavs``: a warm-up, ``VC_REPS`` timed
    calls (audio seconds per wall second as ``bench.py``'s ``value``, and
    the reference's RTF convention), then one warm pass by stage, the
    decode loop's device busy share and the peak device memory."""
    zero_counts()
    mels = vc.convert_wavs(srcs, stop_threshold=2.0)                    # warm
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for _ in range(VC_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mels = vc.convert_wavs(srcs, stop_threshold=2.0)
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    launches = read_counts()
    audio_s = 0.01 * sum(len(m) for m in mels)
    for src, mel in zip(srcs, mels):
        check(mel.shape[1] == 80 and bool(np.isfinite(mel).all()), f"{name}: mel {mel.shape}")
        check(len(mel) == (len(src) // 160 + 1) // 4 * 4,
              f"{name}: {len(mel)} frames for {len(src)} samples")
    st = Stages()
    ppgs = st("extract", lambda: vc.extractor.extract_from_wavs(srcs))
    lf0s = st("f0/lf0 (host)", lambda: vc.lf0s(srcs))
    batch = vc.batch(ppgs, lf0s)
    memory = st("encode_inputs", lambda: vc.encode(batch))
    ns = batch["ns"]
    max_steps = max(((max(ns) + 99) // 100) * 100, 200)

    def decode():
        gen = torch.Generator(device=dev).manual_seed(0)
        return vc.decode(memory, batch["mem_mask"], max_steps, 2.0, gen)

    raw, frames, steps = st("decode loop", decode)
    with torch.no_grad():
        post = st("postnet", lambda: vc.model.postnet_apply(raw)).cpu().numpy()
    staged = [post[i, : min(int(frames[i]), ns[i])] for i in range(len(srcs))]
    err = max(float(np.abs(a - b).max()) for a, b in zip(staged, mels))
    check(err <= 1e-4, f"{name}: the staged pass differs from convert_wavs by {err}")
    wavs = st("vocode (HiFi-GAN, bf16)", lambda: voc.infer_waveform_batch([m.T for m in mels]))
    check(all(len(w) == len(m) * voc.cfg.hop_size and bool(np.isfinite(w).all())
              for w, m in zip(wavs, mels)), f"{name}: vocoded lengths")
    wall = float(np.median(walls))
    print(f"  {name}: batch {len(srcs)} padded to {batch['ppg'].shape[0]}, memory "
          f"{batch['mem_mask'].shape[1]} groups, {steps} decode steps, {audio_s:.2f} s of "
          f"audio ({sum(len(m) for m in mels)} frames)")
    print(f"  convert_wavs: {', '.join(f'{w:.4f}' for w in walls)} s; value (audio s per "
          f"wall s) {audio_s / wall:.2f}, rtf_reference_convention {wall / audio_s:.4f}; "
          f"peak device memory {peak / 2**30:.3f} GiB ({tf32_state()})")
    st.show()
    print(f"  decode loop {st.s['decode loop'] / steps * 1e3:.3f} ms per step; "
          + device_split(decode))
    print(f"  launches on the PPG-VC path: {launches} (the path needs no kernel)")
    check(not any(launches.values()), f"a kernel launched on the PPG-VC path: {launches}")
    return dict(steps=steps, groups=batch["mem_mask"].shape[1])


def phase_ppg_vc(dev, tmp: Path):
    with Phase("PPG voice conversion: make_voice_converter, full width"):
        vc = make_voice_converter(verbose=False, seed=0, device=dev)
        check_config("ppg2mel", vc.cfg, PPG_JSON)
        voc = GanVocoder("hifigan", cfg=dict(Config.from_json(GAN_JSON), **GAN_CFG),
                         verbose=False, seed=0, device=dev)
        print(f"  extractor {sum(p.numel() for p in vc.extractor.model.parameters())} "
              f"parameters ({vc.extractor.cfg.num_blocks} blocks of "
              f"{vc.extractor.cfg.output_size}), ppg2mel "
              f"{sum(p.numel() for p in vc.model.parameters())}, HiFi-GAN "
              f"{sum(p.numel() for p in voc.model.parameters())} in bf16; seeded weights")
        vc.set_reference(REF_WAV)
        check(vc.ref_embed.shape == (256,) and abs(np.linalg.norm(vc.ref_embed) - 1) < 1e-4,
              "reference d-vector")
        print(f"  reference: lf0 mean {vc.ref_lf0_mean:.4f}, std {vc.ref_lf0_std:.4f}")
        srcs_a, srcs_b = vc_sources_a(), vc_sources_b()
        run_vc("run A (bench.py's bench_ppg_vc, tone)", vc, voc, srcs_a, dev)
        shape = run_vc("run B (4.0 to 7.5 s)", vc, voc, srcs_b, dev)
        check(shape == dict(steps=400, groups=192),
              f"run B ran {shape}, not 400 steps over 192 groups")

    with Phase("PPG voice conversion: f32 on the card against the CPU, convert_files"):
        cpu_x = PPGExtractor(cfg=dict(vc.extractor.cfg), verbose=False, device="cpu")
        cpu_x.model.load_state_dict({k: v.cpu() for k, v in
                                     vc.extractor.model.state_dict().items()})

        def diff(a, b):
            return max(float(np.abs(x - y).max()) for x, y in zip(a, b))

        def card_vs_cpu(srcs):
            want = cpu_x.extract_from_wavs(srcs)
            with full_f32():
                err = diff(vc.extractor.extract_from_wavs(srcs), want)
            return want, err, diff(vc.extractor.extract_from_wavs(srcs), want)

        _, err, tf32 = card_vs_cpu(srcs_b)
        print(f"  extractor on run B's speech: max |card - cpu| = {err:.3g} with TF32 off "
              f"(tolerance 1e-4); under the defaults {tf32:.3g}")
        check(err <= 1e-4, f"the extractor on the card differs from the CPU by {err}")
        # run A's pure tone leaves most mel bins at the f32 DFT's rounding
        # noise, where log(mel + 1e-20) is decided by the order of the sums:
        # not held, shown beside the CPU's own f32-against-f64 spread
        want, err, tf32 = card_vs_cpu(srcs_a)
        wav = np.zeros((len(srcs_a), max(3200, -(-len(srcs_a[0]) // 16000) * 16000)))
        wav[:, : len(srcs_a[0])] = np.stack(srcs_a)
        with torch.no_grad():
            exact = cpu_x.model.double()(torch.from_numpy(wav),
                                         torch.as_tensor([len(x) for x in srcs_a])).numpy()
        spread = diff(want, [exact[i, : len(w)] for i, w in enumerate(want)])
        print(f"  extractor on run A's tone: max |card - cpu| = {err:.3g} with TF32 off, under "
              f"the defaults {tf32:.3g}; the CPU's own f32 against f64 {spread:.3g} (not held: "
              f"f32 cannot decide the log-mel bins a pure tone leaves empty)")
        cfg = Config(vc.cfg).merge(dict(prenet_always_dropout=False))
        card_m = MelDecoderMOLv2(cfg).to(dev).eval()
        card_m.load_state_dict(vc.model.state_dict())
        cpu_m = MelDecoderMOLv2(cfg).eval()
        cpu_m.load_state_dict({k: v.cpu() for k, v in vc.model.state_dict().items()})
        rng = np.random.RandomState(0)
        b, t = 2, 128
        lengths = np.array([128, 93])
        inputs = [rng.randn(b, t, cfg["bottle_neck_feature_dim"]).astype(np.float32), lengths,
                  (rng.randn(b, t, 80) * 2).astype(np.float32), lengths,
                  np.stack([rng.randn(b, t) + 5, rng.rand(b, t) > 0.3], -1).astype(np.float32),
                  rng.randn(b, 256).astype(np.float32)]
        with torch.no_grad():
            want = cpu_m(*(torch.from_numpy(x) for x in inputs))
            with full_f32():
                got = card_m(*(torch.from_numpy(x).to(dev) for x in inputs))
            tf32 = card_m(*(torch.from_numpy(x).to(dev) for x in inputs))
        err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
        err_tf32 = max(float((g.cpu() - w).abs().max()) for g, w in zip(tf32, want))
        print(f"  teacher-forced decoder, batch {b} x {t} frames: max |card - cpu| = {err:.3g} "
              f"with TF32 off (tolerance 1e-4); under the defaults {err_tf32:.3g}")
        check(err <= 1e-4, f"the decoder on the card differs from the CPU by {err}")

        src_dir = tmp / "vc_src"
        src_dir.mkdir()
        paths = []
        for i, w in enumerate(srcs_a):
            paths.append(src_dir / f"src{i}.wav")
            save_wav(w, paths[-1], 16000)
        expect = vc.convert_wavs([load_wav(p, target_sr=16000)[0] for p in paths])
        zero_counts()
        vc.convert_files(paths, tmp / "vc_out", vocoder=voc)
        check(not any(read_counts().values()), "a kernel launched in convert_files")
        for p, mel in zip(paths, expect):
            wav, sr = load_wav(tmp / "vc_out" / f"vc_{p.stem}.wav")
            check(sr == 16000 and len(wav) == len(mel) * voc.cfg.hop_size
                  and bool(np.isfinite(wav).all()), f"convert_files output {p.stem}: "
                  f"{len(wav)} samples at {sr} Hz for {len(mel)} frames")
        print(f"  convert_files through HiFi-GAN: {len(paths)} wavs of "
              f"{[len(m) * voc.cfg.hop_size for m in expect]} samples written and read back")


# ---------------------------------------------------------------------------
# VITS serving and training
# ---------------------------------------------------------------------------

def phase_vits_serve(dev):
    with Phase("VITS serve: VitsSynthesizer.synthesize, full width"):
        syn = VitsSynthesizer(cfg=dict(Config.from_json(VITS_JSON), **VITS_CFG),
                              verbose=False, seed=0, device=dev)
        check_config("VITS", syn.cfg, VITS_JSON)
        zero_counts()
        t0 = time.perf_counter()
        f32 = syn.synthesize(TEXTS, max_frames=1000)
        i16 = syn.synthesize(TEXTS, max_frames=1000, pcm16=True)
        cold = time.perf_counter() - t0
        print(f"  launches on the serving path: {read_counts()} (inference needs no kernel)")
        _, y_lengths = syn.synthesize_device(TEXTS, max_frames=1000)
        y_lengths = y_lengths.cpu().numpy()
        hop = syn.cfg.hop_size
        for a, b, n in zip(f32, i16, y_lengths):
            check(a.dtype == np.float32 and b.dtype == np.int16, "VITS output dtypes")
            check(len(a) == len(b) == n * hop and 0 < n <= 1000,
                  f"VITS lengths {len(a)}/{len(b)} for y_length {n}")
            check(bool(np.isfinite(a).all()) and float(np.abs(a).max()) > 0,
                  "VITS audio is not finite or silent")
            q = np.round(np.clip(a, -1, 1) * 32767).astype(np.int32)
            check(int(np.abs(q - b.astype(np.int32)).max()) <= 1,
                  "int16 output differs from the float output")
        audio_s = sum(len(a) for a in f32) / syn.cfg.sample_rate
        print(f"  y_lengths {list(y_lengths)}, {audio_s:.2f} s of audio; cold float+int16 "
              f"passes {cold:.3f} s")

    with Phase("VITS serve: a warm pass, then one by module"):
        st = Stages()
        st("synthesize (float)", lambda: syn.synthesize(TEXTS, max_frames=1000))
        warm = st.s["synthesize (float)"]
        t0 = {}

        def hooks(name, module):
            def pre(*_):
                torch.cuda.synchronize()
                t0[name] = time.perf_counter()

            def post(*_):
                torch.cuda.synchronize()
                st.s[name] = st.s.get(name, 0.0) + time.perf_counter() - t0[name]
            return [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]

        handles = [h for name, label in (("enc_p", "text encoder"),
                                         ("dp", "duration predictor (reverse flows)"),
                                         ("flow", "flow (reverse)"), ("dec", "decoder"))
                   for h in hooks(label, getattr(syn.model, name))]
        st("synthesize (float), by module", lambda: syn.synthesize(TEXTS, max_frames=1000))
        for h in handles:
            h.remove()
        with full_f32():
            st("synthesize (float), TF32 off", lambda: syn.synthesize(TEXTS, max_frames=1000))
        st.show()
        print(f"  warm RTF {audio_s / warm:.2f} ({audio_s:.2f} s of audio in {warm:.4f} s, "
              f"{tf32_state()}); with TF32 off "
              f"{audio_s / st.s['synthesize (float), TF32 off']:.2f}")


def _write_dataset(root: Path, cfg, seed: int = 0) -> None:
    """``VitsDataset``'s layout: ``train.txt``, ``audio/*.npy`` (harmonic
    tones with vibrato and noise, made from ``seed``), ``emo/`` empty."""
    rng = np.random.RandomState(seed)
    (root / "audio").mkdir(parents=True)
    (root / "emo").mkdir()
    letters = "abcdefghijklmnopqrstuvwxyz"
    rows = []
    sym = np.linspace(TRAIN_SYMBOLS[0], TRAIN_SYMBOLS[1], TRAIN_BATCH).astype(int)
    frames = np.linspace(TRAIN_FRAMES[0], TRAIN_FRAMES[1], TRAIN_BATCH).astype(int)
    for i in range(TRAIN_BATCH):
        chars = [letters[c] for c in rng.randint(0, 26, sym[i] - 1)]
        for j in range(5, len(chars) - 1, 6):
            chars[j] = " "
        text = "".join(chars)
        check(len(text_to_sequence(text)) == sym[i], "synthetic text length")
        n = int(frames[i]) * cfg.hop_size
        tt = np.arange(n) / cfg.sample_rate
        f0 = rng.uniform(90, 250) * (1 + 0.05 * np.sin(2 * np.pi * rng.uniform(3, 6) * tt))
        phase = 2 * np.pi * np.cumsum(f0) / cfg.sample_rate
        wav = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6))
        wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * tt) ** 2)
        wav = (wav + 0.01 * rng.randn(n)).astype(np.float32)
        name = f"audio-spk{i % 4}_{i:04d}.npy"
        np.save(root / "audio" / name, wav)
        rows.append(f"{name}|mel-spk{i % 4}_{i:04d}.npy|embed-spk{i % 4}_{i:04d}.npy|"
                    f"{n // cfg.hop_size}|1|{text}")
    (root / "train.txt").write_text("\n".join(rows) + "\n", encoding="utf-8")


def phase_vits_train(dev, tmp: Path):
    cfg = Config(vits_config()).merge(Config.from_json(VITS_JSON)).merge(VITS_CFG)
    check(cfg.segment_size // cfg.hop_size < TRAIN_FRAMES[0], "segments longer than the audio")
    _write_dataset(tmp / "data", cfg)
    captured = []

    def recording(neg_cent, mask):
        if not captured:
            captured.append((neg_cent.detach().clone(), mask.detach().clone()))
        return maximum_path(neg_cent, mask)

    with Phase(f"VITS train: {TRAIN_STEPS} steps, batch {TRAIN_BATCH}, bf16"):
        vits_model_module.maximum_path = recording
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, disc = vits_train("smoke", tmp / "data", tmp / "models", cfg=cfg,
                                 batch_size=TRAIN_BATCH, total_steps=TRAIN_STEPS,
                                 save_every=0, log_every=1, eval_every=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        vits_model_module.maximum_path = maximum_path
        print(f"  launches on the training path: {launches}")
        check(launches["maximum_path"] == TRAIN_STEPS,
              f"K2 launched {launches['maximum_path']} times in {TRAIN_STEPS} steps")
        logs = [json.loads(line) for line in
                (tmp / "models/smoke/logs_vits/scalars.jsonl").read_text().splitlines()]
        check(len(logs) == TRAIN_STEPS, f"{len(logs)} logged steps")
        for rec in logs:
            print("  " + ", ".join(f"{k} {v:.4g}" for k, v in rec.items()))
            check(all(np.isfinite(v) for v in rec.values()), f"a loss is not finite: {rec}")
        nc, mask = captured[0]
        want = (min(b for b in BUCKET_BOUNDARIES if b >= TRAIN_FRAMES[1]),
                max(32, -(-TRAIN_SYMBOLS[1] // 16) * 16))
        check(tuple(nc.shape[1:]) == want, f"MAS ran at {tuple(nc.shape)}, not (B, *{want})")
        print(f"  neg_cent {tuple(nc.shape)} {nc.dtype}; {wall:.2f} s wall for "
              f"{TRAIN_STEPS} steps (first step includes the spectrogram cache)")
        step, state = CheckpointManager(tmp / "models/smoke/ckpt_vits").restore_latest(
            map_location=dev)
        check(step == TRAIN_STEPS + 1, f"checkpoint step {step}")
        for name, t in model.state_dict().items():
            check(torch.equal(state["g"][name], t), f"restored {name} differs")
        for name, t in disc.state_dict().items():
            check(torch.equal(state["d"][name], t), f"restored {name} differs")
        print(f"  checkpoint of step {step} restored: {len(state['g'])} generator and "
              f"{len(state['d'])} discriminator tensors equal")

    with Phase("VITS train: the trainer's step, by part (synchronised at each hook)"):
        ms_step = [rec["train/ms_per_step"] for rec in logs]
        print(f"  train's own ms per step, steps 1..{TRAIN_STEPS}: {ms_step} (step 1 includes "
              f"the spectrogram cache and the first calls)")
        ds = VitsDataset(tmp / "data", cfg)
        batch = to_device(BucketBatcher(ds, TRAIN_BATCH).collate(
            [ds[i] for i in range(TRAIN_BATCH)], 0), dev)
        opt_g, opt_d = make_optimizer(model.parameters()), make_optimizer(disc.parameters())
        step = make_vits_step(model, disc, opt_g, opt_d, cfg, "bf16")
        gen = torch.Generator(device=dev).manual_seed(0)
        step(batch, gen)                                                 # warm
        marks = []

        def mark(event):
            def hook(*_):
                torch.cuda.synchronize()
                marks.append((event, time.perf_counter()))
            return hook

        handles = [model.register_forward_pre_hook(mark("generator forward begins")),
                   model.register_forward_hook(mark("generator forward ends")),
                   disc.register_forward_pre_hook(mark("discriminator forward begins")),
                   disc.register_forward_hook(mark("discriminator forward ends"))]
        for name, opt in (("discriminator", opt_d), ("generator", opt_g)):
            handles += [opt.register_step_pre_hook(mark(f"{name} optimizer begins")),
                        opt.register_step_post_hook(mark(f"{name} optimizer ends"))]
        mark("step begins")()
        step(batch, gen)
        mark("step ends")()
        for h in handles:
            h.remove()
        for (a, t_a), (b, t_b) in zip(marks, marks[1:]):
            print(f"  {a} -> {b}: {t_b - t_a:.4f} s")
        print(f"  step total {marks[-1][1] - marks[0][1]:.4f} s (hooks synchronise); peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        plain_step = {}
        for name, ctx in (("defaults", None), ("TF32 off", full_f32)):
            with ctx() if ctx else nullcontext():
                step(batch, gen)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(batch, gen)
                torch.cuda.synchronize()
                plain_step[name] = time.perf_counter() - t0
        print(f"  one step without hooks: {plain_step['defaults']:.4f} s under the defaults "
              f"({tf32_state()}), {plain_step['TF32 off']:.4f} s with TF32 off")
    return captured[0], launches


# ---------------------------------------------------------------------------
# Tacotron training and WaveRNN's MOL mode (no kernel on either path)
# ---------------------------------------------------------------------------

PINYIN = ("ni3", "hao3", "shi4", "jie4", "zhong1", "guo2", "ren2", "wo3", "men5", "de5",
          "yu3", "yin1", "he2", "cheng2", "jin1", "tian1", "qi4", "hen3")


def _write_taco_dataset(root: Path, seed: int = 0) -> list:
    """``SynthesizerDataset``'s layout: ``train.txt``, ``mels/`` (M, T)
    smooth seeded noise in ±4, ``embeds/`` unit-norm 256-d vectors; texts of
    tone-numbered pinyin. Returns the rows' (frames, symbols)."""
    rng = np.random.RandomState(seed)
    (root / "mels").mkdir(parents=True)
    (root / "embeds").mkdir()
    frames = np.linspace(TACO_FRAMES[0], TACO_FRAMES[1], TACO_UTTS).astype(int)
    symbols = np.linspace(TACO_SYMBOLS[0], TACO_SYMBOLS[1], TACO_UTTS).astype(int)
    rows, shapes = [], []
    kernel = np.hanning(9) / np.hanning(9).sum()
    for i in range(TACO_UTTS):
        words = []
        while len(" ".join(words)) < symbols[i]:
            words.append(PINYIN[rng.randint(len(PINYIN))])
        text = " ".join(words)[: symbols[i] - 2] + "a"   # + EOS: symbols[i] ids
        check(len(text_to_sequence(text)) == symbols[i], "synthetic text length")
        noise = rng.randn(80, frames[i] + 8) * 2.5 - 1.0
        mel = np.stack([np.convolve(row, kernel, "valid") for row in noise])
        np.save(root / "mels" / f"mel-spk{i % 4}_{i:04d}.npy",
                np.clip(mel, -4, 4).astype(np.float32))
        emb = rng.randn(256)
        np.save(root / "embeds" / f"embed-spk{i % 4}_{i:04d}.npy",
                (emb / np.linalg.norm(emb)).astype(np.float32))
        rows.append(f"audio-spk{i % 4}_{i:04d}.npy|mel-spk{i % 4}_{i:04d}.npy|"
                    f"embed-spk{i % 4}_{i:04d}.npy|{frames[i] * 256}|{frames[i]}|{text}")
        shapes.append((int(frames[i]), int(symbols[i])))
    (root / "train.txt").write_text("\n".join(rows) + "\n", encoding="utf-8")
    return shapes


def phase_tacotron_train(dev, tmp: Path):
    cfg = Config(tacotron_config()).merge(Config.from_json(TACOTRON_JSON)).merge(TACO_CFG)
    shapes = _write_taco_dataset(tmp / "taco_data")
    models = tmp / "taco_models"
    r, _, _, batch_size = TACO_SCHEDULE[0]
    t_text = -(-max(s for _, s in shapes) // 32) * 32
    t_mel = -(-max(f for f, _ in shapes) // 100) * 100
    with Phase(f"Tacotron training: train, {TACO_STEPS} steps of batch {batch_size}, "
               f"S = {t_mel // r}, bf16"):
        check_config("Tacotron", cfg, TACOTRON_JSON)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = taco_train("smoke", tmp / "taco_data", models, schedule=TACO_SCHEDULE,
                           total_steps=TACO_STEPS, save_every=2, eval_every=3, log_every=1,
                           cfg=cfg, precision="bf16", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        print(f"  launches on the training path: {launches} (no kernel on this path)")
        check(not any(launches.values()), "a kernel launched on the Tacotron training path")
        logs = [json.loads(line) for line in
                (models / "smoke/logs/scalars.jsonl").read_text().splitlines()]
        check(len(logs) == TACO_STEPS, f"{len(logs)} logged steps")
        for rec in logs:
            print("  " + ", ".join(f"{k} {v:.4g}" for k, v in rec.items()))
            check(all(np.isfinite(v) for v in rec.values()), f"a loss is not finite: {rec}")
        print(f"  {sum(p.numel() for p in model.parameters())} parameters; texts padded to "
              f"{t_text}, mels to {t_mel} frames; {wall:.2f} s wall for {TACO_STEPS} steps")
        ckpt = CheckpointManager(models / "smoke/ckpt")
        step, state = ckpt.restore_latest(map_location=dev)
        check(ckpt.steps() == [2, 4, TACO_STEPS + 1], f"checkpoints {ckpt.steps()}")
        for name, t in model.state_dict().items():
            check(torch.equal(state["model"][name], t), f"restored {name} differs")
        ev = models / "smoke/eval"
        att = np.load(ev / "attention_000003.npz")
        pred = np.load(ev / "mel-prediction-step-000003.npy")
        wav, sr = load_wav(ev / "step-000003-wave-from-mel.wav")
        check(att["attn"].shape == (t_mel // r, t_text) and pred.shape[1] == 80
              and len(wav) > 0 and bool(np.isfinite(wav).all()), "eval artifacts")
        print(f"  checkpoints {ckpt.steps()}, step {step} restored: {len(state['model'])} "
              f"tensors equal; eval artifacts of step 3: attention {att['attn'].shape}, "
              f"mel {pred.shape}, Griffin-Lim wav {len(wav)} samples at {sr} Hz")
        export = models / "smoke/synthesizer.npz"
        save_npz(export, to_flax(model))
        export.with_suffix(".json").write_text(json.dumps(cfg.to_dict()))
        syn = Synthesizer(export, verbose=False, device=dev)
        syn.load()
        for (name, a), b in zip(syn._model.state_dict().items(), model.state_dict().values()):
            check(torch.equal(a, b), f"the .npz export of {name} did not load back")
        print(f"  the trained model, exported by weights.to_flax to {export.name}, loads "
              f"into Synthesizer unchanged")

    with Phase(f"Tacotron training: run_gta_synthesis over {TACO_UTTS} utterances"):
        zero_counts()
        t0 = time.perf_counter()
        n = run_gta_synthesis("smoke", tmp / "taco_data", models, r=r, cfg=cfg, device=dev)
        wall = time.perf_counter() - t0
        check(not any(read_counts().values()), "a kernel launched in GTA synthesis")
        names = (tmp / "taco_data/synthesized.txt").read_text().splitlines()
        check(n == len(names) == TACO_UTTS, f"{n} GTA mels, {len(names)} named")
        for i, (frames, _) in enumerate(shapes):
            gta = np.load(tmp / "taco_data/mels_gta" / f"mel-spk{i % 4}_{i:04d}.npy")
            check(gta.shape == (80, frames) and bool(np.isfinite(gta).all()),
                  f"GTA mel {i}: {gta.shape}, want (80, {frames})")
        print(f"  {n} GTA mels of shapes (80, {shapes[0][0]}..{shapes[-1][0]}) in {wall:.2f} s")

    with Phase("Tacotron training: the trainer's step, by part (synchronised at each mark)"):
        ds = SynthesizerDataset(tmp / "taco_data/train.txt", tmp / "taco_data/mels",
                                tmp / "taco_data/embeds")
        batch = to_device(collate_synthesizer([ds[i] for i in range(batch_size)], r=r),
                               dev)
        opt = taco_optimizer(model, 1e-3)
        step = make_train_step(model, opt, r, "bf16")
        gen = torch.Generator(device=dev).manual_seed(0)
        loop_args = []                   # the decoder loop's inputs, for its profile
        h = model.decoder.register_forward_pre_hook(lambda _, args: loop_args.append(args))
        step(batch, gen)                                                 # warm
        h.remove()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch, gen)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        marks = []

        def mark(event):
            def hook(*_, **__):
                torch.cuda.synchronize()
                marks.append((event, time.perf_counter()))
            return hook

        def clip_marked(grads, max_norm=1.0):
            mark("backward ends, clip begins")()
            norm = clip_by_global_norm(grads, max_norm)
            mark("clip ends")()
            return norm

        handles = [model.encoder_proj.register_forward_hook(mark("encoder ends")),
                   model.postnet.register_forward_pre_hook(mark("decoder loop ends")),
                   model.register_forward_hook(mark("postnet ends")),
                   opt.register_step_pre_hook(mark("Adam begins")),
                   opt.register_step_post_hook(mark("Adam ends"))]
        taco_train_module.clip_by_global_norm = clip_marked
        torch.cuda.reset_peak_memory_stats()
        mark("step begins")()
        step(batch, gen)
        mark("step ends")()
        peak = torch.cuda.max_memory_allocated() / 2**30
        taco_train_module.clip_by_global_norm = clip_by_global_norm
        for h in handles:
            h.remove()
        for (a, t_a), (b, t_b) in zip(marks, marks[1:]):
            print(f"  {a} -> {b}: {(t_b - t_a) * 1e3:.1f} ms")
        print(f"  step without marks: {[round(w * 1e3, 1) for w in walls]} ms "
              f"({tf32_state()}); peak memory {peak:.2f} GiB")
        print(f"  the decoder loop's forward ({t_mel // r} steps, autograd recording, no "
              f"backward): " + device_split(lambda: model.decoder(*loop_args[0])))

    with Phase("Tacotron training: f32 loss and gradients on the card against the CPU"):
        cpu = Tacotron(cfg).train()
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        idx = [0, TACO_UTTS - 1]
        host = collate_synthesizer([ds[i] for i in idx], r=r)
        s = host["mels"].shape[1] // r
        zo = torch.zeros((s, 2, len(idx), cfg.lstm_dims), dtype=torch.bool)
        results = {}
        for name, m, d, cudnn in (("cpu", cpu, "cpu", True), ("card", model, dev, True),
                                  ("card, cuDNN off", model, dev, False)):
            b = to_device(host, d)
            m.zero_grad(set_to_none=True)
            with full_f32() if d != "cpu" else nullcontext(), \
                    torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
                loss, _, _ = loss_of(m, b, r, Policy.from_name("fp32"), zo_masks=zo.to(d))
                loss.backward()
            results[name] = (loss.item(), [p.grad.detach().cpu().double() for p in m.parameters()])

        def errors(name):
            (l_cpu, g_cpu), (l_card, g_card) = results["cpu"], results[name]
            num = sum(float(((a - b) ** 2).sum()) for a, b in zip(g_card, g_cpu))
            return (abs(l_card - l_cpu) / abs(l_cpu),
                    (num / sum(float((b ** 2).sum()) for b in g_cpu)) ** 0.5)
        loss_err, grad_err = errors("card")
        print(f"  batch {len(idx)} x {s} steps, dropout and zoneout off, TF32 off: loss "
              f"{results['card'][0]:.6f} vs {results['cpu'][0]:.6f}, relative error "
              f"{loss_err:.3g} (bound 1e-4); gradients relative L2 {grad_err:.3g} (bound 1e-3); "
              f"with cuDNN off: loss {errors('card, cuDNN off')[0]:.3g}, gradients "
              f"{errors('card, cuDNN off')[1]:.3g} (not held)")
        check(loss_err <= 1e-4, f"the f32 loss on the card differs from the CPU by {loss_err}")
        check(grad_err <= 1e-3, f"the f32 gradients differ from the CPU's by {grad_err}")


def phase_wavernn_mol(dev, tmp: Path):
    cfg = dict(Config.from_json(WAVERNN_JSON), mode="MOL")
    rng = np.random.RandomState(0)
    mel = np.clip(rng.randn(80, MOL_FRAMES) * 1.5 - 1.0, -4, 4).astype(np.float32)
    with Phase(f"WaveRNN MOL: infer_waveform of a {MOL_FRAMES}-frame mel, full width"):
        voc = WaveRnnVocoder(cfg=cfg, verbose=False, seed=0, device=dev)
        check(voc.model.n_classes == 30, "the MOL head")
        voc.infer_waveform(mel[:, :20], target=800, overlap=100)         # warm
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = voc.infer_waveform(mel)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        check(not any(launches.values()), "a kernel launched on the MOL path")
        check(voc.packed is None, "the MOL path packed sampler weights")
        check(wav.shape == ((MOL_FRAMES - 1) * voc.cfg.hop_size,)
              and bool(np.isfinite(wav).all()) and float(np.abs(wav).max()) > 0,
              f"MOL waveform {wav.shape}")
        t_up = MOL_FRAMES * voc.cfg.hop_size
        folds = len(voc._fold_plan(t_up, voc.cfg.gen_target, voc.cfg.gen_overlap)[0])
        width = voc.cfg.gen_target + 2 * voc.cfg.gen_overlap
        print(f"  launches on the MOL path: {launches} (no kernel: the step-by-step "
              f"generator, as in the JAX package)")
        print(f"  {len(wav)} samples ({len(wav) / 16000:.2f} s) from {folds} folds x "
              f"{width} steps in {wall:.3f} s warm: {wall / width * 1e6:.1f} us per step, "
              f"RTF {len(wav) / 16000 / wall:.3f} ({tf32_state()})")

    with Phase("WaveRNN MOL: the generator on the card against the CPU, handed-in draws"):
        cpu = WaveRnnVocoder(cfg=cfg, verbose=False, seed=0, device="cpu")
        c = voc.cfg
        mel_p = np.pad(mel[:, :20].T / c.mel_max_abs_value, ((c.pad, c.pad), (0, 0)))[None]
        with torch.no_grad():
            mels_f, aux_f = cpu._fold(mel_p.astype(np.float32), 800, 100)
        n_f, length = mels_f.shape[:2]
        g = torch.Generator().manual_seed(1)
        u_mix = torch.rand(length, n_f, 10, generator=g)
        draws = (-torch.log(-torch.log(u_mix.clamp(min=1e-20))),
                 1e-5 + (1 - 2e-5) * torch.rand(length, n_f, generator=g))
        want = cpu.generate(mels_f, aux_f, draws=draws)
        with full_f32():
            got = voc.generate(mels_f.to(dev), aux_f.to(dev),
                               draws=tuple(d.to(dev) for d in draws)).cpu()
        err = float((got - want).abs().max())
        print(f"  {n_f} folds x {length} steps, f32, TF32 off: max |card - cpu| = {err:.3g} "
              f"(bound 1e-3)")
        check(err <= 1e-3, f"the MOL generator on the card differs from the CPU by {err}")

    with Phase("WaveRNN load: hot swap, the sampler's packed weights rebuilt"):
        raw = WaveRnnVocoder(cfg=Config.from_json(WAVERNN_JSON), verbose=False, seed=0,
                             device=dev)
        short = mel[:, :30]
        before = raw.infer_waveform(short, seed=5)
        stale = raw.packed
        export = tmp / "wavernn_seed1.npz"
        save_npz(export, to_flax(WaveRnnVocoder(cfg=Config.from_json(WAVERNN_JSON),
                                                verbose=False, seed=1, device="cpu").model))
        raw.load(export, verbose=False)
        check(raw.packed is None, "load kept the packed weights")
        after = raw.infer_waveform(short, seed=5)
        fresh = WaveRnnVocoder(export, cfg=Config.from_json(WAVERNN_JSON), verbose=False,
                               device=dev)
        check(np.array_equal(after, fresh.infer_waveform(short, seed=5)),
              "K1's output after load differs from a fresh vocoder's")
        check(not np.array_equal(after, before), "load did not change the output")
        check(all(torch.equal(raw.packed[k], v) for k, v in fresh.packed.items())
              and not all(torch.equal(stale[k], v) for k, v in fresh.packed.items()),
              "the packed weights were not rebuilt")
        print(f"  after load: K1's audio ({len(after)} samples) equals a fresh vocoder's from "
              f"the same export, and differs from before the swap")


# ---------------------------------------------------------------------------
# the vocoder trainers: HiFi-GAN/Fre-GAN GAN training, WaveRNN training
# ---------------------------------------------------------------------------

def _write_wav_dataset(root: Path, n: int, sr: int, seconds, seed: int = 0,
                       hop: int = 0) -> list:
    """``train.txt`` and ``audio/*.npy``: ``n`` harmonic tones with vibrato
    and noise of ``seconds`` (lo, hi), made from ``seed``; with ``hop``
    also ``mels_gta/`` (80, frames) smooth seeded noise in ±4, frames =
    samples // hop, as GTA mels of the synthesizer's hop. Returns the
    samples per utterance."""
    rng = np.random.RandomState(seed)
    (root / "audio").mkdir(parents=True)
    if hop:
        (root / "mels_gta").mkdir()
    kernel = np.hanning(9) / np.hanning(9).sum()
    rows, lens = [], []
    for i, sec in enumerate(np.linspace(seconds[0], seconds[1], n)):
        samples = int(sec * sr) // max(hop, 1) * max(hop, 1)
        tt = np.arange(samples) / sr
        f0 = rng.uniform(90, 250) * (1 + 0.05 * np.sin(2 * np.pi * rng.uniform(3, 6) * tt))
        wav = sum(0.3 / k * np.sin(k * 2 * np.pi * np.cumsum(f0) / sr) for k in range(1, 6))
        wav = (wav + 0.01 * rng.randn(samples)).astype(np.float32)
        np.save(root / "audio" / f"audio-{i:04d}.npy", wav)
        frames = samples // hop if hop else samples // 256
        if hop:
            noise = rng.randn(80, frames + 8) * 2.5 - 1.0
            mel = np.stack([np.convolve(row, kernel, "valid") for row in noise])
            np.save(root / "mels_gta" / f"mel-{i:04d}.npy", np.clip(mel, -4, 4).astype(np.float32))
        rows.append(f"audio-{i:04d}.npy|mel-{i:04d}.npy|embed-{i:04d}.npy|{samples}|{frames}|text")
        lens.append(samples)
    (root / "train.txt").write_text("\n".join(rows) + "\n")
    return lens


def _rel_l2(got: list, want: list) -> float:
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
    return (num / sum(float((b ** 2).sum()) for b in want)) ** 0.5


def phase_gan_train(dev, tmp: Path):
    cfg = Config(hifigan_config()).merge(Config.from_json(GAN_JSON)).merge(GAN_CFG)
    data, models = tmp / "gan_data", tmp / "gan_models"
    lens = _write_wav_dataset(data, GAN_UTTS, cfg.sample_rate, (1.0, 3.0))
    seg_frames = cfg.segment_size // cfg.hop_size
    with torch.device("meta"):
        g_flops = conv_flops(Generator(cfg), torch.empty(cfg.batch_size, seg_frames,
                                                          cfg.num_mels))
        y_meta = torch.empty(cfg.batch_size, cfg.segment_size)
        d_flops = conv_flops(HifiganDiscriminators(), y_meta, y_meta, True)
    # a step: G forward + backward (3x), D forward + backward on (y, y_hat)
    # (3x), then D forward again + backward to the generator's output (2x)
    step_flops = 3 * g_flops + 5 * d_flops
    with Phase(f"GAN vocoder training: train(arch='hifigan'), {GAN_STEPS} steps of batch "
               f"{cfg.batch_size}, segment {cfg.segment_size}, bf16"):
        check_config("HiFi-GAN", cfg, GAN_JSON)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen, disc = gan_train("smoke", data, models, arch="hifigan", total_steps=GAN_STEPS,
                              val_every=GAN_STEPS - 1, save_every=GAN_STEPS - 1, log_every=1,
                              cfg=cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        print(f"  launches on the GAN training path: {launches} (no kernel on this path)")
        check(not any(launches.values()), "a kernel launched on the GAN training path")
        logs = [json.loads(line) for line in
                (models / "smoke/logs_hifigan/scalars.jsonl").read_text().splitlines()]
        for rec in logs:
            print("  " + ", ".join(f"{k} {v:.4g}" for k, v in rec.items()))
            check(all(np.isfinite(v) for v in rec.values()), f"a loss is not finite: {rec}")
        check([r["step"] for r in logs if "train/gen" in r] == list(range(1, GAN_STEPS + 1))
              and [r["step"] for r in logs if "val/mel_err" in r] == [GAN_STEPS - 1],
              "logged steps and validation")
        ckpt = CheckpointManager(models / "smoke/ckpt_hifigan")
        check(ckpt.steps() == [GAN_STEPS - 1, GAN_STEPS + 1], f"checkpoints {ckpt.steps()}")
        step, state = ckpt.restore_latest(map_location=dev)
        for key, module in (("g", gen), ("d", disc)):
            for name, t in module.state_dict().items():
                check(torch.equal(state[key][name], t), f"restored {key} {name} differs")
        n_g = sum(p.numel() for p in gen.parameters())
        n_d = sum(p.numel() for p in disc.parameters())
        print(f"  {len(lens)} utterances of {min(lens) / cfg.sample_rate:.2f}-"
              f"{max(lens) / cfg.sample_rate:.2f} s; generator {n_g} and discriminators {n_d} "
              f"parameters; {wall:.2f} s wall; checkpoints {ckpt.steps()}, step {step} restored "
              f"with {len(state['g'])} + {len(state['d'])} tensors equal")

    with Phase("GAN vocoder training: the trainer's step, by part (synchronised at each hook)"):
        ds = MelDataset(get_dataset_filelist(data)[0], cfg, syn_dir=data, seed=0)
        batch = to_device(collate_gan([ds[i] for i in range(cfg.batch_size)]), dev)
        opt_g = gan_optimizer(gen.parameters(), cfg)
        opt_d = gan_optimizer(disc.parameters(), cfg)
        step_fn = make_gan_step(gen, disc, opt_g, opt_d, cfg, "bf16")
        step_fn(batch)                                                   # warm
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        marks = []

        def mark(event):
            def hook(*_, **__):
                torch.cuda.synchronize()
                marks.append((event, time.perf_counter()))
            return hook

        handles = [gen.register_forward_hook(mark("generator forward ends")),
                   opt_d.register_step_post_hook(mark("discriminators' AdamW ends")),
                   opt_g.register_step_post_hook(mark("generator's AdamW ends"))]
        torch.cuda.reset_peak_memory_stats()
        mark("step begins")()
        step_fn(batch)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for h in handles:
            h.remove()
        names = ("generator forward", "D forward + backward + AdamW",
                 "G's mel loss, D forward, backward + AdamW")
        for label, (_, t_a), (_, t_b) in zip(names, marks, marks[1:]):
            print(f"  {label}: {(t_b - t_a) * 1e3:.1f} ms")
        best = min(walls)
        print(f"  step without marks: {[round(w * 1e3, 1) for w in walls]} ms ({tf32_state()}); "
              f"peak memory {peak:.2f} GiB; conv FLOPs per step {step_flops:.4g} (generator "
              f"{g_flops:.4g} and discriminators {d_flops:.4g} per forward): "
              f"{step_flops / best / 1e12:.1f} TFLOP/s, "
              f"{100 * step_flops / best / PEAK_BF16_FLOPS:.1f}% of the bf16 peak")
        print("  one step: " + device_split(lambda: step_fn(batch)))

    with Phase("GAN vocoder training: one f32 step on the card against the CPU"):
        # learning rate 0: the discriminators' update moves nothing, so the
        # generator's gradients on both sides are taken through the same
        # discriminators; the spectral-norm statistics still move
        cfg0 = Config(cfg).merge(dict(learning_rate=0.0))
        host = collate_gan([ds[i] for i in range(2)])
        results = {}
        for name, d in (("cpu", "cpu"), ("card", dev)):
            g_m = init_generator(0, cfg).to(d)
            d_m = HifiganDiscriminators().to(d)
            g_m.load_state_dict(gen.state_dict())
            d_m.load_state_dict(disc.state_dict())
            step1 = make_gan_step(g_m, d_m, gan_optimizer(g_m.parameters(), cfg0),
                                  gan_optimizer(d_m.parameters(), cfg0), cfg0, "fp32")
            with full_f32() if d != "cpu" else nullcontext():
                losses = [float(v) for v in step1(to_device(host, d))]
            results[name] = (losses, [p.grad.detach().cpu().double() for p in g_m.parameters()],
                             [p.grad.detach().cpu().double() for p in d_m.parameters()],
                             [b.detach().cpu().double() for n, b in d_m.named_buffers()
                              if n.endswith((".u", ".sigma"))])
        (l_cpu, g_cpu, d_cpu, s_cpu), (l_card, g_card, d_card, s_card) = (results["cpu"],
                                                                          results["card"])
        loss_err = max(abs(a / b - 1) for a, b in zip(l_card, l_cpu))
        g_err, d_err = _rel_l2(g_card, g_cpu), _rel_l2(d_card, d_cpu)
        s_err = max(float((a - b).abs().max()) for a, b in zip(s_card, s_cpu))
        print(f"  batch 2, TF32 off: losses {l_card} vs {l_cpu}, relative error {loss_err:.3g} "
              f"(bound 1e-4); gradients relative L2: generator {g_err:.3g}, discriminators "
              f"{d_err:.3g} (bound 1e-3); spectral-norm u/sigma max |card - cpu| {s_err:.3g} "
              f"(bound 1e-4)")
        check(loss_err <= 1e-4, f"the f32 losses on the card differ from the CPU by {loss_err}")
        check(max(g_err, d_err) <= 1e-3, f"the f32 gradients differ by {g_err}, {d_err}")
        check(s_err <= 1e-4, f"the spectral-norm statistics differ by {s_err}")

    with Phase(f"GAN vocoder training: train(arch='fregan'), {FREGAN_STEPS} steps at "
               f"fregan_config()"):
        fcfg = fregan_config()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fgen, fdisc = gan_train("smoke", data, models, arch="fregan", total_steps=FREGAN_STEPS,
                                val_every=0, save_every=0, log_every=1, seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not any(read_counts().values()), "a kernel launched on the Fre-GAN path")
        logs = [json.loads(line) for line in
                (models / "smoke/logs_fregan/scalars.jsonl").read_text().splitlines()]
        check(len(logs) == FREGAN_STEPS and all(np.isfinite(v) for r in logs for v in r.values()),
              f"Fre-GAN logs {logs}")
        with torch.device("meta"):
            y_meta = torch.empty(fcfg.batch_size, fcfg.segment_size)
            f_flops = conv_flops(FreGanDiscriminators(), y_meta, y_meta, True)
        print(f"  rates {fcfg.upsample_rates}, segment {fcfg.segment_size}, batch "
              f"{fcfg.batch_size}: {sum(p.numel() for p in fgen.parameters())} + "
              f"{sum(p.numel() for p in fdisc.parameters())} parameters; "
              f"{[round(r['train/ms_per_step'], 1) for r in logs]} ms per step in train's log; "
              f"discriminators {f_flops:.4g} FLOPs per forward; {wall:.2f} s wall")


def phase_wavernn_train(dev, tmp: Path):
    cfg = Config(wavernn_config()).merge(Config.from_json(WAVERNN_JSON)).merge(WAVERNN_TRAIN_CFG)
    data, models = tmp / "wavernn_data", tmp / "wavernn_models"
    lens = _write_wav_dataset(data, WAVERNN_UTTS, cfg.sample_rate, WAVERNN_SECONDS, seed=1,
                              hop=cfg.hop_size)
    vocoders, sampled = [], []

    def recording(*args, **kw):
        voc = gen_testset(*args, **kw)
        vocoders.append((voc, {k: v.clone() for k, v in voc.packed.items()}))
        return voc

    # the sampler's inputs on this path, for the hold below; the count stays
    # the wrapper's
    def sampling(weights, mels, aux, seed, n_classes=512, greedy=False):
        sampled.append((weights, mels, aux, seed, n_classes, greedy))
        return wavernn_sample(weights, mels, aux, seed, n_classes, greedy)

    n_ckpt = WAVERNN_STEPS // WAVERNN_SAVE_EVERY
    with Phase(f"WaveRNN training: train, {WAVERNN_STEPS} steps of batch {cfg.batch_size}, "
               f"seq_len {cfg.seq_len}, bf16, gen_testset of {WAVERNN_SAMPLES} at each of "
               f"{n_ckpt} checkpoints"):
        check_config("WaveRNN", cfg, WAVERNN_JSON)
        wavernn_train_module.gen_testset = recording
        wavernn_module.wavernn_sample = sampling
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = wavernn_train("smoke", data, models, total_steps=WAVERNN_STEPS,
                              save_every=WAVERNN_SAVE_EVERY, log_every=1, cfg=cfg,
                              gen_samples=WAVERNN_SAMPLES, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        wavernn_train_module.gen_testset = gen_testset
        wavernn_module.wavernn_sample = wavernn_sample
        samples = n_ckpt * WAVERNN_SAMPLES
        print(f"  launches on the WaveRNN training path: {launches} ({samples} generated "
              f"samples)")
        check(launches["wavernn_sample"] >= samples,
              f"K1 launched {launches['wavernn_sample']} times for {samples} samples")
        check(launches["maximum_path"] == 0 and launches["wavernn_sample(time_major=False)"] == 0,
              "another kernel launched on the WaveRNN training path")
        logs = [json.loads(line) for line in
                (models / "smoke/logs_wavernn/scalars.jsonl").read_text().splitlines()]
        for rec in logs:
            print("  " + ", ".join(f"{k} {v:.4g}" for k, v in rec.items()))
            check(np.isfinite(rec["train/loss"]), f"a loss is not finite: {rec}")
        ckpt = CheckpointManager(models / "smoke/ckpt_wavernn")
        want_steps = [WAVERNN_SAVE_EVERY * (i + 1) for i in range(n_ckpt)] + [WAVERNN_STEPS + 1]
        check(ckpt.steps() == want_steps, f"checkpoints {ckpt.steps()}")
        _, state = ckpt.restore_latest(map_location=dev)
        for name, t in model.state_dict().items():
            check(torch.equal(state["model"][name], t), f"restored {name} differs")
        wavs = {}
        for path in sorted((models / "smoke/samples_wavernn").iterdir()):
            wav, sr = load_wav(path)
            check(len(wav) > 0 and bool(np.isfinite(wav).all()), f"sample {path.name}")
            wavs[path.name] = wav
        check(len(wavs) == 2 * samples, f"{len(wavs)} sample wavs")
        print(f"  {len(lens)} utterances of {min(lens) / cfg.sample_rate:.2f}-"
              f"{max(lens) / cfg.sample_rate:.2f} s; {sum(p.numel() for p in model.parameters())} "
              f"parameters; {wall:.2f} s wall; checkpoints {ckpt.steps()}; {len(wavs)} wavs")

    with Phase("WaveRNN training: each checkpoint's samples from its own weights"):
        (voc, first), (voc2, second) = vocoders[0], vocoders[-1]
        fresh = pack_wavernn_weights(model)
        check(voc is voc2 and all(torch.equal(second[k], v) for k, v in fresh.items()),
              "the last checkpoint's sampler weights are not the trained model's")
        check(not all(torch.equal(first[k], v) for k, v in second.items()),
              "the sampler weights did not change between checkpoints")
        gen_name = f"gen_batched_target{cfg.gen_target}_overlap{cfg.gen_overlap}"
        a = wavs[f"{WAVERNN_SAVE_EVERY}_steps_0_{gen_name}.wav"]
        b = wavs[f"{WAVERNN_STEPS}_steps_0_{gen_name}.wav"]
        check(not np.array_equal(a, b), "the two checkpoints generated the same sample")
        print(f"  one vocoder across {len(vocoders)} checkpoints; its packed weights after the "
              f"last equal the trained model's and differ from the first's; sample 0 differs "
              f"between steps {WAVERNN_SAVE_EVERY} and {WAVERNN_STEPS} "
              f"(max |diff| {float(np.abs(a - b).max()):.3g})")

    with Phase("WaveRNN training: K1 on this path's inputs against its plain version"):
        # the last checkpoint's last call: the trained model's weights, packed
        # in bf16 as the path packs them, and in f32 from the same model
        check(len(sampled) == launches["wavernn_sample"],
              f"{len(sampled)} sampler calls for {launches['wavernn_sample']} launches")
        w_bf16, mels, aux, seed, n_classes, greedy_path = sampled[-1]
        check(w_bf16 is vocoders[-1][0].packed and not greedy_path,
              "the last sampler call did not take the last checkpoint's packed weights")
        w_f32 = pack_wavernn_weights(model, torch.float32)
        f, t, _ = mels.shape
        print(f"  {len(sampled)} calls, shapes {[tuple(c[1].shape[:2]) for c in sampled]} "
              f"(folds x steps); held: F={f} x T={t}, mels {tuple(mels.shape)}, aux "
              f"{tuple(aux.shape)}")
        rnn, fc = w_bf16["I_w"].shape[1], w_bf16["fc1_w"].shape[1]
        for dtype in (torch.bfloat16, torch.float32):
            pl = plan(rnn, fc, n_classes, aux.shape[2] // 4, mels.shape[2], f, dtype,
                      resident_blocks(dev, dtype))
            print(f"  plan ({dtype}, F={f}): grid {pl.grid} blocks of {pl.nu} units, "
                  f"{pl.fchunk} folds per stage, {pl.staged_bytes} B staged per step")
        k1_err = hold_k1_call(w_f32, w_bf16, mels, aux, seed, n_classes)
        k1_ms = cuda_ms(lambda: wavernn_sample(w_bf16, mels, aux, seed, n_classes), reps=3)
        k1_plain_ms = cuda_ms(lambda: wavernn_sample_plain(w_bf16, mels, aux, seed, n_classes))
        print(f"  K1 at this path's call (bf16, sampled): {k1_ms:.3f} ms ({k1_ms / t * 1e3:.2f} "
              f"us per step), plain {k1_plain_ms:.3f} ms; {launches['wavernn_sample']} launches "
              f"on the path ({tf32_state()})")

    with Phase("WaveRNN training: one MOL step, remat against plain in f32, the step timed"):
        ds = WaveRnnDataset(data / "train.txt", data / "mels_gta", data / "audio", cfg)
        rng = random.Random(0)
        batch = to_device(collate_wavernn([ds[i] for i in range(cfg.batch_size)], cfg, rng),
                               dev)
        mol_cfg = Config(cfg).merge(dict(mode="MOL"))
        mol_ds = WaveRnnDataset(data / "train.txt", data / "mels_gta", data / "audio", mol_cfg)
        mol_batch = to_device(collate_wavernn(
            [mol_ds[i] for i in range(cfg.batch_size)], mol_cfg, random.Random(0)), dev)
        mol = WaveRNN(mol_cfg).to(dev).train()
        mol_step = make_wavernn_step(mol, torch.optim.Adam(mol.parameters(), lr=1e-4), "MOL",
                                     "bf16")
        mol_loss = float(mol_step(mol_batch))
        check(np.isfinite(mol_loss), f"MOL loss {mol_loss}")
        losses = {}
        with full_f32():
            for remat in (False, True):
                m = WaveRNN(Config(cfg).merge(dict(remat=remat))).to(dev).train()
                m.load_state_dict(model.state_dict())
                step1 = make_wavernn_step(m, torch.optim.Adam(m.parameters(), lr=1e-4), "RAW",
                                          "fp32", remat=remat)
                losses[remat] = float(step1(batch))
        remat_err = abs(losses[True] / losses[False] - 1)
        print(f"  MOL step loss {mol_loss:.4f} (bf16); f32 with TF32 off: plain {losses[False]:.6f}, "
              f"remat {losses[True]:.6f}, relative difference {remat_err:.3g} (bound 1e-5)")
        check(remat_err <= 1e-5, f"the remat loss differs from the plain one by {remat_err}")
        opt = torch.optim.Adam(model.parameters(), lr=1e-4)
        step = make_wavernn_step(model, opt, "RAW", "bf16")
        step(batch)                                                      # warm
        walls = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  RAW bf16 step, batch {cfg.batch_size} x {cfg.seq_len}: "
              f"{[round(w * 1e3, 1) for w in walls]} ms ({tf32_state()}); peak memory "
              f"{peak:.2f} GiB")
        print("  one step: " + device_split(lambda: step(batch)))
    return k1_err


# ---------------------------------------------------------------------------
# the GE2E and ppg2mel trainers
# ---------------------------------------------------------------------------

def _tone_wav(rng, seconds: float, f0: float, sr: int = 16000) -> np.ndarray:
    """Harmonics of ``f0`` with vibrato, in bursts of 3 a second (the energy
    VAD keeps them), over noise."""
    tt = np.arange(int(seconds * sr)) / sr
    f = f0 * (1 + 0.05 * np.sin(2 * np.pi * rng.uniform(3, 6) * tt))
    wav = sum(0.3 / k * np.sin(k * 2 * np.pi * np.cumsum(f) / sr) for k in range(1, 5))
    bursts = np.sin(2 * np.pi * 3 * tt + rng.uniform(0, 6)) > -0.3
    return (wav * bursts + 0.01 * rng.randn(len(tt))).astype(np.float32)


def _timed_steps(step, n: int = 3) -> list:
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return [round(w * 1e3, 1) for w in walls]


def _grads(module) -> list:
    return [p.grad.detach().cpu().double() for p in module.parameters()]


def phase_encoder_train(dev, tmp: Path):
    raw, clean, models = tmp / "enc_raw", tmp / "enc_clean", tmp / "enc_models"
    s, u = ENC_BATCH
    with Phase(f"GE2E training: preprocess_speaker_dirs, {ENC_SPEAKERS} speakers x {ENC_UTTS} "
               f"utterances of {ENC_SECONDS[0]}-{ENC_SECONDS[1]} s"):
        rng = np.random.RandomState(2)
        for spk in range(ENC_SPEAKERS):
            f0 = 90 + 160 * spk / ENC_SPEAKERS
            for utt in range(ENC_UTTS):
                d = raw / f"spk{spk:02d}"
                d.mkdir(parents=True, exist_ok=True)
                save_wav(_tone_wav(rng, rng.uniform(*ENC_SECONDS), f0), d / f"u{utt:02d}.wav",
                         16000)
        zero_counts()
        t0 = time.perf_counter()
        enc_preprocess.preprocess_speaker_dirs(sorted(raw.iterdir()), "smoke", tmp, clean,
                                               device=dev)
        wall = time.perf_counter() - t0
        check(not any(read_counts().values()), "a kernel launched in GE2E preprocessing")
        lens = [np.load(f).shape for f in clean.rglob("*.npy")]
        check(len(lens) == ENC_SPEAKERS * ENC_UTTS and all(n >= 160 and d == 40 for n, d in lens),
              f"{len(lens)} mel files")
        print(f"  {len(lens)} mels of {min(n for n, _ in lens)}-{max(n for n, _ in lens)} frames "
              f"in {wall:.2f} s")

    with Phase(f"GE2E training: train, {ENC_STEPS} steps of {s} x {u} x 160, bf16"):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = enc_train.train("smoke", clean, models, save_every=2, total_steps=ENC_STEPS,
                                 speakers_per_batch=s, utterances_per_speaker=u, log_every=1,
                                 vis_every=ENC_STEPS, precision="bf16", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        print(f"  launches on the path: {launches} (0: no kernel on the GE2E training path)")
        check(not any(launches.values()), "a kernel launched on the GE2E training path")
        logs = [json.loads(line) for line in
                (models / "smoke/logs/scalars.jsonl").read_text().splitlines()]
        check(len(logs) == ENC_STEPS, f"{len(logs)} logged steps")
        for rec in logs:
            print("  " + ", ".join(f"{k} {v:.4g}" for k, v in rec.items()))
            check(all(np.isfinite(v) for v in rec.values()), f"not finite: {rec}")
        ckpt = CheckpointManager(models / "smoke/ckpt")
        check(ckpt.steps() == [2, ENC_STEPS], f"checkpoints {ckpt.steps()}")
        _, state = ckpt.restore_latest(map_location=dev)
        for name, t in params.state_dict().items():
            check(torch.equal(state["params"][name], t), f"restored {name} differs")
        enc = SpeakerEncoderInference.from_checkpoint(models / "smoke/encoder.npz", device=dev)
        frames = torch.from_numpy(np.load(next(clean.rglob("*.npy")))[:160]).to(dev)
        frames = frames[None].expand(4, -1, -1).contiguous()
        with torch.no_grad():
            want = params["model"](frames).cpu().numpy()
        check(np.array_equal(enc.embed_frames_batch(frames), want),
              "the exported encoder's embeddings differ from the trained model's")
        print(f"  {sum(p.numel() for p in params.parameters())} parameters; {wall:.2f} s wall; "
              f"checkpoints {ckpt.steps()} load back; encoder.npz loads into "
              f"SpeakerEncoderInference with equal embeddings")

    with Phase("GE2E training: the trainer's step, warm"):
        sampler = SpeakerBatchSampler(SpeakerVerificationDataset(clean), s, u, 160, seed=1)
        t0 = time.perf_counter()
        host = sampler.next_batch()
        sample_ms = (time.perf_counter() - t0) * 1e3
        batch = torch.from_numpy(host).to(dev)
        opt = enc_train.make_optimizer(params)
        step = enc_train.make_train_step(params, opt, s, u, "bf16")
        step(batch)
        torch.cuda.reset_peak_memory_stats()
        walls = _timed_steps(lambda: step(batch))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  step {walls} ms ({tf32_state()}); peak memory {peak:.2f} GiB; the host "
              f"sampler {sample_ms:.1f} ms per batch")
        print("  one step: " + device_split(lambda: step(batch)))

    with Phase("GE2E training: f32 on the card against the CPU, remat against plain"):
        fs, fu = ENC_F32_BATCH
        small = torch.from_numpy(
            SpeakerBatchSampler(SpeakerVerificationDataset(clean), fs, fu, 160, seed=2)
            .next_batch())
        results = {}

        def f32_step(name, d, remat=False, cudnn=True):
            p = encoder_model.init_params(0, remat=remat).to(d).train()
            p.load_state_dict(params.state_dict())
            x = small.to(d).reshape(fs * fu, 160, 40)
            with full_f32() if d != "cpu" else nullcontext(), \
                    torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
                embeds = p["model"](x).reshape(fs, fu, -1)
                loss, sim = encoder_model.ge2e_loss(embeds, p["similarity"]["weight"],
                                                    p["similarity"]["bias"])
                loss.backward()
            results[name] = (loss.item(), float(encoder_model.equal_error_rate(sim, fs, fu)),
                             _grads(p))

        for args in (("cpu", "cpu"), ("card", dev), ("card, cuDNN off", dev, False, False),
                     ("card, remat", dev, True)):
            f32_step(*args)
        (l_cpu, e_cpu, g_cpu), (l_card, e_card, g_card) = results["cpu"], results["card"]
        loss_err, grad_err = abs(l_card / l_cpu - 1), _rel_l2(g_card, g_cpu)
        off = results["card, cuDNN off"]
        print(f"  batch {fs} x {fu} x 160, TF32 off: loss {l_card:.6f} vs {l_cpu:.6f}, relative "
              f"error {loss_err:.3g} (bound 1e-5); EER {e_card:.4f} vs {e_cpu:.4f} (bound "
              f"{1 / (fs * fu):.3g}, one rank); gradients relative L2 {grad_err:.3g} (bound "
              f"1e-3); cuDNN off: loss {abs(off[0] / l_cpu - 1):.3g}, gradients "
              f"{_rel_l2(off[2], g_cpu):.3g} (not held)")
        check(loss_err <= 1e-5, f"the f32 GE2E loss on the card differs by {loss_err}")
        check(abs(e_card - e_cpu) <= 1 / (fs * fu), f"EER {e_card} vs {e_cpu}")
        check(grad_err <= 1e-3, f"the f32 GE2E gradients differ by {grad_err}")
        remat = results["card, remat"]
        remat_err = max(abs(remat[0] / l_card - 1), _rel_l2(remat[2], g_card))
        print(f"  remat against plain on the card: loss {remat[0]:.6f} vs {l_card:.6f}, largest "
              f"relative difference of loss and gradients {remat_err:.3g} (bound 1e-6)")
        check(remat_err <= 1e-6, f"remat differs from the plain step by {remat_err}")


def phase_ppg2mel_train(dev, tmp: Path):
    cfg = Config(ppg2mel_config()).merge(Config.from_json(PPG_JSON))
    wavs, vc_dir, models = tmp / "vc_wavs", tmp / "vc_data", tmp / "vc_models"
    with Phase(f"ppg2mel training: preprocess_vc_dataset, {PPG_UTTS} utterances of "
               f"{PPG_SECONDS[0]}-{PPG_SECONDS[1]} s"):
        rng = np.random.RandomState(3)
        wavs.mkdir()
        for i, sec in enumerate(np.linspace(*PPG_SECONDS, PPG_UTTS)):
            save_wav(_tone_wav(rng, sec, rng.uniform(100, 220)), wavs / f"utt_{i:04d}.wav", 16000)
        zero_counts()
        t0 = time.perf_counter()
        preprocess_vc_dataset(wavs, vc_dir, PPGExtractor(verbose=False, device=dev),
                              SpeakerEncoderInference(device=dev), device=dev)
        wall = time.perf_counter() - t0
        check(not any(read_counts().values()), "a kernel launched in VC preprocessing")
        split = {n: (vc_dir / f"{n}_fidlist.txt").read_text().split()
                 for n in ("train", "dev", "eval")}
        check([len(split[n]) for n in ("train", "dev", "eval")] == [12, 2, 2], f"splits {split}")
        shapes = {sub: np.load(vc_dir / sub / "utt_0000.npy").shape
                  for sub in ("bnf", "f0", "embed", "mel")}
        print(f"  {PPG_UTTS} utterances in {wall:.2f} s: 12 train, 2 dev, 2 eval; the first's "
              f"arrays {shapes}")

    with Phase(f"ppg2mel training: train, {PPG_STEPS} steps of batch {PPG_BATCH}, bf16, "
               f"validation every 2"):
        check_config("ppg2mel", cfg, PPG_JSON)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = ppg_train.train("smoke", vc_dir, models, cfg=cfg, batch_size=PPG_BATCH,
                                total_steps=PPG_STEPS, save_every=2, log_every=1, val_every=2,
                                precision="bf16", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        print(f"  launches on the path: {launches} (0: no kernel on the ppg2mel training path)")
        check(not any(launches.values()), "a kernel launched on the ppg2mel training path")
        logs = [json.loads(line) for line in
                (models / "smoke/logs_ppg2mel/scalars.jsonl").read_text().splitlines()]
        check(len(logs) == PPG_STEPS + PPG_STEPS // 2, f"{len(logs)} log lines")
        for rec in logs:
            print("  " + ", ".join(f"{k} {v:.4g}" for k, v in rec.items()))
            check(all(np.isfinite(v) for v in rec.values()), f"not finite: {rec}")
        ckpt = CheckpointManager(models / "smoke/ckpt_ppg2mel")
        best = CheckpointManager(models / "smoke/ckpt_ppg2mel_best")
        check(ckpt.steps() == [2, 4, PPG_STEPS + 1] and best.steps()[0] == 2
              and set(best.steps()) <= {2, 4}, f"checkpoints {ckpt.steps()}, best {best.steps()}")
        _, state = ckpt.restore_latest(map_location=dev)
        for name, t in model.state_dict().items():
            check(torch.equal(state["model"][name], t), f"restored {name} differs")
        attn = np.load(models / "smoke/logs_ppg2mel/dev_attention_0000002.npy")
        print(f"  {sum(p.numel() for p in model.parameters())} parameters; {wall:.2f} s wall; "
              f"checkpoints {ckpt.steps()}, best {best.steps()}; dev attention {attn.shape}")

    with Phase("ppg2mel training: the trainer's step, by part (synchronised at each mark)"):
        ds = ppg_train.OneshotVcDataset(vc_dir, "train")
        host = ppg_train.collate_vc([ds[i] for i in range(PPG_BATCH)], cfg.frames_per_step, 4)
        batch = to_device(host, dev)
        opt, sched = ppg_train.make_optimizer(model, 5e-4)
        step = ppg_train.make_vc_step(model, opt, sched, "bf16")
        gen = torch.Generator(device=dev).manual_seed(0)
        step(batch, gen)
        torch.cuda.reset_peak_memory_stats()
        walls = _timed_steps(lambda: step(batch, gen))
        peak = torch.cuda.max_memory_allocated() / 2**30
        marks = []

        def mark(event):
            def hook(*_, **__):
                torch.cuda.synchronize()
                marks.append((event, time.perf_counter()))
            return hook

        handles = [model.reduce_proj.register_forward_hook(mark("encode ends")),
                   model.postnet.register_forward_pre_hook(mark("decoder loop ends")),
                   model.postnet.register_forward_hook(mark("postnet ends")),
                   opt.register_step_pre_hook(mark("backward and clip end, AdamW begins")),
                   opt.register_step_post_hook(mark("AdamW ends"))]
        mark("step begins")()
        step(batch, gen)
        mark("step ends")()
        for h in handles:
            h.remove()
        for (a, t_a), (b, t_b) in zip(marks, marks[1:]):
            print(f"  {a} -> {b}: {(t_b - t_a) * 1e3:.1f} ms")
        loop = dict(marks)["decoder loop ends"] - dict(marks)["encode ends"]
        total = marks[-1][1] - marks[0][1]
        print(f"  {host['mels'].shape[1] // cfg.frames_per_step} decoder steps; the loop's "
              f"forward {100 * loop / total:.0f}% of the marked step; step without marks "
              f"{walls} ms ({tf32_state()}); peak memory {peak:.2f} GiB")
        print("  one step: " + device_split(lambda: step(batch, gen)))

    with Phase("ppg2mel training: one f32 training step on the card against the CPU"):
        host = ppg_train.collate_vc([ds[0], ds[len(ds) - 1]], cfg.frames_per_step, 4)
        b, t = host["mels"].shape[:2]
        rng = np.random.RandomState(4)

        def keep(*shape):
            return torch.from_numpy(rng.rand(*shape) >= 0.5)
        masks = {"prenet": [keep(b, d) for d in cfg.prenet_dims],
                 "attention": keep(b, cfg.num_mixtures),
                 "postnet": [keep(b, t, 512) for _ in range(4)] + [keep(b, t, cfg.num_mels)]}
        results = {}
        for name, d in (("cpu", "cpu"), ("card", dev)):
            m = MelDecoderMOLv2(cfg).to(d).train()
            m.load_state_dict(model.state_dict())
            bt = to_device(host, d)
            mk = {k: [x.to(d) for x in v] if isinstance(v, list) else v.to(d)
                  for k, v in masks.items()}
            with full_f32() if d != "cpu" else nullcontext():
                out = m(*(bt[k] for k in ("ppgs", "lengths", "mels", "lengths", "lf0s",
                                          "embeds")), masks=mk)
                loss = ppg_train.vc_loss(out, bt)[0]
                loss.backward()
            results[name] = (loss.item(), _grads(m))
        (l_cpu, g_cpu), (l_card, g_card) = results["cpu"], results["card"]
        loss_err, grad_err = abs(l_card / l_cpu - 1), _rel_l2(g_card, g_cpu)
        print(f"  batch 2 x {t} frames ({t // cfg.frames_per_step} decoder steps), dropout masks "
              f"handed in, TF32 off: loss {l_card:.6f} vs {l_cpu:.6f}, relative error "
              f"{loss_err:.3g} (bound 1e-5); gradients relative L2 {grad_err:.3g} (bound 1e-3)")
        check(loss_err <= 1e-5, f"the f32 ppg2mel loss on the card differs by {loss_err}")
        check(grad_err <= 1e-3, f"the f32 ppg2mel gradients differ by {grad_err}")


# ---------------------------------------------------------------------------
# the emotion extractor, the server and the CLI
# ---------------------------------------------------------------------------

def _emo_wavs(seed: int, seconds) -> list:
    rng = np.random.RandomState(seed)
    return [_tone_wav(rng, s, rng.uniform(100, 260)) for s in seconds]


def phase_emotion(dev, tmp: Path):
    with Phase("emotion extractor: wav2emo_config() at full width, seeded, f32"):
        ex = EmotionExtractor(seed=0, device=dev)
        check(ex.available, "the seeded extractor is not available")
        check_config("wav2emo", ex.cfg, wav2emo_config())
        n_params = sum(p.numel() for p in ex.model.parameters())
        print(f"  {ex.cfg.num_hidden_layers} x {ex.cfg.hidden_size} "
              f"{'pre' if ex.cfg.do_stable_layer_norm else 'post'}-LN, "
              f"{len(ex.cfg.conv_dim)} conv layers ({ex.cfg.feat_extract_norm} norm), "
              f"{n_params} parameters in {next(ex.model.parameters()).dtype}")
        wavs = _emo_wavs(0, EMO_SECONDS)
        audio_s = sum(len(w) for w in wavs) / 16000
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.extract_batch(wavs)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        walls = []
        for _ in range(EMO_REPS):
            t0 = time.perf_counter()
            emb, logits = ex.extract_batch(wavs)
            walls.append(time.perf_counter() - t0)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        best = min(walls)
        print(f"  extract_batch of {len(wavs)} wavs of {min(EMO_SECONDS)}-{max(EMO_SECONDS)} s "
              f"({audio_s:.2f} s of audio, padded to {int(np.ceil(max(EMO_SECONDS)))} s): first "
              f"call {first:.4f} s, warm {[round(w, 4) for w in walls]} s per batch")
        print(f"  emotion audio s per wall s: {audio_s / best:.1f} (best warm batch)")
        print(f"  emotion peak memory: {peak:.3f} GiB")
        print(f"  launches on the emotion path: {launches} (the path needs no kernel)")
        check(not any(launches.values()), f"a kernel launched on the emotion path: {launches}")
        check(emb.shape == (len(wavs), ex.cfg.hidden_size) and logits.shape == (len(wavs), 3),
              f"embedding shapes {emb.shape}, {logits.shape}")
        check(bool(np.isfinite(emb).all() and np.isfinite(logits).all()), "non-finite output")
        check(float(np.abs(emb).min(axis=1).max()) > 0 and float(np.abs(emb).max()) > 0,
              "a zero embedding from seeded weights")

    with Phase("emotion extractor on the card against the CPU (f32, TF32 off)"):
        cpu = EmotionExtractor(seed=0, device="cpu")
        pair = _emo_wavs(1, (2.0, 2.0))
        with full_f32():
            card_out = ex.extract_batch(pair)
        cpu_out = cpu.extract_batch(pair)
        errs = [float(np.linalg.norm(g - c) / np.linalg.norm(c))
                for g, c in zip(card_out, cpu_out)]
        print(f"  2 x 2 s: relative L2 embeddings {errs[0]:.3g}, logits {errs[1]:.3g} "
              f"(bound 1e-4)")
        check(max(errs) <= 1e-4, f"the f32 extractor on the card differs from the CPU: {errs}")
        del cpu

    with Phase("create_emotion_embeddings over a 16-utterance synthesizer root"):
        root = tmp / "syn"
        (root / "audio").mkdir(parents=True)
        wavs = _emo_wavs(2, np.linspace(1.0, 3.0, EMO_UTTS))
        rows = []
        for i, w in enumerate(wavs):
            np.save(root / "audio" / f"audio-spk{i % 4}_utt{i:02d}.npy", w)
            rows.append(f"audio-spk{i % 4}_utt{i:02d}.npy|mel-spk{i % 4}_utt{i:02d}.npy|"
                        f"embed-spk{i % 4}_utt{i:02d}.npy|{len(w)}|{len(w) // 256}|ni3 hao3")
        (root / "train.txt").write_text("\n".join(rows) + "\n")
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        create_emotion_embeddings(root, seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        files = sorted((root / "emo").glob("emo-*.npy"))
        print(f"  {len(files)} files in {wall:.3f} s (extractor build included); "
              f"launches {launches}")
        check(len(files) == EMO_UTTS, f"{len(files)} emotion files for {EMO_UTTS} utterances")
        check(not any(launches.values()), f"a kernel launched on the emotion path: {launches}")
        ds = VitsDataset(root, Config(vits_config()).merge(Config.from_json(VITS_JSON)))
        got = ds[0][4]
        want = ex.extract_batch(wavs[:8])[0][0]      # the first batch the preprocessor ran
        err = float(np.abs(got - want).max())
        print(f"  VitsDataset reads {ds.items[0][0]}'s vector back: max |file - extractor| "
              f"{err:.3g} (bound 1e-5)")
        check(got.shape == (ex.cfg.hidden_size,) and err <= 1e-5, "the emotion file differs")


def _request(url: str, path: str, payload=None, kind: str = "json"):
    """A GET (no payload), JSON or multipart POST request; a multipart
    payload maps field names to (file name or None, str or bytes)."""
    if payload is None:
        return urllib.request.Request(url + path)
    if kind == "json":
        return urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                      headers={"Content-Type": "application/json"})
    boundary = "smokeBOUNDARY"
    parts = []
    for name, (fname, data) in payload.items():
        head = f'Content-Disposition: form-data; name="{name}"'
        if fname:
            head += f'; filename="{fname}"'
        data = data.encode() if isinstance(data, str) else data
        parts.append(f"--{boundary}\r\n{head}\r\n\r\n".encode() + data + b"\r\n")
    return urllib.request.Request(
        url + path, data=b"".join(parts) + f"--{boundary}--\r\n".encode(),
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})


def _http(url: str, path: str, payload=None, kind: str = "json", timeout: float = 300):
    """(headers, body, wall s) of one request to the server; a status other
    than 200 raises."""
    req = _request(url, path, payload, kind)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
        status, headers = r.status, dict(r.headers)
    wall = time.perf_counter() - t0
    check(status == 200, f"{path}: status {status}")
    if "json" in headers.get("Content-Type", ""):
        body = json.loads(body)
    return headers, body, wall


def _wav_of(body: bytes):
    with wave.open(io.BytesIO(body)) as w:
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), np.int16)


def phase_serve(dev, tmp: Path):
    root = tmp / "datasets"
    ref_bytes = REF_WAV.read_bytes()
    for i in range(2):
        d = root / "LJSpeech-1.1" / "wavs"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"LJ001-000{i}.wav").write_bytes(ref_bytes)
    save_wav(np.tile(load_wav(REF_WAV)[0], 4), tmp / "src.wav", 16000)
    src_bytes = (tmp / "src.wav").read_bytes()
    built = {}

    def pipeline_factory():
        voc = GanVocoder("hifigan", cfg=dict(Config.from_json(GAN_JSON), **GAN_CFG),
                         verbose=False, seed=0, device=dev)
        built["pipe"] = VoiceCloningPipeline(vocoder=voc, verbose=False, seed=0, device=dev)
        return built["pipe"]

    def vocoder_factory(name):
        if name == "wavernn":
            built["wavernn"] = WaveRnnVocoder(verbose=False, seed=0, device=dev)
            return built["wavernn"]
        if name == "hifigan":
            return built["pipe"].vocoder
        return GanVocoder(name, verbose=False, seed=0, device=dev)

    tb = WebToolbox(datasets_root=root, seed=0, device=dev, pipeline_factory=pipeline_factory,
                    vocoder_factory=vocoder_factory)
    # the sampler's inputs on the WaveRNN vocode, for the hold below; the
    # count stays the wrapper's
    sampled = []

    def sampling(weights, mels, aux, seed, n_classes=512, greedy=False):
        sampled.append((weights, mels, aux, seed, n_classes, greedy))
        return wavernn_sample(weights, mels, aux, seed, n_classes, greedy)

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    srv = serve(port=0, block=False, toolbox=tb)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with Phase("server: the port's serve() on the card, seeded full-width pipeline"):
            _, body, wall = _http(url, "/api/health")
            check(body == {"status": "ok"}, f"health {body}")
            _, res, wall = _http(url, "/api/embed", {"ref": ("ref.wav", ref_bytes),
                                                     "name": (None, "ref")}, "multipart")
            pipe = built["pipe"]
            pipe.synthesizer.load()
            check_config("Tacotron", pipe.synthesizer.cfg, TACOTRON_JSON)
            check_config("HiFi-GAN", pipe.vocoder.cfg, GAN_JSON)
            print(f"  /api/embed: {wall:.3f} s (the pipeline's build included), "
                  f"{len(res['embed'])}-d")
            check(len(res["embed"]) == 256, "embedding width")
            _, res, wall = _http(url, "/api/synthesize_mel",
                                 {"text": TEXTS[0], "utterance": "ref", "steps": STEPS})
            print(f"  /api/synthesize_mel ({STEPS} steps): {wall:.3f} s, mel {res['mel_shape']}")
            check(res["mel_shape"][0] == 80, f"mel shape {res['mel_shape']}")
            for name in ("hifigan", "wavernn", "griffinlim"):
                before = read_counts()["wavernn_sample"]
                wavernn_module.wavernn_sample = sampling
                try:
                    hdrs, body, wall = _http(url, "/api/vocode", {"vocoder": name})
                finally:
                    wavernn_module.wavernn_sample = wavernn_sample
                k1 = read_counts()["wavernn_sample"] - before
                sr, pcm = _wav_of(body)
                print(f"  /api/vocode {name}: {wall:.3f} s, {len(pcm)} samples at {sr} Hz, "
                      f"X-RTF {hdrs['X-RTF']}, K1 launches {k1}")
                check(sr == 16000 and len(pcm) > 0 and int(np.abs(pcm).max()) > 0,
                      f"{name} vocoded an empty or silent wav")
                check(k1 >= 1 if name == "wavernn" else k1 == 0,
                      f"{name}: {k1} K1 launches")

            text = TEXTS[0]
            hdrs, body, wall = _http(url, "/api/synthesize", {"text": (None, text),
                                                              "ref": ("r.wav", ref_bytes)},
                                     "multipart")
            check(hdrs.get("X-Coalesced") == "1", "the one-shot request was not coalesced")
            direct = pipe.tts_batch([text], None,
                                    embed=pipe.embed_reference(read_audio(ref_bytes, 16000)))[0]
            _, want = _wav_of(_wav_bytes(direct.astype(np.float32) / 32767.0, 16000))
            _, got = _wav_of(body)
            diff = int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max())
            print(f"  /api/synthesize: {wall:.3f} s, {len(got)} samples, max |server - "
                  f"tts_batch| {diff} int16 steps (bound 1)")
            check(len(got) == len(want) > 0 and diff <= 1, "the server's wav differs")

        with Phase(f"server: {SERVE_CONCURRENT} concurrent default /api/synthesize requests"):
            batcher = srv.batcher["batcher"]
            before = batcher.dispatches
            refs = [ref_bytes] * SERVE_CONCURRENT
            # each coalesced dispatch's texts and embeddings, for the hold below
            dispatched = []

            def recording(texts, ref_wav, embed=None, **kw):
                dispatched.append((list(texts), np.array(embed)))
                return type(pipe).tts_batch(pipe, texts, ref_wav, embed=embed, **kw)

            def one(i):
                return _http(url, "/api/synthesize", {"text": (None, SERVE_TEXTS[i]),
                                                      "ref": ("r.wav", refs[i])}, "multipart")

            pipe.tts_batch = recording
            try:
                t0 = time.perf_counter()
                with ThreadPoolExecutor(SERVE_CONCURRENT) as pool:
                    results = list(pool.map(one, range(SERVE_CONCURRENT)))
                wall = time.perf_counter() - t0
            finally:
                del pipe.tts_batch
            dispatches = batcher.dispatches - before
            audio_s = sum(len(_wav_of(b)[1]) for _, b, _ in results) / 16000
            print(f"  tts_batch dispatches: {dispatches} for {SERVE_CONCURRENT} requests")
            print(f"  per-request wall s: {[round(w, 3) for _, _, w in results]}")
            print(f"  requests per second: {SERVE_CONCURRENT / wall:.2f} ({wall:.3f} s for all, "
                  f"{audio_s:.2f} s of audio)")
            check(all(h.get("X-Coalesced") == "1" for h, _, _ in results), "not coalesced")
            check(dispatches < SERVE_CONCURRENT, f"{dispatches} dispatches: no coalescing")
            # every response against a direct tts_batch of its own dispatch
            # (the same texts and embeddings in the same batch), within one
            # int16 step after _wav_bytes' peak scaling
            check(len(dispatched) == dispatches and sorted(t for d, _ in dispatched for t in d)
                  == sorted(SERVE_TEXTS), f"dispatched {[d for d, _ in dispatched]}")
            got = {SERVE_TEXTS[i]: _wav_of(b)[1] for i, (_, b, _) in enumerate(results)}
            worst = 0
            for texts, embeds in dispatched:
                for text, pcm in zip(texts, pipe.tts_batch(texts, None, embed=embeds)):
                    _, want = _wav_of(_wav_bytes(pcm.astype(np.float32) / 32767.0, 16000))
                    check(len(got[text]) == len(want) > 0, f"{text!r}: {len(got[text])} "
                          f"samples, tts_batch {len(want)}")
                    worst = max(worst, int(np.abs(got[text].astype(np.int32)
                                                  - want.astype(np.int32)).max()))
            print(f"  dispatch sizes {[len(d) for d, _ in dispatched]}; max |server - tts_batch "
                  f"of the same dispatch| over all {SERVE_CONCURRENT} responses: {worst} int16 "
                  f"steps (bound 1)")
            check(worst <= 1, "a coalesced response differs from its dispatch's tts_batch")

        with Phase("server: /api/stream_tts and /api/convert"):
            req = _request(url, "/api/stream_tts", {"text": (None, SERVE_STREAM_TEXT),
                                                    "ref": ("r.wav", ref_bytes)}, "multipart")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                head = r.read(44)
                first_pcm = r.read(2)
                t_first = time.perf_counter() - t0
                rest = r.read()
                n_chunks = int(r.headers["X-Chunks"])
            total = time.perf_counter() - t0
            pcm = np.frombuffer(first_pcm + rest, np.int16)
            print(f"  /api/stream_tts: {n_chunks} chunks, first chunk after {t_first:.3f} s, "
                  f"all after {total:.3f} s, {len(pcm)} samples")
            check(head[:4] == b"RIFF" and n_chunks > 1 and len(pcm) > 0, "stream_tts output")
            hdrs, body, wall = _http(url, "/api/convert", {"ref": ("r.wav", ref_bytes),
                                                           "src": ("s.wav", src_bytes)},
                                     "multipart", timeout=300)
            sr, pcm = _wav_of(body)
            print(f"  /api/convert (PPG-VC, HiFi-GAN): {wall:.3f} s (the converter's build "
                  f"included), {len(pcm)} samples, X-RTF {hdrs['X-RTF']}")
            check(sr == 16000 and len(pcm) > 0, "convert output")
            launches = read_counts()
            print(f"  launches on the server path: {launches} (K1 on the WaveRNN vocode only)")
            print(f"  server peak memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
            check(launches["wavernn_sample"] >= 1 and launches["maximum_path"] == 0
                  and launches["wavernn_sample(time_major=False)"] == 0,
                  f"launches on the server path {launches}")
    finally:
        srv.shutdown()
        srv.server_close()
    check(not batcher._thread.is_alive() and batcher.pipe is None,
          "the coalescer outlived the server")

    with Phase("server: K1 on the WaveRNN vocode's inputs against its plain version"):
        check(len(sampled) == 1, f"{len(sampled)} sampler calls on the WaveRNN vocode")
        w_bf16, mels, aux, seed, n_classes, greedy_path = sampled[0]
        voc = built["wavernn"]
        check(w_bf16 is voc.packed and not greedy_path,
              "the vocode did not sample with the vocoder's packed weights")
        w_f32 = pack_wavernn_weights(voc.model, torch.float32)
        f, t, _ = mels.shape
        print(f"  held: F={f} folds x T={t} steps, mels {tuple(mels.shape)}, aux "
              f"{tuple(aux.shape)}, seed {seed}")
        k1_err = hold_k1_call(w_f32, w_bf16, mels, aux, seed, n_classes)
        k1_ms = cuda_ms(lambda: wavernn_sample(w_bf16, mels, aux, seed, n_classes), reps=3)
        k1_plain_ms = cuda_ms(lambda: wavernn_sample_plain(w_bf16, mels, aux, seed, n_classes))
        print(f"  K1 at this path's call (bf16, sampled): {k1_ms:.3f} ms ({k1_ms / t * 1e3:.2f} "
              f"us per step), plain {k1_plain_ms:.3f} ms ({tf32_state()})")
    return built["pipe"], k1_err


def phase_cli(pipe, tmp: Path):
    with Phase("CLI: python -m mockingbird_tpu_torch.cli tts, in a subprocess"):
        # the flagship's seeded HiFi-GAN at the committed width, as an export
        save_npz(tmp / "vocoder_hifigan.npz", to_flax(pipe.vocoder.model))
        (tmp / "vocoder_hifigan.json").write_text(json.dumps(pipe.vocoder.cfg.to_dict()))
        out = tmp / "cli.wav"
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "mockingbird_tpu_torch.cli", "--device",
                              str(pipe.device), "tts", TEXTS[0],
                              "--ref", str(REF_WAV), "--out", str(out),
                              "--vocoder", str(tmp / "vocoder_hifigan.npz")],
                             cwd=ROOT, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        check(run.returncode == 0, f"the CLI failed: {run.stderr[-2000:]}")
        line = [ln for ln in run.stdout.splitlines() if ln.startswith("Wrote")]
        check(len(line) == 1 and out.exists(), f"the CLI wrote no wav: {run.stdout[-1000:]}")
        sr, wav = _wav_of(out.read_bytes())
        print(f"  {line[0]}; process wall {wall:.2f} s (start-up and build included), "
              f"{len(wav)} samples at {sr} Hz")
        check(sr == 16000 and len(wav) > 0 and len(wav) % 256 == 0, f"CLI wav {sr} Hz, "
              f"{len(wav)} samples")


# ---------------------------------------------------------------------------
# data parallelism, the checkpoint importer, the unbatched WaveRNN generator
# ---------------------------------------------------------------------------

def _vits_hparams(cfg) -> str:
    """``--hparams`` that turn the CLI's ``vits_config()`` into ``cfg``."""
    base = vits_config()
    return ",".join(f"{k}={v!r}" for k, v in cfg.to_dict().items()
                    if k not in base or base[k] != v)


def _logged(models: Path, run_id: str) -> tuple:
    """(each step's losses (gen, disc, mel, dur, kl), each step's ms) that
    the VITS trainer logged."""
    recs = [json.loads(line) for line in
            (models / run_id / "logs_vits" / "scalars.jsonl").read_text().splitlines()]
    keys = ("train/gen", "train/disc", "train/mel", "train/dur", "train/kl")
    return [[r[k] for k in keys] for r in recs], [r["train/ms_per_step"] for r in recs]


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-12)))


def _reports(stdout: str) -> list:
    return [json.loads(ln.split(" ", 1)[1]) for ln in stdout.splitlines()
            if ln.startswith("RUN_REPORT ")]


def _env(**extra) -> dict:
    import os
    env = {k: v for k, v in os.environ.items() if not k.startswith("MB_")}
    env.update(extra)
    return env


def _vits_run(run_id: str, data: Path, models: Path, cfg, batch: int, steps: int, dev):
    """``vits_train`` in f32 with a record per step; returns its wall seconds."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    vits_train(run_id, data, models, cfg=cfg, batch_size=batch, total_steps=steps,
               save_every=0, log_every=1, eval_every=0, precision="fp32", device=dev)
    sync()
    return time.perf_counter() - t0


def phase_parallel_nccl(dev, tmp: Path):
    """``cli launch --nprocs 1 -- train-vits``: one NCCL rank (the ``MB_*``
    environment, ``initialize_from_env``) on the VITS training phase's data
    and config, f32, against the same 3 steps in this process, both with
    deterministic algorithms (``deterministic``; in the rank through a
    ``sitecustomize``)."""
    cfg = Config(vits_config()).merge(Config.from_json(VITS_JSON)).merge(VITS_CFG)
    _write_dataset(tmp / "data", cfg)
    (tmp / "site").mkdir()
    (tmp / "site/sitecustomize.py").write_text(DETERMINISTIC_SITE)
    with Phase(f"parallel (NCCL): launch --nprocs 1 -- train-vits, {PAR_STEPS} steps, "
               f"batch {TRAIN_BATCH}, f32, deterministic algorithms"):
        zero_counts()
        with deterministic():
            wall_one = _vits_run("one", tmp / "data", tmp / "m1", cfg, TRAIN_BATCH, PAR_STEPS,
                                 dev)
        here = read_counts()
        check(here["maximum_path"] == PAR_STEPS, f"K2 launched {here['maximum_path']} times "
              f"in the in-process run")
        zero_counts()
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "mockingbird_tpu_torch.cli", "--device", dev.type,
             "--hparams", _vits_hparams(cfg), "launch", "--nprocs", "1", "--",
             "train-vits", str(tmp / "data"), "nccl", "-m", str(tmp / "m2"), "--batch_size",
             str(TRAIN_BATCH), "--total_steps", str(PAR_STEPS), "--precision", "fp32",
             "--log_every", "1"],
            cwd=ROOT, env=_env(MB_RUN_REPORT="1", PYTHONPATH=str(tmp / "site")),
            capture_output=True, text=True, timeout=600)
        wall_launch = time.perf_counter() - t0
        check(run.returncode == 0, f"launch failed: {run.stdout[-1500:]} {run.stderr[-1500:]}")
        reports = _reports(run.stdout)
        check(len(reports) == 1 and reports[0]["world"] == 1, f"rank reports {reports}")
        launches = reports[0]["launches"]
        print(f"  the rank's report: {reports[0]}")
        check(launches["maximum_path"] == PAR_STEPS,
              f"K2 launched {launches['maximum_path']} times on the rank in {PAR_STEPS} steps")
        (one, ms_one), (two, ms_two) = _logged(tmp / "m1", "one"), _logged(tmp / "m2", "nccl")
        err = _rel_err(two, one)
        for step, (a, b) in enumerate(zip(one, two), 1):
            print(f"  step {step}: in-process (gen, disc, mel, dur, kl) {a}; NCCL rank {b}")
        print(f"  largest relative difference {err:.3g} (bound 1e-5); ms per step in-process "
              f"{ms_one}, on the NCCL rank {ms_two} (step 1 includes the first calls); wall "
              f"{wall_one:.2f} s in-process, {wall_launch:.2f} s for the launch (process start "
              f"and the model's build included); {tf32_state()}")
        check(len(one) == len(two) == PAR_STEPS and err <= 1e-5,
              f"the NCCL rank's losses differ from the in-process run's by {err:.3g}")
    return launches


def gloo_vits_rank(data: str, models: str, cfg: str, batch: int, steps: int,
                   device: str = DEVICE) -> None:
    """One rank of ``phase_parallel_gloo`` (run in its own process with the
    ``MB_*`` environment): a gloo group over ``device``'s tensors, then VITS
    training of this rank's rows at the config ``cfg`` (JSON), TF32 off and
    deterministic algorithms on."""
    from mockingbird_tpu_torch.parallel import multihost
    started = multihost.initialize_from_env(device, backend="gloo")
    check(started and torch.distributed.get_backend() == "gloo", "no gloo group")
    with full_f32(), deterministic():
        zero_counts()
        _vits_run("gloo", Path(data), Path(models), Config(json.loads(cfg)), batch, steps,
                  multihost.rank_device(device))
    print("RUN_REPORT " + json.dumps({"rank": multihost.process_index(),
                                      "world": multihost.process_count(),
                                      "launches": read_counts()}), flush=True)
    multihost.shutdown()


def gloo_vits_ranks(tmp: Path, cfg, steps: int, dev) -> list:
    """Two ``gloo_vits_rank`` processes on ``tmp / "data"``, training into
    ``tmp / "m2"`` (run ``gloo``) → their ``RUN_REPORT`` dicts."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    code = (f"import chip_smoke as cs; cs.gloo_vits_rank({str(tmp / 'data')!r}, "
            f"{str(tmp / 'm2')!r}, {json.dumps(cfg.to_dict())!r}, {TRAIN_BATCH // 2}, "
            f"{steps}, {dev.type!r})")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=_env(MB_COORDINATOR=f"localhost:{port}",
                                       MB_NUM_PROCESSES="2", MB_PROCESS_ID=str(r)))
             for r in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for proc, out in zip(procs, outs):
        check(proc.returncode == 0, f"a gloo rank failed: {out[-3000:]}")
    return [r for out in outs for r in _reports(out)]


def phase_parallel_gloo(dev, tmp: Path):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device), CUDA tensors, against one rank on the whole batch, TF32 off and
    deterministic algorithms on."""
    cfg = Config(vits_config()).merge(Config.from_json(VITS_JSON)).merge(VITS_CFG)
    _write_dataset(tmp / "data", cfg)
    with Phase(f"parallel (2 ranks on the card, gloo): VITS, {GLOO_STEPS} steps of "
               f"{TRAIN_BATCH // 2} rows per rank, f32"):
        with full_f32(), deterministic():
            zero_counts()
            wall_one = _vits_run("one", tmp / "data", tmp / "m1", cfg, TRAIN_BATCH, GLOO_STEPS,
                                 dev)
        t0 = time.perf_counter()
        reports = gloo_vits_ranks(tmp, cfg, GLOO_STEPS, dev)
        wall_two = time.perf_counter() - t0
        print(f"  the ranks' reports: {reports}")
        check(sorted(r["rank"] for r in reports) == [0, 1]
              and all(r["launches"]["maximum_path"] == GLOO_STEPS for r in reports),
              f"K2 did not launch once per step on each rank: {reports}")
        (one, ms_one), (two, ms_two) = _logged(tmp / "m1", "one"), _logged(tmp / "m2", "gloo")
        for step, (a, b) in enumerate(zip(one, two), 1):
            print(f"  step {step}: one rank (gen, disc, mel, dur, kl) {a}; two ranks {b}; "
                  f"relative difference {_rel_err(b, a):.3g}")
        err = _rel_err(two, one)
        print(f"  largest relative difference {err:.3g} (bound 1e-5); ms per step one rank "
              f"{ms_one}, two gloo ranks on one card (rank 0) {ms_two}; wall {wall_one:.2f} s "
              f"one rank, {wall_two:.2f} s the two ranks' processes")
        check(len(one) == len(two) == GLOO_STEPS and err <= 1e-5,
              f"two gloo ranks differ from one rank by {err:.3g}")
    return sum(r["launches"]["maximum_path"] for r in reports)


def _hifigan_state_dict(tree: dict, cfg) -> dict:
    """The reference HiFi-GAN's ``state_dict`` layout of a generator's flax
    tree (the importer's inverse): torch kernels with weight norm stored as
    ``weight_v`` and ``weight_g = ||v||`` per output slice."""
    def wn(prefix, parent, name, transposed=False):
        conv, scale = parent[f"{name}_conv"], parent[name][f"{name}_conv/kernel/scale"]
        k = conv["kernel"]
        eff = k * scale / np.sqrt(np.sum(k.reshape(-1, k.shape[-1]) ** 2, axis=0))
        w = (np.transpose(eff, (1, 2, 0))[:, :, ::-1] if transposed
             else np.transpose(eff, (2, 1, 0)))
        w = np.ascontiguousarray(w, np.float32)
        sd[f"{prefix}.weight_v"] = torch.from_numpy(w)
        sd[f"{prefix}.weight_g"] = torch.from_numpy(np.sqrt(np.sum(
            w.reshape(w.shape[0], -1) ** 2, axis=1)).reshape(-1, 1, 1).astype(np.float32))
        sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(conv["bias"], np.float32))

    sd: dict = {}
    p = tree["params"]
    wn("conv_pre", p, "conv_pre")
    wn("conv_post", p, "conv_post")
    n_k = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        wn(f"ups.{i}", p, f"ups_{i}", transposed=True)
        for j in range(n_k):
            blk = p[f"resblock_{i}_{j}"]
            for c in range(3):
                for half in ("convs1", "convs2"):
                    wn(f"resblocks.{i * n_k + j}.{half}.{c}", blk, f"{half}_{c}")
    return sd


def phase_import(dev, tmp: Path):
    """``cli import-checkpoint --family hifigan`` of a reference-layout
    state_dict made from the flagship HiFi-GAN's seeded weights: the
    ``.npz`` in ``GanVocoder`` on the card against the same generator from
    its flax tree, TF32 off."""
    with Phase("import: cli import-checkpoint --family hifigan, the flagship's width"):
        cfg = Config(hifigan_config()).merge(Config.from_json(GAN_JSON)).merge(GAN_CFG)
        direct = GanVocoder("hifigan", cfg=dict(cfg), verbose=False, seed=0, half=False,
                            device=dev)
        tree = to_flax(direct.model)
        torch.save({"generator": _hifigan_state_dict(tree, cfg), "steps": 0},
                   tmp / "g_00000000")
        (tmp / "hifigan.json").write_text(json.dumps(cfg.to_dict()))
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "mockingbird_tpu_torch.cli", "--device",
                              dev.type, "import-checkpoint", "--family", "hifigan",
                              "--torch-ckpt", str(tmp / "g_00000000"), "--out",
                              str(tmp / "imported"), "--config", str(tmp / "hifigan.json")],
                             cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        check(run.returncode == 0, f"import-checkpoint failed: {run.stderr[-2000:]}")
        print(f"  {run.stdout.strip().splitlines()[-1]} ({wall:.2f} s, process start included)")
        imported = GanVocoder("hifigan", tmp / "imported.npz", verbose=False, half=False,
                              device=dev)
        check(imported.cfg.to_dict() == cfg.to_dict(), "the sidecar's config differs")
        mel = np.random.RandomState(0).randn(80, 120).astype(np.float32)
        with full_f32():
            got, want = imported.infer_waveform(mel), direct.infer_waveform(mel)
        err = float(np.max(np.abs(got - want)))
        peak = float(np.max(np.abs(want)))
        print(f"  vocoded {len(want)} samples; max |imported - direct| {err:.3g}, "
              f"{err / peak:.3g} of the peak {peak:.3g} (bound 1e-5 of it), TF32 off")
        check(got.shape == want.shape and err <= 1e-5 * peak,
              f"the imported generator differs by {err:.3g}")


def phase_unbatched(dev):
    """``WaveRnnVocoder.infer_waveform(batched=False)`` at the committed RAW
    width, seeded: one K1 launch at F=1 over the whole utterance, held
    against the plain version, and timed."""
    cfg = Config(wavernn_config()).merge(Config.from_json(WAVERNN_JSON))
    voc = WaveRnnVocoder(cfg=cfg, verbose=False, seed=0, device=dev)
    frames = int(round(UNBATCHED_SECONDS * cfg.sample_rate / cfg.hop_size))
    mel = np.random.RandomState(1).randn(80, frames).astype(np.float32)
    captured = []

    def recording(w, mels, aux, seed, n_classes, **kw):
        captured.append((mels, aux, seed, n_classes))
        return wavernn_sample(w, mels, aux, seed, n_classes, **kw)

    with Phase(f"unbatched WaveRNN: infer_waveform(batched=False), {frames} frames, F=1"):
        wavernn_module.wavernn_sample = recording
        try:
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wav = voc.infer_waveform(mel, batched=False)
            wall = time.perf_counter() - t0
            launches = read_counts()
        finally:
            wavernn_module.wavernn_sample = wavernn_sample
        print(f"  launches: {launches}; {len(wav)} samples in {wall:.3f} s (first call: "
              f"packing and the upsampler included)")
        check(launches["wavernn_sample"] == 1 and len(captured) == 1,
              f"K1 launched {launches['wavernn_sample']} times")
        mels, aux, seed, n_classes = captured[0]
        f, t, _ = mels.shape
        check(f == 1 and t == frames * cfg.hop_size, f"K1 ran at F={f}, T={t}")
        check(wav.shape == ((frames - 1) * cfg.hop_size,) and np.isfinite(wav).all(),
              f"unbatched wav {wav.shape}")
        err = hold_k1_call(pack_wavernn_weights(voc.model, torch.float32), voc.packed, mels,
                           aux, seed, n_classes)
        ms = cuda_ms(lambda: wavernn_sample(voc.packed, mels, aux, seed, n_classes), reps=3)
        print(f"  K1 at F=1, T={t}: {ms:.3f} ms, {ms / t * 1e3:.2f} us per step "
              f"({UNBATCHED_SECONDS} s of audio: {UNBATCHED_SECONDS * 1e3 / ms:.2f}x real "
              f"time)")
    return launches, err


# ---------------------------------------------------------------------------
# the kernels against their plain versions
# ---------------------------------------------------------------------------

def mas_cases(dev, b=16, t_y=1000, t_x=160):
    """Ragged and tied (neg_cent, mask) cases at the training shape."""
    rng = np.random.RandomState(0)

    def case(nc, t_ys, t_xs):
        ty, tx = nc.shape[1:]
        mask = ((np.arange(ty)[None, :, None] < np.asarray(t_ys)[:, None, None])
                & (np.arange(tx)[None, None, :] < np.asarray(t_xs)[:, None, None]))
        return (torch.from_numpy(nc.astype(np.float32)).to(dev),
                torch.from_numpy(mask.astype(np.float32)).to(dev))

    t_xs = rng.randint(1, t_x + 1, b)
    yield "ragged", case(rng.randn(b, t_y, t_x), np.maximum(rng.randint(1, t_y + 1, b), t_xs),
                         t_xs)
    yield "ties", case(np.round(rng.randn(b, t_y, t_x)), np.full(b, t_y), np.full(b, t_x))
    yield "T_x = 1", case(rng.randn(b, t_y, 1), rng.randint(1, t_y + 1, b), np.ones(b, int))
    sq = rng.randint(1, t_x + 1, b)
    yield "T_y = T_x", case(rng.randn(b, t_x, t_x), sq, sq)
    yield "T_y >> T_x", case(rng.randn(b, t_y, 12), rng.randint(t_y - t_y // 10, t_y + 1, b),
                             rng.randint(1, 13, b))
    # no band where t_y < t_x: every cell -1e9; neg_cent ~1e3 survives an
    # add to -1e9, so a cell wrongly taken in would change the path
    short = rng.randint(1, t_x // 2, b)
    yield "T_y < T_x", case(1000 * rng.randn(b, t_x // 2, t_x), short,
                            np.minimum(short + rng.randint(0, t_x // 2, b), t_x))


def phase_k2(dev, train_inputs, launches):
    with Phase("K2 maximum_path: kernel against its plain version"):
        nc_train, mask_train = train_inputs
        cases = [("training step", (nc_train, mask_train))] + list(mas_cases(dev))
        max_err = 0.0
        for name, (nc, mask) in cases:  # exact: no matmul or conv, TF32 plays no part
            nc32 = (nc.float() * mask).contiguous()
            t_ys = mask[:, :, 0].float().sum(1).int()
            t_xs = mask[:, 0, :].float().sum(1).int()
            k = maximum_path_cuda(nc32, t_ys, t_xs)
            p = maximum_path_plain(nc32, t_ys, t_xs)
            torch.cuda.synchronize()
            n_diff = int((k != p).sum())
            max_err = max(max_err, float((k - p).abs().max()))
            print(f"  {name}: {tuple(nc.shape)}, {n_diff} of {k.numel()} elements differ")
            check(n_diff == 0, f"K2 differs from its plain version on {name}")
            check(torch.equal(k.sum((1, 2)).int(), t_ys), f"K2 path rows on {name}")
        nc32 = (nc_train.float() * mask_train).contiguous()
        t_ys = mask_train[:, :, 0].float().sum(1).int()
        t_xs = mask_train[:, 0, :].float().sum(1).int()
        # the whole function per call (the path's zero fill and the kernel,
        # the work bound_ms counts); the kernel's own device time beside it
        ms = cuda_ms(lambda: maximum_path_cuda(nc32, t_ys, t_xs), reps=20)
        kernel_ms = device_ms(lambda: maximum_path_cuda(nc32, t_ys, t_xs),
                              "maximum_path_kernel")
        plain_ms = cuda_ms(lambda: maximum_path_plain(nc32, t_ys, t_xs))
        b, t_y, t_x = nc32.shape
        cells = int((t_ys.long() * t_xs.long()).sum())
        n_bytes = cells * 4 + 2 * b * 4 + b * t_y * t_x * 4
        flops = 3.0 * cells
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        kernel_s = (f"{kernel_ms:.4f} ms" if kernel_ms is not None
                    else "not measured (the profiler trace holds no maximum_path_kernel)")
        print(f"  training shape {tuple(nc32.shape)}: {ms:.4f} ms per call by CUDA events "
              f"(zero fill and kernel), the kernel alone {kernel_s} of device time "
              f"(profiler), plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({n_bytes} B: "
              f"the {cells} cells inside the lengths read, the path written; {flops:.3g} "
              f"FLOP); the rows are a chain of {int(t_ys.max())} dependent warp-wide steps, "
              f"{ms / int(t_ys.max()) * 1e3:.3f} us each per call; no single PyTorch call "
              f"computes MAS")
        # T_x = 1 at the same T_y: a trivial forward and the same T_y-step
        # backtrack, an upper bound of the backtrack's share
        tx1 = torch.full((b,), int(t_ys.max()), dtype=torch.int32, device=dev)
        nc1 = torch.randn(b, t_y, 1, device=dev)
        one = torch.ones_like(tx1)
        ms1 = device_ms(lambda: maximum_path_cuda(nc1, tx1, one), "maximum_path_kernel")
        if ms1 is not None and kernel_ms is not None:
            print(f"  T_x = 1, T_y = {t_y}: kernel {ms1:.4f} ms of device time, so at most "
                  f"{100 * ms1 / kernel_ms:.0f}% of the kernel's time at the training shape "
                  f"is the one-thread backtrack")
        else:
            print("  the backtrack's share: not measured (no kernel in the profiler trace)")
    return {"name": "maximum_path", "route": "cuda",
            "source": "mockingbird_tpu_torch/ops/csrc/monotonic_align.cu",
            "replaces": "mockingbird_tpu/ops/monotonic_align_pallas.py:27",
            "launches": launches["maximum_path"], "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None}


def phase_k1(dev, pipe, captured, launches, path_err):
    """K1's hold at the TTS path's call; ``path_err`` is its largest error
    at the WaveRNN trainer's and the server's calls, held there, which its
    ``max_abs_err`` takes in."""
    with Phase("K1 wavernn_sample and K1b (fold-major): kernel against its plain version"):
        check(len(captured) == 1, f"expected one sampler call, got {len(captured)}")
        mels, aux, seed, n_classes, _ = captured[0]
        f, t, _ = mels.shape
        print(f"  shapes from the TTS path: F={f} folds x T={t} steps, "
              f"mels {tuple(mels.shape)}, aux {tuple(aux.shape)}")
        w_bf16 = pipe.vocoder.packed
        w_f32 = pack_wavernn_weights(pipe.vocoder.model, torch.float32)
        rnn, fc = w_bf16["I_w"].shape[1], w_bf16["fc1_w"].shape[1]
        aux_d = aux.shape[2] // 4
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for dtype in (torch.bfloat16, torch.float32):
            resident = resident_blocks(dev, dtype)
            pl = plan(rnn, fc, n_classes, aux_d, mels.shape[2], f, dtype, resident)
            print(f"  plan ({dtype}, F={f}, {sms} SMs, {resident} blocks resident in clusters "
                  f"of 4): grid {pl.grid} blocks of {pl.nu} units, {pl.nv} fc columns, "
                  f"{pl.nq} classes; {pl.smem} B of shared memory per block; {pl.fchunk} "
                  f"folds per stage; exchanged per step {pl.exchange_bytes} B written, "
                  f"{pl.staged_bytes} B staged into all blocks (L2 serves each row once per "
                  f"cluster of 4)")
        # the plain version draws the kernel's own Philox noise, so sampled
        # labels are held step by step as greedy ones are; the last mode is
        # the TTS path's own (bf16 weights, sampled, the path's seed). K1b
        # reads the (F, T, D) f32 conditioning in place and is held against
        # the same plain run.
        err = {True: 0.0, False: 0.0}
        with full_f32():
            for label, w, greedy, bound in (("greedy f32", w_f32, True, GAP_F32),
                                            ("greedy bf16", w_bf16, True, GAP_BF16),
                                            ("sampled f32", w_f32, False, GAP_F32),
                                            ("sampled bf16", w_bf16, False, GAP_BF16)):
                p, gaps = wavernn_sample_plain(w, mels, aux, seed, n_classes, greedy=greedy,
                                               return_gaps=True)
                for time_major in (True, False):
                    k = wavernn_sample(w, mels, aux, seed, n_classes, greedy=greedy,
                                       time_major=time_major)
                    compared, full, worst, e = hold_labels(k, p, gaps, bound, n_classes)
                    err[time_major] = max(err[time_major], e)
                    print(f"  {'K1 ' if time_major else 'K1b'} {label}: {compared}/{f * t} "
                          f"steps equal before the first difference, {full}/{f} folds equal "
                          f"throughout, largest gap at a first difference {worst:.3g} "
                          f"(bound {bound})")
        print(f"  max |x_kernel - x_plain| before each fold's first near-tie: K1 {err[True]}, "
              f"K1b {err[False]}")
        check(err[True] == 0.0 and err[False] == 0.0,
              "labels differ before a fold's first near-tie")
        ks2 = wavernn_sample(w_bf16, mels, aux, seed + 1, n_classes)
        print(f"  sampled bf16 label histograms (64 bins), total variation: kernel/plain "
              f"{tv_distance(k, p, n_classes):.4f}, kernel seed/seed+1 "
              f"{tv_distance(k, ks2, n_classes):.4f}")
        check(torch.equal(wavernn_sample(w_bf16, mels, aux, seed, n_classes),
                          wavernn_sample(w_bf16, mels, aux, seed, n_classes)),
              "sampled kernel is not deterministic for a fixed seed")

        # timings at the TTS path's configuration (bf16, sampled): its own F,
        # one utterance's folds, and the inputs tiled to 4 folds per SM
        f1 = f // len(TEXTS)
        f_big = 4 * sms
        reps = -(-f_big // f)
        sizes = {f: (mels, aux), f1: (mels[:f1], aux[:f1]),
                 f_big: (mels.repeat(reps, 1, 1)[:f_big].contiguous(),
                         aux.repeat(reps, 1, 1)[:f_big].contiguous())}
        times = {}
        for fx, (m_x, a_x) in sizes.items():
            tm = cuda_ms(lambda: wavernn_sample(w_bf16, m_x, a_x, seed, n_classes), reps=3)
            fm = cuda_ms(lambda: wavernn_sample(w_bf16, m_x, a_x, seed, n_classes,
                                                time_major=False), reps=3)
            times[fx] = (tm, fm)
            pl = plan(rnn, fc, n_classes, aux_d, mels.shape[2], fx, torch.bfloat16,
                      resident_blocks(dev, torch.bfloat16))
            print(f"  F={fx}: K1 {tm:.3f} ms ({tm / t * 1e3:.2f} us per step), K1b {fm:.3f} ms "
                  f"({fm / t * 1e3:.2f} us per step); {pl.fchunk} folds per stage, "
                  f"{pl.staged_bytes / 2**20:.1f} MiB staged into all blocks per step")
        ms, ms_b = times[f]
        plain_ms = cuda_ms(lambda: wavernn_sample_plain(w_bf16, mels, aux, seed, n_classes))
        # yardstick: one cuDNN GRU call over the same T x F with the sampler's
        # hidden width, teacher-forced (no sampling, no feedback), as built
        # and after flatten_parameters()
        gru = torch.nn.GRU(rnn, rnn, device=dev, dtype=torch.bfloat16)
        xs = torch.randn(t, f, rnn, device=dev, dtype=torch.bfloat16)
        with torch.no_grad():
            unflat_ms = cuda_ms(lambda: gru(xs), reps=3)
            gru.flatten_parameters()
            library_ms = cuda_ms(lambda: gru(xs), reps=3)
        mm_params = sum(w_bf16[k].numel() for k in w_bf16 if k.endswith(("_w", "_wi", "_wh")))
        flops = 2.0 * mm_params * f * t
        w_bytes = sum(v.numel() * v.element_size() for v in w_bf16.values())
        cond = f * t * (mels.shape[2] + aux.shape[2])
        bounds = {}
        for key, cond_bytes in (("K1", 2), ("K1b", 4)):
            n_bytes = w_bytes + cond * cond_bytes + f * t * 4
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
            bounds[key] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
            print(f"  {key} bound {bounds[key][0]:.4f} ms ({flops:.4g} FLOP, {n_bytes:.4g} B)")
        print(f"  K1 {ms:.3f} ms, K1b {ms_b:.3f} ms, plain {plain_ms:.3f} ms, cuDNN GRU "
              f"yardstick {unflat_ms:.3f} ms as built, {library_ms:.3f} ms after "
              f"flatten_parameters(); per step {ms / t * 1e3:.2f} us ({tf32_state()})")
    common = {"route": "cuda", "source": "mockingbird_tpu_torch/ops/csrc/wavernn_sample.cu",
              "plain_ms": plain_ms, "library_ms": library_ms}
    return [dict(common, name="wavernn_sample", replaces="mockingbird_tpu/ops/wavernn_sample.py:138",
                 launches=launches["wavernn_sample"], max_abs_err=max(err[True], path_err),
                 ms=ms,
                 bound_ms=bounds["K1"][0], bound_by=bounds["K1"][1]),
            # no path takes the fold-major layout (in the JAX package neither):
            # its count from the TTS run is expected to be 0
            dict(common, name="wavernn_sample(time_major=False)",
                 replaces="mockingbird_tpu/ops/wavernn_sample.py:62",
                 launches=launches["wavernn_sample(time_major=False)"],
                 max_abs_err=err[False], ms=ms_b, bound_ms=bounds["K1b"][0],
                 bound_by=bounds["K1b"][1])]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    with Phase("card"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
        print(smi)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        print(f"  paths timed under PyTorch's defaults ({tf32_state()}); TF32 off only "
              f"around the holds against plain versions and the parity checks")

    with Phase("build"):
        # every source at once, one nvcc each
        with ThreadPoolExecutor(len(KERNELS)) as pool:
            reports = list(pool.map(build.build, KERNELS))
        for name, report in zip(KERNELS, reports):
            for line in report.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}:", line.strip())

    pipe, captured, tts_launches = phase_tts(dev)
    phase_hifigan_tts(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_ppg_vc(dev, Path(tmp))
    phase_vits_serve(dev)
    with tempfile.TemporaryDirectory() as tmp:
        train_inputs, train_launches = phase_vits_train(dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        phase_tacotron_train(dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        phase_wavernn_mol(dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        phase_gan_train(dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        k1_train_err = phase_wavernn_train(dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        phase_encoder_train(dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        phase_ppg2mel_train(dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        phase_emotion(dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        serve_pipe, k1_serve_err = phase_serve(dev, Path(tmp))
        phase_cli(serve_pipe, Path(tmp))
        del serve_pipe
    gc.collect()
    print(f"  after the server and the CLI: {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
          f"allocated on the card")
    with tempfile.TemporaryDirectory() as tmp:
        nccl_launches = phase_parallel_nccl(dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        gloo_k2 = phase_parallel_gloo(dev, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        phase_import(dev, Path(tmp))
    unbatched_launches, k1_unbatched_err = phase_unbatched(dev)
    # each kernel's launches over the paths counted here: TTS, the unbatched
    # generator and the NCCL rank (K1); VITS training, the NCCL rank and
    # the two gloo ranks (K2), the ranks' counts as they report them
    k1_launches = {k: tts_launches[k] + unbatched_launches[k] + nccl_launches[k]
                   for k in ("wavernn_sample", "wavernn_sample(time_major=False)")}
    k2_launches = {"maximum_path": train_launches["maximum_path"]
                   + nccl_launches["maximum_path"] + gloo_k2}
    print(f"  launches counted: K1 {k1_launches}, K2 {k2_launches}")
    kernels = phase_k1(dev, pipe, captured, k1_launches,
                       max(k1_train_err, k1_serve_err, k1_unbatched_err))
    kernels.append(phase_k2(dev, train_inputs, k2_launches))
    print(f"== total: {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
