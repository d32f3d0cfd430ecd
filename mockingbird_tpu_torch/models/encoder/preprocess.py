"""Speaker-encoder dataset preprocessing: raw corpora → per-speaker mel .npy.

Port of ``mockingbird_tpu/models/encoder/preprocess.py``: walks the speaker
directories of a corpus, applies the encoder's wav preprocessing (resample →
volume normalisation → VAD trim), writes one ``<utt>.npy`` of float32 mel
frames per utterance and a ``_sources.txt`` manifest, and with
``skip_existing`` resumes by skipping what the manifest lists. Speakers run
in a host thread pool; the mel (``dsp.mel_encoder``) runs on ``device``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from pathlib import Path
from typing import Iterable, Optional, Union

import numpy as np

import torch

from ... import resolve_device
from ...config import encoder_audio_config
from ...dsp import mel_encoder, preprocess_wav

_AUDIO_EXTENSIONS = ("wav", "flac", "m4a", "mp3")


class DatasetLog:
    """Text log of preprocessing metadata."""

    def __init__(self, root, name):
        self.text_file = open(Path(root, f"Log_{name.replace('/', '_')}.txt"), "w")
        self.sample_data = {}
        self.write_line(f"Creating dataset {name} on {datetime.now().strftime('%A %d %B %Y at %H:%M')}")

    def write_line(self, line):
        self.text_file.write(f"{line}\n")

    def add_sample(self, **kwargs):
        for k, v in kwargs.items():
            self.sample_data.setdefault(k, []).append(v)

    def finalize(self):
        self.write_line("Statistics:")
        for k, vals in self.sample_data.items():
            self.write_line(f"\t{k}:")
            self.write_line(f"\t\tmin {np.min(vals)}, max {np.max(vals)}")
            self.write_line(f"\t\tmean {np.mean(vals)}")
            self.write_line(f"\t\tmedian {np.median(vals)}")
        self.write_line("-" * 10)
        self.text_file.close()


def _preprocess_speaker(speaker_dir: Path, out_root: Path, cfg, skip_existing: bool,
                        logger: Optional[DatasetLog], name_prefix: str,
                        device: torch.device) -> int:
    speaker_name = f"{name_prefix}_{speaker_dir.name}" if name_prefix else speaker_dir.name
    speaker_out = out_root / speaker_name
    speaker_out.mkdir(exist_ok=True, parents=True)
    sources_fpath = speaker_out / "_sources.txt"

    existing = set()
    if sources_fpath.exists() and skip_existing:
        with sources_fpath.open() as f:
            existing = {line.split(",")[0] for line in f if line.strip()}
        mode = "a"
    else:
        mode = "w"

    count = 0
    with sources_fpath.open(mode) as sources_file:
        for ext in _AUDIO_EXTENSIONS:
            for in_fpath in sorted(speaker_dir.glob(f"**/*.{ext}")):
                out_name = "_".join(in_fpath.relative_to(speaker_dir).parts)
                out_name = out_name.rsplit(".", 1)[0] + ".npy"
                if skip_existing and out_name in existing:
                    continue
                try:
                    wav = preprocess_wav(in_fpath, cfg)
                except Exception as e:   # one unreadable file must not stop a corpus
                    print(f"skipped {in_fpath}: {type(e).__name__}: {e}")
                    continue
                if len(wav) == 0:
                    continue
                with torch.no_grad():
                    frames = mel_encoder(torch.from_numpy(np.asarray(wav, np.float32)).to(device),
                                         cfg).cpu().numpy()
                if len(frames) < cfg.partials_n_frames:
                    continue
                np.save(speaker_out / out_name, frames)
                if logger:
                    logger.add_sample(duration=len(wav) / cfg.sample_rate)
                sources_file.write(f"{out_name},{in_fpath}\n")
                count += 1
    return count


def preprocess_speaker_dirs(speaker_dirs: Iterable[Path], dataset_name: str,
                            datasets_root: Path, out_dir: Path, skip_existing: bool = False,
                            cfg=None, n_workers: int = 8,
                            device: Union[str, torch.device] = "cuda") -> None:
    """Every speaker directory → ``out_dir/<dataset>_<speaker>/`` of mel
    ``.npy`` files and ``_sources.txt``; utterances shorter than one
    partial (160 frames) are left out."""
    dev = resolve_device(device)
    cfg = cfg or encoder_audio_config()
    out_dir = Path(out_dir)
    out_dir.mkdir(exist_ok=True, parents=True)
    logger = DatasetLog(out_dir, dataset_name)
    prefix = dataset_name.replace("/", "_")

    speaker_dirs = list(speaker_dirs)
    print(f"{dataset_name}: preprocessing {len(speaker_dirs)} speakers")
    with ThreadPoolExecutor(n_workers) as pool:
        counts = list(pool.map(
            lambda d: _preprocess_speaker(d, out_dir, cfg, skip_existing, logger, prefix, dev),
            speaker_dirs))
    print(f"{dataset_name}: wrote {sum(counts)} utterances")
    logger.finalize()


def _dataset_root(datasets_root: Path, name: str) -> Optional[Path]:
    p = Path(datasets_root) / name
    if not p.exists():
        print(f"Couldn't find {p}, skipping {name}")
        return None
    return p


# -- corpus adapters -----------------------------------------------------------

def preprocess_aidatatang_200zh(datasets_root, out_dir, skip_existing=False, **kw):
    root = _dataset_root(datasets_root, "aidatatang_200zh")
    if root is None:
        return
    speakers = sorted((root / "corpus" / "train").glob("*"))
    preprocess_speaker_dirs([d for d in speakers if d.is_dir()], "aidatatang_200zh",
                            datasets_root, out_dir, skip_existing, **kw)


def preprocess_librispeech(datasets_root, out_dir, skip_existing=False, **kw):
    for subset in ("LibriSpeech/train-other-500", "LibriSpeech/train-clean-100",
                   "LibriSpeech/train-clean-360"):
        root = _dataset_root(datasets_root, subset)
        if root is None:
            continue
        speakers = [d for d in sorted(root.glob("*")) if d.is_dir()]
        preprocess_speaker_dirs(speakers, subset, datasets_root, out_dir, skip_existing, **kw)


def preprocess_voxceleb1(datasets_root, out_dir, skip_existing=False, **kw):
    root = _dataset_root(datasets_root, "VoxCeleb1")
    if root is None:
        return
    # keep English-nationality speakers when metadata is available
    meta = root / "vox1_meta.csv"
    keep = None
    if meta.exists():
        with meta.open() as f:
            lines = f.read().splitlines()[1:]
        fields = [line.split("\t") for line in lines]
        keep = {f[0] for f in fields if len(f) > 3 and f[3].lower() in
                ("india", "usa", "canada", "uk", "australia", "ireland", "new zealand")}
    wav_root = root / "wav"
    speakers = [d for d in sorted(wav_root.glob("*")) if d.is_dir() and (keep is None or d.name in keep)]
    preprocess_speaker_dirs(speakers, "VoxCeleb1", datasets_root, out_dir, skip_existing, **kw)


def preprocess_voxceleb2(datasets_root, out_dir, skip_existing=False, **kw):
    root = _dataset_root(datasets_root, "VoxCeleb2")
    if root is None:
        return
    speakers = [d for d in sorted((root / "dev" / "aac").glob("*")) if d.is_dir()]
    preprocess_speaker_dirs(speakers, "VoxCeleb2", datasets_root, out_dir, skip_existing, **kw)


def preprocess_generic(datasets_root, dataset_name, out_dir, skip_existing=False, **kw):
    """Any corpus laid out as <root>/<dataset_name>/<speaker>/**/*.wav."""
    root = _dataset_root(datasets_root, dataset_name)
    if root is None:
        return
    speakers = [d for d in sorted(root.glob("*")) if d.is_dir()]
    preprocess_speaker_dirs(speakers, dataset_name, datasets_root, out_dir, skip_existing, **kw)
