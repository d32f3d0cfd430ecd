"""Synthesizer dataset preprocessing: corpora → {audio/, mels/, embeds/, train.txt}.

Port of ``mockingbird_tpu/models/tacotron/preprocess.py``: the per-dataset
registry (subfolders, transcript path, parser), per utterance trim →
rescale → logmmse denoise → pinyin, the SV2TTS mel (``dsp.melspectrogram``
on the device; the JAX package's ``melspectrogram_bucketed`` equals it and
buckets only for XLA compile counts), the length filters, the pipe-separated
``train.txt``, then speaker embeddings of the saved audio by the port's GE2E
encoder on the device. A thread pool overlaps the host work. The emotion
embeddings for VITS (``create_emotion_embeddings``) wait for the port's
emotion extractor.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from ... import resolve_device
from ...config import encoder_audio_config, sv2tts_audio_config
from ...dsp import load_wav, melspectrogram, preprocess_wav
from ...dsp.logmmse import denoise, profile_noise
from ...text.pinyin import chinese_to_pinyin


def _transcript_general(dict_info: Dict[str, str], lines) -> None:
    """``<utt_id> <text...>`` per line."""
    for v in lines:
        if not v.strip():
            continue
        parts = v.strip().replace("\n", "").replace("\t", " ").split(" ")
        dict_info[parts[0]] = " ".join(parts[1:])


def _transcript_magicdata(dict_info, lines):
    """``<wav_name> <spk> <text...>``."""
    for v in lines:
        if not v.strip():
            continue
        parts = v.strip().split("\t") if "\t" in v else v.strip().split(" ")
        parts = [p for p in " ".join(parts).split(" ") if p]
        if len(parts) >= 3:
            dict_info[parts[0].split(".")[0]] = " ".join(parts[2:])


def _transcript_aishell3(dict_info, lines):
    """aishell3 content.txt: ``<wav> <char pinyin char pinyin ...>``; keeps
    the hanzi (every even token)."""
    for v in lines:
        if not v.strip():
            continue
        parts = v.strip().split()
        if len(parts) < 2:
            continue
        dict_info[parts[0].split(".")[0]] = "".join(parts[1::2])


DATA_INFO = {
    "aidatatang_200zh": dict(subfolders=["corpus/train"],
                             trans_filepath="transcript/aidatatang_200_zh_transcript.txt",
                             transcript_func=_transcript_general),
    "aidatatang_200zh_s": dict(subfolders=["corpus/train"],
                               trans_filepath="transcript/aidatatang_200_zh_transcript.txt",
                               transcript_func=_transcript_general),
    "magicdata": dict(subfolders=["train"], trans_filepath="train/TRANS.txt",
                      transcript_func=_transcript_magicdata),
    "aishell3": dict(subfolders=["train/wav"], trans_filepath="train/content.txt",
                     transcript_func=_transcript_aishell3),
    "data_aishell": dict(subfolders=["wav/train"],
                         trans_filepath="transcript/aishell_transcript_v0.8.txt",
                         transcript_func=_transcript_general),
}


def trim_top_db(wav: np.ndarray, top_db: float = 40.0,
                frame_length: int = 2048, hop_length: int = 1024) -> np.ndarray:
    """librosa.effects.trim: keep from the first to the last frame whose
    RMS is within ``top_db`` of the loudest."""
    if len(wav) < frame_length:
        return wav
    n = 1 + (len(wav) - frame_length) // hop_length
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    rms = np.sqrt(np.mean(wav[idx] ** 2, axis=1))
    db = 20 * np.log10(np.maximum(rms, 1e-10) / max(rms.max(), 1e-10))
    keep = np.where(db > -top_db)[0]
    if len(keep) == 0:
        return wav
    start = keep[0] * hop_length
    end = min(len(wav), (keep[-1] + 1) * hop_length + frame_length)
    return wav[start:end]


def split_on_silences(wav_fpath, words: str, audio_cfg) -> tuple[np.ndarray, str]:
    """Load + trim + rescale + denoise (the noise profiled on the first and
    last 0.15 s; skipped when that fails) + romanise."""
    wav, _ = load_wav(wav_fpath, target_sr=audio_cfg.sample_rate)
    wav = trim_top_db(wav)
    if audio_cfg.rescale:
        wav = wav / max(np.abs(wav).max(), 1e-8) * audio_cfg.rescaling_max
    sr = audio_cfg.sample_rate
    if len(wav) > sr * 0.4:
        noise_wav = np.concatenate([wav[: int(sr * 0.15)], wav[-int(sr * 0.15):]])
        try:
            wav = denoise(wav, profile_noise(noise_wav, sr), eta=0)
        except Exception as e:      # kept un-denoised, as the JAX package keeps it
            print(f"{wav_fpath}: not denoised ({e!r})")
    res = " ".join(p for p in chinese_to_pinyin(words) if p and not p.isspace())
    return wav, res


def process_utterance(wav: np.ndarray, text: str, out_dir: Path, basename: str,
                      audio_cfg, skip_existing: bool,
                      device: Union[str, torch.device] = "cuda") -> Optional[tuple]:
    """Write the mel (bin-major (M, T), as the reference stores it) and the
    audio ``.npy``; None when the utterance is shorter than
    ``utterance_min_duration`` or, with ``clip_mels_length``, longer than
    ``max_mel_frames``. → the ``train.txt`` row's fields."""
    mel_fpath = out_dir / "mels" / f"mel-{basename}.npy"
    wav_fpath = out_dir / "audio" / f"audio-{basename}.npy"
    if skip_existing and mel_fpath.exists() and wav_fpath.exists():
        mel_frames = np.load(mel_fpath).shape[1]
        return wav_fpath.name, mel_fpath.name, f"embed-{basename}.npy", len(wav), mel_frames, text
    if len(wav) < audio_cfg.utterance_min_duration * audio_cfg.sample_rate:
        return None
    with torch.no_grad():
        mel = melspectrogram(torch.from_numpy(np.asarray(wav, np.float32)).to(device),
                             audio_cfg).cpu().numpy()          # (T, M)
    mel_frames = mel.shape[0]
    if mel_frames > audio_cfg.max_mel_frames and audio_cfg.clip_mels_length:
        return None
    np.save(mel_fpath, mel.T, allow_pickle=False)
    np.save(wav_fpath, wav, allow_pickle=False)
    return wav_fpath.name, mel_fpath.name, f"embed-{basename}.npy", len(wav), mel_frames, text


def _preprocess_speaker(speaker_dir: Path, out_dir: Path, skip_existing: bool,
                        audio_cfg, dict_info: Dict[str, str], device):
    metadata = []
    for ext in ("*.wav", "*.flac", "*.mp3"):
        for wav_fpath in sorted(speaker_dir.glob("**/" + ext)):
            words = dict_info.get(wav_fpath.stem)
            if not words:
                continue
            try:
                wav, text = split_on_silences(wav_fpath, words, audio_cfg)
            except Exception as e:  # an unreadable file is skipped, as in the JAX package
                print(f"{wav_fpath}: skipped ({e!r})")
                continue
            item = process_utterance(wav, text, out_dir, f"{speaker_dir.name}_{wav_fpath.stem}",
                                     audio_cfg, skip_existing, device)
            if item is not None:
                metadata.append(item)
    return metadata


def preprocess_dataset(datasets_root: Path, out_dir: Path, n_processes: int = 8,
                       skip_existing: bool = False, dataset: str = "aidatatang_200zh",
                       audio_cfg=None, device: Union[str, torch.device] = "cuda") -> None:
    """Every transcribed utterance of ``datasets_root/dataset`` → ``out_dir``
    (``mels/``, ``audio/``, ``train.txt``); speakers in a pool of
    ``n_processes`` threads."""
    dev = resolve_device(device)
    audio_cfg = (audio_cfg or sv2tts_audio_config()).clone()
    audio_cfg.merge(dict(utterance_min_duration=0.5, clip_mels_length=True))
    info = DATA_INFO[dataset]
    dataset_root = Path(datasets_root) / dataset
    input_dirs = [dataset_root / sub for sub in info["subfolders"]]
    missing = [str(d) for d in input_dirs if not d.exists()]
    if missing:
        raise FileNotFoundError(f"missing input dirs: {missing}")

    out_dir = Path(out_dir)
    (out_dir / "mels").mkdir(parents=True, exist_ok=True)
    (out_dir / "audio").mkdir(exist_ok=True)

    dict_info: Dict[str, str] = {}
    trans = dataset_root / info["trans_filepath"]
    with trans.open("r", encoding="utf-8") as f:
        info["transcript_func"](dict_info, f)

    speaker_dirs = [d for ind in input_dirs for d in sorted(ind.glob("*")) if d.is_dir()]
    func = partial(_preprocess_speaker, out_dir=out_dir, skip_existing=skip_existing,
                   audio_cfg=audio_cfg, dict_info=dict_info, device=dev)
    metadata_fpath = out_dir / "train.txt"
    with metadata_fpath.open("a" if skip_existing else "w", encoding="utf-8") as mf, \
            ThreadPoolExecutor(n_processes) as pool:
        for speaker_metadata in pool.map(func, speaker_dirs):
            for metadatum in speaker_metadata:
                mf.write("|".join(map(str, metadatum)) + "\n")

    with metadata_fpath.open("r", encoding="utf-8") as f:
        metadata = [line.split("|") for line in f if line.strip()]
    if metadata:
        mel_frames = sum(int(m[4]) for m in metadata)
        timesteps = sum(int(m[3]) for m in metadata)
        print(f"{len(metadata)} utterances, {mel_frames} mel frames, "
              f"{timesteps / audio_cfg.sample_rate / 3600:.2f} hours")


def create_embeddings(synthesizer_root: Path, encoder_model_fpath=None, n_processes: int = 4,
                      device: Union[str, torch.device] = "cuda") -> None:
    """Speaker-embed every utterance of ``train.txt``: ``embeds/embed-<utt>.npy``
    from the audio ``preprocess_dataset`` saved, by the GE2E encoder of the
    ``.npz`` export at ``encoder_model_fpath`` (weights made from seed 0
    when it is None; a path that does not exist raises). Existing
    embeddings are kept."""
    from ..encoder.inference import SpeakerEncoderInference

    dev = resolve_device(device)
    synthesizer_root = Path(synthesizer_root)
    wav_dir = synthesizer_root / "audio"
    embed_dir = synthesizer_root / "embeds"
    embed_dir.mkdir(exist_ok=True)
    with (synthesizer_root / "train.txt").open("r", encoding="utf-8") as f:
        metadata = [line.split("|") for line in f if line.strip()]
    enc = (SpeakerEncoderInference.from_checkpoint(encoder_model_fpath, device=dev)
           if encoder_model_fpath is not None else SpeakerEncoderInference(device=dev))
    ecfg = encoder_audio_config()

    def embed_one(m):
        out = embed_dir / m[2]
        if out.exists():
            return
        wav = preprocess_wav(np.load(wav_dir / m[0]), ecfg)
        np.save(out, enc.embed_utterance(wav), allow_pickle=False)

    with ThreadPoolExecutor(n_processes) as pool:
        list(pool.map(embed_one, metadata))
    print(f"Embedded {len(metadata)} utterances")
