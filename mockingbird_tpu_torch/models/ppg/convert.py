"""One-shot voice conversion: source wavs + one reference wav → wavs.

Port of ``mockingbird_tpu/models/ppg/convert.py``: PPG extraction → lf0
conversion to the reference's statistics (host numpy) → ppg2mel AR decode → postnet → vocoder. The decode loop runs in Python with
its state on the device and reads the stop flags back once per step, as
JAX's while-loop tests them once per step; it keeps JAX's semantics (per-row
stop frames, the loop ends when every row has stopped, the buffer stays zero
after that step) and its buckets (batch padded to a power of two, memory to
a multiple of 64 groups), which change the numbers and not only the speed.

``preprocess_vc_dataset`` writes the ppg2mel trainer's corpus.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from ... import resolve_device, seeded
from ...config import Config, encoder_audio_config, sv2tts_audio_config
from ...dsp import inv_mel_spectrogram, load_wav, melspectrogram, preprocess_wav, save_wav
from ...dsp.f0 import compute_f0, compute_mean_std, f02lf0, get_cont_lf0, get_converted_lf0uv
from ...weights import load_flax, load_npz
from ..encoder.inference import SpeakerEncoderInference
from .extractor import PPGExtractor
from .ppg2mel import MelDecoderMOLv2, ppg2mel_config


class VoiceConverter:
    """A reference utterance sets the voice; ``convert_wavs`` re-voices
    source wavs.

    ppg2mel weights come from ``variables`` (the flax tree ``{"params",
    "batch_stats"}``), from an ``.npz`` export at ``ppg2mel_fpath``, or else
    from ``seed``; a path that does not exist raises ``FileNotFoundError``.
    ``extractor`` and ``encoder`` default to seeded models on ``device``."""

    def __init__(self, ppg2mel_fpath: Optional[Union[str, Path]] = None,
                 extractor: Optional[PPGExtractor] = None,
                 encoder: Optional[SpeakerEncoderInference] = None,
                 cfg=None, verbose: bool = True, seed: int = 0,
                 variables: Optional[dict] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.cfg = Config(ppg2mel_config()).merge(cfg or {})
        if ppg2mel_fpath is not None:
            if not Path(ppg2mel_fpath).is_file():
                raise FileNotFoundError(f"no ppg2mel weights at {ppg2mel_fpath}")
            variables = load_npz(ppg2mel_fpath)
            if verbose:
                print(f"Loaded ppg2mel from {ppg2mel_fpath}")
        elif variables is None and verbose:
            print("ppg2mel: fresh (untrained) weights")
        self.extractor = extractor or PPGExtractor(verbose=verbose, device=self.device)
        self.encoder = encoder or SpeakerEncoderInference(device=self.device)
        with seeded(seed):
            model = MelDecoderMOLv2(self.cfg)
        if variables is not None:
            load_flax(model, variables)
        self.model = model.to(self.device).eval()
        self.ref_embed: Optional[np.ndarray] = None
        self.ref_lf0_mean = 0.0
        self.ref_lf0_std = 1.0

    def set_reference(self, ref_wav_path: Union[str, Path]) -> None:
        """Target speaker: the GE2E d-vector and the lf0 statistics."""
        wav = preprocess_wav(ref_wav_path, encoder_audio_config())
        self.ref_embed = self.encoder.embed_utterance(wav)
        raw, _ = load_wav(ref_wav_path, target_sr=16000)
        self.ref_lf0_mean, self.ref_lf0_std = compute_mean_std(f02lf0(compute_f0(raw)))

    def lf0s(self, src_wavs) -> List[np.ndarray]:
        """Each source's (T, 2) [continuous lf0 converted to the
        reference's statistics, uv] (host numpy)."""
        return [get_converted_lf0uv(w, self.ref_lf0_mean, self.ref_lf0_std) for w in src_wavs]

    def batch(self, ppgs, lf0s) -> dict:
        """Trim each utterance to a whole number of memory groups and pad
        the batch: rows to a power of two, the memory to a multiple of 64
        groups (at least 64). Padding rows attend to one frame."""
        down = int(np.prod(self.cfg.encoder_downsample_rates))
        ns = []
        for ppg, lf0 in zip(ppgs, lf0s):
            n = min(len(ppg), len(lf0))
            ns.append(n - n % down)
        b = len(ppgs)
        b_pad = 1 << max(b - 1, 0).bit_length()
        t_mem = max(64, int(np.ceil(max(ns) / down / 64)) * 64)
        ppg_pad = np.zeros((b_pad, t_mem * down, ppgs[0].shape[1]), np.float32)
        lf0_pad = np.zeros((b_pad, t_mem * down, 2), np.float32)
        mem_mask = np.zeros((b_pad, t_mem), np.float32)
        for i, n in enumerate(ns):
            ppg_pad[i, :n] = ppgs[i][:n]
            lf0_pad[i, :n] = lf0s[i][:n]
            mem_mask[i, : n // down] = 1
        mem_mask[b:, :1] = 1
        dev = self.device
        return dict(ns=ns, ppg=torch.from_numpy(ppg_pad).to(dev),
                    lf0=torch.from_numpy(lf0_pad).to(dev),
                    mem_mask=torch.from_numpy(mem_mask).to(dev),
                    embeds=torch.from_numpy(np.tile(np.asarray(self.ref_embed, np.float32),
                                                    (b_pad, 1))).to(dev))

    @torch.no_grad()
    def encode(self, batch: dict) -> torch.Tensor:
        return self.model.encode_inputs(batch["ppg"], batch["lf0"], batch["embeds"])

    @torch.no_grad()
    def decode(self, memory: torch.Tensor, mem_mask: torch.Tensor, max_steps: int,
               stop_threshold: float, generator: Optional[torch.Generator] = None):
        """The AR loop, before the postnet. Returns (mels (B, max_steps//r·r,
        M), per-row frames (B,), steps run): a row's frames are (t+1)·r at
        the step t its stop probability first exceeds ``stop_threshold``,
        else the frames the loop ran."""
        model, c = self.model, self.cfg
        r, m = c.frames_per_step, c.num_mels
        b = memory.shape[0]
        n_groups = max_steps // r
        buf = memory.new_zeros(n_groups, b, m * r)
        carry = model.init_carry(b, memory.device)
        prev = memory.new_zeros(b, m)
        done = torch.zeros(b, dtype=torch.bool, device=memory.device)
        frames = torch.zeros(b, dtype=torch.int64, device=memory.device)
        t = 0
        while t < n_groups:
            carry, (mel_r, stop, _) = model.decode_step(memory, mem_mask, carry, prev, generator)
            buf[t] = mel_r
            newly = ~done & (torch.sigmoid(stop) > stop_threshold)
            done = done | newly
            frames = torch.where(newly, (t + 1) * r, frames)
            prev = mel_r.reshape(b, r, m)[:, -1]
            t += 1
            if bool(done.all()):
                break
        frames = torch.where(done, frames, t * r)
        return buf.transpose(0, 1).reshape(b, n_groups * r, m), frames, t

    def convert_wavs(self, src_wavs, max_steps: Optional[int] = None,
                     stop_threshold: float = 0.5, seed: int = 0) -> List[np.ndarray]:
        """Batched one-shot VC: source wavs (16 kHz float32) → (T_i, 80) mels
        in the SV2TTS ±4 convention, each trimmed to min(its stop frame, its
        source's frames). ``max_steps`` defaults to the longest source's
        frame count rounded up to 100, at least 200. The prenet's dropout
        draws from a generator seeded with ``seed``."""
        if self.ref_embed is None:
            raise RuntimeError("call set_reference() first")
        ppgs = self.extractor.extract_from_wavs(src_wavs)
        batch = self.batch(ppgs, self.lf0s(src_wavs))
        ns = batch["ns"]
        if max_steps is None:
            max_steps = max(((max(ns) + 99) // 100) * 100, 200)
        memory = self.encode(batch)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        mels, frames, _ = self.decode(memory, batch["mem_mask"], max_steps, stop_threshold, gen)
        with torch.no_grad():
            mels = self.model.postnet_apply(mels).cpu().numpy()
        frames = frames.cpu().numpy()
        return [mels[i, : min(int(frames[i]), ns[i])] for i in range(len(src_wavs))]

    def convert_wav(self, src_wav: np.ndarray, max_steps: int = 1600,
                    stop_threshold: float = 0.5, seed: int = 0):
        """source wav → (mel (T, 80), rtf in the reference's convention:
        elapsed / (0.01 · frames), lower is better)."""
        t0 = time.time()
        mel = self.convert_wavs([src_wav], max_steps=max_steps,
                                stop_threshold=stop_threshold, seed=seed)[0]
        return mel, (time.time() - t0) / max(0.01 * len(mel), 1e-6)

    def convert_files(self, src_paths, out_dir: Union[str, Path], vocoder=None,
                      batch_size: int = 8) -> None:
        """Whole-directory conversion in batches of ``batch_size``, each wav
        written as ``vc_<stem>.wav`` at 16 kHz. The vocoder: its
        ``infer_waveform_batch`` when it has one, else ``infer_waveform``
        per mel, else (``None``) Griffin-Lim. Prints the mean RTF in the
        reference's convention."""
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        rtfs = []
        src_paths = list(src_paths)
        for i in range(0, len(src_paths), batch_size):
            chunk = src_paths[i : i + batch_size]
            wavs = [load_wav(p, target_sr=16000)[0] for p in chunk]
            t0 = time.time()
            mels = self.convert_wavs(wavs)
            elapsed = time.time() - t0
            total_frames = sum(len(m) for m in mels)
            rtfs += [elapsed / max(0.01 * total_frames, 1e-6)] * len(chunk)
            if vocoder is not None and hasattr(vocoder, "infer_waveform_batch"):
                outs = vocoder.infer_waveform_batch([m.T for m in mels])
            elif vocoder is not None:
                outs = [vocoder.infer_waveform(m.T) for m in mels]
            else:
                gen = torch.Generator(device=self.device).manual_seed(0)
                outs = [inv_mel_spectrogram(torch.from_numpy(m).to(self.device),
                                            sv2tts_audio_config(), generator=gen).cpu().numpy()
                        for m in mels]
            for p, out in zip(chunk, outs):
                save_wav(out, out_dir / f"vc_{Path(p).stem}.wav", 16000)
        print(f"mean RTF: {np.mean(rtfs):.3f}")


def preprocess_vc_dataset(wav_dir: Path, out_dir: Path,
                          extractor: Optional[PPGExtractor] = None,
                          encoder: Optional[SpeakerEncoderInference] = None,
                          audio_cfg=None, device: Union[str, torch.device] = "cuda") -> None:
    """Every wav under ``wav_dir`` (16 kHz, at least 0.1 s) → ``bnf/``
    (PPGs), ``f0/`` ((T, 2) continuous lf0 and uv), ``embed/`` (the GE2E
    d-vector), ``mel/`` (the SV2TTS mel; JAX's ``melspectrogram_bucketed``
    equals ``melspectrogram`` and buckets only to bound XLA compiles), one
    ``<fid>.npy`` each, and the fid lists: ids ending in 6 or 7 go to dev,
    8 or 9 to eval, the rest to train. ``extractor`` and ``encoder``
    default to seeded models on ``device``."""
    dev = resolve_device(device)
    wav_dir, out_dir = Path(wav_dir), Path(out_dir)
    extractor = extractor or PPGExtractor(verbose=False, device=dev)
    encoder = encoder or SpeakerEncoderInference(device=dev)
    audio_cfg = audio_cfg or sv2tts_audio_config()
    ecfg = encoder_audio_config()
    for sub in ("bnf", "f0", "embed", "mel"):
        (out_dir / sub).mkdir(parents=True, exist_ok=True)

    fids = []
    for wav_path in sorted(wav_dir.glob("**/*.wav")):
        fid = wav_path.stem
        wav, _ = load_wav(wav_path, target_sr=16000)
        if len(wav) < 1600:
            continue
        uv, cont_lf0 = get_cont_lf0(compute_f0(wav))
        arrays = {"bnf": extractor.extract_from_wav(wav),
                  "f0": np.stack([cont_lf0, uv], axis=1).astype(np.float32),
                  "embed": encoder.embed_utterance(preprocess_wav(wav, ecfg)),
                  "mel": melspectrogram(torch.from_numpy(np.asarray(wav, np.float32)).to(dev),
                                        audio_cfg).cpu().numpy()}
        for sub, a in arrays.items():
            np.save(out_dir / sub / f"{fid}.npy", a)
        fids.append(fid)

    splits = {"train": [], "dev": [], "eval": []}
    for fid in fids:
        splits["dev" if fid[-1] in "67" else "eval" if fid[-1] in "89" else "train"].append(fid)
    for name, lst in splits.items():
        (out_dir / f"{name}_fidlist.txt").write_text("\n".join(lst) + "\n")
    print(f"VC preprocess: {len(fids)} utterances ({len(splits['train'])} train / "
          f"{len(splits['dev'])} dev / {len(splits['eval'])} eval)")
