"""End-to-end voice-cloning pipeline: reference wav + texts → waveforms.

Port of ``mockingbird_tpu/pipeline.py``: GE2E encoder → Tacotron (or VITS)
→ vocoder (HiFi-GAN by default, Fre-GAN or WaveRNN by checkpoint name).
``tts_batch`` takes the fused branch when the synthesizer is Tacotron and
the vocoder can vocode on the device (the GAN vocoders): the mels stay on
the device, the PCM is quantised there, and one device-to-host copy per
chunk of texts brings it back. VITS, which makes the waveform itself, takes
a branch of the same contract. Any other pair takes the staged branch
through ``clone_voice``. Weights come from ``.npz`` exports of the JAX
package's param trees, or from ``seed`` when no path is given; a path that
does not exist raises ``FileNotFoundError``. A vocoder object passed as
``vocoder`` is used as it is, in place of one loaded from ``vocoder_fpath``.
``make_voice_converter`` builds the PPG one-shot voice-conversion path
(``models.ppg.VoiceConverter``). Under a profiler session ``tts_batch``
records a span tree per call (``tracing.py``).
"""
from __future__ import annotations

import time
import warnings
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch

from . import resolve_device, tracing
from .config import sv2tts_audio_config
from .dsp import decode_mulaw8_to_int16, save_wav
from .models.encoder import SpeakerEncoderInference
from .models.tacotron import Synthesizer
from .models.vocoder import load_vocoder


class VoiceCloningPipeline:
    """Few-seconds reference audio → cloned-voice TTS."""

    def __init__(self,
                 encoder_fpath: Optional[Union[str, Path]] = None,
                 synthesizer_fpath: Optional[Union[str, Path]] = None,
                 vocoder_fpath: Optional[Union[str, Path]] = None,
                 synthesizer: str = "tacotron",
                 verbose: bool = True, seed: int = 0,
                 device: Union[str, torch.device] = "cuda",
                 vocoder=None):
        self.device = resolve_device(device)
        self.encoder = (SpeakerEncoderInference.from_checkpoint(encoder_fpath, device=self.device)
                        if encoder_fpath is not None
                        else SpeakerEncoderInference(seed=seed, device=self.device))
        self.synthesizer_kind = synthesizer
        if synthesizer == "vits":
            from .models.vits import VitsSynthesizer
            self.synthesizer = VitsSynthesizer(synthesizer_fpath, verbose=verbose, seed=seed,
                                               device=self.device)
        else:
            self.synthesizer = Synthesizer(synthesizer_fpath, verbose=verbose, seed=seed,
                                           device=self.device)
        self.vocoder = (vocoder if vocoder is not None
                        else load_vocoder(vocoder_fpath, verbose=verbose, device=self.device))
        self.audio_cfg = sv2tts_audio_config()
        self._embed_cache: dict = {}

    def embed_reference(self, ref_wav: Union[str, Path, np.ndarray],
                        source_sr: Optional[int] = None) -> np.ndarray:
        key = str(ref_wav) if isinstance(ref_wav, (str, Path)) else None
        if key and key in self._embed_cache:
            return self._embed_cache[key]
        wav = self.encoder.preprocess_wav(ref_wav, source_sr)
        embed = self.encoder.embed_utterance(wav)
        if key:
            self._embed_cache[key] = embed
        return embed

    def clone_voice(self, texts: Union[str, List[str]],
                    ref_wav: Union[str, Path, np.ndarray],
                    style_idx: int = 0, min_stop_token: int = 5,
                    steps: int = 1000, use_griffin_lim: bool = False,
                    source_sr: Optional[int] = None) -> List[np.ndarray]:
        """texts + reference audio → float32 waveforms."""
        if isinstance(texts, str):
            texts = [texts]
        with tracing.span("pipeline.embed"):
            embed = self.embed_reference(ref_wav, source_sr)
            embeds = np.tile(embed, (len(texts), 1))
        if self.synthesizer_kind == "vits":
            return self.synthesizer.synthesize(texts)
        specs = self.synthesizer.synthesize_spectrograms(
            texts, embeds, style_idx=style_idx, min_stop_token=min_stop_token,
            steps=steps)
        if use_griffin_lim:
            return [self.synthesizer.griffin_lim(s) for s in specs]
        if hasattr(self.vocoder, "infer_waveform_batch") and len(specs) > 1:
            return self.vocoder.infer_waveform_batch(specs)
        return [self.vocoder.infer_waveform(s) for s in specs]

    def tts_batch(self, texts: Union[str, List[str]],
                  ref_wav: Union[str, Path, np.ndarray, None],
                  style_idx: int = 0, min_stop_token: int = 5,
                  steps: int = 1000, batch_size: int = 32,
                  source_sr: Optional[int] = None,
                  pcm16: bool = True, pcm_format: Optional[str] = None,
                  embed: Optional[np.ndarray] = None) -> List[np.ndarray]:
        """texts → per-text int16 (``pcm_format`` "int16" or "mulaw8", the
        latter decoded on the host) or float32 waveforms, each trimmed at its
        item's stop frame.

        Fused branch (Tacotron and a vocoder with ``vocode_device``): texts
        go in chunks of ``batch_size``; each chunk's mels stay on the device
        and are vocoded and quantised there, and its PCM comes back in one
        copy. ``embed`` (256,) is one voice for every text, (B, 256) one per
        text; without it the reference wav's embedding is used. VITS takes
        a branch of the same contract (``_tts_vits``), with ``steps`` as its
        ``max_frames``. Any other pair takes the staged branch through
        ``clone_voice`` and returns host-quantised int16 (a ``pcm_format``
        there only warns)."""
        if isinstance(texts, str):
            texts = [texts]
        vits = self.synthesizer_kind == "vits"
        fused = vits or (self.synthesizer_kind == "tacotron"
                         and hasattr(self.vocoder, "vocode_device"))
        with tracing.span("tts_batch") as root:
            root.set("texts", len(texts))
            root.set("fused", fused)
            if vits:
                return self._tts_vits(texts, ref_wav, steps, batch_size, source_sr, pcm16,
                                      pcm_format)
            if fused:
                return self._tts_fused(texts, ref_wav, style_idx, min_stop_token, steps,
                                       batch_size, source_sr, pcm16, pcm_format, embed)
            wavs = self.clone_voice(texts, ref_wav, style_idx=style_idx,
                                    min_stop_token=min_stop_token, steps=steps,
                                    source_sr=source_sr)
            if pcm_format is not None:
                warnings.warn(
                    f"tts_batch: pcm_format={pcm_format!r} requested but the fused "
                    f"on-device path is unavailable (synthesizer={self.synthesizer_kind}, "
                    f"vocoder={type(self.vocoder).__name__}); returning host-quantised "
                    "int16 instead", stacklevel=2)
            if pcm16 or pcm_format is not None:
                with tracing.span("pipeline.unpack"):
                    wavs = [w if w.dtype == np.int16 else
                            np.round(np.clip(w, -1.0, 1.0) * 32767).astype(np.int16)
                            for w in wavs]
            return wavs

    def _tts_vits(self, texts, ref_wav, steps, batch_size, source_sr, pcm16,
                  pcm_format) -> List[np.ndarray]:
        """``tts_batch``'s VITS branch: chunks of ``batch_size`` texts, each
        synthesised for ``steps`` frames (speaker 0, zero emotion), its
        int16 made on the device; every chunk is enqueued before the first
        copy, and each chunk's PCM and lengths come back in one copy each.
        The reference wav is embedded (and cached) as on every branch; VITS
        speaks as speaker 0 whatever the voice. int16 is the only wire
        format: any other ``pcm_format`` warns and gives int16; without
        ``pcm16`` or a format, float32."""
        if ref_wav is not None:
            with tracing.span("pipeline.embed"):
                self.embed_reference(ref_wav, source_sr)
        from .models.vits import inference as vits_inference
        if pcm_format not in (None, "int16"):
            warnings.warn(f"tts_batch: pcm_format={pcm_format!r} requested but VITS returns "
                          "int16 only; returning int16 instead", stacklevel=3)
        quantise = pcm16 or pcm_format is not None
        hop = self.synthesizer.cfg.hop_size
        pending = []
        for i in range(0, len(texts), batch_size):
            chunk = texts[i : i + batch_size]
            pcm_dev, lens_dev = self.synthesizer.synthesize_device(chunk, max_frames=steps,
                                                                   pcm16=quantise)
            pending.append((len(chunk), pcm_dev, lens_dev))
        wavs: List[np.ndarray] = []
        for n, pcm_dev, lens_dev in pending:
            with tracing.span("pipeline.fetch_wait"):
                pcm = pcm_dev.cpu().numpy()             # one device-to-host copy per chunk
                lens = lens_dev.cpu().numpy()
            vits_inference.count_frames(steps, lens)
            with tracing.span("pipeline.unpack"):
                for j in range(n):
                    wavs.append(pcm[j, : int(lens[j]) * hop])
        return wavs

    def _tts_fused(self, texts, ref_wav, style_idx, min_stop_token, steps, batch_size,
                   source_sr, pcm16, pcm_format, embed) -> List[np.ndarray]:
        """``tts_batch``'s fused branch."""
        with tracing.span("pipeline.embed"):
            embed = (self.embed_reference(ref_wav, source_sr) if embed is None
                     else np.asarray(embed, np.float32))
            embeds_all = np.tile(embed, (len(texts), 1)) if embed.ndim == 1 else embed
        assert embeds_all.shape[0] == len(texts), \
            f"per-text embeds {embeds_all.shape} vs {len(texts)} texts"
        hop = self.vocoder.cfg.hop_size
        # every chunk is vocoded before any PCM is fetched, so the copies
        # queue behind the device work instead of interleaving with it
        pending = []
        for i in range(0, len(texts), batch_size):
            chunk = texts[i : i + batch_size]
            mels_dev, frame_lens = self.synthesizer.synthesize_mels_device(
                chunk, embeds_all[i : i + len(chunk)], style_idx=style_idx,
                min_stop_token=min_stop_token, steps=steps)
            pcm_dev = self.vocoder.vocode_device(mels_dev, pcm16=pcm16, pcm_format=pcm_format)
            pending.append((len(chunk), pcm_dev, frame_lens))
        wavs: List[np.ndarray] = []
        for n, pcm_dev, frame_lens in pending:
            with tracing.span("pipeline.fetch_wait"):
                pcm = pcm_dev.cpu().numpy()             # one device-to-host copy per chunk
                lens = frame_lens.cpu().numpy()
            with tracing.span("pipeline.unpack"):
                if pcm_format == "mulaw8":
                    pcm = decode_mulaw8_to_int16(pcm)
                for j in range(n):
                    wavs.append(pcm[j, : int(lens[j]) * hop])
        return wavs

    def clone_voice_long(self, text: str, ref_wav: Union[str, Path, np.ndarray],
                         break_seconds: float = 0.15, max_chars: int = 140,
                         **kwargs) -> np.ndarray:
        """Long text → one waveform: numbers read out, split at punctuation,
        packed into chunks of at most ``max_chars``, the chunks synthesised
        in one ``tts_batch`` and joined with ``break_seconds`` of silence."""
        from .text.long_text import synthesize_long_text

        def synth(chunks):
            wavs = self.tts_batch(chunks, ref_wav, **kwargs)
            return [w.astype(np.float32) / 32767.0 if w.dtype == np.int16 else w
                    for w in wavs]

        return synthesize_long_text(text, synth, self.audio_cfg.sample_rate,
                                    break_seconds, max_chars)

    def tts_to_file(self, text: str, ref_wav: Union[str, Path], out_path: Union[str, Path],
                    long_text: Optional[bool] = None, **kwargs) -> float:
        """Synthesise ``text`` into a wav file; returns the real-time factor
        (seconds of audio per second of wall time). Texts over 140 characters
        (or ``long_text=True``) go through ``clone_voice_long``."""
        t0 = time.time()
        use_gl = kwargs.pop("use_griffin_lim", False)
        if not use_gl and (long_text or (long_text is None and len(text) > 140)):
            wav = self.clone_voice_long(text, ref_wav, **kwargs)
        else:
            wav = self.clone_voice(text, ref_wav, use_griffin_lim=use_gl, **kwargs)[0]
        dt = time.time() - t0
        save_wav(wav, out_path, self.audio_cfg.sample_rate)
        return len(wav) / self.audio_cfg.sample_rate / dt


def make_voice_converter(ppg2mel_fpath: Optional[Union[str, Path]] = None,
                         verbose: bool = True, device: Union[str, torch.device] = "cuda",
                         seed: int = 0):
    """The PPG one-shot voice-conversion pipeline (``VoiceConverter``):
    ppg2mel weights from an ``.npz`` export, or from ``seed`` without one."""
    from .models.ppg import VoiceConverter
    return VoiceConverter(ppg2mel_fpath, verbose=verbose, seed=seed, device=device)
