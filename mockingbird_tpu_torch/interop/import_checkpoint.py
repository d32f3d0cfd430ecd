"""Import reference/community PyTorch checkpoints into the port.

Port of ``mockingbird_tpu/interop/import_checkpoint.py``. It reads the
reference's on-disk containers and writes, where the JAX package writes an
orbax checkpoint, an ``.npz`` export (``weights.save_npz``) of the same
structure, with the family's config as a ``.json`` sidecar beside it:

  family          torch container                         → saved structure
  encoder         {step, model_state, optimizer_state}    → {model}
  tacotron        {model_state, optimizer_state}          → {params, batch_stats}
                  (+ the reference's ``.json`` hparams sidecar, honoured)
  wavernn         {model_state, optimizer_state} or raw   → {params, batch_stats}
  hifigan/fregan  {generator} g_* file                    → {params}
  vits            {model, iteration, ...} G_* file        → {params}
  ppg_extractor   raw espnet asr state_dict (24epoch.pt)  → {params, batch_stats}
  ppg2mel         {model} best_loss_step_*.pth            → {params, batch_stats}
  wav2emo         HF / reference emotion model            → {params}

Each family's loader in the port reads the result: ``SpeakerEncoderInference
.from_checkpoint``, ``Synthesizer``, ``WaveRnnVocoder``, ``GanVocoder``,
``VitsSynthesizer``, ``PPGExtractor``, ``VoiceConverter`` and
``EmotionExtractor``.

Usage: ``python -m mockingbird_tpu_torch.cli import-checkpoint --family vits
--torch-ckpt G_64000.pth --out vits_imported`` writes ``vits_imported.npz``
and ``vits_imported.json``; pass the ``.npz`` wherever the port takes a
model path.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import Config
from ..weights import save_npz
from . import torch_weights as tw

FAMILIES = ("encoder", "tacotron", "wavernn", "hifigan", "fregan", "vits",
            "ppg_extractor", "ppg2mel", "wav2emo")


def _load_torch_state_dict(path):
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("model_state", "model", "generator", "state_dict"):
            if key in ckpt and isinstance(ckpt[key], dict):
                ckpt = ckpt[key]
                break
    return {k: np.asarray(v.detach().cpu().numpy())
            for k, v in ckpt.items() if hasattr(v, "detach")}


def import_reference_checkpoint(family: str, torch_ckpt, out_path,
                                cfg: Optional[Config] = None,
                                verbose: bool = True) -> Path:
    """Convert a reference torch checkpoint into the port's ``.npz`` export
    (``out_path`` when it ends in ``.npz``, else ``out_path`` with ``.npz``
    appended) and its ``.json`` config sidecar (none for the encoder, which
    has no config). Returns the ``.npz`` path."""
    assert family in FAMILIES, f"family must be one of {FAMILIES}"
    sd = _load_torch_state_dict(torch_ckpt)
    out = Path(out_path)
    if out.suffix != ".npz":
        out = out.with_name(out.name + ".npz")
    c = None

    if family == "encoder":
        state = {"model": tw.convert_encoder(sd)}
    elif family == "tacotron":
        from ..models.tacotron.model import tacotron_config
        c = Config(tacotron_config()).merge(cfg or {})
        # honour the reference's json hparams sidecar if present
        sidecar = Path(torch_ckpt).with_suffix(".json")
        if sidecar.exists():
            c.merge(Config.from_json(sidecar))
        params, stats = tw.convert_tacotron(sd, c)
        state = {"params": params, "batch_stats": stats}
    elif family == "wavernn":
        from ..models.vocoder.wavernn import wavernn_config
        c = Config(wavernn_config()).merge(cfg or {})
        params, stats = tw.convert_wavernn(sd, c)
        state = {"params": params, "batch_stats": stats}
    elif family == "hifigan":
        from ..models.vocoder.hifigan import hifigan_config
        c = Config(hifigan_config()).merge(cfg or {})
        state = {"params": tw.convert_hifigan_generator(sd, c)}
    elif family == "fregan":
        from ..models.vocoder.fregan import fregan_config
        c = Config(fregan_config()).merge(cfg or {})
        state = {"params": tw.convert_fregan_generator(sd, c)}
    elif family == "vits":
        from ..models.vits.model import vits_config
        c = Config(vits_config()).merge(cfg or {})
        state = {"params": tw.convert_vits(sd, c)}
    elif family == "ppg_extractor":
        from ..models.ppg.extractor import ppg_config
        c = Config(ppg_config()).merge(cfg or {})
        params, stats = tw.convert_conformer_encoder(sd, c, prefix="encoder")
        state = {"params": {"encoder": params}, "batch_stats": {"encoder": stats}}
    elif family == "wav2emo":
        from ..models.wav2emo import wav2emo_config
        c = Config(wav2emo_config()).merge(cfg or {})
        prefix = "wav2vec2" if any(k.startswith("wav2vec2.") for k in sd) else ""
        state = {"params": tw.convert_wav2vec2_emotion(sd, c, prefix=prefix)}
    else:  # ppg2mel
        from ..models.ppg.ppg2mel import ppg2mel_config
        c = Config(ppg2mel_config()).merge(cfg or {})
        params, stats = tw.convert_ppg2mel(sd, c)
        state = {"params": params, "batch_stats": stats}

    out.parent.mkdir(parents=True, exist_ok=True)
    save_npz(out, state)
    if c is not None:
        out.with_suffix(".json").write_text(json.dumps(c.to_dict(), indent=2))
    if verbose:
        n = sum(x.size for x in _leaves(state))
        print(f"Imported {family} checkpoint {torch_ckpt} → {out} ({n / 1e6:.2f}M params)")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
