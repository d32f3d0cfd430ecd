"""Training visualisations as PNG files.

Port of ``mockingbird_tpu/train/visualizations.py``, the parts a trainer
draws: 2-D embedding projections (UMAP when ``umap`` is installed, else PCA
by SVD) for the GE2E trainer, and the ppg2mel trainer's attention map
(``plot_alignment``), drawn with matplotlib. matplotlib is optional:
``have_matplotlib()`` says whether it is importable, and the trainers check
it before they draw, printing one line when a PNG is skipped.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Optional

import numpy as np

_COLORMAP = np.array([
    [76, 255, 0], [0, 127, 70], [255, 0, 0], [255, 217, 38], [0, 135, 255],
    [165, 0, 165], [255, 167, 255], [0, 255, 255], [255, 96, 38],
    [142, 76, 0], [33, 0, 127], [0, 0, 0], [183, 183, 183],
], dtype=float) / 255


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def project_embeddings(embeds: np.ndarray) -> np.ndarray:
    """(N, D) → (N, 2) by UMAP if installed, else PCA."""
    if importlib.util.find_spec("umap") is not None:
        import umap
        return umap.UMAP().fit_transform(embeds)
    x = embeds - embeds.mean(axis=0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:2].T


def draw_projections(embeds: np.ndarray, utterances_per_speaker: int,
                     step: int, out_fpath: Optional[Path] = None,
                     max_speakers: int = 10) -> np.ndarray:
    """Scatter the projections of the first ``max_speakers`` speakers'
    embeddings, one colour per speaker; returns the projections."""
    plt = _pyplot()
    n_speakers = min(max_speakers, len(embeds) // utterances_per_speaker)
    embeds = embeds[: n_speakers * utterances_per_speaker]
    ground_truth = np.repeat(np.arange(n_speakers), utterances_per_speaker)
    colors = [_COLORMAP[i % len(_COLORMAP)] for i in ground_truth]

    projected = project_embeddings(embeds)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(projected[:, 0], projected[:, 1], c=colors)
    ax.set_title(f"Embedding projections (step {step})")
    ax.set_aspect("equal")
    if out_fpath is not None:
        fig.savefig(out_fpath, dpi=80)
    plt.close(fig)
    return projected


def plot_alignment(attn: np.ndarray, out_fpath: Path) -> None:
    """(decoder steps, memory) attention → PNG, memory on the vertical axis."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.imshow(np.asarray(attn).T, aspect="auto", origin="lower", interpolation="none")
    ax.set_xlabel("decoder step")
    ax.set_ylabel("memory")
    fig.savefig(out_fpath, dpi=80)
    plt.close(fig)
