"""Speaker-verification data objects (host side).

The port's own copy of ``mockingbird_tpu/models/encoder/dataset.py``: an
infinite speaker-balanced sampler built on constrained-random cycling,
yielding fixed-shape (speakers, utterances, partials_n_frames, 40) mel
batches. With the same ``seed`` it yields exactly the JAX package's batches:
both draw from ``random.Random(seed)`` and ``np.random.RandomState(seed)``
in the same order.
"""
from __future__ import annotations

import random
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np


class RandomCycler:
    """Constrained-random order: over any window of n*len(source) consecutive
    samples, each item appears exactly n times."""

    def __init__(self, source, rng=None):
        if len(source) == 0:
            raise Exception("Can't create RandomCycler from an empty collection")
        self.all_items = list(source)
        self.next_items: list = []
        self.rng = rng if rng is not None else random

    def sample(self, count: int) -> list:
        shuffle = lambda l: self.rng.sample(l, len(l))
        out = []
        while count > 0:
            if count >= len(self.all_items):
                out.extend(shuffle(list(self.all_items)))
                count -= len(self.all_items)
                continue
            n = min(count, len(self.next_items))
            out.extend(self.next_items[:n])
            self.next_items = self.next_items[n:]
            if len(self.next_items) == 0:
                self.next_items = shuffle(list(self.all_items))
            count -= n
        return out

    def __next__(self):
        return self.sample(1)[0]


class Utterance:
    def __init__(self, frames_fpath: Path):
        self.frames_fpath = Path(frames_fpath)

    def get_frames(self) -> np.ndarray:
        return np.load(self.frames_fpath)

    def random_partial(self, n_frames: int, np_rng=None) -> tuple[np.ndarray, tuple[int, int]]:
        """Crop (or zero-pad, for a clip shorter than n_frames) a random
        n_frames window."""
        frames = self.get_frames()
        if frames.shape[0] < n_frames:
            pad = np.zeros((n_frames - frames.shape[0], frames.shape[1]), frames.dtype)
            frames = np.concatenate([frames, pad], axis=0)
        r = np_rng if np_rng is not None else np.random
        start = 0 if frames.shape[0] == n_frames else r.randint(0, frames.shape[0] - n_frames)
        return frames[start : start + n_frames], (start, start + n_frames)


class Speaker:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.name = self.root.name
        self.utterances: Optional[List[Utterance]] = None
        self.utterance_cycler: Optional[RandomCycler] = None

    def _load_utterances(self):
        sources_file = self.root / "_sources.txt"
        if sources_file.exists():
            with sources_file.open() as f:
                names = [line.split(",")[0] for line in f if line.strip()]
            paths = [self.root / n for n in names]
        else:
            paths = sorted(self.root.glob("*.npy"))
        self.utterances = [Utterance(p) for p in paths]
        self.utterance_cycler = RandomCycler(self.utterances)

    def random_partial(self, count: int, n_frames: int, rng=None, np_rng=None):
        if self.utterances is None:
            self._load_utterances()
        if rng is not None:
            self.utterance_cycler.rng = rng
        utterances = self.utterance_cycler.sample(count)
        return [(u,) + u.random_partial(n_frames, np_rng) for u in utterances]


class SpeakerVerificationDataset:
    """Iterates forever over speaker directories of preprocessed .npy mels."""

    def __init__(self, datasets_root: Path):
        self.root = Path(datasets_root)
        speaker_dirs = [d for d in sorted(self.root.glob("*")) if d.is_dir()]
        if len(speaker_dirs) == 0:
            raise Exception("No speakers found. Make sure you are pointing to the directory "
                            "containing all preprocessed speaker directories.")
        self.speakers = [Speaker(d) for d in speaker_dirs]
        self.speaker_cycler = RandomCycler(self.speakers)

    def __len__(self):
        return int(1e10)

    def num_speakers(self):
        return len(self.speakers)


class SpeakerBatchSampler:
    """Yields (S, U, n_frames, 40) float32 arrays forever; ``seed`` makes
    the stream deterministic."""

    def __init__(self, dataset: SpeakerVerificationDataset,
                 speakers_per_batch: int, utterances_per_speaker: int, n_frames: int,
                 seed: Optional[int] = None):
        self.dataset = dataset
        self.s = speakers_per_batch
        self.u = utterances_per_speaker
        self.n_frames = n_frames
        self.rng = random.Random(seed) if seed is not None else None
        self.np_rng = np.random.RandomState(seed) if seed is not None else None
        if self.rng is not None:
            dataset.speaker_cycler.rng = self.rng

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> np.ndarray:
        speakers = self.dataset.speaker_cycler.sample(self.s)
        batch = np.zeros((self.s, self.u, self.n_frames, 40), dtype=np.float32)
        for i, spk in enumerate(speakers):
            partials = spk.random_partial(self.u, self.n_frames, self.rng, self.np_rng)
            for j, (_, frames, _) in enumerate(partials):
                batch[i, j] = frames
        return batch
