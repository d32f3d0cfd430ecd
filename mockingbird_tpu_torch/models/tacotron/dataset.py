"""Synthesizer dataset and collate (host side).

Port of ``mockingbird_tpu/models/tacotron/dataset.py``: reads ``train.txt``
pipe-separated metadata next to the ``mels/`` and ``embeds/`` dirs, yields
(text ids, mel, speaker embedding, index) tuples; collate zero-pads text and
pads mels with the silence value (−max_abs_value). Lengths are padded to
buckets of ``TEXT_BUCKET`` symbols and ``MEL_BUCKET`` frames, as in the JAX
package: the buckets decide numbers, not only shapes, since padded frames
carry the silence value and count in the (unmasked) loss.
"""
from __future__ import annotations

import queue
import random
import threading
from pathlib import Path
from typing import Iterator, List

import numpy as np

from ...text import text_to_sequence

TEXT_BUCKET = 32
MEL_BUCKET = 100


class SynthesizerDataset:
    def __init__(self, metadata_fpath: Path, mel_dir: Path, embed_dir: Path,
                 cleaner_names: List[str] = ("basic_cleaners",), num_mels: int = 80):
        self.num_mels = num_mels
        metadata_fpath, mel_dir, embed_dir = Path(metadata_fpath), Path(mel_dir), Path(embed_dir)
        with metadata_fpath.open("r", encoding="utf-8") as f:
            metadata = [line.strip().split("|") for line in f if line.strip()]
        used = [x for x in metadata if int(x[4])]
        self.mel_fpaths = [mel_dir / x[1] for x in used]
        self.embed_fpaths = [embed_dir / x[2] for x in used]
        self.texts = [x[5].strip() for x in used]
        self.cleaner_names = list(cleaner_names)
        print(f"Found {len(self.mel_fpaths)} samples")

    def __len__(self):
        return len(self.mel_fpaths)

    def __getitem__(self, index):
        text = np.asarray(text_to_sequence(self.texts[index], self.cleaner_names), np.int32)
        mel = np.load(self.mel_fpaths[index]).astype(np.float32)
        if mel.shape[0] == self.num_mels and mel.shape[1] != self.num_mels:
            mel = mel.T  # stored bin-major (M, T) → time-major
        if mel.shape[1] != self.num_mels:
            raise ValueError(f"{self.mel_fpaths[index]}: mel of shape {mel.shape}, "
                             f"not {self.num_mels} bins")
        embed = np.load(self.embed_fpaths[index]).astype(np.float32)
        return text, mel, embed, index


def _ceil_to(n: int, m: int) -> int:
    return int(((n + m - 1) // m) * m)


def collate_synthesizer(batch, r: int, max_abs_value: float = 4.0,
                        text_bucket: int = TEXT_BUCKET, mel_bucket: int = MEL_BUCKET):
    """→ dict(texts (B,Tt) int32, mels (B,Tm,M), embeds (B,256), stop (B,Tm),
    text_lengths, mel_lengths, indices). Mel pad value is −max_abs_value
    (silence); the stop target is 1 from the last real frame on."""
    texts, mels, embeds, idx = zip(*batch)
    text_lens = np.array([len(t) for t in texts], np.int32)
    mel_lens = np.array([m.shape[0] for m in mels], np.int32)

    t_text = _ceil_to(max(text_lens), text_bucket)
    t_mel = _ceil_to(_ceil_to(max(mel_lens), mel_bucket), r)

    b, m = len(batch), mels[0].shape[1]
    text_arr = np.zeros((b, t_text), np.int32)
    mel_arr = np.full((b, t_mel, m), -max_abs_value, np.float32)
    stop_arr = np.ones((b, t_mel), np.float32)
    for i, (t, mel) in enumerate(zip(texts, mels)):
        text_arr[i, : len(t)] = t
        mel_arr[i, : mel.shape[0]] = mel
        stop_arr[i, : max(mel.shape[0] - 1, 0)] = 0.0

    return dict(texts=text_arr, mels=mel_arr, embeds=np.stack(embeds).astype(np.float32),
                stop=stop_arr, text_lengths=text_lens, mel_lengths=mel_lens,
                indices=np.asarray(idx, np.int32))


class DataLoader:
    """Shuffling batch loader over an indexable dataset, yielding collated
    numpy batches. The order comes from ``random.Random(seed)``, one shuffle
    per pass, as in the JAX package, so both give the same batches. A
    background thread prefetches two batches ahead (disk reads and
    collation overlap the device step)."""

    def __init__(self, dataset, batch_size: int, collate_fn, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = random.Random(seed)

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _batches(self) -> Iterator[dict]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        chunks = [order[i : i + bs] for i in range(0, len(order), bs)]
        if self.drop_last:
            chunks = [c for c in chunks if len(c) == bs]
        for chunk in chunks:
            yield self.collate_fn([self.dataset[i] for i in chunk])

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=2)
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._batches():
                    if not put(b):
                        return              # the consumer left the pass early
                put(end)
            except Exception as e:          # handed to the consumer, raised there
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)
