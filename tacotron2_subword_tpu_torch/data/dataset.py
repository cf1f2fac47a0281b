"""Data pipeline of the training path: the reference-format corpus on
disk, padding, length buckets and background prefetch (numpy on the host).

The port's own copy of ``tacotron2_subword_tpu/data/dataset.py``:
``load_filepaths``, ``create_alignment_target``, ``BertTacotron2Dataset``
(per utterance a durations npy with phone IDs in column 0 and durations in
column 1, ``ljspeech-mel-%05d.npy`` (1-indexed), subword IDs and a BERT
[CLS] vector per index), ``pad_batch`` and ``BucketedLoader`` with the same
bucket edges, padding, gate target and repeat-to-fill ``weight``, so one
corpus gives the same batches in both packages, the loader's shard
options for multi-rank training, and ``PrefetchLoader``.

Left out: ``compile_plan``, which costs the XLA compile budget of the
bucket grid.  PyTorch compiles nothing per bucket shape.
"""

from __future__ import annotations

import bisect
import os
import queue
import threading
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np


def load_filepaths(path: str, split: str = "|") -> List[List[str]]:
    """Rows of a ``wav|durations.npy`` list file, blank lines skipped."""
    with open(path, encoding="utf-8") as f:
        return [line.strip().split(split) for line in f if line.strip()]


def create_alignment_target(durations: np.ndarray, n_frames: int,
                            n_phones: Optional[int] = None) -> np.ndarray:
    """Per-phone durations -> a 0/1 [n_frames, n_phones] alignment; frames
    past the durations' sum stay 0, durations past ``n_frames`` are cut
    (reference utils.py:92-117)."""
    n_phones = n_phones or len(durations)
    out = np.zeros((n_frames, n_phones), np.float32)
    t = 0
    for i, d in enumerate(durations):
        d = int(d)
        out[t:min(t + d, n_frames), i] = 1.0
        t += d
        if t >= n_frames:
            break
    return out


class BertTacotron2Dataset:
    """(phone IDs, subword IDs, [CLS] vector, mel, durations) per index:
    ``mel_dir/ljspeech-mel-%05d.npy`` (index + 1), ``sub_dir/{i}.npy``,
    ``cls_dir/{i}.npy``, and the list row's last field naming the
    durations npy.  A mel stored as [T, 80] is transposed to [80, T].
    ``load_alignment`` adds the duration-expanded ``alignment`` target."""

    def __init__(self, file_list: Sequence[Sequence[str]], mel_dir: str,
                 sub_dir: str, cls_dir: str, load_alignment: bool = False):
        self.rows = list(file_list)
        self.mel_dir = mel_dir
        self.sub_dir = sub_dir
        self.cls_dir = cls_dir
        self.load_alignment = load_alignment

    def __len__(self) -> int:
        return len(self.rows)

    def _mel_path(self, i: int) -> str:
        return os.path.join(self.mel_dir, f"ljspeech-mel-{i + 1:05d}.npy")

    def lengths(self, i: int) -> Tuple[int, int, int]:
        """(text_len, sub_len, mel_len) from the npy headers alone."""
        dur = np.load(self.rows[i][-1], mmap_mode="r")
        sub = np.load(os.path.join(self.sub_dir, f"{i}.npy"), mmap_mode="r")
        mel = np.load(self._mel_path(i), mmap_mode="r")
        t_mel = mel.shape[1] if mel.shape[0] == 80 else mel.shape[0]
        return dur.shape[0], sub.shape[0], int(t_mel)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        dur = np.load(self.rows[i][-1])
        text = dur[:, 0].astype(np.int32)
        durations = dur[:, 1].astype(np.int32)
        mel = np.load(self._mel_path(i)).astype(np.float32)
        if mel.shape[0] != 80 and mel.shape[1] == 80:
            mel = mel.T
        sub = np.load(os.path.join(self.sub_dir, f"{i}.npy")).astype(np.int32)
        cls = np.load(os.path.join(self.cls_dir, f"{i}.npy")).astype(
            np.float32).reshape(-1)
        sample = {"text": text, "sub": sub, "cls": cls, "mel": mel,
                  "durations": durations}
        if self.load_alignment:
            sample["alignment"] = create_alignment_target(
                durations, mel.shape[1], len(text))
        return sample


def _pad_to(x: np.ndarray, length: int, axis: int = 0,
            value: float = 0.0) -> np.ndarray:
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, length - x.shape[axis])
    return np.pad(x, pad, constant_values=value)


def pad_batch(samples: List[Dict[str, np.ndarray]],
              text_len: Optional[int] = None,
              sub_len: Optional[int] = None,
              mel_len: Optional[int] = None,
              with_alignment: bool = False) -> Dict[str, np.ndarray]:
    """Pad samples into one batch: zero-padded text/sub/mel, lengths, the
    [CLS] vector for both streams, and a gate target that is 0 before the
    last valid frame and 1 from it on."""
    text_len = text_len or max(len(s["text"]) for s in samples)
    sub_len = sub_len or max(len(s["sub"]) for s in samples)
    mel_len = mel_len or max(s["mel"].shape[1] for s in samples)
    batch = {
        "text": np.stack([_pad_to(s["text"], text_len) for s in samples]),
        "text_lengths": np.asarray([len(s["text"]) for s in samples],
                                   np.int32),
        "sub": np.stack([_pad_to(s["sub"], sub_len) for s in samples]),
        "sub_lengths": np.asarray([len(s["sub"]) for s in samples], np.int32),
        "mels": np.stack([_pad_to(s["mel"], mel_len, axis=1)
                          for s in samples]),
        "output_lengths": np.asarray([s["mel"].shape[1] for s in samples],
                                     np.int32),
        "cls_phone": np.stack([s["cls"] for s in samples]),
        "cls_sub": np.stack([s["cls"] for s in samples]),
    }
    t = np.arange(mel_len)[None, :]
    batch["gate_target"] = (
        t >= (batch["output_lengths"][:, None] - 1)).astype(np.float32)
    if with_alignment:
        batch["align_target"] = np.stack([
            _pad_to(_pad_to(s["alignment"], mel_len, axis=0), text_len,
                    axis=1) for s in samples])
    return batch


class BucketedLoader:
    """Batches of one (text, sub, mel) length bucket each, padded to the
    bucket's edges.  Nothing is dropped: a bucket's last partial batch is
    filled by repeating its last sample, and ``weight`` (1 for real rows, 0
    for the repeats) keeps the repeats out of the loss.  The order is
    shuffled per epoch, from a seed that depends on the epoch only (as in
    the JAX package, whose ``seed`` argument the shuffle does not read:
    ``seed`` is taken and unread here too).

    Shards (``shard_index`` of ``num_shards``, one per data rank): with
    ``shard_within_batch`` every shard iterates the whole dataset in the
    same order, forms the same global batches of ``batch_size`` and keeps
    its contiguous rows of each (``weight`` included), so the ranks stay in
    lockstep on batch count and shape; a ``batch_size`` that
    ``num_shards`` does not divide raises ValueError.  Without it each
    shard takes every ``num_shards``-th utterance and batches them
    itself."""

    def __init__(self, dataset, batch_size: int,
                 text_edges: Sequence[int] = (32, 64, 96, 128, 192),
                 mel_edges: Sequence[int] = (128, 256, 384, 512, 768, 1024),
                 sub_edges: Sequence[int] = (16, 32, 48, 64, 96),
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1,
                 drop_remainder: bool = False,
                 with_alignment: bool = False, frames_per_step: int = 1,
                 shard_within_batch: bool = False):
        if shard_within_batch and batch_size % num_shards:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"num_shards={num_shards}")
        self.ds = dataset
        self.batch_size = batch_size
        self.text_edges = sorted(text_edges)
        # mel pad lengths must divide n_frames_per_step
        r = max(int(frames_per_step), 1)
        self.mel_edges = sorted({-(-e // r) * r for e in mel_edges})
        self.sub_edges = sorted(sub_edges)
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.shard_within_batch = shard_within_batch
        self.drop_remainder = drop_remainder
        self.with_alignment = with_alignment
        self.epoch = 0

    def _edge(self, edges: Sequence[int], v: int) -> int:
        i = bisect.bisect_left(edges, v)
        return edges[min(i, len(edges) - 1)]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(len(self.ds))
        np.random.RandomState(self.epoch * 9973 + 17).shuffle(idx)
        if not self.shard_within_batch:
            idx = idx[self.shard_index::self.num_shards]
        self.epoch += 1
        buckets: Dict[Tuple[int, int, int], list] = {}
        for i in idx:
            s = self.ds[int(i)]
            key = (self._edge(self.text_edges, len(s["text"])),
                   self._edge(self.sub_edges, len(s["sub"])),
                   self._edge(self.mel_edges, s["mel"].shape[1]))
            buckets.setdefault(key, []).append(s)
            if len(buckets[key]) == self.batch_size:
                yield self._rows(self._emit(key, buckets.pop(key)))
        for key, rest in sorted(buckets.items()):
            if self.drop_remainder:
                continue
            weight = np.zeros(self.batch_size, np.float32)
            weight[:len(rest)] = 1.0
            while len(rest) < self.batch_size:
                rest.append(rest[-1])
            b = self._emit(key, rest)
            b["weight"] = weight
            yield self._rows(b)

    def _emit(self, key, samples) -> Dict[str, np.ndarray]:
        t, s, m = key
        b = pad_batch(samples, text_len=t, sub_len=s, mel_len=m,
                      with_alignment=self.with_alignment)
        b["weight"] = np.ones(len(samples), np.float32)
        return b

    def _rows(self, b: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This shard's contiguous rows of a global batch (lockstep
        mode)."""
        if not self.shard_within_batch or self.num_shards == 1:
            return b
        k = self.batch_size // self.num_shards
        lo = self.shard_index * k
        return {key: v[lo:lo + k] for key, v in b.items()}


class PrefetchLoader:
    """Iterates ``loader`` in a producer thread, ``depth`` batches ahead,
    with ``stage`` (e.g. the copy to the card) run in that thread.

    The order is kept.  An exception in the producer is raised in the
    consumer.  Leaving the iteration early (``close`` or a dropped
    iterator) stops the producer and joins it.  Each ``iter`` runs the
    loader anew, so one PrefetchLoader serves every epoch.  The producer
    shares the GIL with the consumer: it overlaps the npy reads and the
    copies, not Python work."""

    _DONE = object()

    def __init__(self, loader, depth: int = 2,
                 stage: Optional[Callable] = None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.loader = loader
        self.depth = depth
        self.stage = stage

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for batch in self.loader:
                    if self.stage is not None:
                        batch = self.stage(batch)
                    if not put(batch):
                        return
                put(PrefetchLoader._DONE)
            except BaseException as e:  # raised again in the consumer
                put(e)

        t = threading.Thread(target=produce, daemon=True,
                             name="prefetch-loader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is PrefetchLoader._DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=30.0)
            if t.is_alive():
                raise RuntimeError("prefetch producer did not stop")
