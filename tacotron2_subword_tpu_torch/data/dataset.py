"""Batching for the training path: padding and length buckets (numpy).

The port's own copy of ``pad_batch`` and ``BucketedLoader`` from
``tacotron2_subword_tpu/data/dataset.py``, with the same bucket edges,
padding, gate target and repeat-to-fill ``weight``, so one dataset gives the
same batches in both packages.  The loader is single-process: the JAX
package's multi-host shard options are left out.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


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
    the JAX package, whose ``seed`` argument the shuffle does not read)."""

    def __init__(self, dataset, batch_size: int,
                 text_edges: Sequence[int] = (32, 64, 96, 128, 192),
                 mel_edges: Sequence[int] = (128, 256, 384, 512, 768, 1024),
                 sub_edges: Sequence[int] = (16, 32, 48, 64, 96),
                 drop_remainder: bool = False,
                 with_alignment: bool = False, frames_per_step: int = 1):
        self.ds = dataset
        self.batch_size = batch_size
        self.text_edges = sorted(text_edges)
        # mel pad lengths must divide n_frames_per_step
        r = max(int(frames_per_step), 1)
        self.mel_edges = sorted({-(-e // r) * r for e in mel_edges})
        self.sub_edges = sorted(sub_edges)
        self.drop_remainder = drop_remainder
        self.with_alignment = with_alignment
        self.epoch = 0

    def _edge(self, edges: Sequence[int], v: int) -> int:
        i = bisect.bisect_left(edges, v)
        return edges[min(i, len(edges) - 1)]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(len(self.ds))
        np.random.RandomState(self.epoch * 9973 + 17).shuffle(idx)
        self.epoch += 1
        buckets: Dict[Tuple[int, int, int], list] = {}
        for i in idx:
            s = self.ds[int(i)]
            key = (self._edge(self.text_edges, len(s["text"])),
                   self._edge(self.sub_edges, len(s["sub"])),
                   self._edge(self.mel_edges, s["mel"].shape[1]))
            buckets.setdefault(key, []).append(s)
            if len(buckets[key]) == self.batch_size:
                yield self._emit(key, buckets.pop(key))
        for key, rest in sorted(buckets.items()):
            if self.drop_remainder:
                continue
            weight = np.zeros(self.batch_size, np.float32)
            weight[:len(rest)] = 1.0
            while len(rest) < self.batch_size:
                rest.append(rest[-1])
            b = self._emit(key, rest)
            b["weight"] = weight
            yield b

    def _emit(self, key, samples) -> Dict[str, np.ndarray]:
        t, s, m = key
        b = pad_batch(samples, text_len=t, sub_len=s, mel_len=m,
                      with_alignment=self.with_alignment)
        b["weight"] = np.ones(len(samples), np.float32)
        return b
