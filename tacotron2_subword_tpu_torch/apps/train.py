"""Training CLI of the port, on synthetic data.

    python -m tacotron2_subword_tpu_torch.apps.train -o outdir --synthetic 64 \
        [--hparams "[k:v-k:v]"] [--batch-size 8] [--max-iters N] \
        [--log-interval 1] [--device cpu]

The ``--synthetic N`` path of ``tacotron2_subword_tpu/apps/train.py``:
length-bucketed batches of generated utterances, one train step each,
validation every ``iters_per_checkpoint`` iterations, with the same log
lines.  Batches go to the card by a pinned-memory, non-blocking copy.  The
device is CUDA unless ``--device cpu`` is given.

Not ported yet (ROADMAP Queue 1 item 9): the real-data file lists,
checkpoints, the logger, meshes, AOT warm-up, the profiler and prefetch;
their flags do not exist here, so passing one is an argparse error.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from tacotron2_subword_tpu_torch import train_lib as T
from tacotron2_subword_tpu_torch.config import TacotronConfig, create_config
from tacotron2_subword_tpu_torch.data.dataset import BucketedLoader
from tacotron2_subword_tpu_torch.utils.platform import resolve_device


class SyntheticDataset:
    """Generated utterances with the real pipeline's shapes (the JAX
    package's ``SyntheticDataset``, the same numbers per seed and index)."""

    def __init__(self, cfg: TacotronConfig, n: int = 64, seed: int = 0):
        self.cfg = cfg
        self.n = n
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed * 100003 + i)
        T_text = rng.randint(20, 60)
        T_mel = rng.randint(80, 240)
        return {
            "text": rng.randint(0, self.cfg.n_symbols, T_text
                                ).astype(np.int32),
            "sub": rng.randint(0, self.cfg.sub_n_symbols,
                               rng.randint(8, 24)).astype(np.int32),
            "cls": rng.randn(self.cfg.bert_embedding_dim
                             ).astype(np.float32),
            "mel": rng.randn(self.cfg.n_mel_channels, T_mel
                             ).astype(np.float32),
            "durations": np.ones(T_text, np.int32),
        }


def device_batch(batch: Dict[str, np.ndarray],
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device`` (pinned, non-blocking on CUDA;
    ids as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype == torch.int32:
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def validate(state, loader, cfg, device, generator):
    """Weighted mean of the total loss over the loader's batches."""
    total, n = 0.0, 0.0
    for batch in loader:
        losses, _ = T.eval_step(state, device_batch(batch, device), cfg,
                                generator=generator)
        w = float(np.sum(batch["weight"]))
        total += float(losses["total"]) * w
        n += w
    return total / max(n, 1.0)


def train(args) -> Dict[str, Optional[float]]:
    """Run the training loop; returns the last iteration, loss and
    validation loss."""
    if not args.synthetic:
        raise SystemExit("only --synthetic N is ported: the real-data "
                         "pipeline waits for ROADMAP Queue 1 item 9")
    cfg = create_config(hparams_string=args.hparams)
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    device = resolve_device(args.device)
    os.makedirs(args.output_directory, exist_ok=True)

    train_ds = SyntheticDataset(cfg, args.synthetic, seed=1)
    val_ds = SyntheticDataset(cfg, max(8, args.synthetic // 8), seed=2)
    loader_kw = dict(batch_size=cfg.batch_size,
                     with_alignment=bool(cfg.align_loss),
                     frames_per_step=cfg.n_frames_per_step)
    train_loader = BucketedLoader(train_ds, **loader_kw)
    state, tx = T.create_train_state(torch.Generator().manual_seed(cfg.seed),
                                     cfg, device=device)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    print(f"training: {device}, batch {cfg.batch_size}, {len(train_ds)} "
          f"utterances", flush=True)
    iteration, total, val_loss = 0, None, None
    for epoch in range(cfg.epochs):
        for batch in train_loader:
            t0 = time.perf_counter()
            state, metrics = T.train_step(state, device_batch(batch, device),
                                          cfg, tx, generator=generator)
            total = float(metrics["total"])  # host sync
            dt = time.perf_counter() - t0
            iteration += 1
            if iteration % args.log_interval == 0:
                print(f"epoch {epoch} iter {iteration}: loss {total:.4f} "
                      f"grad_norm {float(metrics['grad_norm']):.3f} "
                      f"{dt:.2f}s/it", flush=True)
            if iteration % cfg.iters_per_checkpoint == 0:
                val_loader = BucketedLoader(val_ds, **loader_kw)
                val_loss = validate(state, val_loader, cfg, device,
                                    generator)
                print(f"validation loss {val_loss:.4f}", flush=True)
            if args.max_iters and iteration >= args.max_iters:
                print("reached max iters", flush=True)
                return {"iterations": iteration, "loss": total,
                        "val_loss": val_loss}
    return {"iterations": iteration, "loss": total, "val_loss": val_loss}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-o", "--output_directory", required=True)
    p.add_argument("--hparams", default=None,
                   help='reference-style "[k:v-k:v]" overrides')
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic utterances")
    p.add_argument("--max-iters", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default) or "cpu"')
    return p


def main(argv=None):
    return train(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
