"""Training CLI of the port (``tacotron2_subword_tpu/apps/train.py``;
reference train.py:188-439).

    python -m tacotron2_subword_tpu_torch.apps.train -o outdir [-l logdir] \
        --train-list train.txt --val-list val.txt --mel-dir mels \
        --sub-dir subs --cls-dir cls [-c checkpoint [--warm_start]] \
        [--hparams "[k:v-k:v]"] [--batch-size 8] [--prefetch 2] \
        [--profile-dir dir] [--max-iters N] [--device cpu]

On several cards, one process per card:

    python -m torch.distributed.run --nproc_per_node=N \
        -m tacotron2_subword_tpu_torch.apps.train --multihost \
        [--model-parallel M] -o outdir ...

or ``--synthetic N`` in place of the file lists (generated utterances
with the real pipeline's shapes).  Length-bucketed batches go to the card
by a pinned, non-blocking copy in a prefetch thread (``--prefetch 0``:
in the loop), one train step each; every ``iters_per_checkpoint``
iterations a validation pass (K3 for the soft-DTW term), a
``checkpoint_{n}`` and, when the loss fell, ``checkpoint_best``.  The
device is CUDA unless ``--device cpu`` is given.

Resume: ``-c`` wins over the newest ``checkpoint_*`` in the output dir;
the step, params, BN statistics and Adam state come from it, and the
learning rate from its meta.json when ``use_saved_learning_rate`` is set
and the checkpoint recorded one (> 0); the optimizer takes it, as the
reference's does.  The dropout generator
starts again from ``cfg.seed`` and the loader from epoch 0, as the JAX CLI
restarts its key: a resumed run does not replay a straight run's draws.
``-c path --warm_start`` loads params and BN statistics only, keeping
``cfg.ignore_layers`` fresh.

``--multihost`` initializes ``torch.distributed`` from the torchrun
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL
on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``.  The JAX CLI runs one
process per host over all its devices; here it is one process per card.
The ranks form a (data, model) mesh (``parallel.mesh``) with
``--model-parallel`` ranks on the model axis: ``--batch-size`` is per data
rank, so the global batch is batch-size x n_data, and every rank's loader
forms the same global batches and keeps its rows.  N ranks compute what
one process computes on the global batch.  Rank (0, 0) prints, writes the
checkpoints (the full state, in the one-file format) and the logs; every
rank loads a checkpoint and keeps its slices.

Left out: ``--aot-warmup`` and the compile plan (XLA compile-budget tools;
PyTorch compiles nothing per bucket shape).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from tacotron2_subword_tpu_torch import train_lib as T
from tacotron2_subword_tpu_torch.config import TacotronConfig, create_config
from tacotron2_subword_tpu_torch.data.dataset import (
    BertTacotron2Dataset, BucketedLoader, PrefetchLoader, load_filepaths)
from tacotron2_subword_tpu_torch.parallel import mesh as PM
from tacotron2_subword_tpu_torch.utils import checkpoint as CK
from tacotron2_subword_tpu_torch.utils.logging_utils import Tacotron2Logger
from tacotron2_subword_tpu_torch.utils.platform import (StepProfiler,
                                                        resolve_device)


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


def validate(state, loader, cfg, device, generator, mesh=None, plan=None):
    """(weighted mean of the total loss over the loader's global batches,
    the last batch's (outputs, device batch) of this rank)."""
    mesh = mesh or PM.Mesh()
    total, n, last = 0.0, 0.0, None
    for batch in loader:
        db = device_batch(batch, device)
        losses, outputs = T.eval_step(state, db, cfg, mesh=mesh, plan=plan,
                                      generator=generator)
        w = float(mesh.data_sum(db["weight"].sum()))
        total += float(losses["total"]) * w
        n += w
        last = (outputs, db)
    return total / max(n, 1.0), last


def _datasets(args, cfg):
    if args.synthetic:
        return (SyntheticDataset(cfg, args.synthetic, seed=1),
                SyntheticDataset(cfg, max(8, args.synthetic // 8), seed=2))
    need = ("train_list", "val_list", "mel_dir", "sub_dir", "cls_dir")
    missing = [k for k in need if not getattr(args, k)]
    if missing:
        raise SystemExit("give --synthetic N, or every one of --train-list "
                         "--val-list --mel-dir --sub-dir --cls-dir (missing: "
                         + ", ".join(missing) + ")")
    align = bool(cfg.align_loss)
    train_ds = BertTacotron2Dataset(load_filepaths(args.train_list),
                                    args.mel_dir, args.sub_dir, args.cls_dir,
                                    load_alignment=align)
    val_ds = BertTacotron2Dataset(load_filepaths(args.val_list),
                                  args.val_mel_dir or args.mel_dir,
                                  args.val_sub_dir or args.sub_dir,
                                  args.val_cls_dir or args.cls_dir,
                                  load_alignment=align)
    return train_ds, val_ds


def train(args) -> Dict[str, Optional[float]]:
    """Run the training loop.  Returns the first and last iteration, the
    last step's metrics and validation loss, and per iteration its total
    loss and its wall seconds from the end of the previous one (batch wait
    included, validation and checkpoints not)."""
    cfg = create_config(hparams_string=args.hparams)
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    if args.tokenizer_vocab:
        cfg = cfg.replace(sub_n_symbols=args.tokenizer_vocab)
    if args.multihost:
        device = PM.init_from_env(args.device)
    else:
        device = resolve_device(args.device)
    try:
        return _train(args, cfg, device)
    finally:
        if args.multihost:
            dist.destroy_process_group()


def _train(args, cfg: TacotronConfig, device) -> Dict[str, Optional[float]]:
    mesh = PM.make_mesh(n_model=args.model_parallel)
    # the backend's communicators, set up while the ranks are in lockstep
    PM.collective_barrier(mesh)
    say = print if mesh.is_main else (lambda *a, **k: None)
    global_batch = cfg.batch_size * mesh.n_data
    os.makedirs(args.output_directory, exist_ok=True)

    train_ds, val_ds = _datasets(args, cfg)
    loader_kw = dict(batch_size=global_batch, shard_index=mesh.data,
                     num_shards=mesh.n_data, shard_within_batch=True,
                     with_alignment=bool(cfg.align_loss),
                     frames_per_step=cfg.n_frames_per_step)
    train_loader = BucketedLoader(train_ds, **loader_kw)
    state, _ = T.create_train_state(torch.Generator().manual_seed(cfg.seed),
                                    cfg, device=device)
    learning_rate = cfg.learning_rate

    start_iter = 0
    ckpt_path = args.checkpoint or CK.scan_checkpoint(args.output_directory)
    if ckpt_path and not args.warm_start:
        state, meta = CK.load_checkpoint(ckpt_path, device)
        start_iter = state.step
        if cfg.use_saved_learning_rate and meta.get("learning_rate", 0) > 0:
            learning_rate = meta["learning_rate"]
        say(f"resumed from {ckpt_path} at iteration {start_iter}",
            flush=True)
    elif ckpt_path and args.warm_start:
        state = CK.warm_start(ckpt_path, state, cfg.ignore_layers)
        say(f"warm-started from {ckpt_path}", flush=True)
    tx = T.make_optimizer(cfg, learning_rate)
    shardings = PM.train_state_shardings(state, mesh)
    state = PM.shard_train_state(state, mesh)

    logger = (Tacotron2Logger(args.log_directory)
              if args.log_directory and mesh.is_main else None)
    profiler = StepProfiler(args.profile_dir if mesh.is_main else None)
    best = CK.BestTracker(args.output_directory, mesh)
    # seeded alike on every rank: each draws the global batch's randomness
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    stage = lambda batch: device_batch(batch, device)

    def staged(loader):
        if args.prefetch > 0:
            return PrefetchLoader(loader, depth=args.prefetch, stage=stage)
        return map(stage, loader)

    say(f"training: {device}, mesh data {mesh.n_data} x model "
        f"{mesh.n_model}, global batch {global_batch}, {len(train_ds)} "
        f"utterances", flush=True)
    iteration, total, val_loss, metrics = start_iter, None, None, {}
    losses, iter_s = [], []
    result = lambda: {"start_iteration": start_iter, "iterations": iteration,
                      "loss": total, "val_loss": val_loss,
                      "metrics": {k: float(v) for k, v in metrics.items()},
                      "losses": losses, "iter_s": iter_s}
    try:
        for epoch in range(cfg.epochs):
            t_prev = time.perf_counter()
            for db in staged(train_loader):
                t0 = time.perf_counter()
                profiler.step(iteration)
                state, metrics = T.train_step(
                    state, db, cfg, tx, mesh=mesh, plan=shardings.params,
                    generator=generator)
                total = float(metrics["total"])  # host sync
                t1 = time.perf_counter()
                dt = t1 - t0
                iteration += 1
                losses.append(total)
                iter_s.append(t1 - t_prev)
                if iteration % args.log_interval == 0:
                    say(f"epoch {epoch} iter {iteration}: loss {total:.8f} "
                        f"grad_norm {float(metrics['grad_norm']):.3f} "
                        f"{dt:.4f}s/it", flush=True)
                    if logger:
                        logger.log_training(metrics, learning_rate, dt,
                                            iteration)
                if iteration % cfg.iters_per_checkpoint == 0:
                    val_loader = BucketedLoader(val_ds, **loader_kw)
                    val_loss, last = validate(state, val_loader, cfg, device,
                                              generator, mesh,
                                              shardings.params)
                    say(f"validation loss {val_loss:.8f}", flush=True)
                    full = PM.gather_train_state(state, mesh, shardings)
                    CK.save_checkpoint(full, args.output_directory,
                                       val_loss=val_loss,
                                       learning_rate=learning_rate,
                                       mesh=mesh)
                    if best.update(full, val_loss, learning_rate):
                        say(f"new best val loss {val_loss:.4f}", flush=True)
                    if logger and last is not None:
                        logger.log_validation(val_loss, full.params,
                                              last[0], last[1], iteration)
                if args.max_iters and iteration >= args.max_iters:
                    say("reached max iters", flush=True)
                    return result()
                t_prev = time.perf_counter()
        return result()
    finally:
        profiler.close()
        if logger:
            logger.close()


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("-o", "--output_directory", required=True)
    p.add_argument("-l", "--log_directory", default=None,
                   help="TensorBoard logs here (needs tensorboardX and "
                        "matplotlib)")
    p.add_argument("-c", "--checkpoint", default=None,
                   help="checkpoint to resume from (wins over the newest "
                        "in the output dir)")
    p.add_argument("--warm_start", action="store_true",
                   help="with -c: load params and BN statistics only, "
                        "keeping cfg.ignore_layers fresh")
    p.add_argument("--hparams", default=None,
                   help='reference-style "[k:v-k:v]" overrides')
    p.add_argument("--train-list", default=None)
    p.add_argument("--val-list", default=None)
    p.add_argument("--mel-dir", default=None)
    p.add_argument("--val-mel-dir", default=None)
    p.add_argument("--sub-dir", default=None)
    p.add_argument("--cls-dir", default=None)
    p.add_argument("--val-sub-dir", default=None,
                   help="subword-ID dir of the val list (default --sub-dir)")
    p.add_argument("--val-cls-dir", default=None)
    p.add_argument("--tokenizer_vocab", type=int, default=None,
                   help="subword vocab size (sets sub_n_symbols)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic utterances")
    p.add_argument("--multihost", action="store_true",
                   help="initialize torch.distributed from the torchrun "
                        "environment (one process per card)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="model-axis size (splits the embeddings' and the "
                        "decoder LSTMs' storage; data axis = ranks / this)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches loaded and copied ahead in a thread "
                        "(0: in the loop)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of steps 5-7 here")
    p.add_argument("--max-iters", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help='"cuda" (default) or "cpu"')
    return p


def main(argv=None):
    return train(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
