"""Checkpoints of the port: save, find the newest, load, warm start, and
keep the best.

Counterpart of ``tacotron2_subword_tpu/utils/checkpoint.py`` (reference
train.py:86-123, 182-186, 366-368), in the port's own
format: a ``checkpoint_{step}/`` directory under the output dir holding
``state.pt``, one ``torch.save`` file of {step, params, bn_state,
opt_state} (tensors, lists and dicts only, so it loads with
``weights_only=True``), and the same ``meta.json`` as the JAX layout
({iteration, val_loss, learning_rate}).

The JAX package writes Orbax directories, which cannot be read without
JAX; ``load_checkpoint`` says so.  To cross formats, move the arrays
through numpy (``utils/import_jax.py``).

Multi-rank training (``parallel.mesh``) keeps this one-file format: every
rank passes the full state (``gather_train_state``) and its mesh, rank
(0, 0) writes, and a barrier keeps any rank from reading a half-written
file; every rank loads the whole file, then takes its slices
(``shard_train_state``).  So a checkpoint of a 2x2 run loads on one card,
and the other way round.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from tacotron2_subword_tpu_torch.parallel import mesh as PM
from tacotron2_subword_tpu_torch.train_lib import AdamState, TrainState
from tacotron2_subword_tpu_torch.utils.platform import resolve_device
from tacotron2_subword_tpu_torch.utils.tree import to_device, tree_leaves

STATE_FILE = "state.pt"
META_FILE = "meta.json"


def checkpoint_path(output_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(output_dir), f"checkpoint_{step}")


def scan_checkpoint(output_dir: str,
                    prefix: str = "checkpoint_") -> Optional[str]:
    """Newest checkpoint dir by step number (reference train.py:182-186)."""
    pattern = os.path.join(os.path.abspath(output_dir), prefix + "*")
    candidates = []
    for p in glob.glob(pattern):
        m = re.match(rf".*{prefix}(\d+)$", p)
        if m and os.path.isdir(p):
            candidates.append((int(m.group(1)), p))
    if not candidates:
        return None
    return max(candidates)[1]


def save_checkpoint(state: TrainState, output_dir: str, *,
                    val_loss: float = float("inf"),
                    learning_rate: float = 0.0,
                    name: Optional[str] = None,
                    mesh: Optional[PM.Mesh] = None) -> str:
    """Write ``state`` (the full state; tensors copied to the CPU) to
    ``output_dir/checkpoint_{step}`` or ``output_dir/name``; returns the
    directory.  With a ``mesh`` every rank calls it: rank (0, 0) writes,
    then all pass a barrier."""
    step = int(state.step)
    path = (os.path.join(os.path.abspath(output_dir), name)
            if name else checkpoint_path(output_dir, step))
    if mesh is None or mesh.is_main:
        _write(state, path, val_loss, learning_rate)
    if mesh is not None:
        PM.collective_barrier(mesh)
    return path


def _write(state: TrainState, path: str, val_loss: float,
           learning_rate: float) -> None:
    step = int(state.step)
    os.makedirs(path, exist_ok=True)
    opt = state.opt_state
    tree = {"step": step, "params": state.params, "bn_state": state.bn_state,
            "opt_state": {"count": opt.count, "mu": opt.mu, "nu": opt.nu}}
    tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(to_device(tree, "cpu"), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump({"iteration": step, "val_loss": float(val_loss),
                   "learning_rate": float(learning_rate)}, f)


def load_checkpoint(path: str, device="cuda"
                    ) -> Tuple[TrainState, Dict[str, Any]]:
    """(TrainState on ``device``, meta) from a checkpoint directory of the
    port (reference train.py:100-113: optimizer and step included)."""
    device = resolve_device(device)
    state_file = os.path.join(path, STATE_FILE)
    if not os.path.isfile(state_file):
        raise FileNotFoundError(
            f"{path} holds no {STATE_FILE}: it is not a checkpoint of the "
            f"PyTorch port.  Orbax checkpoints of the JAX package cannot be "
            f"read without JAX; move their arrays to the port through numpy "
            f"(utils/import_jax.tacotron2_params_from_numpy) and save them "
            f"with save_checkpoint.")
    tree = torch.load(state_file, map_location=device, weights_only=True)
    opt = tree["opt_state"]
    state = TrainState(int(tree["step"]), tree["params"], tree["bn_state"],
                       AdamState(opt["count"], opt["mu"], opt["nu"]))
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(path, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


def warm_start(path: str, state: TrainState,
               ignore_layers: Sequence[str] = ("embedding",)) -> TrainState:
    """``state`` with the params and BN statistics of the checkpoint at
    ``path``, but the current values for each top-level param key in
    ``ignore_layers``; step and optimizer state stay ``state``'s
    (reference train.py:86-98)."""
    device = tree_leaves(state.params)[0].device
    loaded, _ = load_checkpoint(path, device)
    params = dict(loaded.params)
    for layer in ignore_layers:
        if layer in params:
            params[layer] = state.params[layer]
    return state._replace(params=params, bn_state=loaded.bn_state)


class BestTracker:
    """Keeps ``output_dir/checkpoint_best``: the lowest validation loss so
    far, read from its ``meta.json`` at start (reference
    train.py:366-368).  With a ``mesh`` every rank keeps one, with the
    same (global) losses, and rank (0, 0) writes."""

    def __init__(self, output_dir: str, mesh: Optional[PM.Mesh] = None):
        self.mesh = mesh
        self.output_dir = os.path.abspath(output_dir)
        self.best = float("inf")
        best_meta = os.path.join(self.output_dir, "checkpoint_best",
                                 META_FILE)
        if os.path.exists(best_meta):
            with open(best_meta) as f:
                self.best = json.load(f).get("val_loss", float("inf"))

    def update(self, state: TrainState, val_loss: float,
               learning_rate: float) -> bool:
        """Save ``state`` as checkpoint_best when ``val_loss`` is below the
        best so far; True when it saved."""
        if val_loss < self.best:
            self.best = val_loss
            save_checkpoint(state, self.output_dir, val_loss=val_loss,
                            learning_rate=learning_rate,
                            name="checkpoint_best", mesh=self.mesh)
            return True
        return False
