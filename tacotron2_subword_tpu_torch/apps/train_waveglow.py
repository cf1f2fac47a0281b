"""WaveGlow training CLI of the port (``tacotron2_subword_tpu/apps/
train_waveglow.py``, the reference's waveglow/train.py:62-152).

    python -m tacotron2_subword_tpu_torch.apps.train_waveglow -o outdir \
        --wav-dir data/wav [--config waveglow/config.json] [--synthetic N] \
        [--flows N] [--batch-size 4] [--iters N] [--iters-per-checkpoint N] \
        [--resume outdir/waveglow_N] [--device cpu]

Each iteration takes ``--batch-size`` random 16000-sample segments (the
reference's Mel2Samp, drawn from a numpy ``RandomState(0)`` in the JAX
package's order), computes their mels on the device
(``ops.stft.mel_spectrogram``), and takes one Adam step (optax's ``adam``:
b1 0.9, b2 0.999, eps 1e-8, the config's learning rate, 1e-4 by default)
on the flow NLL (``models.waveglow.loss``).  ``--config`` reads the
reference ``waveglow/config.json`` layout (``waveglow_config`` with its
``WN_config``, ``train_config``'s learning_rate and sigma).

Every ``--iters-per-checkpoint`` iterations it saves ``waveglow_{it}``, a
``weights_only`` torch file of the params, the Adam state, the iteration
and the segment sampler's random state; ``--resume`` restores all four,
so a resumed run draws the segments a straight run would.  One device
(CUDA unless ``--device cpu``); the JAX CLI trains at batch-size x its
devices.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tacotron2_subword_tpu_torch.models import waveglow as WG
from tacotron2_subword_tpu_torch.ops import stft as S
from tacotron2_subword_tpu_torch.train_lib import AdamState, Optimizer, adam
from tacotron2_subword_tpu_torch.utils.audio import load_wav
from tacotron2_subword_tpu_torch.utils.platform import resolve_device
from tacotron2_subword_tpu_torch.utils.tree import (to_device, tree_leaves,
                                                    tree_map)

SEGMENT = 16000  # reference waveglow/config.json data_config


class Mel2SampDataset:
    """Random fixed-length segments of the wavs at least one segment long
    (reference waveglow/mel2samp.py)."""

    def __init__(self, wav_paths: List[str], segment: int = SEGMENT,
                 seed: int = 0):
        self.wavs = []
        for p in wav_paths:
            wav = np.clip(load_wav(p)[0], -1, 1)
            if len(wav) >= segment:
                self.wavs.append(wav)
        self.segment = segment
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.wavs)

    def sample_batch(self, batch_size: int) -> np.ndarray:
        """[B, segment] f32: a wav, then an offset, per row."""
        out = np.empty((batch_size, self.segment), np.float32)
        for i in range(batch_size):
            wav = self.wavs[self.rng.randint(len(self.wavs))]
            start = self.rng.randint(0, len(wav) - self.segment + 1)
            out[i] = wav[start:start + self.segment]
        return out


class SyntheticWavs:
    """``n`` wavs of a sine (80-500 Hz) plus noise, two segments long."""

    def __init__(self, n: int = 8, segment: int = SEGMENT, seed: int = 0):
        self.segment = segment
        rng = np.random.RandomState(seed)
        t = np.arange(segment * 2) / 22050.0
        self.wavs = [
            (0.3 * np.sin(2 * np.pi * rng.uniform(80, 500) * t)
             + 0.05 * rng.randn(len(t))).astype(np.float32)
            for _ in range(n)]
        self.rng = rng

    __len__ = Mel2SampDataset.__len__
    sample_batch = Mel2SampDataset.sample_batch


def load_config(path: Optional[str], flows: int = 0):
    """(WaveGlowConfig, learning rate, sigma) from a reference
    waveglow/config.json (the published widths, lr 1e-4 and sigma 1.0
    without one); ``flows`` > 0 overrides n_flows."""
    cfg, lr, sigma = WG.WaveGlowConfig(), 1e-4, 1.0
    if path and os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
        wg = dict(raw.get("waveglow_config", {}))
        wn = wg.pop("WN_config", {})
        cfg = WG.WaveGlowConfig(
            n_mel_channels=wg.get("n_mel_channels", 80),
            n_flows=wg.get("n_flows", 12), n_group=wg.get("n_group", 8),
            n_early_every=wg.get("n_early_every", 4),
            n_early_size=wg.get("n_early_size", 2),
            wn_layers=wn.get("n_layers", 8),
            wn_channels=wn.get("n_channels", 256),
            wn_kernel_size=wn.get("kernel_size", 3))
        tc = raw.get("train_config", {})
        lr, sigma = tc.get("learning_rate", 1e-4), tc.get("sigma", 1.0)
    if flows:
        cfg = dataclasses.replace(cfg, n_flows=flows)
    return cfg, lr, sigma


def make_optimizer(lr: float) -> Optimizer:
    """``optax.adam(lr)`` over tensors."""
    return adam(0.9, 0.999, 1e-8, lambda count: lr)


def loss_and_grads(params, audio: torch.Tensor, cfg: WG.WaveGlowConfig,
                   sigma: float = 1.0):
    """The flow NLL of audio [B, T] given its own mel (the JAX CLI's
    ``loss_fn``) and its gradient: (loss as a 0-dim tensor, grads in the
    params' tree)."""
    mel = S.mel_spectrogram(audio, n_mel_channels=cfg.n_mel_channels)
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    nll = WG.loss(WG.forward(leaves, cfg, mel, audio), sigma=sigma)
    grads = iter(torch.autograd.grad(nll, tree_leaves(leaves)))
    return nll.detach(), tree_map(lambda _: next(grads), leaves)


def train_step(params, opt_state: AdamState, audio: torch.Tensor,
               cfg: WG.WaveGlowConfig, tx: Optimizer, sigma: float = 1.0):
    """One step on audio [B, T] (the JAX CLI's ``step_impl``):
    ``loss_and_grads``, then one Adam update.  Returns (new params, new
    Adam state, loss as a 0-dim tensor)."""
    nll, grads = loss_and_grads(params, audio, cfg, sigma)
    upd, opt_state = tx.update(grads, opt_state)
    return (tree_map(lambda p, u: (p + u).detach(), params, upd), opt_state,
            nll)


def _rng_state(rng: np.random.RandomState) -> Dict:
    name, keys, pos, has_gauss, gauss = rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": pos,
            "has_gauss": has_gauss, "gauss": gauss}


def _set_rng_state(rng: np.random.RandomState, st: Dict) -> None:
    rng.set_state(("MT19937", st["keys"].numpy().astype(np.uint32),
                   int(st["pos"]), int(st["has_gauss"]),
                   float(st["gauss"])))


def save_waveglow(path: str, params, opt_state: AdamState, it: int,
                  rng: np.random.RandomState) -> None:
    cpu = lambda t: t.detach().cpu()
    torch.save({"params": tree_map(cpu, params),
                "opt_state": tree_map(cpu, opt_state._asdict()),
                "iteration": it, "data_rng": _rng_state(rng)}, path)


def load_waveglow(path: str, device, template=None):
    """(params, Adam state, iteration, data rng state) of a
    ``waveglow_{it}`` file on ``device``.  With ``template`` (fresh params)
    the params' keys, list lengths, shapes and dtypes are checked against
    it: a file of another config raises ValueError."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    if template is not None:
        shape = lambda tree: tree_map(lambda t: (tuple(t.shape), t.dtype),
                                      tree)
        if shape(ck["params"]) != shape(template):
            raise ValueError(f"{path}: its params differ from this run's "
                             f"WaveGlow config")
    return (to_device(ck["params"], device),
            AdamState(**to_device(ck["opt_state"], device)),
            int(ck["iteration"]), ck["data_rng"])


def train(args) -> Dict:
    """The CLI's loop; returns {start_iteration, iterations, losses (one per
    iteration), s_per_it, wavs, checkpoints}."""
    device = resolve_device(args.device)
    cfg, lr, sigma = load_config(args.config, args.flows)
    os.makedirs(args.output_directory, exist_ok=True)
    if args.synthetic:
        ds = SyntheticWavs(args.synthetic)
    else:
        ds = Mel2SampDataset(sorted(glob.glob(
            os.path.join(args.wav_dir, "*.wav"))))
    print(f"waveglow training: {len(ds)} wavs on {device}")

    params = WG.init_waveglow(torch.Generator().manual_seed(args.seed), cfg,
                              device=device)
    tx = make_optimizer(lr)
    opt_state = tx.init(params)
    start = 0
    if args.resume:
        params, opt_state, start, rng = load_waveglow(args.resume, device,
                                                      template=params)
        _set_rng_state(ds.rng, rng)
        print(f"resumed at iter {start} from {args.resume}")

    losses, s_per_it, saved = [], [], []
    for it in range(start + 1, start + args.iters + 1):
        t0 = time.perf_counter()
        audio = torch.from_numpy(ds.sample_batch(args.batch_size)).to(device)
        params, opt_state, nll = train_step(params, opt_state, audio, cfg,
                                            tx, sigma)
        losses.append(nll.item())
        s_per_it.append(time.perf_counter() - t0)
        print(f"iter {it}: loss {losses[-1]:.4f} {s_per_it[-1]:.2f}s/it",
              flush=True)
        if it % args.iters_per_checkpoint == 0:
            path = os.path.join(args.output_directory, f"waveglow_{it}")
            save_waveglow(path, params, opt_state, it, ds.rng)
            saved.append(path)
            print(f"saved {path}")
    return {"start_iteration": start, "iterations": start + args.iters,
            "losses": losses, "s_per_it": s_per_it, "wavs": len(ds),
            "checkpoints": saved}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-o", "--output_directory", required=True)
    p.add_argument("--wav-dir", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--iters-per-checkpoint", type=int, default=200)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--flows", type=int, default=0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--resume", default=None,
                   help="waveglow_N file of a previous run (params, Adam "
                        "state, iteration, segment sampler)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run there)")
    return p


def main(argv=None) -> Dict:
    return train(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
