"""HiFi-GAN training / GTA fine-tuning CLI of the port
(``tacotron2_subword_tpu/apps/train_hifigan.py``).

    python -m tacotron2_subword_tpu_torch.apps.train_hifigan -o outdir \
        --wav-dir data/wav [--mel-dir gta_mels] [--config config_v1.json] \
        [--batch-size 16] [--iters N] [--resume outdir/state_NNNNNNNN] \
        [--mel-only [--stft-loss-weight W]] [--synthetic N] [--device cpu]

The generator and the MPD/MSD discriminators train adversarially over
(mel, audio) segment pairs of 8192 samples (config_v1's segment_size): the
mels are the GTA mels of ``apps.gta`` when ``--mel-dir`` is given (the
clip's basename + .npy), else computed from the audio.  One step: the
discriminators on the generator's output, detached (LSGAN), then the
generator against the updated discriminators: adversarial + 2 x feature
matching + 45 x L1 between the log-mels (``ops.stft.mel_spectrogram``) of
its output and of the audio.  ``--mel-only`` updates the generator with
the 45 x mel L1 alone (discriminators frozen), plus ``--stft-loss-weight``
x the L1 of the 513-bin log |STFT|.  Adam (b1 0.8, b2 0.99) with the
reference's per-epoch decay (``--lr-decay``, 0.999 every len(clips) /
batch iterations) as optax's staircase schedule.

Every ``--iters-per-checkpoint`` iterations: ``g_NNNNNNNN``, the
reference's ``{'generator': state_dict}`` torch file (weight_v / weight_g
/ bias; the inference CLIs of both packages serve it), and
``state_NNNNNNNN``, a ``weights_only`` torch file of the generator, the
discriminators, both Adam states and the iteration, which ``--resume``
restores exactly.  ``loss_curve.csv`` takes a row every
``--log-interval`` iterations and is appended to on resume.  The device is
CUDA unless ``--device cpu`` is given.

Launched by ``python -m torch.distributed.run --nproc_per_node=N -m
tacotron2_subword_tpu_torch.apps.train_hifigan ...`` it trains on N ranks
(NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``) over the data
axis, as the JAX CLI trains over its devices: ``--batch-size`` is per rank,
every rank draws the global batch of batch-size x N segments from the same
seeded sampler and keeps its rows, each rank's loss is its share of the
global batch mean and the gradients are summed over the ranks, so N ranks
take the step one process takes on the global batch.  The per-epoch decay
counts global batches.  Rank 0 prints and writes the files; ``--resume``
is read by every rank.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from tacotron2_subword_tpu_torch.models import hifigan as HG
from tacotron2_subword_tpu_torch.ops import stft as S
from tacotron2_subword_tpu_torch.parallel import mesh as PM
from tacotron2_subword_tpu_torch.train_lib import (AdamState, Optimizer, adam,
                                                   global_metrics)
from tacotron2_subword_tpu_torch.utils.audio import load_wav
from tacotron2_subword_tpu_torch.utils.platform import resolve_device
from tacotron2_subword_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                                    to_device)

SEGMENT = 8192  # reference hifigan_infer/config_v1.json segment_size


class SegmentSampler:
    """(mel, audio) segment pairs; the mel from ``mel_dir`` (GTA) when
    given, otherwise computed from the audio.  Clips shorter than one
    segment + hop, and mels shorter than one segment's frames, are
    skipped.  Draws from ``RandomState(seed)`` in the JAX package's order,
    so one seed gives its batches."""

    def __init__(self, wav_paths: List[str], mel_dir: Optional[str],
                 hop: int = 256, segment: int = SEGMENT, seed: int = 0):
        self.entries = []
        n_short = 0
        for p in wav_paths:
            wav = np.clip(load_wav(p)[0], -1, 1)
            if len(wav) < segment + hop:
                continue
            mel = None
            if mel_dir:
                mp = os.path.join(
                    mel_dir, os.path.splitext(os.path.basename(p))[0] + ".npy")
                if os.path.exists(mp):
                    mel = np.load(mp)
                    if mel.shape[1] < segment // hop:
                        n_short += 1
                        continue
            self.entries.append((wav, mel))
        if n_short:
            print(f"SegmentSampler: skipped {n_short} clips whose mel is "
                  f"shorter than {segment // hop} frames")
        self.hop = hop
        self.segment = segment
        self.frames = segment // hop
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.entries)

    def sample_batch(self, batch_size: int):
        """(mel [B, n_mels, segment/hop] f32, audio [B, segment] f32),
        numpy."""
        audio = np.empty((batch_size, self.segment), np.float32)
        mels = []
        for i in range(batch_size):
            wav, mel = self.entries[self.rng.randint(len(self.entries))]
            if mel is not None:
                # the mel may run a frame past the audio (T//hop+1 framing):
                # the offset lets both windows fit
                max_f0 = min(mel.shape[1] - self.frames,
                             (len(wav) - self.segment) // self.hop)
                f0 = self.rng.randint(0, max_f0 + 1)
                mels.append(mel[:, f0:f0 + self.frames])
                audio[i] = wav[f0 * self.hop:f0 * self.hop + self.segment]
            else:
                s0 = self.rng.randint(0, len(wav) - self.segment + 1)
                audio[i] = wav[s0:s0 + self.segment]
                mels.append(None)
        if mels[0] is None:
            mel_batch = S.mel_spectrogram(torch.from_numpy(audio)).numpy()[
                :, :, :self.frames]
        else:
            mel_batch = np.stack(mels)
        return mel_batch, audio


class SyntheticSegments:
    """``n`` clips of a sine (80-500 Hz) plus noise, two segments long."""

    def __init__(self, n: int = 8, segment: int = SEGMENT, seed: int = 0):
        rng = np.random.RandomState(seed)
        t = np.arange(segment * 2) / 22050.0
        self.entries = [((0.3 * np.sin(2 * np.pi * rng.uniform(80, 500) * t)
                          + 0.02 * rng.randn(len(t))).astype(np.float32),
                         None) for _ in range(n)]
        self.hop, self.segment, self.frames = 256, segment, segment // 256
        self.rng = rng

    __len__ = SegmentSampler.__len__
    sample_batch = SegmentSampler.sample_batch


def make_optimizer(lr: float, lr_decay: float = 1.0,
                   decay_every: int = 1) -> Optimizer:
    """``optax.adam(schedule, b1=0.8, b2=0.99)`` over tensors: Adam with
    bias correction (eps 1e-8), then -lr_k where step k (counted before it
    is taken) has lr_k = lr * lr_decay ** floor(k / decay_every), the
    staircase of the reference's per-epoch ExponentialLR (config_v1's
    lr_decay 0.999); a constant lr when ``lr_decay`` >= 1."""
    decay_every = max(int(decay_every), 1)

    def step_size(count: torch.Tensor) -> torch.Tensor:
        lr32 = torch.tensor(lr, dtype=torch.float32, device=count.device)
        if lr_decay >= 1.0:
            return lr32
        p = torch.floor(count.to(torch.float32) / decay_every)
        decay = torch.tensor(lr_decay, dtype=torch.float32,
                             device=count.device)
        return torch.where(count <= 0, lr32, lr32 * torch.pow(decay, p))

    return adam(0.8, 0.99, 1e-8, step_size)


class GanState(NamedTuple):
    gen: dict
    disc: dict
    opt_g: AdamState
    opt_d: AdamState


def mel_l1(y_hat: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
    """Mean |log-mel(y_hat) - log-mel(audio)| over the shorter frame
    count (TacotronSTFT's log-mel, ``ops.stft.mel_spectrogram``)."""
    mel_hat = S.mel_spectrogram(y_hat[:, 0, :])
    mel_y = S.mel_spectrogram(audio)
    n = min(mel_hat.shape[-1], mel_y.shape[-1])
    return torch.mean(torch.abs(mel_hat[..., :n] - mel_y[..., :n]))


def stft_l1(y_hat: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
    """Mean |log |STFT(y_hat)| - log |STFT(audio)|| over 513 bins, the
    magnitudes clamped at 1e-5."""
    sm_hat = S.stft_magnitude(y_hat[:, 0, :], 1024, 256, 1024)
    sm_y = S.stft_magnitude(audio, 1024, 256, 1024)
    k = min(sm_hat.shape[-1], sm_y.shape[-1])
    return torch.mean(torch.abs(
        torch.log(torch.clamp_min(sm_hat[..., :k], 1e-5))
        - torch.log(torch.clamp_min(sm_y[..., :k], 1e-5))))


def _grads(loss: torch.Tensor, tree, mesh: PM.Mesh) -> dict:
    """The gradient of ``loss`` (this rank's share of the global loss)
    summed over the data axis."""
    leaves = tree_leaves(tree)
    it = iter(torch.autograd.grad(loss, leaves))
    return PM.sum_gradients(tree_map(lambda _: next(it), tree), None, mesh)


def _leaf(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def _apply(tree, updates):
    return tree_map(lambda p, u: (p + u).detach(), tree, updates)


def discriminator_update(disc, opt_d: AdamState, y: torch.Tensor,
                         y_hat: torch.Tensor, tx_d: Optimizer,
                         mesh: Optional[PM.Mesh] = None):
    """One Adam step of the discriminators on real y and generated y_hat
    [B, 1, T] (LSGAN); returns (new params, new Adam state, this rank's
    share of d_loss, ``mesh``'s data axis summing the gradients)."""
    mesh = mesh or PM.Mesh()
    leaves = _leaf(disc)
    rs, gs, _, _ = HG.discriminators_apply(leaves, y, y_hat)
    d_loss = HG.discriminator_loss(rs, gs) / mesh.n_data
    upd, opt_d = tx_d.update(_grads(d_loss, leaves, mesh), opt_d)
    return _apply(disc, upd), opt_d, d_loss.detach()


def gan_step(state: GanState, mel: torch.Tensor, audio: torch.Tensor,
             h: HG.HifiganConfig, tx_g: Optimizer, tx_d: Optimizer, *,
             mel_only: bool = False, stft_loss_weight: float = 0.0,
             mesh: Optional[PM.Mesh] = None, terms=(1.0, 1.0, 1.0)):
    """One training step on mel [B, n_mels, frames] and audio [B, samples]
    (the JAX CLI's ``step_impl``).  GAN: the discriminators take one Adam
    step on D(y) and D(G(mel)) detached, then the generator one on
    adversarial + feature + 45 x mel L1 against the updated
    discriminators, each term weighted by ``terms`` (1 each in training; a
    term weighted 0 leaves G's gradient); the generator's output is
    computed once for both.
    ``mel_only``: the generator alone on 45 x mel L1 (+ ``stft_loss_weight``
    x log-|STFT| L1), d_loss 0.  Returns (new state, {d_loss, g_loss,
    mel_l1}) with the losses as 0-dim tensors on the device.

    On a ``mesh`` (its data axis) mel and audio are this rank's rows of the
    global batch.  Every term is a plain mean over rows of one shape, so
    each rank's share of the global loss is its own mean / n_data; the
    gradients are summed over the data axis and the losses returned are
    the global ones."""
    mesh = mesh or PM.Mesh()
    share = lambda loss: loss / mesh.n_data
    gen = _leaf(state.gen)
    y_hat = HG.generator_apply(gen, h, mel)
    if mel_only:
        loss_mel = share(mel_l1(y_hat, audio))
        total = 45.0 * loss_mel
        if stft_loss_weight:
            total = total + stft_loss_weight * share(stft_l1(y_hat, audio))
        upd, opt_g = tx_g.update(_grads(total, gen, mesh), state.opt_g)
        return (state._replace(gen=_apply(state.gen, upd), opt_g=opt_g),
                global_metrics({"d_loss": torch.zeros((), device=mel.device),
                                "g_loss": total, "mel_l1": loss_mel}, mesh))
    y = audio[:, None, :]
    new_disc, opt_d, d_loss = discriminator_update(
        state.disc, state.opt_d, y, y_hat.detach(), tx_d, mesh)
    with torch.no_grad():
        _, fr = HG.discriminate(new_disc, y)
    gs, fg = HG.discriminate(new_disc, y_hat)
    loss_mel = share(mel_l1(y_hat, audio))
    w_adv, w_feat, w_mel = terms
    total = (share(w_adv * HG.generator_adv_loss(gs)
                   + w_feat * HG.feature_loss(fr, fg))
             + 45.0 * w_mel * loss_mel)
    upd, opt_g = tx_g.update(_grads(total, gen, mesh), state.opt_g)
    return (GanState(_apply(state.gen, upd), new_disc, opt_g, opt_d),
            global_metrics({"d_loss": d_loss, "g_loss": total,
                            "mel_l1": loss_mel}, mesh))


def _structure(tree):
    """Keys, list lengths, and each tensor's shape and dtype."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype))
    return type(tree).__name__


def _state_tree(state: GanState, it: int) -> dict:
    return {"gen": state.gen, "disc": state.disc,
            "opt_g": state.opt_g._asdict(), "opt_d": state.opt_d._asdict(),
            "it": it}


def save_gan_state(path: str, state: GanState, it: int) -> None:
    torch.save(tree_map(lambda t: t.detach().cpu()
                        if isinstance(t, torch.Tensor) else t,
                        _state_tree(state, it)), path)


def restore_gan_state(path: str, template: GanState, device):
    """(GanState, iteration) from a ``state_NNNNNNNN`` file, held against
    ``template`` (fresh params and optimizer states): a missing or extra
    key, another list length, shape or dtype raises ValueError instead of
    landing in the wrong slot."""
    st = torch.load(path, map_location="cpu", weights_only=True)
    want = _structure(_state_tree(template, 0))
    if _structure(st) != want:
        raise ValueError(f"{path}: its structure differs from this run's "
                         f"generator, discriminators and optimizers")
    dev = lambda t: to_device(t, device)
    return (GanState(dev(st["gen"]), dev(st["disc"]),
                     AdamState(**dev(st["opt_g"])),
                     AdamState(**dev(st["opt_d"]))), int(st["it"]))


def train(args) -> Dict:
    """The CLI's loop; returns {start_iteration, iterations, losses
    [(d, g, mel) per logged iteration], s_per_it [per log window, its mean
    wall s per iteration: batch sampling, the step and the previous
    window's checkpoint write], clips, decay_every}."""
    launched = PM.torchrun_env()
    device = (PM.init_from_env(args.device) if launched
              else resolve_device(args.device))
    try:
        return _train(args, device)
    finally:
        if launched:
            dist.destroy_process_group()


def _train(args, device) -> Dict:
    mesh = PM.make_mesh()
    PM.collective_barrier(mesh)
    say = print if mesh.is_main else (lambda *a, **k: None)
    h = (HG.HifiganConfig.from_json(args.config) if args.config
         else HG.HifiganConfig())
    os.makedirs(args.output_directory, exist_ok=True)
    if args.synthetic:
        ds = SyntheticSegments(args.synthetic)
    else:
        ds = SegmentSampler(sorted(glob.glob(
            os.path.join(args.wav_dir, "*.wav"))), args.mel_dir)
    say(f"hifigan training: {len(ds)} clips on {device}, {mesh.n_data} "
        f"data ranks")

    gen = torch.Generator().manual_seed(args.seed)
    params = HG.init_generator(gen, h, device=device)
    disc = HG.init_discriminators(gen, device=device)
    B = args.batch_size
    B_total = B * mesh.n_data
    # "epoch" for the per-epoch reference decay = one pass over the clips
    decay_every = args.decay_every or max(len(ds) // max(B_total, 1), 1)
    if args.lr_decay < 1.0:
        say(f"lr decay {args.lr_decay} every {decay_every} iters "
            f"(reference ExponentialLR per epoch)")
    tx_g = make_optimizer(args.lr, args.lr_decay, decay_every)
    tx_d = make_optimizer(args.lr, args.lr_decay, decay_every)
    state = GanState(params, disc, tx_g.init(params), tx_d.init(disc))
    start_it = 0
    if args.resume:
        state, start_it = restore_gan_state(args.resume, state, device)
        say(f"resumed GAN state at iter {start_it} from {args.resume}")

    rows = slice(mesh.data * B, (mesh.data + 1) * B)
    curve_path = os.path.join(args.output_directory, "loss_curve.csv")
    curve_new = not (args.resume and os.path.exists(curve_path))
    losses, s_per_it = [], []
    curve = (open(curve_path, "w" if curve_new else "a") if mesh.is_main
             else open(os.devnull, "w"))
    with curve:
        if curve_new:
            curve.write("iter,d_loss,g_loss,mel_l1,s_per_it\n")
        t_log = time.perf_counter()
        for it in range(start_it + 1, start_it + args.iters + 1):
            mel, audio = ds.sample_batch(B_total)
            state, m = gan_step(state,
                                torch.from_numpy(mel[rows]).to(device),
                                torch.from_numpy(audio[rows]).to(device), h,
                                tx_g, tx_d, mel_only=args.mel_only,
                                stft_loss_weight=args.stft_loss_weight,
                                mesh=mesh)
            # the losses come to the host, and the host waits for the
            # device, only every --log-interval iters: in between, the
            # next batch is sampled while the device runs the step
            if it % args.log_interval == 0:
                dl, gl, lm = (m[k].item() for k in ("d_loss", "g_loss",
                                                    "mel_l1"))
                s_it = (time.perf_counter() - t_log) / args.log_interval
                losses.append((dl, gl, lm))
                s_per_it.append(s_it)
                say(f"iter {it}: d {dl:.3f} g {gl:.3f} mel {lm:.3f} "
                    f"{s_it:.2f}s/it", flush=True)
                curve.write(f"{it},{dl:.4f},{gl:.4f},{lm:.4f},{s_it:.3f}\n")
                curve.flush()
                t_log = time.perf_counter()
            if it % args.iters_per_checkpoint == 0:
                if mesh.is_main:
                    out = args.output_directory
                    torch.save({"generator": HG.export_torch_generator(
                        state.gen)}, os.path.join(out, f"g_{it:08d}"))
                    save_gan_state(os.path.join(out, f"state_{it:08d}"),
                                   state, it)
                    print(f"saved g_{it:08d} + state_{it:08d}")
                PM.collective_barrier(mesh)
    return {"start_iteration": start_it, "iterations": start_it + args.iters,
            "losses": losses, "s_per_it": s_per_it, "clips": len(ds),
            "decay_every": decay_every}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-o", "--output_directory", required=True)
    p.add_argument("--wav-dir", default=None)
    p.add_argument("--mel-dir", default=None,
                   help="GTA mels from apps.gta (else mels from the wavs)")
    p.add_argument("--config", default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lr-decay", type=float, default=0.999,
                   help="per-epoch exponential lr decay (reference "
                        "config_v1.json lr_decay; 1.0 = constant lr)")
    p.add_argument("--decay-every", type=int, default=0,
                   help="iters per decay step (0 = one epoch = "
                        "len(clips) / batch)")
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--iters-per-checkpoint", type=int, default=200)
    p.add_argument("--log-interval", type=int, default=1,
                   help="bring the losses to the host every N iters")
    p.add_argument("--resume", default=None,
                   help="state_NNNNNNNN file of a previous run (restores "
                        "generator, discriminators, optimizers, iteration)")
    p.add_argument("--stft-loss-weight", type=float, default=0.0,
                   help="add w x log-|STFT| L1 (513 bins) to the --mel-only "
                        "objective")
    p.add_argument("--mel-only", action="store_true",
                   help="update the generator with the 45 x mel-L1 term "
                        "only, discriminators frozen")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run there)")
    return p


def main(argv=None) -> Dict:
    return train(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
