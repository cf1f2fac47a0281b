"""Losses, the optimizer and the training step of the port.

Counterpart of ``tacotron2_subword_tpu/train_lib.py``: MSE on the mel and
postnet mel, BCE-with-logits on the gate, an optional soft-DTW term on the
postnet mel (K2 in the train step, K3 in the eval step; ``ops/softdtw.py``),
an optional 1 - SSIM term on the postnet mel (``ops/ssim.py``) and an
optional L2/KL alignment term.  The optimizer is the JAX package's
optax chain written out over tensors: L2 decay added to the gradient,
global-norm clipping, Adam with bias correction, then the step -lr.  A
non-finite gradient norm skips the update of params and optimizer state
(the step count still moves), with no host sync.

On a ``parallel.mesh.Mesh`` of N data ranks each rank holds its rows of
the global batch and computes its share of the global loss: every mean
divides by the global element count, every ``weight`` sum is summed over
the data group, and the BN statistics and the randomness are the global
batch's.  The gradients are summed over the data axis, so N ranks compute
what one process computes on the global batch (the JAX package's jitted
step over a sharded batch), and the metrics returned are the global
values.  With a model axis the planned leaves' params and Adam moments are
stored as slices and gathered for the step (``parallel.mesh``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from tacotron2_subword_tpu_torch.config import TacotronConfig
from tacotron2_subword_tpu_torch.models import tacotron2 as M
from tacotron2_subword_tpu_torch.ops import softdtw as SD
from tacotron2_subword_tpu_torch.ops.ssim import ssim
from tacotron2_subword_tpu_torch.parallel import mesh as PM
from tacotron2_subword_tpu_torch.utils.tree import tree_leaves, tree_map


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor):
    """Numerically stable BCE-with-logits, elementwise."""
    return (torch.clamp_min(logits, 0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _masked_kl(align_out, align_target, text_lengths, mel_lengths):
    """Per-sample KL(target || out) over the valid frames and positions,
    averaged over frames, summed over the batch."""
    eps = 1e-6
    out = torch.clamp_min(align_out, eps)
    tar = torch.clamp_min(align_target, eps)
    T_mel, T_text = align_out.shape[1], align_out.shape[2]
    frame_valid = M.sequence_mask(mel_lengths - 1, T_mel).float()
    pos_valid = M.sequence_mask(text_lengths - 1, T_text).float()
    kl = align_target * (torch.log(tar) - torch.log(out)) * pos_valid[:, None]
    per_frame = kl.sum(dim=2)
    per_sample = ((per_frame * frame_valid).sum(dim=1)
                  / torch.clamp_min(frame_valid.sum(dim=1), 1.0))
    return per_sample.sum()


def _n_data(mesh: Optional[PM.Mesh]) -> int:
    return 1 if mesh is None else mesh.n_data


def _mean(x: torch.Tensor, mesh: Optional[PM.Mesh]) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch
    (``mesh``'s data axis; every rank holds as many rows)."""
    return x.mean() / _n_data(mesh)


def _weight_sum(w: torch.Tensor, mesh: Optional[PM.Mesh]) -> torch.Tensor:
    """The global batch's ``weight`` sum, at least 1."""
    s = w.sum() if mesh is None else mesh.data_sum(w.sum())
    return torch.clamp_min(s, 1.0)


def softdtw_mel_loss(mel_out: torch.Tensor, mel_target: torch.Tensor,
                     cfg: TacotronConfig,
                     w: Optional[torch.Tensor] = None,
                     mesh: Optional[PM.Mesh] = None) -> torch.Tensor:
    """Soft-DTW between predicted and target mels [B, n_mels, T] over the
    frames' squared distances, normalised by (N + M) * n_mels; the
    (weighted) mean over the (global) batch.

    ``cfg.softdtw_impl``: "auto" and "pallas" take the kernels (K2 where a
    gradient is needed, K3 where not), "scan" the plain implementation."""
    x = mel_out.transpose(1, 2).float()
    y = mel_target.transpose(1, 2).float()
    N, Mf = x.shape[1], y.shape[1]
    D = SD.euclidean_dist_matrix(x, y)
    if cfg.softdtw_impl in ("auto", "pallas"):
        vals = SD.softdtw_diff(D, cfg.softdtw_gamma, cfg.softdtw_bandwidth)
    elif cfg.softdtw_impl == "scan":
        vals = SD.softdtw(D, cfg.softdtw_gamma, cfg.softdtw_bandwidth)
    else:
        raise ValueError(f"unknown softdtw_impl {cfg.softdtw_impl!r}")
    per = vals / float((N + Mf) * mel_out.shape[1])
    if w is None:
        return _mean(per, mesh)
    return (per * w).sum() / _weight_sum(w, mesh)


def ssim_mel_loss(mel_out: torch.Tensor, mel_target: torch.Tensor,
                  w: Optional[torch.Tensor] = None,
                  mesh: Optional[PM.Mesh] = None) -> torch.Tensor:
    """1 - SSIM of the mel images [B, n_mels, T], in f32: the reference's
    commented-out ``-ssim(mel_out, mel_target)`` term (loss_function.py:10,
    24) shifted by 1 to be non-negative; the (weighted) mean over the
    (global) batch."""
    s = ssim(mel_out[:, None].float(), mel_target[:, None].float(),
             size_average=w is None)
    if w is None:
        return (1.0 - s) / _n_data(mesh)
    return ((1.0 - s) * w).sum() / _weight_sum(w, mesh)


def tacotron2_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, Any],
                   cfg: TacotronConfig, iteration,
                   mesh: Optional[PM.Mesh] = None
                   ) -> Dict[str, torch.Tensor]:
    """dict(total, mel, gate, align, align_bert[, softdtw][, ssim]).  An
    optional ``batch["weight"]`` [B] leaves out the duplicates that fill a
    partial batch; all ones gives the plain means.  With a ``mesh``, this
    rank's share of each global loss (see the module docstring)."""
    mel_target = batch["mels"]
    gate_target = batch["gate_target"]
    w = batch.get("weight")
    if w is None:
        mel_loss = (_mean((outputs["mel"] - mel_target) ** 2, mesh)
                    + _mean((outputs["mel_postnet"] - mel_target) ** 2,
                            mesh))
        gate_loss = _mean(bce_with_logits(outputs["gate"], gate_target),
                          mesh)
    else:
        wsum = _weight_sum(w, mesh)

        def wmean(x):  # per-sample mean over non-batch dims, then weighted
            return (x.reshape(x.shape[0], -1).mean(dim=1) * w).sum() / wsum

        mel_loss = (wmean((outputs["mel"] - mel_target) ** 2)
                    + wmean((outputs["mel_postnet"] - mel_target) ** 2))
        gate_loss = wmean(bce_with_logits(outputs["gate"], gate_target))
    zero = torch.zeros((), device=mel_target.device)
    losses = {"mel": mel_loss, "gate": gate_loss, "align": zero,
              "align_bert": zero}
    total = mel_loss + gate_loss
    if cfg.softdtw_loss_weight > 0.0:
        sdtw = softdtw_mel_loss(outputs["mel_postnet"], mel_target, cfg, w,
                                mesh)
        losses["softdtw"] = sdtw
        total = total + cfg.softdtw_loss_weight * sdtw
    if cfg.ssim_loss_weight > 0.0:
        sl = ssim_mel_loss(outputs["mel_postnet"], mel_target, w, mesh)
        losses["ssim"] = sl
        total = total + cfg.ssim_loss_weight * sl
    if cfg.align_loss and "align_target" in batch:
        if cfg.n_frames_per_step != 1:
            raise ValueError("align_loss requires n_frames_per_step=1")
        target = batch["align_target"]
        # the target lives on the phone axis; the subword term only where
        # the axes agree (as the JAX package does)
        bert_ok = outputs["alignments_bert"].shape == target.shape
        if cfg.align_loss == "L2":
            a = _mean((outputs["alignments"] - target) ** 2, mesh)
            ab = (_mean((outputs["alignments_bert"] - target) ** 2, mesh)
                  if bert_ok else zero)
        elif cfg.align_loss == "KL":  # a sum over the batch: a share as is
            a = _masked_kl(outputs["alignments"], target,
                           batch["text_lengths"], batch["output_lengths"])
            ab = (_masked_kl(outputs["alignments_bert"], target,
                             batch["sub_lengths"], batch["output_lengths"])
                  if bert_ok else zero)
        else:
            raise ValueError(f"unknown align_loss {cfg.align_loss!r}")
        active = torch.as_tensor(iteration, device=a.device) \
            < cfg.align_loss_max_iters
        a = torch.where(active, a, 0.0)
        ab = torch.where(active, ab, 0.0)
        losses["align"], losses["align_bert"] = a, ab
        total = total + a + ab
    losses["total"] = total
    return losses


# ---------------------------------------------------------------------------
# Optimizer / train state
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar: updates applied
    mu: Any              # first moments, the params' tree
    nu: Any              # second moments


class Optimizer(NamedTuple):
    init: Any    # params -> AdamState
    update: Any  # (grads, state, params) -> (updates, new state)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tree_leaves(tree)))


def adam(b1: float, b2: float, eps: float,
         lr_at: Callable[[torch.Tensor], Any]) -> Optimizer:
    """Adam with bias correction over tensors (optax's ``scale_by_adam``
    then the step): the update is -lr_at(count) * m_hat / (sqrt(v_hat) +
    eps), ``count`` being the updates taken before this one.  ``lr_at``
    returns a float or a 0-dim tensor."""
    def init(params):
        z = lambda p: torch.zeros_like(p)
        dev = tree_leaves(params)[0].device
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         tree_map(z, params), tree_map(z, params))

    def update(grads, state: AdamState, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state.nu)
        count = state.count + 1
        n = count.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, device=n.device) ** n
        bc2 = 1 - torch.tensor(b2, device=n.device) ** n
        neg_lr = -lr_at(state.count)
        upd = tree_map(lambda m, v: neg_lr * ((m / bc1)
                                              / (torch.sqrt(v / bc2) + eps)),
                       mu, nu)
        return upd, AdamState(count, mu, nu)

    return Optimizer(init, update)


def make_optimizer(cfg: TacotronConfig, learning_rate=None) -> Optimizer:
    """The JAX package's chain, in its order: g + weight_decay * p; clip
    to global norm ``grad_clip_thresh``; Adam (b1 0.9, b2 0.999, eps 1e-8,
    bias-corrected); times -lr."""
    lr = cfg.learning_rate if learning_rate is None else learning_rate
    wd, max_norm = cfg.weight_decay, cfg.grad_clip_thresh
    core = adam(0.9, 0.999, 1e-8, lambda count: lr)

    def update(grads, state: AdamState, params, norm=global_norm):
        """``norm`` takes the tree of g + wd * p (a rank's slices on a
        model axis: ``parallel.mesh.sharded_norm``)."""
        g = tree_map(lambda g, p: g + wd * p, grads, params)
        g_norm = norm(g)
        trigger = g_norm < max_norm
        g = tree_map(lambda t: torch.where(trigger, t, (t / g_norm) * max_norm),
                     g)
        return core.update(g, state)

    return Optimizer(core.init, update)


class TrainState(NamedTuple):
    step: int
    params: Any
    bn_state: Any
    opt_state: AdamState


def create_train_state(generator: torch.Generator, cfg: TacotronConfig,
                       optimizer: Optional[Optimizer] = None, device="cuda"):
    """(TrainState with fresh params, optimizer).  ``generator`` is a CPU
    generator (see ``init_tacotron2``)."""
    params, bn = M.init_tacotron2(generator, cfg, device=device)
    tx = optimizer or make_optimizer(cfg)
    return TrainState(0, params, bn, tx.init(params)), tx


def global_metrics(losses: Dict[str, torch.Tensor],
                   mesh: Optional[PM.Mesh]) -> Dict[str, torch.Tensor]:
    """The global losses from each rank's shares: one sum over the data
    group, detached."""
    keys = list(losses)
    v = torch.stack([losses[k].detach().float() for k in keys])
    if mesh is not None:
        v = mesh.data_sum(v)
    return dict(zip(keys, v.unbind()))


def loss_and_grads(state: TrainState, batch, cfg: TacotronConfig, *,
                   mesh: Optional[PM.Mesh] = None, plan=None,
                   generator: Optional[torch.Generator] = None,
                   randomness: Optional[Dict] = None):
    """Forward, loss and backward of one step: (the global losses, the full
    gradients summed over the data axis (the same on every rank), the new
    BN state).  ``plan``
    (``parallel.mesh.tacotron_param_sharding``) names the leaves stored as
    slices; None: all replicated."""
    mesh = mesh or PM.Mesh()
    full = PM.gather(state.params, plan, mesh)
    params = tree_map(lambda p: p.detach().requires_grad_(True), full)
    outputs, new_bn = M.forward(params, state.bn_state, cfg, batch,
                                training=True, generator=generator,
                                randomness=randomness, mesh=mesh)
    losses = tacotron2_loss(outputs, batch, cfg, state.step, mesh)
    p_leaves = tree_leaves(params)
    g_leaves = torch.autograd.grad(losses["total"], p_leaves,
                                   allow_unused=True)
    # contiguous, as sum_gradients' buffer is: the norm's rounding then
    # does not depend on the mesh
    g_leaves = [torch.zeros_like(p) if g is None else g.contiguous()
                for g, p in zip(g_leaves, p_leaves)]
    it = iter(g_leaves)
    grads = PM.sum_gradients(tree_map(lambda _: next(it), full), plan, mesh)
    new_bn = tree_map(lambda t: t.detach(), new_bn)
    return global_metrics(losses, mesh), grads, new_bn


def train_step(state: TrainState, batch, cfg: TacotronConfig, tx: Optimizer,
               *, mesh: Optional[PM.Mesh] = None, plan=None,
               generator: Optional[torch.Generator] = None,
               randomness: Optional[Dict] = None):
    """One optimization step: forward, loss, backward, update.  The
    randomness is drawn from ``generator`` unless given (see
    ``M.make_randomness``).  ``mesh`` and ``plan``: see
    ``loss_and_grads``.  Returns (new state, metrics): the losses,
    ``grad_norm`` (of the raw gradients) and ``skipped`` (1.0 when a
    non-finite norm skipped the update), all tensors on the device."""
    mesh = mesh or PM.Mesh()
    metrics, grads, new_bn = loss_and_grads(
        state, batch, cfg, mesh=mesh, plan=plan, generator=generator,
        randomness=randomness)
    with torch.no_grad():
        grad_norm = global_norm(grads)
        finite = torch.isfinite(grad_norm)
        updates, new_opt = tx.update(
            PM.shard(grads, plan, mesh), state.opt_state, state.params,
            norm=lambda t: PM.sharded_norm(t, plan, mesh))
        keep = lambda new, old: torch.where(finite, new, old)
        new_params = tree_map(lambda p, u: keep(p + u, p), state.params,
                              updates)
        new_opt = AdamState(keep(new_opt.count, state.opt_state.count),
                            tree_map(keep, new_opt.mu, state.opt_state.mu),
                            tree_map(keep, new_opt.nu, state.opt_state.nu))
        metrics["grad_norm"] = grad_norm
        metrics["skipped"] = (~finite).to(torch.float32)
    return TrainState(state.step + 1, new_params, new_bn, new_opt), metrics


@torch.no_grad()
def eval_step(state: TrainState, batch, cfg: TacotronConfig, *,
              mesh: Optional[PM.Mesh] = None, plan=None,
              generator: Optional[torch.Generator] = None,
              randomness: Optional[Dict] = None):
    """Forward (BN running statistics, no dropout but the prenet's) and the
    losses, with no autograd: the soft-DTW term takes K3.  Returns (the
    global losses, this rank's outputs)."""
    mesh = mesh or PM.Mesh()
    outputs, _ = M.forward(PM.gather(state.params, plan, mesh),
                           state.bn_state, cfg, batch, training=False,
                           generator=generator, randomness=randomness,
                           mesh=mesh)
    losses = tacotron2_loss(outputs, batch, cfg, state.step, mesh)
    return global_metrics(losses, mesh), outputs


def make_gate_target(output_lengths: torch.Tensor, max_len: int):
    """0 until the last valid frame, 1 from it on."""
    t = torch.arange(max_len, device=output_lengths.device)[None, :]
    return (t >= (output_lengths[:, None] - 1)).to(torch.float32)
