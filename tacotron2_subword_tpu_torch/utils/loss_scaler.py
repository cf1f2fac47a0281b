"""Dynamic loss scaling (reference loss_scaler.py:3-80).

Counterpart of ``tacotron2_subword_tpu/utils/loss_scaler.py``.  The port
trains in bfloat16 with float32 master params, which has float32's
exponent range, so no training path uses this; it is kept for float16
experiments, with the reference's DynamicLossScaler semantics: the scale
starts at 2**32, halves on an overflow (an inf or nan gradient, whose step
the caller skips) and doubles after ``scale_window`` clean steps.  The state
lives on the device and the update makes no host sync: ``overflow`` is a
bool tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tacotron2_subword_tpu_torch.utils.platform import resolve_device
from tacotron2_subword_tpu_torch.utils.tree import tree_leaves, tree_map


class LossScalerState(NamedTuple):
    scale: torch.Tensor         # current loss scale, f32 scalar
    good_steps: torch.Tensor    # consecutive overflow-free steps, int32


def init_loss_scaler(init_scale: float = 2.0 ** 32,
                     device=None) -> LossScalerState:
    """The state on ``device`` (CUDA when None)."""
    device = resolve_device(device)
    return LossScalerState(
        torch.tensor(init_scale, dtype=torch.float32, device=device),
        torch.tensor(0, dtype=torch.int32, device=device))


def scale_loss(state: LossScalerState, loss: torch.Tensor) -> torch.Tensor:
    return loss * state.scale


def unscale_and_update(state: LossScalerState, grads,
                       scale_factor: float = 2.0,
                       scale_window: int = 1000
                       ) -> Tuple[object, LossScalerState, torch.Tensor]:
    """Unscale grads (a half-precision leaf is promoted to f32, as JAX
    promotes it); on overflow (inf/nan) halve the scale and signal the step
    should be skipped.  Returns (grads, new_state, overflow)."""
    scale = state.scale
    grads = tree_map(
        lambda g: g.to(torch.promote_types(g.dtype, scale.dtype)) / scale,
        grads)
    finite = torch.ones((), dtype=torch.bool, device=scale.device)
    for g in tree_leaves(grads):
        finite = finite & torch.isfinite(g).all()
    overflow = ~finite

    new_scale = torch.where(overflow, scale / scale_factor, scale)
    new_good = torch.where(overflow, 0, state.good_steps + 1)
    grow = new_good >= scale_window
    new_scale = torch.where(grow, new_scale * scale_factor, new_scale)
    new_good = torch.where(grow, 0, new_good)
    return grads, LossScalerState(new_scale, new_good), overflow
