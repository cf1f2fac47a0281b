"""Attention for the dual-stream decoder: Stepwise Monotonic Attention.

Counterpart of ``tacotron2_subword_tpu/models/attention.py``.  The decoder
runs both attention streams (phone and subword) as one stack, so the
per-step functions here take a leading stream axis S on every input and on
every parameter: query [S, B, Q], memory [S, B, T, D], processed memory
[S, B, T, A], mask [S, B, T], params leaves [S, ...].  One stream is S=1.

Only the default variant, StepwiseMonotonicAttention (SMA, the reference's
default and the one wired into its dual-stream decoder), is ported so far;
the other five variants raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from tacotron2_subword_tpu_torch.nn import layers as L

SCORE_MASK_VALUE = -1e9  # finite stand-in for -inf
SMA_SIGMOID_NOISE = 2.0  # std of the training noise on SMA's energies

VARIANTS = (
    "LocationSensitiveAttention",
    "ForwardAttentionV2",
    "ContentAttention",
    "DynamicConvolutionAttention",
    "StepwiseMonotonicAttention",
    "GMMAttention",
)


def _check_variant(variant: str) -> None:
    if variant == "StepwiseMonotonicAttention":
        return
    if variant in VARIANTS:
        raise NotImplementedError(
            f"attention {variant!r} is not ported yet; only "
            f"StepwiseMonotonicAttention is")
    raise ValueError(f"unknown attention variant {variant!r}")


def attention_init(gen: torch.Generator, variant: str, attention_rnn_dim: int,
                   embedding_dim: int, attention_dim: int):
    """Parameters of one stream (CPU generator), as the reference
    initialises them."""
    _check_variant(variant)
    return {
        "memory": L.linear_init(gen, embedding_dim, attention_dim,
                                bias=False, gain="tanh"),
        "query": L.linear_init(gen, attention_rnn_dim, attention_dim,
                               bias=False, gain="tanh"),
        "v": L.torch_linear_init_nobias(gen, attention_dim, 1),
    }


def process_memory(params, memory: torch.Tensor) -> torch.Tensor:
    """memory_layer of one stream: [B, T, embed] -> [B, T, attention_dim]."""
    return L.linear_apply(params["memory"], memory)


def init_state(variant: str, batch: int, max_time: int,
               device=None) -> Dict[str, torch.Tensor]:
    """Per-utterance attention state of one stream (f32)."""
    _check_variant(variant)
    a = torch.zeros((batch, max_time), dtype=torch.float32, device=device)
    a[:, 0] = 1.0
    return {"alignment": a}


def _additive_energies(params, query: torch.Tensor,
                       processed_memory: torch.Tensor) -> torch.Tensor:
    """v . tanh(W q + processed_memory) per stream: [S, B, T]."""
    pq = torch.einsum("sbq,sqa->sba", query, params["query"]["w"])
    e = torch.tanh(pq[:, :, None, :] + processed_memory)
    return torch.einsum("sbta,sa->sbt", e, params["v"]["w"][..., 0])


def _masked(energies: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return energies
    return energies.masked_fill(~mask, SCORE_MASK_VALUE)


def _context(weights: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """sum_t weights[s,b,t] * memory[s,b,t,:] in memory's dtype (a batched
    matmul, which accumulates in f32 for bf16 inputs)."""
    return torch.einsum("sbt,sbtd->sbd", weights.to(memory.dtype), memory)


def attention_step(variant: str, params, query, memory, processed_memory,
                   mask, state, noise: Optional[torch.Tensor] = None):
    """One step of every stream: returns (context [S, B, D], weights
    [S, B, T], new state).  ``mask`` is True at valid positions.

    SMA (He et al. 2019, eq. 8): p = sigmoid(energies);
    align_t = prev * p + shift_right(prev * (1 - p)).  In training the
    given ``noise`` [S, B, T] (N(0, 1) * SMA_SIGMOID_NOISE) is added to the
    masked energies before the sigmoid."""
    _check_variant(variant)
    e = _masked(_additive_energies(params, query, processed_memory), mask)
    if noise is not None:
        e = e + noise.to(e.dtype)
    p_i = torch.sigmoid(e)
    prev = state["alignment"]
    moved = prev[..., :-1] * (1.0 - p_i[..., :-1])
    align = prev * p_i + torch.nn.functional.pad(moved, (1, 0))
    return _context(align, memory), align, {**state, "alignment": align}
