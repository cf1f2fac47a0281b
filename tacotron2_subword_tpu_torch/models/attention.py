"""Attention for the dual-stream decoder: the six variants of the JAX
package.

Counterpart of ``tacotron2_subword_tpu/models/attention.py``.  The decoder
runs both attention streams (phone and subword) as one stack, so the
per-step functions here take a leading stream axis S on every input and on
every parameter: query [S, B, Q], memory [S, B, T, D], processed memory
[S, B, T, A], mask [S, B, T], previous and cumulative weights
``weights_cat`` [S, B, 2, T], state leaves [S, B, ...], params leaves
[S, ...].  One stream is S=1.  Each stream's convolutions run as one
grouped convolution over the stack (groups=S, or S*B for DCA's per-sample
filters).

Variants (reference attention.py):
 - "LocationSensitiveAttention"    additive energies + location features
 - "ForwardAttentionV2"            LSA's energies through the forward
                                   recursion on log_alpha
 - "ContentAttention"              additive energies, no location
 - "DynamicConvolutionAttention"   static + per-sample dynamic filters over
                                   the previous weights, beta-binomial prior
 - "StepwiseMonotonicAttention"    the default
 - "GMMAttention"                  a mixture of K=5 Gaussians moving forward

Every variant works for both streams, as in the JAX package (the reference
builds the subword stream's attention for SMA only).  Each step computes in
the dtype it is handed (the decoder's compute dtype), with the JAX
package's type promotion: GMM's positions are an f32 ``arange``, so its
weights come out f32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

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
# the variants that read the previous and cumulative weights
READS_WEIGHTS = ("LocationSensitiveAttention", "ForwardAttentionV2")

# DCA constants (reference attention.py:202-208)
DCA_STATIC_CHANNELS = 8
DCA_STATIC_KERNEL = 21
DCA_DYNAMIC_CHANNELS = 8
DCA_DYNAMIC_KERNEL = 21
DCA_PRIOR_LENGTH = 11
DCA_ALPHA, DCA_BETA = 0.1, 0.9

GMM_K = 5
GMM_EPS = 1e-5


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown attention variant {variant!r}")


def dca_prior() -> torch.Tensor:
    """The beta-binomial pmf over 0..P-1 (n = P-1, alpha 0.1, beta 0.9),
    flipped, f32: pmf(k) = C(n, k) B(k + a, n - k + b) / B(a, b), in f64
    through lgamma."""
    n, a, b = DCA_PRIOR_LENGTH - 1, DCA_ALPHA, DCA_BETA
    lbeta = lambda x, y: math.lgamma(x) + math.lgamma(y) - math.lgamma(x + y)
    pmf = [math.exp(math.lgamma(n + 1) - math.lgamma(k + 1)
                    - math.lgamma(n - k + 1) + lbeta(k + a, n - k + b)
                    - lbeta(a, b)) for k in range(n + 1)]
    return torch.tensor(pmf[::-1], dtype=torch.float64).float()


def attention_init(gen: torch.Generator, variant: str, attention_rnn_dim: int,
                   embedding_dim: int, attention_dim: int,
                   location_n_filters: int, location_kernel_size: int):
    """Parameters of one stream (CPU generator), as the reference
    initialises them; the keys of the JAX package's tree."""
    _check_variant(variant)
    A = attention_dim
    p = {"memory": L.linear_init(gen, embedding_dim, A, bias=False,
                                 gain="tanh")}
    if variant in ("LocationSensitiveAttention", "ForwardAttentionV2",
                   "ContentAttention", "StepwiseMonotonicAttention"):
        p["query"] = L.linear_init(gen, attention_rnn_dim, A, bias=False,
                                   gain="tanh")
        p["v"] = (L.torch_linear_init_nobias(gen, A, 1)
                  if variant == "StepwiseMonotonicAttention"
                  else L.linear_init(gen, A, 1, bias=False))
        if variant in READS_WEIGHTS:
            p["loc_conv"] = L.conv1d_init(gen, 2, location_n_filters,
                                          location_kernel_size, bias=False)
            p["loc_dense"] = L.linear_init(gen, location_n_filters, A,
                                           bias=False, gain="tanh")
    elif variant == "DynamicConvolutionAttention":
        p["W"] = L.torch_linear_init(gen, attention_rnn_dim, A)
        p["V"] = L.torch_linear_init_nobias(
            gen, A, DCA_DYNAMIC_CHANNELS * DCA_DYNAMIC_KERNEL)
        p["F"] = {"w": L.uniform(gen, (DCA_STATIC_CHANNELS, 1,
                                       DCA_STATIC_KERNEL),
                                 1.0 / math.sqrt(DCA_STATIC_KERNEL))}
        p["U"] = L.torch_linear_init_nobias(gen, DCA_STATIC_CHANNELS, A)
        p["T"] = L.torch_linear_init(gen, DCA_DYNAMIC_CHANNELS, A)
        p["v"] = L.torch_linear_init_nobias(gen, A, 1)
        # a parameter leaf, trained as in the JAX package (the reference
        # keeps it as a fixed buffer)
        p["prior"] = dca_prior()
    else:  # GMMAttention
        p["mlp1"] = L.torch_linear_init(gen, attention_rnn_dim, A)
        p["mlp2"] = L.torch_linear_init(gen, A, 3 * GMM_K)
    return p


def process_memory(params, memory: torch.Tensor) -> torch.Tensor:
    """memory_layer of one stream: [B, T, embed] -> [B, T, attention_dim]."""
    return L.linear_apply(params["memory"], memory)


def init_state(variant: str, batch: int, max_time: int,
               device=None) -> Dict[str, torch.Tensor]:
    """Per-utterance attention state of one stream (f32)."""
    _check_variant(variant)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    if variant == "ForwardAttentionV2":
        la = torch.full((batch, max_time), -1e4, dtype=torch.float32,
                        device=device)
        la[:, 0] = 0.0
        return {"log_alpha": la}
    if variant in ("StepwiseMonotonicAttention",
                   "DynamicConvolutionAttention"):
        a = zeros(batch, max_time)
        a[:, 0] = 1.0
        return {"alignment" if variant == "StepwiseMonotonicAttention"
                else "alignment_pre": a}
    if variant == "GMMAttention":
        return {"mu_prev": zeros(batch, GMM_K)}
    return {}


def _lin(p, x: torch.Tensor) -> torch.Tensor:
    """Stacked linear: x [S, ..., in] @ w [S, in, out] (+ b [S, out])."""
    S, out = x.shape[0], p["w"].shape[-1]
    y = torch.bmm(x.reshape(S, -1, x.shape[-1]), p["w"])
    if "b" in p:
        y = y + p["b"][:, None, :]
    return y.reshape(*x.shape[:-1], out)


def _stream_conv(x: torch.Tensor, w: torch.Tensor,
                 padding) -> torch.Tensor:
    """Each stream's conv1d as one grouped conv (groups=S): x [S, B, C, T],
    w [S, O, C, k] -> [S, B, O, T']; ``padding`` as F.pad's (left, right)."""
    S, B, C, T = x.shape
    O = w.shape[1]
    y = F.conv1d(F.pad(x.transpose(0, 1).reshape(B, S * C, T), padding),
                 w.reshape(S * O, C, w.shape[-1]), groups=S)
    return y.reshape(B, S, O, -1).transpose(0, 1)


def _additive_energies(params, query: torch.Tensor,
                       processed_memory: torch.Tensor,
                       weights_cat: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """v . tanh(W q + processed_memory (+ location features)) per stream:
    [S, B, T].  The location features are a conv (2 -> F channels, no
    bias, "same" padding) over ``weights_cat`` and a dense layer."""
    pq = torch.einsum("sbq,sqa->sba", query, params["query"]["w"])
    e = pq[:, :, None, :] + processed_memory
    if weights_cat is not None:
        k = params["loc_conv"]["w"].shape[-1]
        conv = _stream_conv(weights_cat, params["loc_conv"]["w"],
                            ((k - 1) // 2, (k - 1) // 2))    # [S, B, F, T]
        e = e + _lin(params["loc_dense"], conv.transpose(2, 3))
    return torch.einsum("sbta,sa->sbt", torch.tanh(e),
                        params["v"]["w"][..., 0])


def _masked(energies: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return energies
    return energies.masked_fill(~mask, SCORE_MASK_VALUE)


def _context(weights: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """sum_t weights[s,b,t] * memory[s,b,t,:] in the promoted dtype of the
    two (a batched matmul, which accumulates in f32 for bf16 inputs), cast
    to memory's dtype."""
    dt = torch.promote_types(weights.dtype, memory.dtype)
    return torch.einsum("sbt,sbtd->sbd", weights.to(dt),
                        memory.to(dt)).to(memory.dtype)


def attention_step(variant: str, params, query, memory, processed_memory,
                   mask, state, noise: Optional[torch.Tensor] = None, *,
                   weights_cat: Optional[torch.Tensor] = None):
    """One step of every stream: returns (context [S, B, D], weights
    [S, B, T], new state).  ``mask`` is True at valid positions;
    ``weights_cat`` [S, B, 2, T] holds the previous and the cumulative
    weights (read by LSA and FAv2 only).

    SMA (He et al. 2019, eq. 8): p = sigmoid(energies);
    align_t = prev * p + shift_right(prev * (1 - p)).  In training the
    given ``noise`` [S, B, T] (N(0, 1) * SMA_SIGMOID_NOISE) is added to the
    masked energies before the sigmoid; no other variant reads it."""
    _check_variant(variant)
    if variant == "StepwiseMonotonicAttention":
        e = _masked(_additive_energies(params, query, processed_memory), mask)
        if noise is not None:
            e = e + noise.to(e.dtype)
        p_i = torch.sigmoid(e)
        prev = state["alignment"]
        moved = prev[..., :-1] * (1.0 - p_i[..., :-1])
        align = prev * p_i + F.pad(moved, (1, 0))
        return _context(align, memory), align, {**state, "alignment": align}

    if variant == "DynamicConvolutionAttention":
        return _dca_step(params, query, memory, mask, state)
    if variant == "GMMAttention":
        return _gmm_step(params, query, memory, mask, state)

    e = _masked(_additive_energies(
        params, query, processed_memory,
        None if variant == "ContentAttention" else weights_cat), mask)
    if variant == "ForwardAttentionV2":
        # the forward recursion; log_alpha is written back into the state
        # (the reference drops it: attention.py:151)
        log_alpha = state["log_alpha"]
        shifted = F.pad(log_alpha[..., :-1], (1, 0), value=SCORE_MASK_VALUE)
        e = torch.logaddexp(log_alpha, shifted) + e
        state = {**state, "log_alpha": e}
    w = torch.softmax(e, dim=-1)
    return _context(w, memory), w, state


def _dca_step(params, query, memory, mask, state):
    """Dynamic convolution attention (reference attention.py:236-289):
    energies v . tanh(U f + T g) + log prior, from the previous weights
    alone: f by the static filters, g by filters made from the query for
    each sample, the prior a causal conv of the previous weights."""
    S, B, T, _ = memory.shape
    prev = state["alignment_pre"]                                # [S, B, T]
    prior = params["prior"]                                      # [S, P]
    p = _stream_conv(prev[:, :, None, :], prior[:, None, None, :],
                     (DCA_PRIOR_LENGTH - 1, 0))[:, :, 0]
    p = torch.log(torch.clamp_min(p, 1e-6))

    # per-sample filters: one grouped conv, groups = S * B
    G = _lin(params["V"], torch.tanh(_lin(params["W"], query)))
    pad = (DCA_DYNAMIC_KERNEL - 1) // 2
    g = F.conv1d(prev.reshape(1, S * B, T),
                 G.reshape(S * B * DCA_DYNAMIC_CHANNELS, 1,
                           DCA_DYNAMIC_KERNEL), padding=pad, groups=S * B)
    g = g.reshape(S, B, DCA_DYNAMIC_CHANNELS, T).transpose(2, 3)
    pad = (DCA_STATIC_KERNEL - 1) // 2
    f = _stream_conv(prev[:, :, None, :], params["F"]["w"],
                     (pad, pad)).transpose(2, 3)                 # [S, B, T, C]

    e = torch.einsum("sbta,sa->sbt", torch.tanh(
        _lin(params["U"], f) + _lin(params["T"], g)),
        params["v"]["w"][..., 0]) + p
    w = torch.softmax(_masked(e, mask), dim=-1)
    return _context(w, memory), w, {**state, "alignment_pre": w}


def _gmm_step(params, query, memory, mask, state):
    """GMM-v2 attention (reference attention.py:427-472): K Gaussians whose
    means only move forward (mu += softplus(delta))."""
    T = memory.shape[2]
    interm = _lin(params["mlp2"], torch.tanh(_lin(params["mlp1"], query)))
    omega_hat = interm[..., :GMM_K]
    delta_hat = interm[..., GMM_K:2 * GMM_K]
    sigma_hat = interm[..., 2 * GMM_K:]

    sigma = F.softplus(sigma_hat) + GMM_EPS                      # [S, B, K]
    delta = F.softplus(delta_hat)
    omega = torch.softmax(omega_hat, dim=-1)
    Z = torch.sqrt(2 * math.pi * sigma ** 2)

    mu = state["mu_prev"] + delta
    j = torch.arange(T, dtype=torch.float32, device=memory.device)
    phi = (omega / Z)[..., None] * torch.exp(
        -((j - mu[..., None]) ** 2) / (sigma[..., None] ** 2) / 2)
    w = torch.softmax(_masked(phi.sum(dim=-2), mask), dim=-1)
    return _context(w, memory), w, {**state, "mu_prev": mu}
