"""Primitive layers as functions over dicts of tensors.

Counterpart of ``tacotron2_subword_tpu/nn/layers.py``, with the same
parameter layouts, so one set of weights serves both packages:
 - Linear ``w`` is [in, out] (``y = x @ w + b``);
 - Conv1d is NCH activations with an OIH weight; ConvTranspose1d keeps
   torch's [in, out, k];
 - LSTM cells keep torch's ``w_ih`` [4H, in], ``w_hh`` [4H, H], ``b_ih``,
   ``b_hh`` with gate order (i, f, g, o); ``lstm_prepare`` fuses them into
   one [in+H, 4H] weight that the loops use;
 - BatchNorm keeps ``scale``/``bias`` as parameters and ``mean``/``var`` as
   separate state.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from tacotron2_subword_tpu_torch.ops import quant as Q

GAINS = {"linear": 1.0, "sigmoid": 1.0, "tanh": 5.0 / 3.0,
         "relu": math.sqrt(2.0)}


# -- Init (the reference's distributions; drawn on the CPU generator) -----------

def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    """U(-bound, bound) f32 on the CPU."""
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


def xavier_uniform(gen, shape, fan_in: int, fan_out: int,
                   gain: float = 1.0) -> torch.Tensor:
    return uniform(gen, shape, gain * math.sqrt(6.0 / (fan_in + fan_out)))


def linear_init(gen, in_dim: int, out_dim: int, bias: bool = True,
                gain: str = "linear"):
    """Xavier-uniform ``w`` [in, out]; bias U(+-1/sqrt(in))."""
    p = {"w": xavier_uniform(gen, (in_dim, out_dim), in_dim, out_dim,
                             GAINS[gain])}
    if bias:
        p["b"] = uniform(gen, (out_dim,), 1.0 / math.sqrt(in_dim))
    return p


def torch_linear_init_nobias(gen, in_dim: int, out_dim: int):
    """torch.nn.Linear's default weight, U(+-1/sqrt(in)), as ``w`` [in, out]."""
    return {"w": uniform(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim))}


def torch_linear_init(gen, in_dim: int, out_dim: int):
    """torch.nn.Linear's default weight and bias, both U(+-1/sqrt(in))."""
    p = torch_linear_init_nobias(gen, in_dim, out_dim)
    p["b"] = uniform(gen, (out_dim,), 1.0 / math.sqrt(in_dim))
    return p


def conv1d_init(gen, in_ch: int, out_ch: int, kernel_size: int,
                gain: str = "linear", bias: bool = True):
    """Xavier-uniform OIH ``w``; bias U(+-1/sqrt(fan_in))."""
    fan_in, fan_out = in_ch * kernel_size, out_ch * kernel_size
    p = {"w": xavier_uniform(gen, (out_ch, in_ch, kernel_size), fan_in,
                             fan_out, GAINS[gain])}
    if bias:
        p["b"] = uniform(gen, (out_ch,), 1.0 / math.sqrt(fan_in))
    return p


def weight_norm_init(gen, shape):
    """{v ~ N(0, 0.01), g = ||v||} with the norm over every dim but 0 (the
    HiFi-GAN init)."""
    v = torch.empty(shape).normal_(0.0, 0.01, generator=gen)
    g = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, len(shape))),
                             keepdim=True))
    return {"v": v, "g": g}


def batchnorm_init(num_features: int):
    return ({"scale": torch.ones(num_features),
             "bias": torch.zeros(num_features)},
            {"mean": torch.zeros(num_features),
             "var": torch.ones(num_features)})


def lstm_cell_init(gen, input_dim: int, hidden_dim: int):
    """torch LSTMCell layout and init: all U(+-1/sqrt(H))."""
    bound = 1.0 / math.sqrt(hidden_dim)
    return {"w_ih": uniform(gen, (4 * hidden_dim, input_dim), bound),
            "w_hh": uniform(gen, (4 * hidden_dim, hidden_dim), bound),
            "b_ih": uniform(gen, (4 * hidden_dim,), bound),
            "b_hh": uniform(gen, (4 * hidden_dim,), bound)}


def bilstm_init(gen, input_dim: int, hidden_dim: int):
    return {"fwd": lstm_cell_init(gen, input_dim, hidden_dim),
            "bwd": lstm_cell_init(gen, input_dim, hidden_dim)}


# -- Linear / Conv ------------------------------------------------------------

def linear_apply(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y.to(x.dtype)


def conv1d_apply(p, x: torch.Tensor, padding: Optional[int] = None,
                 dilation: int = 1, stride: int = 1,
                 groups: int = 1) -> torch.Tensor:
    """x [B, C_in, T] -> [B, C_out, T'] ("same" padding by default); ``w``
    is [C_out, C_in / groups, k]."""
    w = p["w"]
    if padding is None:
        padding = dilation * (w.shape[-1] - 1) // 2
    return F.conv1d(x, w, p.get("b"), stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def conv2d_apply(p, x: torch.Tensor, stride=(1, 1),
                 padding=(0, 0)) -> torch.Tensor:
    """x [B, C_in, H, W] -> [B, C_out, H', W'] (NCHW, OIHW ``w``)."""
    return F.conv2d(x, p["w"], p.get("b"), stride=stride, padding=padding)


def conv_transpose1d_apply(p, x: torch.Tensor, stride: int,
                           padding: int = 0) -> torch.Tensor:
    """x [B, C_in, T] -> [B, C_out, (T-1)*stride - 2*padding + k]; ``w`` is
    [in, out, k] as in torch."""
    return F.conv_transpose1d(x, p["w"], p.get("b"), stride=stride,
                              padding=padding)


# -- Weight norm --------------------------------------------------------------

def weight_norm_weight(p, dim: int = 0) -> torch.Tensor:
    """w = g * v / ||v||, the norm over every dim but ``dim`` (torch
    weight_norm); differentiable in ``v`` and ``g``."""
    v, g = p["v"], p["g"]
    axes = tuple(i for i in range(v.dim()) if i != dim)
    norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))
    return g * v / torch.clamp_min(norm, 1e-12)


def fuse_weight_norm(p):
    """Collapse {v, g} into a direct weight ``w`` (torch
    remove_weight_norm), the norm over every dim but 0."""
    out = {k: t for k, t in p.items() if k not in ("v", "g")}
    out["w"] = weight_norm_weight(p)
    return out


# -- BatchNorm1d / dropout / embedding ------------------------------------------

def batchnorm_apply(params, state, x: torch.Tensor, training: bool = False,
                    momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm1d over x [B, C, T].

    Eval mode returns y, normalised with the running statistics.  Training
    mode returns (y, new_state): y is normalised with the batch statistics
    over (B, T), taken in f32 and biased (padding included, as in the
    reference); the running variance takes Bessel's correction over the
    B*T values, with ``momentum``."""
    if not training:
        mean, var = state["mean"], state["var"]
    else:
        xf = x.to(torch.float32)
        mean = xf.mean(dim=(0, 2))
        var = xf.var(dim=(0, 2), unbiased=False)
        count = x.shape[0] * x.shape[2]
        unbiased = var * count / max(count - 1.0, 1.0)
        new_state = {
            "mean": (1 - momentum) * state["mean"] + momentum * mean,
            "var": (1 - momentum) * state["var"] + momentum * unbiased}
    inv = torch.rsqrt(var + eps) * params["scale"]
    y = ((x - mean[None, :, None]) * inv[None, :, None]
         + params["bias"][None, :, None]).to(x.dtype)
    return (y, new_state) if training else y


def keep_mask(shape, rate: float, generator: torch.Generator,
              device=None) -> torch.Tensor:
    """A boolean keep-mask: True with probability 1 - rate."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float,
            mask: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout: where(mask, x / (1 - rate), 0), in x's dtype, with
    the given boolean keep-mask or, without one, a mask drawn from
    ``generator`` (on x's device)."""
    if rate == 0.0:
        return x
    if mask is None:
        mask = keep_mask(x.shape, rate, generator, x.device)
    return torch.where(mask, x / (1.0 - rate), 0.0).to(x.dtype)


def embedding_apply(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """ids [...] int -> [..., dim] rows of ``table``."""
    return F.embedding(ids.long(), table)


# -- LSTM -----------------------------------------------------------------------

def lstm_prepare(p):
    """Fuse torch-layout LSTM params into {w: [in+H, 4H], b: [4H]}.  Call
    outside any loop: the concat and transpose copy the whole weight.

    ``w`` is kept in f32 whatever the params' dtype: the gate matmul then
    returns f32 gates from bf16 values, as JAX's ``preferred_element_type=
    float32`` does (a bf16 value is exact in f32, and with TF32 off the
    product is summed in f32).  ``b`` keeps the params' dtype."""
    w = torch.cat([p["w_ih"], p["w_hh"]], dim=1).t()
    return {"w": w.to(torch.float32).contiguous(),
            "b": p["b_ih"] + p["b_hh"]}


def _lstm_nonlin(gates: torch.Tensor, c: torch.Tensor, out_dtype):
    """(i, f, g, o) gate nonlinearity on f32 gates [..., 4H]."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c.to(torch.float32) + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(out_dtype), c_new.to(out_dtype)


def lstm_cell_prepared(pp, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                       tap: Optional[torch.Tensor] = None):
    """One LSTM step on prepared params.  Either one cell (x [B, in], w
    [in+H, 4H]) or a stack of S cells (x [S, B, in], w [S, in+H, 4H],
    b [S, 4H]).  The gates are f32 (see ``lstm_prepare``).

    ``tap`` optionally adds a (zero) [..., 4H] f32 term to the gates: the
    decoder's custom backward reads the per-step gate gradients from it."""
    xh = torch.cat([x, h], dim=-1).to(pp["w"].dtype)
    b = pp["b"]
    gates = xh @ pp["w"] + (b[:, None, :] if b.dim() == 2 else b)
    if tap is not None:
        gates = gates + tap
    return _lstm_nonlin(gates, c, x.dtype)


def lstm_quantize_stacked(pp):
    """Quantize stacked prepared params {w: [S, K, 4H], b: [S, 4H]} to int8
    with one scale per output channel.  Call outside the decode loop."""
    w_q, scale = Q.quantize_int8(pp["w"], axis=1)
    return {"w_q": w_q, "scale": scale, "b": pp["b"].to(torch.float32)}


def lstm_cell_quant_stacked(pq, x: torch.Tensor, h: torch.Tensor,
                            c: torch.Tensor):
    """Stacked int8 LSTM step: x/h/c [S, B, .]; the gate matmul is K1."""
    xh = torch.cat([x, h], dim=-1)
    gates = Q.matmul_dequant_int8(xh, pq["w_q"], pq["scale"])
    return _lstm_nonlin(gates + pq["b"][:, None, :], c, x.dtype)


def _reverse_padded(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row of x [B, T, D] within its valid length."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    L = lengths.to(x.device)[:, None]
    idx = torch.where(t < L, L - 1 - t, t)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def bilstm_apply(p, x: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bidirectional LSTM over x [B, T, D] -> [B, T, 2H], length-exact.

    The backward direction reads each row reversed within its valid length
    (in place of torch's pack_padded_sequence) and outputs past each length
    are zero.  Both directions run as one stacked cell per time step on the
    fused [in+H, 4H] weights of ``lstm_prepare``."""
    B, T, _ = x.shape
    fwd, bwd = lstm_prepare(p["fwd"]), lstm_prepare(p["bwd"])
    pp = {"w": torch.stack([fwd["w"], bwd["w"]]),
          "b": torch.stack([fwd["b"], bwd["b"]])}
    H = p["fwd"]["w_hh"].shape[1]
    xr = (_reverse_padded(x, lengths) if lengths is not None
          else x.flip(1))
    xs = torch.stack([x, xr])                       # [2, B, T, D]
    h = x.new_zeros((2, B, H))
    c = x.new_zeros((2, B, H))
    ys = []
    for t in range(T):
        h, c = lstm_cell_prepared(pp, xs[:, :, t], h, c)
        ys.append(h)
    ys = torch.stack(ys, dim=2)                     # [2, B, T, H]
    back = (_reverse_padded(ys[1], lengths) if lengths is not None
            else ys[1].flip(1))
    out = torch.cat([ys[0], back], dim=-1)
    if lengths is not None:
        valid = (torch.arange(T, device=x.device)[None, :]
                 < lengths.to(x.device)[:, None])
        out = out * valid[:, :, None].to(out.dtype)
    return out
