"""HiFi-GAN generator (inference) in PyTorch.

Counterpart of the generator half of
``tacotron2_subword_tpu/models/hifigan.py``: conv_pre (80 -> C, k7), then per
upsampling stage leaky_relu -> ConvTranspose1d -> the average of the
multi-receptive-field resblocks, then leaky_relu -> conv_post -> tanh.
Parameters carry weight-norm {v, g, b} as trained; ``fuse_generator``
collapses them for serving.  ``HifiganConfig.from_json`` reads the
reference's config JSON and ``import_torch_generator`` its
``{'generator': state_dict}`` checkpoints.  The convolutions are torch's F.conv1d /
F.conv_transpose1d, as the JAX package leaves them to XLA's convolutions.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tacotron2_subword_tpu_torch.nn import layers as L
from tacotron2_subword_tpu_torch.utils.platform import resolve_device
from tacotron2_subword_tpu_torch.utils.tree import to_device

LRELU_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class HifiganConfig:
    """HiFi-GAN v1 by default (the reference's config_v1.json)."""
    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80
    sampling_rate: int = 22050

    @classmethod
    def from_json(cls, path: str) -> "HifiganConfig":
        """The reference's config JSON (hifigan_infer/config_v1.json)."""
        with open(path) as f:
            h = json.load(f)
        return cls(
            resblock=str(h["resblock"]),
            upsample_rates=tuple(h["upsample_rates"]),
            upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
            upsample_initial_channel=h["upsample_initial_channel"],
            resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in h["resblock_dilation_sizes"]),
            num_mels=h.get("num_mels", 80),
            sampling_rate=h.get("sampling_rate", 22050),
        )

    @property
    def total_upsample(self) -> int:
        out = 1
        for u in self.upsample_rates:
            out *= u
        return out


def get_padding(kernel: int, dilation: int = 1) -> int:
    return (kernel * dilation - dilation) // 2


def _wn_conv_init(gen, in_ch: int, out_ch: int, k: int):
    p = L.weight_norm_init(gen, (out_ch, in_ch, k))
    p["b"] = torch.zeros(out_ch)
    return p


def _wn_convt_init(gen, in_ch: int, out_ch: int, k: int):
    # ConvTranspose1d layout [in, out, k]; weight norm over dim 0
    p = L.weight_norm_init(gen, (in_ch, out_ch, k))
    p["b"] = torch.zeros(out_ch)
    return p


def _resblock_init(gen, h: HifiganConfig, channels: int, kernel: int,
                   dilations: Sequence[int]):
    n = len(dilations)
    if h.resblock == "1":
        return {"convs1": [_wn_conv_init(gen, channels, channels, kernel)
                           for _ in range(n)],
                "convs2": [_wn_conv_init(gen, channels, channels, kernel)
                           for _ in range(n)]}
    return {"convs": [_wn_conv_init(gen, channels, channels, kernel)
                      for _ in range(n)]}


def init_generator(generator: torch.Generator, h: HifiganConfig,
                   device="cuda"):
    """Random weight-normed generator params (v ~ N(0, 0.01)), drawn from a
    CPU generator and moved to ``device``."""
    device = resolve_device(device)
    ch = h.upsample_initial_channel
    params: Dict[str, Any] = {
        "conv_pre": _wn_conv_init(generator, h.num_mels, ch, 7)}
    ups, resblocks = [], []
    for i, k in enumerate(h.upsample_kernel_sizes):
        out_ch = ch // (2 ** (i + 1))
        ups.append(_wn_convt_init(generator, ch // (2 ** i), out_ch, k))
        for kern, dil in zip(h.resblock_kernel_sizes,
                             h.resblock_dilation_sizes):
            resblocks.append(_resblock_init(generator, h, out_ch, kern, dil))
    params["ups"] = ups
    params["resblocks"] = resblocks
    params["conv_post"] = _wn_conv_init(generator, out_ch, 1, 7)
    return to_device(params, device)


def _fused(p):
    """{w, b} of a weight-normed or already fused conv."""
    return L.fuse_weight_norm(p) if "v" in p else p


def _conv(p, x, dilation: int = 1, padding=None):
    p = _fused(p)
    if padding is None:
        padding = get_padding(p["w"].shape[-1], dilation)
    return L.conv1d_apply(p, x, padding=padding, dilation=dilation)


def _convt(p, x, stride: int, padding: int):
    return L.conv_transpose1d_apply(_fused(p), x, stride, padding)


def _resblock_apply(p, h: HifiganConfig, x, dilations):
    lrelu = lambda v: F.leaky_relu(v, LRELU_SLOPE)
    if h.resblock == "1":
        for c1, c2, d in zip(p["convs1"], p["convs2"], dilations):
            xt = _conv(c1, lrelu(x), dilation=d)
            x = _conv(c2, lrelu(xt)) + x
    else:
        for c, d in zip(p["convs"], dilations):
            x = _conv(c, lrelu(x), dilation=d) + x
    return x


def generator_apply(params, h: HifiganConfig, mel: torch.Tensor):
    """mel [B, 80, T] -> waveform [B, 1, T * prod(upsample_rates)]."""
    x = _conv(params["conv_pre"], mel, padding=3)
    nk = len(h.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(h.upsample_rates,
                                   h.upsample_kernel_sizes)):
        x = _convt(params["ups"][i], F.leaky_relu(x, LRELU_SLOPE), stride=u,
                   padding=(k - u) // 2)
        xs = None
        for j in range(nk):
            r = _resblock_apply(params["resblocks"][i * nk + j], h, x,
                                h.resblock_dilation_sizes[j])
            xs = r if xs is None else xs + r
        x = xs / nk
    x = F.leaky_relu(x)  # default slope 0.01, as the reference
    return torch.tanh(_conv(params["conv_post"], x, padding=3))


def fuse_generator(params):
    """Collapse every weight-norm {v, g} into ``w`` (remove_weight_norm)."""
    return {"conv_pre": _fused(params["conv_pre"]),
            "conv_post": _fused(params["conv_post"]),
            "ups": [_fused(p) for p in params["ups"]],
            "resblocks": [{k: [_fused(c) for c in v] for k, v in rb.items()}
                          for rb in params["resblocks"]]}


def import_torch_generator(sd, h: HifiganConfig, device="cuda"):
    """Params from a reference HiFi-GAN state dict (the ``generator`` entry
    of a ``g_*`` checkpoint, reference hifigan_utils.py:38-41 /
    inference.py:184-188; tensors or numpy arrays), weight-normed
    (weight_v / weight_g) or fused (weight), on ``device``.  A missing key
    raises KeyError."""
    device = resolve_device(device)

    def t(key):
        return torch.as_tensor(np.asarray(sd[key]), dtype=torch.float32,
                               device=device)

    def grab(prefix):
        if f"{prefix}.weight_v" in sd:
            return {"v": t(f"{prefix}.weight_v"), "g": t(f"{prefix}.weight_g"),
                    "b": t(f"{prefix}.bias")}
        return {"w": t(f"{prefix}.weight"), "b": t(f"{prefix}.bias")}

    params = {"conv_pre": grab("conv_pre"), "conv_post": grab("conv_post"),
              "ups": [grab(f"ups.{i}") for i in range(len(h.upsample_rates))],
              "resblocks": []}
    nk = len(h.resblock_kernel_sizes)
    names = ("convs1", "convs2") if h.resblock == "1" else ("convs",)
    for i in range(len(h.upsample_rates) * nk):
        nd = len(h.resblock_dilation_sizes[i % nk])
        params["resblocks"].append(
            {name: [grab(f"resblocks.{i}.{name}.{j}") for j in range(nd)]
             for name in names})
    return params
