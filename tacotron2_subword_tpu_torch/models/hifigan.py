"""HiFi-GAN in PyTorch: the generator, the discriminators and the GAN losses.

Counterpart of ``tacotron2_subword_tpu/models/hifigan.py``.  Generator:
conv_pre (80 -> C, k7), then per upsampling stage leaky_relu ->
ConvTranspose1d -> the average of the multi-receptive-field resblocks, then
leaky_relu -> conv_post -> tanh.  Discriminators (training): the
multi-period one (periods 2, 3, 5, 7, 11; the waveform reflect-padded to a
multiple of the period and folded to [B, 1, T/p, p]) and the multi-scale
one (three scales, 4/2 average pooling between them), with the LSGAN and
feature-matching losses.  Parameters carry weight-norm {v, g, b} as
trained (norm over every dim but 0); ``fuse_generator`` collapses them for
serving.  ``HifiganConfig.from_json`` reads the reference's config JSON,
``import_torch_generator`` its ``{'generator': state_dict}`` checkpoints
and ``export_torch_generator`` writes one.  The convolutions are torch's
F.conv1d / F.conv2d / F.conv_transpose1d, as the JAX package leaves them to
XLA's convolutions.  Served on the card (autograd off), the generator keeps
its activations channels-last and ends each convolution with one pass of
the hand-written epilogue K4 (``ops/conv_epilogue.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tacotron2_subword_tpu_torch.nn import layers as L
from tacotron2_subword_tpu_torch.ops import conv_epilogue as EP
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
    """mel [B, 80, T] -> waveform [B, 1, T * prod(upsample_rates)].

    A CUDA mel with autograd off (serving, under ``inference_mode``) takes
    ``_generator_apply_channels_last``; every other call (the CPU,
    training) the code below.  Served in strict f32 (cuDNN's TF32 off, not
    torch's default), cuDNN's f32 channels-last kernels ran V1 about 8x
    slower than its NCHW ones on an H100 (1 x 256 frames: 53 against
    6.8 ms)."""
    if mel.is_cuda and not torch.is_grad_enabled():
        return _generator_apply_channels_last(params, h, mel)
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


def _conv_cl(p, x, dilation: int = 1, padding=None):
    """A fused conv's convolution without its bias on a channels-last
    [B, C, 1, T] activation: cuDNN reads and writes NHWC, no transposes."""
    w = p["w"]
    if padding is None:
        padding = get_padding(w.shape[-1], dilation)
    w = w.unsqueeze(2).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w, None, padding=(0, padding), dilation=(1, dilation))


def _convt_cl(p, x, stride: int, padding: int):
    w = p["w"].unsqueeze(2).contiguous(memory_format=torch.channels_last)
    return F.conv_transpose2d(x, w, None, stride=(1, stride),
                              padding=(0, padding))


def _rows(t):
    """A channels-last [B, C, 1, T] tensor as its [B * T, C] rows (a view:
    raises if ``t`` is not channels-last)."""
    return None if t is None else t.permute(0, 2, 3, 1).view(-1, t.shape[1])


def _epilogue(y, p, *, residual=None, mrf_sum=None, mrf_div=0, out_pre=None,
              out_act=None, act="lrelu", slope=LRELU_SLOPE):
    """``ops.conv_epilogue`` on channels-last tensors, with p's bias."""
    EP.conv_epilogue(_rows(y), p["b"], residual=_rows(residual),
                     mrf_sum=_rows(mrf_sum), mrf_div=mrf_div,
                     out_pre=_rows(out_pre), out_act=_rows(out_act), act=act,
                     slope=slope)


def _generator_apply_channels_last(params, h: HifiganConfig,
                                   mel: torch.Tensor):
    """``generator_apply`` with the activations held channels-last,
    [B, C, 1, T] (physically [B, T, C]), from conv_pre's input to
    conv_post's output: each convolution is cuDNN's, without its bias, and
    one ``ops.conv_epilogue`` pass after it adds the bias, the residual and
    the MRF sum and average, and writes the pre-activation where a later
    add reads it and the activation where the next convolution reads it.
    The f32 operations are ``generator_apply``'s, in its order; only the
    convolutions' algorithms differ, and conv_post runs with TF32 off.
    Weight-normed trees are fused per call, and the weights' channels-last
    copies are made per call.

    For conv_post, cuDNN's process-wide ``allow_tf32`` is set off and then
    back: the serving path assumes one thread drives the card, as
    ``synthesize`` does.  A convolution another thread runs meanwhile runs
    in strict f32, and a change another thread makes to the switch
    meanwhile is undone."""
    B = mel.shape[0]
    nk = len(h.resblock_kernel_sizes)
    stages = len(h.upsample_rates)
    p = _fused(params["conv_pre"])
    y = _conv_cl(p, mel.unsqueeze(2).contiguous(
        memory_format=torch.channels_last), padding=3)
    _epilogue(y, p, out_act=y)
    act = y                            # leaky_relu(conv_pre(mel))
    for i, (u, k) in enumerate(zip(h.upsample_rates,
                                   h.upsample_kernel_sizes)):
        p = _fused(params["ups"][i])
        x = _convt_cl(p, act, stride=u, padding=(k - u) // 2)
        x_act = torch.empty_like(x)
        _epilogue(x, p, out_pre=x, out_act=x_act)
        # the stage's average feeds the next stage's leaky_relu, or the
        # default-slope one before conv_post, as in generator_apply
        slope_out = LRELU_SLOPE if i + 1 < stages else 0.01
        mrf = None
        for j in range(nk):
            rb = params["resblocks"][i * nk + j]
            dils = h.resblock_dilation_sizes[j]
            if h.resblock == "1":
                pairs = list(zip(rb["convs1"], rb["convs2"], dils))
            else:
                pairs = [(None, c, d) for c, d in zip(rb["convs"], dils)]
            pre, a = x, x_act
            for m, (c1, c2, d) in enumerate(pairs):
                if c1 is not None:     # resblock "1": the dilated conv
                    p1 = _fused(c1)
                    a = _conv_cl(p1, a, dilation=d)
                    _epilogue(a, p1, out_act=a)
                    d = 1
                p2 = _fused(c2)
                y = _conv_cl(p2, a, dilation=d)
                if m + 1 < len(pairs):
                    a = torch.empty_like(y)
                    _epilogue(y, p2, residual=pre, out_pre=y, out_act=a)
                    pre = y
                elif j + 1 < nk:       # into the MRF sum
                    _epilogue(y, p2, residual=pre, mrf_sum=mrf,
                              out_pre=y if mrf is None else mrf)
                    if mrf is None:
                        mrf = y
                else:                  # the last resblock: the average
                    _epilogue(y, p2, residual=pre, mrf_sum=mrf, mrf_div=nk,
                              out_act=y, slope=slope_out)
                    act = y
    # conv_post in full f32: its rounding reaches the wav unaveraged.  In
    # TF32, V2's served wavs moved up to 9.4e-5 of full scale from the f32
    # reference (8 seeds; the generator path 1.4e-5), in f32 up to 2.4e-5
    p = _fused(params["conv_post"])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = _conv_cl(p, act, padding=3)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    _epilogue(y, p, out_act=y, act="tanh")
    return y.view(B, 1, -1)


def right_context_frames(h: HifiganConfig) -> int:
    """Mel frames after a row's last kept frame that its kept samples (the
    first n * total_upsample of an n-frame row) can read through
    ``generator_apply``: a mel cut or padded anywhere at or past frame
    n + right_context_frames(h) gives them the same values.  Followed back
    from the last kept sample: conv_post's and each resblock's reach at
    its rate, each transposed convolution's padding over its stride
    (rounded down: output o reads inputs up to (o + padding) // stride),
    then conv_pre's 3 frames."""
    def reach(k: int, d: int) -> int:    # right reach of a "same" conv
        return d * (k - 1) - get_padding(k, d)

    def resblock_reach(k: int, dilations) -> int:
        # resblock "1" follows each dilated conv with an undilated one
        second = reach(k, 1) if h.resblock == "1" else 0
        return sum(reach(k, d) + second for d in dilations)

    last = -1 + 3          # the last kept sample, R*n - 1, and conv_post
    for u, k in reversed(list(zip(h.upsample_rates,
                                  h.upsample_kernel_sizes))):
        last += max(resblock_reach(kern, dil) for kern, dil in zip(
            h.resblock_kernel_sizes, h.resblock_dilation_sizes))
        last = (last + (k - u) // 2) // u
    last += 3              # conv_pre: the last frame read is n + last
    return last + 1


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


def export_torch_generator(params):
    """The inverse of ``import_torch_generator``: a generator tree as the
    reference's state dict (the tree's path is the module name; v / g / w /
    b become weight_v / weight_g / weight / bias), contiguous CPU tensors,
    for ``torch.save({'generator': ...})``."""
    names = {"v": "weight_v", "g": "weight_g", "w": "weight", "b": "bias"}
    sd = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, prefix + names[k] if k in names else f"{prefix}{k}.")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}.")
        else:
            sd[prefix] = tree.detach().cpu().contiguous()
    walk(params, "")
    return sd


# ---------------------------------------------------------------------------
# Discriminators and GAN losses (training; reference hifigan_model.py:127-281)
# ---------------------------------------------------------------------------

PERIODS = (2, 3, 5, 7, 11)
# (in, out) channels of the period discriminator's (5, 1) convolutions
PERIOD_DISC_CHANNELS = ((1, 32), (32, 128), (128, 512), (512, 1024),
                        (1024, 1024))
# (in_ch, out_ch, kernel, stride, groups, padding) per layer of the scale
# discriminator (reference hifigan_model.py:194-203)
SCALE_DISC_SPEC = ((1, 128, 15, 1, 1, 7), (128, 128, 41, 2, 4, 20),
                   (128, 256, 41, 2, 16, 20), (256, 512, 41, 4, 16, 20),
                   (512, 1024, 41, 4, 16, 20), (1024, 1024, 41, 1, 16, 20),
                   (1024, 1024, 5, 1, 1, 2))


def _wn_init(gen, shape):
    p = L.weight_norm_init(gen, shape)
    p["b"] = torch.zeros(shape[0])
    return p


def init_discriminators(generator: torch.Generator, device="cuda"):
    """Random weight-normed MPD + MSD params (v ~ N(0, 0.01)), drawn from
    a CPU generator and moved to ``device``: {"mpd": 5 period
    discriminators {convs [5], conv_post}, "msd": 3 scale discriminators
    {convs [7], conv_post}}."""
    device = resolve_device(device)
    mpd = [{"convs": [_wn_init(generator, (cout, cin, 5, 1))
                      for cin, cout in PERIOD_DISC_CHANNELS],
            "conv_post": _wn_init(generator, (1, 1024, 3, 1))}
           for _ in PERIODS]
    msd = [{"convs": [_wn_init(generator, (cout, cin // g, k))
                      for cin, cout, k, _, g, _ in SCALE_DISC_SPEC],
            "conv_post": _wn_init(generator, (1, 1024, 3))}
           for _ in range(3)]
    return to_device({"mpd": mpd, "msd": msd}, device)


def period_discriminator_apply(p, x: torch.Tensor, period: int):
    """x [B, 1, T] -> (logits [B, n], feature maps of the 6 layers)."""
    B, C, T = x.shape
    if T % period:
        x = F.pad(x, (0, period - T % period), mode="reflect")
    x = x.reshape(B, C, x.shape[-1] // period, period)
    fmap = []
    for i, conv in enumerate(p["convs"]):
        x = L.conv2d_apply(_fused(conv), x, stride=(3, 1) if i < 4 else (1, 1),
                           padding=(2, 0))
        x = F.leaky_relu(x, LRELU_SLOPE)
        fmap.append(x)
    x = L.conv2d_apply(_fused(p["conv_post"]), x, padding=(1, 0))
    fmap.append(x)
    return x.reshape(B, -1), fmap


def scale_discriminator_apply(p, x: torch.Tensor):
    """x [B, 1, T] -> (logits [B, n], feature maps of the 8 layers)."""
    fmap = []
    for c, (_, _, _, stride, groups, pad) in zip(p["convs"],
                                                 SCALE_DISC_SPEC):
        x = L.conv1d_apply(_fused(c), x, padding=pad, stride=stride,
                           groups=groups)
        x = F.leaky_relu(x, LRELU_SLOPE)
        fmap.append(x)
    x = L.conv1d_apply(_fused(p["conv_post"]), x, padding=1)
    fmap.append(x)
    return x.reshape(x.shape[0], -1), fmap


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Window 4, stride 2, zero padding 2 counted in the mean (the JAX
    package's reduce_window sum / 4)."""
    return F.avg_pool1d(x, 4, 2, padding=2, count_include_pad=True)


def discriminate(params, x: torch.Tensor):
    """One waveform batch x [B, 1, T] through MPD then MSD: (logits,
    feature maps), one entry per discriminator (8)."""
    outs, fmaps = [], []
    for p, period in zip(params["mpd"], PERIODS):
        o, f = period_discriminator_apply(p, x, period)
        outs.append(o)
        fmaps.append(f)
    for i, p in enumerate(params["msd"]):
        if i:
            x = _avg_pool(x)
        o, f = scale_discriminator_apply(p, x)
        outs.append(o)
        fmaps.append(f)
    return outs, fmaps


def discriminators_apply(params, y: torch.Tensor, y_hat: torch.Tensor):
    """(real_logits, gen_logits, real_fmaps, gen_fmaps) across MPD + MSD
    (reference hifigan_model.py:174-247)."""
    rs, fr = discriminate(params, y)
    gs, fg = discriminate(params, y_hat)
    return rs, gs, fr, fg


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """2 x the sum over every feature map of mean |real - generated|."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2


def discriminator_loss(real_outs, gen_outs) -> torch.Tensor:
    """LSGAN: sum over discriminators of mean (1 - D(y))^2 + mean D(y_hat)^2."""
    loss = 0.0
    for dr, dg in zip(real_outs, gen_outs):
        loss = loss + torch.mean((1 - dr) ** 2) + torch.mean(dg ** 2)
    return loss


def generator_adv_loss(gen_outs) -> torch.Tensor:
    """LSGAN: sum over discriminators of mean (1 - D(y_hat))^2."""
    loss = 0.0
    for dg in gen_outs:
        loss = loss + torch.mean((1 - dg) ** 2)
    return loss
