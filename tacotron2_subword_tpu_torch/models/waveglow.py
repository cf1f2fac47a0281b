"""WaveGlow flow vocoder in PyTorch: forward, loss, inverse (synthesis).

Counterpart of ``tacotron2_subword_tpu/models/waveglow.py`` (the reference
glow.py:43-311), with its parameter tree: the mel is upsampled by a
ConvTranspose1d (80 -> 80, k 1024, s 256), the audio is grouped into
``n_group`` channels, and 12 flows of [invertible 1x1 conv -> WN affine
coupling] run with early outputs of 2 channels every 4 flows.  The loss is
z^2 / 2 sigma^2 - sum log s - sum log det W, normalised by the size of z
(glow.py:43-59).  The convolutions are torch's F.conv1d /
F.conv_transpose1d (cuDNN on the card), as the JAX package leaves them to
XLA; the flow loop is a Python loop, since each flow has its own channel
count.

Parameters: ``upsample`` {w [80, 80, k], b}; ``convinv`` a list of {w [n, n]}
(orthonormal, det +1 at init); ``wn`` a list of {start, cond, in_layers,
res_skip (weight-normed {v, g, b}), end {w, b} (zero at init)}.  bf16
synthesis casts the params and the mel (``utils.tree.cast_floats``): W's
inverse is taken in f32 and cast, and the latents are drawn in f32 and
cast.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import torch

from tacotron2_subword_tpu_torch.nn import layers as L
from tacotron2_subword_tpu_torch.utils.platform import resolve_device
from tacotron2_subword_tpu_torch.utils.tree import to_device


@dataclasses.dataclass(frozen=True)
class WaveGlowConfig:
    """The reference waveglow/config.json widths by default."""
    n_mel_channels: int = 80
    n_flows: int = 12
    n_group: int = 8
    n_early_every: int = 4
    n_early_size: int = 2
    wn_layers: int = 8
    wn_channels: int = 256
    wn_kernel_size: int = 3
    upsample_kernel: int = 1024
    upsample_stride: int = 256

    def n_remaining(self) -> int:
        """Channels left after every early output (the latent's width at
        the last flow)."""
        n = self.n_group
        for k in range(1, self.n_flows):
            if k % self.n_early_every == 0:
                n -= self.n_early_size
        return n


def _early(cfg: WaveGlowConfig, k: int) -> bool:
    """Flow ``k`` is preceded by an early output."""
    return k % cfg.n_early_every == 0 and k > 0


def _wn_conv_init(gen, in_ch: int, out_ch: int, k: int):
    """A weight-normed conv with torch's default v ~ U(+-1/sqrt(in*k)) and
    g = ||v||."""
    bound = 1.0 / math.sqrt(in_ch * k)
    v = L.uniform(gen, (out_ch, in_ch, k), bound)
    g = torch.sqrt(torch.sum(v * v, dim=(1, 2), keepdim=True))
    return {"v": v, "g": g, "b": torch.zeros(out_ch)}


def _wn_init(gen, cfg: WaveGlowConfig, n_half: int):
    """The WN coupling net (reference glow.py:105-151)."""
    C = cfg.wn_channels
    p: Dict[str, Any] = {
        "start": _wn_conv_init(gen, n_half, C, 1),
        # zero end conv: each coupling starts as the identity (glow.py:127)
        "end": {"w": torch.zeros(2 * n_half, C, 1),
                "b": torch.zeros(2 * n_half)},
        "cond": _wn_conv_init(gen, cfg.n_mel_channels * cfg.n_group,
                              2 * C * cfg.wn_layers, 1),
        "in_layers": [], "res_skip": []}
    for i in range(cfg.wn_layers):
        p["in_layers"].append(_wn_conv_init(gen, C, 2 * C,
                                            cfg.wn_kernel_size))
        p["res_skip"].append(_wn_conv_init(
            gen, C, 2 * C if i < cfg.wn_layers - 1 else C, 1))
    return p


def init_waveglow(gen: torch.Generator, cfg: WaveGlowConfig, device="cuda"):
    """Random params drawn from the CPU generator ``gen`` and moved to
    ``device``: torch's default inits, each ``convinv`` a random orthonormal
    matrix with det +1 (reference glow.py:73-80)."""
    device = resolve_device(device)
    bound = 1.0 / math.sqrt(cfg.n_mel_channels * cfg.upsample_kernel)
    shape = (cfg.n_mel_channels, cfg.n_mel_channels, cfg.upsample_kernel)
    params: Dict[str, Any] = {
        "upsample": {"w": L.uniform(gen, shape, bound),
                     "b": L.uniform(gen, (cfg.n_mel_channels,), bound)},
        "convinv": [], "wn": []}
    n_half, n_rem = cfg.n_group // 2, cfg.n_group
    for k in range(cfg.n_flows):
        if _early(cfg, k):
            n_half -= cfg.n_early_size // 2
            n_rem -= cfg.n_early_size
        q, _ = torch.linalg.qr(torch.randn(n_rem, n_rem, generator=gen))
        if torch.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        params["convinv"].append({"w": q})
        params["wn"].append(_wn_init(gen, cfg, n_half))
    return to_device(params, device)


def _conv(p, x: torch.Tensor, dilation: int = 1,
          padding: int = 0) -> torch.Tensor:
    w = L.weight_norm_weight(p) if "v" in p else p["w"]
    return L.conv1d_apply({"w": w, "b": p["b"]}, x, padding=padding,
                          dilation=dilation)


def _wn_apply(p, cfg: WaveGlowConfig, audio_half: torch.Tensor,
              spect: torch.Tensor) -> torch.Tensor:
    """audio_half [B, n_half, Tg] and the grouped spect [B, mels*n_group, Tg]
    -> [B, 2*n_half, Tg]: b over the first n_half rows, log s over the
    rest."""
    C = cfg.wn_channels
    x = _conv(p["start"], audio_half)
    cond = _conv(p["cond"], spect)
    out = None
    for i in range(cfg.wn_layers):
        d = 2 ** i
        acts = _conv(p["in_layers"][i], x, dilation=d,
                     padding=(cfg.wn_kernel_size * d - d) // 2)
        acts = acts + cond[:, i * 2 * C:(i + 1) * 2 * C]
        acts = torch.tanh(acts[:, :C]) * torch.sigmoid(acts[:, C:])
        rs = _conv(p["res_skip"][i], acts)
        skip = rs[:, C:] if i < cfg.wn_layers - 1 else rs
        if i < cfg.wn_layers - 1:
            x = x + rs[:, :C]
        out = skip if out is None else out + skip
    return L.conv1d_apply(p["end"], out, padding=0)


def _group_spect(spect_up: torch.Tensor, n_group: int) -> torch.Tensor:
    """[B, C, T] -> [B, C*n_group, T//n_group], channel c*n_group + offset
    (the reference's unfold / permute / view, glow.py:220-221)."""
    B, C, T = spect_up.shape
    Tg = T // n_group
    s = spect_up[:, :, :Tg * n_group].reshape(B, C, Tg, n_group)
    return s.permute(0, 1, 3, 2).reshape(B, C * n_group, Tg)


def _group_audio(audio: torch.Tensor, n_group: int) -> torch.Tensor:
    """[B, T] -> [B, n_group, T//n_group] (glow.py:223)."""
    B, T = audio.shape
    Tg = T // n_group
    return audio[:, :Tg * n_group].reshape(B, Tg, n_group).permute(0, 2, 1)


def _ungroup_audio(audio: torch.Tensor) -> torch.Tensor:
    """[B, n_group, Tg] -> [B, Tg*n_group] (glow.py:292)."""
    B, G, Tg = audio.shape
    return audio.permute(0, 2, 1).reshape(B, Tg * G)


def _mix(W: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The invertible 1x1 conv: W [n, n] over a's channels, in a's dtype."""
    return torch.einsum("ij,bjt->bit", W.to(a.dtype), a)


def _upsample(params, cfg: WaveGlowConfig, spect: torch.Tensor):
    return L.conv_transpose1d_apply(params["upsample"], spect,
                                    stride=cfg.upsample_stride)


def forward(params, cfg: WaveGlowConfig, spect: torch.Tensor,
            audio: torch.Tensor):
    """The training direction: mel [B, mels, F] and audio [B, T] -> (z
    [B, n_group, T//n_group], log_s per flow, B*Tg*log|det W| per flow)
    (reference glow.py:207-249); z holds the early outputs in flow order,
    then the last flow's channels."""
    T = audio.shape[1]
    sp = _group_spect(_upsample(params, cfg, spect)[:, :, :T], cfg.n_group)
    a = _group_audio(audio, cfg.n_group)
    B, _, Tg = a.shape
    out_audio: List[torch.Tensor] = []
    log_s_list: List[torch.Tensor] = []
    log_det_w_list: List[torch.Tensor] = []
    for k in range(cfg.n_flows):
        if _early(cfg, k):
            out_audio.append(a[:, :cfg.n_early_size])
            a = a[:, cfg.n_early_size:]
        W = params["convinv"][k]["w"]
        # the sign is ignored, as in the reference and the JAX package
        log_det_w_list.append(B * Tg * torch.linalg.slogdet(W)[1])
        a = _mix(W, a)
        n_half = a.shape[1] // 2
        a0, a1 = a[:, :n_half], a[:, n_half:]
        wn_out = _wn_apply(params["wn"][k], cfg, a0, sp)
        log_s = wn_out[:, n_half:]
        a1 = torch.exp(log_s) * a1 + wn_out[:, :n_half]
        log_s_list.append(log_s)
        a = torch.cat([a0, a1], dim=1)
    out_audio.append(a)
    return torch.cat(out_audio, dim=1), log_s_list, log_det_w_list


def loss(model_output, sigma: float = 1.0) -> torch.Tensor:
    """The flow NLL over the size of z (reference glow.py:43-59)."""
    z, log_s_list, log_det_w_list = model_output
    log_s_total = sum(torch.sum(s) for s in log_s_list)
    log_det_total = sum(log_det_w_list)
    nll = (torch.sum(z * z) / (2 * sigma * sigma) - log_s_total
           - log_det_total)
    return nll / z.numel()


def latent_shapes(cfg: WaveGlowConfig, B: int, Tg: int):
    """The shapes of the latents ``infer`` draws, in its order: the last
    flow's [B, n_rem, Tg], then one [B, n_early_size, Tg] per early output
    from the last flow to the first."""
    shapes = [(B, cfg.n_remaining(), Tg)]
    shapes += [(B, cfg.n_early_size, Tg) for k in reversed(range(cfg.n_flows))
               if _early(cfg, k)]
    return shapes


def infer(params, cfg: WaveGlowConfig, spect: torch.Tensor,
          sigma: float = 1.0, generator: Optional[torch.Generator] = None,
          noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """The reverse pass: mel [B, mels, F] -> audio [B, T] in the mel's
    dtype (reference glow.py:251-293), the upsampled mel trimmed by
    kernel - stride frames as the reference trims it.  The latents are
    standard normals times ``sigma``, drawn in f32 from ``generator`` on the
    mel's device, or taken from ``noise`` (f32 standard normals in
    ``latent_shapes``' order, the order the JAX package draws them), and
    cast to the mel's dtype."""
    dtype, dev = spect.dtype, spect.device
    sp = _upsample(params, cfg, spect)
    sp = _group_spect(sp[:, :, :-(cfg.upsample_kernel - cfg.upsample_stride)],
                      cfg.n_group)
    B, _, Tg = sp.shape
    if noise is None:
        noise = [torch.randn(s, generator=generator, device=dev,
                             dtype=torch.float32)
                 for s in latent_shapes(cfg, B, Tg)]
    latents = iter(noise)
    a = (sigma * next(latents).to(dev, torch.float32)).to(dtype)
    for k in reversed(range(cfg.n_flows)):
        n_half = a.shape[1] // 2
        a0, a1 = a[:, :n_half], a[:, n_half:]
        wn_out = _wn_apply(params["wn"][k], cfg, a0, sp)
        a1 = (a1 - wn_out[:, :n_half]) / torch.exp(wn_out[:, n_half:])
        a = torch.cat([a0, a1], dim=1)
        # the inverse in f32 (an 8x8 inverse in bf16 would poison the whole
        # reverse chain; the reference caches a float inverse, glow.py:262)
        W_inv = torch.linalg.inv(
            params["convinv"][k]["w"].to(torch.float32))
        a = _mix(W_inv, a)
        if _early(cfg, k):
            z = (sigma * next(latents).to(dev, torch.float32)).to(dtype)
            a = torch.cat([z, a], dim=1)
    return _ungroup_audio(a)
