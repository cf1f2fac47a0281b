"""The HiFi-GAN generator as a vocoder part (jik876/hifi-gan models.py):
its weights' leaves and its work a mel frame, from the sizes the config
file keeps under "hifigan".

Bounds: the fused convolutions at torch's default U(+-1/sqrt(fan_in)) (a
trained generator's weight norm is folded into them for serving).
"""

from __future__ import annotations

import math
from typing import List

from t2s_bench.flops import conv_macs
from t2s_bench.weights import Spec


def specs(h: dict) -> List[Spec]:
    """Leaves "gen.*" of the fused generator whose sizes ``h`` holds."""
    s: List[Spec] = []

    def conv(name, c_in, c_out, k, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        s.extend([(f"{name}.w", (c_out, c_in, k), -b, b),
                  (f"{name}.b", (c_out,), -b, b)])

    ch = h["upsample_initial_channel"]
    conv("gen.conv_pre", h["num_mels"], ch, 7, h["num_mels"] * 7)
    j = 0
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        b = 1.0 / math.sqrt(c_out * k)   # torch: fan_in = out * k
        s.extend([(f"gen.ups.{i}.w", (c_in, c_out, k), -b, b),
                  (f"gen.ups.{i}.b", (c_out,), -b, b)])
        for kern, dil in zip(h["resblock_kernel_sizes"],
                             h["resblock_dilation_sizes"]):
            names = ("convs1", "convs2") if h["resblock"] == "1" \
                else ("convs",)
            for nm in names:
                for d in range(len(dil)):
                    conv(f"gen.resblocks.{j}.{nm}.{d}", c_out, c_out, kern,
                         c_out * kern)
            j += 1
    conv("gen.conv_post", ch // 2 ** len(h["upsample_rates"]), 1, 7,
         ch // 2 ** len(h["upsample_rates"]) * 7)
    return s


def frame_flops(h: dict) -> float:
    """The generator's work per mel frame: conv_pre, the transposed convs
    (each input position times C_in x C_out x k), the resblocks (each conv
    C x C x k per output position) and conv_post."""
    ch = h["upsample_initial_channel"]
    macs = conv_macs(h["num_mels"], ch, 7, 1)
    pos = 1
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        macs += c_in * c_out * k * pos
        pos *= u
        n_convs = 2 if h["resblock"] == "1" else 1
        for kern, dil in zip(h["resblock_kernel_sizes"],
                             h["resblock_dilation_sizes"]):
            macs += n_convs * len(dil) * conv_macs(c_out, c_out, kern, pos)
    macs += conv_macs(ch // 2 ** len(h["upsample_rates"]), 1, 7, pos)
    return 2.0 * macs
