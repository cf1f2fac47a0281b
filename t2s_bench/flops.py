"""Operations and bytes of the work, counted from shapes: the yardstick of
the roofline and utilisation metrics.

A multiply-add counts 2; nonlinearities, normalisation, masking and
softmax are not counted (they are a small share of every layer here).
Counts are of the work a sentence needs at its own lengths: the padding
of a batch and the steps run past a sentence's stop are not counted.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W): 989 TFLOP/s
bf16, 3.35 TB/s HBM.  The K1 bound (``k1_bound_s``) is the arithmetic of
PERF.md's kernel table at commit 8e462dd: the larger of the HBM bytes
(int8 weight, bf16 x, f32 scale, f32 out) over 3.35 TB/s and the FLOPs
over 989 TFLOP/s.
"""

from __future__ import annotations

import math
from typing import Sequence

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def conv_macs(c_in: int, c_out: int, k: int, positions: int) -> int:
    return c_in * c_out * k * positions


def lstm_macs(n_in: int, h: int) -> int:
    """One cell step: [x, h] @ [in + H, 4H]."""
    return (n_in + h) * 4 * h


def encoder_flops(t: dict, length: int) -> float:
    """One stream's encoder at ``length`` IDs: 3 convs, the BiLSTM, the
    [CLS] converter and the attention's memory layer."""
    E = t["encoder_embedding_dim"]
    macs = t["encoder_n_convolutions"] * conv_macs(
        E, E, t["encoder_kernel_size"], length)
    macs += 2 * lstm_macs(E, E // 2) * length
    macs += (E + t["bert_embedding_dim"]) * E * length
    macs += E * t["attention_dim"] * length
    return 2.0 * macs


def attention_flops(t: dict, length: int) -> float:
    """One stream's attention step over ``length`` memory positions."""
    A, E = t["attention_dim"], t["encoder_embedding_dim"]
    macs = t["attention_rnn_dim"] * A          # query layer
    macs += A * length                         # v . tanh(...)
    macs += E * length                         # context
    if t["attention"] == "LocationSensitiveAttention":
        F, k = (t["attention_location_n_filters"],
                t["attention_location_kernel_size"])
        macs += 2 * F * k * length + F * A * length
    return 2.0 * macs


def decode_step_flops(t: dict, len_text: int, len_sub: int) -> float:
    """One decoder step of one sentence: both prenets, both attention
    LSTMs and attentions, the decoder LSTM and the two projections."""
    M = t["n_mel_channels"] * t["n_frames_per_step"]
    P, E = t["prenet_dim"], t["encoder_embedding_dim"]
    Ar, D = t["attention_rnn_dim"], t["decoder_rnn_dim"]
    macs = 2 * (M * P + P * P)
    macs += 2 * lstm_macs(P + E, Ar)
    macs += lstm_macs(2 * Ar + 2 * E, D)
    macs += (D + 2 * E) * (M + 1)
    return 2.0 * macs + attention_flops(t, len_text) + attention_flops(
        t, len_sub)


def postnet_frame_flops(t: dict) -> float:
    n, k = t["postnet_n_convolutions"], t["postnet_kernel_size"]
    M, C = t["n_mel_channels"], t["postnet_embedding_dim"]
    chans = [M] + [C] * (n - 1) + [M]
    return 2.0 * sum(conv_macs(a, b, k, 1) for a, b in zip(chans, chans[1:]))


def batch_flops(t: dict, vocoder_frame_flops: float,
                len_text: Sequence[int], len_sub: Sequence[int],
                frames: Sequence[int]) -> float:
    """The model FLOPs of the delivered sentences: the encoders at their
    lengths, then per frame the decode step, the postnet and the vocoder
    (``vocoder_frame_flops``, its part's ``frame_flops``)."""
    per_frame = postnet_frame_flops(t) + vocoder_frame_flops
    return float(sum(
        encoder_flops(t, a) + encoder_flops(t, b)
        + int(n) * (decode_step_flops(t, a, b) + per_frame)
        for a, b, n in zip(len_text, len_sub, frames)))


def k1_bytes(S: int, B: int, K: int, N: int) -> int:
    """HBM bytes of one K1 launch, each read or written once: the int8
    weight, the bf16 x, the f32 scale and the f32 output."""
    return S * K * N + 2 * S * B * K + 4 * S * N + 4 * S * B * N


def k1_flops(S: int, B: int, K: int, N: int) -> int:
    return 2 * S * B * K * N


def k1_bound_s(S: int, B: int, K: int, N: int) -> float:
    """The least time of one K1 launch on the card."""
    return max(k1_bytes(S, B, K, N) / PEAK_HBM_BYTES,
               k1_flops(S, B, K, N) / PEAK_BF16_FLOPS)


def k1_step_shapes(t: dict, B: int):
    """The two K1 launches of one decode step: the stacked attention LSTMs
    and the decoder LSTM, as (S, B, K, N)."""
    P, E = t["prenet_dim"], t["encoder_embedding_dim"]
    Ar, D = t["attention_rnn_dim"], t["decoder_rnn_dim"]
    return [(2, B, P + E + Ar, 4 * Ar), (1, B, 2 * Ar + 2 * E + D, 4 * D)]


def k1_step_bound_s(t: dict, B: int) -> float:
    return sum(k1_bound_s(*s) for s in k1_step_shapes(t, B))


def share_pct(num: float, den: float):
    """100 num / den, or None where nothing was read."""
    if not den or not math.isfinite(den):
        return None
    return 100.0 * num / den

