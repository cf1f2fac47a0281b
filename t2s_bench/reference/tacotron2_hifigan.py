"""Plain reference of the dual-stream BERT-Tacotron 2 with HiFi-GAN: plain
torch operations in float32, one sentence per row, no kernels, no fused
weights, no stacked streams.  It imports nothing of the program.

Semantics, after the published descriptions (NVIDIA/tacotron2 model.py,
PhucNguyenAH/tacotron2_subword's dual-stream model and SMA, jik876/hifi-gan
models.py):
 - each stream: embedding -> 3x (conv k5 "same", BatchNorm in eval, ReLU)
   -> a BiLSTM that reads each row within its length -> concat the [CLS]
   vector at every position -> linear converter;
 - each decoder step: two prenets (2x linear without bias, ReLU, dropout
   0.5 that stays on in inference), one attention LSTM per stream on
   [prenet, previous context], the stream's attention, one decoder LSTM on
   [h_phone, ctx_phone, h_sub, ctx_sub], the mel and gate projections of
   [h_dec, ctx_phone, ctx_sub];
 - attention: SMA, p = sigmoid(v . tanh(W q + V m)), alignment
   prev * p + shift_right(prev * (1 - p)), starting on the first position;
   or location-sensitive, softmax of v . tanh(W q + V m + U conv([w_prev,
   w_cum])), starting from zero weights; positions past a row's length are
   masked (energy -1e9);
 - postnet: 5 convs k5 "same" with BatchNorm, tanh on all but the last,
   added to the mel;
 - HiFi-GAN generator: conv_pre k7, per stage leaky ReLU 0.1 ->
   transposed conv -> the mean of the resblocks (type 1: pairs of dilated
   and plain convs on leaky ReLU 0.1, residual), leaky ReLU 0.01 ->
   conv_post k7 -> tanh.

``Precision`` rounds where the program holds a lower precision: none in the
plain run except the weights that the configuration states below bf16 (the
decode LSTMs' int8 weights, worked out again from the weights rounded to
the compute dtype, one scale per gate row); everything at the control's
precision in the control.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

MASK_ENERGY = -1e9
BN_EPS = 1e-5
QMAX = {"int8": 127, "int4": 7}
FP8_MAX = 448.0


def _round_float(x: torch.Tensor, fmt: str, dim: Optional[int]) -> torch.Tensor:
    """x rounded to ``fmt`` and back to f32; fp8 with one scale over the
    whole tensor (dim None) or per slice along ``dim``."""
    if fmt == "float32":
        return x
    if fmt == "bfloat16":
        return x.to(torch.bfloat16).float()
    if fmt == "float8_e4m3":
        amax = (x.abs().amax() if dim is None
                else x.abs().amax(dim=dim, keepdim=True))
        s = torch.clamp_min(amax, 1e-12) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s
    raise ValueError(f"unknown float format {fmt!r}")


def quantize_rows(w: torch.Tensor, fmt: str) -> torch.Tensor:
    """Symmetric integer quantization of w [rows, K] with one scale per row
    (amax / qmax, floored at 1e-8 / qmax), dequantized to f32."""
    q = QMAX[fmt]
    scale = torch.clamp_min(w.abs().amax(dim=1, keepdim=True), 1e-8) / q
    return torch.clamp(torch.round(w / scale), -q, q) * scale


class Precision:
    """Where and how the reference rounds.  ``spec`` holds "acoustic" (the
    encoders, the decode loop and the postnet), "decode_lstm_weights" and
    "vocoder", each a format name; ``compute`` is the configuration's
    acoustic dtype, from which integer weights are derived."""

    def __init__(self, spec: Dict[str, str], compute: str, plain: bool):
        self.acoustic = "float32" if plain else spec["acoustic"]
        self.vocoder = "float32" if plain else spec["vocoder"]
        lw = spec["decode_lstm_weights"]
        self.lstm = lw if lw in QMAX else ("float32" if plain else lw)
        self.compute = compute

    def act(self, x):
        return _round_float(x, self.acoustic, None)

    def w(self, x, dim: int = 0):
        """A weight, with fp8's scale per slice along ``dim``'s output."""
        return _round_float(x, self.acoustic,
                            tuple(d for d in range(x.dim()) if d != dim))

    def decode_lstm(self, w_ih, w_hh):
        """The decode loop's gate weight [4H, in + H]."""
        w = torch.cat([w_ih, w_hh], dim=1)
        if self.lstm in QMAX:
            return quantize_rows(_round_float(w, self.compute, None),
                                 self.lstm)
        return _round_float(w, self.lstm, (1,))

    def voc(self, x):
        """A vocoder tensor, activation or weight."""
        return _round_float(x, self.vocoder, None)


# -- acoustic model --------------------------------------------------------

def _lstm_step(W, b, x, h, c, act):
    gates = torch.cat([x, h], dim=-1) @ W.t() + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return act(h), act(c)


def _bn(x, p, s):
    return ((x - s["mean"][None, :, None])
            / torch.sqrt(s["var"][None, :, None] + BN_EPS)
            * p["scale"][None, :, None] + p["bias"][None, :, None])


def _bilstm(p, x, lengths, prec: Precision):
    """x [k, T, D] -> [k, T, 2H]; each direction reads a row within its
    length; outputs past the length are zero."""
    k, T, _ = x.shape
    t = torch.arange(T, device=x.device)[None, :]
    L = lengths[:, None]
    valid = t < L
    rev = torch.where(valid, L - 1 - t, t)                      # [k, T]
    outs = []
    for d, seq in (("fwd", x), ("bwd", torch.gather(
            x, 1, rev[:, :, None].expand_as(x)))):
        W = prec.w(torch.cat([p[d]["w_ih"], p[d]["w_hh"]], dim=1))
        b = p[d]["b_ih"] + p[d]["b_hh"]
        H = p[d]["w_hh"].shape[1]
        h = x.new_zeros(k, H)
        c = x.new_zeros(k, H)
        ys = []
        for i in range(T):
            h, c = _lstm_step(W, b, seq[:, i], h, c, prec.act)
            ys.append(h)
        y = torch.stack(ys, dim=1)
        if d == "bwd":
            y = torch.gather(y, 1, rev[:, :, None].expand_as(y))
        outs.append(y)
    return torch.cat(outs, dim=-1) * valid[:, :, None]


def encode(P, bn, stream: str, ids, lengths, cls, prec: Precision):
    """One stream's memory [k, T, E]: ``stream`` is "" (phones) or "_sub";
    ids [k, T] padded with 0, lengths [k], cls [k, 768]."""
    x = prec.act(P["embedding" + stream][ids]).transpose(1, 2)
    enc = P["encoder" + stream]
    for layer, st in zip(enc["convs"], bn["encoder" + stream]):
        w = prec.w(layer["conv"]["w"])
        y = F.conv1d(x, w, layer["conv"]["b"], padding=(w.shape[-1] - 1) // 2)
        x = prec.act(torch.relu(_bn(y, layer["bn"], st)))
    h = _bilstm(enc["lstm"], x.transpose(1, 2), lengths, prec)
    fused = torch.cat([h, cls[:, None, :].expand(-1, h.shape[1], -1)], -1)
    conv = P["linear_converter" + stream]
    return prec.act(fused @ prec.w(conv["w"], 1) + conv["b"])


def _sma(p, q, mem, pmem, mask, align, prec):
    e = (torch.tanh((q @ prec.w(p["query"]["w"], 1))[:, None, :] + pmem)
         @ prec.w(p["v"]["w"], 1))[..., 0]
    pr = torch.sigmoid(prec.act(e).masked_fill(~mask, MASK_ENERGY))
    moved = align[:, :-1] * (1.0 - pr[:, :-1])
    align = prec.act(align * pr + F.pad(moved, (1, 0)))
    return prec.act(torch.einsum("kt,ktd->kd", align, mem)), align


def _lsa(p, q, mem, pmem, mask, w_prev, w_cum, prec):
    lw = prec.w(p["loc_conv"]["w"])
    loc = F.conv1d(torch.stack([w_prev, w_cum], dim=1), lw,
                   padding=(lw.shape[-1] - 1) // 2)          # [k, F, T]
    feat = prec.act(loc.transpose(1, 2) @ prec.w(p["loc_dense"]["w"], 1))
    e = (torch.tanh((q @ prec.w(p["query"]["w"], 1))[:, None, :] + pmem
                    + feat) @ prec.w(p["v"]["w"], 1))[..., 0]
    w = prec.act(torch.softmax(e.masked_fill(~mask, MASK_ENERGY), dim=-1))
    return prec.act(torch.einsum("kt,ktd->kd", w, mem)), w


def decode_teacher_forced(P, t: dict, memory, memory_b, lengths, sub_lengths,
                          frames, n_steps: int,
                          masks: Callable[[int], torch.Tensor],
                          prec: Precision):
    """The decoder run for ``n_steps`` steps on the given frames: step s
    reads frame s - 1 of ``frames`` [k, n_mels, >= n_steps - 1] (zeros at
    s = 0) and ``masks(s)`` [4, k, prenet_dim] of 0 / 2 (phone prenet's two
    layers, then the subword prenet's).  Returns the mel [k, n_mels,
    n_steps] and gate logits [k, n_steps] that each step predicts."""
    d = P["decoder"]
    k = memory.shape[0]
    lsa = t["attention"] == "LocationSensitiveAttention"
    streams = []
    for mem, lens, name in ((memory, lengths, ""), (memory_b, sub_lengths,
                                                    "_bert")):
        T = mem.shape[1]
        att = d["attention" + name]
        streams.append({
            "mem": mem, "att": att,
            "pmem": prec.act(mem @ prec.w(att["memory"]["w"], 1)),
            "mask": torch.arange(T, device=mem.device)[None, :] < lens[:, None],
            "W": prec.decode_lstm(d["attention_rnn" + name]["w_ih"],
                                  d["attention_rnn" + name]["w_hh"]),
            "b": (d["attention_rnn" + name]["b_ih"]
                  + d["attention_rnn" + name]["b_hh"]),
            "pre": [prec.w(l["w"], 1) for l in d["prenet" + name]],
            "h": mem.new_zeros(k, t["attention_rnn_dim"]),
            "c": mem.new_zeros(k, t["attention_rnn_dim"]),
            "ctx": mem.new_zeros(k, mem.shape[2]),
            "w": mem.new_zeros(k, T), "w_cum": mem.new_zeros(k, T),
            "align": F.one_hot(torch.zeros(k, dtype=torch.long, device=mem.device),
                               T).float()})
    Wd = prec.decode_lstm(d["decoder_rnn"]["w_ih"], d["decoder_rnn"]["w_hh"])
    bd = d["decoder_rnn"]["b_ih"] + d["decoder_rnn"]["b_hh"]
    h_dec = memory.new_zeros(k, t["decoder_rnn_dim"])
    c_dec = memory.new_zeros(k, t["decoder_rnn_dim"])
    Wp, bp = prec.w(d["linear_projection"]["w"], 1), d["linear_projection"]["b"]
    Wg, bg = prec.w(d["gate_layer"]["w"], 1), d["gate_layer"]["b"]
    mels, gates = [], []
    prev = memory.new_zeros(k, frames.shape[1])
    for s in range(n_steps):
        m = masks(s)
        if s > 0:
            prev = frames[:, :, s - 1]
        for j, st in enumerate(streams):
            x = prev
            for li, w in enumerate(st["pre"]):
                x = prec.act(torch.relu(x @ w) * m[2 * j + li])
            st["h"], st["c"] = _lstm_step(st["W"], st["b"],
                                          torch.cat([x, st["ctx"]], -1),
                                          st["h"], st["c"], prec.act)
        for st in streams:
            if lsa:
                st["ctx"], w = _lsa(st["att"], st["h"], st["mem"], st["pmem"],
                                    st["mask"], st["w"], st["w_cum"], prec)
                st["w"], st["w_cum"] = w, st["w_cum"] + w
            else:
                st["ctx"], st["align"] = _sma(st["att"], st["h"], st["mem"],
                                              st["pmem"], st["mask"],
                                              st["align"], prec)
        a, b = streams
        h_dec, c_dec = _lstm_step(
            Wd, bd, torch.cat([a["h"], a["ctx"], b["h"], b["ctx"]], -1),
            h_dec, c_dec, prec.act)
        hc = torch.cat([h_dec, a["ctx"], b["ctx"]], -1)
        mels.append(prec.act(hc @ Wp + bp))
        gates.append(prec.act(hc @ Wg + bg)[:, 0])
    return torch.stack(mels, dim=2), torch.stack(gates, dim=1)


def postnet(P, bn, mel, prec: Precision):
    """mel [k, n_mels, T] -> mel + the postnet's residual."""
    x = mel
    layers = P["postnet"]
    for i, (layer, st) in enumerate(zip(layers, bn["postnet"])):
        w = prec.w(layer["conv"]["w"])
        y = _bn(F.conv1d(x, w, layer["conv"]["b"],
                         padding=(w.shape[-1] - 1) // 2), layer["bn"], st)
        x = prec.act(torch.tanh(y) if i < len(layers) - 1 else y)
    return mel + x


# -- HiFi-GAN --------------------------------------------------------------

def _pad(k: int, d: int = 1) -> int:
    return (k * d - d) // 2


def hifigan(G, h: dict, mel, prec: Precision):
    """mel [k, n_mels, T] -> waveform [k, T * prod(upsample_rates)]."""
    conv = lambda p, x, d=1: prec.voc(F.conv1d(
        prec.voc(x), prec.voc(p["w"]), p["b"], dilation=d,
        padding=_pad(p["w"].shape[-1], d)))
    x = conv(G["conv_pre"], mel)
    nk = len(h["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        up = G["ups"][i]
        x = prec.voc(F.conv_transpose1d(
            prec.voc(F.leaky_relu(x, 0.1)), prec.voc(up["w"]), up["b"],
            stride=u, padding=(k - u) // 2))
        acc = 0
        for j in range(nk):
            rb, dil = G["resblocks"][i * nk + j], h["resblock_dilation_sizes"][j]
            y = x
            if h["resblock"] == "1":
                for c1, c2, d in zip(rb["convs1"], rb["convs2"], dil):
                    y = conv(c2, F.leaky_relu(conv(c1, F.leaky_relu(y, 0.1), d),
                                              0.1)) + y
            else:
                for c, d in zip(rb["convs"], dil):
                    y = conv(c, F.leaky_relu(y, 0.1), d) + y
            acc = acc + y
        x = prec.voc(acc / nk)
    return torch.tanh(conv(G["conv_post"], F.leaky_relu(x, 0.01)))[:, 0]


VOCODE_ROWS = 8   # rows a generator call, so that it fits beside the rest


def vocode(G, cfg: dict, mel, rows, batch: int, frames: int,
           prec: Precision, generator):
    """The check's vocoder stage (``judge``): mel [k, n_mels, frames] of
    the kept rows -> waveforms [k, frames * prod(upsample_rates)], the
    generator run over groups of VOCODE_ROWS rows.  HiFi-GAN draws no
    random numbers: ``generator`` is never called, and ``rows`` and
    ``batch`` are not read."""
    h = cfg["hifigan"]
    return torch.cat([hifigan(G, h, mel[i:i + VOCODE_ROWS], prec)
                      for i in range(0, mel.shape[0], VOCODE_ROWS)])


def bucket(mel_postnet, n_frames, pad_to: int, floor: float):
    """The vocoder's input: each row's first ``n_frames`` frames of
    ``mel_postnet`` [k, n_mels, >= n], then ``floor`` up to ``pad_to``."""
    k, M, _ = mel_postnet.shape
    out = mel_postnet.new_full((k, M, pad_to), floor)
    for i, n in enumerate(n_frames):
        out[i, :, :n] = mel_postnet[i, :, :n]
    return out
