"""Random weights of a configuration, made on the device from the seed.

One ``torch.rand`` call on a generator on the device fills a flat f32
buffer; each leaf is a view of it, mapped to U(lo, hi) by its own bounds.
The leaves are named by dotted paths ("decoder.attention_rnn.w_ih"); a
numeric part is a list index.  ``nest`` builds the tree of dicts and lists
that both the program's adapter and the reference read.  Layouts: linear
``w`` [in, out]; conv ``w`` [out, in, k]; transposed conv ``w`` [in, out, k];
LSTM ``w_ih`` [4H, in], ``w_hh`` [4H, H] with gates (i, f, g, o).

Bounds: the Tacotron 2 reference's initialisers (Xavier-uniform with its
gains, torch's LSTM and linear defaults); BatchNorm's running statistics
and affine terms drawn near their initial values so that the
normalisation's arithmetic is exercised.  The vocoder's leaves ("gen.*")
and their bounds are its part's (``vocoders/<name>.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], float, float]   # name, shape, lo, hi

GAINS = {"linear": 1.0, "sigmoid": 1.0, "tanh": 5.0 / 3.0,
         "relu": math.sqrt(2.0)}


def _sym(b: float) -> Tuple[float, float]:
    return -b, b


def _xavier(fan_in: int, fan_out: int, gain: str) -> Tuple[float, float]:
    return _sym(GAINS[gain] * math.sqrt(6.0 / (fan_in + fan_out)))


def _linear(out: List[Spec], name: str, n_in: int, n_out: int,
            gain: str = "linear", bias: bool = True) -> None:
    out.append((f"{name}.w", (n_in, n_out), *_xavier(n_in, n_out, gain)))
    if bias:
        out.append((f"{name}.b", (n_out,), *_sym(1.0 / math.sqrt(n_in))))


def _conv(out: List[Spec], name: str, c_in: int, c_out: int, k: int,
          gain: str = "linear") -> None:
    out.append((f"{name}.w", (c_out, c_in, k),
                *_xavier(c_in * k, c_out * k, gain)))
    out.append((f"{name}.b", (c_out,), *_sym(1.0 / math.sqrt(c_in * k))))


def _bn(out: List[Spec], pname: str, sname: str, c: int) -> None:
    out += [(f"{pname}.scale", (c,), 0.8, 1.2),
            (f"{pname}.bias", (c,), -0.1, 0.1),
            (f"{sname}.mean", (c,), -0.1, 0.1),
            (f"{sname}.var", (c,), 0.6, 1.4)]


def _lstm(out: List[Spec], name: str, n_in: int, h: int) -> None:
    b = _sym(1.0 / math.sqrt(h))
    out += [(f"{name}.w_ih", (4 * h, n_in), *b),
            (f"{name}.w_hh", (4 * h, h), *b),
            (f"{name}.b_ih", (4 * h,), *b),
            (f"{name}.b_hh", (4 * h,), *b)]


def tacotron_specs(t: dict) -> List[Spec]:
    """Leaves "params.*" and "bn.*" of the dual-stream Tacotron 2 whose
    sizes ``t`` holds (the config file's "tacotron" group)."""
    s: List[Spec] = []
    E, C = t["encoder_embedding_dim"], t["symbols_embedding_dim"]
    emb = _sym(math.sqrt(3.0) * math.sqrt(2.0 / (t["n_symbols"] + C)))
    s.append(("params.embedding", (t["n_symbols"], C), *emb))
    s.append(("params.embedding_sub", (t["sub_n_symbols"], C), *emb))
    for enc in ("encoder", "encoder_sub"):
        for i in range(t["encoder_n_convolutions"]):
            _conv(s, f"params.{enc}.convs.{i}.conv", E, E,
                  t["encoder_kernel_size"], "relu")
            _bn(s, f"params.{enc}.convs.{i}.bn", f"bn.{enc}.{i}", E)
        for d in ("fwd", "bwd"):
            _lstm(s, f"params.{enc}.lstm.{d}", E, E // 2)
    for conv in ("linear_converter", "linear_converter_sub"):
        _linear(s, f"params.{conv}", E + t["bert_embedding_dim"], E)
    M, P = t["n_mel_channels"] * t["n_frames_per_step"], t["prenet_dim"]
    Ar, D, A = t["attention_rnn_dim"], t["decoder_rnn_dim"], t["attention_dim"]
    dec = "params.decoder"
    for pre in ("prenet", "prenet_bert"):
        _linear(s, f"{dec}.{pre}.0", M, P, bias=False)
        _linear(s, f"{dec}.{pre}.1", P, P, bias=False)
    for rnn in ("attention_rnn", "attention_rnn_bert"):
        _lstm(s, f"{dec}.{rnn}", P + E, Ar)
    lsa = t["attention"] == "LocationSensitiveAttention"
    if t["attention"] not in ("LocationSensitiveAttention",
                              "StepwiseMonotonicAttention"):
        raise ValueError(f"attention {t['attention']!r} has no reference")
    for att in ("attention", "attention_bert"):
        _linear(s, f"{dec}.{att}.memory", E, A, "tanh", bias=False)
        _linear(s, f"{dec}.{att}.query", Ar, A, "tanh", bias=False)
        if lsa:
            _linear(s, f"{dec}.{att}.v", A, 1, bias=False)
            F, k = (t["attention_location_n_filters"],
                    t["attention_location_kernel_size"])
            s.append((f"{dec}.{att}.loc_conv.w", (F, 2, k),
                      *_xavier(2 * k, F * k, "linear")))
            _linear(s, f"{dec}.{att}.loc_dense", F, A, "tanh", bias=False)
        else:   # SMA's v is torch's default nn.Linear init
            s.append((f"{dec}.{att}.v.w", (A, 1), *_sym(1.0 / math.sqrt(A))))
    _lstm(s, f"{dec}.decoder_rnn", 2 * Ar + 2 * E, D)
    _linear(s, f"{dec}.linear_projection", D + 2 * E, M)
    _linear(s, f"{dec}.gate_layer", D + 2 * E, 1, "sigmoid")
    n = t["postnet_n_convolutions"]
    for i in range(n):
        c_in = t["n_mel_channels"] if i == 0 else t["postnet_embedding_dim"]
        c_out = (t["n_mel_channels"] if i == n - 1
                 else t["postnet_embedding_dim"])
        _conv(s, f"params.postnet.{i}.conv", c_in, c_out,
              t["postnet_kernel_size"], "linear" if i == n - 1 else "tanh")
        _bn(s, f"params.postnet.{i}.bn", f"bn.postnet.{i}", c_out)
    return s


def make(specs: List[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``specs`` from one draw of a generator on ``device``
    seeded with ``seed``: {name: f32 tensor}."""
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    flat = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, lo, hi in specs:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(hi - lo).add_(lo)
        at += n
    return out


def nest(flat: Dict[str, torch.Tensor], prefix: str):
    """The tree under ``prefix`` of dotted leaf names: dicts, and lists
    where every key of a level is a number."""
    root: dict = {}
    for name, t in flat.items():
        if not name.startswith(prefix + "."):
            continue
        node, parts = root, name[len(prefix) + 1:].split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(root)
