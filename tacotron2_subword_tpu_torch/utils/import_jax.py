"""Weight bridge: the JAX package's parameter trees -> the port's tensors.

Both packages keep one set of layouts, so the bridge moves arrays and checks
shapes; it transposes nothing.  It takes the JAX pytrees as nested dicts and
lists of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and
needs no JAX itself.

Layout rules (shared by both packages):
 - Linear: ``w`` [in, out], ``b`` [out]  (y = x @ w + b; torch's nn.Linear
   stores [out, in]);
 - Conv1d: ``w`` OIH [out, in, k], ``b`` [out], activations NCH;
 - ConvTranspose1d: ``w`` [in, out, k] as torch;
 - LSTM cell: ``w_ih`` [4H, in], ``w_hh`` [4H, H], ``b_ih`` / ``b_hh`` [4H],
   gate order (i, f, g, o) as torch;
 - BatchNorm: params ``scale`` / ``bias``, state ``mean`` / ``var``;
 - weight norm: ``v`` and ``g`` (norm over every dim but 0), or a fused ``w``.
"""

from __future__ import annotations

import numpy as np
import torch

from tacotron2_subword_tpu_torch.config import TacotronConfig
from tacotron2_subword_tpu_torch.models.hifigan import (
    PERIOD_DISC_CHANNELS, PERIODS, SCALE_DISC_SPEC, HifiganConfig)
from tacotron2_subword_tpu_torch.models.waveglow import WaveGlowConfig
from tacotron2_subword_tpu_torch.utils.platform import resolve_device
from tacotron2_subword_tpu_torch.utils.tree import tree_map


def _tensors(tree, device):
    def conv(a):
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = a.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return tree_map(conv, tree)


def _expect(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)} (see the layout rules)")


def tacotron2_params_from_numpy(params, bn_state, cfg: TacotronConfig,
                                device="cuda"):
    """(params, bn_state) of the JAX package, as numpy trees -> the port's
    (params, bn_state) on ``device``, with the layouts checked against
    ``cfg``."""
    device = resolve_device(device)
    p, bn = _tensors(params, device), _tensors(bn_state, device)
    E, D = cfg.encoder_embedding_dim, cfg.symbols_embedding_dim
    Ar, Dr = cfg.attention_rnn_dim, cfg.decoder_rnn_dim
    _expect("embedding", p["embedding"], (cfg.n_symbols, D))
    _expect("embedding_sub", p["embedding_sub"], (cfg.sub_n_symbols, D))
    for enc in ("encoder", "encoder_sub"):
        conv = p[enc]["convs"][0]["conv"]["w"]
        _expect(f"{enc}.convs.0.conv.w", conv,
                (E, D, cfg.encoder_kernel_size))
        _expect(f"{enc}.lstm.fwd.w_ih", p[enc]["lstm"]["fwd"]["w_ih"],
                (4 * (E // 2), E))
    for conv in ("linear_converter", "linear_converter_sub"):
        _expect(f"{conv}.w", p[conv]["w"], (E + cfg.bert_embedding_dim, E))
    dp = p["decoder"]
    for rnn in ("attention_rnn", "attention_rnn_bert"):
        _expect(f"decoder.{rnn}.w_ih", dp[rnn]["w_ih"],
                (4 * Ar, cfg.prenet_dim + E))
    _expect("decoder.decoder_rnn.w_ih", dp["decoder_rnn"]["w_ih"],
            (4 * Dr, 2 * Ar + 2 * E))
    _expect("decoder.linear_projection.w", dp["linear_projection"]["w"],
            (Dr + 2 * E, cfg.n_mel_channels * cfg.n_frames_per_step))
    # the attention's query-side layer: "W" for DCA, "mlp1" for GMM
    q = {"DynamicConvolutionAttention": "W",
         "GMMAttention": "mlp1"}.get(cfg.attention, "query")
    _expect(f"decoder.attention.{q}.w", dp["attention"][q]["w"],
            (Ar, cfg.attention_dim))
    _expect("postnet.0.conv.w", p["postnet"][0]["conv"]["w"],
            (cfg.postnet_embedding_dim, cfg.n_mel_channels,
             cfg.postnet_kernel_size))
    return p, bn


def adam_state_from_numpy(count, mu, nu, params, device="cuda"):
    """optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``; numpy, the
    moments over the params' tree) -> the port's ``train_lib.AdamState`` on
    ``device``, each moment checked against the matching leaf of the
    port's ``params``.  With it a JAX train state and the port's take the
    same next step."""
    from tacotron2_subword_tpu_torch.train_lib import AdamState
    device = resolve_device(device)
    m, v = _tensors(mu, device), _tensors(nu, device)
    for name, tree in (("mu", m), ("nu", v)):
        tree_map(lambda a, p: _expect(name, a, p.shape), tree, params)
    c = torch.tensor(int(np.asarray(count)), dtype=torch.int32, device=device)
    return AdamState(c, m, v)


def hifigan_params_from_numpy(params, h: HifiganConfig, device="cuda"):
    """HiFi-GAN generator params of the JAX package (weight-normed or
    fused), as a numpy tree -> the port's params on ``device``."""
    device = resolve_device(device)
    p = _tensors(params, device)
    pre = p["conv_pre"]
    w = pre["w"] if "w" in pre else pre["v"]
    _expect("conv_pre", w, (h.upsample_initial_channel, h.num_mels, 7))
    for i, k in enumerate(h.upsample_kernel_sizes):
        up = p["ups"][i]
        w = up["w"] if "w" in up else up["v"]
        _expect(f"ups.{i}", w, (h.upsample_initial_channel // 2 ** i,
                                h.upsample_initial_channel // 2 ** (i + 1), k))
    n_rb = len(h.upsample_rates) * len(h.resblock_kernel_sizes)
    if len(p["resblocks"]) != n_rb:
        raise ValueError(f"resblocks: {len(p['resblocks'])}, expected {n_rb}")
    return p


def hifigan_discriminators_from_numpy(params, device="cuda"):
    """MPD + MSD params of the JAX package (``init_discriminators``'
    tree), as a numpy tree -> the port's tree on ``device``, every
    weight-norm ``v`` and ``g`` checked against the layer it feeds."""
    device = resolve_device(device)
    p = _tensors(params, device)
    if len(p["mpd"]) != len(PERIODS) or len(p["msd"]) != 3:
        raise ValueError(f"{len(p['mpd'])} period / {len(p['msd'])} scale "
                         f"discriminators, expected {len(PERIODS)} / 3")

    def wn(name, q, shape):
        _expect(f"{name}.v", q["v"], shape)
        _expect(f"{name}.g", q["g"], (shape[0],) + (1,) * (len(shape) - 1))
        _expect(f"{name}.b", q["b"], shape[:1])

    for n, d in enumerate(p["mpd"]):
        for i, (cin, cout) in enumerate(PERIOD_DISC_CHANNELS):
            wn(f"mpd.{n}.convs.{i}", d["convs"][i], (cout, cin, 5, 1))
        wn(f"mpd.{n}.conv_post", d["conv_post"], (1, 1024, 3, 1))
    for n, d in enumerate(p["msd"]):
        for i, (cin, cout, k, _, g, _) in enumerate(SCALE_DISC_SPEC):
            wn(f"msd.{n}.convs.{i}", d["convs"][i], (cout, cin // g, k))
        wn(f"msd.{n}.conv_post", d["conv_post"], (1, 1024, 3))
    return p


def optax_adam_state_from_numpy(opt_state, params, device="cuda"):
    """The state of ``optax.adam(lr_or_schedule, ...)`` as a numpy tree:
    (ScaleByAdamState(count, mu, nu), EmptyState() or
    ScaleByScheduleState(count)) -> the port's ``train_lib.AdamState``
    (each moment checked against ``params``).  The port's schedule reads
    Adam's count: optax's two counters move together, and a state where
    they differ raises."""
    adam, sched = opt_state
    if "count" in getattr(sched, "_fields", ()) and int(
            np.asarray(sched.count)) != int(np.asarray(adam.count)):
        raise ValueError(f"schedule count {int(np.asarray(sched.count))} "
                         f"!= Adam count {int(np.asarray(adam.count))}")
    return adam_state_from_numpy(adam.count, adam.mu, adam.nu, params,
                                 device=device)


def waveglow_params_from_numpy(params, cfg: WaveGlowConfig, device="cuda"):
    """WaveGlow params of the JAX package (``init_waveglow``'s tree, or
    ``import_torch_waveglow``'s, weight-normed or fused), as a numpy tree ->
    the port's params on ``device``, each flow's widths checked against
    ``cfg``."""
    device = resolve_device(device)
    p = _tensors(params, device)
    M, C, L = cfg.n_mel_channels, cfg.wn_channels, cfg.wn_layers
    _expect("upsample.w", p["upsample"]["w"], (M, M, cfg.upsample_kernel))
    if len(p["convinv"]) != cfg.n_flows or len(p["wn"]) != cfg.n_flows:
        raise ValueError(f"{len(p['convinv'])} convinv / {len(p['wn'])} WN, "
                         f"expected {cfg.n_flows} flows")

    def weight(q):
        return q["w"] if "w" in q else q["v"]

    n_rem = cfg.n_group
    for k, (inv, wn) in enumerate(zip(p["convinv"], p["wn"])):
        if k % cfg.n_early_every == 0 and k > 0:
            n_rem -= cfg.n_early_size
        _expect(f"convinv.{k}.w", inv["w"], (n_rem, n_rem))
        _expect(f"wn.{k}.start", weight(wn["start"]), (C, n_rem // 2, 1))
        _expect(f"wn.{k}.end", weight(wn["end"]), (2 * (n_rem // 2), C, 1))
        _expect(f"wn.{k}.cond", weight(wn["cond"]),
                (2 * C * L, M * cfg.n_group, 1))
        if len(wn["in_layers"]) != L or len(wn["res_skip"]) != L:
            raise ValueError(f"wn.{k}: {len(wn['in_layers'])} layers, "
                             f"expected {L}")
        for i in range(L):
            _expect(f"wn.{k}.in_layers.{i}", weight(wn["in_layers"][i]),
                    (2 * C, C, cfg.wn_kernel_size))
            _expect(f"wn.{k}.res_skip.{i}", weight(wn["res_skip"][i]),
                    (2 * C if i < L - 1 else C, C, 1))
    return p
