"""Import reference PyTorch checkpoints into the port's parameter tree.

Counterpart of ``tacotron2_subword_tpu/utils/import_torch.py``: maps the
reference BERT_Tacotron2 ``state_dict`` layout (reference model.py:494-515
module names; train.py:116-123 checkpoint dict format) onto the nested-dict
params + batchnorm state that both packages share (layout rules in
``utils/import_jax.py``): torch Linear stores [out, in], the tree keeps
[in, out] (transposed); Conv1d and LSTM layouts match directly.  The tree is
built as numpy and handed to ``tacotron2_params_from_numpy``, which checks
its shapes against the config and moves it to the device.

Each attention variant reads its own keys.  ContentAttention reads its
``query_layer`` and ``v`` (LinearNorm), which the JAX package's importer
leaves out.  ``waveglow_params_from_torch_state_dict`` reads the three
WaveGlow layouts of the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from tacotron2_subword_tpu_torch.config import TacotronConfig
from tacotron2_subword_tpu_torch.models.attention import (READS_WEIGHTS,
                                                          _check_variant)
from tacotron2_subword_tpu_torch.models.waveglow import WaveGlowConfig
from tacotron2_subword_tpu_torch.nn.layers import weight_norm_weight
from tacotron2_subword_tpu_torch.utils.import_jax import (
    tacotron2_params_from_numpy, waveglow_params_from_numpy)


def _a(sd: Mapping[str, Any], key: str) -> np.ndarray:
    return np.asarray(sd[key], dtype=np.float32)


def _lin(sd, prefix) -> Dict[str, np.ndarray]:
    """LinearNorm: '{prefix}.linear_layer.weight' [out,in] (+ optional bias)."""
    p = {"w": _a(sd, f"{prefix}.linear_layer.weight").T}
    if f"{prefix}.linear_layer.bias" in sd:
        p["b"] = _a(sd, f"{prefix}.linear_layer.bias")
    return p


def _plain_lin(sd, prefix) -> Dict[str, np.ndarray]:
    """torch.nn.Linear: '{prefix}.weight' (+ optional '.bias')."""
    p = {"w": _a(sd, f"{prefix}.weight").T}
    if f"{prefix}.bias" in sd:
        p["b"] = _a(sd, f"{prefix}.bias")
    return p


def _conv(sd, prefix) -> Dict[str, np.ndarray]:
    """ConvNorm: '{prefix}.conv.weight' [out,in,k] (+ optional bias)."""
    p = {"w": _a(sd, f"{prefix}.conv.weight")}
    if f"{prefix}.conv.bias" in sd:
        p["b"] = _a(sd, f"{prefix}.conv.bias")
    return p


def _bn(sd, prefix):
    params = {"scale": _a(sd, f"{prefix}.weight"),
              "bias": _a(sd, f"{prefix}.bias")}
    state = {"mean": _a(sd, f"{prefix}.running_mean"),
             "var": _a(sd, f"{prefix}.running_var")}
    return params, state


def _lstm_cell(sd, prefix):
    return {k: _a(sd, f"{prefix}.{name}")
            for k, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                            ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))}


def _bilstm(sd, prefix):
    return {direction: {
        "w_ih": _a(sd, f"{prefix}.weight_ih_l0{suffix}"),
        "w_hh": _a(sd, f"{prefix}.weight_hh_l0{suffix}"),
        "b_ih": _a(sd, f"{prefix}.bias_ih_l0{suffix}"),
        "b_hh": _a(sd, f"{prefix}.bias_hh_l0{suffix}")}
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse"))}


def _conv_bn_stack(sd, prefix, n_convs):
    layers, bns = [], []
    for i in range(n_convs):
        bn_p, bn_s = _bn(sd, f"{prefix}.convolutions.{i}.1")
        layers.append({"conv": _conv(sd, f"{prefix}.convolutions.{i}.0"),
                       "bn": bn_p})
        bns.append(bn_s)
    return layers, bns


def _encoder(sd, prefix, n_convs):
    convs, bns = _conv_bn_stack(sd, prefix, n_convs)
    return {"convs": convs, "lstm": _bilstm(sd, f"{prefix}.lstm")}, bns


def _attention(sd, prefix, variant: str):
    """One stream's attention weights, in ``attention_init``'s tree."""
    _check_variant(variant)
    p = {"memory": _lin(sd, f"{prefix}.memory_layer")}
    if variant == "DynamicConvolutionAttention":
        p["W"] = _plain_lin(sd, f"{prefix}.W")
        p["V"] = _plain_lin(sd, f"{prefix}.V")
        p["F"] = {"w": _a(sd, f"{prefix}.F.weight")}
        for k in ("U", "T", "v"):
            p[k] = _plain_lin(sd, f"{prefix}.{k}")
        p["prior"] = _a(sd, f"{prefix}.P")
    elif variant == "GMMAttention":
        p["mlp1"] = _plain_lin(sd, f"{prefix}.mlp.0")
        p["mlp2"] = _plain_lin(sd, f"{prefix}.mlp.2")
    else:
        p["query"] = _lin(sd, f"{prefix}.query_layer")
        p["v"] = (_plain_lin if variant == "StepwiseMonotonicAttention"
                  else _lin)(sd, f"{prefix}.v")
        if variant in READS_WEIGHTS:
            loc = f"{prefix}.location_layer"
            p["loc_conv"] = {"w": _a(sd, f"{loc}.location_conv.conv.weight")}
            p["loc_dense"] = _lin(sd, f"{loc}.location_dense")
    return p


def params_from_torch_state_dict(sd: Mapping[str, Any], cfg: TacotronConfig,
                                 device="cuda"
                                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A reference state dict (tensors or numpy arrays) → (params,
    bn_state) in the port's tree on ``device``.  A missing key raises
    KeyError."""
    enc, enc_bn = _encoder(sd, "encoder", cfg.encoder_n_convolutions)
    enc_s, enc_s_bn = _encoder(sd, "encoder_sub", cfg.encoder_n_convolutions)
    post, post_bn = _conv_bn_stack(sd, "postnet", cfg.postnet_n_convolutions)
    # The reference builds attention_layer_bert only for SMA
    # (model.py:158-191); without it the phone stream's weights drive both.
    bert_prefix = ("decoder.attention_layer_bert"
                   if any(k.startswith("decoder.attention_layer_bert.")
                          for k in sd) else "decoder.attention_layer")
    dec = {
        "prenet": [_lin(sd, "decoder.prenet.layers.0"),
                   _lin(sd, "decoder.prenet.layers.1")],
        "prenet_bert": [_lin(sd, "decoder.prenet_bert.layers.0"),
                        _lin(sd, "decoder.prenet_bert.layers.1")],
        "attention_rnn": _lstm_cell(sd, "decoder.attention_rnn"),
        "attention_rnn_bert": _lstm_cell(sd, "decoder.attention_rnn_bert"),
        "attention": _attention(sd, "decoder.attention_layer", cfg.attention),
        "attention_bert": _attention(sd, bert_prefix, cfg.attention),
        "decoder_rnn": _lstm_cell(sd, "decoder.decoder_rnn"),
        "linear_projection": _lin(sd, "decoder.linear_projection"),
        "gate_layer": _lin(sd, "decoder.gate_layer"),
    }
    params = {
        "embedding": _a(sd, "embedding.weight"),
        "embedding_sub": _a(sd, "embedding_sub.weight"),
        "encoder": enc,
        "encoder_sub": enc_s,
        "linear_converter": _lin(sd, "linear_converter"),
        "linear_converter_sub": _lin(sd, "linear_converter_sub"),
        "decoder": dec,
        "postnet": post,
    }
    bn_state = {"encoder": enc_bn, "encoder_sub": enc_s_bn,
                "postnet": post_bn}
    return tacotron2_params_from_numpy(params, bn_state, cfg, device=device)


def load_torch_checkpoint(path: str, cfg: TacotronConfig, device="cuda"):
    """Load a reference ``checkpoint_{iter}`` file (train.py:116-123 format:
    {iteration, state_dict, optimizer, val_loss, learning_rate}; tensors
    and plain values only).  Returns (params, bn_state, meta)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    sd = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    params, bn_state = params_from_torch_state_dict(sd, cfg, device=device)
    meta = {k: ckpt[k] for k in ("iteration", "val_loss", "learning_rate")
            if k in ckpt}
    return params, bn_state, meta


def waveglow_params_from_torch_state_dict(sd: Mapping[str, Any],
                                          cfg: WaveGlowConfig,
                                          device="cuda"):
    """A reference WaveGlow state dict (tensors or numpy arrays; the
    reference saves whole model objects, waveglow/train.py:52-60, so take
    their ``.state_dict()``) -> the port's params on ``device``, as the JAX
    package's ``import_torch_waveglow``.  Three layouts are read:
     - the fused per-WN ``cond_layer`` and ``res_skip_layers``
       (reference glow.py:119-152);
     - the vendored one's per-layer ``cond_layers.{i}``
       (waveglow/glow.py:119-152), concatenated along the output channels
       in layer order, the slices ``_wn_apply`` takes;
     - the old split ``res_layers`` / ``skip_layers`` with per-layer
       ``cond_layers.{i}`` (waveglow/glow_old.py:30-64, convert_model.py:
       11-38): res and skip rows concatenated per layer, the last layer
       having no res conv.
    torch's weight norm is per output row, so concatenating v / g / b rows
    is exact.  A missing key raises KeyError."""
    def wn_conv(prefix):
        if f"{prefix}.weight_v" in sd:
            return {"v": _a(sd, f"{prefix}.weight_v"),
                    "g": _a(sd, f"{prefix}.weight_g"),
                    "b": _a(sd, f"{prefix}.bias")}
        return {"w": _a(sd, f"{prefix}.weight"), "b": _a(sd, f"{prefix}.bias")}

    def fused(c):
        if "w" in c:
            return c["w"]
        return weight_norm_weight({k: torch.from_numpy(c[k])
                                   for k in ("v", "g")}).numpy()

    def concat(convs):
        if all("v" in c for c in convs):
            return {k: np.concatenate([c[k] for c in convs])
                    for k in ("v", "g", "b")}
        return {"w": np.concatenate([fused(c) for c in convs]),
                "b": np.concatenate([c["b"] for c in convs])}

    def has(prefix):
        return f"{prefix}.weight_v" in sd or f"{prefix}.weight" in sd

    def cond(k):
        if has(f"WN.{k}.cond_layer"):
            return wn_conv(f"WN.{k}.cond_layer")
        return concat([wn_conv(f"WN.{k}.cond_layers.{i}")
                       for i in range(cfg.wn_layers)])

    def res_skip(k, i):
        if has(f"WN.{k}.res_skip_layers.{i}"):
            return wn_conv(f"WN.{k}.res_skip_layers.{i}")
        skip = wn_conv(f"WN.{k}.skip_layers.{i}")
        if i < cfg.wn_layers - 1:
            return concat([wn_conv(f"WN.{k}.res_layers.{i}"), skip])
        return skip

    params = {"upsample": {"w": _a(sd, "upsample.weight"),
                           "b": _a(sd, "upsample.bias")},
              "convinv": [], "wn": []}
    for k in range(cfg.n_flows):
        params["convinv"].append(
            {"w": _a(sd, f"convinv.{k}.conv.weight")[:, :, 0]})
        params["wn"].append({
            "start": wn_conv(f"WN.{k}.start"),
            "end": {"w": _a(sd, f"WN.{k}.end.weight"),
                    "b": _a(sd, f"WN.{k}.end.bias")},
            "cond": cond(k),
            "in_layers": [wn_conv(f"WN.{k}.in_layers.{i}")
                          for i in range(cfg.wn_layers)],
            "res_skip": [res_skip(k, i) for i in range(cfg.wn_layers)]})
    return waveglow_params_from_numpy(params, cfg, device=device)
