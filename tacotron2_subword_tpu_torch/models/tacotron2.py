"""Dual-stream BERT-Tacotron 2 in PyTorch: inference and teacher-forced
training.

Counterpart of ``tacotron2_subword_tpu/models/tacotron2.py``: two input
streams (phone IDs and subword IDs), each with its own conv + BiLSTM encoder
and its own attention, both conditioned on a BERT [CLS] vector, feeding one
autoregressive mel decoder with a postnet residual.  Parameters are the
JAX package's nested dicts, with the same keys and layouts.

The decoder runs both streams as one stack (stream 0 = phones, 1 =
subwords): the two attention LSTMs are one stacked cell and the subword
memory is zero-padded to the phone stream's length and masked.  With
``cfg.decode_quant == "int8"`` the LSTM weights are quantized once, after
the cast to the compute dtype, and each step's two stacked LSTM matmuls run
on the int8 kernel K1 (ops/quant.py).

Free-running decode stops each sample on its own gate (the stop frame is
included).  The loop reads "all finished" on the host only every
SYNC_EVERY steps; the outputs are masked by each sample's length, so
the steps run after the last sample stopped change nothing.

Teacher-forced training (``forward``) takes all of its randomness
(dropout keep-masks, SMA's noise) from one dict, drawn up front by
``make_randomness`` or given by the caller, so a run can be replayed
exactly.  With ``cfg.custom_decoder_vjp`` the decoder loop's backward is
hand-routed (``_TFScanCustom``): the big LSTM weight gradients are formed
after the loop, as one f32 matmul each.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from tacotron2_subword_tpu_torch.config import TacotronConfig
from tacotron2_subword_tpu_torch.models import attention as A
from tacotron2_subword_tpu_torch.nn import layers as L
from tacotron2_subword_tpu_torch.utils import trace
from tacotron2_subword_tpu_torch.utils.platform import resolve_device
from tacotron2_subword_tpu_torch.utils.tree import (
    cast_floats, to_device, tree_leaves, tree_map, tree_stack, tree_unflatten)

GATE_PAD_VALUE = 1e3
SYNC_EVERY = 16  # decode steps between host reads of "all finished"
PRENET_DROPOUT = 0.5


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool, True at valid positions."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])


def _compute_dtype(cfg: TacotronConfig) -> torch.dtype:
    if cfg.parity_mode or cfg.compute_dtype == "float32":
        return torch.float32
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _encoder_init(gen, cfg: TacotronConfig):
    convs, bns = [], []
    E = cfg.encoder_embedding_dim
    for _ in range(cfg.encoder_n_convolutions):
        bn_p, bn_s = L.batchnorm_init(E)
        convs.append({"conv": L.conv1d_init(gen, E, E, cfg.encoder_kernel_size,
                                            gain="relu"),
                      "bn": bn_p})
        bns.append(bn_s)
    return {"convs": convs, "lstm": L.bilstm_init(gen, E, E // 2)}, bns


def _postnet_init(gen, cfg: TacotronConfig):
    n = cfg.postnet_n_convolutions
    layers, bns = [], []
    for i in range(n):
        in_ch = cfg.n_mel_channels if i == 0 else cfg.postnet_embedding_dim
        out_ch = (cfg.n_mel_channels if i == n - 1
                  else cfg.postnet_embedding_dim)
        conv = L.conv1d_init(gen, in_ch, out_ch, cfg.postnet_kernel_size,
                             gain="linear" if i == n - 1 else "tanh")
        bn_p, bn_s = L.batchnorm_init(out_ch)
        layers.append({"conv": conv, "bn": bn_p})
        bns.append(bn_s)
    return layers, bns


def _prenet_init(gen, cfg: TacotronConfig):
    return [L.linear_init(gen, cfg.n_mel_channels * cfg.n_frames_per_step,
                          cfg.prenet_dim, bias=False),
            L.linear_init(gen, cfg.prenet_dim, cfg.prenet_dim, bias=False)]


def _decoder_init(gen, cfg: TacotronConfig):
    E, Ar = cfg.encoder_embedding_dim, cfg.attention_rnn_dim
    attn = lambda: A.attention_init(gen, cfg.attention, Ar, E,
                                    cfg.attention_dim,
                                    cfg.attention_location_n_filters,
                                    cfg.attention_location_kernel_size)
    hidden_ctx = cfg.decoder_rnn_dim + 2 * E
    return {
        "prenet": _prenet_init(gen, cfg),
        "prenet_bert": _prenet_init(gen, cfg),
        "attention_rnn": L.lstm_cell_init(gen, cfg.prenet_dim + E, Ar),
        "attention_rnn_bert": L.lstm_cell_init(gen, cfg.prenet_dim + E, Ar),
        "attention": attn(),
        "attention_bert": attn(),
        "decoder_rnn": L.lstm_cell_init(gen, 2 * Ar + 2 * E,
                                        cfg.decoder_rnn_dim),
        "linear_projection": L.linear_init(
            gen, hidden_ctx, cfg.n_mel_channels * cfg.n_frames_per_step),
        "gate_layer": L.linear_init(gen, hidden_ctx, 1, gain="sigmoid"),
    }


def init_tacotron2(generator: torch.Generator, cfg: TacotronConfig,
                   device="cuda"):
    """Random (params, bn_state) from the reference's distributions.

    ``generator`` is a CPU generator: the weights are drawn on the host and
    then moved to ``device``, so one seed gives the same weights on every
    device."""
    device = resolve_device(device)
    # reference quirk kept: the subword table reuses the phone table's bound
    std = (2.0 / (cfg.n_symbols + cfg.symbols_embedding_dim)) ** 0.5
    val = (3.0 ** 0.5) * std
    emb = L.uniform(generator, (cfg.n_symbols, cfg.symbols_embedding_dim),
                    val)
    emb_sub = L.uniform(generator,
                        (cfg.sub_n_symbols, cfg.symbols_embedding_dim), val)
    enc, enc_bn = _encoder_init(generator, cfg)
    enc_sub, enc_sub_bn = _encoder_init(generator, cfg)
    conv_in = cfg.encoder_embedding_dim + cfg.bert_embedding_dim
    params = {
        "embedding": emb,
        "embedding_sub": emb_sub,
        "encoder": enc,
        "encoder_sub": enc_sub,
        "linear_converter": L.linear_init(generator, conv_in,
                                          cfg.encoder_embedding_dim),
        "linear_converter_sub": L.linear_init(generator, conv_in,
                                              cfg.encoder_embedding_dim),
        "decoder": _decoder_init(generator, cfg),
    }
    params["postnet"], post_bn = _postnet_init(generator, cfg)
    bn_state = {"encoder": enc_bn, "encoder_sub": enc_sub_bn,
                "postnet": post_bn}
    return to_device(params, device), to_device(bn_state, device)


# ---------------------------------------------------------------------------
# Sub-modules
# ---------------------------------------------------------------------------

def encoder_apply(params, bn_state, x: torch.Tensor,
                  lengths: Optional[torch.Tensor], *, training: bool = False,
                  masks: Optional[List[torch.Tensor]] = None, mesh=None):
    """x [B, C, T] embedded inputs -> ([B, T, C], new BN state): 3x
    conv/BN/ReLU (with dropout 0.5 on ``masks`` in training), then the
    length-exact BiLSTM.  In eval the BN state is returned as given.  In
    training, BN takes its statistics over ``mesh``'s data axis."""
    new_bn = []
    for i, layer in enumerate(params["convs"]):
        y = L.conv1d_apply(layer["conv"], x)
        if training:
            y, bn_s = L.batchnorm_apply(layer["bn"], bn_state[i], y, True,
                                        mesh=mesh)
            y = L.dropout(torch.relu(y), 0.5, masks[i])
        else:
            bn_s = bn_state[i]
            y = torch.relu(L.batchnorm_apply(layer["bn"], bn_s, y))
        new_bn.append(bn_s)
        x = y
    return L.bilstm_apply(params["lstm"], x.transpose(1, 2), lengths), new_bn


def prenet_apply(params, x: torch.Tensor, masks=None) -> torch.Tensor:
    """2x (linear -> ReLU -> dropout 0.5).  ``masks`` gives one scaled
    keep-mask per layer (the reference keeps this dropout on even in
    inference); None means no dropout."""
    for i, p in enumerate(params):
        x = torch.relu(L.linear_apply(p, x))
        if masks is not None:
            x = x * masks[i]
    return x


def _prenet_masks(generator, n: int, shape, dtype, device) -> torch.Tensor:
    """n scaled keep-masks [n, *shape] in one draw."""
    return _scaled(L.keep_mask((n, *shape), PRENET_DROPOUT, generator,
                               device), PRENET_DROPOUT, dtype)


def postnet_apply(params, bn_state, x: torch.Tensor, *,
                  training: bool = False,
                  masks: Optional[List[torch.Tensor]] = None, mesh=None):
    """x [B, n_mels, T] -> (residual [B, n_mels, T], new BN state): 5 convs
    with BN, tanh on all but the last, dropout 0.5 on ``masks`` after every
    layer in training (BN's statistics over ``mesh``'s data axis)."""
    n = len(params)
    new_bn = []
    for i, layer in enumerate(params):
        y = L.conv1d_apply(layer["conv"], x)
        if training:
            y, bn_s = L.batchnorm_apply(layer["bn"], bn_state[i], y, True,
                                        mesh=mesh)
        else:
            bn_s = bn_state[i]
            y = L.batchnorm_apply(layer["bn"], bn_s, y)
        if i < n - 1:
            y = torch.tanh(y)
        if training:
            y = L.dropout(y, 0.5, masks[i])
        new_bn.append(bn_s)
        x = y
    return x, new_bn


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class DecoderCarry(NamedTuple):
    """Decoder state, the two attention streams stacked on axis 0."""
    h_att: torch.Tensor      # [2, B, attention_rnn_dim]
    c_att: torch.Tensor      # [2, B, attention_rnn_dim]
    h_dec: torch.Tensor      # [B, decoder_rnn_dim]
    c_dec: torch.Tensor      # [B, decoder_rnn_dim]
    ctx: torch.Tensor        # [2, B, encoder_embedding_dim]
    # the previous and the cumulative weights [2, B, T]; None for the
    # variants that do not read them (A.READS_WEIGHTS)
    w: Optional[torch.Tensor]
    w_cum: Optional[torch.Tensor]
    att_state: Dict[str, torch.Tensor]  # leaves stacked on axis 0


def _stack_stream_params(dp, quant: str = ""):
    """(attention LSTMs stacked and prepared, attention params stacked,
    decoder LSTM prepared); with ``quant="int8"`` both LSTM weights are
    quantized (the decoder LSTM as a stack of one)."""
    rnn_s = tree_stack([L.lstm_prepare(dp["attention_rnn"]),
                        L.lstm_prepare(dp["attention_rnn_bert"])])
    att_s = tree_stack([dp["attention"], dp["attention_bert"]])
    dec = L.lstm_prepare(dp["decoder_rnn"])
    if quant == "int8":
        rnn_s = L.lstm_quantize_stacked(rnn_s)
        dec = L.lstm_quantize_stacked({k: v[None] for k, v in dec.items()})
    elif quant:
        raise ValueError(f"unknown decode_quant {quant!r}")
    return rnn_s, att_s, dec


def _pad_T(x: torch.Tensor, T: int, axis: int = -1) -> torch.Tensor:
    """Zero-pad ``axis`` of x up to length T."""
    extra = T - x.shape[axis]
    if extra <= 0:
        return x
    axis = axis % x.dim()
    return F.pad(x, [0, 0] * (x.dim() - 1 - axis) + [0, extra])


def _decoder_carry_init(cfg: TacotronConfig, B: int, T: int, dtype,
                        device) -> DecoderCarry:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    state0 = A.init_state(cfg.attention, B, T, device=device)
    reads_w = cfg.attention in A.READS_WEIGHTS
    return DecoderCarry(
        h_att=z(2, B, cfg.attention_rnn_dim),
        c_att=z(2, B, cfg.attention_rnn_dim),
        h_dec=z(B, cfg.decoder_rnn_dim), c_dec=z(B, cfg.decoder_rnn_dim),
        ctx=z(2, B, cfg.encoder_embedding_dim),
        w=z(2, B, T) if reads_w else None,
        w_cum=z(2, B, T) if reads_w else None,
        att_state={k: torch.stack([v, v]).to(dtype)
                   for k, v in state0.items()})


def _decode_step(rnn_s, att_s, dec_rnn, cfg: TacotronConfig,
                 carry: DecoderCarry, pre_ts, memory_s, proc_mem_s, mask_s,
                 extras=None, taps=None):
    """One step with both streams stacked.  pre_ts [2, B, P] prenet outputs;
    memory_s/proc_mem_s [2, B, T, .]; mask_s [2, B, T].

    Training passes ``extras``: the scaled keep-masks att_h/att_c
    [2, B, A] and dec_h/dec_c [B, D] (the reference drops both h and c of
    each LSTM) and, for SMA, its noise [2, B, T].  ``taps`` are zero f32
    additions to the two big LSTMs' gates ([2, B, 4A], [B, 4D]) for the
    custom backward.  Returns (new carry, hidden_ctx [B, dec + 2*embed],
    weights [2, B, T], (att_in, dec_in) the two LSTMs' inputs)."""
    att_in = torch.cat([pre_ts, carry.ctx], dim=-1)
    if "w_q" in rnn_s:
        h_att, c_att = L.lstm_cell_quant_stacked(rnn_s, att_in, carry.h_att,
                                                 carry.c_att)
    else:
        h_att, c_att = L.lstm_cell_prepared(
            rnn_s, att_in, carry.h_att, carry.c_att,
            None if taps is None else taps[0])
    if extras is not None:
        h_att = h_att * extras["att_h"]
        c_att = c_att * extras["att_c"]
    w_cat = (None if carry.w is None
             else torch.stack([carry.w, carry.w_cum], dim=2))  # [2, B, 2, T]
    ctx, w, att_state = A.attention_step(
        cfg.attention, att_s, h_att, memory_s, proc_mem_s, mask_s,
        carry.att_state, None if extras is None else extras.get("noise"),
        weights_cat=w_cat)
    # reference concat order: h_phone, ctx_phone, h_bert, ctx_bert
    dec_in = torch.cat([h_att[0], ctx[0], h_att[1], ctx[1]], dim=-1)
    if "w_q" in dec_rnn:
        h1, c1 = L.lstm_cell_quant_stacked(dec_rnn, dec_in[None],
                                           carry.h_dec[None],
                                           carry.c_dec[None])
        h_dec, c_dec = h1[0], c1[0]
    else:
        h_dec, c_dec = L.lstm_cell_prepared(
            dec_rnn, dec_in, carry.h_dec, carry.c_dec,
            None if taps is None else taps[1])
    if extras is not None:
        h_dec = h_dec * extras["dec_h"]
        c_dec = c_dec * extras["dec_c"]
    hidden_ctx = torch.cat([h_dec, ctx[0], ctx[1]], dim=-1)
    new_carry = DecoderCarry(
        h_att=h_att, c_att=c_att, h_dec=h_dec, c_dec=c_dec, ctx=ctx,
        w=None if w_cat is None else w,
        w_cum=None if w_cat is None else carry.w_cum + w,
        att_state=att_state)
    return new_carry, hidden_ctx, w, (att_in, dec_in)


def _tf_scan_plain(cfg: TacotronConfig, rnn_s, att_s, dec_rnn, memory_s,
                   proc_mem_s, mask_s, pre, extras=None, taps=None,
                   save_xh: bool = False):
    """The teacher-forced decoder loop.  pre [T, 2, B, P]; ``extras`` holds
    the per-step training inputs (att_h, att_c, dec_h, dec_c and SMA's
    noise, each with a leading axis T; see ``_decode_step``) and
    ``taps`` the per-step gate taps ([T, 2, B, 4A], [T, B, 4D]).  Returns
    hidden_ctx [T, B, H] and weights [T, 2, B, T_mem], and with ``save_xh``
    the LSTMs' full inputs [x, h_prev] ([T, 2, B, K_att], [T, B, K_dec])."""
    B, T = memory_s.shape[1], memory_s.shape[2]
    carry = _decoder_carry_init(cfg, B, T, memory_s.dtype, memory_s.device)
    hcs, ws, xh_att, xh_dec = [], [], [], []
    for t in range(pre.shape[0]):
        ex = None if extras is None else {k: v[t] for k, v in extras.items()}
        tp = None if taps is None else (taps[0][t], taps[1][t])
        h_att, h_dec = carry.h_att, carry.h_dec
        carry, hc, w, (att_in, dec_in) = _decode_step(
            rnn_s, att_s, dec_rnn, cfg, carry, pre[t], memory_s, proc_mem_s,
            mask_s, ex, tp)
        hcs.append(hc)
        ws.append(w)
        if save_xh:
            xh_att.append(torch.cat([att_in, h_att], dim=-1))
            xh_dec.append(torch.cat([dec_in, h_dec], dim=-1))
    out = (torch.stack(hcs), torch.stack(ws))
    if save_xh:
        out += ((torch.stack(xh_att), torch.stack(xh_dec)),)
    return out


class _TFScanCustom(torch.autograd.Function):
    """The teacher-forced decoder loop with a hand-routed backward.

    Autograd of the plain loop adds each step's share of the two big LSTM
    weight gradients into a weight-sized buffer, once per frame.  Here the
    backward replays the loop with those weights detached and zero "taps"
    on the gates that require grad: autograd of the replay gives the
    per-step gate gradients dG_t as the taps' gradients, with no
    weight-sized accumulator in the loop.  Then dW = sum_t xh_t^T dG_t is
    one f32 matmul per weight, cast to the compute dtype as the JAX package
    casts it.  Every leaf of the stacked attention tree gets autograd's
    gradient through the replay (None for the memory layer, which the loop
    does not read).  The forward is replayed exactly: its randomness is in
    ``extras``.

    apply(cfg, mask_s, extras, att_tree, rnn_w, rnn_b, dec_w, dec_b,
    memory_s, proc_mem_s, pre, *att_leaves) -> (hidden_ctx, weights), where
    ``att_leaves`` are ``tree_leaves(att_s)`` and ``att_tree`` is att_s
    (read for its structure only)."""

    @staticmethod
    def forward(ctx, cfg, mask_s, extras, att_tree, rnn_w, rnn_b, dec_w,
                dec_b, memory_s, proc_mem_s, pre, *att_leaves):
        ctx.att_tree = tree_map(lambda _: None, att_tree)
        hc, ws = _tf_scan_plain(cfg, {"w": rnn_w, "b": rnn_b},
                                tree_unflatten(ctx.att_tree, att_leaves),
                                {"w": dec_w, "b": dec_b}, memory_s,
                                proc_mem_s, mask_s, pre, extras)
        ctx.cfg, ctx.extras = cfg, extras
        ctx.save_for_backward(mask_s, rnn_w, rnn_b, dec_w, dec_b, memory_s,
                              proc_mem_s, pre, *att_leaves)
        return hc, ws

    @staticmethod
    def backward(ctx, g_hc, g_ws):
        (mask_s, rnn_w, rnn_b, dec_w, dec_b, memory_s, proc_mem_s, pre,
         *att_leaves) = ctx.saved_tensors
        T, _, B = pre.shape[:3]
        leaf = lambda t: t.detach().requires_grad_(True)
        att_in = [leaf(t) for t in att_leaves]
        ins = [leaf(t) for t in (memory_s, proc_mem_s, pre)]
        taps = (torch.zeros((T, 2, B, rnn_w.shape[-1]), dtype=torch.float32,
                            device=pre.device, requires_grad=True),
                torch.zeros((T, B, dec_w.shape[-1]), dtype=torch.float32,
                            device=pre.device, requires_grad=True))
        with torch.enable_grad():
            hc, ws, (xh_att, xh_dec) = _tf_scan_plain(
                ctx.cfg, {"w": rnn_w.detach(), "b": rnn_b.detach()},
                tree_unflatten(ctx.att_tree, att_in),
                {"w": dec_w.detach(), "b": dec_b.detach()}, ins[0], ins[1],
                mask_s, ins[2], ctx.extras, taps, save_xh=True)
            grads = torch.autograd.grad((hc, ws), (*ins, *taps, *att_in),
                                        (g_hc, g_ws), allow_unused=True)
        dmem, dpm, dpre, dg_att, dg_dec = grads[:5]
        d_att = grads[5:]
        dtype = xh_att.dtype
        f32 = lambda t: t.detach().to(dtype).to(torch.float32)
        K_att, K_dec = xh_att.shape[-1], xh_dec.shape[-1]
        # dW[s] = sum over (t, b) of xh^T dG, one f32 matmul per weight
        xa = f32(xh_att).permute(1, 0, 2, 3).reshape(2, -1, K_att)
        ga = f32(dg_att).permute(1, 0, 2, 3).reshape(2, T * B, -1)
        dW_att = torch.bmm(xa.transpose(1, 2), ga)
        dW_dec = f32(xh_dec).reshape(-1, K_dec).t() @ f32(dg_dec).reshape(
            T * B, -1)
        cast = lambda d, like: d.to(dtype).to(like.dtype)
        return (None, None, None, None, cast(dW_att, rnn_w),
                dg_att.sum((0, 2)).to(rnn_b.dtype), cast(dW_dec, dec_w),
                dg_dec.sum((0, 1)).to(dec_b.dtype), dmem, dpm, dpre, *d_att)


# the batch dim of each randomness entry (a list holds one tensor per layer)
RANDOMNESS_BATCH_DIM = {"prenet": 0, "prenet_bert": 0, "encoder": 0,
                        "encoder_sub": 0, "postnet": 0, "att_h": 2,
                        "att_c": 2, "dec_h": 1, "dec_c": 1, "noise": 2}


def randomness_rows(randomness: Dict, start: int, stop: int) -> Dict:
    """The batch rows [start, stop) of a ``make_randomness`` dict."""
    def rows(k, v):
        if isinstance(v, list):
            return [rows(k, t) for t in v]
        return v.narrow(RANDOMNESS_BATCH_DIM[k], start, stop - start)
    return {k: rows(k, v) for k, v in randomness.items()}


def make_randomness(cfg: TacotronConfig, B: int, T_text: int, T_sub: int,
                    T_out: int, *, training: bool,
                    generator: Optional[torch.Generator], device=None,
                    mesh=None):
    """Every random draw of one ``forward``, up front: boolean keep-masks
    (True = keep) and SMA's noise.  Keys: "prenet"/"prenet_bert" (2 masks
    [B, T_steps, prenet_dim] each, when prenet dropout is on);
    training adds "encoder"/"encoder_sub" (one mask [B, E, T] per conv),
    "postnet" (one mask [B, C_i, T_out] per layer), "att_h"/"att_c"
    [T_steps, 2, B, A], "dec_h"/"dec_c" [T_steps, B, D] and, for SMA only
    (no other variant reads it), "noise" [T_steps, 2, B, max(T_text,
    T_sub)] (N(0, 1) * SMA_SIGMOID_NOISE, f32).  ``generator`` lives on
    ``device``.

    With a ``mesh`` (``parallel.mesh``), B is this rank's share of the
    batch: the global batch's draws are made (every rank's generator seeded
    alike), then this rank's rows are kept, so N ranks see the numbers one
    process sees."""
    if mesh is not None and mesh.n_data > 1:
        full = make_randomness(cfg, B * mesh.n_data, T_text, T_sub, T_out,
                               training=training, generator=generator,
                               device=device)
        return randomness_rows(full, mesh.data * B, (mesh.data + 1) * B)
    T_steps = T_out // cfg.n_frames_per_step
    out = {}
    need = training or cfg.prenet_dropout_always_on
    if not need:
        return out
    if generator is None:
        raise ValueError("dropout is on: pass a torch.Generator or the "
                         "randomness dict")
    keep = lambda shape, rate: L.keep_mask(shape, rate, generator, device)
    for k in ("prenet", "prenet_bert"):
        out[k] = [keep((B, T_steps, cfg.prenet_dim), PRENET_DROPOUT)
                  for _ in range(2)]
    if not training:
        return out
    E = cfg.encoder_embedding_dim
    out["encoder"] = [keep((B, E, T_text), 0.5)
                      for _ in range(cfg.encoder_n_convolutions)]
    out["encoder_sub"] = [keep((B, E, T_sub), 0.5)
                          for _ in range(cfg.encoder_n_convolutions)]
    n = cfg.postnet_n_convolutions
    out["postnet"] = [keep((B, cfg.n_mel_channels if i == n - 1
                            else cfg.postnet_embedding_dim, T_out), 0.5)
                      for i in range(n)]
    Ar, Dr = cfg.attention_rnn_dim, cfg.decoder_rnn_dim
    out["att_h"] = keep((T_steps, 2, B, Ar), cfg.p_attention_dropout)
    out["att_c"] = keep((T_steps, 2, B, Ar), cfg.p_attention_dropout)
    out["dec_h"] = keep((T_steps, B, Dr), cfg.p_decoder_dropout)
    out["dec_c"] = keep((T_steps, B, Dr), cfg.p_decoder_dropout)
    if cfg.attention != "StepwiseMonotonicAttention":
        return out
    out["noise"] = torch.randn((T_steps, 2, B, max(T_text, T_sub)),
                               generator=generator,
                               device=device) * A.SMA_SIGMOID_NOISE
    return out


def _scaled(mask: torch.Tensor, rate: float, dtype) -> torch.Tensor:
    """A boolean keep-mask as multipliers 0 or 1/(1-rate), divided in
    ``dtype`` as the JAX package divides."""
    return mask.to(dtype) / torch.tensor(1.0 - rate, dtype=dtype,
                                         device=mask.device)


def decoder_teacher_forced(dp, cfg: TacotronConfig, memory, memory_b, mels,
                           text_lengths, sub_lengths, *, training: bool,
                           randomness: Dict):
    """Teacher-forced decoding.  memory [B, T_text, E], memory_b
    [B, T_sub, E], mels [B, n_mels, T_out]; ``randomness`` from
    ``make_randomness``.  Returns (mel [B, n_mels, T_out], gate
    [B, T_out], alignments [B, T_steps, T_text], alignments_bert
    [B, T_steps, T_sub]), all f32, T_steps = T_out / r.

    With r = n_frames_per_step > 1 each step consumes and emits a group of
    r frames, and the per-step gate is repeated r times to frame
    granularity (as the JAX package does).  ``cfg.decoder_scan_unroll``
    is a knob of JAX's scan and has no meaning here: it is ignored."""
    B, _, T_out = mels.shape
    r, M = cfg.n_frames_per_step, cfg.n_mel_channels
    if T_out % r != 0:
        raise ValueError(f"mel length {T_out} is not divisible by "
                         f"n_frames_per_step={r}")
    T_steps = T_out // r
    dtype = _compute_dtype(cfg)
    dp = cast_floats(dp, dtype)
    memory, memory_b, mels = memory.to(dtype), memory_b.to(dtype), mels.to(dtype)

    # teacher inputs: a zero go-frame group, then all but the last group
    groups = mels.transpose(1, 2).reshape(B, T_steps, r * M)
    teacher = torch.cat([groups.new_zeros((B, 1, r * M)), groups[:, :-1]],
                        dim=1)
    pre = []
    for k in ("prenet", "prenet_bert"):
        masks = randomness.get(k)
        if masks is not None:
            masks = [_scaled(m, PRENET_DROPOUT, dtype) for m in masks]
        pre.append(prenet_apply(dp[k], teacher, masks))
    pre = torch.stack([pre[0].transpose(0, 1), pre[1].transpose(0, 1)],
                      dim=1)                              # [T, 2, B, P]

    T_text, T_sub = memory.shape[1], memory_b.shape[1]
    T = max(T_text, T_sub)
    rnn_s, att_s, dec_rnn = _stack_stream_params(dp)
    memory_s = torch.stack([_pad_T(memory, T, axis=1),
                            _pad_T(memory_b, T, axis=1)])
    proc_mem_s = torch.stack([
        _pad_T(A.process_memory(dp["attention"], memory), T, axis=1),
        _pad_T(A.process_memory(dp["attention_bert"], memory_b), T, axis=1)])
    mask_s = torch.stack([sequence_mask(text_lengths, T),
                          sequence_mask(sub_lengths, T)])

    extras = None
    if training:
        extras = {
            "att_h": _scaled(randomness["att_h"], cfg.p_attention_dropout,
                             dtype),
            "att_c": _scaled(randomness["att_c"], cfg.p_attention_dropout,
                             dtype),
            "dec_h": _scaled(randomness["dec_h"], cfg.p_decoder_dropout,
                             dtype),
            "dec_c": _scaled(randomness["dec_c"], cfg.p_decoder_dropout,
                             dtype)}
        if cfg.attention == "StepwiseMonotonicAttention":
            extras["noise"] = randomness["noise"][..., :T].to(dtype)
    if training and cfg.custom_decoder_vjp and torch.is_grad_enabled():
        hidden_ctx, ws = _TFScanCustom.apply(
            cfg, mask_s, extras, att_s, rnn_s["w"], rnn_s["b"], dec_rnn["w"],
            dec_rnn["b"], memory_s, proc_mem_s, pre, *tree_leaves(att_s))
    else:
        hidden_ctx, ws = _tf_scan_plain(cfg, rnn_s, att_s, dec_rnn, memory_s,
                                        proc_mem_s, mask_s, pre, extras)

    mel_out = L.linear_apply(dp["linear_projection"], hidden_ctx)  # [T, B, rM]
    gate_out = L.linear_apply(dp["gate_layer"], hidden_ctx)[..., 0]  # [T, B]
    mel = mel_out.transpose(0, 1).reshape(B, T_out, M).transpose(1, 2)
    gate = gate_out.t().float()
    if r > 1:
        gate = gate.repeat_interleave(r, dim=1)
    return (mel.float(), gate,
            ws[:, 0, :, :T_text].transpose(0, 1).float(),
            ws[:, 1, :, :T_sub].transpose(0, 1).float())


def decoder_infer(dp, cfg: TacotronConfig, memory: torch.Tensor,
                  memory_b: torch.Tensor, *,
                  generator: Optional[torch.Generator] = None,
                  max_steps: Optional[int] = None,
                  gate_threshold: Optional[float] = None,
                  text_lengths: Optional[torch.Tensor] = None,
                  sub_lengths: Optional[torch.Tensor] = None):
    """Free-running decode with per-sample gate stop.

    Returns mel [B, n_mels, S*r], gate [B, S], alignments [B, S, T_text],
    alignments_bert [B, S, T_sub], mel_lengths [B] (frames), infer_ok [B]
    (False where max steps was hit) and steps_run (decoder steps executed,
    an int), where S = max_steps and r = n_frames_per_step.  With
    ``cfg.prenet_dropout_always_on`` the prenet masks come from
    ``generator``, which must live on memory's device.  With ``utils.trace``
    on, records the spans ``decode.prepare``, ``decode.loop`` (its
    ``decode.sync`` reads inside) and ``decode.finish``, and counts
    ``decode.steps`` and ``decode.syncs``."""
    S = int(max_steps or cfg.max_decoder_steps)
    thresh = cfg.gate_threshold if gate_threshold is None else gate_threshold
    B, dev = memory.shape[0], memory.device
    M, r = cfg.n_mel_channels, cfg.n_frames_per_step
    if cfg.prenet_dropout_always_on and generator is None:
        raise ValueError("prenet dropout is on: pass a torch.Generator")

    with trace.span("decode.prepare"):
        dtype = _compute_dtype(cfg)
        dp = cast_floats(dp, dtype)
        memory, memory_b = memory.to(dtype), memory_b.to(dtype)
        T_text, T_sub = memory.shape[1], memory_b.shape[1]
        T = max(T_text, T_sub)
        rnn_s, att_s, dec_rnn = _stack_stream_params(dp, cfg.decode_quant)
        memory_s = torch.stack([_pad_T(memory, T, axis=1),
                                _pad_T(memory_b, T, axis=1)])
        proc_mem_s = torch.stack([
            _pad_T(A.process_memory(dp["attention"], memory), T, axis=1),
            _pad_T(A.process_memory(dp["attention_bert"], memory_b), T,
                   axis=1)])
        if text_lengths is None:
            # unmasked inference; the padded slots of the stack are masked
            text_lengths = torch.full((B,), T_text, device=dev)
            sub_lengths = torch.full((B,), T_sub, device=dev)
        mask_s = torch.stack([sequence_mask(text_lengths.to(dev), T),
                              sequence_mask(sub_lengths.to(dev), T)])

        carry = _decoder_carry_init(cfg, B, T, dtype, dev)
        mel_buf = torch.zeros((S, B, M * r), dtype=dtype, device=dev)
        gate_buf = torch.full((S, B), GATE_PAD_VALUE, dtype=dtype, device=dev)
        align_buf = torch.zeros((S, 2, B, T), dtype=dtype, device=dev)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        lengths = torch.zeros(B, dtype=torch.long, device=dev)
        prev = torch.zeros((B, M * r), dtype=dtype, device=dev)

    steps_run = 0
    with trace.span("decode.loop"):
        for t in range(S):
            if cfg.prenet_dropout_always_on:
                m = _prenet_masks(generator, 4, (B, cfg.prenet_dim), dtype,
                                  dev)
                masks, masks_b = (m[0], m[1]), (m[2], m[3])
            else:
                masks = masks_b = None
            pre_ts = torch.stack([
                prenet_apply(dp["prenet"], prev, masks),
                prenet_apply(dp["prenet_bert"], prev, masks_b)])
            carry, hidden_ctx, w_s, _ = _decode_step(
                rnn_s, att_s, dec_rnn, cfg, carry, pre_ts, memory_s,
                proc_mem_s, mask_s)
            mel_t = L.linear_apply(dp["linear_projection"], hidden_ctx)
            gate_t = L.linear_apply(dp["gate_layer"], hidden_ctx)[..., 0]
            mel_buf[t] = mel_t
            gate_buf[t] = gate_t
            align_buf[t] = w_s
            fired = torch.sigmoid(gate_t) > thresh
            # the stop frame is included
            lengths = lengths.masked_fill(fired & ~finished, t + 1)
            finished = finished | fired
            prev = mel_t
            steps_run = t + 1
            if steps_run % SYNC_EVERY == 0:
                with trace.span("decode.sync"):
                    done = bool(finished.all())
                if done:
                    break
    trace.count("decode.steps", steps_run)
    trace.count("decode.syncs", steps_run // SYNC_EVERY)

    with trace.span("decode.finish"):
        # samples that never fired ran to max steps (infer_ok False)
        step_lengths = torch.where(finished, lengths,
                                   torch.full_like(lengths, steps_run))
        valid = sequence_mask(step_lengths, S)                 # [B, S]
        frame_valid = valid.repeat_interleave(r, dim=1)        # [B, S*r]
        mel_frames = mel_buf.permute(1, 0, 2).reshape(B, S * r, M)
        mel = (mel_frames.transpose(1, 2) * frame_valid[:, None, :]).float()
        gate = torch.where(valid, gate_buf.t().float(),
                           torch.full_like(valid, GATE_PAD_VALUE,
                                           dtype=torch.float32))
        vf = valid[:, :, None].float()
        out = {
            "mel": mel,
            "gate": gate,
            "alignments": (align_buf[:, 0, :, :T_text].permute(1, 0, 2)
                           .float() * vf),
            "alignments_bert": (align_buf[:, 1, :, :T_sub].permute(1, 0, 2)
                                .float() * vf),
            "mel_lengths": step_lengths * r,
            "infer_ok": finished,
            "steps_run": steps_run,
        }
    return out


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def _encode_stream(params, bn_state, emb_table, ids, lengths, cls, converter,
                   dtype: torch.dtype, *, training: bool = False,
                   masks: Optional[List[torch.Tensor]] = None, mesh=None):
    """embedding -> encoder -> concat [CLS] -> linear converter: (memory
    [B, T, encoder_embedding_dim] in ``dtype``, new encoder BN state)."""
    params = cast_floats(params, dtype)
    emb = L.embedding_apply(emb_table.to(dtype), ids)      # [B, T, C]
    enc, new_bn = encoder_apply(params, bn_state, emb.transpose(1, 2), lengths,
                                training=training, masks=masks, mesh=mesh)
    if cls.dim() == 2:
        cls = cls[:, None, :].expand(-1, enc.shape[1], -1)
    fused = torch.cat([enc, cls.to(enc.dtype)], dim=-1)
    return L.linear_apply(cast_floats(converter, dtype), fused), new_bn


def parse_output(mel, mel_postnet, gate, output_lengths, n_mel_channels,
                 mask_padding: bool = True):
    """Zero the padded mel frames and fill the padded gate energies with
    GATE_PAD_VALUE."""
    if not mask_padding or output_lengths is None:
        return mel, mel_postnet, gate
    valid = sequence_mask(output_lengths, mel.shape[-1])
    return (mel * valid[:, None, :], mel_postnet * valid[:, None, :],
            torch.where(valid, gate, GATE_PAD_VALUE))


def forward(params, bn_state, cfg: TacotronConfig, batch, *, training: bool,
            generator: Optional[torch.Generator] = None,
            randomness: Optional[Dict] = None, mesh=None):
    """Teacher-forced forward pass.

    batch: text [B, T_text] int, text_lengths [B], sub [B, T_sub] int,
    sub_lengths [B], mels [B, n_mels, T_out], output_lengths [B],
    cls_phone / cls_sub [B, 768] (or per token [B, T, 768]), all on one
    device.  The randomness comes from ``randomness`` (see
    ``make_randomness``) or, when that is None, is drawn from
    ``generator`` (on the batch's device).  With a ``mesh``
    (``parallel.mesh``) the batch is this rank's rows of the global batch:
    the BN statistics and the randomness are the global batch's.

    Returns (outputs {mel, mel_postnet, gate, alignments,
    alignments_bert}, new BN state)."""
    dtype = _compute_dtype(cfg)
    if randomness is None:
        B, T_text = batch["text"].shape
        randomness = make_randomness(
            cfg, B, T_text, batch["sub"].shape[1], batch["mels"].shape[2],
            training=training, generator=generator,
            device=batch["mels"].device, mesh=mesh)
    memory, bn_enc = _encode_stream(
        params["encoder"], bn_state["encoder"], params["embedding"],
        batch["text"], batch["text_lengths"], batch["cls_phone"],
        params["linear_converter"], dtype, training=training,
        masks=randomness.get("encoder"), mesh=mesh)
    memory_b, bn_enc_b = _encode_stream(
        params["encoder_sub"], bn_state["encoder_sub"],
        params["embedding_sub"], batch["sub"], batch["sub_lengths"],
        batch["cls_sub"], params["linear_converter_sub"], dtype,
        training=training, masks=randomness.get("encoder_sub"), mesh=mesh)
    mel, gate, align, align_b = decoder_teacher_forced(
        params["decoder"], cfg, memory, memory_b, batch["mels"],
        batch["text_lengths"], batch["sub_lengths"], training=training,
        randomness=randomness)
    residual, bn_post = postnet_apply(
        cast_floats(params["postnet"], dtype), bn_state["postnet"],
        mel.to(dtype), training=training, masks=randomness.get("postnet"),
        mesh=mesh)
    mel_postnet = mel + residual.float()
    mel, mel_postnet, gate = parse_output(
        mel, mel_postnet, gate, batch.get("output_lengths"),
        cfg.n_mel_channels, cfg.mask_padding)
    outputs = {"mel": mel, "mel_postnet": mel_postnet, "gate": gate,
               "alignments": align, "alignments_bert": align_b}
    return outputs, {"encoder": bn_enc, "encoder_sub": bn_enc_b,
                     "postnet": bn_post}


@torch.inference_mode()
def infer(params, bn_state, cfg: TacotronConfig, text, sub, cls_phone,
          cls_sub, *, generator: Optional[torch.Generator] = None,
          max_steps: Optional[int] = None,
          gate_threshold: Optional[float] = None,
          text_lengths=None, sub_lengths=None):
    """Free-running inference: IDs [B, T_text] / [B, T_sub] and [CLS]
    vectors [B, 768] (or per-token [B, T, 768]) -> decoder_infer's outputs
    plus mel_postnet [B, n_mels, S*r].  All inputs on one device; optional
    lengths make padded batches exact."""
    dtype = _compute_dtype(cfg)
    with trace.span("serve.encode"):
        memory, _ = _encode_stream(params["encoder"], bn_state["encoder"],
                                   params["embedding"], text, text_lengths,
                                   cls_phone, params["linear_converter"],
                                   dtype)
        memory_b, _ = _encode_stream(params["encoder_sub"],
                                     bn_state["encoder_sub"],
                                     params["embedding_sub"], sub,
                                     sub_lengths, cls_sub,
                                     params["linear_converter_sub"], dtype)
    out = decoder_infer(params["decoder"], cfg, memory, memory_b,
                        generator=generator, max_steps=max_steps,
                        gate_threshold=gate_threshold,
                        text_lengths=text_lengths, sub_lengths=sub_lengths)
    with trace.span("serve.postnet"):
        residual, _ = postnet_apply(cast_floats(params["postnet"], dtype),
                                    bn_state["postnet"],
                                    out["mel"].to(dtype))
        valid = sequence_mask(out["mel_lengths"], out["mel"].shape[-1])
        out["mel_postnet"] = ((out["mel"] + residual.float())
                              * valid[:, None, :])
    return out
