"""Export the port's HiFi-GAN generator to a .tflite flatbuffer (the producer
side of ``models.vocoder_runtimes.load_tflite_vocoder``; counterpart of the
root ``tools/export_hifigan_tflite.py``, which goes through jax2tf and the
TFLite converter).

    python -m tacotron2_subword_tpu_torch.tools.export_hifigan_tflite \
        --out hifigan.tflite [--checkpoint g_00000000 --config c.json] \
        [--frames 256] [--batch 1]

The graph computes ``models.hifigan.generator_apply`` at a FIXED input
``[batch, num_mels, frames]`` (f32) and writes ``[batch, 1, frames *
prod(upsample_rates)]``, the root tool's layout; pad mels to ``--frames``
and slice the waveform, as ``apps/inference.vocode_bucketed`` does.  Inside,
the activations stay NHWC ``[B, 1, T, C]``: one TRANSPOSE + RESHAPE at the
input, one RESHAPE at the output, and between them only CONV_2D (SAME,
dilated), TRANSPOSE_CONV (SAME, stride u), LEAKY_RELU (0.1, and 0.01 before
conv_post), ADD, MUL (the resblocks' average as a product with 1 / nk) and
TANH.  It is written by ``utils.tflite_lite.encode_model``: no tensorflow,
no ``flatbuffers`` package.  ``--checkpoint`` is a reference ``{'generator':
state_dict}`` torch file; without one the generator is a random init from
seed 0.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tacotron2_subword_tpu_torch.models import hifigan as HG
from tacotron2_subword_tpu_torch.utils import tflite_lite as TL


def generator_tflite_model(params, h: HG.HifiganConfig, frames: int = 256,
                           batch: int = 1) -> TL.Model:
    """Fused generator params (tensors) and config -> a :class:`TL.Model`
    computing ``generator_apply`` on ``[batch, num_mels, frames]``."""
    tensors, ops = [], []
    lrelu_of = {}

    def tensor(name, shape, data=None, dtype=TL.FLOAT32):
        tensors.append(TL.Tensor(name, tuple(int(d) for d in shape), dtype,
                                 data))
        return len(tensors) - 1

    def const_ints(name, vals):
        return tensor(name, (len(vals),), np.asarray(vals, np.int32),
                      TL.INT32)

    def op(code, inputs, name, shape, **options):
        out = tensor(name, shape)
        ops.append(TL.Op(code, list(inputs), [out],
                         TL.full_options(code, options),
                         TL.OP_VERSION.get(code, 1)))
        return out

    def shape(i):
        return tensors[i].shape

    def lrelu(x, alpha):
        if (x, alpha) not in lrelu_of:      # resblocks share lrelu(x)
            lrelu_of[x, alpha] = op(TL.LEAKY_RELU, [x], f"lrelu_{len(ops)}",
                                    shape(x), alpha=float(np.float32(alpha)))
        return lrelu_of[x, alpha]

    def conv(x, tag, p, dilation=1):
        w = p["w"].detach().float().cpu().numpy()        # [O, I, k]
        k = w.shape[-1]
        if (k - 1) * dilation % 2:
            raise ValueError(f"{tag}: kernel {k} at dilation {dilation} has "
                             f"no SAME padding equal to generator_apply's")
        wi = tensor(f"{tag}/w", (w.shape[0], 1, k, w.shape[1]),
                    np.ascontiguousarray(w.transpose(0, 2, 1))[:, None])
        bi = tensor(f"{tag}/b", (w.shape[0],),
                    p["b"].detach().float().cpu().numpy())
        b_, _, t, _ = shape(x)
        return op(TL.CONV_2D, [x, wi, bi], tag, (b_, 1, t, w.shape[0]),
                  padding=TL.SAME, stride_w=1, stride_h=1,
                  dilation_w_factor=dilation, dilation_h_factor=1)

    def convt(x, tag, p, u, k):
        w = p["w"].detach().float().cpu().numpy()        # [I, O, k]
        if (k - u) % 2:
            raise ValueError(f"{tag}: kernel {k} at stride {u} has no SAME "
                             f"padding equal to generator_apply's")
        b_, _, t, _ = shape(x)
        out_shape = (b_, 1, t * u, w.shape[1])
        si = const_ints(f"{tag}/output_shape", out_shape)
        wi = tensor(f"{tag}/w", (w.shape[1], 1, k, w.shape[0]),
                    np.ascontiguousarray(w.transpose(1, 2, 0))[:, None])
        bi = tensor(f"{tag}/b", (w.shape[1],),
                    p["b"].detach().float().cpu().numpy())
        return op(TL.TRANSPOSE_CONV, [si, wi, x, bi], tag, out_shape,
                  padding=TL.SAME, stride_w=u, stride_h=1)

    mel = tensor("mel", (batch, h.num_mels, frames))
    x = op(TL.TRANSPOSE, [mel, const_ints("perm_btc", (0, 2, 1))],
           "mel_btc", (batch, frames, h.num_mels))
    x = op(TL.RESHAPE, [x, const_ints("shape_nhwc",
                                      (batch, 1, frames, h.num_mels))],
           "mel_nhwc", (batch, 1, frames, h.num_mels))
    x = conv(x, "conv_pre", params["conv_pre"])
    nk = len(h.resblock_kernel_sizes)
    inv_nk = tensor("inv_nk", (1,), np.asarray([1.0 / nk], np.float32))
    for i, (u, k) in enumerate(zip(h.upsample_rates,
                                   h.upsample_kernel_sizes)):
        x = convt(lrelu(x, HG.LRELU_SLOPE), f"ups_{i}", params["ups"][i],
                  u, k)
        xs = None
        for j in range(nk):
            rb = params["resblocks"][i * nk + j]
            r = x
            for di, d in enumerate(h.resblock_dilation_sizes[j]):
                tag = f"resblocks_{i * nk + j}"
                if h.resblock == "1":
                    t = conv(lrelu(r, HG.LRELU_SLOPE), f"{tag}/c1_{di}",
                             rb["convs1"][di], dilation=d)
                    t = conv(lrelu(t, HG.LRELU_SLOPE), f"{tag}/c2_{di}",
                             rb["convs2"][di])
                else:
                    t = conv(lrelu(r, HG.LRELU_SLOPE), f"{tag}/c_{di}",
                             rb["convs"][di], dilation=d)
                r = op(TL.ADD, [t, r], f"{tag}/add_{di}", shape(r))
            xs = r if xs is None else op(TL.ADD, [xs, r], f"mrf_{i}_sum_{j}",
                                         shape(r))
        x = op(TL.MUL, [xs, inv_nk], f"mrf_{i}", shape(xs))
    x = conv(lrelu(x, 0.01), "conv_post", params["conv_post"])
    x = op(TL.TANH, [x], "tanh", shape(x))
    n_out = shape(x)[2]
    wav = op(TL.RESHAPE, [x, const_ints("shape_wav", (batch, 1, n_out))],
             "wav", (batch, 1, n_out))
    return TL.Model(tensors, ops, [mel], [wav],
                    description="tacotron2_subword_tpu_torch HiFi-GAN")


def export_tflite(params, h: HG.HifiganConfig, out_path: str,
                  frames: int = 256, batch: int = 1) -> int:
    """Write ``generator_apply(params, h, .)`` at the input ``[batch,
    num_mels, frames]`` as a .tflite flatbuffer to ``out_path``; returns
    the bytes written.  ``params`` may be weight-normed (fused here)."""
    model = generator_tflite_model(HG.fuse_generator(params), h, frames,
                                   batch)
    blob = TL.encode_model(model)
    with open(out_path, "wb") as f:
        f.write(blob)
    return len(blob)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="reference g_NNNNNNNN torch file ({'generator': "
                        "...}); a random init from seed 0 when absent")
    p.add_argument("--config", default=None, help="config_v1.json-style")
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--batch", type=int, default=1)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    h = (HG.HifiganConfig.from_json(args.config) if args.config
         else HG.HifiganConfig())
    if args.checkpoint and os.path.isdir(args.checkpoint):
        raise NotImplementedError(
            f"{args.checkpoint}: Orbax generator directories of the JAX "
            f"package cannot be read without JAX; convert it with "
            f"tools/orbax_to_torch.py --generator (where JAX is installed) "
            f"and pass the g_* torch file it writes")
    if args.checkpoint:
        ck = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=True)
        params = HG.import_torch_generator(ck.get("generator", ck), h,
                                           device="cpu")
    else:
        params = HG.init_generator(torch.Generator().manual_seed(0), h,
                                   device="cpu")
    n = export_tflite(params, h, args.out, args.frames, args.batch)
    print(f"wrote {args.out}: {n} bytes, input "
          f"[{args.batch}, {h.num_mels}, {args.frames}]")
    return n


if __name__ == "__main__":
    main()
