"""Export the port's HiFi-GAN generator to an ONNX model (the producer side
of ``models.vocoder_runtimes.load_onnx_vocoder``; counterpart of the JAX
package's ``tools/export_hifigan_onnx.py``).

    python -m tacotron2_subword_tpu_torch.tools.export_hifigan_onnx \
        --out hifigan.onnx [--checkpoint g_00000000] [--config config_v1.json]

The generator is a Conv / ConvTranspose / LeakyRelu / Tanh / Add / Mul graph
(standard opset-13 ops), emitted by ``utils.onnx_lite.encode_model`` with
the JAX tool's node order, names and attributes; the time axis is dynamic
(dim_param "T").  ``--checkpoint`` is a reference ``{'generator':
state_dict}`` torch file (weight-normed or fused, as ``apps.train_hifigan``
writes it); without one the generator is a random init from seed 0.  The
JAX package's Orbax generator directories are not read:
``tools/orbax_to_torch.py --generator`` converts them.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tacotron2_subword_tpu_torch.models import hifigan as HG
from tacotron2_subword_tpu_torch.utils import onnx_lite as OX


def generator_onnx_graph(params, h: HG.HifiganConfig):
    """Fused generator params (tensors) and config -> (nodes, initializers)
    mirroring ``models.hifigan.generator_apply``."""
    nodes, inits = [], {}
    uid = [0]

    def fresh(tag):
        uid[0] += 1
        return f"{tag}_{uid[0]}"

    def weights(tag, p):
        wn, bn = f"{tag}_w", f"{tag}_b"
        inits[wn] = p["w"].detach().cpu().numpy().astype(np.float32)
        inits[bn] = p["b"].detach().cpu().numpy().astype(np.float32)
        return wn, bn

    def conv(x, tag, p, dilation=1, padding=None):
        wn, bn = weights(tag, p)
        if padding is None:
            padding = HG.get_padding(inits[wn].shape[-1], dilation)
        out = fresh(tag)
        nodes.append(OX.Node("Conv", [x, wn, bn], [out],
                             {"pads": [padding, padding],
                              "dilations": [dilation], "strides": [1]}))
        return out

    def convt(x, tag, p, stride, padding):
        wn, bn = weights(tag, p)
        out = fresh(tag)
        nodes.append(OX.Node("ConvTranspose", [x, wn, bn], [out],
                             {"pads": [padding, padding],
                              "strides": [stride]}))
        return out

    def lrelu(x, alpha):
        out = fresh("lrelu")
        nodes.append(OX.Node("LeakyRelu", [x], [out],
                             {"alpha": float(alpha)}))
        return out

    def add(a, b):
        out = fresh("add")
        nodes.append(OX.Node("Add", [a, b], [out]))
        return out

    x = conv("mel", "conv_pre", params["conv_pre"], padding=3)
    nk = len(h.resblock_kernel_sizes)
    inits["inv_nk"] = np.asarray([1.0 / nk], np.float32)
    for i, (u, k) in enumerate(zip(h.upsample_rates,
                                   h.upsample_kernel_sizes)):
        x = lrelu(x, HG.LRELU_SLOPE)
        x = convt(x, f"ups_{i}", params["ups"][i], stride=u,
                  padding=(k - u) // 2)
        xs = None
        for j in range(nk):
            rb = params["resblocks"][i * nk + j]
            r = x
            for di, d in enumerate(h.resblock_dilation_sizes[j]):
                if h.resblock == "1":
                    t = conv(lrelu(r, HG.LRELU_SLOPE), f"rb{i}_{j}_c1_{di}",
                             rb["convs1"][di], dilation=d)
                    t = conv(lrelu(t, HG.LRELU_SLOPE), f"rb{i}_{j}_c2_{di}",
                             rb["convs2"][di], dilation=1)
                    r = add(t, r)
                else:
                    r = add(conv(lrelu(r, HG.LRELU_SLOPE),
                                 f"rb{i}_{j}_c_{di}", rb["convs"][di],
                                 dilation=d), r)
            xs = r if xs is None else add(xs, r)
        out = fresh("mrf")
        nodes.append(OX.Node("Mul", [xs, "inv_nk"], [out]))
        x = out
    x = lrelu(x, 0.01)  # conv_post's pre-activation, torch's default slope
    x = conv(x, "conv_post", params["conv_post"], padding=3)
    nodes.append(OX.Node("Tanh", [x], ["wav"]))
    return nodes, inits


def export_onnx(params, h: HG.HifiganConfig, out_path: str) -> int:
    """Write ``generator_apply(params, h, .)`` as ONNX to ``out_path``;
    returns the bytes written.  ``params`` may be weight-normed (fused
    here)."""
    nodes, inits = generator_onnx_graph(HG.fuse_generator(params), h)
    blob = OX.encode_model(nodes, inits,
                           inputs={"mel": ["B", h.num_mels, "T"]},
                           outputs={"wav": ["B", 1, "T_up"]},
                           graph_name="hifigan_generator")
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
    n = export_onnx(params, h, args.out)
    print(f"wrote {args.out}: {n} bytes")
    return n


if __name__ == "__main__":
    main()
