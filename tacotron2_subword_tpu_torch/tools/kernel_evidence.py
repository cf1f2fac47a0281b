"""The port's hand-written kernels on the card, timed and held to their
plain versions (the port's counterpart of the root
``tools/tpu_kernel_evidence.py``; the ``tpu_`` prefix is dropped).

    python -m tacotron2_subword_tpu_torch.tools.kernel_evidence \
        [--out NOTE.md] [--repeats 10] [--device cpu]

Covers, at the root tool's shapes and tolerances:
 - K3 ``ops.softdtw.softdtw_value`` (soft-DTW value) and K2
   ``softdtw_grad`` (value and E = dvalue/dD, fused) against the plain
   anti-diagonal scan (``softdtw_grad_plain``) at B=128 17x15 up to B=512
   256x256 of Euclidean distances: the summed value within 1e-5 relative,
   max|E - E_plain| within 1e-5 of max|E_plain|;
 - K1 ``ops.quant.matmul_dequant_int8`` (S=2, B=8 / 128, K=1792,
   N=4096, bf16 x) against ``matmul_dequant_int8_plain``: max|d| within
   2e-2 of max|plain|;
 - batch mel extraction (``ops.stft.mel_spectrogram``, B=64 x 66304
   samples, f32 and bf16) against the card's roofline: 3.35 TB/s of HBM,
   989 TFLOP/s bf16 and 67 TFLOP/s f32 (H100 SXM data sheet).

Times are CUDA-event times of ``--repeats`` calls back to back after a
warm-up (ms per call; the host's launches are in them where they are
longer than the kernels).  On the CPU (``--device cpu``) the wrappers take
their plain versions, the comparisons still run and the times read
"not measured".  Exits 1 if any comparison is out of its tolerance.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tacotron2_subword_tpu_torch.utils.platform import resolve_device

SDTW_SHAPES = ((128, 17, 15), (512, 64, 64), (512, 128, 128),
               (512, 192, 192), (512, 256, 256))
K1_SHAPES = ((2, 8, 1792, 4096), (2, 128, 1792, 4096))   # (S, B, K, N)
MEL_SHAPE = (64, 66304)      # ~3 s per utterance
SDTW_TOL, K1_TOL = 1e-5, 2e-2
HBM_BW, BF16_PEAK, F32_PEAK = 3.35e12, 989e12, 67e12


def event_ms(fn, dev, repeats: int):
    """CUDA-event ms per call of ``fn`` over ``repeats`` calls after one
    warm-up; None off the card."""
    if dev.type != "cuda":
        return None
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def softdtw_row(B: int, N: int, M: int, dev, rng, repeats: int) -> dict:
    """K3 and K2 against the plain scan on the distances of random 2-D
    sequences of lengths N and M."""
    from tacotron2_subword_tpu_torch.ops import softdtw as SD
    x = torch.from_numpy(rng.standard_normal((B, N, 2), dtype=np.float32)
                         ).to(dev)
    y = torch.from_numpy(rng.standard_normal((B, M, 2), dtype=np.float32)
                         ).to(dev)
    D = SD.euclidean_dist_matrix(x, y).contiguous()
    v_plain, E_plain = SD.softdtw_grad_plain(D, 1.0, 0.0)
    v_k3 = SD.softdtw_value(D, 1.0, 0.0)
    v_k2, E = SD.softdtw_grad(D, 1.0, 0.0)
    vsum = float(v_plain.double().sum())
    vmag = max(abs(vsum), 1.0)
    dv3 = abs(float(v_k3.double().sum()) - vsum) / vmag
    dv2 = abs(float(v_k2.double().sum()) - vsum) / vmag
    dg = float((E - E_plain).abs().max()) / max(
        float(E_plain.abs().max()), 1e-30)
    return {"B": B, "N": N, "M": M, "rel_dvalue_k3": dv3,
            "rel_dvalue_k2": dv2, "rel_dgrad_k2": dg,
            "ok": max(dv3, dv2, dg) < SDTW_TOL,
            "plain_ms": event_ms(lambda: SD.softdtw_grad_plain(D, 1.0, 0.0),
                                 dev, repeats),
            "k3_ms": event_ms(lambda: SD.softdtw_value(D, 1.0, 0.0), dev,
                              repeats),
            "k2_ms": event_ms(lambda: SD.softdtw_grad(D, 1.0, 0.0), dev,
                              repeats)}


def int8_row(S: int, B: int, K: int, N: int, dev, rng, repeats: int) -> dict:
    """K1 (bf16 x, int8 weights quantized per output column) against its
    plain version."""
    from tacotron2_subword_tpu_torch.ops import quant as Q
    x = torch.from_numpy(rng.standard_normal((S, B, K), dtype=np.float32)
                         ).to(dev).bfloat16()
    w = torch.from_numpy(rng.standard_normal((S, K, N), dtype=np.float32)
                         ).to(dev)
    w_q, scale = Q.quantize_int8(w, axis=1)
    r0 = Q.matmul_dequant_int8_plain(x, w_q, scale)
    r1 = Q.matmul_dequant_int8(x, w_q, scale)
    rel = float((r1 - r0).abs().max()) / max(float(r0.abs().max()), 1e-6)
    return {"S": S, "B": B, "K": K, "N": N, "rel_err": rel,
            "ok": rel < K1_TOL,
            "plain_ms": event_ms(
                lambda: Q.matmul_dequant_int8_plain(x, w_q, scale), dev,
                repeats),
            "k1_ms": event_ms(lambda: Q.matmul_dequant_int8(x, w_q, scale),
                              dev, repeats)}


def mel_row(B: int, T: int, dtype: torch.dtype, dev, rng,
            repeats: int) -> dict:
    """Mel extraction's time against its bounds: the STFT and filterbank
    FLOPs over the type's peak, and the bytes over HBM's rate, both
    counted with the wav read and the mel written once (``bytes_min``)
    and with every intermediate written and read (``bytes_hi``)."""
    from tacotron2_subword_tpu_torch.ops import stft as S
    y = torch.from_numpy(rng.standard_normal((B, T), dtype=np.float32)
                         * 0.1).to(dev).to(dtype)
    mel = S.mel_spectrogram(y)
    F = T // 256 + 1
    flops = 2 * B * F * (1024 * 1026 + 513 * 80)
    el = y.element_size()
    bytes_min = el * (B * T + B * 80 * F)
    bytes_hi = el * (B * T + 2 * B * F * 1024 + 1026 * 1024
                     + B * 1026 * F + B * 80 * F)
    peak = BF16_PEAK if dtype == torch.bfloat16 else F32_PEAK
    bound_ms = max(flops / peak, bytes_min / HBM_BW) * 1e3
    ms = event_ms(lambda: S.mel_spectrogram(y), dev, repeats)
    row = {"dtype": str(dtype).replace("torch.", ""), "B": B, "T": T,
           "frames": F, "gflop": flops / 1e9, "bytes_min": bytes_min,
           "bytes_hi": bytes_hi, "bound_ms": bound_ms, "ms": ms,
           "finite": bool(torch.isfinite(mel).all())}
    if ms is not None:
        row.update(audio_s_per_s=B * T / 22050.0 / (ms / 1e3),
                   tflops=flops / (ms / 1e3) / 1e12,
                   gbs_hi=bytes_hi / (ms / 1e3) / 1e9,
                   bound_share=bound_ms / ms)
    return row


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run there)")
    return ap


def main(argv=None) -> dict:
    """Prints the evidence (and writes ``--out``); returns {ok, softdtw,
    int8, mel: the rows}.  Exits 1 on a mismatch when run as a script."""
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    t = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions)")
    lines = [f"kernel evidence: device={dev} ({name})"]
    rng = np.random.default_rng(0)
    res = {"softdtw": [], "int8": [], "mel": []}
    with torch.inference_mode():
        for B, N, M in SDTW_SHAPES:
            r = softdtw_row(B, N, M, dev, rng, args.repeats)
            res["softdtw"].append(r)
            lines.append(
                f"softdtw B={B} {N}x{M}: plain fwd+bwd {t(r['plain_ms'])} | "
                f"K3 fwd {t(r['k3_ms'])} | K2 fused fwd+bwd "
                f"{t(r['k2_ms'])} | rel_dval={r['rel_dvalue_k3']:.2e}/"
                f"{r['rel_dvalue_k2']:.2e} rel_dgrad={r['rel_dgrad_k2']:.2e}"
                f" {'OK' if r['ok'] else 'MISMATCH'}")
        for S_, B, K, N in K1_SHAPES:
            r = int8_row(S_, B, K, N, dev, rng, args.repeats)
            res["int8"].append(r)
            lines.append(
                f"int8 matmul S={S_} {B}x{K}x{N}: plain {t(r['plain_ms'])} "
                f"| K1 {t(r['k1_ms'])} | rel_err {r['rel_err']:.2e} "
                f"{'OK' if r['ok'] else 'MISMATCH'}")
        for dtype in (torch.float32, torch.bfloat16):
            r = mel_row(*MEL_SHAPE, dtype, dev, rng, args.repeats)
            res["mel"].append(r)
            line = (f"mel_extract {r['dtype']} B={r['B']} T={r['T']} "
                    f"(F={r['frames']}): {t(r['ms'])}, bound "
                    f"{r['bound_ms']:.4f} ms ({r['gflop']:.1f} GFLOP; "
                    f"{r['bytes_min'] / 1e6:.0f} MB in + out, "
                    f"{r['bytes_hi'] / 1e6:.0f} MB if every intermediate "
                    f"materializes)")
            if r["ms"] is not None:
                line += (f" = {r['audio_s_per_s']:,.0f} audio-sec/s | "
                         f"{r['tflops']:.1f} TFLOP/s | {r['gbs_hi']:.0f} "
                         f"GB/s of the fully materialized bytes vs 3350 "
                         f"GB/s HBM | {100 * r['bound_share']:.1f}% of "
                         f"the bound")
            lines.append(line)
    res["ok"] = all(r["ok"] for r in res["softdtw"] + res["int8"]) and all(
        r["finite"] for r in res["mel"])
    report = "\n".join(lines)
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write("# Hand-written kernels on the card\n\n```\n" + report
                    + "\n```\n")
    return res


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
