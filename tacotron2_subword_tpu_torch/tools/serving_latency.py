"""B=1 serving latency of the port: per-stage text -> wav breakdown and
real-time factor (the port's counterpart of the root
``tools/serving_latency.py``, with its flags, JSON keys and table).

    python -m tacotron2_subword_tpu_torch.tools.serving_latency \
        --checkpoint run/checkpoint_N [--hifigan-checkpoint g_file \
        [--hifigan-config config.json]] [--text "..."] [--repeats 20] \
        [--hparams "[decode_quant:int8]"] [--out-md latency.md] \
        [--device cpu]

One utterance, split into:

  front_end   host: NFKC normalize + G2P + subword IDs (crc32)
  acoustic    encoder + gate-stopped decode (``models.tacotron2.infer``)
  vocoder     HiFi-GAN (or Griffin-Lim) on the 64-frame mel bucket
  total       wall text -> wav, and RTF = audio seconds / total wall

Wall times are medians of ``--repeats`` calls, each ended by a wait for
the device.  Device times are the busy time (the union of the CUDA kernel
intervals, ``utils.xprof``) of 4 traced calls, divided by 4: the card's
own cost, without the host's launches.  The first call of each stage
(cuBLAS / cuDNN handles, plans) is timed apart: the ``compile_*_s`` keys
hold first-call seconds (the port compiles nothing).  With ``--hparams
"[decode_quant:int8]"`` each decoder step runs K1 twice.  The lexicon
defaults under ``$T2S_RESOURCES_DIR``, else ``resources/``.  The device is
CUDA unless ``--device cpu`` is given; on the CPU the device columns read
null ("not measured").
"""

from __future__ import annotations

import argparse
import json
import os
import time
import unicodedata

import numpy as np
import torch

from tacotron2_subword_tpu_torch.apps.inference import (load_acoustic_model,
                                                        load_vocoder,
                                                        vocode_bucketed)
from tacotron2_subword_tpu_torch.config import create_config
from tacotron2_subword_tpu_torch.models import tacotron2 as M
from tacotron2_subword_tpu_torch.text import Text2Seq
from tacotron2_subword_tpu_torch.text.bert import hashed_subword_ids
from tacotron2_subword_tpu_torch.text.g2p import default_resources_dir
from tacotron2_subword_tpu_torch.utils import xprof
from tacotron2_subword_tpu_torch.utils.platform import resolve_device

DEFAULT_TEXT = ("con cò bé bé nó đậu cành tre đi không hỏi mẹ biết đi "
                "đường nào")
TRACED_CALLS = 4


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--hifigan-checkpoint", default=None)
    p.add_argument("--hifigan-config", default=None)
    p.add_argument("--text", default=DEFAULT_TEXT)
    p.add_argument("--g2p-lexicon", default=os.path.join(
        default_resources_dir(),
        "all-vietnamese-syllables_17k9.XSAMPA.Mien-BAC_KA.txt"))
    p.add_argument("--gate-threshold", type=float, default=0.5)
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--max-decoder-steps", type=int, default=2000)
    p.add_argument("--out-md", default=None)
    p.add_argument("--hparams", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run there)")
    return p


def front_end(t2s, text: str, sub_n_symbols: int):
    """(phone IDs, subword IDs) of one line, as numpy int64."""
    norm = unicodedata.normalize("NFKC", text).lower()
    seq = np.asarray(t2s.grapheme_to_sequence(norm), np.int64)
    sub = np.asarray(hashed_subword_ids(norm, sub_n_symbols), np.int64)
    return seq, sub


def main(argv=None):
    """Prints the result line (and writes ``--out-md``).  Returns (result,
    steps): ``steps`` lists the decoder steps of every acoustic call, in
    order (K1 runs twice per step with int8 hparams)."""
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (
        lambda: None)

    def device_ms(fn):
        """Busy ms per call of TRACED_CALLS calls (None off the card)."""
        if not on_card:
            return None
        with xprof.device_profile() as prof:
            for _ in range(TRACED_CALLS):
                fn()
            sync()
        return xprof.device_busy_ms(prof) / TRACED_CALLS

    cfg = create_config(hparams_string=args.hparams)
    cfg = cfg.replace(max_decoder_steps=args.max_decoder_steps)
    params, bn = load_acoustic_model(args.checkpoint, cfg, dev)
    vocode, voc_name = load_vocoder(args.hifigan_checkpoint,
                                    args.hifigan_config, dev)
    t2s = Text2Seq(args.g2p_lexicon)

    # ---- stage 1: host front end ---------------------------------------
    fe_times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        seq, sub = front_end(t2s, args.text, cfg.sub_n_symbols)
        fe_times.append(time.perf_counter() - t0)
    fe_ms = _median(fe_times) * 1e3

    # ---- stage 2: acoustic (encoder + gate-stopped decode) --------------
    as_t = lambda a: torch.from_numpy(a).to(dev)
    text_d = as_t(np.pad(seq, (0, -(-len(seq) // 16) * 16 - len(seq)))[None])
    sub_d = as_t(np.pad(sub, (0, -(-len(sub) // 8) * 8 - len(sub)))[None])
    cls_d = torch.zeros((1, cfg.bert_embedding_dim), device=dev)
    tl, sl = as_t(np.asarray([len(seq)])), as_t(np.asarray([len(sub)]))
    steps = []

    @torch.inference_mode()
    def acoustic():
        out = M.infer(params, bn, cfg, text_d, sub_d, cls_d, cls_d,
                      generator=torch.Generator(device=dev).manual_seed(0),
                      text_lengths=tl, sub_lengths=sl,
                      gate_threshold=args.gate_threshold)
        steps.append(out["steps_run"])
        return out

    t0 = time.perf_counter()
    out = acoustic()
    n_frames = int(out["mel_lengths"][0])   # waits for the decode
    compile_acoustic_s = time.perf_counter() - t0
    mel = out["mel_postnet"]

    ac_times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        o = acoustic()
        int(o["mel_lengths"][0])
        float(o["mel_postnet"][0, 0, 0])
        ac_times.append(time.perf_counter() - t0)
    ac_wall_ms = _median(ac_times) * 1e3
    ac_dev_ms = device_ms(acoustic)

    # ---- stage 3: vocoder -------------------------------------------------
    @torch.inference_mode()
    def vocoder(m, n):
        wav = vocode_bucketed(vocode, m, [n], hop=cfg.hop_length)[0]
        sync()
        return wav

    t0 = time.perf_counter()
    wav = vocoder(mel, n_frames)
    compile_vocoder_s = time.perf_counter() - t0
    vo_times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        wav = vocoder(mel, n_frames)
        vo_times.append(time.perf_counter() - t0)
    vo_wall_ms = _median(vo_times) * 1e3
    vo_dev_ms = device_ms(lambda: vocoder(mel, n_frames))
    if not torch.isfinite(wav).all():
        raise FloatingPointError("non-finite waveform")

    # ---- end to end -------------------------------------------------------
    e2e_times = []
    for _ in range(max(args.repeats // 2, 5)):
        t0 = time.perf_counter()
        front_end(t2s, args.text, cfg.sub_n_symbols)
        o = acoustic()
        nf = int(o["mel_lengths"][0])
        vocoder(o["mel_postnet"], nf)
        e2e_times.append(time.perf_counter() - t0)
    e2e_wall_ms = _median(e2e_times) * 1e3

    audio_s = n_frames * cfg.hop_length / cfg.sampling_rate
    dev_total = (ac_dev_ms + vo_dev_ms) if on_card else None
    rnd = lambda v: None if v is None else round(v, 2)
    result = {
        "text_chars": len(args.text), "phones": int(len(seq)),
        "frames": n_frames, "audio_s": round(audio_s, 3),
        "vocoder": voc_name,
        "front_end_ms": round(fe_ms, 3),
        "acoustic_wall_ms": round(ac_wall_ms, 2),
        "acoustic_device_ms": rnd(ac_dev_ms),
        "vocoder_wall_ms": round(vo_wall_ms, 2),
        "vocoder_device_ms": rnd(vo_dev_ms),
        "e2e_wall_ms": round(e2e_wall_ms, 2),
        "rtf_wall": round(audio_s / (e2e_wall_ms / 1e3), 2),
        "rtf_device": (round(audio_s / (dev_total / 1e3), 2)
                       if on_card else None),
        "compile_acoustic_s": round(compile_acoustic_s, 3),
        "compile_vocoder_s": round(compile_vocoder_s, 3),
        "gate_threshold": args.gate_threshold,
        "repeats": args.repeats,
    }
    print(json.dumps(result))

    if args.out_md:
        d = lambda v: "not measured" if v is None else f"{v:.1f}"
        md = [
            "# B=1 serving latency (text → wav, gate-stopped)",
            "",
            f"Checkpoint `{args.checkpoint}`, vocoder **{voc_name}**, "
            f"{len(seq)} phones → {n_frames} frames "
            f"({audio_s:.2f} s audio), gate threshold "
            f"{args.gate_threshold}, median of {args.repeats}, device "
            f"{torch.cuda.get_device_name(dev) if on_card else dev}.",
            "",
            "| stage | wall ms | device ms |",
            "|---|---|---|",
            f"| front-end (G2P + subwords, host) | {fe_ms:.2f} | – |",
            f"| acoustic (encoder + decode) | {ac_wall_ms:.1f} | "
            f"{d(ac_dev_ms)} |",
            f"| vocoder ({voc_name}) | {vo_wall_ms:.1f} | {d(vo_dev_ms)} |",
            f"| **end-to-end** | **{e2e_wall_ms:.1f}** | {d(dev_total)} |",
            "",
            f"**RTF (wall) = {result['rtf_wall']}x** real-time; RTF on "
            f"device busy time alone = {result['rtf_device']}x.  Device "
            "time is the union of the CUDA kernel intervals of "
            f"{TRACED_CALLS} traced calls; the wall adds the host's "
            f"launches.  First calls: acoustic {compile_acoustic_s:.3f} s, "
            f"vocoder {compile_vocoder_s:.3f} s.",
        ]
        with open(args.out_md, "w") as f:
            f.write("\n".join(md) + "\n")
        print(f"wrote {args.out_md}")
    return result, steps


if __name__ == "__main__":
    main()
