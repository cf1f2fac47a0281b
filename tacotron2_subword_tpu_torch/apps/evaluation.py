"""MCD / soft-DTW evaluation CLI of the port
(``tacotron2_subword_tpu/apps/evaluation.py``; the reference's
evaluation.py:106-117 and softdtw.py:75-97): every wav of a benchmark dir
against the ground-truth wav of the same basename.

    python -m tacotron2_subword_tpu_torch.apps.evaluation mcd \
        --benchmark benchmark --gt-dir data/wav
    python -m tacotron2_subword_tpu_torch.apps.evaluation softdtw \
        --benchmark benchmark --gt-dir data/wav [--device cpu]

``mcd``: both wavs resampled to 16 kHz (the reference evaluates there),
then ``eval.metrics.mcd_between_wavs``; on the host.  ``softdtw``: both
wavs at 22050 Hz, their log-mels (``ops.stft.mel_spectrogram``) on the
device, then ``ops.softdtw.softdtw_distance`` (gamma 1, no band, not
normalised) between the synthesized and the ground-truth frames: on a CUDA
device one launch of the soft-DTW forward kernel K3 per file, at B=1 (an
empty wav, all silence trimmed away, is skipped).  The
device is CUDA unless ``--device cpu`` is given.  Each prints one line per
file and the mean, and returns the mean (NaN with no pair).
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List, Tuple

import numpy as np
import torch

from tacotron2_subword_tpu_torch.utils.audio import load_wav


def pairs(benchmark: str, gt_dir: str) -> List[Tuple[str, str]]:
    """(synthesized, ground truth) paths, by basename, sorted."""
    out = []
    for infer_path in sorted(glob.glob(os.path.join(benchmark, "*.wav"))):
        gt_path = os.path.join(gt_dir, os.path.basename(infer_path))
        if os.path.exists(gt_path):
            out.append((infer_path, gt_path))
    return out


def eval_mcd(args) -> float:
    from tacotron2_subword_tpu_torch.eval import mcd_between_wavs
    mcds = []
    for infer_path, gt_path in pairs(args.benchmark, args.gt_dir):
        src, _ = load_wav(gt_path, 16000)
        trg, _ = load_wav(infer_path, 16000)
        mcd = mcd_between_wavs(src, trg, fs=16000)
        if mcd is not None:
            mcds.append(float(mcd))
            print(f"{os.path.basename(infer_path)}: {mcd:.3f}")
    mean = float(np.mean(mcds)) if mcds else float("nan")
    print("Process MCD for GroundTruth and testset")
    print(mean)
    return mean


@torch.inference_mode()
def eval_softdtw(args) -> float:
    from tacotron2_subword_tpu_torch.ops import softdtw as SD
    from tacotron2_subword_tpu_torch.ops import stft as S
    from tacotron2_subword_tpu_torch.utils.platform import resolve_device
    device = resolve_device(args.device)
    mel = lambda w: S.mel_spectrogram(
        torch.from_numpy(np.clip(w, -1, 1)[None]).to(device))
    vals = []
    for infer_path, gt_path in pairs(args.benchmark, args.gt_dir):
        gt, _ = load_wav(gt_path, 22050)
        syn, _ = load_wav(infer_path, 22050)
        if not (len(gt) and len(syn)):
            print(f"{os.path.basename(infer_path)}: empty, skipped")
            continue
        d = SD.softdtw_distance(mel(syn).transpose(1, 2),
                                mel(gt).transpose(1, 2))
        vals.append(d[0].item())
        print(f"{os.path.basename(infer_path)}: {vals[-1]:.3f}")
    mean = float(np.mean(vals)) if vals else float("nan")
    print("Mean soft-DTW:", mean)
    return mean


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("metric", choices=["mcd", "softdtw"])
    p.add_argument("--benchmark", default="benchmark")
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--device", default=None,
                   help="torch device of softdtw (default cuda; 'cpu' to "
                        "run there)")
    return p


def main(argv=None) -> float:
    args = build_argparser().parse_args(argv)
    return eval_mcd(args) if args.metric == "mcd" else eval_softdtw(args)


if __name__ == "__main__":
    main()
