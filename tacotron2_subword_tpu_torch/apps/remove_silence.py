"""Leading/trailing silence trimming CLI of the port
(``tacotron2_subword_tpu/apps/remove_silence.py``; the reference's
remove_silence.py:7-35, without pydub).

    python -m tacotron2_subword_tpu_torch.apps.remove_silence \
        --in-dir Outdir/demo/audio --out-dir benchmark [--threshold-dbfs -50]

Every wav of ``--in-dir`` is trimmed by ``eval.metrics.trim_silence`` (10
ms chunks quieter than the threshold, from both ends) and written to
``--out-dir`` under its name as int16 (x 32767) at its own rate.  Numpy
only: nothing runs on a device.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from tacotron2_subword_tpu_torch.utils.audio import load_wav


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--in-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--threshold-dbfs", type=float, default=-50.0)
    return p


def main(argv=None) -> int:
    """Returns the number of wavs written."""
    args = build_argparser().parse_args(argv)
    from scipy.io.wavfile import write
    from tacotron2_subword_tpu_torch.eval import trim_silence
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for path in sorted(glob.glob(os.path.join(args.in_dir, "*.wav"))):
        wav, sr = load_wav(path)
        trimmed, start, end = trim_silence(wav, args.threshold_dbfs, fs=sr)
        out = os.path.join(args.out_dir, os.path.basename(path))
        write(out, sr, (np.clip(trimmed, -1, 1) * 32767).astype(np.int16))
        n += 1
        print(f"{os.path.basename(path)}: trimmed "
              f"{start / sr:.2f}s head, {(len(wav) - end) / sr:.2f}s tail")
    return n


if __name__ == "__main__":
    main()
