"""The wav reader of the port's CLIs."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_wav(path: str, target_sr: Optional[int] = None
             ) -> Tuple[np.ndarray, int]:
    """(f32 wav, rate): int16 scaled by 1/32768 (a float wav as it is),
    resampled to ``target_sr`` when given and different."""
    from scipy.io.wavfile import read
    sr, data = read(path)
    wav = data.astype(np.float32)
    if data.dtype == np.int16:
        wav = wav / 32768.0
    if target_sr and sr != target_sr:
        from tacotron2_subword_tpu_torch.eval.metrics import resample_to
        wav = resample_to(wav, sr, target_sr).astype(np.float32)
        sr = target_sr
    return wav, sr
