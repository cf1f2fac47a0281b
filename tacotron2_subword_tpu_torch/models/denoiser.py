"""Vocoder bias removal (denoiser) in PyTorch.

Counterpart of ``tacotron2_subword_tpu/models/denoiser.py``, itself the
reference's hifiganBiasRemover / waveglowBiasRemover (reference
bias_remover.py:6-74, waveglow/denoiser.py): synthesize audio from an
all-zero (or random) mel, take its STFT magnitude at hop filter_length/4,
keep the first frame as the "bias spectrum", and at denoise time subtract
``strength * bias`` from the magnitude (clamped at 0) before inverting the
STFT.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tacotron2_subword_tpu_torch.ops import stft as S

FILTER_LENGTH = 1024
N_OVERLAP = 4
WIN_LENGTH = 1024
HOP = FILTER_LENGTH // N_OVERLAP


def compute_bias_spec(vocoder_fn: Callable[[torch.Tensor], torch.Tensor], *,
                      mode: str = "zeros", n_mel_channels: int = 80,
                      n_frames: int = 88, device="cpu",
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """vocoder_fn: mel [1, n_mels, T] → audio [1, T'] (or [1, 1, T']), on
    ``device``.  Returns the bias spectrum [1, cutoff, 1].  ``mode``
    "normal" draws the mel from ``generator`` (on ``device``)."""
    shape = (1, n_mel_channels, n_frames)
    if mode == "zeros":
        mel = torch.zeros(shape, device=device)
    elif mode == "normal":
        mel = torch.randn(shape, generator=generator, device=device)
    else:
        raise ValueError(f"mode {mode!r} not supported")
    audio = vocoder_fn(mel)
    if audio.dim() == 3:
        audio = audio[:, 0, :]
    bias_spec = S.stft_magnitude(audio, FILTER_LENGTH, HOP, WIN_LENGTH)
    return bias_spec[:, :, :1]


def denoise(audio: torch.Tensor, bias_spec: torch.Tensor,
            strength: float = 0.1) -> torch.Tensor:
    """audio [B, T] → denoised [B, T] (reference bias_remover.py:31-36;
    strength 0.9 for HiFi-GAN, 0.01 for WaveGlow at inference,
    reference inference.py:202)."""
    spec, angles = S.stft_magnitude(audio, FILTER_LENGTH, HOP, WIN_LENGTH,
                                    return_phase=True)
    spec = torch.clamp(spec - bias_spec * strength, min=0.0)
    return S.inverse_stft(spec, angles, FILTER_LENGTH, HOP, WIN_LENGTH)
