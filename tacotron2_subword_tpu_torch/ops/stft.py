"""STFT / inverse STFT / mel spectrogram / Griffin-Lim in PyTorch.

Counterpart of ``tacotron2_subword_tpu/ops/stft.py``, with the same math:
the reference computes its STFT as a strided conv1d against a precomputed
windowed Fourier basis (reference stft.py:42-141) and the mel transform as a
matmul against a librosa (slaney-normalised) mel filterbank followed by a
log dynamic-range compression (reference layers.py:42-80,
audio_processing.py:78-93).  Here the reflect-padded signal is framed with
``Tensor.unfold`` (a strided view, no gather) and multiplied by the same
windowed Fourier basis in f32, so the numbers follow the JAX package's and
not ``torch.stft``'s.  The inverse STFT is the transposed product followed
by an overlap-add with ``F.fold``, which sums each output sample's frames
in a fixed order (deterministic on CUDA, unlike a scatter-add), and the
librosa-0.6 window-sum-square correction (reference
audio_processing.py:7-56).

The constants (bases, filterbanks, window envelopes) are computed once in
numpy and cached, and their device copies are cached per (shape, device),
so no constant is copied from the host inside Griffin-Lim's loop.  The
device copies are made outside inference mode, whoever asks first: a copy
made under ``torch.inference_mode`` (the GTA dump, the checkpoint sweep)
could not take part in a later autograd graph (HiFi-GAN's mel loss).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Host-side constants (numpy, cached)
# ---------------------------------------------------------------------------

def hann_window(win_length: int, dtype=np.float64) -> np.ndarray:
    """Periodic Hann window, identical to scipy.signal.get_window('hann', n,
    fftbins=True) used by the reference (stft.py:66)."""
    n = np.arange(win_length, dtype=dtype)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def _padded_window(filter_length: int, win_length: int) -> np.ndarray:
    """Hann window zero-center-padded to filter_length (librosa pad_center)."""
    if filter_length < win_length:
        raise ValueError(f"filter_length {filter_length} < win_length "
                         f"{win_length}")
    w = hann_window(win_length)
    lpad = (filter_length - win_length) // 2
    out = np.zeros(filter_length)
    out[lpad:lpad + win_length] = w
    return out


@functools.lru_cache(maxsize=None)
def stft_bases(filter_length: int, hop_length: int, win_length: int,
               window: str = "hann"):
    """Windowed forward/inverse Fourier bases (reference stft.py:52-75):
    forward rows are [Re(F); Im(F)] of the DFT matrix (cutoff = n//2+1 rows
    each) times the padded window; the inverse basis is the windowed
    pseudo-inverse of ``scale * fourier_basis``.

    Returns (forward_basis [2*cutoff, filter_length],
             inverse_basis [2*cutoff, filter_length]) as float32."""
    scale = filter_length / hop_length
    fourier = np.fft.fft(np.eye(filter_length))
    cutoff = filter_length // 2 + 1
    basis = np.vstack([np.real(fourier[:cutoff]), np.imag(fourier[:cutoff])])
    inverse = np.linalg.pinv(scale * basis).T  # [2*cutoff, filter_length]
    if window is not None:
        if window != "hann":
            raise NotImplementedError(f"window={window!r}")
        w = _padded_window(filter_length, win_length)
        fwd = basis * w[None, :]
        inv = inverse * w[None, :]
    else:
        fwd, inv = basis, inverse
    return fwd.astype(np.float32), inv.astype(np.float32)


@functools.lru_cache(maxsize=None)
def window_sumsquare(n_frames: int, filter_length: int, hop_length: int,
                     win_length: int) -> np.ndarray:
    """Sum-square Hann envelope at the given hop (librosa 0.6 semantics,
    reference audio_processing.py:7-56).  Shape [filter_length + hop*(n-1)]."""
    n = filter_length + hop_length * (n_frames - 1)
    x = np.zeros(n)
    win_sq = hann_window(win_length)
    win_sq = (win_sq / np.max(np.abs(win_sq))) ** 2  # librosa normalize(inf-norm)
    lpad = (filter_length - win_length) // 2
    padded = np.zeros(filter_length)
    padded[lpad:lpad + win_length] = win_sq
    for i in range(n_frames):
        s = i * hop_length
        x[s:min(n, s + filter_length)] += padded[:max(0, min(filter_length, n - s))]
    return x.astype(np.float32)


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    """Slaney mel→Hz (librosa default, htk=False)."""
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                     freqs)
    return freqs


def hz_to_mel(freqs: np.ndarray) -> np.ndarray:
    """Slaney Hz→mel (librosa default, htk=False)."""
    freqs = np.asarray(freqs, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freqs / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freqs >= min_log_hz
    with np.errstate(divide="ignore"):
        mels = np.where(log_t,
                        min_log_mel + np.log(np.maximum(freqs, 1e-10) / min_log_hz) / logstep,
                        mels)
    return mels


@functools.lru_cache(maxsize=None)
def mel_filterbank(sampling_rate: int, n_fft: int, n_mels: int,
                   fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank [n_mels, n_fft//2+1],
    numerically identical to librosa.filters.mel(sr, n_fft, n_mels, fmin,
    fmax) as used by the reference (layers.py:50-51)."""
    fftfreqs = np.linspace(0, sampling_rate / 2, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


# ---------------------------------------------------------------------------
# Device copies of the constants, cached per (shape, device)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _bases_on(filter_length: int, hop_length: int, win_length: int,
              device: torch.device):
    fwd, inv = stft_bases(filter_length, hop_length, win_length)
    with torch.inference_mode(False):
        return (torch.from_numpy(fwd).to(device),
                torch.from_numpy(inv).to(device))


@functools.lru_cache(maxsize=64)
def _mel_basis_on(sampling_rate: int, n_fft: int, n_mels: int, fmin: float,
                  fmax: float, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(mel_filterbank(sampling_rate, n_fft, n_mels,
                                               fmin, fmax)).to(device)


@functools.lru_cache(maxsize=64)
def _inv_mel_basis_on(sampling_rate: int, n_fft: int, n_mels: int,
                      fmin: float, fmax: float,
                      device: torch.device) -> torch.Tensor:
    fb = mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax)
    with torch.inference_mode(False):
        return torch.from_numpy(np.linalg.pinv(fb)).to(device)


@functools.lru_cache(maxsize=64)
def _wss_correction_on(n_frames: int, filter_length: int, hop_length: int,
                       win_length: int, device: torch.device) -> torch.Tensor:
    """1/window-sum-square where it exceeds f32 tiny, else 1: [out_len]."""
    wss = window_sumsquare(n_frames, filter_length, hop_length, win_length)
    tiny = np.finfo(np.float32).tiny
    corr = np.where(wss > tiny, 1.0 / np.maximum(wss, tiny), 1.0)
    with torch.inference_mode(False):
        return torch.from_numpy(corr.astype(np.float32)).to(device)


# ---------------------------------------------------------------------------
# Tensor ops
# ---------------------------------------------------------------------------

def _reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """[B, T] reflect-padded by ``pad`` on both sides.  Where ``pad >= T``
    the reflection repeats, as ``np.pad`` / ``jnp.pad(mode="reflect")`` do:
    index arithmetic with period 2 (T - 1), a constant for T = 1."""
    T = y.shape[-1]
    if pad < T:
        return F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    i = torch.arange(-pad, T + pad, device=y.device)
    if T == 1:
        return y[:, torch.zeros_like(i)]
    j = torch.remainder(i, 2 * (T - 1))
    return y[:, torch.where(j >= T, 2 * (T - 1) - j, j)]


def frame_signal(y: torch.Tensor, filter_length: int,
                 hop_length: int) -> torch.Tensor:
    """Reflect-pad by filter_length//2 on both sides (librosa/reference
    stft.py:84-89) and cut into hop-strided frames.

    y: [B, T] → frames [B, n_frames, filter_length] (a strided view),
    n_frames = T // hop + 1."""
    y = _reflect_pad(y, filter_length // 2)
    return y.unfold(-1, filter_length, hop_length)


def _spectrum(frames: torch.Tensor, filter_length: int, hop_length: int,
              win_length: int):
    """frames [B, F, N] → (real, imag) [B, cutoff, F]: one matmul against
    the windowed Fourier basis, in f32 (f64 for f64 frames)."""
    fwd, _ = _bases_on(filter_length, hop_length, win_length, frames.device)
    x = frames if frames.dtype == torch.float64 else frames.float()
    spec = torch.matmul(x, fwd.to(x.dtype).t()).transpose(1, 2)
    cutoff = filter_length // 2 + 1
    return spec[:, :cutoff], spec[:, cutoff:]


def stft_magnitude(y: torch.Tensor, filter_length: int, hop_length: int,
                   win_length: int, return_phase: bool = False):
    """Forward STFT magnitude (and optionally phase) of [B, T] → [B, cutoff,
    n_frames]."""
    real, imag = _spectrum(frame_signal(y, filter_length, hop_length),
                           filter_length, hop_length, win_length)
    mag = torch.sqrt(real * real + imag * imag)
    if return_phase:
        return mag, torch.atan2(imag, real)
    return mag


def inverse_stft(magnitude: torch.Tensor, phase: torch.Tensor,
                 filter_length: int, hop_length: int,
                 win_length: int) -> torch.Tensor:
    """Inverse STFT (reference stft.py:107-136): the frames of the inverse
    basis, overlap-added in a fixed order, with the window-sum-square
    correction and edge trimming.  magnitude/phase: [B, cutoff, n_frames]
    → [B, (n_frames - 1) * hop]."""
    _, inv = _bases_on(filter_length, hop_length, win_length,
                       magnitude.device)
    n_frames = magnitude.shape[-1]
    recomb = torch.cat([magnitude * torch.cos(phase),
                        magnitude * torch.sin(phase)], dim=1)
    contrib = torch.matmul(recomb.transpose(1, 2), inv)       # [B, F, N]
    out_len = filter_length + hop_length * (n_frames - 1)
    sig = F.fold(contrib.transpose(1, 2), output_size=(1, out_len),
                 kernel_size=(1, filter_length),
                 stride=(1, hop_length))[:, 0, 0, :]
    sig = sig * _wss_correction_on(n_frames, filter_length, hop_length,
                                   win_length, magnitude.device)
    sig = sig * (float(filter_length) / hop_length)
    pad = filter_length // 2
    return sig[:, pad:-pad]


def dynamic_range_compression(x: torch.Tensor, C: float = 1.0,
                              clip_val: float = 1e-5) -> torch.Tensor:
    """log(clamp(x, clip_val) * C) — reference audio_processing.py:78-84."""
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x: torch.Tensor, C: float = 1.0) -> torch.Tensor:
    return torch.exp(x) / C


def mel_spectrogram(y: torch.Tensor, sampling_rate: int = 22050,
                    filter_length: int = 1024, hop_length: int = 256,
                    win_length: int = 1024, n_mel_channels: int = 80,
                    mel_fmin: float = 0.0,
                    mel_fmax: float = 8000.0) -> torch.Tensor:
    """[B, T] waveform in [-1, 1] → [B, n_mels, n_frames] log-mel, matching
    reference layers.py:63-80 (TacotronSTFT.mel_spectrogram)."""
    mag = stft_magnitude(y, filter_length, hop_length, win_length)
    fb = _mel_basis_on(sampling_rate, filter_length, n_mel_channels,
                       mel_fmin, mel_fmax, mag.device)
    return dynamic_range_compression(torch.matmul(fb.to(mag.dtype), mag))


def inv_mel_spec(mel: torch.Tensor, sampling_rate: int = 22050,
                 filter_length: int = 1024, hop_length: int = 256,
                 win_length: int = 1024, mel_fmin: float = 0.0,
                 mel_fmax: float = 8000.0, griffin_iters: int = 60,
                 scaling: float = 1000.0,
                 angles: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """log-mel [B, n_mels, T] → waveform via filterbank pseudo-inverse +
    Griffin-Lim (the reference's Audio.tools.inv_mel_spec, Audio/
    tools.py:45-61, including the spec_from_mel_scaling=1000 factor).
    ``angles`` / ``generator``: as ``griffin_lim``."""
    spec = mel_to_linear(mel, sampling_rate, filter_length, mel_fmin,
                         mel_fmax) * scaling
    wav = griffin_lim(spec, filter_length, hop_length, win_length,
                      n_iters=griffin_iters, angles=angles,
                      generator=generator)
    return wav / scaling


def mel_to_linear(mel: torch.Tensor, sampling_rate: int = 22050,
                  filter_length: int = 1024, mel_fmin: float = 0.0,
                  mel_fmax: float = 8000.0) -> torch.Tensor:
    """log-mel [B, n_mels, T] → linear magnitude [B, cutoff, T] through the
    filterbank's pseudo-inverse, floored at 1e-8."""
    inv_fb = _inv_mel_basis_on(sampling_rate, filter_length, mel.shape[1],
                               mel_fmin, mel_fmax, mel.device)
    return torch.clamp(torch.matmul(inv_fb, dynamic_range_decompression(mel)),
                       min=1e-8)


def hifigan_mel_spectrogram(y: torch.Tensor, n_fft: int = 1024,
                            num_mels: int = 80, sampling_rate: int = 22050,
                            hop_size: int = 256, win_size: int = 1024,
                            fmin: float = 0.0, fmax: float = 8000.0,
                            peak_normalize: bool = True) -> torch.Tensor:
    """The reference's HiFi-GAN-style mel path (reference utils.py:55-80):
    peak-normalize * 0.95, reflect pad (n_fft-hop)/2, no centering,
    sqrt(|.|^2 + 1e-9) magnitude, mel + log clip.  y: [B, T]."""
    if peak_normalize:
        peak = torch.amax(torch.abs(y), dim=1, keepdim=True)
        y = y / torch.clamp(peak, min=1e-9) * 0.95
    frames = _reflect_pad(y, (n_fft - hop_size) // 2).unfold(-1, n_fft,
                                                             hop_size)
    real, imag = _spectrum(frames, n_fft, hop_size, win_size)
    mag = torch.sqrt(real * real + imag * imag + 1e-9)
    fb = _mel_basis_on(sampling_rate, n_fft, num_mels, fmin, fmax, mag.device)
    return dynamic_range_compression(torch.matmul(fb.to(mag.dtype), mag))


def griffin_lim(magnitudes: torch.Tensor, filter_length: int, hop_length: int,
                win_length: int, n_iters: int = 30,
                angles: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Griffin-Lim phase reconstruction (reference audio_processing.py:59-75).
    magnitudes: [B, cutoff, n_frames] linear magnitude → [B, T] signal.

    The initial phases are ``angles`` when given, else uniform in
    [-pi, pi) from ``generator`` (on the magnitudes' device)."""
    if angles is None:
        angles = (torch.rand(magnitudes.shape, generator=generator,
                             device=magnitudes.device) * (2 * math.pi)
                  - math.pi)
    for _ in range(n_iters):
        signal = inverse_stft(magnitudes, angles, filter_length, hop_length,
                              win_length)
        _, angles = stft_magnitude(signal, filter_length, hop_length,
                                   win_length, return_phase=True)
    return inverse_stft(magnitudes, angles, filter_length, hop_length,
                        win_length)
