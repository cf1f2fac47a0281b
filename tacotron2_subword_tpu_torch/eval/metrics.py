"""Quality metrics: MCD, DTW, soft-DTW, F0, silence trimming (numpy, scipy).

The port's copy of ``tacotron2_subword_tpu/eval/metrics.py``, with the same
numbers: the reference computes MCD with pyworld (harvest F0, cheaptrick
envelope, 24 MCEP coefficients) and aligns with fastdtw (reference
evaluation.py:28-104); neither is installed, so

 - ``estimate_f0``: autocorrelation F0 with a voicing decision (the role of
   WORLD's harvest: selecting voiced frames);
 - ``mel_cepstrum``: MCEP as the DCT-II of the mel-warped, cepstrally
   liftered log envelope (the role of cheaptrick + code_spectral_envelope;
   absolute values are not WORLD's, rankings are);
 - ``dtw_path``: exact O(NM) DTW (what fastdtw approximates), swept by
   anti-diagonals: each cell takes the same min and the same one add as the
   row-by-row recursion, so the table and the path are the same to the bit;
 - ``softdtw_np``: soft-DTW of one distance matrix on the host (checkpoint
   sweeps, where every pair has another shape);
 - ``trim_silence``: dBFS-threshold leading/trailing trim (the reference's
   pydub scan, best_checkpoint.py:496-518).

MCD is the reference's formula (evaluation.py:96-98):
mean(10/ln10 * sqrt(2 * sum(diff^2))).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import scipy.fftpack

from tacotron2_subword_tpu_torch.ops.stft import (hann_window, hz_to_mel,
                                                  mel_to_hz)


# ---------------------------------------------------------------------------
# F0 (autocorrelation, voicing decision)
# ---------------------------------------------------------------------------

def estimate_f0(wav: np.ndarray, fs: int, frame_period: float = 5.0,
                f0_floor: float = 71.0, f0_ceil: float = 800.0,
                voicing_threshold: float = 0.3) -> np.ndarray:
    """Frame-wise F0 in Hz; 0 for unvoiced frames."""
    hop = int(fs * frame_period / 1000.0)
    win = int(fs * 0.04)  # 40 ms analysis window
    lag_min = int(fs / f0_ceil)
    lag_max = min(int(fs / f0_floor), win - 1)
    n_frames = max(0, (len(wav) - win) // hop + 1)
    f0 = np.zeros(n_frames)
    for t in range(n_frames):
        frame = wav[t * hop:t * hop + win].astype(np.float64)
        frame = frame - frame.mean()
        energy = np.sum(frame * frame)
        if energy < 1e-8:
            continue
        ac = np.correlate(frame, frame, mode="full")[win - 1:]
        ac = ac / (ac[0] + 1e-12)
        seg = ac[lag_min:lag_max]
        if seg.size == 0:
            continue
        peak = int(np.argmax(seg)) + lag_min
        if ac[peak] > voicing_threshold:
            f0[t] = fs / peak
    return f0


# ---------------------------------------------------------------------------
# Mel-cepstrum (MCEP)
# ---------------------------------------------------------------------------

def _spectral_envelope(wav: np.ndarray, fs: int, frame_period: float = 5.0,
                       n_fft: int = 1024,
                       f0_med: Optional[float] = None) -> np.ndarray:
    """Smoothed log power envelope [T, n_fft//2+1] by F0-adaptive cepstral
    liftering (the smoothing role of cheaptrick): DCT-I of the log
    periodogram, every quefrency at or above half the median pitch period
    zeroed, inverted.  Each frame is floored 60 dB under its peak, so
    digitally silent bands do not dominate the distance."""
    hop = int(fs * frame_period / 1000.0)
    win = hann_window(n_fft)
    n_frames = max(0, (len(wav) - n_fft) // hop + 1)
    sp = np.empty((n_frames, n_fft // 2 + 1))
    for t in range(n_frames):
        frame = wav[t * hop:t * hop + n_fft] * win
        sp[t] = np.abs(np.fft.rfft(frame)) ** 2 + 1e-10
    sp = np.maximum(sp, sp.max(axis=1, keepdims=True) * 1e-6)
    log_sp = np.log(sp)
    # DCT-I coefficient q sits at cepstral lag q samples; the first
    # rahmonic of an F0 voice at q = fs/F0: keep q < 0.5*fs/F0
    f0_med = f0_med if f0_med and f0_med > 0 else 160.0
    lifter = int(max(8, min(0.5 * fs / f0_med, log_sp.shape[1] - 1)))
    ceps = scipy.fftpack.dct(log_sp, type=1, axis=1)
    ceps[:, lifter:] = 0.0
    smooth = scipy.fftpack.idct(ceps, type=1, axis=1) \
        / (2 * (log_sp.shape[1] - 1))
    return smooth


def mel_cepstrum(wav: np.ndarray, fs: int, dim: int = 24,
                 frame_period: float = 5.0) -> Tuple[np.ndarray, np.ndarray]:
    """(mcep [T, dim], f0 [T]) on one frame grid: the DCT-II of the
    mel-warped smoothed log envelope, the liftering cutoff set by this
    utterance's median voiced F0."""
    f0 = estimate_f0(wav, fs, frame_period)
    voiced = f0[f0 > 0]
    f0_med = float(np.median(voiced)) if voiced.size else 0.0
    log_env = _spectral_envelope(wav, fs, frame_period, f0_med=f0_med)
    n_freqs = log_env.shape[1]
    freqs = np.linspace(0, fs / 2, n_freqs)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(fs / 2), 128))
    warped = np.empty((log_env.shape[0], 128))
    for t in range(log_env.shape[0]):
        warped[t] = np.interp(mel_pts, freqs, log_env[t])
    mcep = scipy.fftpack.dct(warped, type=2, axis=1, norm="ortho")[:, :dim]
    n = min(len(f0), mcep.shape[0])
    return mcep[:n], f0[:n]


# ---------------------------------------------------------------------------
# DTW (exact)
# ---------------------------------------------------------------------------

def dtw_path(x: np.ndarray, y: np.ndarray
             ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Exact DTW with euclidean local distance.  x [N, D], y [M, D] ->
    (total distance, path indices into x, path indices into y).

    D[i, j] = d[i-1, j-1] + min(min(D[i-1, j], D[i-1, j-1]), D[i, j-1]) for
    every cell of one anti-diagonal at once (all three lie on earlier
    ones)."""
    N, M = len(x), len(y)
    d = np.sqrt(np.maximum(
        (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
        - 2 * x @ y.T, 0.0))
    D = np.full((N + 1, M + 1), np.inf)
    D[0, 0] = 0.0
    for p in range(2, N + M + 1):
        i = np.arange(max(1, p - M), min(N, p - 1) + 1)
        j = p - i
        D[i, j] = d[i - 1, j - 1] + np.minimum(
            np.minimum(D[i - 1, j], D[i - 1, j - 1]), D[i, j - 1])
    i, j = N, M
    path_x, path_y = [], []
    while i > 0 and j > 0:
        path_x.append(i - 1)
        path_y.append(j - 1)
        moves = [(D[i - 1, j - 1], i - 1, j - 1), (D[i - 1, j], i - 1, j),
                 (D[i, j - 1], i, j - 1)]
        _, i, j = min(moves)
    return float(D[N, M]), np.asarray(path_x[::-1]), np.asarray(path_y[::-1])


# ---------------------------------------------------------------------------
# Soft-DTW (numpy, host-side)
# ---------------------------------------------------------------------------

def softdtw_np(D: np.ndarray, gamma: float = 1.0) -> float:
    """Soft-DTW value of one distance matrix [N, M] by the anti-diagonal
    recursion of ``ops.softdtw`` (R[-1,-1] = 0, other edges +INF, no band),
    in float64 on the host."""
    N, M = D.shape
    INF = 1e30
    r1 = np.full(N, INF)
    r2 = np.full(N, INF)
    rows = np.arange(N)
    for p in range(N + M - 1):
        j = p - rows
        valid = (j >= 0) & (j < M)
        d = np.where(valid, D[rows, np.clip(j, 0, M - 1)], INF)
        down = np.concatenate(([INF], r1[:-1]))    # (i-1, j)
        dd = np.concatenate(([INF], r2[:-1]))      # (i-1, j-1)
        if p == 0:
            dd[0] = 0.0
        z = np.stack([-down, -r1, -dd]) / gamma
        zmax = z.max(axis=0)
        sm = np.where(zmax <= -INF / 2, -INF,
                      gamma * (np.log(np.exp(z - zmax[None]).sum(axis=0))
                               + zmax))
        r_new = np.where(valid, d - sm, INF)
        r2, r1 = r1, r_new
    return float(r1[N - 1])


# ---------------------------------------------------------------------------
# MCD
# ---------------------------------------------------------------------------

MCD_CONST = 10.0 / np.log(10.0)


def mcd_from_mcep(src_mcc: np.ndarray, trg_mcc: np.ndarray) -> float:
    """DTW-aligned MCD (reference evaluation.py:91-98)."""
    _, px, py = dtw_path(src_mcc, trg_mcc)
    diff2sum = np.sum((src_mcc[px] - trg_mcc[py]) ** 2, axis=1)
    return float(np.mean(MCD_CONST * np.sqrt(2 * diff2sum)))


def resample_to(wav: np.ndarray, fs: int, target_fs: int) -> np.ndarray:
    """Polyphase resample (the role of librosa.load(sr=...), reference
    evaluation.py:75-76)."""
    if fs == target_fs:
        return wav
    import scipy.signal
    g = math.gcd(int(target_fs), int(fs))
    return scipy.signal.resample_poly(
        wav.astype(np.float64), target_fs // g, fs // g)


def mcd_between_wavs(src: np.ndarray, trg: np.ndarray, fs: int = 16000,
                     dim: int = 24, eval_fs: int = 16000
                     ) -> Optional[float]:
    """Waveforms at ``fs`` -> resampled to ``eval_fs`` (the reference always
    evaluates at 16 kHz) -> voiced-frame MCEPs -> DTW -> MCD; None when
    either side has no voiced frame."""
    src = resample_to(src, fs, eval_fs)
    trg = resample_to(trg, fs, eval_fs)
    src_mcc, src_f0 = mel_cepstrum(src, eval_fs, dim)
    trg_mcc, trg_f0 = mel_cepstrum(trg, eval_fs, dim)
    src_mcc = src_mcc[src_f0 > 0]
    trg_mcc = trg_mcc[trg_f0 > 0]
    if len(src_mcc) == 0 or len(trg_mcc) == 0:
        return None
    return mcd_from_mcep(src_mcc, trg_mcc)


# ---------------------------------------------------------------------------
# Silence trimming
# ---------------------------------------------------------------------------

def _dbfs(chunk: np.ndarray) -> float:
    rms = np.sqrt(np.mean(chunk.astype(np.float64) ** 2) + 1e-12)
    return 20 * np.log10(rms + 1e-12)


def detect_leading_silence(wav: np.ndarray, silence_threshold: float = -50.0,
                           chunk_size_ms: float = 10.0,
                           fs: int = 22050) -> int:
    """Sample index of the first chunk louder than the threshold (pydub's
    detect_leading_silence, reference remove_silence.py:7-20)."""
    chunk = max(1, int(fs * chunk_size_ms / 1000.0))
    pos = 0
    while pos + chunk <= len(wav):
        if _dbfs(wav[pos:pos + chunk]) > silence_threshold:
            return pos
        pos += chunk
    return len(wav)


def trim_silence(wav: np.ndarray, silence_threshold: float = -50.0,
                 chunk_size_ms: float = 10.0, fs: int = 22050
                 ) -> Tuple[np.ndarray, int, int]:
    """Trim leading and trailing silence; returns (trimmed, start, end)."""
    start = detect_leading_silence(wav, silence_threshold, chunk_size_ms, fs)
    tail = detect_leading_silence(wav[::-1], silence_threshold,
                                  chunk_size_ms, fs)
    end = len(wav) - tail
    if end <= start:
        return wav[:0], 0, 0
    return wav[start:end], start, end
