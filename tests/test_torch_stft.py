"""The port's STFT ops and denoiser against the JAX package's, on the same
seeded numpy inputs, B = 1..3 and uneven signal lengths.

Tolerances, as max|port - jax| / max|jax|: the host constants bit-equal;
STFT magnitude and the mel spectrograms 1e-5 (one f32 matmul each, summed
in another order); the inverse STFT and the denoiser 1e-4 (two matmuls and
an overlap-add); Griffin-Lim with the JAX initial phases injected, 4
iterations, 1e-4.  An f64 signal's mels stay f64: 1e-10 absolute of the
same bases applied in float64 numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_subword_tpu.models import denoiser as JD
from tacotron2_subword_tpu.ops import stft as JS
from tacotron2_subword_tpu_torch.models import denoiser as TD
from tacotron2_subword_tpu_torch.ops import stft as TS
from tests.torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(1, 4096), (3, 5001), (2, 2309)]   # [B, T], T not a hop multiple
GEOMETRY = (1024, 256, 1024)                 # filter, hop, window


def _rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def _signal(shape, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(shape[1]) / 22050.0
    tone = np.sin(2 * np.pi * 440.0 * t)[None] * rng.uniform(0.2, 0.6,
                                                              (shape[0], 1))
    return (tone + 0.1 * rng.randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("fl,hop,wl", [(1024, 256, 1024), (512, 128, 400),
                                       (512, 100, 320)])
def test_constants_bit_equal(fl, hop, wl):
    for t, j in zip(TS.stft_bases(fl, hop, wl), JS.stft_bases(fl, hop, wl)):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(TS.window_sumsquare(7, fl, hop, wl),
                                  JS.window_sumsquare(7, fl, hop, wl))
    np.testing.assert_array_equal(TS.hann_window(wl), JS.hann_window(wl))
    for n_mels, fmax in ((80, 8000.0), (5, 11025.0)):
        np.testing.assert_array_equal(
            TS.mel_filterbank(22050, fl, n_mels, 0.0, fmax),
            JS.mel_filterbank(22050, fl, n_mels, 0.0, fmax))
    mels = np.linspace(0, 60, 13)
    np.testing.assert_array_equal(TS.mel_to_hz(mels), JS.mel_to_hz(mels))
    np.testing.assert_array_equal(TS.hz_to_mel(TS.mel_to_hz(mels)),
                                  JS.hz_to_mel(JS.mel_to_hz(mels)))


@pytest.mark.parametrize("shape", SHAPES)
def test_stft_and_mels_match_jax(shape):
    y = _signal(shape)
    yt, yj = torch.from_numpy(y), jnp.asarray(y)
    mag_t = TS.stft_magnitude(yt, *GEOMETRY)
    mag_j = JS.stft_magnitude(yj, *GEOMETRY)
    assert mag_t.shape == (shape[0], 513, shape[1] // 256 + 1)
    assert _rel(mag_t, mag_j) <= 1e-5
    assert _rel(TS.mel_spectrogram(yt), JS.mel_spectrogram(yj)) <= 1e-5
    assert _rel(TS.hifigan_mel_spectrogram(yt),
                JS.hifigan_mel_spectrogram(yj)) <= 1e-5
    frames = TS.frame_signal(yt, 1024, 256)
    np.testing.assert_array_equal(frames.numpy(),
                                  np.asarray(JS.frame_signal(yj, 1024, 256)))


@pytest.mark.parametrize("n", [400, 300])
def test_mels_of_signals_shorter_than_the_pad_match_jax(n):
    """A signal no longer than the reflect pad (512 for mel_spectrogram,
    384 for hifigan_mel_spectrogram) reflects repeatedly, as jnp.pad."""
    y = _signal((2, n), seed=3)
    yt, yj = torch.from_numpy(y), jnp.asarray(y)
    got, want = TS.mel_spectrogram(yt), JS.mel_spectrogram(yj)
    assert got.shape == (2, 80, n // 256 + 1)
    assert _rel(got, want) <= 1e-5
    assert _rel(TS.hifigan_mel_spectrogram(yt),
                JS.hifigan_mel_spectrogram(yj)) <= 1e-5


@pytest.mark.parametrize("n,pad", [(1, 5), (3, 10), (7, 512), (400, 512),
                                   (513, 512)])
def test_reflect_pad_matches_numpy(n, pad):
    y = np.random.RandomState(n).randn(2, n).astype(np.float32)
    np.testing.assert_array_equal(
        TS._reflect_pad(torch.from_numpy(y), pad).numpy(),
        np.pad(y, ((0, 0), (pad, pad)), mode="reflect"))


@pytest.mark.parametrize("shape", SHAPES)
def test_inverse_stft_matches_jax(shape):
    rng = np.random.RandomState(1)
    n_frames = shape[1] // 256 + 1
    mag = rng.rand(shape[0], 513, n_frames).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    got = TS.inverse_stft(torch.from_numpy(mag), torch.from_numpy(phase),
                          *GEOMETRY)
    want = JS.inverse_stft(jnp.asarray(mag), jnp.asarray(phase), *GEOMETRY)
    assert got.shape == (shape[0], (n_frames - 1) * 256)
    assert _rel(got, want) <= 1e-4
    # and it inverts the forward transform
    y = _signal(shape)
    m, p = TS.stft_magnitude(torch.from_numpy(y), *GEOMETRY,
                             return_phase=True)
    back = TS.inverse_stft(m, p, *GEOMETRY)
    n = min(back.shape[1], shape[1])
    assert _rel(back[:, :n], y[:, :n]) <= 1e-4


def _toy_vocoder(xp, mel):
    """A fixed mel → audio map [1, M, T] → [1, 256 T], in jnp or torch."""
    level = xp.mean(mel, 1)                               # [1, T]
    up = xp.repeat(level, 256, 1) if xp is jnp else level.repeat_interleave(
        256, 1)
    t = xp.arange(up.shape[1]) / 22050.0
    return 0.05 * xp.sin(2 * np.pi * 220.0 * t)[None] + 1e-3 * up


@pytest.mark.parametrize("shape", SHAPES)
def test_denoiser_matches_jax(shape):
    bt = TD.compute_bias_spec(lambda m: _toy_vocoder(torch, m),
                              n_mel_channels=5)
    bj = JD.compute_bias_spec(lambda m: _toy_vocoder(jnp, m),
                              n_mel_channels=5)
    assert bt.shape == (1, 513, 1)
    assert _rel(bt, bj) <= 1e-5
    y = _signal(shape) * 20000.0
    got = TD.denoise(torch.from_numpy(y), bt, strength=0.9)
    want = JD.denoise(jnp.asarray(y), bj, strength=0.9)
    assert got.shape == (shape[0], (shape[1] // 256) * 256)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("shape", SHAPES)
def test_griffin_lim_matches_jax_with_injected_angles(shape):
    mag = JS.stft_magnitude(jnp.asarray(_signal(shape, seed=2)), *GEOMETRY)
    key = jax.random.PRNGKey(0)
    angles = np.asarray(jax.random.uniform(key, mag.shape, minval=-np.pi,
                                           maxval=np.pi, dtype=jnp.float32))
    want = JS.griffin_lim(mag, *GEOMETRY, n_iters=4, key=key)
    got = TS.griffin_lim(torch.from_numpy(np.array(mag)), *GEOMETRY,
                         n_iters=4, angles=torch.from_numpy(angles.copy()))
    assert _rel(got, want) <= 1e-4
    # phases drawn from a generator: the same seed, the same signal
    g = lambda: torch.Generator().manual_seed(3)
    a = TS.griffin_lim(torch.from_numpy(np.array(mag)), *GEOMETRY, n_iters=1,
                       generator=g())
    b = TS.griffin_lim(torch.from_numpy(np.array(mag)), *GEOMETRY, n_iters=1,
                       generator=g())
    assert torch.equal(a, b)


def test_inv_mel_spec_matches_jax_through_the_same_phases():
    """The filterbank pseudo-inverse and scaling of ``inv_mel_spec``: with
    zero Griffin-Lim iterations the result is the iSTFT of the injected
    phases, so both packages see the same linear spectrum."""
    mel = JS.mel_spectrogram(jnp.asarray(_signal((2, 3000), seed=4)))
    key = jax.random.PRNGKey(0)
    want = JS.inv_mel_spec(mel, griffin_iters=0, key=key)
    angles = jax.random.uniform(key, (2, 513, mel.shape[-1]),
                                minval=-np.pi, maxval=np.pi)
    got = TS.inv_mel_spec(torch.from_numpy(np.array(mel)), griffin_iters=0,
                          angles=torch.from_numpy(np.array(angles)))
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("shape", SHAPES)
def test_f64_mels_stay_f64(shape):
    """An f64 waveform stays f64 through the STFT and the filterbank (the
    f64 witness of chip_smoke.py's GAN gradient trace): within 1e-10 of
    the same f32 bases applied in float64 numpy, where the f32 path lies
    further off."""
    y = _signal(shape).astype(np.float64)
    got = TS.mel_spectrogram(torch.from_numpy(y))
    assert got.dtype == torch.float64
    fwd, _ = TS.stft_bases(*GEOMETRY)
    frames = TS.frame_signal(torch.from_numpy(y), 1024, 256).numpy()
    spec = frames @ fwd.astype(np.float64).T           # [B, F, 2 x 513]
    mag = np.hypot(spec[..., :513], spec[..., 513:]).transpose(0, 2, 1)
    fb = TS.mel_filterbank(22050, 1024, 80, 0.0, 8000.0).astype(np.float64)
    want = np.log(np.maximum(fb @ mag, 1e-5))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    f32 = TS.mel_spectrogram(torch.from_numpy(y.astype(np.float32)))
    assert np.abs(f32.double().numpy() - want).max() > 1e-8
