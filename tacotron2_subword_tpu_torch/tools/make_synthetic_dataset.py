"""Generate a synthetic but learnable TTS corpus in the reference's on-disk
format (the port's copy of the root ``tools/make_synthetic_dataset.py``,
with its flags, defaults, constants, random streams, file tree and rows).

    python -m tacotron2_subword_tpu_torch.tools.make_synthetic_dataset \
        --out synth_data --n-train 256 --n-val 32 [--seed 0] \
        [--from-text [--lexicon lex] [--tokenizer-json vibert_512.json]] \
        [--sub-vocab 512] [--no-wavs]

Files written (reference data_utils.py:48-86; the port's
``data/dataset.BertTacotron2Dataset`` reads them):
  {out}/{split}/mels/ljspeech-mel-%05d.npy  [80, T] log-mel  (index + 1)
  {out}/{split}/sub/{i}.npy                 subword token IDs
  {out}/{split}/cls/{i}.npy                 768-d "CLS" vector
  {out}/{split}/durations/{i}.npy           [T_text, 2]: phone IDs, frames
  {out}/{split}/wav/{i}.wav                 22050 Hz ground-truth audio
  {out}/train.txt, {out}/val.txt            rows "wav_path|durations_path"

The corpus is built audio-first.  Each phone ID maps to fixed
source-filter acoustics (a semitone offset off the utterance's base pitch,
3 formants, voiced or not, a fricative noise band, a duration); the
waveform is a harmonic oscillator bank with a sample-exact running phase
and fixed per-harmonic phase offsets, plus spectrally shaped noise; the
log-mel is then computed from the waveform with the math of
``ops/stft.mel_spectrogram`` (reflect pad, padded Hann window, slaney
filterbank, log compression), in float64 numpy on the host, so the same
seed gives the same bytes as the JAX package's tool.  The "CLS" vector
carries a per-utterance pitch shift, and the subword IDs are a function of
phone bigrams, so both conditioning paths carry information.

``--from-text``: each utterance is a random Vietnamese sentence from the
lexicon's syllables run through the port's text front end (NFKC,
lowercase, G2P -> phone IDs), with subword IDs from a trained tokenizer
(``--tokenizer-json``, e.g. ``tools/train_tokenizer.py``'s output; pass
the same file to inference) or the crc32 IDs the inference CLI uses, and
a zero CLS vector; ``{split}_text.txt`` ("id|sentence") is written beside
train.txt.  The default ``--lexicon`` is the reference lexicon under
``$T2S_RESOURCES_DIR``, else ``resources/``.
"""

from __future__ import annotations

import argparse
import functools
import os
import time
import unicodedata

import numpy as np

from tacotron2_subword_tpu_torch.text.g2p import default_resources_dir

N_PHONES = 64          # phone IDs drawn from [3, 3+N_PHONES)
SUB_VOCAB = 512        # subword IDs from phone bigram hash
MEL_CHANNELS = 80
CLS_DIM = 768
SR = 22050
HOP = 256
NFFT = 1024
BASE_F0 = 150.0        # utterance base pitch before CLS shift (Hz)
FADE = 128             # noise segment crossfade (samples)
GAIN = 0.30            # global calibration so peaks land ~0.5, never clip

# fixed per-harmonic phase offsets, shared by the whole corpus: the vocoder
# sees one consistent phase convention, and the crest factor stays
# moderate compared to a zero-phase impulse train
_PHI = np.random.RandomState(7).uniform(0, 2 * np.pi, 256)

LEXICON_NAME = "all-vietnamese-syllables_17k9.XSAMPA.Mien-BAC_KA.txt"


@functools.lru_cache(maxsize=None)
def phone_params(p: int):
    """Fixed source-filter acoustics for phone ID p."""
    rng = np.random.RandomState(1000 + p)
    return dict(
        dur=2 + (p % 5),                       # frames
        voiced=(p % 4) != 3,                   # 75% voiced
        level=0.5 + 0.5 * rng.rand(),
        semitones=(p * 7) % 13 - 6,            # -6..+6 off the base f0
        formants=np.array([280.0 + 620.0 * rng.rand(),
                           950.0 + 1550.0 * rng.rand(),
                           2500.0 + 1000.0 * rng.rand()]),
        bandwidths=np.array([90.0, 120.0, 180.0]),
        fric_center=2500.0 + 4500.0 * rng.rand(),
        fric_width=800.0 + 1200.0 * rng.rand(),
    )


def formant_envelope(f: np.ndarray, prm) -> np.ndarray:
    """Spectral envelope |H(f)|: 3 Lorentzian resonances and a tilt of
    about -6 dB per octave, over any frequency grid."""
    gains = (1.0, 0.63, 0.32)
    env = np.zeros_like(f, dtype=np.float64)
    for g, F, B in zip(gains, prm["formants"], prm["bandwidths"]):
        env += g / (1.0 + ((f - F) / B) ** 2)
    return env / (1.0 + (f / 4000.0) ** 2)


def noise_envelope(f: np.ndarray, prm) -> np.ndarray:
    """Noise-source spectral shape: the fricative band for unvoiced phones,
    faint broadband breath for voiced ones."""
    if prm["voiced"]:
        return 0.05 * formant_envelope(f, prm)
    band = np.exp(-0.5 * ((f - prm["fric_center"]) / prm["fric_width"]) ** 2)
    return 0.9 * band + 0.05 / (1.0 + (f / 4000.0) ** 2)


def synth_wav(phones: np.ndarray, pitch_shift_st: float = 0.0,
              noise_seed: int = 0):
    """Phones -> (waveform [n], durations [len(phones)]), n = sum(durations)
    * HOP: a harmonic bank with a sample-exact running phase plus per-phone
    FFT-shaped noise with raised-cosine crossfades."""
    prms = [phone_params(int(p)) for p in phones]
    durs = np.array([q["dur"] for q in prms], np.int64)
    edges = np.concatenate([[0], np.cumsum(durs)])
    total = int(edges[-1])
    n = total * HOP

    # frame-rate control tracks
    fidx = np.repeat(np.arange(len(phones)), durs)          # frame -> phone
    st = np.array([q["semitones"] for q in prms])[fidx].astype(np.float64)
    t_fr = (np.arange(total) + 0.5) * HOP / SR
    declination = -2.0 * np.arange(total) / max(total, 1)   # -2 st over utt
    vibrato = 0.15 * np.sin(2 * np.pi * 5.5 * t_fr)
    f0_fr = BASE_F0 * 2.0 ** ((pitch_shift_st + st + declination + vibrato)
                              / 12.0)
    level_fr = np.array([q["level"] for q in prms])[fidx]
    voiced_fr = np.array([1.0 if q["voiced"] else 0.0 for q in prms])[fidx]

    # harmonic amplitudes at frame rate: A[k, t] = env(k * f0[t]) * level *
    # voiced, tapered above 7.5 kHz so the band edge is smooth
    f0_min = float(f0_fr.min())
    K = min(int(8300.0 / f0_min), _PHI.size)
    k = np.arange(1, K + 1, dtype=np.float64)
    fk = k[:, None] * f0_fr[None, :]                        # [K, T]
    A = np.zeros((K, total))
    for i, q in enumerate(prms):
        s, e = edges[i], edges[i + 1]
        A[:, s:e] = formant_envelope(fk[:, s:e], q)
    taper = np.clip((8300.0 - fk) / 800.0, 0.0, 1.0)
    A *= taper * (level_fr * voiced_fr)[None, :]

    # sample rate: upsample the amplitudes, integrate the phase
    pos = np.arange(n) / HOP - 0.5                          # frame coords
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, total - 1)
    i1 = np.minimum(i0 + 1, total - 1)
    w = np.clip(pos - i0, 0.0, 1.0)
    f0_s = f0_fr[i0] * (1.0 - w) + f0_fr[i1] * w
    phase = 2.0 * np.pi * np.cumsum(f0_s) / SR
    A_s = (A[:, i0] * (1.0 - w)[None, :]
           + A[:, i1] * w[None, :]).astype(np.float32)
    wav = np.einsum(
        "kn,kn->n", A_s,
        np.sin(np.outer(k, phase) + _PHI[:K, None]).astype(np.float32))

    # shaped noise, per phone segment with crossfades
    nrng = np.random.RandomState(noise_seed)
    noise = np.zeros(n + 2 * FADE, np.float32)
    for i, q in enumerate(prms):
        s, e = int(edges[i]) * HOP, int(edges[i + 1]) * HOP
        m = e - s + 2 * FADE
        x = nrng.randn(m)
        f = np.fft.rfftfreq(m, 1.0 / SR)
        x = np.fft.irfft(np.fft.rfft(x) * noise_envelope(f, q), m)
        ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(FADE) / FADE)
        x[:FADE] *= ramp
        x[-FADE:] *= ramp[::-1]
        noise[s:s + m] += (q["level"] * x).astype(np.float32)
    wav += 1.4 * noise[FADE:FADE + n]

    wav = np.clip(GAIN * wav, -0.98, 0.98).astype(np.float32)
    return wav, durs.astype(np.int32)


def mel_from_wav(wav: np.ndarray, n_frames: int) -> np.ndarray:
    """Waveform -> [80, n_frames] log-mel with the math of
    ``ops/stft.mel_spectrogram`` (reflect pad, padded-Hann windowed DFT,
    slaney filterbank, log compression), by numpy's rfft in float64."""
    from tacotron2_subword_tpu_torch.ops import stft as S

    pad = NFFT // 2
    y = np.pad(wav.astype(np.float64), (pad, pad), mode="reflect")
    m = (len(y) - NFFT) // HOP + 1
    idx = (np.arange(m)[:, None] * HOP + np.arange(NFFT)[None, :])
    frames = y[idx] * S._padded_window(NFFT, NFFT)[None, :]
    mag = np.abs(np.fft.rfft(frames, axis=1)).T                # [513, m]
    fb = S.mel_filterbank(SR, NFFT, MEL_CHANNELS, 0.0, 8000.0)
    mel = np.log(np.maximum(fb @ mag, 1e-5))
    assert mel.shape[1] >= n_frames
    return mel[:, :n_frames].astype(np.float32)


def make_utterance(rng: np.random.RandomState):
    n = rng.randint(8, 24)
    phones = rng.randint(3, 3 + N_PHONES, n).astype(np.int32)
    # CLS encodes a global pitch shift in [-6, 6] semitones
    shift = float(rng.uniform(-6, 6))
    cls = np.zeros(CLS_DIM, np.float32)
    cls[:64] = shift / 6.0
    cls[64:128] = rng.randn(64) * 0.01  # distractor noise
    wav, durs = synth_wav(phones, shift, noise_seed=rng.randint(1 << 30))
    mel = mel_from_wav(wav, int(durs.sum()))
    durations = np.stack([phones, durs], axis=1)
    # subword IDs: phone-bigram hash, one per non-overlapping pair
    pairs = phones[: (n // 2) * 2].reshape(-1, 2)
    sub = ((pairs[:, 0] * 131 + pairs[:, 1] * 7) % (SUB_VOCAB - 3) + 3
           ).astype(np.int32)
    return phones, durations, sub, cls, mel, wav


def load_syllables(lexicon_path: str, limit: int = 4000):
    """First column of the reference lexicon: the Vietnamese syllables the
    sentences are composed from."""
    sylls = []
    with open(lexicon_path, encoding="utf-8") as f:
        for line in f:
            w = line.split()[0] if line.strip() else ""
            if w and all(not c.isdigit() for c in w):
                sylls.append(w)
            if len(sylls) >= limit:
                break
    return sylls


def make_text_utterance(rng, sylls, t2s, sub_vocab: int, tokenizer=None):
    """Real text -> the front end -> phase-true synthesized audio.
    ``tokenizer`` (a ``text.bert.SubwordTokenizer``) replaces the crc32 IDs
    when given (reference data_utils.py:15-26)."""
    from tacotron2_subword_tpu_torch.text.bert import hashed_subword_ids

    n_words = rng.randint(4, 11)
    text = " ".join(sylls[rng.randint(len(sylls))] for _ in range(n_words))
    norm = unicodedata.normalize("NFKC", text).lower()
    phones = np.asarray(t2s.grapheme_to_sequence(norm), np.int32)
    if tokenizer is not None:
        sub = tokenizer.encode(norm) % sub_vocab  # as the inference CLI
    else:
        sub = hashed_subword_ids(norm, sub_vocab)
    cls = np.zeros(CLS_DIM, np.float32)  # the inference-time fallback
    wav, durs = synth_wav(phones, 0.0, noise_seed=rng.randint(1 << 30))
    mel = mel_from_wav(wav, int(durs.sum()))
    durations = np.stack([phones, durs], axis=1)
    return text, phones, durations, sub, cls, mel, wav


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-train", type=int, default=256)
    ap.add_argument("--n-val", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--from-text", action="store_true",
                    help="compose real Vietnamese sentences and run the "
                         "G2P front end for phone IDs")
    ap.add_argument("--lexicon", default=os.path.join(
        default_resources_dir(), LEXICON_NAME))
    ap.add_argument("--sub-vocab", type=int, default=SUB_VOCAB,
                    help="must match the sub_n_symbols the model is "
                         "trained and run with (crc32 IDs)")
    ap.add_argument("--tokenizer-json", default=None,
                    help="trained tokenizers.Tokenizer JSON (e.g. "
                         "train_tokenizer's output): the subword stream of "
                         "--from-text instead of the crc32 IDs; pass the "
                         "same file to apps.inference --tokenizer-json")
    ap.add_argument("--no-wavs", action="store_true",
                    help="skip writing the ground-truth wavs (mels only)")
    return ap


def main(argv=None) -> dict:
    """Write the corpus; returns {split: (utterances, seconds)}."""
    ap = build_argparser()
    args = ap.parse_args(argv)

    t2s, sylls, tokenizer = None, None, None
    if args.from_text:
        from tacotron2_subword_tpu_torch.text import Text2Seq
        t2s = Text2Seq(args.lexicon)
        sylls = load_syllables(args.lexicon)
        if args.tokenizer_json:
            from tacotron2_subword_tpu_torch.text.bert import SubwordTokenizer
            tokenizer = SubwordTokenizer(args.tokenizer_json)
            if tokenizer.vocab_size > args.sub_vocab:
                ap.error(f"tokenizer vocab {tokenizer.vocab_size} exceeds "
                         f"--sub-vocab {args.sub_vocab}")
        print(f"front-end ready: {len(sylls)} syllables"
              + (f", tokenizer vocab {tokenizer.vocab_size}"
                 if tokenizer else " (crc32 subword fallback)"))

    from scipy.io.wavfile import write as wavwrite

    timing = {}
    for split, n, off in (("train", args.n_train, 0),
                          ("val", args.n_val, args.n_train)):
        t0 = time.perf_counter()
        base = os.path.join(args.out, split)
        for d in ("mels", "sub", "cls", "durations", "wav"):
            os.makedirs(os.path.join(base, d), exist_ok=True)
        rows, text_rows = [], []
        for i in range(n):
            rng = np.random.RandomState(args.seed * 999983 + off + i)
            if args.from_text:
                text, phones, durations, sub, cls, mel, wav = \
                    make_text_utterance(rng, sylls, t2s, args.sub_vocab,
                                        tokenizer)
                text_rows.append(f"{i}|{text}")
            else:
                phones, durations, sub, cls, mel, wav = make_utterance(rng)
            np.save(os.path.join(base, "mels", f"ljspeech-mel-{i+1:05d}.npy"),
                    mel)
            np.save(os.path.join(base, "sub", f"{i}.npy"), sub)
            np.save(os.path.join(base, "cls", f"{i}.npy"), cls)
            dur_path = os.path.join(base, "durations", f"{i}.npy")
            np.save(dur_path, durations)
            wav_path = os.path.join(base, "wav", f"{i}.wav")
            if not args.no_wavs:
                wavwrite(wav_path, SR,
                         np.clip(wav * 32768.0, -32768, 32767
                                 ).astype(np.int16))
                rows.append(f"{wav_path}|{dur_path}")
            else:
                rows.append(f"placeholder_{i}.wav|{dur_path}")
            if (i + 1) % 256 == 0:
                print(f"  {split}: {i + 1}/{n}", flush=True)
        with open(os.path.join(args.out, f"{split}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
        if text_rows:
            with open(os.path.join(args.out, f"{split}_text.txt"), "w",
                      encoding="utf-8") as f:
                f.write("\n".join(text_rows) + "\n")
        timing[split] = (n, time.perf_counter() - t0)
        print(f"{split}: {n} utterances under {base}")
    return timing


if __name__ == "__main__":
    main()
