"""End-to-end GTA -> vocoder fine-tune smoke of the port (its counterpart
of the root ``tools/gta_vocoder_smoke.py``, with its flags and steps):
GTA mel extraction feeding a HiFi-GAN fine-tune, the reference's
production workflow, over the synthetic corpus with an acoustic
checkpoint.

    python -m tacotron2_subword_tpu_torch.tools.gta_vocoder_smoke \
        --data synth_data --checkpoint run/checkpoint_best --work gta_smoke \
        [--split val] [--n 16] [--iters 5] [--eval-n 2] [--report DIR] \
        [--corpus-wavs | --skip-wavs] [--eval-only] [--hparams "..."] \
        [--hifigan-config config.json] [--device cpu]

Steps:
 1. Griffin-Lim waveforms from the corpus's ground-truth mels (or, with
    ``--corpus-wavs``, the corpus's own phase-true wavs) ->
    {work}/wavs/placeholder_{i}.wav; the last --eval-n utterances are
    held out of the fine-tune (in {work}/eval_wavs/);
 2. ``python -m tacotron2_subword_tpu_torch.apps.gta``: teacher-forced
    mels from the acoustic checkpoint -> {work}/gta_mels/;
 3. ``python -m tacotron2_subword_tpu_torch.apps.train_hifigan`` on the
    (GTA mel, waveform) pairs for --iters steps;
 4. held-out mel-L1 (|mel(G(gta_mel)) - gt|, against the corpus mel and
    against the mel of the training audio) of the initial generator (seed
    1234, the CLI's) against the fine-tuned one, the wav-MCD of the
    fine-tuned HiFi-GAN and of Griffin-Lim against the ground-truth audio,
    and one held-out GTA mel vocoded -> {work}/vocoded.wav; ``--report``
    writes the table to {report}/gta_hifigan_finetune.md beside the wav.

Both subprocesses get ``--device`` (and ``--hparams`` / the HiFi-GAN
``--config``) passed through.  The device is CUDA unless ``--device cpu``
is given.  Griffin-Lim's initial phases come from a generator seeded 0.
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import torch
from scipy.io.wavfile import read as wav_read
from scipy.io.wavfile import write as wav_write

from tacotron2_subword_tpu_torch.apps.best_checkpoint import mel_bucketed
from tacotron2_subword_tpu_torch.eval.metrics import mcd_between_wavs
from tacotron2_subword_tpu_torch.models import hifigan as HG
from tacotron2_subword_tpu_torch.ops import stft as S
from tacotron2_subword_tpu_torch.utils.platform import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MEL_FLOOR = math.log(1e-5)
BUCKET = 64   # frames: one vocoder shape per bucket, cut back after


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--work", required=True)
    ap.add_argument("--split", default="val")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--eval-n", type=int, default=2,
                    help="trailing utterances held out of the fine-tune "
                         "for the before/after mel-L1 evaluation")
    ap.add_argument("--report", default=None,
                    help="directory to write gta_hifigan_finetune.md + the "
                         "fine-tuned-vocoder wav into")
    ap.add_argument("--hifigan-batch", type=int, default=2)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint interval for the fine-tune (default: "
                         "once at the end)")
    ap.add_argument("--log-interval", type=int, default=1)
    ap.add_argument("--resume", default=None,
                    help="pass through to train_hifigan --resume")
    ap.add_argument("--skip-wavs", action="store_true",
                    help="reuse {work}/wavs + gta_mels from a previous run "
                         "(steps 1-2 skipped)")
    ap.add_argument("--corpus-wavs", action="store_true",
                    help="use the corpus's phase-true ground-truth audio "
                         "({split}/wav/{i}.wav) instead of Griffin-Lim "
                         "renders")
    ap.add_argument("--eval-only", action="store_true",
                    help="skip the fine-tune too: evaluate the newest "
                         "g_* under {work}/hifigan (use with --skip-wavs)")
    ap.add_argument("--hparams", default=None,
                    help="the acoustic model's config, passed to apps.gta")
    ap.add_argument("--hifigan-config", default=None,
                    help="HiFi-GAN JSON config, passed to train_hifigan "
                         "(v1 without one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run there)")
    return ap


def main(argv=None) -> dict:
    """Returns {init and fine-tuned held-out mel-L1 (vs the corpus mel and
    vs mel(gt wav)), wav-MCD of HiFi-GAN and Griffin-Lim, ft_iters, the
    vocoded wav's path and samples}."""
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    dev_args = ["--device", str(dev)]
    base = os.path.join(args.data, args.split)
    wav_dir = os.path.join(args.work, "wavs")
    eval_wav_dir = os.path.join(args.work, "eval_wavs")
    gta_dir = os.path.join(args.work, "gta_mels")
    voc_dir = os.path.join(args.work, "hifigan")
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(eval_wav_dir, exist_ok=True)
    n_train = args.n - args.eval_n
    list_path = os.path.join(args.work, "list.txt")
    gl_gen = lambda: torch.Generator(device=dev).manual_seed(0)

    @torch.inference_mode()
    def griffin_lim(mel: np.ndarray) -> np.ndarray:
        """Griffin-Lim over the mel padded to a BUCKET multiple with the
        silence floor, cut to the true length."""
        T = mel.shape[1]
        pad_f = -(-T // BUCKET) * BUCKET
        m = np.pad(mel, ((0, 0), (0, pad_f - T)), constant_values=MEL_FLOOR)
        m_t = torch.from_numpy(m[None].astype(np.float32)).to(dev)
        return S.inv_mel_spec(m_t, generator=gl_gen())[0].cpu().numpy(
            )[: T * 256]

    # ---- 1. waveforms (held-out ones in their own dir) ----------------
    rows = []
    if args.skip_wavs:
        print("[1-2/4] --skip-wavs: reusing existing wavs + GTA mels",
              flush=True)
    else:
        for i in range(args.n):
            dur_path = os.path.join(base, "durations", f"{i}.npy")
            out_dir = wav_dir if i < n_train else eval_wav_dir
            wav_path = os.path.join(out_dir, f"placeholder_{i}.wav")
            if args.corpus_wavs:
                shutil.copy(os.path.join(base, "wav", f"{i}.wav"), wav_path)
            else:
                mel = np.load(os.path.join(base, "mels",
                                           f"ljspeech-mel-{i + 1:05d}.npy"))
                wav = griffin_lim(mel)
                wav = wav / max(1e-6, np.abs(wav).max()) * 0.8
                wav_write(wav_path, 22050, (wav * 32767).astype(np.int16))
            rows.append(f"{wav_path}|{dur_path}")
        with open(list_path, "w") as f:
            f.write("\n".join(rows) + "\n")
        print(f"[1/4] wrote {args.n} "
              f"{'corpus' if args.corpus_wavs else 'griffin-lim'} wavs "
              f"({args.eval_n} held out)", flush=True)

        # ---- 2. GTA extraction -------------------------------------------
        cmd = [sys.executable, "-m", "tacotron2_subword_tpu_torch.apps.gta",
               list_path, args.checkpoint, gta_dir,
               "--mel-dir", os.path.join(base, "mels"),
               "--sub-dir", os.path.join(base, "sub"),
               "--cls-dir", os.path.join(base, "cls"),
               "--batch-size", "8", *dev_args]
        if args.hparams:
            cmd += ["--hparams", args.hparams]
        subprocess.run(cmd, check=True, cwd=REPO)
        n_gta = len([f for f in os.listdir(gta_dir) if f.endswith(".npy")])
        print(f"[2/4] GTA mels extracted: {n_gta}", flush=True)
        if n_gta < args.n:
            raise RuntimeError(f"{n_gta} GTA mels for {args.n} utterances")

    # ---- 3. HiFi-GAN fine-tune on (GTA mel, audio) ---------------------
    if not args.eval_only:
        cmd = [sys.executable, "-m",
               "tacotron2_subword_tpu_torch.apps.train_hifigan",
               "-o", voc_dir, "--wav-dir", wav_dir, "--mel-dir", gta_dir,
               "--batch-size", str(args.hifigan_batch),
               "--iters", str(args.iters),
               "--log-interval", str(args.log_interval),
               "--iters-per-checkpoint", str(args.ckpt_every or args.iters),
               *dev_args]
        if args.hifigan_config:
            cmd += ["--config", args.hifigan_config]
        if args.resume:
            cmd += ["--resume", args.resume]
        subprocess.run(cmd, check=True, cwd=REPO)
    ckpts = sorted(f for f in os.listdir(voc_dir) if f.startswith("g_"))
    if not ckpts:
        raise RuntimeError("no fine-tuned generator checkpoint written")
    ft_iters = int(ckpts[-1].split("_")[1])
    print(f"[3/4] fine-tuned generator: {ckpts[-1]}", flush=True)

    # ---- 4. held-out mel-L1 before/after + vocode ----------------------
    h = (HG.HifiganConfig.from_json(args.hifigan_config)
         if args.hifigan_config else HG.HifiganConfig())
    gen_init = HG.init_generator(torch.Generator().manual_seed(1234), h,
                                 device=dev)
    sd = torch.load(os.path.join(voc_dir, ckpts[-1]), map_location="cpu",
                    weights_only=True)
    gen_ft = HG.import_torch_generator(sd["generator"], h, device=dev)

    @torch.inference_mode()
    def vocode_b(gen_params, gta: np.ndarray) -> np.ndarray:
        """The generator over a BUCKET-padded mel, cut to the true
        length."""
        T = gta.shape[1]
        pad_f = -(-T // BUCKET) * BUCKET
        m = np.pad(gta, ((0, 0), (0, pad_f - T)), constant_values=MEL_FLOOR)
        y = HG.generator_apply(gen_params, h, torch.from_numpy(
            m[None].astype(np.float32)).to(dev))[0, 0].cpu().numpy()
        # the upsampling factor on the raw output: 256 samples per frame
        if len(y) != pad_f * 256:
            raise AssertionError(f"generator gave {len(y)} samples for "
                                 f"{pad_f} frames")
        return y[: T * 256]

    def read_wav(path: str) -> np.ndarray:
        return wav_read(path)[1].astype(np.float32) / 32768.0

    def mel_l1(gen_params, idx: int):
        """Held-out mel-L1 of G(gta_mel): vs the corpus mel, and vs the
        mel of the audio the fine-tune trains against."""
        gta = np.load(os.path.join(gta_dir, f"placeholder_{idx}.npy"))
        gt = np.load(os.path.join(base, "mels",
                                  f"ljspeech-mel-{idx + 1:05d}.npy"))
        gt_wav_mel = mel_bucketed(read_wav(os.path.join(
            eval_wav_dir, f"placeholder_{idx}.wav")), dev)
        m = mel_bucketed(np.clip(vocode_b(gen_params, gta), -1, 1), dev)
        n = min(m.shape[-1], gt.shape[-1])
        n2 = min(m.shape[-1], gt_wav_mel.shape[-1])
        return (float(np.mean(np.abs(m[:, :n] - gt[:, :n]))),
                float(np.mean(np.abs(m[:, :n2] - gt_wav_mel[:, :n2]))))

    eval_ids = list(range(n_train, args.n))
    init_pairs = [mel_l1(gen_init, i) for i in eval_ids]
    ft_pairs = [mel_l1(gen_ft, i) for i in eval_ids]
    l1_init, l1_init_w = (float(np.mean([p[j] for p in init_pairs]))
                          for j in (0, 1))
    l1_ft, l1_ft_w = (float(np.mean([p[j] for p in ft_pairs]))
                      for j in (0, 1))
    print(f"[4/4] held-out mel-L1 vs gt_mel: init {l1_init:.4f} -> "
          f"fine-tuned {l1_ft:.4f}; vs mel(gt_wav): init {l1_init_w:.4f} "
          f"-> fine-tuned {l1_ft_w:.4f} ({ft_iters} iters, "
          f"{len(eval_ids)} utts)", flush=True)

    # wav-level MCD on the held-out GTA mels: the fine-tuned HiFi-GAN and
    # Griffin-Lim, both against the ground-truth audio
    def rms_match(y: np.ndarray, ref: np.ndarray) -> np.ndarray:
        """Loudness-equalize a vocoded output to the ground truth (both
        arms alike), so MCD's level coefficient compares spectra."""
        return y * (np.sqrt(np.mean(ref ** 2))
                    / max(np.sqrt(np.mean(y ** 2)), 1e-9))

    mcd_hifi, mcd_gl = [], []
    for i in eval_ids:
        gta = np.load(os.path.join(gta_dir, f"placeholder_{i}.npy"))
        gt = read_wav(os.path.join(eval_wav_dir, f"placeholder_{i}.wav"))
        y_hifi, y_gl = vocode_b(gen_ft, gta), griffin_lim(gta)
        if args.corpus_wavs:
            y_hifi, y_gl = rms_match(y_hifi, gt), rms_match(y_gl, gt)
        else:
            # the Griffin-Lim renders of the ground truth are 0.8-peak
            y_gl = y_gl / max(1e-6, np.abs(y_gl).max()) * 0.8
        m1 = mcd_between_wavs(np.clip(y_hifi, -1, 1), gt, fs=22050)
        m2 = mcd_between_wavs(np.clip(y_gl, -1, 1), gt, fs=22050)
        if m1 is not None and m2 is not None:
            mcd_hifi.append(m1)
            mcd_gl.append(m2)
    mcd_hifi_m = float(np.mean(mcd_hifi)) if mcd_hifi else float("nan")
    mcd_gl_m = float(np.mean(mcd_gl)) if mcd_gl else float("nan")
    print(f"held-out wav-MCD vs ground truth: fine-tuned HiFi-GAN "
          f"{mcd_hifi_m:.3f} vs Griffin-Lim {mcd_gl_m:.3f} "
          f"({len(mcd_hifi)} utts)", flush=True)

    y = vocode_b(gen_ft, np.load(os.path.join(
        gta_dir, f"placeholder_{eval_ids[0]}.npy")))
    if not np.isfinite(y).all():
        raise FloatingPointError("non-finite vocoded waveform")
    out_wav = os.path.join(args.work, "vocoded.wav")
    wav_write(out_wav, 22050, (np.clip(y, -1, 1) * 32767).astype(np.int16))
    print(f"vocoded {out_wav}: {len(y)} samples "
          f"({len(y) / 22050:.2f}s), rms {float(np.sqrt((y**2).mean())):.4f}")

    if args.report:
        os.makedirs(args.report, exist_ok=True)
        shutil.copy(out_wav, os.path.join(args.report,
                                          "vocoded_gta_hifigan.wav"))
        gt_note = ("Ground truth is the corpus's phase-true audio; both "
                   "arms are RMS-matched to it before MCD.\n\n"
                   if args.corpus_wavs else
                   "(the corpus 'ground-truth' audio is itself a "
                   "Griffin-Lim render: the GL row shares its artifact "
                   "family with the target)\n\n")
        with open(os.path.join(args.report, "gta_hifigan_finetune.md"),
                  "w") as f:
            f.write(
                "# GTA -> HiFi-GAN fine-tune (the port, device "
                f"{dev})\n\n"
                f"Acoustic checkpoint: `{args.checkpoint}`; "
                f"{n_train} train / {len(eval_ids)} held-out utterances; "
                f"{ft_iters} GAN fine-tune iters "
                "(apps/train_hifigan.py), GTA mels from apps/gta.py.\n\n"
                "| generator | mel-L1 vs gt_mel | mel-L1 vs mel(gt_wav) "
                "(training target) |\n"
                "|---|---|---|\n"
                f"| random init | {l1_init:.4f} | {l1_init_w:.4f} |\n"
                f"| fine-tuned ({ft_iters} iters) | {l1_ft:.4f} | "
                f"{l1_ft_w:.4f} |\n\n"
                "Held-out wav-MCD vs the ground-truth audio (16 kHz "
                "eval):\n\n"
                "| vocoder | wav-MCD |\n"
                "|---|---|\n"
                f"| fine-tuned HiFi-GAN | {mcd_hifi_m:.3f} |\n"
                f"| Griffin-Lim (60 iters) | {mcd_gl_m:.3f} |\n\n"
                + gt_note +
                "`vocoded_gta_hifigan.wav` is a held-out GTA mel vocoded "
                "by the fine-tuned generator.\n")
        print(f"report -> {args.report}/gta_hifigan_finetune.md")
    print("GTA -> HiFi-GAN fine-tune -> vocode: OK")
    return {"mel_l1_init": l1_init, "mel_l1_ft": l1_ft,
            "mel_l1_init_vs_wav": l1_init_w, "mel_l1_ft_vs_wav": l1_ft_w,
            "mcd_hifigan": mcd_hifi_m, "mcd_griffin_lim": mcd_gl_m,
            "ft_iters": ft_iters, "vocoded": out_wav, "samples": len(y)}


if __name__ == "__main__":
    main()
