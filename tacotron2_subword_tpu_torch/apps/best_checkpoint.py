"""Checkpoint-sweep evaluation CLI of the port
(``tacotron2_subword_tpu/apps/best_checkpoint.py``; the reference's
best_checkpoint.py:436-597).

    python -m tacotron2_subword_tpu_torch.apps.best_checkpoint \
        --checkpoint-dir Outdir --script val.txt --gt-dir data/wav \
        --out-csv logging.csv [--g2p-lexicon lex] \
        [--hifigan-checkpoint g_... --hifigan-config c.json] \
        [--gate-threshold 0.5] [--max-decoder-steps N] \
        [--hparams "[k:v-k:v]"] [--device cpu]

For every ``checkpoint_*`` in the directory, in step order: synthesize the
validation script (``id|text`` lines), vocode each utterance, trim its
silence, and score it against ``{gt-dir}/{id}.wav``: MCD
(``eval.metrics.mcd_between_wavs``, at 16 kHz) and soft-DTW between the
log-mels of the trimmed and the ground-truth wav, divided by N + M
(``eval.metrics.softdtw_np``, gamma 1).  One row per checkpoint goes to a
CSV ledger (checkpoint, mcd_mean, softdtw_mean, silence_mean_s, failed,
n_utts; the reference's columns); checkpoints already in it are skipped,
so a sweep resumes.

As in the JAX CLI: the text front end runs once for the whole script
(NFKC-lowercased text -> phone IDs, crc32 subword IDs, zero [CLS]), padded
to multiples of 32 into one batch, and each checkpoint decodes that batch
with one ``models.tacotron2.infer`` (prenet masks from a generator seeded
0 per checkpoint); an utterance whose gate never fired counts as
``failed``; a wav that is all silence is not scored (the JAX CLI fails
on it).  ``--gate-threshold`` defaults to 0.5 (the reference's 0.001
stops a healthy gate within a few frames).  With ``--hparams
"[decode_quant:int8]"`` each decoder step runs K1 twice.  The vocoder is
HiFi-GAN from a reference-format ``g_*`` file (``--hifigan-checkpoint``,
the format ``apps.train_hifigan`` writes), else Griffin-Lim.  Mels of a
wav are taken over a reflect-padded 16384-sample bucket, keeping
``n // hop + 1`` frames.  The device is CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import re
import time
import unicodedata
from typing import Dict, List

import numpy as np
import torch

from tacotron2_subword_tpu_torch.config import TacotronConfig, create_config
from tacotron2_subword_tpu_torch.eval import metrics as EM
from tacotron2_subword_tpu_torch.models import tacotron2 as M
from tacotron2_subword_tpu_torch.ops import stft as S
from tacotron2_subword_tpu_torch.utils.audio import load_wav
from tacotron2_subword_tpu_torch.utils.platform import resolve_device


def list_checkpoints(dir_path: str, pattern: str = "checkpoint_*") -> List[str]:
    """Paths matching ``pattern`` with a trailing number, by that number."""
    out = []
    for p in glob.glob(os.path.join(dir_path, pattern)):
        m = re.search(r"(\d+)$", p)
        if m:
            out.append((int(m.group(1)), p))
    return [p for _, p in sorted(out)]


def read_ledger(path: str) -> Dict[str, Dict]:
    if not os.path.exists(path):
        return {}
    with open(path, newline="") as f:
        return {row["checkpoint"]: row for row in csv.DictReader(f)}


def append_ledger(path: str, row: Dict) -> None:
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row.keys()))
        if not exists:
            w.writeheader()
        w.writerow(row)


def prepare_batch(lines, t2s, cfg: TacotronConfig, device,
                  pad_to: int = 32) -> Dict[str, torch.Tensor]:
    """The text front end once for the whole script -> one batch padded to
    multiples of ``pad_to``, with zero [CLS] vectors and the true lengths."""
    from tacotron2_subword_tpu_torch.text.bert import hashed_subword_ids
    seqs, subs = [], []
    for _utt_id, text in lines:
        text = unicodedata.normalize("NFKC", text).lower()
        seqs.append(np.asarray(t2s.grapheme_to_sequence(text), np.int64))
        subs.append(np.asarray(hashed_subword_ids(text, cfg.sub_n_symbols),
                               np.int64))
    T_text = -(-max(len(s) for s in seqs) // pad_to) * pad_to
    T_sub = -(-max(len(s) for s in subs) // pad_to) * pad_to
    t = lambda a: torch.from_numpy(a).to(device)
    return dict(
        text=t(np.stack([np.pad(s, (0, T_text - len(s))) for s in seqs])),
        sub=t(np.stack([np.pad(s, (0, T_sub - len(s))) for s in subs])),
        cls=torch.zeros((len(seqs), cfg.bert_embedding_dim), device=device),
        t_lens=t(np.asarray([len(s) for s in seqs])),
        s_lens=t(np.asarray([len(s) for s in subs])))


def mel_bucketed(wav: np.ndarray, device, hop: int = 256,
                 bucket: int = 16384) -> np.ndarray:
    """log-mel [n_mels, n // hop + 1] of a wav of n samples, taken over the
    wav reflect-padded up to a multiple of ``bucket`` samples (zero-padded
    where the pad is not shorter than the wav), as the JAX CLI takes it."""
    n = len(wav)
    pad = -(-n // bucket) * bucket
    w = np.clip(wav, -1, 1).astype(np.float32)
    extra = pad - n
    if 0 < extra <= n - 1:
        w = np.pad(w, (0, extra), mode="reflect")
    else:
        w = np.pad(w, (0, extra))
    m = S.mel_spectrogram(torch.from_numpy(w[None]).to(device))[0]
    return m.cpu().numpy()[:, : n // hop + 1]


@torch.inference_mode()
def sweep(args) -> List[Dict]:
    """Score every checkpoint not in the ledger yet; returns their ledger
    rows, each with ``seconds``: its decode, vocode and metrics wall time
    (not written to the ledger)."""
    from tacotron2_subword_tpu_torch.apps.inference import (
        load_acoustic_model, load_vocoder, vocode_bucketed)
    from tacotron2_subword_tpu_torch.text import Text2Seq

    device = resolve_device(args.device)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    cfg = create_config(hparams_string=args.hparams)
    cfg = cfg.replace(max_decoder_steps=args.max_decoder_steps)
    t2s = Text2Seq(args.g2p_lexicon)
    vocode, _ = load_vocoder(args.hifigan_checkpoint, args.hifigan_config,
                             device)
    with open(args.script, encoding="utf-8") as f:
        lines = [l.strip().split("|", 1) for l in f if l.strip()]
    lines = lines[:args.max_utts]
    batch = prepare_batch(lines, t2s, cfg, device)

    # the ground-truth wavs and their mels are the same for every checkpoint
    gt_cache: Dict[str, tuple] = {}
    for utt_id, _text in lines:
        gt_path = os.path.join(args.gt_dir, f"{utt_id}.wav")
        if os.path.exists(gt_path):
            gt, _ = load_wav(gt_path)
            gt_cache[utt_id] = (gt, mel_bucketed(gt, device))

    ledger = read_ledger(args.out_csv)
    results = []
    for ckpt in list_checkpoints(args.checkpoint_dir):
        name = os.path.basename(ckpt)
        if name in ledger:
            print(f"{name}: already in ledger, skipping")
            continue
        params, bn_state = load_acoustic_model(ckpt, cfg, device)
        sync()
        t0 = time.perf_counter()
        out = M.infer(params, bn_state, cfg, batch["text"], batch["sub"],
                      batch["cls"], batch["cls"],
                      generator=torch.Generator(device=device).manual_seed(0),
                      gate_threshold=args.gate_threshold,
                      text_lengths=batch["t_lens"],
                      sub_lengths=batch["s_lens"])
        lens_b = out["mel_lengths"].tolist()
        ok_b = out["infer_ok"].tolist()
        t_decode = time.perf_counter() - t0
        t_vocode = t_metrics = 0.0

        mcds, sdtws, silences, failed = [], [], [], 0
        for i, (utt_id, _text) in enumerate(lines):
            if not ok_b[i]:
                failed += 1
                continue
            t1 = time.perf_counter()
            wav = vocode_bucketed(vocode, out["mel_postnet"][i:i + 1],
                                  [lens_b[i]], hop=cfg.hop_length)[0]
            wav = wav.float().cpu().numpy()
            t2 = time.perf_counter()
            t_vocode += t2 - t1
            trimmed, start, _ = EM.trim_silence(wav, fs=cfg.sampling_rate)
            silences.append(start / cfg.sampling_rate)
            # all silence leaves nothing to score (the JAX CLI fails there)
            if utt_id in gt_cache and len(trimmed):
                gt, gt_mel = gt_cache[utt_id]
                mcd = EM.mcd_between_wavs(trimmed, gt, fs=cfg.sampling_rate)
                if mcd is not None:
                    mcds.append(mcd)
                # soft-DTW between the mels of both wavs (reference
                # best_checkpoint.py:422-433)
                syn_mel = mel_bucketed(trimmed, device)
                D = ((syn_mel.T[:, None, :]
                      - gt_mel.T[None, :, :]) ** 2).sum(-1)
                sdtws.append(EM.softdtw_np(D, gamma=1.0)
                             / (D.shape[0] + D.shape[1]))
            t_metrics += time.perf_counter() - t2

        row = {
            "checkpoint": name,
            "mcd_mean": round(float(np.mean(mcds)), 4) if mcds else "",
            "softdtw_mean": round(float(np.mean(sdtws)), 4) if sdtws else "",
            "silence_mean_s": round(float(np.mean(silences)), 4)
                               if silences else "",
            "failed": failed,
            "n_utts": len(lines),
        }
        append_ledger(args.out_csv, row)
        seconds = {"decode": t_decode, "vocode": t_vocode,
                   "metrics": t_metrics}
        results.append({**row, "seconds": seconds})
        print(row, "seconds:", {k: round(v, 3) for k, v in seconds.items()},
              flush=True)
    return results


def build_argparser() -> argparse.ArgumentParser:
    from tacotron2_subword_tpu_torch.text.g2p import default_resources_dir
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--script", required=True)
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--out-csv", default="logging.csv")
    p.add_argument("--g2p-lexicon", default=os.path.join(
        default_resources_dir(),
        "all-vietnamese-syllables_17k9.XSAMPA.Mien-BAC_KA.txt"))
    p.add_argument("--hifigan-checkpoint", default=None)
    p.add_argument("--hifigan-config", default=None)
    p.add_argument("--max-decoder-steps", type=int, default=2000)
    p.add_argument("--max-utts", type=int, default=100)
    p.add_argument("--gate-threshold", type=float, default=0.5)
    p.add_argument("--hparams", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run there)")
    return p


def main(argv=None) -> List[Dict]:
    return sweep(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
