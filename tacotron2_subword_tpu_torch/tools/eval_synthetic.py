"""Quality of trained checkpoints on the synthetic corpus
(``tools/make_synthetic_dataset.py``; the port's copy of the root
``tools/eval_synthetic.py``, with its flags, defaults and CSV): a
free-running decode from the val split's phone and subword IDs, then mel
soft-DTW and MCD against the ground-truth mels (the reference's acceptance
metrics, evaluation.py:70-117 / softdtw.py:75-97, at mel level: the
corpus has no recorded audio).

    python -m tacotron2_subword_tpu_torch.tools.eval_synthetic \
        --data synth_data --checkpoint run/checkpoint_best \
        [--sweep-dir RUN_DIR] [--gate-thresholds 0.5,0.001] [--n 16] \
        [--max-steps 256] [--hparams "[decode_quant:int8]"] \
        [--out-csv eval.csv] [--cpu]

One batched ``models.tacotron2.infer`` per (checkpoint, threshold) over
the first ``--n`` val utterances, their IDs padded to multiples of 16
(phones) and 8 (subwords); the prenet masks come from a
``torch.Generator`` seeded 100 at each decode.  With ``--hparams
"[decode_quant:int8]"`` each decoder step runs K1 twice, as on the
serving path.  The metrics run in numpy on the host: soft-DTW
(``eval.metrics.softdtw_np``, gamma 1) of the squared-distance matrix
divided by N + M, and MCD (``eval.metrics.mcd_from_mcep``) over the
DCT-II cepstra 1-13 of the log-mels.

``--sweep-dir`` evaluates every ``checkpoint_*`` of a run directory in
step order (``apps.best_checkpoint.list_checkpoints``), one summary row
per (checkpoint, threshold) appended to ``--out-csv`` as it is made; rows
already in that CSV are skipped, so a killed sweep resumes, and a CSV
whose header differs from the summary's columns stops the tool.  Without
it, ``--out-csv`` receives the per-utterance rows of the one checkpoint
(or the summaries when there are several thresholds).  Checkpoints are
the port's (``utils.checkpoint``; ``tools/orbax_to_torch.py`` converts
the JAX package's).  The tool runs on CUDA unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np
import torch

from tacotron2_subword_tpu_torch.apps.best_checkpoint import list_checkpoints
from tacotron2_subword_tpu_torch.config import TacotronConfig, create_config
from tacotron2_subword_tpu_torch.eval import metrics as EM
from tacotron2_subword_tpu_torch.models import tacotron2 as M
from tacotron2_subword_tpu_torch.utils import checkpoint as CK
from tacotron2_subword_tpu_torch.utils.platform import resolve_device

MASK_SEED = 100  # the JAX tool's PRNGKey(100)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--sweep-dir", default=None,
                    help="evaluate every checkpoint_* in this directory "
                         "(the reference best_checkpoint.py ledger, "
                         "best_checkpoint.py:436-597, at mel level)")
    ap.add_argument("--hparams", default=None)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--max-steps", type=int, default=256)
    ap.add_argument("--gate-thresholds", default=None,
                    help="comma-separated list; default = cfg value (the "
                         "reference's 0.001 is hair-trigger: a healthy "
                         "gate's noise floor is ~3e-3; 0.5 is the robust "
                         "setting)")
    ap.add_argument("--out-csv", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: CUDA)")
    return ap


def main(argv=None) -> dict:
    """Returns {ledger: the summary rows (read and new), rows and
    mel_postnet: the last decode's per-utterance rows and its postnet mels
    (numpy [n, n_mels, steps], None when nothing was decoded), decodes: per
    new (checkpoint, threshold) its steps_run and decode / metrics
    seconds}."""
    ap = build_argparser()
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    cfg = create_config(hparams_string=args.hparams)
    thresholds = ([float(t) for t in args.gate_thresholds.split(",")]
                  if args.gate_thresholds else [cfg.gate_threshold])
    if args.sweep_dir:
        ckpts = list_checkpoints(args.sweep_dir)
    else:
        if not args.checkpoint:
            ap.error("one of --checkpoint / --sweep-dir is required")
        ckpts = [args.checkpoint]

    batch = load_val_batch(args, device)
    ledger, rows, decodes, mel = [], [], [], None
    # the resumable ledger: each (checkpoint, gate) row is appended as it
    # is made and rows already present are skipped (the reference's
    # resumable CSV, best_checkpoint.py:444-456)
    sweep_csv = args.out_csv if args.sweep_dir else None
    done = set()
    if sweep_csv and os.path.exists(sweep_csv):
        with open(sweep_csv, newline="") as f:
            for r in csv.DictReader(f):
                done.add((r["checkpoint"], float(r["gate"])))
                ledger.append(r)
    for ckpt in ckpts:
        todo = [t for t in thresholds
                if (os.path.basename(ckpt), t) not in done]
        if not todo:
            print(f"{os.path.basename(ckpt)}: already in ledger, skipping",
                  flush=True)
            continue
        state, _meta = CK.load_checkpoint(ckpt, device)
        for thr in todo:
            summary, rows, timing, mel = eval_checkpoint(
                args, cfg, state, ckpt, thr, batch, device)
            ledger.append(summary)
            decodes.append({"checkpoint": os.path.basename(ckpt),
                            "gate": thr, **timing})
            print(f"{os.path.basename(ckpt)} gate={thr}: "
                  f"softdtw(mel)={summary['softdtw']:.4f}  "
                  f"MCD={summary['mcd']:.4f}  "
                  f"len_err={summary['len_err']*100:.1f}%  "
                  f"gate_ok={summary['gate_ok']}/{summary['n']}", flush=True)
            if sweep_csv:
                append_row(sweep_csv, summary)

    if args.out_csv and not sweep_csv:
        out_rows = ledger if len(ledger) > 1 else rows
        with open(args.out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(out_rows[0].keys()))
            w.writeheader()
            w.writerows(out_rows)
        print("wrote", args.out_csv)
    return {"ledger": ledger, "rows": rows, "mel_postnet": mel,
            "decodes": decodes}


def append_row(path: str, summary: dict) -> None:
    """Append one summary row, with a header if the file is new; an
    existing file's header must equal the summary's columns, or rows would
    land under the wrong ones."""
    new = not os.path.exists(path)
    if not new:
        with open(path, newline="") as f:
            header = next(csv.reader(f))
        if header != list(summary.keys()):
            raise SystemExit(
                f"{path} header {header} != current summary schema "
                f"{list(summary.keys())}; move the old ledger aside or use a "
                "new --out-csv name")
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(summary.keys()))
        if new:
            w.writeheader()
        w.writerow(summary)


def load_val_batch(args, device) -> dict:
    """The first ``args.n`` val utterances as one batch on ``device``: IDs
    padded to multiples of 16 (phones) and 8 (subwords), [CLS] vectors,
    true lengths, and the ground-truth mels (numpy, host)."""
    base = os.path.join(args.data, "val")
    raw = []
    for i in range(args.n):
        dur = np.load(os.path.join(base, "durations", f"{i}.npy"))
        raw.append((dur[:, 0].astype(np.int32),
                    np.load(os.path.join(base, "sub", f"{i}.npy"))))
    T_TEXT = -(-max(len(p) for p, _ in raw) // 16) * 16
    T_SUB = -(-max(len(s) for _, s in raw) // 8) * 8
    texts, subs, clss, gts, t_lens, s_lens = [], [], [], [], [], []
    for i in range(args.n):
        phones, sub_ids = raw[i]
        texts.append(np.pad(phones, (0, T_TEXT - len(phones))))
        subs.append(np.pad(sub_ids, (0, T_SUB - len(sub_ids))))
        clss.append(np.load(os.path.join(base, "cls", f"{i}.npy")))
        gts.append(np.load(os.path.join(base, "mels",
                                        f"ljspeech-mel-{i+1:05d}.npy")))
        t_lens.append(len(phones))
        s_lens.append(len(sub_ids))
    ids = lambda a: torch.from_numpy(np.stack(a).astype(np.int64)).to(device)
    return dict(text=ids(texts), sub=ids(subs),
                cls=torch.from_numpy(np.stack(clss).astype(np.float32)
                                     ).to(device),
                t_lens=torch.tensor(t_lens, device=device),
                s_lens=torch.tensor(s_lens, device=device), gts=gts)


def decode(state, cfg: TacotronConfig, batch: dict, thr: float,
           max_steps: int, device):
    """One batched free-running decode of ``batch`` at gate threshold
    ``thr``, the prenet masks from a generator seeded MASK_SEED."""
    with torch.inference_mode():
        return M.infer(state.params, state.bn_state, cfg, batch["text"],
                       batch["sub"], batch["cls"], batch["cls"],
                       generator=torch.Generator(device=device).manual_seed(
                           MASK_SEED),
                       max_steps=max_steps, gate_threshold=thr,
                       text_lengths=batch["t_lens"],
                       sub_lengths=batch["s_lens"])


def eval_checkpoint(args, cfg: TacotronConfig, state, ckpt: str, thr: float,
                    batch: dict, device):
    """(summary row, per-utterance rows, {steps_run, decode_s, metrics_s},
    the decode's postnet mels as numpy) of one checkpoint at one gate
    threshold."""
    import scipy.fftpack

    t0 = time.perf_counter()
    out = decode(state, cfg, batch, thr, args.max_steps, device)
    mel_b = out["mel_postnet"].float().cpu().numpy()
    lens_b = out["mel_lengths"].cpu().numpy()
    ok_b = out["infer_ok"].cpu().numpy()
    t1 = time.perf_counter()

    rows, sdtw_vals, mcd_vals, len_err = [], [], [], []
    for i in range(args.n):
        gt = batch["gts"][i]
        n_frames = int(lens_b[i])
        pred = mel_b[i, :, :max(n_frames, 2)]

        # mel soft-DTW, per frame pair  [reference softdtw.py]
        D = ((pred.T[:, None, :] - gt.T[None, :, :]) ** 2).sum(-1)
        sdtw = EM.softdtw_np(D, gamma=1.0) / (D.shape[0] + D.shape[1])
        # MCD over DTW-aligned cepstra: the MCD formula on the DCT-II
        # cepstra of the log-mels (the corpus's ground truth is mels)
        mcep_p = scipy.fftpack.dct(pred.T, type=2, norm="ortho")[:, 1:14]
        mcep_g = scipy.fftpack.dct(gt.T, type=2, norm="ortho")[:, 1:14]
        mcd = float(EM.mcd_from_mcep(mcep_p, mcep_g))
        sdtw_vals.append(sdtw)
        mcd_vals.append(mcd)
        len_err.append(abs(n_frames - gt.shape[1]) / gt.shape[1])
        rows.append({"utt": i, "gate": thr, "frames_pred": n_frames,
                     "frames_gt": gt.shape[1], "softdtw": round(sdtw, 4),
                     "mcd": round(mcd, 4),
                     "gate_ok": bool(ok_b[i])})

    summary = {
        "checkpoint": os.path.basename(ckpt), "step": int(state.step),
        "gate": thr, "n": len(rows), "softdtw": float(np.mean(sdtw_vals)),
        "mcd": float(np.mean(mcd_vals)), "len_err": float(np.mean(len_err)),
        "gate_ok": sum(r["gate_ok"] for r in rows),
    }
    timing = {"steps_run": int(out["steps_run"]), "decode_s": t1 - t0,
              "metrics_s": time.perf_counter() - t1}
    return summary, rows, timing, mel_b


if __name__ == "__main__":
    main()
