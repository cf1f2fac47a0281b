"""Offline preprocessing CLI of the port (``tacotron2_subword_tpu/apps/
preprocess.py``: the reference's preprocess.py, preprocess/get{Phone,Mel}.py
and check_data.py entry points).

Subcommands:
  mels       wav dir -> per-utterance log-mel npys, computed on the device
             (``ops.stft.mel_spectrogram``), ``ljspeech-mel-%05d.npy`` by
             sorted index + 1 (preprocess/getMel.py)
  phones     ``id|text`` transcript -> phone-ID npys through Text2Seq
             (preprocess/getPhone.py)
  subwords   transcript -> subword-ID npys (a tokenizer JSON folded into
             ``--vocab``, else the crc32 fallback) and [CLS] npys (a local
             BERT model, else zeros) (preprocess.py:27-98)
  lists      train / val list files of ``wav|durations`` rows
  check      every path of a list file exists (check_data.py)

Text normalization is NFKC + lowercase (the reference calls an external
HTTP API, preprocess/getNorm.py); ``--norm-cmd`` runs a local normalizer
first.  ``mels`` runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import unicodedata

import numpy as np
import torch


def cmd_mels(args) -> int:
    from tacotron2_subword_tpu_torch.ops import stft as S
    from tacotron2_subword_tpu_torch.utils.audio import load_wav
    from tacotron2_subword_tpu_torch.utils.platform import resolve_device
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    wavs = sorted(glob.glob(os.path.join(args.wav_dir, "*.wav")))
    for i, path in enumerate(wavs):
        wav = np.clip(load_wav(path)[0], -1, 1)
        mel = S.mel_spectrogram(torch.from_numpy(wav[None]).to(device))[0]
        np.save(os.path.join(args.out_dir, f"ljspeech-mel-{i + 1:05d}.npy"),
                mel.cpu().numpy())
    print(f"wrote {len(wavs)} mels to {args.out_dir}")
    return len(wavs)


def _normalize(text: str, norm_cmd) -> str:
    if norm_cmd:
        out = subprocess.run(norm_cmd.split() + [text],
                             capture_output=True, text=True)
        if out.returncode == 0 and out.stdout.strip():
            text = out.stdout.strip()
    return unicodedata.normalize("NFKC", text).lower()


def _transcript(path: str):
    with open(path, encoding="utf-8") as f:
        return [l.strip().split("|", 1) for l in f if l.strip()]


def cmd_phones(args) -> int:
    from tacotron2_subword_tpu_torch.text import Text2Seq
    t2s = Text2Seq(args.g2p_lexicon)
    os.makedirs(args.out_dir, exist_ok=True)
    lines = _transcript(args.transcript)
    for i, (_, text) in enumerate(lines):
        seq = t2s.grapheme_to_sequence(_normalize(text, args.norm_cmd))
        np.save(os.path.join(args.out_dir, f"{i}.npy"),
                np.asarray(seq, np.int32))
    print(f"wrote {len(lines)} phone sequences to {args.out_dir}")
    return len(lines)


def cmd_subwords(args) -> int:
    from tacotron2_subword_tpu_torch.text.bert import hashed_subword_ids
    os.makedirs(args.sub_dir, exist_ok=True)
    os.makedirs(args.cls_dir, exist_ok=True)
    tokenizer = embedder = None
    if args.tokenizer_json and os.path.exists(args.tokenizer_json):
        from tacotron2_subword_tpu_torch.text.bert import SubwordTokenizer
        tokenizer = SubwordTokenizer(args.tokenizer_json)
    if args.bert_model and os.path.exists(args.bert_model):
        from tacotron2_subword_tpu_torch.text.bert import ClsEmbedder
        embedder = ClsEmbedder(args.bert_model)
    lines = _transcript(args.transcript)
    for i, (_, text) in enumerate(lines):
        text = _normalize(text, args.norm_cmd)
        # IDs folded into the embedding table, as the inference CLI folds
        # them into sub_n_symbols, so both see the same stream
        ids = (tokenizer.encode(text) % args.vocab if tokenizer is not None
               else hashed_subword_ids(text, args.vocab))
        np.save(os.path.join(args.sub_dir, f"{i}.npy"), ids)
        cls = (embedder.embed_cls(text) if embedder is not None
               else np.zeros(768, np.float32))
        np.save(os.path.join(args.cls_dir, f"{i}.npy"), cls)
    print(f"wrote {len(lines)} subword/cls pairs")
    return len(lines)


def cmd_lists(args) -> int:
    rows = []
    for dur in sorted(glob.glob(os.path.join(args.dur_dir, "*.npy"))):
        base = os.path.splitext(os.path.basename(dur))[0]
        rows.append(f"{os.path.join(args.wav_dir, base + '.wav')}|{dur}")
    n_val = max(1, int(len(rows) * args.val_fraction))
    os.makedirs(os.path.dirname(os.path.abspath(args.train_out)),
                exist_ok=True)
    with open(args.train_out, "w") as f:
        f.write("\n".join(rows[n_val:]) + "\n")
    with open(args.val_out, "w") as f:
        f.write("\n".join(rows[:n_val]) + "\n")
    print(f"{len(rows) - n_val} train / {n_val} val rows")
    return len(rows)


def cmd_check(args) -> int:
    """Returns the number of missing paths."""
    missing = 0
    with open(args.list_file, encoding="utf-8") as f:
        for line in f:
            for p in line.strip().split("|"):
                if p and not os.path.exists(p):
                    print("MISSING:", p)
                    missing += 1
    print(f"{missing} missing paths")
    return missing


def build_argparser() -> argparse.ArgumentParser:
    from tacotron2_subword_tpu_torch.text.g2p import default_resources_dir
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("mels")
    m.add_argument("--wav-dir", required=True)
    m.add_argument("--out-dir", required=True)
    m.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run there)")

    ph = sub.add_parser("phones")
    ph.add_argument("--transcript", required=True, help="id|text lines")
    ph.add_argument("--out-dir", required=True)
    ph.add_argument("--g2p-lexicon", default=os.path.join(
        default_resources_dir(),
        "all-vietnamese-syllables_17k9.XSAMPA.Mien-BAC_KA.txt"))
    ph.add_argument("--norm-cmd", default=None)

    sw = sub.add_parser("subwords")
    sw.add_argument("--transcript", required=True)
    sw.add_argument("--sub-dir", required=True)
    sw.add_argument("--cls-dir", required=True)
    sw.add_argument("--tokenizer-json", default=None)
    sw.add_argument("--bert-model", default=None)
    sw.add_argument("--vocab", type=int, default=5500)
    sw.add_argument("--norm-cmd", default=None)

    ls = sub.add_parser("lists")
    ls.add_argument("--wav-dir", required=True)
    ls.add_argument("--dur-dir", required=True)
    ls.add_argument("--train-out", required=True)
    ls.add_argument("--val-out", required=True)
    ls.add_argument("--val-fraction", type=float, default=0.02)

    ck = sub.add_parser("check")
    ck.add_argument("list_file")
    return p


COMMANDS = {"mels": cmd_mels, "phones": cmd_phones, "subwords": cmd_subwords,
            "lists": cmd_lists, "check": cmd_check}


def main(argv=None) -> int:
    """Runs one subcommand; returns its count (files written, rows, or
    missing paths for ``check``)."""
    args = build_argparser().parse_args(argv)
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    main()
