"""GTA (ground-truth-aligned) mel dump CLI of the port
(``tacotron2_subword_tpu/apps/gta.py``; the reference's GTA.py:13-70).

    python -m tacotron2_subword_tpu_torch.apps.gta train.txt CHECKPOINT \
        MEL_OUT [--sub-dir subs --cls-dir cls] [--mel-dir mels] \
        [--batch-size 16] [--overwrite] [--hparams "[k:v-k:v]"] \
        [--device cpu]

Per training-list row ``wav_path|durations.npy``: the phone IDs are column
0 of the durations array, the target mel is computed from the wav by
``ops.stft.mel_spectrogram`` (or read from ``--mel-dir`` by ROW INDEX,
``ljspeech-mel-{i+1:05d}.npy``, as the JAX CLI reads it), the subword IDs
and [CLS] vector come from ``--sub-dir`` / ``--cls-dir`` as ``{i}.npy``
(zeros without them).  Utterances are sorted stably by mel length and
batched, text / subwords / mel padded to multiples of 16 / 8 / 64, and the
teacher-forced ``models.tacotron2.forward(training=False)`` output
``mel_postnet`` cut to each mel's length is saved as
``{mel_out}/{wav_basename}.npy``.  Rows whose output exists are skipped
unless ``--overwrite``.

The prenet's dropout stays on in eval (``prenet_dropout_always_on``), so a
dump is random: its masks come from one ``torch.Generator`` on the device,
seeded 0.  The checkpoint is a port checkpoint directory or a reference
torch ``checkpoint_*`` file (``apps.inference.load_acoustic_model``).  The
device is CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from tacotron2_subword_tpu_torch.apps.inference import load_acoustic_model
from tacotron2_subword_tpu_torch.config import TacotronConfig, create_config
from tacotron2_subword_tpu_torch.models import tacotron2 as M
from tacotron2_subword_tpu_torch.ops import stft as S
from tacotron2_subword_tpu_torch.utils.audio import load_wav
from tacotron2_subword_tpu_torch.utils.platform import resolve_device


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad(x: np.ndarray, n: int) -> np.ndarray:
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])])


def read_utterances(args, cfg: TacotronConfig) -> List[Dict]:
    """The rows still to dump: text, mel [n_mels, T], sub, cls, out_path."""
    with open(args.train_list, encoding="utf-8") as f:
        rows = [l.strip().split("|") for l in f if l.strip()]
    utts = []
    for i, row in enumerate(rows):
        wav_path, dur_path = row[0], row[-1]
        out_path = os.path.join(
            args.mel_out, os.path.splitext(os.path.basename(wav_path))[0]
            + ".npy")
        if os.path.exists(out_path) and not args.overwrite:
            continue
        text = np.load(dur_path)[:, 0].astype(np.int64)
        if args.mel_dir:
            mel = np.load(os.path.join(
                args.mel_dir, f"ljspeech-mel-{i + 1:05d}.npy")).astype(
                np.float32)
            if mel.shape[0] != cfg.n_mel_channels and \
                    mel.shape[1] == cfg.n_mel_channels:
                mel = mel.T
        else:
            wav = torch.from_numpy(np.clip(load_wav(wav_path)[0], -1, 1)[None])
            mel = S.mel_spectrogram(
                wav, cfg.sampling_rate, cfg.filter_length, cfg.hop_length,
                cfg.win_length, cfg.n_mel_channels, cfg.mel_fmin,
                cfg.mel_fmax)[0].numpy()
        sub = (np.load(os.path.join(args.sub_dir, f"{i}.npy")).astype(
            np.int64) if args.sub_dir else np.zeros(4, np.int64))
        cls = (np.load(os.path.join(args.cls_dir, f"{i}.npy")).astype(
            np.float32).reshape(-1) if args.cls_dir
            else np.zeros(cfg.bert_embedding_dim, np.float32))
        utts.append(dict(text=text, mel=mel, sub=sub, cls=cls,
                         out_path=out_path))
    return utts


def make_batch(chunk: List[Dict], device) -> Dict[str, torch.Tensor]:
    """One padded batch of ``forward``: text / sub / mel to multiples of
    16 / 8 / 64, with their true lengths."""
    T_text = _round_up(max(len(u["text"]) for u in chunk), 16)
    T_sub = _round_up(max(len(u["sub"]) for u in chunk), 8)
    T_mel = _round_up(max(u["mel"].shape[1] for u in chunk), 64)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    cls = t(np.stack([u["cls"] for u in chunk]))
    return {
        "text": t(np.stack([_pad(u["text"], T_text) for u in chunk])),
        "text_lengths": t(np.asarray([len(u["text"]) for u in chunk])),
        "sub": t(np.stack([_pad(u["sub"], T_sub) for u in chunk])),
        "sub_lengths": t(np.asarray([len(u["sub"]) for u in chunk])),
        "mels": t(np.stack([_pad(u["mel"], T_mel) for u in chunk])),
        "output_lengths": t(np.asarray([u["mel"].shape[1] for u in chunk])),
        "cls_phone": cls, "cls_sub": cls}


@torch.inference_mode()
def gta_synthesis(args) -> int:
    """Dump every row not dumped yet; returns the number of mels written."""
    device = resolve_device(args.device)
    cfg = create_config(hparams_string=args.hparams)
    params, bn_state = load_acoustic_model(args.checkpoint, cfg, device)
    os.makedirs(args.mel_out, exist_ok=True)
    utts = read_utterances(args, cfg)
    if not utts:
        print("nothing to do")
        return 0
    utts.sort(key=lambda u: u["mel"].shape[1])
    generator = torch.Generator(device=device).manual_seed(0)
    B = args.batch_size
    n_done = 0
    for s in range(0, len(utts), B):
        chunk = utts[s:s + B]
        batch = make_batch(chunk, device)
        out, _ = M.forward(params, bn_state, cfg, batch, training=False,
                           generator=generator)
        mel_pred = out["mel_postnet"].float().cpu().numpy()
        for k, u in enumerate(chunk):
            np.save(u["out_path"], mel_pred[k, :, :u["mel"].shape[1]])
            n_done += 1
        print(f"GTA batch {s // B}: {len(chunk)} utts "
              f"(T_mel={batch['mels'].shape[-1]}) done", flush=True)
    return n_done


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("train_list")
    p.add_argument("checkpoint")
    p.add_argument("mel_out")
    p.add_argument("--sub-dir", default=None)
    p.add_argument("--cls-dir", default=None)
    p.add_argument("--mel-dir", default=None,
                   help="read the mels (by row index) from this dir instead "
                        "of computing them from the wavs")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--hparams", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run there)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    return gta_synthesis(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
