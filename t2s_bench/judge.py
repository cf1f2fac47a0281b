"""The output check: the plain reference judges what the timed path served.

For the sentences that the check reads (``traffic.check_rows`` of one
batch of the window), the reference, in float32 with TF32 off:
 - encodes both streams from the same IDs and [CLS] vectors;
 - runs the decoder teacher-forced on the frames the program served (step
   s reads served frame s - 1), with the prenet masks drawn again from the
   serving generator's state before that batch, and predicts each step's
   mel frame and gate logit;
 - runs the postnet on the program's decoder mel, and the vocoder on the
   program's postnet mel, bucketed and trimmed as served, then scaled and
   clipped to the int16 range.
Each served output is compared with the reference's prediction from the
same served inputs, as a served model's tokens are judged by the
reference's logits over the same prompt and tokens.

The vocoder is the reference module's ``vocode(G, cfg, mel, rows, batch,
frames, prec, generator)``: the gen tree, the configuration, the kept
rows' bucketed mels [k, n_mels, frames], their indices in the batch of
``batch`` sentences, the padded frame count, the precision, and a
callable that returns the serving generator as it stood after the
decode's last prenet mask draw (the decode draws one mask [4, batch,
prenet_dim] a step it ran).  It returns the waveforms [k, frames * hop]
before scaling.  A vocoder that draws random numbers (latents, noise)
draws them from the serving generator, right after the decode's last
mask draw; its reference states the shapes and order of those draws and
makes them from the generator the callable returns.  A vocoder that
draws none never calls it, and the check draws nothing more.

Numbers (each against its limit in the cell's file):
  mel_gap      widest gap of a decoder mel frame: |served - reference| (L2
               over the mel channels) over the sentence's RMS frame norm
  gate_gap     widest |served - reference| gate logit over valid steps
  postnet_gap  as mel_gap, of the postnet mel
  wav_gap      widest RMS gap of a 256-sample stretch of the wav, as a share
               of the int16 full scale (32768): the program's rounding
               errors are about constant in int16 units from seed to seed,
               while a sentence's RMS moves ten-fold with the random weights
  stop_off     sentences whose length is not where their served gate first
               passed the threshold (the step limit where it never did)
  failed       sentences of the window that hit the step limit or gave a
               non-finite or wrong-length wav
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

MAX_WAV_VALUE = 32768.0 * 1.7
FULL_SCALE = 32768.0
MEL_FLOOR = math.log(1e-5)
MIN_FRAMES = 8
BUCKET = 64
PRENET_DROPOUT = 0.5


class Kept(NamedTuple):
    """What the window kept of one batch for the check."""
    batch: int                 # index in the window
    rows: np.ndarray           # the sentences read, sorted
    n: np.ndarray              # every sentence's frames (mel_lengths)
    steps_run: int
    gen_state: torch.Tensor    # the serving generator's state before it
    mel: torch.Tensor          # [rows, n_mels, S] decoder mel, served
    mel_postnet: torch.Tensor  # [rows, n_mels, S]
    gate: torch.Tensor         # [rows, S] gate logits
    wavs: List[np.ndarray]     # the rows' wavs as served (host)


@contextlib.contextmanager
def tf32_off():
    """float32 matmuls and convolutions without TF32, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def vocoder_frames(n: np.ndarray) -> np.ndarray:
    return np.maximum(n, MIN_FRAMES)


def outputs(ref, cfg: dict, tree: dict, requests, kept: Kept, prec,
            device) -> Dict[str, object]:
    """The reference's predictions, at precision ``prec``, for the kept
    rows: "mel" [k, n_mels, steps], "gate" [k, steps], "mel_postnet"
    [k, n_mels, S], "wav" (list of host arrays)."""
    t = cfg["tacotron"]
    P, bn, G = tree["params"], tree["bn"], tree["gen"]
    rows = kept.rows
    sel = [requests[i] for i in rows]
    B = len(requests)

    def ids(j):
        T = max(len(r[j]) for r in requests)
        out = np.zeros((len(sel), T), np.int64)
        for i, r in enumerate(sel):
            out[i, :len(r[j])] = r[j]
        return (torch.from_numpy(out).to(device),
                torch.tensor([len(r[j]) for r in sel], device=device))

    with torch.no_grad(), tf32_off():
        (text, t_len), (sub, s_len) = ids(0), ids(1)
        cls_p = torch.from_numpy(np.stack([r[2] for r in sel])).to(device)
        cls_s = torch.from_numpy(np.stack([r[3] for r in sel])).to(device)
        mem = ref.encode(P, bn, "", text, t_len, cls_p, prec)
        mem_b = ref.encode(P, bn, "_sub", sub, s_len, cls_s, prec)

        g = torch.Generator(device=device)
        g.set_state(kept.gen_state)
        idx = torch.as_tensor(rows, device=device)
        scale = 1.0 / (1.0 - PRENET_DROPOUT)
        drawn = 0

        def draw():
            nonlocal drawn
            drawn += 1
            return torch.rand((4, B, t["prenet_dim"]), generator=g,
                              device=device)

        def masks(_step):
            keep = draw() < 1.0 - PRENET_DROPOUT
            return keep[:, idx].float() * scale

        def after_decode():
            while drawn < kept.steps_run:
                draw()
            return g

        n = kept.n[rows]
        mel, gate = ref.decode_teacher_forced(
            P, t, mem, mem_b, t_len, s_len, kept.mel, int(n.max()), masks,
            prec)
        mel_postnet = ref.postnet(P, bn, kept.mel, prec)

        nv = vocoder_frames(kept.n)
        pad_to = -(-int(nv.max()) // BUCKET) * BUCKET
        x = ref.bucket(kept.mel_postnet, nv[rows], pad_to, MEL_FLOOR)
        hop = t["hop_length"]
        w = ref.vocode(G, cfg, x, rows, B, pad_to, prec, after_decode)
        w = torch.clamp(w * MAX_WAV_VALUE, -32768.0, 32767.0)
        wavs = [w[j, :nv[r] * hop].cpu().numpy()
                for j, r in enumerate(rows)]
    return {"mel": mel, "gate": gate, "mel_postnet": mel_postnet,
            "wav": wavs}


def _frame_gap(a: torch.Tensor, b: torch.Tensor, n: np.ndarray) -> float:
    worst = 0.0
    for i, ni in enumerate(n):
        d = torch.linalg.vector_norm(a[i, :, :ni] - b[i, :, :ni], dim=0)
        scale = torch.linalg.vector_norm(b[i, :, :ni]) / math.sqrt(ni)
        worst = max(worst, float(d.max() / scale))
    return worst


def _wav_gap(a: List[np.ndarray], b: List[np.ndarray], hop: int) -> float:
    worst = 0.0
    for x, y in zip(a, b):
        if x.shape != y.shape or not np.all(np.isfinite(x)):
            return math.inf
        d = (x.astype(np.float64) - y).reshape(-1, hop)
        worst = max(worst, float(np.sqrt(np.mean(d * d, axis=1)).max()))
    return worst / FULL_SCALE


def gaps(served: Dict[str, object], ref_out: Dict[str, object], n: np.ndarray,
         hop: int) -> Dict[str, float]:
    """The four gaps of ``served`` (the program's outputs of the kept rows,
    or the control's) from the reference's."""
    gate = max(float((served["gate"][i, :ni] - ref_out["gate"][i, :ni])
                     .abs().max()) for i, ni in enumerate(n))
    return {"mel_gap": _frame_gap(served["mel"], ref_out["mel"], n),
            "gate_gap": gate,
            "postnet_gap": _frame_gap(served["mel_postnet"],
                                      ref_out["mel_postnet"], n),
            "wav_gap": _wav_gap(served["wav"], ref_out["wav"], hop)}


def stop_off(kept: Kept, threshold: float, dtype: torch.dtype) -> int:
    """Kept sentences whose length disagrees with their served gate, the
    stop rule sigmoid(logit) > threshold taken in the compute ``dtype``."""
    gate = (torch.sigmoid(kept.gate[:, :kept.steps_run].to(dtype))
            > threshold).cpu().numpy()
    off = 0
    for i, row in enumerate(kept.rows):
        fired = np.nonzero(gate[i])[0]
        want = int(fired[0]) + 1 if len(fired) else kept.steps_run
        off += int(kept.n[row] != want)
    return off


def served(kept: Kept) -> Dict[str, object]:
    return {"mel": kept.mel, "gate": kept.gate,
            "mel_postnet": kept.mel_postnet, "wav": kept.wavs}
