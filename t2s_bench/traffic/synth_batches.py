"""Traffic generator ``synth_batches``: closed-loop batch synthesis, one
offline worker sending its next batch when the last one's wavs are on the
host.

Parameters (the mix's JSON):
  batch           sentences a batch
  batches         distinct batches drawn from the seed, sent in turn
  seconds         {"min", "mean", "max"}: a sentence's spoken length, a
                  triangular distribution with that least, mean and most
  symbols_per_s   phone IDs a spoken second
  subwords_per_s  subword IDs a spoken second
  gate_threshold  the serving entry's stop threshold
  max_steps       the decode's step limit
  check_batches   the batch the output check reads is drawn from the first
                  this many of the window
  check_rows      sentences of that batch the check reads (the one with the
                  most frames among them)

A batch holds ``batch`` sentences whose spoken lengths are the evenly
spaced quantiles of the distribution, in an order drawn from the seed, so
every batch pads to the same shapes and every seed asks for the same work.
A sentence of d seconds has round(d * symbols_per_s) phone IDs and
round(d * subwords_per_s) subword IDs, and stops near frame
phones * frames_per_s / symbols_per_s (``rig``).  IDs are uniform over
1..n-1 (0 is the pad ID); one [CLS] vector N(0, 1) a sentence serves both
streams, as the CLI's does, save its coordinate 0, which carries the
sentence's stop frame to the rigged gate (``latch_input``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

Request = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

# The rig's decoder-LSTM units: a 2-cycle and a 4-cycle oscillator, the
# frame counter, a unit that is on from the first step, and the latch.
F1, F2, COUNT, ON, LATCH = range(5)
PERIOD = 4            # decode steps a count
COUNTS = 256          # counts the counter's bf16 cell holds exactly, 0 up
BIG = 100.0           # a pre-activation weight that saturates its gate
SAT = 20.0            # a bias that saturates its gate (sigmoid -> 1.0)
GATE_W = 8.0


def frames_per_s(cfg: dict) -> float:
    return cfg["sampling_rate"] / cfg["hop_length"]


def spoken_seconds(params: dict) -> np.ndarray:
    """The ``batch`` evenly spaced quantiles of the triangular distribution
    with the mix's least, mean and most ``seconds``, ascending."""
    s = params["seconds"]
    a, b = s["min"], s["max"]
    m = 3.0 * s["mean"] - a - b
    if not a <= m <= b:
        raise ValueError("no triangular distribution has that mean")
    u = (np.arange(params["batch"]) + 0.5) / params["batch"]
    cut = (m - a) / (b - a)
    return np.where(u < cut, a + np.sqrt(u * (b - a) * (m - a)),
                    b - np.sqrt((1.0 - u) * (b - a) * (b - m)))


def sizes(params: dict, cfg: dict):
    """(phone IDs, subword IDs, target stop frame) of each sentence of a
    batch, ascending; ``cfg`` is the configuration's "tacotron" group."""
    d = spoken_seconds(params)
    phones = np.maximum(np.rint(d * params["symbols_per_s"]), 2).astype(
        np.int64)
    subs = np.maximum(np.rint(d * params["subwords_per_s"]), 1).astype(
        np.int64)
    stops = np.rint(phones * frames_per_s(cfg)
                    / params["symbols_per_s"]).astype(np.int64)
    return phones, subs, stops


def counts_for(stop: np.ndarray) -> np.ndarray:
    """The counter's count at which a sentence meant to stop at frame
    ``stop`` fires: the counter counts at steps 1, 5, 9, ..., so count k
    fires at step 4k - 3, frame 4k - 2."""
    k = np.rint((np.asarray(stop) + 2) / PERIOD).astype(np.int64)
    if np.any(k < 1) or np.any(k >= COUNTS):
        raise ValueError(
            f"stop frames must lie in [2, {PERIOD * (COUNTS - 1) - 2}]")
    return k


def latch_input(stop: np.ndarray) -> np.ndarray:
    """[CLS] coordinate 0 of sentences meant to stop at frame ``stop``: the
    latch's cell becomes tanh of it, half a count below the count that
    fires (bfloat16 rounds it to a count or a half; the sentence stops
    within a count, 4 frames, of ``stop`` or where a tie of the two units'
    bfloat16 outputs puts it)."""
    return np.arctanh((counts_for(stop) - 0.5) / COUNTS).astype(np.float32)


def rig(params_tree: dict, params: dict) -> None:
    """Make each sentence stop near its own frame, as a trained gate fires
    at the end of its text.  In place, on the Tacotron 2 parameter tree
    (torch LSTM layout, gates i, f, g, o; linear ``w`` [in, out]).

    Random weights hold the gate's probability near 0.5 at every frame.
    Here five units of the decoder LSTM, all other weights into them
    zeroed, count the frames and hold the sentence's stop count; the gate
    layer reads only two of them.  Every gate of the five saturates (its
    sigmoid or tanh is 0 or 1 in float32) except where stated, so bfloat16
    and float32 run them alike:
      F1     c = +1, -1, +1, ... (its g reads its own h with weight -100);
      F2     toggles when F1 was positive: c = +0.38, -1, -1, +1, +1, ...;
      COUNT  adds tanh(2^-8) when F1 and F2 were both positive, at steps
             1, 5, 9, ...: c = k / 256 after the k-th count, which a
             bfloat16 cell holds exactly up to k = 255;
      ON     c = t + 1, so its h is 0 before the first step and > 0.76
             after it;
      LATCH  takes tanh of phone-memory channel 0 at the first step only
             (its input gate reads ON) and holds it.
    Phone-memory channel 0 is [CLS] coordinate 0 (the converter's column
    0 reads only it), so the first step's context carries it, its
    attention weights summing to 1.  The gate's logit is
    8 * (h[COUNT] - h[LATCH]): it passes 0 at the first count above the
    latch."""
    dec = params_tree["decoder"]
    r, gate = dec["decoder_rnn"], dec["gate_layer"]
    H = r["w_hh"].shape[1]
    A = dec["attention_rnn"]["w_hh"].shape[1]   # ctx_phone starts at A
    conv = params_tree["linear_converter"]
    E = conv["w"].shape[1]
    if H < 5:
        raise ValueError("the decoder LSTM is too small for the rig")

    def row(unit, g):
        return g * H + unit
    with torch.no_grad():
        conv["w"][:, 0] = 0.0
        conv["w"][E, 0] = 1.0          # [CLS] coordinate 0
        conv["b"][0] = 0.0
        for u in range(5):
            rows = [row(u, g) for g in range(4)]
            r["w_ih"][rows] = 0.0
            r["w_hh"][rows] = 0.0
            r["b_ih"][rows] = 0.0
            r["b_hh"][rows] = 0.0
        b, w_hh, w_ih = r["b_ih"], r["w_hh"], r["w_ih"]
        # F1: i = o = 1, f = 0, g = sign of (0.5 - h_F1)
        b[[row(F1, 0), row(F1, 3)]] = SAT
        b[row(F1, 1)] = -BIG
        b[row(F1, 2)] = BIG / 2
        w_hh[row(F1, 2), F1] = -BIG
        # F2: toggles (f = 0, i = 1, g = -sign h_F2) when h_F1 > 0,
        # holds (f = 1, i = 0) when h_F1 < 0
        w_hh[row(F2, 0), F1] = BIG
        w_hh[row(F2, 1), F1] = -BIG
        w_hh[row(F2, 2), F2] = -BIG
        b[row(F2, 2)] = 1.0
        b[row(F2, 3)] = SAT
        # COUNT: i = 1 when h_F1 > 0 and h_F2 > 0; f = o = 1
        w_hh[row(COUNT, 0), F1] = BIG
        w_hh[row(COUNT, 0), F2] = BIG
        b[row(COUNT, 0)] = -0.8 * BIG
        b[[row(COUNT, 1), row(COUNT, 3)]] = SAT
        b[row(COUNT, 2)] = 1.0 / COUNTS
        # ON: every gate open
        b[[row(ON, g) for g in range(4)]] = SAT
        # LATCH: i = 1 at the first step only; f = o = 1; g reads ctx 0
        w_hh[row(LATCH, 0), ON] = -BIG
        b[row(LATCH, 0)] = SAT
        b[[row(LATCH, 1), row(LATCH, 3)]] = SAT
        w_ih[row(LATCH, 2), A] = 1.0
        gate["w"].zero_()
        gate["w"][COUNT, 0] = GATE_W
        gate["w"][LATCH, 0] = -GATE_W
        gate["b"].zero_()


def make(params: dict, seed: int, cfg: dict) -> List[List[Request]]:
    """``params["batches"]`` batches of requests (phone IDs, subword IDs,
    [CLS] for the phone stream, [CLS] for the subword stream) from
    ``seed``; ``cfg`` is the configuration's "tacotron" group."""
    rng = np.random.default_rng([seed, 0x7a5])
    B = params["batch"]
    phones, subs, stops = sizes(params, cfg)
    latch = latch_input(stops)
    out = []
    for _ in range(params["batches"]):
        order = rng.permutation(B)
        cls = rng.standard_normal((B, cfg["bert_embedding_dim"]),
                                  dtype=np.float32)
        cls[:, 0] = latch[order]
        batch = []
        for i, j in enumerate(order):
            ph = rng.integers(1, cfg["n_symbols"], phones[j], dtype=np.int64)
            sw = rng.integers(1, cfg["sub_n_symbols"], subs[j],
                              dtype=np.int64)
            batch.append((ph, sw, cls[i], cls[i]))
        out.append(batch)
    return out


def check_batch(params: dict, seed: int) -> int:
    """The index of the window's batch that the output check reads, drawn
    from the seed among the first ``check_batches``."""
    rng = np.random.default_rng([seed, 0xc4e])
    return int(rng.integers(0, params["check_batches"]))


def check_rows(params: dict, seed: int, k: int,
               n_frames: np.ndarray) -> np.ndarray:
    """The ``check_rows`` sentences of the window's batch ``k`` that the
    check reads: the one with the most frames, and others drawn from the
    seed; sorted."""
    rng = np.random.default_rng([seed, 0x5e1, k])
    longest = int(np.argmax(n_frames))
    rest = np.delete(np.arange(len(n_frames)), longest)
    pick = rng.choice(rest, params["check_rows"] - 1, replace=False)
    return np.sort(np.append(pick, longest))
