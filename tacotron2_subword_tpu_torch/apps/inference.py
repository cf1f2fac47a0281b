"""Serving core: a batch of requests -> mels -> HiFi-GAN waveforms.

Counterpart of the model half of ``tacotron2_subword_tpu/apps/inference.py``
(``run_inference`` and ``vocode_bucketed``): requests arrive as phone IDs,
subword IDs and [CLS] vectors; they are padded to one batch with their true
lengths, decoded with per-sample gate stop, vocoded with HiFi-GAN and scaled
to the int16 range.  The text front end, checkpoint loading, the denoiser
and Griffin-Lim are not ported yet.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tacotron2_subword_tpu_torch.config import TacotronConfig
from tacotron2_subword_tpu_torch.models import hifigan as HG
from tacotron2_subword_tpu_torch.models import tacotron2 as M
from tacotron2_subword_tpu_torch.utils.platform import resolve_device

MAX_WAV_VALUE = 32768.0 * 1.7
MEL_FLOOR = math.log(1e-5)  # dynamic-range-compression silence floor
MIN_FRAMES = 8  # a 1-frame mel (gate firing at once) still gives audio
BUCKET = 64  # frames: the vocoder's input is padded to a multiple of this

Request = Tuple[Sequence[int], Sequence[int], np.ndarray, np.ndarray]


def pad_requests(requests: Sequence[Request], device):
    """(phone_ids, sub_ids, cls_phone [768], cls_sub [768]) per request ->
    padded id batches, [CLS] batches and true lengths on ``device``."""
    B = len(requests)
    t_len = [len(r[0]) for r in requests]
    s_len = [len(r[1]) for r in requests]
    text = np.zeros((B, max(t_len)), np.int64)
    sub = np.zeros((B, max(s_len)), np.int64)
    for i, (ph, sw, _, _) in enumerate(requests):
        text[i, :len(ph)] = ph
        sub[i, :len(sw)] = sw
    cls_p = np.stack([np.asarray(r[2], np.float32) for r in requests])
    cls_s = np.stack([np.asarray(r[3], np.float32) for r in requests])
    as_t = lambda a: torch.from_numpy(a).to(device)
    return (as_t(text), as_t(sub), as_t(cls_p), as_t(cls_s),
            as_t(np.asarray(t_len, np.int64)), as_t(np.asarray(s_len, np.int64)))


def vocode_bucketed(gen_params, h: HG.HifiganConfig, mel: torch.Tensor,
                    n_frames: torch.Tensor, hop: int) -> List[torch.Tensor]:
    """Vocode a batch of mels [B, 80, T] with true lengths ``n_frames`` [B]:
    each mel keeps max(n, 8) frames, the rest and the pad up to a multiple
    of BUCKET frames are filled with the silence floor, and each waveform
    is cut back to max(n, 8) * hop samples."""
    n = [max(int(v), MIN_FRAMES) for v in n_frames.tolist()]
    pad_f = -(-max(n) // BUCKET) * BUCKET
    m = mel[:, :, :max(n)]
    m = F.pad(m, (0, pad_f - m.shape[-1]), value=MEL_FLOOR)
    keep = (torch.arange(pad_f, device=mel.device)[None, :]
            < torch.tensor(n, device=mel.device)[:, None])
    m = torch.where(keep[:, None, :], m, torch.full_like(m, MEL_FLOOR))
    wav = HG.generator_apply(gen_params, h, m)[:, 0, :]
    return [wav[i, :n[i] * hop] for i in range(len(n))]


@torch.inference_mode()
def synthesize(params, bn, gen_params, cfg: TacotronConfig,
               h: HG.HifiganConfig, requests: Sequence[Request], *,
               generator: Optional[torch.Generator], device="cuda",
               max_steps: Optional[int] = None,
               gate_threshold: Optional[float] = None):
    """Serve ``requests`` as one batch.  Returns a dict: ``wavs`` (one f32
    waveform per request, scaled by MAX_WAV_VALUE and clipped to the int16
    range), ``mel_postnet``, ``mel_lengths``, ``infer_ok`` and
    ``steps_run`` (decoder steps executed).  Params and ``generator`` live
    on ``device``."""
    device = resolve_device(device)
    text, sub, cls_p, cls_s, t_len, s_len = pad_requests(requests, device)
    out = M.infer(params, bn, cfg, text, sub, cls_p, cls_s,
                  generator=generator, max_steps=max_steps,
                  gate_threshold=gate_threshold, text_lengths=t_len,
                  sub_lengths=s_len)
    wavs = vocode_bucketed(gen_params, h, out["mel_postnet"],
                           out["mel_lengths"], hop=cfg.hop_length)
    out["wavs"] = [torch.clamp(w * MAX_WAV_VALUE, -32768.0, 32767.0)
                   for w in wavs]
    return out
