"""Gate-stopped inference -> waveform demo on a checkpoint of the port (its
counterpart of the root ``tools/infer_wav_demo.py``, with its flags).

    python -m tacotron2_subword_tpu_torch.tools.infer_wav_demo \
        --data synth_data --checkpoint run/checkpoint_best \
        --out sample_gatestop.wav [--utt 0] [--split val] [--max-steps 256] \
        [--gate-threshold T] [--hparams "..."] [--device cpu]

One utterance of the synthetic corpus (phone IDs from its durations,
subword IDs and [CLS] from the corpus) goes through a free-running
``models.tacotron2.infer`` (prenet masks from a generator seeded 7) that
must stop on its gate before ``--max-steps`` (``gate_stopped``, the
reference's INFER_FLAG, model.py:461-488), then through Griffin-Lim
(``ops.stft.inv_mel_spec``, initial phases seeded 0) to a 16-bit wav
normalized to 0.8 of full scale.  The device is CUDA unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from scipy.io.wavfile import write as wav_write

from tacotron2_subword_tpu_torch.config import create_config
from tacotron2_subword_tpu_torch.models import tacotron2 as M
from tacotron2_subword_tpu_torch.ops import stft as S
from tacotron2_subword_tpu_torch.utils import checkpoint as CK
from tacotron2_subword_tpu_torch.utils.platform import resolve_device

MIN_FRAMES = 8   # Griffin-Lim needs a few frames past its edge trimming


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--utt", type=int, default=0)
    ap.add_argument("--split", default="val")
    ap.add_argument("--max-steps", type=int, default=256)
    ap.add_argument("--gate-threshold", type=float, default=None)
    ap.add_argument("--hparams", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run there)")
    return ap


@torch.inference_mode()
def main(argv=None) -> dict:
    """Returns {frames, gt_frames, gate_stopped, steps_run, samples, out};
    raises AssertionError when the gate did not stop the decode."""
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = create_config(hparams_string=args.hparams)
    state, _ = CK.load_checkpoint(args.checkpoint, dev)

    base = os.path.join(args.data, args.split)
    i = args.utt
    dur = np.load(os.path.join(base, "durations", f"{i}.npy"))
    as_t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    phones = as_t(dur[:, 0].astype(np.int64)[None])
    sub = as_t(np.load(os.path.join(base, "sub", f"{i}.npy")
                       ).astype(np.int64)[None])
    cls = as_t(np.load(os.path.join(base, "cls", f"{i}.npy")
                       ).astype(np.float32)[None])
    gt = np.load(os.path.join(base, "mels", f"ljspeech-mel-{i+1:05d}.npy"))

    out = M.infer(state.params, state.bn_state, cfg, phones, sub, cls, cls,
                  generator=torch.Generator(device=dev).manual_seed(7),
                  max_steps=args.max_steps,
                  gate_threshold=args.gate_threshold)
    ok = bool(out["infer_ok"][0])
    n = int(out["mel_lengths"][0])
    print(f"utt {i}: decoded {n} frames (gt {gt.shape[1]}), "
          f"gate_stopped={ok} (INFER_FLAG)")
    assert ok, "decode hit max_steps: the gate did not stop (INFER_FLAG=False)"

    mel = out["mel_postnet"][:1, :, :max(n, MIN_FRAMES)]
    wav = S.inv_mel_spec(mel, generator=torch.Generator(
        device=dev).manual_seed(0))[0].cpu().numpy()
    if not np.isfinite(wav).all():
        raise FloatingPointError("non-finite waveform")
    wav = wav / max(1e-6, np.abs(wav).max()) * 0.8
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    wav_write(args.out, cfg.sampling_rate, (wav * 32767).astype(np.int16))
    print(f"wrote {args.out}: {len(wav)} samples "
          f"({len(wav) / cfg.sampling_rate:.2f}s)")
    return {"frames": n, "gt_frames": int(gt.shape[1]), "gate_stopped": ok,
            "steps_run": out["steps_run"], "samples": len(wav),
            "out": args.out}


if __name__ == "__main__":
    main()
