"""Inference of the port: the text → wav CLI and the batched serving core.

    python -m tacotron2_subword_tpu_torch.apps.inference \
        --script script.txt --checkpoint-dir Outdir --out-dir Outdir/demo \
        --g2p-lexicon <lexicon-or-.g2pfst> \
        [--hifigan-checkpoint g_... --hifigan-config config_v1.json] \
        [--tokenizer-json vibert_5500.json --bert-model <local dir>] \
        [--max-decoder-steps N] [--overwrite] [--hparams "[k:v-k:v]"] \
        [--device cpu]

Counterpart of ``tacotron2_subword_tpu/apps/inference.py`` (the reference's
inference.py:342-375 pipeline), with its flags, defaults and output tree
plus ``--device`` (CUDA unless ``--device cpu`` is given).  Per script line
``id|text``: NFKC-lowercase normalization, G2P → phone IDs, subword IDs
(a tokenizer JSON, else the crc32 fallback) and the BERT [CLS] vector (a
local BERT model, else zeros), gate-stopped decoding (max_decoder_steps
6000, reference inference.py:246), alignment/mel plots, HiFi-GAN vocoding
with bias removal (strength 0.9) — or Griffin-Lim when no vocoder
checkpoint is given (BASELINE config 1) — scaled by 32768*1.7 and written
as 22050 Hz int16 wav under ``audio/``, with ``mels/``, ``alignment/`` and
``alignment_bert/`` beside it; already-rendered ids are skipped unless
``--overwrite`` (resumability, reference inference.py:365-366).  With
``--hparams "[decode_quant:int8]"`` each decoder step runs the int8 kernel
K1 twice (ops/quant.py).

Checkpoints: the port's own ``checkpoint_{step}/`` directories
(utils/checkpoint.py) and reference torch ``checkpoint_{iter}`` files.
``--hifigan-checkpoint`` also takes ``.onnx`` and ``.tflite`` files (run on
the device by ``utils/onnx_lite`` and ``utils/tflite_lite``); as in the JAX
CLI, those are scaled by 32768 and not denoised.  The JAX package's Orbax
directories are not read: ``tools/orbax_to_torch.py`` converts them.

``synthesize`` is the batched serving core: pre-tokenised requests padded
to one batch with their true lengths, decoded with per-sample gate stop and
vocoded with HiFi-GAN.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import math
import os
import re
import time
import unicodedata
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tacotron2_subword_tpu_torch.config import TacotronConfig, create_config
from tacotron2_subword_tpu_torch.models import denoiser as DN
from tacotron2_subword_tpu_torch.models import hifigan as HG
from tacotron2_subword_tpu_torch.models import tacotron2 as M
from tacotron2_subword_tpu_torch.ops import stft as S
from tacotron2_subword_tpu_torch.utils.platform import resolve_device

MAX_WAV_VALUE = 32768.0 * 1.7  # reference inference.py:196
MEL_FLOOR = math.log(1e-5)  # dynamic-range-compression silence floor
MIN_FRAMES = 8  # a 1-frame mel (gate firing at once) still gives audio
BUCKET = 64  # frames: the vocoder's input is padded to a multiple of this
SAMPLING_RATE = 22050
BIAS_STRENGTH = 0.9  # HiFi-GAN bias removal, reference inference.py:202

Request = Tuple[Sequence[int], Sequence[int], np.ndarray, np.ndarray]
Vocoder = Callable[[torch.Tensor], torch.Tensor]  # mel [B,M,T] -> wav [B,T']


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


def vocode_bucketed(vocode: Vocoder, mel: torch.Tensor,
                    n_frames: Sequence[int], hop: int) -> List[torch.Tensor]:
    """Vocode a batch of mels [B, 80, T] with true lengths ``n_frames``:
    each mel keeps max(n, 8) frames (a 1-frame mel — the reference's
    gate-fires-on-first-frame quirk, model.py:461-467 — would leave nothing
    after the iSTFT's edge trimming), the rest and the pad up to a multiple
    of BUCKET frames are filled with the silence floor, and each waveform
    is cut back to max(n, 8) * hop samples."""
    n = [max(int(v), MIN_FRAMES) for v in n_frames]
    pad_f = -(-max(n) // BUCKET) * BUCKET
    m = mel[:, :, :max(n)]
    m = F.pad(m, (0, pad_f - m.shape[-1]), value=MEL_FLOOR)
    keep = (torch.arange(pad_f, device=mel.device)[None, :]
            < torch.tensor(n, device=mel.device)[:, None])
    m = torch.where(keep[:, None, :], m, torch.full_like(m, MEL_FLOOR))
    wav = vocode(m)
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
    wavs = vocode_bucketed(
        lambda m: HG.generator_apply(gen_params, h, m)[:, 0, :],
        out["mel_postnet"], out["mel_lengths"].tolist(), hop=cfg.hop_length)
    out["wavs"] = [torch.clamp(w * MAX_WAV_VALUE, -32768.0, 32767.0)
                   for w in wavs]
    return out


# ---------------------------------------------------------------------------
# The text -> wav CLI
# ---------------------------------------------------------------------------

def latest_checkpoint_path(dir_path: str,
                           regex: str = "checkpoint_*") -> Optional[str]:
    """Newest checkpoint by trailing number (reference
    inference.py:284-292)."""
    f_list = glob.glob(os.path.join(dir_path, regex))
    f_list = [f for f in f_list if re.search(r"\d+$", f)]
    if not f_list:
        return None
    f_list.sort(key=lambda f: int(re.search(r"(\d+)$", f).group(1)))
    return f_list[-1]


def load_acoustic_model(checkpoint: str, cfg: TacotronConfig, device):
    """(params, bn_state) on ``device`` from a checkpoint directory of the
    port or a reference torch ``checkpoint_{iter}`` file."""
    if os.path.isdir(checkpoint):
        from tacotron2_subword_tpu_torch.utils.checkpoint import \
            load_checkpoint
        state, _ = load_checkpoint(checkpoint, device=device)
        return state.params, state.bn_state
    from tacotron2_subword_tpu_torch.utils.import_torch import \
        load_torch_checkpoint
    params, bn_state, _ = load_torch_checkpoint(checkpoint, cfg,
                                                device=device)
    return params, bn_state


def load_vocoder(hifigan_checkpoint: Optional[str],
                 hifigan_config: Optional[str],
                 device) -> Tuple[Vocoder, str]:
    """(vocode: mel [B, 80, T] → wav [B, T'], name) on ``device``: HiFi-GAN
    from a reference ``{'generator': state_dict}`` torch file (weight-normed
    or fused) and its JSON config (v1 without one), fused for serving
    ("hifigan"); an ``.onnx`` file through the port's executor on
    ``device`` ("hifigan-onnx", reference inference.py:208-223); a
    ``.tflite`` file through the port's TFLite executor on ``device``
    ("hifigan-tflite", reference best_checkpoint.py:230-260); or, with no
    checkpoint, Griffin-Lim (BASELINE config 1)."""
    if hifigan_checkpoint and hifigan_checkpoint.endswith(".onnx"):
        from tacotron2_subword_tpu_torch.models.vocoder_runtimes import \
            load_onnx_vocoder
        return load_onnx_vocoder(hifigan_checkpoint, device), "hifigan-onnx"
    if hifigan_checkpoint and hifigan_checkpoint.endswith(".tflite"):
        from tacotron2_subword_tpu_torch.models.vocoder_runtimes import \
            load_tflite_vocoder
        return (load_tflite_vocoder(hifigan_checkpoint, device),
                "hifigan-tflite")
    if hifigan_checkpoint and os.path.isdir(hifigan_checkpoint):
        raise NotImplementedError(
            f"{hifigan_checkpoint}: Orbax generator directories of the JAX "
            f"package cannot be read without JAX; convert it where JAX is "
            f"installed: python tools/orbax_to_torch.py --generator "
            f"{hifigan_checkpoint} --out FILE [--config CONFIG], and pass "
            f"FILE (a reference g_* torch file)")
    if hifigan_checkpoint:
        h = (HG.HifiganConfig.from_json(hifigan_config)
             if hifigan_config else HG.HifiganConfig())
        ckpt = torch.load(hifigan_checkpoint, map_location="cpu",
                          weights_only=True)
        params = HG.fuse_generator(HG.import_torch_generator(
            ckpt.get("generator", ckpt), h, device=device))
        return (lambda mel: HG.generator_apply(params, h, mel)[:, 0, :],
                "hifigan")

    def vocode_gl(mel):
        # mel → linear magnitude through the filterbank's pseudo-inverse,
        # then 30 Griffin-Lim iterations (the reference's
        # Audio.tools.inv_mel_spec path, Audio/tools.py:45-61, with
        # spec_from_mel_scaling=1000); the initial phases are seeded per call
        gen = torch.Generator(device=mel.device).manual_seed(0)
        return S.inv_mel_spec(mel, griffin_iters=30, generator=gen)
    return vocode_gl, "griffin_lim"


@dataclasses.dataclass
class Synthesizer:
    """Everything one line needs: the model, the vocoder (with its bias
    spectrum for HiFi-GAN) and the text front end, on one device."""
    cfg: TacotronConfig
    params: Any
    bn_state: Any
    vocode: Vocoder
    vocoder_name: str
    bias_spec: Optional[torch.Tensor]
    t2s: Any
    tokenizer: Any
    embedder: Any
    device: torch.device


@torch.inference_mode()
def load_synthesizer(args) -> Synthesizer:
    """The CLI's model, vocoder and text front end on ``args.device``."""
    device = resolve_device(args.device)
    cfg = create_config(hparams_string=args.hparams)
    cfg = cfg.replace(max_decoder_steps=args.max_decoder_steps)

    ckpt = args.checkpoint or latest_checkpoint_path(args.checkpoint_dir)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint under {args.checkpoint_dir}")
    print("Load:", ckpt)
    params, bn_state = load_acoustic_model(ckpt, cfg, device)
    vocode, vocoder_name = load_vocoder(args.hifigan_checkpoint,
                                        args.hifigan_config, device)

    from tacotron2_subword_tpu_torch.text import Text2Seq
    t2s = Text2Seq(args.g2p_lexicon)
    tokenizer = embedder = None
    if args.tokenizer_json and os.path.exists(args.tokenizer_json):
        from tacotron2_subword_tpu_torch.text.bert import SubwordTokenizer
        tokenizer = SubwordTokenizer(args.tokenizer_json)
    if args.bert_model and os.path.exists(args.bert_model):
        from tacotron2_subword_tpu_torch.text.bert import ClsEmbedder
        embedder = ClsEmbedder(args.bert_model)

    # the bias remover is built from the vocoder itself (reference
    # bias_remover.py:6-29)
    bias_spec = None
    if vocoder_name == "hifigan" and args.bias_remove:
        bias_spec = DN.compute_bias_spec(
            vocode, n_mel_channels=cfg.n_mel_channels, device=device)
    return Synthesizer(cfg, params, bn_state, vocode, vocoder_name,
                       bias_spec, t2s, tokenizer, embedder, device)


def _pad_to(ids: np.ndarray, multiple: int) -> np.ndarray:
    return np.pad(ids, (0, -(-len(ids) // multiple) * multiple - len(ids)))


@torch.inference_mode()
def synthesize_text(syn: Synthesizer, text: str) -> Dict[str, Any]:
    """One script line's text → IDs → mel → waveform.

    Returns ``n_frames`` (the mel's true length), ``infer_ok``,
    ``steps_run``, ``mel`` [n_mels, max(n, 8)], ``alignments`` /
    ``alignments_bert`` [n, T] (numpy), ``wav`` (f32 numpy in the int16
    range, before the cast) and ``times``: the wall seconds of the front
    end, the acoustic model, the vocoder and the denoiser (HiFi-GAN only),
    each ended by a wait for the device."""
    cfg, dev = syn.cfg, syn.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    times: Dict[str, float] = {}
    t0 = time.perf_counter()
    text = unicodedata.normalize("NFKC", text).lower()
    seq = np.asarray(syn.t2s.grapheme_to_sequence(text), np.int64)
    if syn.tokenizer is not None:
        sub_ids = syn.tokenizer.encode(text) % cfg.sub_n_symbols
    else:
        # crc32 (not the process-salted hash()): the IDs any tokenizer-less
        # training corpus was built with
        from tacotron2_subword_tpu_torch.text.bert import hashed_subword_ids
        sub_ids = hashed_subword_ids(text, cfg.sub_n_symbols)
    sub_ids = np.asarray(sub_ids, np.int64)
    cls = (syn.embedder.embed_cls(text) if syn.embedder is not None
           else np.zeros(cfg.bert_embedding_dim, np.float32))
    # padded to multiples of 16 / 8 as the JAX CLI pads them: the encoder's
    # convolutions see the pad, so the same pad gives the same memory
    as_t = lambda a: torch.from_numpy(a).to(dev)
    text_t = as_t(_pad_to(seq, 16)[None])
    sub_t = as_t(_pad_to(sub_ids, 8)[None])
    cls_t = as_t(np.asarray(cls, np.float32)[None])
    t_len, s_len = as_t(np.asarray([len(seq)])), as_t(np.asarray(
        [len(sub_ids)]))
    sync()
    t1 = time.perf_counter()
    times["front_end"] = t1 - t0

    out = M.infer(syn.params, syn.bn_state, cfg, text_t, sub_t, cls_t, cls_t,
                  generator=torch.Generator(device=dev).manual_seed(0),
                  text_lengths=t_len, sub_lengths=s_len)
    n = int(out["mel_lengths"][0])  # waits for the decode and the postnet
    t2 = time.perf_counter()
    times["acoustic"] = t2 - t1

    wav = vocode_bucketed(syn.vocode, out["mel_postnet"], [n],
                          hop=cfg.hop_length)[0][None]
    # as the JAX CLI: only the native HiFi-GAN is scaled by 32768 * 1.7 and
    # denoised; the exported ones, like Griffin-Lim, by 32768
    if syn.vocoder_name == "hifigan":
        wav = wav * MAX_WAV_VALUE
        sync()
        t3 = time.perf_counter()
        times["vocoder"] = t3 - t2
        if syn.bias_spec is not None:
            wav = DN.denoise(wav, syn.bias_spec, strength=BIAS_STRENGTH)
            wav_np = wav[0].cpu().numpy()
            times["denoiser"] = time.perf_counter() - t3
        else:
            wav_np = wav[0].cpu().numpy()
    else:
        wav_np = (wav[0] * 32768.0).cpu().numpy()
        times["vocoder"] = time.perf_counter() - t2
    return {
        "n_frames": n,
        "infer_ok": bool(out["infer_ok"][0]),
        "steps_run": out["steps_run"],
        "mel": out["mel_postnet"][0, :, :max(n, MIN_FRAMES)].cpu().numpy(),
        "alignments": out["alignments"][0, :n].cpu().numpy(),
        "alignments_bert": out["alignments_bert"][0, :n].cpu().numpy(),
        "wav": np.clip(wav_np, -32768, 32767),
        "times": times,
    }


def save_plots(out_dir: str, utt_id: str, result: Dict[str, Any]) -> None:
    """alignment/, alignment_bert/ and mels/ PNGs of one line."""
    from tacotron2_subword_tpu_torch.utils.logging_utils import (
        plot_alignment, plot_spectrogram, save_image)
    for sub, img in (("alignment", plot_alignment(result["alignments"])),
                     ("alignment_bert",
                      plot_alignment(result["alignments_bert"])),
                     ("mels", plot_spectrogram(result["mel"]))):
        save_image(img, os.path.join(out_dir, sub, f"{utt_id}.png"))


def write_wav(path: str, wav: np.ndarray, sr: int = SAMPLING_RATE) -> None:
    """int16 wav; the cast truncates toward zero, as the JAX CLI's does."""
    from scipy.io.wavfile import write
    write(path, sr, wav.astype(np.int16))


def run_inference(args) -> int:
    """Render every line of ``args.script`` not rendered yet; returns the
    number of wavs written."""
    syn = load_synthesizer(args)
    for sub in ("audio", "mels", "alignment", "alignment_bert"):
        os.makedirs(os.path.join(args.out_dir, sub), exist_ok=True)
    with open(args.script, encoding="utf-8") as f:
        lines = [l.strip() for l in f if l.strip()]
    n_done = 0
    for line in lines:
        utt_id, text = line.split("|", 1)
        wav_path = os.path.join(args.out_dir, "audio", f"{utt_id}.wav")
        if os.path.exists(wav_path) and not args.overwrite:
            continue
        result = synthesize_text(syn, text)
        if not result["infer_ok"]:
            print(f"{utt_id}: reached max decoder steps")
        save_plots(args.out_dir, utt_id, result)
        t0 = time.perf_counter()
        write_wav(wav_path, result["wav"])
        result["times"]["wav_write"] = time.perf_counter() - t0
        n_done += 1
        split = ", ".join(f"{k} {v * 1e3:.1f} ms"
                          for k, v in result["times"].items())
        print(f"{utt_id}: {result['mel'].shape[-1]} frames -> "
              f"{len(result['wav']) / SAMPLING_RATE:.2f}s audio "
              f"({syn.vocoder_name}; {split})")
    return n_done


def build_argparser() -> argparse.ArgumentParser:
    from tacotron2_subword_tpu_torch.text.g2p import default_resources_dir
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--script", required=True, help="id|text lines")
    p.add_argument("--checkpoint-dir", default="Outdir")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out-dir", default="Outdir/demo")
    p.add_argument("--g2p-lexicon", default=os.path.join(
        default_resources_dir(),
        "all-vietnamese-syllables_17k9.XSAMPA.Mien-BAC_KA.txt"))
    p.add_argument("--hifigan-checkpoint", default=None)
    p.add_argument("--hifigan-config", default=None)
    p.add_argument("--tokenizer-json", default=None)
    p.add_argument("--bert-model", default=None)
    p.add_argument("--bias-remove", action="store_true", default=True)
    p.add_argument("--max-decoder-steps", type=int, default=6000)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--hparams", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run there)")
    return p


def main(argv=None) -> int:
    return run_inference(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
