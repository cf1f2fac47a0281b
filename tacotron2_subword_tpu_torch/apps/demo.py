"""News-reader TTS demo of the port (``tacotron2_subword_tpu/apps/
demo.py``, the reference's streamlitNews.py:118-199): long text ->
sentences -> one synthesis per sentence -> one wav, 0.15 s of silence after
each sentence.

    python -m tacotron2_subword_tpu_torch.apps.demo --text-file news.txt \
        --out news.wav --checkpoint-dir Outdir --g2p-lexicon <lexicon> \
        [--hifigan-checkpoint g_... --hifigan-config c.json] \
        [--hparams "[decode_quant:int8]"] [--device cpu]

It runs as a CLI (a text file or stdin -> one 22050 Hz int16 wav) and,
under ``streamlit run``, as a text box (streamlit is imported only there).
The model and vocoder load through ``apps.inference.load_synthesizer`` (no
bias removal, as in the JAX demo).  As the JAX demo does: each sentence is
NFKC-lowercased (the reference calls an HTTP text-norm API), its subword
IDs are ``hash(word) % sub_n_symbols`` (Python's ``hash`` is salted per
process, so two processes give other IDs), its [CLS] vectors are zeros,
its prenet dropout is drawn from a generator seeded with 0, and its mel
keeps at least 8 frames.  CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import unicodedata
from typing import List

import numpy as np
import torch

SAMPLING_RATE = 22050
PAUSE_S = 0.15


def split_sentences(text: str) -> List[str]:
    """Split on terminal punctuation followed by white space (the reference
    splits on '.', streamlitNews.py:184)."""
    parts = re.split(r"(?<=[.!?])\s+", text.replace("\n", " "))
    return [p.strip() for p in parts if p.strip()]


def load_demo(args):
    """The demo's ``Synthesizer`` (apps.inference) on ``args.device``."""
    from tacotron2_subword_tpu_torch.apps.inference import load_synthesizer
    return load_synthesizer(argparse.Namespace(
        **vars(args), tokenizer_json=None, bert_model=None,
        bias_remove=False))


@torch.inference_mode()
def synthesize_sentence(syn, sent: str) -> np.ndarray:
    """One sentence -> its f32 wav in [-1, 1] (numpy)."""
    from tacotron2_subword_tpu_torch.models import tacotron2 as M
    cfg, dev = syn.cfg, syn.device
    sent = unicodedata.normalize("NFKC", sent).lower()
    seq = np.asarray(syn.t2s.grapheme_to_sequence(sent), np.int64)[None]
    sub = np.asarray([hash(w) % cfg.sub_n_symbols for w in sent.split()],
                     np.int64)[None]
    cls = torch.zeros((1, cfg.bert_embedding_dim), device=dev)
    out = M.infer(syn.params, syn.bn_state, cfg,
                  torch.from_numpy(seq).to(dev),
                  torch.from_numpy(sub).to(dev), cls, cls,
                  generator=torch.Generator(device=dev).manual_seed(0))
    n = int(out["mel_lengths"][0])
    return syn.vocode(out["mel_postnet"][:, :, :max(n, 8)])[0].cpu().numpy()


def synthesize_long_text(text: str, args, syn=None) -> np.ndarray:
    """``text`` -> one f32 wav: each sentence's audio followed by 0.15 s of
    silence.  ``syn``: a loaded ``load_demo(args)``, else loaded here."""
    syn = syn if syn is not None else load_demo(args)
    chunks = []
    for sent in split_sentences(text):
        chunks.append(synthesize_sentence(syn, sent))
        chunks.append(np.zeros(int(PAUSE_S * SAMPLING_RATE), np.float32))
    return np.concatenate(chunks) if chunks else np.zeros(1, np.float32)


def build_argparser() -> argparse.ArgumentParser:
    from tacotron2_subword_tpu_torch.text.g2p import default_resources_dir
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--text-file", default=None, help="default: stdin")
    p.add_argument("--out", default="news.wav")
    p.add_argument("--checkpoint-dir", default="Outdir")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--g2p-lexicon", default=os.path.join(
        default_resources_dir(),
        "all-vietnamese-syllables_17k9.XSAMPA.Mien-BAC_KA.txt"))
    p.add_argument("--hifigan-checkpoint", default=None)
    p.add_argument("--hifigan-config", default=None)
    p.add_argument("--max-decoder-steps", type=int, default=2000)
    p.add_argument("--hparams", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run there)")
    return p


def main(argv=None) -> np.ndarray:
    """Writes ``--out``; returns the f32 wav."""
    args = build_argparser().parse_args(argv)
    if args.text_file:
        with open(args.text_file, encoding="utf-8") as f:
            text = f.read()
    else:
        text = sys.stdin.read()
    wav = synthesize_long_text(text, args)
    from scipy.io.wavfile import write
    write(args.out, SAMPLING_RATE,
          np.clip(wav * 32768.0, -32768, 32767).astype(np.int16))
    print(f"wrote {args.out}: {len(wav) / SAMPLING_RATE:.1f}s")
    return wav


def streamlit_app():  # pragma: no cover - needs streamlit
    import streamlit as st
    st.title("TTS news reader")
    text = st.text_area("Text", "Xin chào. Đây là bản tin hôm nay.")
    if st.button("Synthesize"):
        wav = synthesize_long_text(text, build_argparser().parse_args([]))
        st.audio((np.clip(wav * 32768, -32768, 32767)).astype(np.int16)
                 .tobytes(), sample_rate=SAMPLING_RATE)


if __name__ == "__main__":
    try:
        import streamlit.runtime.scriptrunner as _sr
    except ImportError:
        main()
    else:
        if _sr.get_script_run_ctx() is not None:
            streamlit_app()
        else:
            main()
