"""Train a reference-style subword tokenizer asset (``vibert_{vocab}.json``;
the port's copy of the root ``tools/train_tokenizer.py``, with its flags
and output).

    python -m tacotron2_subword_tpu_torch.tools.train_tokenizer \
        --out-dir assets --vocab-size 512 --from-lexicon 4096 [--seed 0] \
        [--texts train_text.txt ...] [--lexicon lex]

A BERT-style WordPiece tokenizer whose JSON loads through
``text.bert.SubwordTokenizer``, so a trained asset, not the crc32 IDs,
carries the subword stream from the corpus through training to inference
(the reference ships its assets, data/vibert_*.json, read by
data_utils.py:15-26, but not the script that made them).  Normalization is
the corpus text path's (NFKC + lowercase); the [CLS] $A [SEP]
post-processor mirrors the reference's assets.

Sentences come from ``--texts`` (plain lines, or the "id|sentence" rows
``make_synthetic_dataset --from-text`` writes) and/or ``--from-lexicon
N``: N seeded random sentences of the lexicon's syllables, drawn as
``make_synthetic_dataset --from-text`` draws them.  The default
``--lexicon`` lies under ``$T2S_RESOURCES_DIR``, else ``resources/``.

It runs on the host only and needs the ``tokenizers`` package, imported
when training starts; without it the tool raises an ImportError naming
the package.
"""

from __future__ import annotations

import argparse
import os
import unicodedata
from typing import Iterable, List

from tacotron2_subword_tpu_torch.text.g2p import default_resources_dir
from tacotron2_subword_tpu_torch.tools.make_synthetic_dataset import (
    LEXICON_NAME, load_syllables)


def train_wordpiece(sentences: Iterable[str], vocab_size: int):
    """BERT-style WordPiece tokenizer over ``sentences``: [PAD] / [UNK] /
    [CLS] / [SEP] / [MASK] at IDs 0-4, an NFKC + lowercase normalizer,
    whitespace pre-tokenization and a [CLS] $A [SEP] post-processor (the
    reference's vibert layout)."""
    try:
        from tokenizers import (Tokenizer, models, normalizers,
                                pre_tokenizers, processors, trainers)
    except ImportError as e:
        raise ImportError(
            "train_tokenizer needs the 'tokenizers' package, which is not "
            "installed") from e

    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.Sequence(
        [normalizers.NFKC(), normalizers.Lowercase()])
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.WordPieceTrainer(
        vocab_size=vocab_size,
        special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    tok.train_from_iterator(sentences, trainer)
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]",
        pair="[CLS] $A [SEP] $B [SEP]",
        special_tokens=[("[CLS]", tok.token_to_id("[CLS]")),
                        ("[SEP]", tok.token_to_id("[SEP]"))])
    return tok


def read_text_file(path: str) -> List[str]:
    """Plain sentences, or make_synthetic_dataset's "id|sentence" rows."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            out.append(line.split("|", 1)[1] if "|" in line else line)
    return out


def lexicon_sentences(lexicon_path: str, n: int, seed: int = 0) -> List[str]:
    """Seeded random sentences of 4-10 of the lexicon's syllables, as
    make_synthetic_dataset --from-text composes them."""
    import numpy as np

    sylls = load_syllables(lexicon_path)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rng.randint(4, 11)
        text = " ".join(sylls[rng.randint(len(sylls))] for _ in range(k))
        out.append(unicodedata.normalize("NFKC", text).lower())
    return out


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=None,
                    help="output JSON path (default "
                         "{out-dir}/vibert_{vocab}.json)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--vocab-size", type=int, default=512,
                    help="must be <= the model's sub_n_symbols "
                         "(embedding-table size)")
    ap.add_argument("--texts", nargs="*", default=[],
                    help="sentence files (plain or id|sentence)")
    ap.add_argument("--from-lexicon", type=int, default=0, metavar="N",
                    help="also compose N random lexicon sentences")
    ap.add_argument("--lexicon", default=os.path.join(
        default_resources_dir(), LEXICON_NAME))
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> str:
    """Train and save the tokenizer; returns the JSON's path."""
    ap = build_argparser()
    args = ap.parse_args(argv)

    sentences: List[str] = []
    for p in args.texts:
        sentences += read_text_file(p)
    if args.from_lexicon:
        if not os.path.exists(args.lexicon):
            ap.error(f"lexicon not found: {args.lexicon}")
        sentences += lexicon_sentences(args.lexicon, args.from_lexicon,
                                       args.seed)
    if not sentences:
        ap.error("no training text: pass --texts and/or --from-lexicon N")

    tok = train_wordpiece(sentences, args.vocab_size)
    out = args.out or os.path.join(args.out_dir,
                                   f"vibert_{tok.get_vocab_size()}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    tok.save(out)
    print(f"trained on {len(sentences)} sentences -> {out} "
          f"(vocab {tok.get_vocab_size()})")
    return out


if __name__ == "__main__":
    main()
