"""Tokenizer-variant check: compare the subword-ID streams (and, with a
local BERT model, the [CLS] vectors) of one text across tokenizer
vocabularies.

The port's copy of ``tacotron2_subword_tpu/apps/check_bert_emb.py`` (the
reference's check_bert_emb.py:1-102, which runs one sentence through five
vibert_{5500..7500}.json tokenizers and bert-base-multilingual-cased).  It
prints each variant's token stream and each pair's stream agreement
(lengths, exact prefix match, bag-of-IDs Jaccard) and, with
``--bert-model``, the pair's [CLS] cosine.  Without ``--tokenizers`` or
``--fallback-vocabs`` the tokenizer shipped with the package
(assets/vibert_512.json) is the one variant; ``--fallback-vocabs`` compares
the crc32 subword IDs the inference CLI uses when it has no tokenizer.
``tokenizers`` and ``transformers`` are imported only when a tokenizer or
BERT model is loaded.

    python -m tacotron2_subword_tpu_torch.apps.check_bert_emb \
        --text "toi so gian qua hoa lieu" \
        --tokenizers data/vibert_5500.json data/vibert_6000.json \
        [--bert-model /path/to/bert-base-multilingual-cased]
    python -m tacotron2_subword_tpu_torch.apps.check_bert_emb \
        --text "..." --fallback-vocabs 5500 6000 7500
"""

from __future__ import annotations

import argparse
import itertools
import os
from typing import Dict, List, Optional

import numpy as np

from tacotron2_subword_tpu_torch.text.bert import (hashed_subword_ids,
                                                   packaged_tokenizer_path)


def _stream_agreement(a: np.ndarray, b: np.ndarray) -> Dict:
    """Alignment-free comparison of two ID streams: lengths, exact prefix
    match fraction and bag-of-IDs Jaccard."""
    n = min(len(a), len(b))
    exact = float(np.mean(a[:n] == b[:n])) if n else 0.0
    sa, sb = set(a.tolist()), set(b.tolist())
    jacc = len(sa & sb) / max(len(sa | sb), 1)
    return {"len_a": len(a), "len_b": len(b),
            "prefix_match": round(exact, 4), "jaccard": round(jacc, 4)}


def check(text: str, tokenizers: Optional[List[str]] = None,
          fallback_vocabs: Optional[List[int]] = None,
          bert_model: Optional[str] = None) -> Dict:
    """Every tokenizer variant over ``text``, cross-compared.  Returns
    {"variants": {name: {"n_tokens", "vocab", "ids", "has_cls"}},
    "pairs": {"a|b": {agreement, "cls_cosine" with a BERT model}}}."""
    if tokenizers is None and not fallback_vocabs:
        packaged = packaged_tokenizer_path()
        tokenizers = [packaged] if packaged else []
    variants: Dict[str, Dict] = {}
    if tokenizers:
        from tacotron2_subword_tpu_torch.text.bert import SubwordTokenizer
    for path in tokenizers or []:
        tok = SubwordTokenizer(path)
        name = os.path.splitext(os.path.basename(path))[0]
        variants[name] = {"ids": tok.encode(text), "vocab": tok.vocab_size}
    for v in fallback_vocabs or []:
        variants[f"crc32_{v}"] = {"ids": hashed_subword_ids(text, int(v)),
                                  "vocab": int(v)}
    if not variants:
        raise ValueError("no tokenizer variants: pass --tokenizers and/or "
                         "--fallback-vocabs")

    cls = None
    if bert_model:
        # one local BERT body: the [CLS] vector does not depend on the
        # variant's stream, so each variant records the same one
        from tacotron2_subword_tpu_torch.text.bert import ClsEmbedder
        cls = ClsEmbedder(bert_model).embed_cls(text)
    for v in variants.values():
        v["cls"] = cls

    pairs: Dict[str, Dict] = {}
    for (na, va), (nb, vb) in itertools.combinations(variants.items(), 2):
        rec = _stream_agreement(np.asarray(va["ids"]), np.asarray(vb["ids"]))
        if va["cls"] is not None and vb["cls"] is not None:
            ca, cb = va["cls"], vb["cls"]
            rec["cls_cosine"] = round(float(
                np.dot(ca, cb) / (np.linalg.norm(ca) * np.linalg.norm(cb)
                                  + 1e-12)), 6)
        pairs[f"{na}|{nb}"] = rec
    return {"variants": {k: {"n_tokens": len(v["ids"]), "vocab": v["vocab"],
                             "ids": np.asarray(v["ids"]).tolist(),
                             "has_cls": v["cls"] is not None}
                         for k, v in variants.items()},
            "pairs": pairs}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--text", required=True)
    p.add_argument("--tokenizers", nargs="*", default=None,
                   help="tokenizers.Tokenizer JSON files (vibert_*.json)")
    p.add_argument("--fallback-vocabs", nargs="*", type=int, default=None,
                   help="compare the crc32 fallback IDs at these vocab sizes")
    p.add_argument("--bert-model", default=None,
                   help="local BERT model dir for [CLS] embedding cosines")
    args = p.parse_args(argv)
    rep = check(args.text, args.tokenizers, args.fallback_vocabs,
                args.bert_model)
    for name, v in rep["variants"].items():
        tail = " ..." if v["n_tokens"] > 16 else ""
        print(f"{name}: vocab={v['vocab']} n_tokens={v['n_tokens']} "
              f"ids={v['ids'][:16]}{tail}")
    for pair, rec in rep["pairs"].items():
        print(f"{pair}: {rec}")
    return rep


if __name__ == "__main__":
    main()
