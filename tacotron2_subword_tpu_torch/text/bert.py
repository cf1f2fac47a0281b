"""Subword tokenization + BERT [CLS] sentence embeddings (host-side; the
port's own copy of ``tacotron2_subword_tpu/text/bert.py``).

Mirrors the reference's get_embedding / get_embedding_cls
(reference data_utils.py:15-46): a ``tokenizers.Tokenizer`` JSON file
("vibert_{vocab}.json") produces subword token IDs with [CLS]/[SEP]
stripped, and a HF BertModel forward produces the 768-d [CLS] vector that
conditions both streams.

Model and tokenizer paths are local files.  ``tokenizers`` and
``transformers`` are imported only when a tokenizer or a BERT model is
loaded; without them the CLI uses ``hashed_subword_ids`` and a zero [CLS]
vector.  The [CLS] extraction runs the HF model on the CPU exactly as the
reference does (inference.py:351-353).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class SubwordTokenizer:
    """tokenizers.Tokenizer wrapper: text → subword IDs without the
    [CLS]/[SEP] specials (reference data_utils.py:15-26)."""

    def __init__(self, tokenizer_json: str):
        from tokenizers import Tokenizer
        if not os.path.exists(tokenizer_json):
            raise FileNotFoundError(tokenizer_json)
        self.tokenizer = Tokenizer.from_file(tokenizer_json)

    def encode(self, text: str) -> np.ndarray:
        ids = self.tokenizer.encode(text).ids
        # strip leading [CLS] / trailing [SEP] when the tokenizer adds them
        specials = {self.tokenizer.token_to_id(t)
                    for t in ("[CLS]", "[SEP]") if
                    self.tokenizer.token_to_id(t) is not None}
        ids = [i for i in ids if i not in specials]
        return np.asarray(ids, dtype=np.int32)

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.get_vocab_size()


class ClsEmbedder:
    """HF BertModel [CLS]-vector extractor (reference data_utils.py:28-46).

    ``model_path`` must be a local directory (nothing is downloaded); the
    reference uses bert-base-multilingual-cased.
    """

    def __init__(self, model_path: str):
        import torch
        from transformers import BertModel, BertTokenizer
        self.torch = torch
        self.tokenizer = BertTokenizer.from_pretrained(model_path)
        self.model = BertModel.from_pretrained(model_path)
        self.model.eval()

    def embed_cls(self, text: str) -> np.ndarray:
        inputs = self.tokenizer(text, return_tensors="pt", truncation=True,
                                max_length=512)
        with self.torch.no_grad():
            out = self.model(**inputs)
        return out.last_hidden_state[0, 0].numpy().astype(np.float32)


def repeat_cls(cls_vec: np.ndarray, length: int) -> np.ndarray:
    """CLS vector repeated per position (reference data_utils.py:77-78)."""
    return np.repeat(cls_vec[None, :], length, axis=0)


def hashed_subword_ids(text: str, vocab_size: int) -> np.ndarray:
    """Deterministic per-word subword-ID fallback for when no tokenizer
    asset is present (the reference always has data/vibert_*.json; this repo
    must degrade gracefully).  Uses crc32 — NOT Python ``hash``, which is
    salted per process (PYTHONHASHSEED) and would make training-time and
    inference-time IDs disagree across runs.  IDs land in [3, vocab_size)
    leaving 0..2 for pad/BOS/EOS conventions."""
    import zlib
    words = text.split()
    if not words:
        words = [""]
    return np.asarray(
        [zlib.crc32(w.encode("utf-8")) % max(vocab_size - 3, 1) + 3
         for w in words], np.int32)


def packaged_tokenizer_path() -> Optional[str]:
    """Path of the trained tokenizer shipped with the package
    (``assets/vibert_512.json``, a copy of the JAX package's asset, trained
    by tools/train_tokenizer.py over the Vietnamese syllable lexicon), or
    None if the package was installed without its data files.  The
    reference ships its equivalents as data/vibert_{5500..7500}.json
    (reference check_bert_emb.py:24-33)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets", "vibert_512.json")
    return path if os.path.exists(path) else None
