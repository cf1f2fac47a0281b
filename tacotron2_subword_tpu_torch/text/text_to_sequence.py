"""Text → phone-ID sequences (the reference's Text2Seq,
build/lib/g2p/text_to_sequence.py:7-177; the port's own copy of
``tacotron2_subword_tpu/text/text_to_sequence.py``).

Semantics preserved exactly: BOS '+' / EOS '~' padding, optional
per-syllable delimiter (e.g. 'z' → 'a|n|hz'), whitespace phones between
syllables (dropped when ignore_white_space), phone-ID map loaded from a
``phone\\tid`` file or built from the lexicons.

One reference defect fixed and documented: `_convert_phone_to_id` returns
the raw ID and the callers test `if phone_id:` — which silently DROPS the
phone with ID 0 (the pad '_').  We test `is not None` instead.
"""

from __future__ import annotations

import os
from typing import List, Optional

from tacotron2_subword_tpu_torch.text import lexicon as L
from tacotron2_subword_tpu_torch.text.g2p import (G2PFst, default_g2p_config,
                                                  default_resources_dir)


class Text2Seq:
    def __init__(self, g2p_model_path: str, g2p_config=None,
                 phone_id_list_file: Optional[str] = None,
                 g2p_model_type: str = "phonetisaurus",
                 delimiter: Optional[str] = None,
                 ignore_white_space: bool = False):
        if g2p_model_type == "transformer":
            # reference text_to_sequence.py:25-30 — the legacy torch
            # transformer G2P is explicitly unsupported there too
            raise ValueError(
                "The transformer g2p model is no longer supported.")
        if g2p_model_type != "phonetisaurus":
            raise ValueError(f"unknown g2p_model_type {g2p_model_type!r}")
        if phone_id_list_file is None:
            name = ("phone_id_list.delimiter." + delimiter + ".txt"
                    if delimiter is not None else "phone_id_list.txt")
            phone_id_list_file = os.path.join(default_resources_dir(), name)

        self.g2p = G2PFst(g2p_model_path, g2p_config or default_g2p_config())
        self.config = self.g2p.config
        self.delimiter = delimiter
        self.ignore_white_space = ignore_white_space

        t2s = self.config["t2s"]
        self._pad = t2s["pad"]
        self._special = t2s["special"]
        self._EOS = t2s["EOS"]
        self._BOS = t2s["BOS"]
        self.white_space = t2s.get("white_space", " ")
        self._letters = t2s["letters"]
        self._punctuation = self.config["g2p"]["punctuation"].replace(
            "\\", "")

        other_symbols = (list(self._pad) + list(self._special)
                         + list(self._EOS) + list(self._BOS)
                         + list(self._punctuation))
        if os.path.isfile(phone_id_list_file):
            self.phone_to_id, self.id_to_phone = L.load_phone_id_file(
                phone_id_list_file)
        else:
            self.phone_to_id, self.id_to_phone = L.build_phone_id_map(
                self.g2p.lexicon, other_symbols, delimiter)
        self.symbol_to_id, self.id_to_symbol = L.build_character_id_map(
            self._letters, other_symbols)
        if self.delimiter is not None:
            self._EOS = self._EOS + self.delimiter
            self._BOS = self._BOS + self.delimiter

    # -- helpers ---------------------------------------------------------

    def pad_sequence(self, sequence: List[int],
                     is_phone: bool = True) -> List[int]:
        table = self.phone_to_id if is_phone else self.symbol_to_id
        return [table[self._BOS]] + sequence + [table[self._EOS]]

    def _phone_id(self, phone: str) -> Optional[int]:
        if phone and phone in self.phone_to_id:
            return self.phone_to_id[phone]
        if phone:
            print(f'WARNING: phone "{phone}" is not in phone id map')
        return None

    def _append_white_space(self, sequence: List[int]) -> None:
        ws = (self.white_space + self.delimiter
              if self.delimiter is not None else self.white_space)
        pid = self._phone_id(ws)
        if pid is not None:
            sequence.append(pid)

    # -- public API ------------------------------------------------------

    def phone_to_sequence(self, phone_sequence: str,
                          padding: bool = True) -> List[int]:
        """'p|h|i|n t|h|i|m' → IDs (reference text_to_sequence.py:147-177)."""
        sequence: List[int] = []
        for syllable in phone_sequence.split(" "):
            if self.delimiter is not None:
                syllable = syllable + self.delimiter
            for phone in syllable.split("|"):
                pid = self._phone_id(phone)
                if pid is not None:
                    sequence.append(pid)
            if not self.ignore_white_space:
                self._append_white_space(sequence)
        if not self.ignore_white_space and sequence:
            sequence = sequence[:-1]
        if padding:
            sequence = self.pad_sequence(sequence)
        return sequence

    def grapheme_to_sequence(self, text: str,
                             padding: bool = True) -> List[int]:
        """text → G2P → IDs (reference text_to_sequence.py:131-134)."""
        return self.phone_to_sequence(self.g2p.g2p(text), padding=padding)

    def text_to_sequence(self, inputs: str, is_phone: bool = True,
                         padding: bool = False) -> List[int]:
        """Phone string or raw characters → IDs (reference
        text_to_sequence.py:89-118)."""
        if is_phone:
            return self.phone_to_sequence(inputs, padding=padding)
        sequence = [self.symbol_to_id[ch]
                    for ch in inputs.replace("\\", "")]
        if padding:
            sequence = self.pad_sequence(sequence, is_phone=False)
        return sequence
