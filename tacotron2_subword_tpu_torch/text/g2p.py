"""Grapheme-to-phoneme front-end (the port's own copy of
``tacotron2_subword_tpu/text/g2p.py``).

Behavior mirror of the reference G2P / G2P_Phonetisaurus (reference
build/lib/g2p/g2p.py:11-158): word-by-word lookup through the Vietnamese →
foreign → English lexicons, punctuation pass-through, OOV words decoded by
the (native C++) joint-sequence model, and optional Kaldi-style positional
tagging (_B/_I/_E/_S) with punctuation→pause-phone mapping.

Config is a plain dict matching the reference's YAML schema
(conf/config_phonetisaurus.yml); ``default_g2p_config()`` reproduces its
values and points the lexicon paths into the resources directory:
``$T2S_RESOURCES_DIR``, else ``resources/`` under the working directory
(the data files are not vendored).  PyYAML is imported only where a YAML
config file is read.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

from tacotron2_subword_tpu_torch.text import lexicon as L
from tacotron2_subword_tpu_torch.text.fst_g2p import FstG2PModel


def default_resources_dir() -> str:
    """Where the lexicons and phone-ID lists live: ``$T2S_RESOURCES_DIR``,
    else ``resources`` under the working directory."""
    return os.environ.get("T2S_RESOURCES_DIR", "resources")


def default_g2p_config(resources_dir: Optional[str] = None) -> Dict:
    """Reference conf/config_phonetisaurus.yml equivalent."""
    res = resources_dir or default_resources_dir()
    return {
        "g2p": {
            "nbest": 1, "beam": 10000, "thresh": 99.0, "write_fsts": False,
            "accumulate": False, "pmass": 0.0,
            "punctuation": "!\\'(),.:;?",
        },
        "resources": {
            "vi_lexicon_file": os.path.join(
                res, "all-vietnamese-syllables_17k9.XSAMPA.Mien-BAC_KA.txt"),
            "foreign_lexicon_file": os.path.join(
                res, "03_all_foreign_words.10600woreds.30102020.lex"),
            "en_lexicon_file": os.path.join(
                res, "cmudict-0.7b.vi.mergeEng-xsampa.forE2E.KA.txt"),
            "load_default": False,
        },
        "t2s": {
            "special": "-", "pad": "_", "EOS": "~", "BOS": "+",
            "white_space": " ",
            "letters": ("jJfFwWzZaáàăắằẵẳặâấầẫẩậãảạbcdđeéèêếềễểệẽẻẹghiíìĩỉị"
                        "klmnoóòôốồỗổộõỏọơớờỡởợpqrstuúùũủụưứừữửựvxyýỳỹỷỵ"
                        "AÁÀĂẮẰẴẲẶÂẤẦẪẨẬÃẢẠBCDĐEÉÈÊẾỀỄỂỆẼẺẸGHIÍÌĨỈỊ"
                        "KLMNOÓÒÔỐỒỖỔỘÕỎỌƠỚỜỠỞỢPQRSTUÚÙŨỦỤƯỨỪỮỬỰVXYÝỲỸỶỴ"),
        },
        "kaldi_format": {
            "kaldi_format": False, "begin": "_B", "end": "_E",
            "inner": "_I", "single": "_S",
            "g2p_punctuation": {"!": "lpau", "'": None, "(": None,
                                ")": None, ",": "mpau", ".": "lpau",
                                ":": "lpau", ";": "lpau", "?": "lpau",
                                " ": None},
        },
    }


class G2P:
    """Lexicon-lookup G2P with OOV hook (reference g2p.py:11-118)."""

    def __init__(self, config):
        if isinstance(config, str):
            import yaml
            with open(config) as f:
                self.config = yaml.safe_load(f)
        else:
            self.config = config
        res = self.config["resources"]
        self.lexicon = L.build_lexicon(res["vi_lexicon_file"],
                                       res["en_lexicon_file"],
                                       res["foreign_lexicon_file"])
        self.vi_lex, self.en_lex, self.foreign_lex = self.lexicon
        self._punctuation = self.config["g2p"]["punctuation"].replace(
            "\\", "")

    def infer(self, word: str) -> str:
        raise NotImplementedError

    def g2p(self, text: str, punctuation: Optional[str] = None) -> str:
        """text → syllable-space-separated, '|'-joined phone string
        (reference g2p.py:45-75; lookup order vi → foreign → en)."""
        if punctuation is not None:
            self._punctuation = punctuation
        parts = []
        unk = []
        for word in text.split():
            for lex in (self.vi_lex, self.foreign_lex, self.en_lex):
                if word in lex:
                    parts.append(re.sub(" ", "|", " ".join(lex[word].split())))
                    break
            else:
                if word in self._punctuation:
                    parts.append(word)
                else:
                    unk.append(word)
                    parts.append(self.infer(word))
        out = " ".join(p for p in parts if p).strip()
        if out and self.config["kaldi_format"]["kaldi_format"]:
            out = self.convert_kaldi_format(out)
        return out

    def convert_kaldi_format(self, phone_seq: str) -> str:
        """Positional tagging + punctuation→pause phones (reference
        g2p.py:77-118)."""
        kf = self.config["kaldi_format"]
        begin, end = kf["begin"], kf["end"]
        inner, single = kf["inner"], kf["single"]
        g2p_punct = kf["g2p_punctuation"]
        for punc in self._punctuation:
            if punc not in g2p_punct:
                raise ValueError(
                    f"Punctuation {punc!r} must be configured in "
                    f"g2p_punctuation")
        out = []
        for syllable in phone_seq.split(" "):
            phones = [p for p in syllable.split("|") if p.strip()]
            if not phones:
                continue
            if len(phones) > 1:
                for p in phones:
                    if p in self._punctuation:
                        raise RuntimeError(
                            f"Punctuation {p!r} must be single word!")
            if len(phones) == 1:
                if phones[0] in self._punctuation:
                    pause = g2p_punct[phones[0]]
                    if pause:
                        out.append(pause)
                else:
                    out.append(phones[0] + single)
            elif len(phones) == 2:
                out.append(phones[0] + begin + "|" + phones[1] + end)
            else:
                mid = "|".join(p + inner for p in phones[1:-1])
                out.append(phones[0] + begin + "|" + mid + "|"
                           + phones[-1] + end)
        return " ".join(out)


class G2PFst(G2P):
    """G2P with the native joint-sequence model for OOV words — the
    framework's G2P_Phonetisaurus (reference g2p.py:120-158).

    ``model_path`` may be a trained model file (.g2pfst) or a lexicon file
    to train from on the fly (mirroring how the reference trains its FST
    from lexicons offline).
    """

    def __init__(self, model_path: str, config=None, beam: int = 500):
        super().__init__(config or default_g2p_config())
        self.model_path = model_path
        self.beam = beam
        if model_path.endswith(".g2pfst") and os.path.exists(model_path):
            self.model = FstG2PModel.load(model_path)
        elif os.path.exists(model_path):
            self.model = FstG2PModel.train(model_path)
        else:
            raise IOError(f"No such file: {model_path}")

    def infer(self, word: str) -> str:
        # '9'→'_' output-symbol mapping kept from the reference
        # (g2p.py:151-153, an artifact of its FST symbol table).
        return self.model.phoneticize(word, self.beam).replace("9", "_")
