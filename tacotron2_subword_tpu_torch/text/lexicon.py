"""Lexicon loading and phone/character ID maps (the port's own copy of
``tacotron2_subword_tpu/text/lexicon.py``).

Format compatibility with the reference (reference build/lib/g2p/
lexicon.py:47-167): lexicon files are ``word phone phone ...`` lines
(utf-8-sig), the phone-ID map file is ``phone\\tid`` lines, and the ID map
is built as [other_symbols] + sorted(phones) (+ delimiter-suffixed copies
when a syllable delimiter is configured).
"""

from __future__ import annotations

import codecs
from typing import Dict, List, Optional, Sequence, Tuple


def norm_vnmese_accent(text: str) -> str:
    """Vietnamese accent-position normalization (reference lexicon.py:5-43):
    short words use the old-style placement (uỳ→ùy, oà→òa) except after
    'qu'; longer words use the new-style placement."""
    uy_old = [("uỳ", "ùy"), ("uý", "úy"), ("uỷ", "ủy"), ("uỹ", "ũy"),
              ("uỵ", "ụy")]
    uy_new = [(b, a) for a, b in uy_old]
    oa_old = [("oà", "òa"), ("oá", "óa"), ("oả", "ỏa"), ("oã", "õa"),
              ("oạ", "ọa"), ("oè", "òe"), ("oé", "óe"), ("oẻ", "ỏe"),
              ("oẽ", "õe"), ("oẹ", "ọe")]
    oa_new = [(b, a) for a, b in oa_old]

    words = text.split(" ")
    for i, w in enumerate(words):
        if len(w) <= 3:
            for a, b in (uy_new if w.startswith("qu") else uy_old):
                w = w.replace(a, b)
            for a, b in oa_old:
                w = w.replace(a, b)
        else:
            for a, b in oa_new:
                w = w.replace(a, b)
        words[i] = w
    return " ".join(words)


def load_lexicon(path: str) -> Dict[str, str]:
    """word → space-joined phones."""
    lex: Dict[str, str] = {}
    with codecs.open(path, mode="r", encoding="utf-8-sig") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            lex[parts[0]] = " ".join(parts[1:])
    return lex


def build_lexicon(vi_path: str, en_path: str,
                  foreign_path: str) -> Tuple[Dict[str, str], ...]:
    return (load_lexicon(vi_path), load_lexicon(en_path),
            load_lexicon(foreign_path))


def build_phone_id_map(lexicon: Sequence[Dict[str, str]],
                       other_symbols: Sequence[str] = (),
                       delimiter: Optional[str] = None
                       ) -> Tuple[Dict[str, int], Dict[int, str]]:
    """ID map = [other_symbols(+delim copies)] + sorted(phones) (+ delim
    copies), reference lexicon.py:111-139."""
    phones: List[str] = []
    for lex in lexicon:
        for value in lex.values():
            for phone in value.split(" "):
                if phone and phone not in phones:
                    phones.append(phone)
    phones = sorted(phones)
    others = [s for s in other_symbols if s]
    if delimiter is not None:
        phones = ([s + delimiter for s in others] + phones
                  + [p + delimiter for p in phones])
    else:
        phones = others + phones
    phone_to_id = {s: i for i, s in enumerate(phones)}
    id_to_phone = {i: s for i, s in enumerate(phones)}
    return phone_to_id, id_to_phone


def load_phone_id_file(path: str) -> Tuple[Dict[str, int], Dict[int, str]]:
    """Load a ``phone\\tid`` map file (reference lexicon.py:144-161; note
    the reference keeps IDs as *strings* — we convert to int, documented
    divergence)."""
    phone_to_id: Dict[str, int] = {}
    id_to_phone: Dict[int, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            values = line.rstrip("\n").split("\t")
            if len(values) != 2:
                continue
            phone, idphone = values
            phone_to_id[phone] = int(idphone)
            id_to_phone[int(idphone)] = phone
    return phone_to_id, id_to_phone


def build_character_id_map(letters: str, other_symbols: Sequence[str] = ()
                           ) -> Tuple[Dict[str, int], Dict[int, str]]:
    symbols = list(letters) + list(other_symbols)
    return ({s: i for i, s in enumerate(symbols)},
            {i: s for i, s in enumerate(symbols)})


def dump_phone_id_file(phone_to_id: Dict[str, int], path: str) -> None:
    """Write the map as ``phone\tid`` lines in ID order (the format
    ``load_phone_id_file`` reads)."""
    with open(path, "w", encoding="utf-8") as f:
        for phone, pid in sorted(phone_to_id.items(), key=lambda kv: kv[1]):
            f.write(f"{phone}\t{pid}\n")
