"""Dump a phone -> ID map built from lexicons (the port's copy of
``tacotron2_subword_tpu/apps/dump_phone_id_map.py``, reference
tools/dump_phone_id_map.py:1-58).

    python -m tacotron2_subword_tpu_torch.apps.dump_phone_id_map \
        --vi-lex ... --en-lex ... --foreign-lex ... --out phone_id_list.txt \
        [--delimiter z] [--pause-symbols lpau mpau]

The map is [pad, special, EOS, BOS, punctuation, pause symbols] + the
lexicons' sorted phones, written as ``phone\\tid`` lines.  The lexicons
default to the reference names under ``$T2S_RESOURCES_DIR`` (else
``resources/``).
"""

from __future__ import annotations

import argparse

from tacotron2_subword_tpu_torch.text import lexicon as L
from tacotron2_subword_tpu_torch.text.g2p import default_g2p_config


def main(argv=None) -> int:
    """Returns the number of symbols written."""
    cfg = default_g2p_config()
    res = cfg["resources"]
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--vi-lex", default=res["vi_lexicon_file"])
    p.add_argument("--en-lex", default=res["en_lexicon_file"])
    p.add_argument("--foreign-lex", default=res["foreign_lexicon_file"])
    p.add_argument("--out", required=True)
    p.add_argument("--delimiter", default=None)
    p.add_argument("--pause-symbols", nargs="*", default=["lpau", "mpau"])
    args = p.parse_args(argv)

    lexicon = L.build_lexicon(args.vi_lex, args.en_lex, args.foreign_lex)
    t2s = cfg["t2s"]
    punct = cfg["g2p"]["punctuation"].replace("\\", "")
    others = (list(t2s["pad"]) + list(t2s["special"]) + list(t2s["EOS"])
              + list(t2s["BOS"]) + list(punct) + list(args.pause_symbols))
    p2i, _ = L.build_phone_id_map(lexicon, others, args.delimiter)
    L.dump_phone_id_file(p2i, args.out)
    print(f"wrote {len(p2i)} symbols to {args.out}")
    return len(p2i)


if __name__ == "__main__":
    main()
