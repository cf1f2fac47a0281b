"""The port's text front end against the JAX package's on a small lexicon
(the one of tests/test_apps_cli.py): phone-ID maps, G2P phones (native
engine, its Python mirror and the JAX package's), Kaldi tagging, phone-ID
sequences, hashed subword IDs and tokenizer IDs.  Everything here is exact."""

import copy

import numpy as np
import pytest

from tacotron2_subword_tpu.text import bert as JB
from tacotron2_subword_tpu.text import fst_g2p as JF
from tacotron2_subword_tpu.text import g2p as JG
from tacotron2_subword_tpu.text import lexicon as JL
from tacotron2_subword_tpu.text import text_to_sequence as JT
from tacotron2_subword_tpu_torch.text import bert as TB
from tacotron2_subword_tpu_torch.text import fst_g2p as TF
from tacotron2_subword_tpu_torch.text import g2p as TG
from tacotron2_subword_tpu_torch.text import lexicon as TL
from tacotron2_subword_tpu_torch.text import text_to_sequence as TT
from tests.torch_threads import one_torch_thread  # noqa: F401

LEXICON = ("an a_1 n\nanh a_1 J\nba b a_1\nbanh b a_1 J\n"
           "em E_1 m\nme m E_1\nnam n a_1 m\n")
RESOURCE_NAMES = ("all-vietnamese-syllables_17k9.XSAMPA.Mien-BAC_KA.txt",
                  "03_all_foreign_words.10600woreds.30102020.lex",
                  "cmudict-0.7b.vi.mergeEng-xsampa.forE2E.KA.txt")
TEXTS = ("ba me em",                  # in the lexicon
         "bam nhanh emb",             # out of it: the G2P model decodes
         "nam , anh banh !",          # punctuation passes through
         "me ba . em ? an")
OOV_WORDS = ("bam", "nhanh", "emb", "anba", "mem", "bnam", "e")


@pytest.fixture(scope="module")
def resources(tmp_path_factory):
    """(lexicon path, resources dir holding the three reference lexicon
    names and a phone_id_list.txt made by the JAX package)."""
    d = tmp_path_factory.mktemp("t2s")
    lex = d / "small.lex"
    lex.write_text(LEXICON, encoding="utf-8")
    for name in RESOURCE_NAMES:
        (d / name).write_text(LEXICON, encoding="utf-8")
    cfg = JG.default_g2p_config(str(d))
    t2s = cfg["t2s"]
    others = (list(t2s["pad"]) + list(t2s["special"]) + list(t2s["EOS"])
              + list(t2s["BOS"])
              + list(cfg["g2p"]["punctuation"].replace("\\", ""))
              + [" ", "lpau", "mpau"])
    p2i, _ = JL.build_phone_id_map([JL.load_lexicon(str(lex))], others)
    JL.dump_phone_id_file(p2i, str(d / "phone_id_list.txt"))
    return str(lex), str(d)


def test_lexicon_and_phone_id_maps_equal(resources):
    lex, d = resources
    assert TL.load_lexicon(lex) == JL.load_lexicon(lex)
    lexicons = [TL.load_lexicon(lex)]
    for others, delim in (((), None), (("_", "-", "~", "+"), None),
                          (("_", "~", "+"), "z")):
        assert (TL.build_phone_id_map(lexicons, others, delim)
                == JL.build_phone_id_map(lexicons, others, delim))
    path = f"{d}/phone_id_list.txt"
    assert TL.load_phone_id_file(path) == JL.load_phone_id_file(path)
    assert (TL.build_character_id_map("abcđ", ["_", "~"])
            == JL.build_character_id_map("abcđ", ["_", "~"]))
    for text in ("thuỷ hoà", "quỳ khoẻ", "uỳ oà"):
        assert TL.norm_vnmese_accent(text) == JL.norm_vnmese_accent(text)


def test_g2p_engines_agree(resources):
    """The port's native engine (built from its own copy of the C++
    source), its pure-Python mirror and the JAX package's engine give the
    same phones for words outside the lexicon."""
    lex, _ = resources
    assert TF.FstG2PModel.native_available()
    native = TF.FstG2PModel.train(lex)
    assert isinstance(native, TF.FstG2PModel)
    mirror = TF._PyG2PModel.train(lex)
    ref = JF.FstG2PModel.train(lex)
    assert native.num_graphones == mirror.num_graphones == ref.num_graphones
    for word in OOV_WORDS:
        want = ref.phoneticize(word)
        assert native.phoneticize(word) == want, word
        assert mirror.phoneticize(word) == want, word


@pytest.mark.parametrize("kaldi", [False, True])
def test_g2p_phones_equal(resources, kaldi):
    lex, d = resources
    cfg = JG.default_g2p_config(d)
    cfg["kaldi_format"]["kaldi_format"] = kaldi
    assert TG.default_g2p_config(d) == JG.default_g2p_config(d)
    ref = JG.G2PFst(lex, copy.deepcopy(cfg))
    port = TG.G2PFst(lex, copy.deepcopy(cfg))
    for text in TEXTS:
        assert port.g2p(text) == ref.g2p(text), text
    for phones in ("b|a_1 m|E_1 , E_1|m", "a_1 n|a_1|m ."):
        assert (port.convert_kaldi_format(phones)
                == ref.convert_kaldi_format(phones))


@pytest.mark.parametrize("id_list", [True, False])
def test_text_to_sequence_equal(resources, monkeypatch, id_list):
    """IDs from a phone_id_list.txt, or from the map built from the
    lexicons when the file is absent (the pad '_' keeps its ID 0)."""
    lex, d = resources
    monkeypatch.setenv("T2S_RESOURCES_DIR", d)
    id_file = f"{d}/phone_id_list.txt" if id_list else f"{d}/absent.txt"
    ref = JT.Text2Seq(lex, phone_id_list_file=id_file)
    port = TT.Text2Seq(lex, phone_id_list_file=id_file)
    assert port.phone_to_id == ref.phone_to_id
    assert port.symbol_to_id == ref.symbol_to_id
    for text in TEXTS:
        assert (port.grapheme_to_sequence(text)
                == ref.grapheme_to_sequence(text)), text
        chars = text.replace(" ", "")  # the letters table has no space
        assert (port.text_to_sequence(chars, is_phone=False, padding=True)
                == ref.text_to_sequence(chars, is_phone=False, padding=True))
    assert port.phone_to_sequence("_ b|a_1") == ref.phone_to_sequence(
        "_ b|a_1")
    # the default phone-ID file comes from T2S_RESOURCES_DIR
    if id_list:
        assert TT.Text2Seq(lex).phone_to_id == ref.phone_to_id


def test_hashed_subword_ids_equal():
    for text in ("", "ba me em", "Nam, anh bánh!", "tôi  yêu   hà nội"):
        for vocab in (5, 31, 5500):
            np.testing.assert_array_equal(TB.hashed_subword_ids(text, vocab),
                                          JB.hashed_subword_ids(text, vocab))
    ids = TB.hashed_subword_ids("ba me em", 31)
    assert ids.dtype == np.int32 and (ids >= 3).all() and (ids < 31).all()
    cls = np.arange(4, dtype=np.float32)
    np.testing.assert_array_equal(TB.repeat_cls(cls, 3),
                                  JB.repeat_cls(cls, 3))


def test_tokenizer_ids_equal():
    pytest.importorskip("tokenizers")
    path = JB.packaged_tokenizer_path()
    assert path is not None
    ref, port = JB.SubwordTokenizer(path), TB.SubwordTokenizer(path)
    assert port.vocab_size == ref.vocab_size
    for text in ("tôi yêu hà nội", "xin chào các bạn", "ba me em"):
        np.testing.assert_array_equal(port.encode(text), ref.encode(text))
