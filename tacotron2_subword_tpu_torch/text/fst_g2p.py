"""Python interface to the native C++ joint-sequence G2P engine (the port's
own copy of ``tacotron2_subword_tpu/text/fst_g2p.py``).

The engine is the port's copy of the host C++ source,
``tacotron2_subword_tpu_torch/native/g2p_fst.cpp``, built at first use with
``g++ -O2 -std=c++17 -fPIC -shared`` into ``_kbuild/libg2p_fst-<hash>.so``
and loaded with ctypes — the framework's equivalent of the reference's
``import phonetisaurus`` C++ binding (reference build/lib/g2p/g2p.py:5,138).
When the library cannot be built (no compiler), a pure-Python mirror of the
same algorithm (Viterbi-EM graphone alignment + trigram LM + beam decode)
gives the same phones at lower speed; ``FstG2PModel.native_available()``
says which engine runs, and the fallback is reported once on stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC = _PKG_DIR / "native" / "g2p_fst.cpp"
_BUILD_DIR = _PKG_DIR / "_kbuild"
_CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib_cache: Dict[str, Optional[ctypes.CDLL]] = {}


def _build_lib() -> Path:
    """Compile the engine unless this source and these flags are built
    already; returns the library's path.  Raises if the compiler fails."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + b"\0"
                       + _SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libg2p_fst-{h}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} exit {proc.returncode}: {proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent reader never sees half a file
    return out


def _load_lib() -> Optional[ctypes.CDLL]:
    """The engine's ctypes handle, or None when it cannot be built (then
    the pure-Python mirror runs).  Built and loaded once per process."""
    if "lib" in _lib_cache:
        return _lib_cache["lib"]
    try:
        lib = ctypes.CDLL(str(_build_lib()))
    except (OSError, RuntimeError) as e:
        print(f"fst_g2p: native engine unavailable, using the Python "
              f"mirror ({e})", file=sys.stderr)
        _lib_cache["lib"] = None
        return None
    lib.g2p_train.restype = ctypes.c_void_p
    lib.g2p_train.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int]
    lib.g2p_save.restype = ctypes.c_int
    lib.g2p_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.g2p_load.restype = ctypes.c_void_p
    lib.g2p_load.argtypes = [ctypes.c_char_p]
    lib.g2p_phoneticize.restype = ctypes.c_int
    lib.g2p_phoneticize.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_int]
    lib.g2p_num_graphones.restype = ctypes.c_int
    lib.g2p_num_graphones.argtypes = [ctypes.c_void_p]
    lib.g2p_free.argtypes = [ctypes.c_void_p]
    _lib_cache["lib"] = lib
    return lib


class FstG2PModel:
    """Native-backed G2P model (train / save / load / phoneticize)."""

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib
        self._buf = ctypes.create_string_buffer(8192)

    @classmethod
    def native_available(cls) -> bool:
        """True when the native engine builds and loads (else the
        pure-Python mirror runs)."""
        return _load_lib() is not None

    @classmethod
    def train(cls, lexicon_path: str, max_g: int = 2, max_p: int = 2,
              em_iters: int = 4) -> "FstG2PModel":
        lib = _load_lib()
        if lib is None:
            return _PyG2PModel.train(lexicon_path, max_g, max_p, em_iters)
        h = lib.g2p_train(lexicon_path.encode(), max_g, max_p, em_iters)
        if not h:
            raise RuntimeError(f"g2p_train failed on {lexicon_path}")
        return cls(h, lib)

    @classmethod
    def load(cls, model_path: str) -> "FstG2PModel":
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(
                "the native G2P engine could not be built and the "
                "pure-Python mirror cannot load a saved model")
        h = lib.g2p_load(model_path.encode())
        if not h:
            raise RuntimeError(f"g2p_load failed on {model_path}")
        return cls(h, lib)

    def save(self, path: str) -> None:
        if self._lib.g2p_save(self._h, path.encode()) != 0:
            raise RuntimeError(f"g2p_save failed: {path}")

    @property
    def num_graphones(self) -> int:
        return self._lib.g2p_num_graphones(self._h)

    def phoneticize(self, word: str, beam: int = 500) -> str:
        """word → 'p|h|o|n' (the reference's infer() output format,
        build/lib/g2p/g2p.py:140-158)."""
        n = self._lib.g2p_phoneticize(self._h, word.encode(), beam,
                                      self._buf, len(self._buf))
        if n < 0:
            return ""
        return self._buf.value.decode()

    def __del__(self):
        try:
            if self._h and self._lib:
                self._lib.g2p_free(self._h)
                self._h = None
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Pure-Python mirror (same algorithm; used when the .so isn't built)
# ---------------------------------------------------------------------------

class _PyG2PModel:
    NEG_INF = -1e30

    def __init__(self):
        self.graphones: List[Tuple[str, str]] = []
        self.graphone_id: Dict[Tuple[str, str], int] = {}
        self.by_grapheme: Dict[str, List[int]] = defaultdict(list)
        self.trigram: Dict[Tuple[int, int], Dict[int, float]] = {}
        self.bigram: Dict[int, Dict[int, float]] = {}
        self.unigram: Dict[int, float] = {}
        self.unigram_floor = -20.0
        self.max_g, self.max_p = 2, 2

    # -- training --
    @classmethod
    def train(cls, lexicon_path: str, max_g=2, max_p=2, em_iters=4):
        import codecs
        entries = []
        with codecs.open(lexicon_path, "r", encoding="utf-8-sig") as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) >= 2 and len(parts[0]) <= 40:
                    entries.append((list(parts[0]), parts[1:]))
        m = cls()
        m.max_g, m.max_p = max_g, max_p
        logp: Dict[Tuple[str, str], float] = {}
        unk = -12.0

        def align(graphemes, phones):
            G, P = len(graphemes), len(phones)
            D = [[cls.NEG_INF] * (P + 1) for _ in range(G + 1)]
            bp = [[(0, 0)] * (P + 1) for _ in range(G + 1)]
            D[0][0] = 0.0
            for i in range(G + 1):
                for j in range(P + 1):
                    if D[i][j] <= cls.NEG_INF / 2:
                        continue
                    for dg in range(1, max_g + 1):
                        if i + dg > G:
                            break
                        for dp in range(0, max_p + 1):
                            if j + dp > P:
                                break
                            g = "".join(graphemes[i:i + dg])
                            p = "|".join(phones[j:j + dp])
                            s = (D[i][j] + logp.get((g, p), unk)
                                 - (2.0 if dp == 0 else 0.0))
                            if s > D[i + dg][j + dp]:
                                D[i + dg][j + dp] = s
                                bp[i + dg][j + dp] = (dg, dp)
            if D[G][P] <= cls.NEG_INF / 2:
                return None
            out = []
            i, j = G, P
            while i > 0 or j > 0:
                dg, dp = bp[i][j]
                if dg == 0 and dp == 0:
                    return None
                out.append(("".join(graphemes[i - dg:i]),
                            "|".join(phones[j - dp:j])))
                i, j = i - dg, j - dp
            return out[::-1]

        for _ in range(max(1, em_iters)):
            counts: Dict[Tuple[str, str], float] = defaultdict(float)
            total = 0.0
            for graphemes, phones in entries:
                al = align(graphemes, phones)
                if not al:
                    continue
                for gp in al:
                    counts[gp] += 1.0
                    total += 1.0
            logp = {k: math.log(v / total) for k, v in counts.items()}
            unk = math.log(0.5 / total)

        BOS, EOS = -1, -2
        tri_c: Dict[Tuple[int, int], Dict[int, float]] = defaultdict(
            lambda: defaultdict(float))
        big_c: Dict[int, Dict[int, float]] = defaultdict(
            lambda: defaultdict(float))
        uni_c: Dict[int, float] = defaultdict(float)
        uni_total = 0.0
        for graphemes, phones in entries:
            al = align(graphemes, phones)
            if not al:
                continue
            ids = []
            for gp in al:
                if gp not in m.graphone_id:
                    m.graphone_id[gp] = len(m.graphones)
                    m.by_grapheme[gp[0]].append(len(m.graphones))
                    m.graphones.append(gp)
                ids.append(m.graphone_id[gp])
            h1, h2 = BOS, BOS
            for k in range(len(ids) + 1):
                w = ids[k] if k < len(ids) else EOS
                tri_c[(h1, h2)][w] += 1.0
                big_c[h2][w] += 1.0
                uni_c[w] += 1.0
                uni_total += 1.0
                h1, h2 = h2, w
        for ctx, cc in tri_c.items():
            tot = sum(cc.values())
            T = len(cc)
            m.trigram[ctx] = {w: math.log(c / (tot + T))
                              for w, c in cc.items()}
        for h, cc in big_c.items():
            tot = sum(cc.values())
            T = len(cc)
            m.bigram[h] = {w: math.log(c / (tot + T)) for w, c in cc.items()}
        m.unigram = {w: math.log(c / uni_total) for w, c in uni_c.items()}
        m.unigram_floor = math.log(0.5 / uni_total)
        return m

    def _lm(self, h1, h2, w):
        t = self.trigram.get((h1, h2))
        if t is not None and w in t:
            return t[w]
        b = self.bigram.get(h2)
        if b is not None and w in b:
            return b[w] - 1.0
        return self.unigram.get(w, self.unigram_floor) - 2.0

    @property
    def num_graphones(self):
        return len(self.graphones)

    def save(self, path):
        raise NotImplementedError(
            "the pure-Python mirror has no serializer; the native engine "
            "saves models")

    def phoneticize(self, word: str, beam: int = 500) -> str:
        chars = list(word)
        G = len(chars)
        beams: List[List[Tuple[float, int, int, int, int]]] = [
            [] for _ in range(G + 1)]
        beams[0].append((0.0, -1, -1, -1, -1))
        for i in range(G):
            for hi, (score, h1, h2, _, _) in enumerate(beams[i]):
                for dg in range(1, self.max_g + 1):
                    if i + dg > G:
                        break
                    g = "".join(chars[i:i + dg])
                    for gid in self.by_grapheme.get(g, ()):
                        s = score + self._lm(h1, h2, gid)
                        beams[i + dg].append((s, h2, gid, hi, gid))
            for j in range(i + 1, min(G, i + self.max_g) + 1):
                if len(beams[j]) > beam:
                    beams[j].sort(key=lambda h: -h[0])
                    del beams[j][beam:]
        if not beams[G]:
            out = []
            for c in chars:
                cands = self.by_grapheme.get(c)
                if not cands:
                    continue
                best = max(cands, key=lambda gid: self.unigram.get(
                    gid, self.unigram_floor))
                p = self.graphones[best][1]
                if p:
                    out.append(p)
            return "|".join(out)
        best_hi, best_s = -1, self.NEG_INF
        for hi, (score, h1, h2, _, _) in enumerate(beams[G]):
            s = score + self._lm(h1, h2, -2)
            if s > best_s:
                best_s, best_hi = s, hi
        gids = []
        pos, idx = G, best_hi
        while pos > 0 and idx >= 0:
            score, h1, h2, prev, gid = beams[pos][idx]
            if gid < 0:
                break
            gids.append(gid)
            pos -= len(self.graphones[gid][0])
            idx = prev
        gids.reverse()
        return "|".join(self.graphones[g][1] for g in gids
                        if self.graphones[g][1])
