// g2p_fst: joint-sequence n-gram grapheme-to-phoneme engine (C++17).
//
// Native equivalent of the reference's Phonetisaurus OpenFst decoder
// (reference build/lib/g2p/g2p.py:120-158 wraps `phonetisaurus.Phonetisaurus
// (model.fst).Phoneticize(word, nbest, beam, thresh, ...)`).  Rather than
// parsing OpenFst binaries, this implements the same modelling approach
// end-to-end: EM-aligned graphones (grapheme-chunk/phoneme-chunk pairs, the
// joint-sequence model of Bisani & Ney 2008 that Phonetisaurus trains) with
// a Witten-Bell-smoothed trigram LM over graphone tokens, and a beam-search
// shortest-path decode — so OOV words get pronunciations from a model
// trained on the same lexicons the reference ships.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).
//
//   void* g2p_train(const char* lexicon_path, int max_g, int max_p,
//                   int em_iters);
//   int   g2p_save(void* model, const char* path);
//   void* g2p_load(const char* path);
//   int   g2p_phoneticize(void* model, const char* word, int beam,
//                         char* out, int out_cap);
//   void  g2p_free(void* model);

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double NEG_INF = -1e30;

// ---- UTF-8 helpers --------------------------------------------------------

std::vector<std::string> utf8_chars(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size()) {
    unsigned char c = s[i];
    size_t len = 1;
    if ((c & 0x80) == 0) len = 1;
    else if ((c & 0xE0) == 0xC0) len = 2;
    else if ((c & 0xF0) == 0xE0) len = 3;
    else if ((c & 0xF8) == 0xF0) len = 4;
    if (i + len > s.size()) len = 1;
    out.push_back(s.substr(i, len));
    i += len;
  }
  return out;
}

// ---- Model ----------------------------------------------------------------

struct Graphone {
  std::string g;  // grapheme chunk (UTF-8, possibly multi-char)
  std::string p;  // phoneme chunk ("" = epsilon, "|"-joined if multi)
};

struct Model {
  std::vector<Graphone> graphones;
  std::unordered_map<std::string, int> graphone_id;  // key: g + "\x01" + p
  // grapheme chunk -> candidate graphone ids (for the decoder)
  std::unordered_map<std::string, std::vector<int>> by_grapheme;
  // n-gram log-probs over graphone ids; context key: "h1,h2" (ids, -1 = BOS)
  std::unordered_map<std::string, std::unordered_map<int, double>> trigram;
  std::unordered_map<int64_t, std::unordered_map<int, double>> bigram;
  std::unordered_map<int, double> unigram;
  double unigram_floor = -20.0;
  int max_g = 2, max_p = 2;
};

std::string gp_key(const std::string& g, const std::string& p) {
  return g + '\x01' + p;
}

// ---- Lexicon --------------------------------------------------------------

struct Entry {
  std::vector<std::string> graphemes;
  std::vector<std::string> phones;
};

std::vector<Entry> load_lexicon(const std::string& path) {
  std::vector<Entry> entries;
  std::ifstream f(path);
  std::string line;
  while (std::getline(f, line)) {
    // strip BOM / CR
    if (line.size() >= 3 && (unsigned char)line[0] == 0xEF) line = line.substr(3);
    while (!line.empty() && (line.back() == '\r' || line.back() == '\n'))
      line.pop_back();
    std::istringstream iss(line);
    std::string word;
    if (!(iss >> word)) continue;
    Entry e;
    e.graphemes = utf8_chars(word);
    std::string ph;
    while (iss >> ph) e.phones.push_back(ph);
    if (e.graphemes.empty() || e.phones.empty()) continue;
    if (e.graphemes.size() > 40 || e.phones.size() > 60) continue;
    entries.push_back(std::move(e));
  }
  return entries;
}

// ---- Alignment (Viterbi-EM over graphones) --------------------------------

struct AlignScorer {
  std::unordered_map<std::string, double> logp;  // graphone -> log prob
  double unk = -12.0;
  double score(const std::string& g, const std::string& p) const {
    auto it = logp.find(gp_key(g, p));
    return it == logp.end() ? unk : it->second;
  }
};

std::string join_chunk(const std::vector<std::string>& v, size_t a, size_t n,
                       const char* sep) {
  std::string out;
  for (size_t k = 0; k < n; ++k) {
    if (k) out += sep;
    out += v[a + k];
  }
  return out;
}

// Viterbi alignment of one entry into graphone tokens.
bool viterbi_align(const Entry& e, const AlignScorer& sc, int max_g,
                   int max_p, std::vector<std::pair<std::string, std::string>>* out) {
  const size_t G = e.graphemes.size(), P = e.phones.size();
  std::vector<std::vector<double>> D(G + 1, std::vector<double>(P + 1, NEG_INF));
  std::vector<std::vector<std::pair<int, int>>> bp(
      G + 1, std::vector<std::pair<int, int>>(P + 1, {0, 0}));
  D[0][0] = 0.0;
  for (size_t i = 0; i <= G; ++i) {
    for (size_t j = 0; j <= P; ++j) {
      if (D[i][j] <= NEG_INF / 2) continue;
      for (int dg = 1; dg <= max_g; ++dg) {
        if (i + dg > G) break;
        for (int dp = 0; dp <= max_p; ++dp) {
          if (j + dp > P) break;
          if (dg == 0 && dp == 0) continue;
          std::string g = join_chunk(e.graphemes, i, dg, "");
          std::string p = join_chunk(e.phones, j, dp, "|");
          double s = D[i][j] + sc.score(g, p) - (dp == 0 ? 2.0 : 0.0);
          if (s > D[i + dg][j + dp]) {
            D[i + dg][j + dp] = s;
            bp[i + dg][j + dp] = {dg, dp};
          }
        }
      }
    }
  }
  if (D[G][P] <= NEG_INF / 2) return false;
  std::vector<std::pair<std::string, std::string>> rev;
  size_t i = G, j = P;
  while (i > 0 || j > 0) {
    auto [dg, dp] = bp[i][j];
    if (dg == 0 && dp == 0) return false;
    rev.push_back({join_chunk(e.graphemes, i - dg, dg, ""),
                   join_chunk(e.phones, j - dp, dp, "|")});
    i -= dg;
    j -= dp;
  }
  out->assign(rev.rbegin(), rev.rend());
  return true;
}

// ---- n-gram training ------------------------------------------------------

int64_t big_key(int h, int w) { return (int64_t)(h + 2) << 32 | (uint32_t)(w + 2); }

std::string tri_key(int h1, int h2) {
  return std::to_string(h1) + ',' + std::to_string(h2);
}

template <typename M>
void normalize_witten_bell(M& counts_map,
                           std::unordered_map<int, double>* out,
                           double total, double types) {
  // Witten-Bell: P(w|h) = c / (N + T), with T/(N+T) mass left for backoff.
  for (auto& kv : counts_map) {
    (*out)[kv.first] = std::log(kv.second / (total + types));
  }
}

Model* train(const std::string& lexicon_path, int max_g, int max_p,
             int em_iters) {
  auto entries = load_lexicon(lexicon_path);
  if (entries.empty()) return nullptr;

  AlignScorer sc;
  // EM (Viterbi variant): align -> count -> re-estimate.
  for (int iter = 0; iter < std::max(1, em_iters); ++iter) {
    std::unordered_map<std::string, double> counts;
    double total = 0;
    for (const auto& e : entries) {
      std::vector<std::pair<std::string, std::string>> al;
      if (!viterbi_align(e, sc, max_g, max_p, &al)) continue;
      for (auto& gp : al) {
        counts[gp_key(gp.first, gp.second)] += 1.0;
        total += 1.0;
      }
    }
    sc.logp.clear();
    for (auto& kv : counts)
      sc.logp[kv.first] = std::log(kv.second / total);
    sc.unk = std::log(0.5 / total);
  }

  auto* m = new Model();
  m->max_g = max_g;
  m->max_p = max_p;

  // final alignments -> graphone inventory + n-gram counts
  const int BOS = -1;
  std::unordered_map<std::string, std::unordered_map<int, double>> tri_c;
  std::unordered_map<int64_t, std::unordered_map<int, double>> big_c;
  std::unordered_map<int, double> uni_c;
  double uni_total = 0;

  for (const auto& e : entries) {
    std::vector<std::pair<std::string, std::string>> al;
    if (!viterbi_align(e, sc, max_g, max_p, &al)) continue;
    std::vector<int> ids;
    for (auto& gp : al) {
      std::string key = gp_key(gp.first, gp.second);
      auto it = m->graphone_id.find(key);
      int id;
      if (it == m->graphone_id.end()) {
        id = (int)m->graphones.size();
        m->graphone_id[key] = id;
        m->graphones.push_back({gp.first, gp.second});
        m->by_grapheme[gp.first].push_back(id);
      } else {
        id = it->second;
      }
      ids.push_back(id);
    }
    const int EOS = -2;
    int h1 = BOS, h2 = BOS;
    for (size_t k = 0; k <= ids.size(); ++k) {
      int w = (k < ids.size()) ? ids[k] : EOS;
      tri_c[tri_key(h1, h2)][w] += 1.0;
      big_c[big_key(h2, 0) + w * 0][w] += 0.0;  // placeholder (filled below)
      h1 = h2;
      h2 = w;
    }
    // bigram/unigram counts
    int h = BOS;
    for (size_t k = 0; k <= ids.size(); ++k) {
      int w = (k < ids.size()) ? ids[k] : EOS;
      big_c[big_key(h, 0)][w] += 1.0;
      uni_c[w] += 1.0;
      uni_total += 1.0;
      h = w;
    }
  }

  for (auto& kv : tri_c) {
    double total = 0;
    for (auto& c : kv.second) total += c.second;
    normalize_witten_bell(kv.second, &m->trigram[kv.first], total,
                          (double)kv.second.size());
  }
  for (auto& kv : big_c) {
    double total = 0;
    for (auto& c : kv.second) total += c.second;
    normalize_witten_bell(kv.second, &m->bigram[kv.first], total,
                          (double)kv.second.size());
  }
  for (auto& kv : uni_c)
    m->unigram[kv.first] = std::log(kv.second / uni_total);
  m->unigram_floor = std::log(0.5 / uni_total);
  return m;
}

double lm_score(const Model& m, int h1, int h2, int w) {
  auto t = m.trigram.find(tri_key(h1, h2));
  if (t != m.trigram.end()) {
    auto it = t->second.find(w);
    if (it != t->second.end()) return it->second;
  }
  auto b = m.bigram.find(big_key(h2, 0));
  double backoff = -1.0;  // approximate backoff penalty
  if (b != m.bigram.end()) {
    auto it = b->second.find(w);
    if (it != b->second.end()) return it->second + backoff;
  }
  auto u = m.unigram.find(w);
  double base = (u != m.unigram.end()) ? u->second : m.unigram_floor;
  return base + 2 * backoff;
}

// ---- Decoding -------------------------------------------------------------

struct Hyp {
  double score;
  int h1, h2;
  int prev_idx;      // index into previous beam
  int graphone;      // graphone consumed to reach this hyp
};

std::string phoneticize(const Model& m, const std::string& word, int beam_size) {
  auto chars = utf8_chars(word);
  const size_t G = chars.size();
  // beams[pos] = hypotheses covering the first `pos` graphemes
  std::vector<std::vector<Hyp>> beams(G + 1);
  beams[0].push_back({0.0, -1, -1, -1, -1});

  for (size_t i = 0; i < G; ++i) {
    if (beams[i].empty()) continue;
    for (int hi = 0; hi < (int)beams[i].size(); ++hi) {
      const Hyp h = beams[i][hi];
      for (int dg = 1; dg <= m.max_g && i + dg <= G; ++dg) {
        std::string g = join_chunk(chars, i, dg, "");
        auto it = m.by_grapheme.find(g);
        if (it == m.by_grapheme.end()) continue;
        for (int gid : it->second) {
          double s = h.score + lm_score(m, h.h1, h.h2, gid);
          beams[i + dg].push_back({s, h.h2, gid, hi, gid});
        }
      }
    }
    // prune next beams
    for (size_t j = i + 1; j <= std::min(G, i + (size_t)m.max_g); ++j) {
      auto& b = beams[j];
      if ((int)b.size() > beam_size) {
        std::partial_sort(b.begin(), b.begin() + beam_size, b.end(),
                          [](const Hyp& a, const Hyp& c) {
                            return a.score > c.score;
                          });
        b.resize(beam_size);
      }
    }
  }

  if (beams[G].empty()) {
    // fallback: per-character unigram-best graphones; unknown chars skipped
    std::string out;
    for (auto& c : chars) {
      auto it = m.by_grapheme.find(c);
      if (it == m.by_grapheme.end()) continue;
      int best = it->second[0];
      double bs = NEG_INF;
      for (int gid : it->second) {
        auto u = m.unigram.find(gid);
        double s = (u != m.unigram.end()) ? u->second : m.unigram_floor;
        if (s > bs) { bs = s; best = gid; }
      }
      const std::string& p = m.graphones[best].p;
      if (p.empty()) continue;
      if (!out.empty()) out += '|';
      out += p;
    }
    return out;
  }

  // pick best final hyp including EOS probability
  int best = -1;
  double best_s = NEG_INF;
  for (int hi = 0; hi < (int)beams[G].size(); ++hi) {
    const Hyp& h = beams[G][hi];
    double s = h.score + lm_score(m, h.h1, h.h2, -2);
    if (s > best_s) { best_s = s; best = hi; }
  }

  // backtrack
  std::vector<int> gids;
  size_t pos = G;
  int idx = best;
  while (pos > 0 && idx >= 0) {
    const Hyp& h = beams[pos][idx];
    if (h.graphone >= 0) {
      gids.push_back(h.graphone);
      pos -= utf8_chars(m.graphones[h.graphone].g).size();
    } else {
      break;
    }
    idx = h.prev_idx;
  }
  std::reverse(gids.begin(), gids.end());

  std::string out;
  for (int gid : gids) {
    const std::string& p = m.graphones[gid].p;
    if (p.empty()) continue;
    if (!out.empty()) out += '|';
    out += p;
  }
  return out;
}

// ---- Serialization (simple text format) -----------------------------------

bool save(const Model& m, const std::string& path) {
  std::ofstream f(path);
  if (!f) return false;
  f << "G2PFST1\n" << m.max_g << ' ' << m.max_p << '\n';
  f << m.graphones.size() << '\n';
  for (auto& gp : m.graphones) f << gp.g << '\t' << gp.p << '\n';
  f << m.unigram.size() << '\n';
  for (auto& kv : m.unigram) f << kv.first << ' ' << kv.second << '\n';
  f << m.unigram_floor << '\n';
  size_t nbig = 0;
  for (auto& kv : m.bigram) nbig += kv.second.size();
  f << nbig << '\n';
  for (auto& kv : m.bigram) {
    int h = (int)(kv.first >> 32) - 2;
    for (auto& c : kv.second) f << h << ' ' << c.first << ' ' << c.second << '\n';
  }
  size_t ntri = 0;
  for (auto& kv : m.trigram) ntri += kv.second.size();
  f << ntri << '\n';
  for (auto& kv : m.trigram) {
    for (auto& c : kv.second)
      f << kv.first << ' ' << c.first << ' ' << c.second << '\n';
  }
  return (bool)f;
}

Model* load(const std::string& path) {
  std::ifstream f(path);
  if (!f) return nullptr;
  std::string magic;
  std::getline(f, magic);
  if (magic != "G2PFST1") return nullptr;
  auto* m = new Model();
  f >> m->max_g >> m->max_p;
  size_t ng;
  f >> ng;
  f.ignore();
  for (size_t i = 0; i < ng; ++i) {
    std::string line;
    std::getline(f, line);
    auto tab = line.find('\t');
    Graphone gp{line.substr(0, tab),
                tab == std::string::npos ? "" : line.substr(tab + 1)};
    m->graphone_id[gp_key(gp.g, gp.p)] = (int)i;
    m->by_grapheme[gp.g].push_back((int)i);
    m->graphones.push_back(std::move(gp));
  }
  size_t nu;
  f >> nu;
  for (size_t i = 0; i < nu; ++i) {
    int w; double s; f >> w >> s;
    m->unigram[w] = s;
  }
  f >> m->unigram_floor;
  size_t nb;
  f >> nb;
  for (size_t i = 0; i < nb; ++i) {
    int h, w; double s; f >> h >> w >> s;
    m->bigram[big_key(h, 0)][w] = s;
  }
  size_t nt;
  f >> nt;
  for (size_t i = 0; i < nt; ++i) {
    std::string ctx; int w; double s; f >> ctx >> w >> s;
    m->trigram[ctx][w] = s;
  }
  return m;
}

}  // namespace

extern "C" {

void* g2p_train(const char* lexicon_path, int max_g, int max_p,
                int em_iters) {
  try {
    return train(lexicon_path, max_g, max_p, em_iters);
  } catch (...) {
    return nullptr;
  }
}

int g2p_save(void* model, const char* path) {
  if (!model) return -1;
  return save(*static_cast<Model*>(model), path) ? 0 : -1;
}

void* g2p_load(const char* path) {
  try {
    return load(path);
  } catch (...) {
    return nullptr;
  }
}

int g2p_phoneticize(void* model, const char* word, int beam, char* out,
                    int out_cap) {
  if (!model || !word || !out || out_cap <= 0) return -1;
  try {
    std::string s = phoneticize(*static_cast<Model*>(model), word,
                                beam > 0 ? beam : 500);
    if ((int)s.size() + 1 > out_cap) return -2;
    std::memcpy(out, s.c_str(), s.size() + 1);
    return (int)s.size();
  } catch (...) {
    return -1;
  }
}

int g2p_num_graphones(void* model) {
  return model ? (int)static_cast<Model*>(model)->graphones.size() : -1;
}

void g2p_free(void* model) {
  delete static_cast<Model*>(model);
}

}  // extern "C"
