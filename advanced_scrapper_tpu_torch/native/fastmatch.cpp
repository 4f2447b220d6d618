// fastmatch: host-side exact verification kernels behind the device match
// screen.  A copy of the JAX package's native/fastmatch.cpp: the port builds
// and loads its own (cpu/native.py), never the reference's source or library.
//
// The reference leans on rapidfuzz (a C++ pip extension) for
// fuzz.partial_ratio (match_keywords.py:4,175-176).  This library provides
// the same semantics natively (dependency-free for deployment), with exact
// score parity CI-fuzzed against the installed rapidfuzz 3.x
// (tests/test_rapidfuzz_parity.py; `cpu/fuzz.py` is the pure-Python twin):
//
//   ratio(s1, s2)        = 100 * (1 - indel_dist / (|s1|+|s2|))
//                          with indel_dist = |s1|+|s2| - 2*LCS
//   partial_ratio(s1,s2) = max over sliding windows of the shorter string's
//                          length across the longer (including overhanging
//                          partial windows at both ends), with two
//                          rapidfuzz-3.x rules: an empty needle scores 0
//                          against non-empty text (100 only empty-vs-empty),
//                          and equal-length inputs are scanned in BOTH
//                          orientations (max taken) — see
//                          fuzz_py.partial_ratio_alignment in rapidfuzz.
//
// rapidfuzz scores UNICODE CODE POINTS, not bytes; the `_u32` entry points
// take UTF-32 sequences and match it exactly on non-ASCII text (curly
// quotes, accents, CJK).  The byte entry points remain for pure-ASCII
// fast paths and raw-bytes callers (identical results on ASCII).
//
// LCS length uses the Crochemore/Hyyrö bit-parallel recurrence
//   V = (V + (V & M)) | (V & ~M)
// over 64-bit words (multi-word with carry for patterns > 64 units);
// LCS = zero bits of V within the pattern length.  Complexity per call:
// O(windows * |window| * ceil(m/64)) — microseconds for typical entity
// names against full articles.
//
// Build: g++ -O3 -shared -fPIC fastmatch.cpp -o libfastmatch.so
// (driven automatically by cpu/native.py, into build/host/)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

// Pattern match-mask table over a 256-entry direct-indexed byte alphabet.
struct ByteMasks {
  int m;
  int words;
  std::vector<uint64_t> table;  // 256 x words

  explicit ByteMasks(const uint8_t* p, int len) : m(len), words((len + 63) / 64) {
    table.assign(256 * (size_t)words, 0);
    for (int i = 0; i < len; ++i) {
      table[(size_t)p[i] * words + (i >> 6)] |= 1ULL << (i & 63);
    }
  }

  const uint64_t* masks_for(uint8_t c) const { return &table[(size_t)c * words]; }
};

// Pattern match-mask table over the pattern's own (sorted, deduped)
// codepoint alphabet; haystack chars resolve by binary search, misses map
// to an all-zero mask.
struct CodepointMasks {
  int m;
  int words;
  std::vector<uint32_t> alpha;
  std::vector<uint64_t> table;  // alpha.size() x words
  std::vector<uint64_t> zero;   // words zeros

  explicit CodepointMasks(const uint32_t* p, int len)
      : m(len), words((len + 63) / 64) {
    alpha.assign(p, p + len);
    std::sort(alpha.begin(), alpha.end());
    alpha.erase(std::unique(alpha.begin(), alpha.end()), alpha.end());
    table.assign(alpha.size() * (size_t)words, 0);
    zero.assign(words, 0);
    for (int i = 0; i < len; ++i) {
      const size_t idx =
          std::lower_bound(alpha.begin(), alpha.end(), p[i]) - alpha.begin();
      table[idx * words + (i >> 6)] |= 1ULL << (i & 63);
    }
  }

  const uint64_t* masks_for(uint32_t c) const {
    auto it = std::lower_bound(alpha.begin(), alpha.end(), c);
    if (it == alpha.end() || *it != c) return zero.data();
    return &table[(size_t)(it - alpha.begin()) * words];
  }
};

// LCS length of the pattern (via masks) against text[0..tlen)
template <typename Masks, typename CharT>
int lcs_len(const Masks& pm, const CharT* text, int tlen) {
  const int words = pm.words;
  uint64_t vbuf[8];
  std::vector<uint64_t> vheap;
  uint64_t* V = vbuf;
  if (words > 8) {
    vheap.assign(words, ~0ULL);
    V = vheap.data();
  } else {
    for (int w = 0; w < words; ++w) vbuf[w] = ~0ULL;
  }
  for (int j = 0; j < tlen; ++j) {
    const uint64_t* M = pm.masks_for(text[j]);
    uint64_t carry = 0;
    for (int w = 0; w < words; ++w) {
      const uint64_t u = V[w] & M[w];
      const uint64_t sum = V[w] + u + carry;
      carry = (sum < V[w] || (carry && sum == V[w])) ? 1 : 0;
      V[w] = sum | (V[w] & ~M[w]);
    }
  }
  // LCS = zero bits within the first m positions
  int zeros = 0;
  for (int w = 0; w < words; ++w) {
    uint64_t mask = ~0ULL;
    const int remaining = pm.m - (w << 6);
    if (remaining < 64) mask = (remaining <= 0) ? 0 : ((1ULL << remaining) - 1);
    zeros += __builtin_popcountll(~V[w] & mask);
  }
  return zeros;
}

inline double indel_ratio(int m, int w, int lcs) {
  const int total = m + w;
  if (total == 0) return 100.0;
  return 200.0 * (double)lcs / (double)total;
}

// Max ratio of `needle` vs the length-m sliding windows of `haystack`
// (clipped at both edges).
template <typename Masks, typename CharT>
double scan_windows(const CharT* needle, int m, const CharT* haystack, int n) {
  Masks pm(needle, m);
  double best = 0.0;
  for (int start = -(m - 1); start < n; ++start) {
    const int lo = start > 0 ? start : 0;
    const int hi = (start + m) < n ? (start + m) : n;
    if (hi <= lo) continue;
    const int lcs = lcs_len(pm, haystack + lo, hi - lo);
    const double sc = indel_ratio(m, hi - lo, lcs);
    if (sc > best) {
      best = sc;
      if (best >= 100.0) break;
    }
  }
  return best;
}

// Sliding character-multiset intersection — an O(1)-per-position upper
// bound on the LCS of the needle vs each window (LCS ⊆ common multiset).
// Windows whose bound cannot reach `cutoff` skip the bit-parallel LCS
// entirely; with cutoff 95 and entity-name needles against article text,
// virtually every window is skipped, so the scan is O(n) counter updates
// plus rare exact rescores.  Exactness: a skipped window's true score ≤
// its bound < cutoff, and rapidfuzz score_cutoff semantics return 0 for
// results below cutoff anyway, so the returned value is identical to the
// full scan followed by thresholding (fuzzed in
// tests/test_rapidfuzz_parity.py).
//
// Counting alphabet: the byte path indexes a 256 table directly; the
// UTF-32 path maps haystack chars through the needle's sorted alphabet
// (misses contribute nothing — they can never be common).
struct ByteCounter {
  int counts[256];
  explicit ByteCounter(const uint8_t* p, int m) {
    std::memset(counts, 0, sizeof(counts));
    for (int i = 0; i < m; ++i) counts[p[i]]++;
  }
  static int index_of(const ByteCounter&, uint8_t c) { return c; }
  int size() const { return 256; }
};

struct CodepointCounter {
  std::vector<uint32_t> alpha;
  std::vector<int> counts;
  explicit CodepointCounter(const uint32_t* p, int m) {
    alpha.assign(p, p + m);
    std::sort(alpha.begin(), alpha.end());
    alpha.erase(std::unique(alpha.begin(), alpha.end()), alpha.end());
    counts.assign(alpha.size(), 0);
    for (int i = 0; i < m; ++i) {
      counts[std::lower_bound(alpha.begin(), alpha.end(), p[i]) -
             alpha.begin()]++;
    }
  }
  static int index_of(const CodepointCounter& nc, uint32_t c) {
    auto it = std::lower_bound(nc.alpha.begin(), nc.alpha.end(), c);
    if (it == nc.alpha.end() || *it != c) return -1;
    return (int)(it - nc.alpha.begin());
  }
  int size() const { return (int)alpha.size(); }
};

template <typename Masks, typename Counter, typename CharT>
double scan_windows_cutoff(const CharT* needle, int m, const CharT* haystack,
                           int n, double cutoff) {
  // Masks (the 2 KB bit-parallel table) builds lazily at the FIRST window
  // that survives the bound — the common all-pruned path pays only the
  // counter scan.  The counter's own needle alphabet is ≤ m entries, a
  // trivial build next to the masks table.
  std::unique_ptr<Masks> pm;
  const Counter nc(needle, m);
  std::vector<int> wcounts(nc.size(), 0);
  int inter = 0;  // Σ_c min(window_count[c], needle_count[c])
  auto add = [&](CharT ch) {
    const int idx = Counter::index_of(nc, ch);
    if (idx < 0) return;
    if (wcounts[idx] < nc.counts[idx]) ++inter;
    ++wcounts[idx];
  };
  auto del = [&](CharT ch) {
    const int idx = Counter::index_of(nc, ch);
    if (idx < 0) return;
    --wcounts[idx];
    if (wcounts[idx] < nc.counts[idx]) --inter;
  };
  double best = 0.0;
  int cur_lo = 0, cur_hi = 0;  // current counted window [cur_lo, cur_hi)
  for (int start = -(m - 1); start < n; ++start) {
    const int lo = start > 0 ? start : 0;
    const int hi = (start + m) < n ? (start + m) : n;
    if (hi <= lo) continue;
    while (cur_hi < hi) add(haystack[cur_hi++]);
    while (cur_lo < lo) del(haystack[cur_lo++]);
    const double ub = indel_ratio(m, hi - lo, inter);
    if (ub < cutoff || ub <= best) continue;  // cannot reach cutoff / improve
    if (!pm) pm.reset(new Masks(needle, m));
    const int lcs = lcs_len(*pm, haystack + lo, hi - lo);
    const double sc = indel_ratio(m, hi - lo, lcs);
    if (sc > best) {
      best = sc;
      if (best >= 100.0) break;
    }
  }
  return best >= cutoff ? best : 0.0;
}

template <typename Masks, typename Counter, typename CharT>
double partial_ratio_cutoff_impl(const CharT* s1, int len1, const CharT* s2,
                                 int len2, double cutoff) {
  const CharT* shorter = s1;
  const CharT* longer = s2;
  int m = len1, n = len2;
  if (len1 > len2) {
    shorter = s2; longer = s1; m = len2; n = len1;
  }
  if (m == 0) {
    const double sc = (n == 0) ? 100.0 : 0.0;
    return sc >= cutoff ? sc : 0.0;
  }
  double best = scan_windows_cutoff<Masks, Counter>(shorter, m, longer, n, cutoff);
  if (best < 100.0 && m == n) {
    const double rev =
        scan_windows_cutoff<Masks, Counter>(longer, n, shorter, m, cutoff);
    if (rev > best) best = rev;
  }
  return best;
}

template <typename Masks, typename CharT>
double ratio_impl(const CharT* s1, int len1, const CharT* s2, int len2) {
  if (len1 + len2 == 0) return 100.0;
  if (len1 == 0 || len2 == 0) return 0.0;
  Masks pm(s1, len1);
  const int lcs = lcs_len(pm, s2, len2);
  return indel_ratio(len1, len2, lcs);
}

// rapidfuzz 3.x partial_ratio semantics (see header comment).
template <typename Masks, typename CharT>
double partial_ratio_impl(const CharT* s1, int len1, const CharT* s2, int len2) {
  const CharT* shorter = s1;
  const CharT* longer = s2;
  int m = len1, n = len2;
  if (len1 > len2) {
    shorter = s2; longer = s1; m = len2; n = len1;
  }
  if (m == 0) return n == 0 ? 100.0 : 0.0;
  double best = scan_windows<Masks>(shorter, m, longer, n);
  if (best < 100.0 && m == n) {
    // equal lengths: rapidfuzz scans both orientations and takes the max
    const double rev = scan_windows<Masks>(longer, n, shorter, m);
    if (rev > best) best = rev;
  }
  return best;
}

}  // namespace

extern "C" {

// Normalised indel similarity in [0, 100] over bytes.
double fm_ratio(const uint8_t* s1, int len1, const uint8_t* s2, int len2) {
  return ratio_impl<ByteMasks>(s1, len1, s2, len2);
}

// Normalised indel similarity over UTF-32 code points (lengths in units).
double fm_ratio_u32(const uint32_t* s1, int len1, const uint32_t* s2, int len2) {
  return ratio_impl<CodepointMasks>(s1, len1, s2, len2);
}

// partial_ratio over bytes (exact rapidfuzz parity for pure-ASCII input).
double fm_partial_ratio(const uint8_t* s1, int len1, const uint8_t* s2, int len2) {
  return partial_ratio_impl<ByteMasks>(s1, len1, s2, len2);
}

// partial_ratio over UTF-32 code points — exact rapidfuzz parity on any text.
double fm_partial_ratio_u32(
    const uint32_t* s1, int len1, const uint32_t* s2, int len2) {
  return partial_ratio_impl<CodepointMasks>(s1, len1, s2, len2);
}

// partial_ratio with rapidfuzz score_cutoff semantics: exact score when it
// reaches `cutoff`, else 0.0.  The multiset upper bound skips nearly every
// window at high cutoffs (the matcher's >95 verify), ~10-50× the full scan.
double fm_partial_ratio_cutoff(const uint8_t* s1, int len1, const uint8_t* s2,
                               int len2, double cutoff) {
  return partial_ratio_cutoff_impl<ByteMasks, ByteCounter>(
      s1, len1, s2, len2, cutoff);
}

double fm_partial_ratio_cutoff_u32(const uint32_t* s1, int len1,
                                   const uint32_t* s2, int len2,
                                   double cutoff) {
  return partial_ratio_cutoff_impl<CodepointMasks, CodepointCounter>(
      s1, len1, s2, len2, cutoff);
}

// Batch: one needle against many haystacks (offsets into a byte arena).
// Scores must point at n doubles.
void fm_partial_ratio_batch(
    const uint8_t* needle, int needle_len,
    const uint8_t* arena, const int64_t* offsets, const int32_t* lengths,
    int n, double* scores) {
  for (int i = 0; i < n; ++i) {
    scores[i] = fm_partial_ratio(needle, needle_len, arena + offsets[i], lengths[i]);
  }
}

// Batch with score_cutoff: ONE haystack (an article/title) against a
// PERSISTENT packed needle arena (entity names, built once per index) with
// a per-call int32 row selection — the matcher's verify shape.  One call
// replaces a ctypes round trip (plus a fresh haystack encode) per name;
// each pair scores exactly like fm_partial_ratio_cutoff (the impl's
// shorter/longer swap makes argument order irrelevant).  scores[i]
// corresponds to select[i] and must point at n_select doubles.
void fm_partial_ratio_cutoff_select(
    const uint8_t* hay, int hay_len,
    const uint8_t* arena, const int64_t* offsets, const int32_t* lengths,
    const int32_t* select, int n_select, double cutoff, double* scores) {
  for (int i = 0; i < n_select; ++i) {
    const int r = select[i];
    scores[i] = fm_partial_ratio_cutoff(arena + offsets[r], lengths[r],
                                        hay, hay_len, cutoff);
  }
}

}  // extern "C"

// -- multi-pattern matcher core (Aho-Corasick over bytes) --------------------
//
// One automaton scan finds EVERY occurrence of EVERY pattern in a single
// pass over the text — the host-side successor of the matcher's per-name
// `re.finditer` loops (match_keywords.py:165-173 reroute), where each
// ALL-CAPS entity name used to re-scan the whole article.  Word-boundary
// (\b) filtering and per-name non-overlap stay on the Python side, where
// the regex semantics live; this core only enumerates raw (pattern, start)
// hits.  Classic goto/fail/output construction over the byte alphabet with
// sparse per-node edges (entity sets are small; scan cost is a couple of
// array/loop steps per text byte).

namespace {

struct AcNode {
  // sorted sparse edges: byte -> node index
  std::vector<std::pair<uint8_t, int32_t>> next;
  int32_t fail = 0;
  int32_t out_link = -1;   // nearest suffix node that ends a pattern
  int32_t pattern = -1;    // pattern id ending here (-1 = none)

  int32_t find(uint8_t c) const {
    for (const auto& e : next)
      if (e.first == c) return e.second;
    return -1;
  }
};

struct AcAutomaton {
  std::vector<AcNode> nodes;
  std::vector<int32_t> pat_len;
};

}  // namespace

extern "C" {

// Build an automaton over n patterns (pattern i = blob[offsets[i],
// offsets[i+1])).  Empty patterns are skipped (they can never match).
void* fm_ac_build(const uint8_t* blob, const int64_t* offsets, long n) {
  auto* ac = new (std::nothrow) AcAutomaton();
  if (!ac) return nullptr;
  ac->nodes.emplace_back();  // root
  ac->pat_len.assign(n, 0);
  for (long i = 0; i < n; ++i) {
    const int64_t len = offsets[i + 1] - offsets[i];
    ac->pat_len[i] = static_cast<int32_t>(len);
    if (len <= 0) continue;
    int32_t cur = 0;
    for (int64_t k = 0; k < len; ++k) {
      const uint8_t c = blob[offsets[i] + k];
      int32_t nxt = ac->nodes[cur].find(c);
      if (nxt < 0) {
        nxt = static_cast<int32_t>(ac->nodes.size());
        ac->nodes.emplace_back();
        ac->nodes[cur].next.emplace_back(c, nxt);
      }
      cur = nxt;
    }
    if (ac->nodes[cur].pattern < 0) ac->nodes[cur].pattern =
        static_cast<int32_t>(i);
    // duplicate pattern strings: first id wins; Python dedups names first
  }
  // BFS fail links
  std::vector<int32_t> queue;
  for (const auto& e : ac->nodes[0].next) {
    ac->nodes[e.second].fail = 0;
    queue.push_back(e.second);
  }
  for (size_t qi = 0; qi < queue.size(); ++qi) {
    const int32_t u = queue[qi];
    for (const auto& e : ac->nodes[u].next) {
      const uint8_t c = e.first;
      const int32_t v = e.second;
      int32_t f = ac->nodes[u].fail;
      int32_t t;
      while ((t = ac->nodes[f].find(c)) < 0 && f != 0) f = ac->nodes[f].fail;
      ac->nodes[v].fail = t >= 0 && t != v ? t : 0;
      const int32_t fv = ac->nodes[v].fail;
      ac->nodes[v].out_link =
          ac->nodes[fv].pattern >= 0 ? fv : ac->nodes[fv].out_link;
      queue.push_back(v);
    }
  }
  return ac;
}

void fm_ac_destroy(void* h) { delete static_cast<AcAutomaton*>(h); }

// Scan text, emitting (pattern id, start offset) for every occurrence of
// every pattern.  Returns the TOTAL number of occurrences; only the first
// `cap` are written to out_ids/out_starts (callers grow and re-scan when
// the return value exceeds cap).  Hits are emitted in end-position order,
// so per-pattern start offsets arrive ascending — what the finditer
// non-overlap replay on the Python side needs.
long fm_ac_scan(void* h, const uint8_t* text, long len, int32_t* out_ids,
                int64_t* out_starts, long cap) {
  const auto* ac = static_cast<const AcAutomaton*>(h);
  long hits = 0;
  int32_t cur = 0;
  for (long pos = 0; pos < len; ++pos) {
    const uint8_t c = text[pos];
    int32_t t;
    while ((t = ac->nodes[cur].find(c)) < 0 && cur != 0)
      cur = ac->nodes[cur].fail;
    cur = t >= 0 ? t : 0;
    for (int32_t o = cur; o >= 0; o = ac->nodes[o].out_link) {
      const int32_t pid = ac->nodes[o].pattern;
      if (pid >= 0) {
        if (hits < cap) {
          out_ids[hits] = pid;
          out_starts[hits] = pos + 1 - ac->pat_len[pid];
        }
        hits++;
      }
    }
  }
  return hits;
}

}  // extern "C"
