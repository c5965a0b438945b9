"""METEOR scorer, pure Python (replaces the meteor-1.5.jar Java subprocess).

Parity target: pycocoevalcap's ``Meteor`` (src/evaluation.py:12), i.e.
METEOR 1.5 for English with ``-norm``: staged matchers (exact 1.0,
stem 0.6, synonym 0.8, paraphrase 0.6), content/function word weighting
(delta), harmonic mean (alpha) and fragmentation penalty (gamma, beta), with
corpus-level scores computed from **aggregated sufficient statistics** over
segments (not averaged per-segment scores), each segment scored against its
best reference.

Alignment follows the jar's Aligner: all candidate matches from every stage
(the paraphrase stage matches multiword phrases) are resolved by a beam
search over one-to-one span alignments that prefers, lexicographically,
(1) the most covered words, (2) the fewest chunks, (3) the smallest total
start-position distance — the jar's comparison order, with its beam width.

Data: the jar ships WordNet-derived synonyms and a paraphrase table; this
image has neither WordNet corpora nor the jar, so compact English
synonym/paraphrase tables are shipped in ``eval/data/`` and loaded by
default. For full parity with the jar, point ``synonym_file`` /
``paraphrase_file`` at complete tables (or install NLTK WordNet corpora,
which the synonym stage then uses automatically). A loud warning is issued
whenever a matcher stage ends up inert.

Deviation (documented per SURVEY.md §7 hard-part #3): the stem stage uses
NLTK's Snowball English stemmer (same algorithm family as the jar's
Snowball stemmer).
"""

import os
import warnings
from collections import defaultdict

# METEOR 1.5 English defaults (task: rank; Denkowski & Lavie 2011 Table 1)
ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
STAGE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)  # exact, stem, syn, para
BEAM_WIDTH = 40          # the jar Aligner's beam size
MAX_PHRASE_LEN = 4       # longest phrase considered by the paraphrase stage

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DEFAULT_SYNONYMS = os.path.join(DATA_DIR, "meteor_synonyms_en.txt")
DEFAULT_PARAPHRASES = os.path.join(DATA_DIR, "meteor_paraphrase_en.txt")
_DEFAULT = object()
_warned_compact_table = False

# METEOR-style English function-word list (common closed-class words)
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no such own same other
another all both few many much more most several
i you he she it we they me him her us them my your his its our their mine
yours hers ours theirs myself yourself himself herself itself ourselves
themselves who whom whose which what
and or but nor so yet for because although though while if unless until
when whenever where wherever after before since as than whether
in on at by with from to of about against between into through during
without within along across behind beyond plus except up down off above
below over under again further once near
is am are was were be been being do does did doing have has had having
will would shall should may might must can could ought
not n't only very too also just there here then now
""".split())


def _snowball():
    try:
        from nltk.stem.snowball import SnowballStemmer
        return SnowballStemmer("english").stem
    except Exception:  # pragma: no cover - nltk is baked into the image
        return lambda w: w


def _wordnet_synsets():
    try:
        from nltk.corpus import wordnet
        wordnet.synsets("test")  # raises LookupError without corpus data
        return wordnet
    except Exception:
        return None


def _load_synonym_table(path):
    """One synonym group per line ('w1 w2 ...'), or 'w ||| s' pairs."""
    table = defaultdict(set)
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.split("#", 1)[0].strip().lower()
            if not line:
                continue
            parts = (line.split(" ||| ") if " ||| " in line
                     else line.split())
            for a in parts:
                for b in parts:
                    if a != b:
                        table[a].add(b)
    return table


def _load_paraphrase_table(path):
    """'phrase ||| phrase' per line (symmetric; phrases may be multiword)."""
    table = defaultdict(set)
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.split("#", 1)[0].strip().lower()
            parts = line.split(" ||| ")
            if len(parts) >= 2:
                for a in parts:
                    for b in parts:
                        if a != b:
                            table[a].add(b)
    return table


class Meteor:
    def __init__(self, paraphrase_file=_DEFAULT, synonym_file=_DEFAULT,
                 warn=True):
        """``synonym_file``: flat synonym table path, or None to disable the
        stage; by default the shipped compact table is used unless NLTK
        WordNet corpora are installed (preferred). ``paraphrase_file``:
        paraphrase table path ('phrase ||| phrase' per line), or None to
        disable; defaults to the shipped compact table."""
        self._stem = _snowball()
        self._wordnet = None
        self._synonym_table = None
        if synonym_file is _DEFAULT:
            self._wordnet = _wordnet_synsets()
            if self._wordnet is None and os.path.exists(DEFAULT_SYNONYMS):
                self._synonym_table = _load_synonym_table(DEFAULT_SYNONYMS)
        elif synonym_file:
            self._synonym_table = _load_synonym_table(synonym_file)

        self._paraphrases = None
        if paraphrase_file is _DEFAULT:
            if os.path.exists(DEFAULT_PARAPHRASES):
                self._paraphrases = _load_paraphrase_table(DEFAULT_PARAPHRASES)
        elif paraphrase_file:
            self._paraphrases = _load_paraphrase_table(paraphrase_file)

        self._max_para_len = 1
        if self._paraphrases:
            self._max_para_len = min(
                MAX_PHRASE_LEN,
                max(p.count(" ") + 1 for p in self._paraphrases))

        if warn:
            if self._wordnet is None and not self._synonym_table:
                warnings.warn(
                    "METEOR synonym stage is INERT (no WordNet corpora and "
                    "no synonym table): scores will run systematically low "
                    "vs the meteor-1.5 jar. Pass synonym_file= or install "
                    "NLTK WordNet data.", stacklevel=2)
            elif self._wordnet is None and self._synonym_table is not None \
                    and synonym_file is _DEFAULT:
                global _warned_compact_table
                if not _warned_compact_table:  # once per process, not per call
                    _warned_compact_table = True
                    warnings.warn(
                        "METEOR synonym stage is using the shipped compact "
                        "synonym table (NLTK WordNet corpora not installed); "
                        "scores approximate but do not exactly match the "
                        "meteor-1.5 jar's WordNet stage.", stacklevel=2)
            if not self._paraphrases:
                warnings.warn(
                    "METEOR paraphrase stage is INERT (no paraphrase "
                    "table): scores will run low vs the meteor-1.5 jar.",
                    stacklevel=2)

    # -- matchers ----------------------------------------------------------

    def _synonyms(self, word):
        if self._synonym_table is not None:
            return self._synonym_table.get(word, set())
        if self._wordnet is None:
            return set()
        syns = set()
        for synset in self._wordnet.synsets(word):
            for lemma in synset.lemmas():
                syns.add(lemma.name().replace("_", " ").lower())
        return syns

    def _candidates(self, hyp, ref):
        """All candidate matches as (h_start, h_len, r_start, r_len, stage).
        Word stages (exact/stem/synonym) record only the earliest matching
        stage per pair; the paraphrase stage adds span matches."""
        cands = []
        stems_h = [self._stem(w) for w in hyp]
        stems_r = [self._stem(w) for w in ref]
        has_syn = self._wordnet is not None or self._synonym_table is not None
        for i, hw in enumerate(hyp):
            syn_h = self._synonyms(hw) if has_syn else None
            for j, rw in enumerate(ref):
                if hw == rw:
                    cands.append((i, 1, j, 1, 0))
                elif stems_h[i] == stems_r[j]:
                    cands.append((i, 1, j, 1, 1))
                elif has_syn and (rw in syn_h or hw in self._synonyms(rw)):
                    cands.append((i, 1, j, 1, 2))
        if self._paraphrases:
            L = self._max_para_len
            ref_spans = {}
            for j in range(len(ref)):
                for m in range(1, min(L, len(ref) - j) + 1):
                    ref_spans.setdefault(" ".join(ref[j:j + m]),
                                         []).append((j, m))
            for i in range(len(hyp)):
                for n in range(1, min(L, len(hyp) - i) + 1):
                    phrase = " ".join(hyp[i:i + n])
                    for para in self._paraphrases.get(phrase, ()):
                        for (j, m) in ref_spans.get(para, ()):
                            if not (n == 1 and m == 1 and any(
                                    c[0] == i and c[2] == j and c[4] < 3
                                    for c in cands)):
                                cands.append((i, n, j, m, 3))
        return cands

    @staticmethod
    def _resolve(cands, rn=64, beam=BEAM_WIDTH):
        """The jar Aligner's resolution: beam search over one-to-one span
        alignments, preferring (more covered words, fewer chunks, smaller
        total |h_start - r_start|). Returns the winning match list.

        Uses the C++ core (native/kmbart_native.cpp meteor_resolve) when
        built and the reference fits its 63-word coverage mask; the Python
        loop below has identical semantics (parity-tested)."""
        if cands:
            from kmbart_tpu_torch import _native
            if _native.available() and rn <= 63:
                idx = _native.meteor_resolve(cands, rn, beam)
                if idx is not None:
                    return [cands[k] for k in idx]
        by_start = defaultdict(list)
        max_h = 0
        for c in cands:
            by_start[c[0]].append(c)
            max_h = max(max_h, c[0] + c[1])
        # state: (covered, chunks, dist, h_pos, r_mask, h_end, r_end, matches)
        states = [(0, 0, 0, 0, 0, -1, -1, ())]
        for pos in range(max_h):
            nxt = []
            for st in states:
                covered, chunks, dist, h_pos, r_mask, h_end, r_end, ms = st
                if h_pos > pos:
                    nxt.append(st)
                    continue
                nxt.append((covered, chunks, dist, pos + 1, r_mask,
                            h_end, r_end, ms))
                for c in by_start.get(pos, ()):
                    i, n, j, m, stage = c
                    span_mask = ((1 << m) - 1) << j
                    if r_mask & span_mask:
                        continue
                    cont = (i == h_end and j == r_end)
                    nxt.append((covered + n + m,
                                chunks + (0 if cont else 1),
                                dist + abs(i - j),
                                i + n, r_mask | span_mask,
                                i + n, j + m, ms + (c,)))
            nxt.sort(key=lambda s: (-s[0], s[1], s[2]))
            # drop duplicate (r_mask, h_pos) keeping the best-ranked
            seen, states = set(), []
            for s in nxt:
                key = (s[3], s[4], s[5], s[6])
                if key in seen:
                    continue
                seen.add(key)
                states.append(s)
                if len(states) >= beam:
                    break
        return list(states[0][7]) if states else []

    def _align(self, hyp, ref):
        """Returns list of (h_start, h_len, r_start, r_len, stage)."""
        if not hyp or not ref:
            return []
        return self._resolve(self._candidates(hyp, ref), rn=len(ref))

    @staticmethod
    def _chunks(matches):
        """Chunks: runs of matches contiguous in both hyp and ref."""
        if not matches:
            return 0
        matches = sorted(matches)
        ch = 1
        for a, b in zip(matches, matches[1:]):
            if not (b[0] == a[0] + a[1] and b[2] == a[2] + a[3]):
                ch += 1
        return ch

    # -- statistics ---------------------------------------------------------

    def _segment_stats(self, hyp_words, ref_words):
        matches = self._align(hyp_words, ref_words)

        def split_counts(words, idx):
            content = sum(1 for i in idx if words[i] not in FUNCTION_WORDS)
            return content, len(idx) - content

        total_h = sum(m[1] for m in matches)
        total_r = sum(m[3] for m in matches)
        stats = {
            "hyp_len_c": sum(1 for w in hyp_words if w not in FUNCTION_WORDS),
            "hyp_len_f": sum(1 for w in hyp_words if w in FUNCTION_WORDS),
            "ref_len_c": sum(1 for w in ref_words if w not in FUNCTION_WORDS),
            "ref_len_f": sum(1 for w in ref_words if w in FUNCTION_WORDS),
            "chunks": self._chunks(matches),
            "match_total_h": total_h,
            "match_total_r": total_r,
        }
        for s in range(4):
            idx_h = [i for m in matches if m[4] == s
                     for i in range(m[0], m[0] + m[1])]
            idx_r = [j for m in matches if m[4] == s
                     for j in range(m[2], m[2] + m[3])]
            c_h, f_h = split_counts(hyp_words, idx_h)
            c_r, f_r = split_counts(ref_words, idx_r)
            stats[f"m{s}_hc"], stats[f"m{s}_hf"] = c_h, f_h
            stats[f"m{s}_rc"], stats[f"m{s}_rf"] = c_r, f_r
        return stats

    @staticmethod
    def _score_from_stats(st):
        w = STAGE_WEIGHTS
        wp = sum(w[s] * (DELTA * st[f"m{s}_hc"] + (1 - DELTA) * st[f"m{s}_hf"])
                 for s in range(4))
        wr = sum(w[s] * (DELTA * st[f"m{s}_rc"] + (1 - DELTA) * st[f"m{s}_rf"])
                 for s in range(4))
        denom_p = DELTA * st["hyp_len_c"] + (1 - DELTA) * st["hyp_len_f"]
        denom_r = DELTA * st["ref_len_c"] + (1 - DELTA) * st["ref_len_f"]
        if denom_p == 0 or denom_r == 0:
            return 0.0
        P, R = wp / denom_p, wr / denom_r
        if P == 0 or R == 0:
            return 0.0
        fmean = P * R / (ALPHA * P + (1 - ALPHA) * R)
        m_avg = 0.5 * (st["match_total_h"] + st["match_total_r"])
        frag = st["chunks"] / m_avg if m_avg > 0 else 0.0
        if st["chunks"] == 1 and st["match_total_h"] == st["hyp_len_c"] + st["hyp_len_f"] \
                and st["match_total_r"] == st["ref_len_c"] + st["ref_len_f"]:
            frag = 0.0  # meteor: single chunk covering everything -> no penalty
        pen = GAMMA * (frag ** BETA) if frag > 0 else 0.0
        return (1.0 - pen) * fmean

    def score_segment(self, hypothesis, references):
        """Best-reference segment score + its stats."""
        hyp_words = hypothesis.lower().split()
        best, best_stats = 0.0, None
        for ref in references:
            st = self._segment_stats(hyp_words, ref.lower().split())
            sc = self._score_from_stats(st)
            if best_stats is None or sc > best:
                best, best_stats = sc, st
        return best, best_stats

    def compute_score(self, gts, res):
        """pycocoevalcap interface: aggregate stats over segments, final
        score from the sums (the jar's 'EVAL ||| stats' protocol)."""
        keys = sorted(gts.keys(), key=str)
        agg = defaultdict(float)
        scores = []
        for k in keys:
            sc, st = self.score_segment(res[k][0], gts[k])
            scores.append(sc)
            for name, v in st.items():
                agg[name] += v
        final = self._score_from_stats(agg) if keys else 0.0
        return final, scores
