r"""PTB-style caption tokenizer, pure Python (replaces the Java subprocess).

Parity target: pycocoevalcap's ``PTBTokenizer`` (imported at
src/evaluation.py:10) — the Stanford CoreNLP 3.4.1 PTBTokenizer run with
``-preserveLines -lowerCase``, followed by dropping the PUNCTUATIONS token
list. This reimplements the Penn-Treebank tokenization rules the Stanford
tokenizer applies to caption-style text:

  - punctuation separation, with the PTB digit guards (commas and colons
    stay inside numbers: ``1,000``, ``5:30``) and ``&`` kept inside tokens
    (``at&t``);
  - contraction splitting (n't 'll 've 're 'm 's 'd) and the PTB
    assimilation list (``cannot`` -> ``can not``, ``gonna`` -> ``gon na``,
    ...);
  - abbreviation periods kept attached (``mr.``, ``u.s.``, single-letter
    initials ``j. k.``) instead of split off;
  - quote normalisation to ``\`\```/``''`` pairs (double) and ``\```/``'``
    (single), bracket normalisation to -LRB-/-RRB- style tokens.

Then lowercases and filters the same punctuation list (note the list is
uppercase, so lowercased ``-lrb-`` tokens deliberately SURVIVE the filter,
matching pycocoevalcap's behavior exactly), so downstream BLEU/METEOR/CIDEr
see the same token streams. Golden-corpus parity: tests/test_eval.py::
test_ptb_golden_corpus (60 hand-checked sentences).
"""

import re

PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"]

_BRACKETS = {"(": "-LRB-", ")": "-RRB-", "{": "-LCB-", "}": "-RCB-",
             "[": "-LSB-", "]": "-RSB-"}

# PTB assimilations (tokenizer.sed "special words" + Stanford's handling):
# written against the raw lowercased word, expanded into two tokens.
_ASSIMILATIONS = {
    "cannot": "can not", "gimme": "gim me", "gonna": "gon na",
    "gotta": "got ta", "lemme": "lem me", "wanna": "wan na",
    "more'n": "more 'n", "'tis": "'t is", "'twas": "'t was",
    "d'ye": "d' ye",
}
_ASSIM_RE = re.compile(
    r"(?i)(?<![\w'])(" + "|".join(re.escape(k) for k in _ASSIMILATIONS)
    + r")(?![\w'])")

# Common abbreviations whose trailing period is part of the token
# (CoreNLP keeps these lexically; this list covers caption-ish text).
_ABBREVS = {
    "mr", "mrs", "ms", "dr", "prof", "rev", "gen", "sen", "rep",
    "jr", "sr", "etc", "e.g", "i.e", "vs", "inc", "ltd", "corp",
    "dept", "univ", "approx", "apt", "ave", "blvd", "rd",
    "oz", "lb", "lbs", "vol", "fig", "jan", "feb", "mar", "apr",
    "jun", "jul", "aug", "sep", "sept", "oct", "nov", "dec", "a.m", "p.m",
}
# Context-dependent abbreviations (CoreNLP keeps the period only in
# context): "no." needs a following number ("No. 5" — "... says no."
# splits); the place/unit words need an adjacent digit or capitalized
# word ("St. Louis", "Mt. Everest", "5 ft.", "Main St.").
_CTX_FOLLOW_DIGIT = {"no"}
_CTX_ADJACENT = {"st", "mt", "ft", "co"}
_PERIOD_HOLD = "\x00"


def _protect_abbrev_periods(s):
    # single-letter initials and acronyms: "j." / "u.s." / "u.s.a."
    prev = None
    while prev != s:
        prev = s
        s = re.sub(r"(?i)(?<![\w.])([a-z])\.", r"\1" + _PERIOD_HOLD, s)
        s = re.sub(r"(?i)(" + _PERIOD_HOLD + r"[a-z])\.",
                   r"\1" + _PERIOD_HOLD, s)

    def abbr(m):
        word = m.group(1)
        w = word.lower().replace(_PERIOD_HOLD, ".")
        if w in _ABBREVS:
            return word + _PERIOD_HOLD
        if w in _CTX_FOLLOW_DIGIT:
            if re.match(r"\s*\d", m.string[m.end():]):
                return word + _PERIOD_HOLD
        elif w in _CTX_ADJACENT:
            before = m.string[:m.start()]
            after = m.string[m.end():]
            if (re.match(r"\s*(\d|[A-Z])", after)
                    or re.search(r"(\d|\b[A-Z][\w%s]*)\s+$" % _PERIOD_HOLD,
                                 before)):
                return word + _PERIOD_HOLD
        return m.group(0)

    return re.sub(r"(?i)(?<![\w.])([a-z][\w" + _PERIOD_HOLD + r"]*)\.",
                  abbr, s)


def ptb_tokenize_sentence(text):
    """Tokenize one sentence into PTB-ish tokens (pre punctuation filter)."""
    s = " " + text.strip() + " "
    s = _ASSIM_RE.sub(lambda m: _ASSIMILATIONS[m.group(1).lower()], s)
    # directional quotes -> PTB backtick/quote pairs
    s = s.replace("“", " `` ").replace("”", " '' ")
    s = re.sub(r'(^|[ \(\[{<])"', r"\1 `` ", s)
    s = s.replace('"', " '' ")
    # opening single quote (not an apostrophe inside a word)
    s = re.sub(r"(^|[ \(\[{<])'(?=[^' ])", r"\1 ` ", s)
    # ellipsis
    s = s.replace("...", " ... ")
    # most punctuation; & stays inside tokens (at&t), comma and colon keep
    # their PTB digit guards (1,000 / 5:30 are single tokens)
    s = re.sub(r"([;@#$%?!])", r" \1 ", s)
    s = re.sub(r"([^0-9]),", r"\1 , ", s)
    s = re.sub(r",([^0-9])", r" , \1", s)
    s = re.sub(r"([^0-9]):", r"\1 : ", s)
    s = re.sub(r":([^0-9])", r" : \1", s)
    # abbreviation periods are protected before period separation
    s = _protect_abbrev_periods(s)
    # final period (and period before closing quote/bracket); the [^.]
    # guard keeps the dots of an already-spaced "..." together
    s = re.sub(r"([^.])(\.)(\s*(?:[\]\)}>\"']*)\s*)$", r"\1 \2\3", s)
    s = re.sub(r"([^.])(\.)(\s)", r"\1 \2\3", s)
    # brackets
    for k, v in _BRACKETS.items():
        s = s.replace(k, " %s " % v)
    s = s.replace("--", " -- ")
    # possessives / contractions
    s = re.sub(r"(?i)([^' ])('s|'m|'d|'ll|'re|'ve)([ .,!?;:])", r"\1 \2\3", s)
    s = re.sub(r"(?i)([^' ])(n't)([ .,!?;:])", r"\1 \2\3", s)
    s = re.sub(r"([^' ])(' )", r"\1 \2", s)
    s = s.replace(_PERIOD_HOLD, ".")
    return s.lower().split()


class PTBTokenizer:
    """Drop-in for pycocoevalcap.tokenizer.ptbtokenizer.PTBTokenizer."""

    def tokenize(self, captions_for_image):
        """{key: [{'caption': str}, ...]} -> {key: [str, ...]} where each
        output string is the space-joined, punctuation-filtered token list."""
        out = {}
        for k, caps in captions_for_image.items():
            out[k] = [
                " ".join(w for w in ptb_tokenize_sentence(c["caption"])
                         if w not in PUNCTUATIONS)
                for c in caps
            ]
        return out
