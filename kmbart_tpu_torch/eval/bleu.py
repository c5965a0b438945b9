"""Corpus BLEU with coco-caption semantics.

Parity target: pycocoevalcap's ``Bleu``/``BleuScorer`` (src/evaluation.py:11):
clipped n-gram precision against max reference counts, "closest" effective
reference length (ties broken toward the shorter), corpus-level aggregation
of numerators/denominators with the tiny/small epsilons, and the
``exp(1 - 1/ratio)`` brevity penalty applied to every order.
"""

from collections import defaultdict


def _ngram_counts(words, n):
    counts = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


def _cook_refs(refs, n):
    reflens = [len(r.split()) for r in refs]
    maxcounts = {}
    for ref in refs:
        for ngram, count in _ngram_counts(ref.split(), n).items():
            maxcounts[ngram] = max(maxcounts.get(ngram, 0), count)
    return reflens, maxcounts


def _cook_test(test, reflens, maxcounts, n, eff="closest"):
    words = test.split()
    testlen = len(words)
    if eff == "closest":
        reflen = min((abs(l - testlen), l) for l in reflens)[1]
    elif eff == "shortest":
        reflen = min(reflens)
    else:  # average
        reflen = float(sum(reflens)) / len(reflens)
    guess = [max(0, testlen - k + 1) for k in range(1, n + 1)]
    correct = [0] * n
    counts = _ngram_counts(words, n)
    for ngram, count in counts.items():
        correct[len(ngram) - 1] += min(maxcounts.get(ngram, 0), count)
    return testlen, reflen, guess, correct


def _native_counts(hypo, refs, n):
    """Clipped n-gram counting through the C++ kernel when built
    (native/kmbart_native.cpp bleu_counts); token strings are interned to
    int32 ids first. Returns (testlen, reflens, guess, correct) or None."""
    from kmbart_tpu_torch import _native
    if not _native.available():
        return None
    import numpy as np
    interned = {}

    def ids(sent):
        out = []
        for w in sent.split():
            out.append(interned.setdefault(w, len(interned)))
        return np.asarray(out, np.int32)

    hyp = ids(hypo)
    ref_tok = [ids(r) for r in refs]
    correct, guess = _native.bleu_counts(hyp, ref_tok, max_n=n)
    return len(hyp), [len(r) for r in ref_tok], guess.tolist(), correct.tolist()


class Bleu:
    """compute_score(gts, res) -> (score_list[n], per_instance[n][i])."""

    def __init__(self, n=4, use_native=True):
        self.n = n
        self.use_native = use_native

    def compute_score(self, gts, res):
        n = self.n
        small, tiny = 1e-9, 1e-15
        assert sorted(gts.keys()) == sorted(res.keys())

        total_testlen = total_reflen = 0
        total_guess = [0] * n
        total_correct = [0] * n
        per_instance = [[] for _ in range(n)]

        for key in sorted(gts.keys(), key=str):
            hypo = res[key]
            refs = gts[key]
            assert len(hypo) == 1 and len(refs) >= 1
            native = _native_counts(hypo[0], refs, n) if self.use_native else None
            if native is not None:
                testlen, reflens, guess, correct = native
                reflen = min((abs(l - testlen), l) for l in reflens)[1]
            else:
                reflens, maxcounts = _cook_refs(refs, n)
                testlen, reflen, guess, correct = _cook_test(
                    hypo[0], reflens, maxcounts, n)

            total_testlen += testlen
            total_reflen += reflen
            for k in range(n):
                total_guess[k] += guess[k]
                total_correct[k] += correct[k]

            # per-instance scores (coco reports these as the second output)
            bleu = 1.0
            ratio = (testlen + tiny) / (reflen + small)
            for k in range(n):
                bleu *= (correct[k] + tiny) / (guess[k] + small)
                b = bleu ** (1.0 / (k + 1))
                if ratio < 1:
                    import math
                    b *= math.exp(1 - 1 / ratio)
                per_instance[k].append(b)

        import math
        bleus = []
        bleu = 1.0
        ratio = (total_testlen + tiny) / (total_reflen + small)
        for k in range(n):
            bleu *= (total_correct[k] + tiny) / (total_guess[k] + small)
            b = bleu ** (1.0 / (k + 1))
            if ratio < 1:
                b *= math.exp(1 - 1 / ratio)
            bleus.append(b)
        return bleus, per_instance
