"""CIDEr: TF-IDF weighted n-gram consensus.

Parity target: pycocoevalcap's ``Cider``/``CiderScorer``
(src/evaluation.py:13): n=1..4 counts, document frequency over the reference
corpus, log-space IDF (log N - log df clipped at df>=1), clipped-min
similarity weighted by the reference vector, per-order cosine normalisation,
a Gaussian length penalty (sigma=6), mean over orders and references, x10.
"""

import math
from collections import defaultdict


def _ngram_counts(words, n=4):
    counts = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


class Cider:
    def __init__(self, n=4, sigma=6.0):
        self.n = n
        self.sigma = sigma

    def compute_score(self, gts, res):
        keys = sorted(gts.keys(), key=str)
        assert sorted(res.keys(), key=str) == keys

        crefs = [[_ngram_counts(r.split(), self.n) for r in gts[k]] for k in keys]
        ctest = [_ngram_counts(res[k][0].split(), self.n) for k in keys]
        test_lens = [len(res[k][0].split()) for k in keys]
        ref_lens = [[len(r.split()) for r in gts[k]] for k in keys]

        # document frequency: #instances whose reference set contains the ngram
        df = defaultdict(float)
        for refs in crefs:
            for ngram in set(ng for ref in refs for ng in ref):
                df[ngram] += 1
        log_n = math.log(float(len(crefs)))

        def counts2vec(counts, length):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            for ngram, tf in counts.items():
                idf = log_n - math.log(max(1.0, df[ngram]))
                k = len(ngram) - 1
                vec[k][ngram] = float(tf) * idf
                norm[k] += vec[k][ngram] ** 2
            return vec, [math.sqrt(x) for x in norm]

        def sim(vh, nh, lh, vr, nr, lr):
            delta = float(lh - lr)
            val = [0.0] * self.n
            for k in range(self.n):
                for ngram, w in vh[k].items():
                    val[k] += min(w, vr[k].get(ngram, 0.0)) * vr[k].get(ngram, 0.0)
                if nh[k] != 0 and nr[k] != 0:
                    val[k] /= (nh[k] * nr[k])
                val[k] *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
            return val

        scores = []
        for i in range(len(keys)):
            vh, nh = counts2vec(ctest[i], test_lens[i])
            score = [0.0] * self.n
            for j, ref in enumerate(crefs[i]):
                vr, nr = counts2vec(ref, ref_lens[i][j])
                s = sim(vh, nh, test_lens[i], vr, nr, ref_lens[i][j])
                for k in range(self.n):
                    score[k] += s[k]
            score_avg = sum(score) / self.n / len(crefs[i]) * 10.0
            scores.append(score_avg)

        mean = sum(scores) / len(scores) if scores else 0.0
        return mean, scores
