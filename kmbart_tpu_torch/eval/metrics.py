"""VCG metric evaluation.

Parity target: src/evaluation.py:17-89 — visual-comet-style scoring: pair
predictions and references by (index, task_type), skip empty reference
lists, PTB-tokenize, score BLEU-1..4 / METEOR / CIDEr, and optionally the
Unique/Novel diversity rates with digit normalisation (``use_same_id``).
"""

import json

import numpy as np

from kmbart_tpu_torch.eval.bleu import Bleu
from kmbart_tpu_torch.eval.cider import Cider
from kmbart_tpu_torch.eval.meteor import Meteor
from kmbart_tpu_torch.eval.ptb_tokenizer import PTBTokenizer


def use_same_id(sent):
    """Digit normalisation for diversity stats (src/evaluation.py:17-21)."""
    r_sent = sent.replace("'", " '")
    r_sent = " ".join([g if not g.isdigit() else "1"
                       for g in r_sent.split()]).strip()
    r_sent = r_sent.replace(" '", "'")
    return r_sent


def compute_metric_inference(gens_list, refs_list, calculate_diversity=False,
                             train_file=None, verbose=True):
    scorers = [
        (Bleu(4), ["BLEU1", "BLEU2", "BLEU3", "BLEU4"]),
        (Meteor(), "METEOR"),
        (Cider(), "CIDEr"),
    ]
    tokenizer = PTBTokenizer()

    refs, preds = {}, {}
    output = {}
    cnt = 0
    for gens in gens_list:
        ref_index = gens["index"]
        relation = gens["task_type"]
        ref = refs_list[ref_index].get(relation, []) \
            if isinstance(refs_list[ref_index], dict) else refs_list[ref_index][relation]
        if len(ref) > 0:
            for pred in gens["generations"]:
                preds[cnt] = [{"caption": pred}]
                refs[cnt] = [{"caption": r} for r in ref]
                cnt += 1

    refs = tokenizer.tokenize(refs)
    preds = tokenizer.tokenize(preds)

    if calculate_diversity:
        unique_sents, novel_sents = [], []
        train_sents = json.load(open(train_file))
        ts = set()
        for d in train_sents:
            for r in ("intent", "before", "after"):
                if r in d:
                    for sent in d[r]:
                        ts.add(use_same_id(sent))
        for pred in preds.values():
            pred_same_id = use_same_id(pred[0])
            unique_sents.append(pred_same_id)
            novel_sents.append(pred_same_id not in ts)
        output["Unique"] = len(set(unique_sents)) / max(len(unique_sents), 1)
        output["Novel"] = float(np.mean(novel_sents)) if novel_sents else 0.0
        if verbose:
            print("Unique Inferences:", output["Unique"])
            print("Novel Inferences:", output["Novel"])

    for scorer, method in scorers:
        score, scores = scorer.compute_score(refs, preds)
        if isinstance(method, list):
            for m, s in zip(method, score):
                output[m] = s
                if verbose:
                    print(m, s)
        else:
            output[method] = score
            if verbose:
                print(method, score)
    return output
