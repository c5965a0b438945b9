"""Metric-scoring CLI of the port: ``python -m kmbart_tpu_torch.vcg_eval``.

Twin of the root ``vcg_eval.py`` (the reference's vcg_eval.py:8-41): score
a generation file against a reference file with BLEU, METEOR and CIDEr,
and Unique/Novel diversity against the train annotations when
``--annotation`` is given. It takes the same flags and logs the same
scores, through the port's own ``eval/metrics.py``.
"""

import argparse
import json

from kmbart_tpu_torch.eval.metrics import compute_metric_inference
from kmbart_tpu_torch.utils.logger import Logger


def main(args):
    logger = Logger()
    with open(args.generation) as f:
        gens_list = json.load(f)
    with open(args.reference) as f:
        refs_list = json.load(f)
    scores = compute_metric_inference(
        gens_list=gens_list,
        refs_list=refs_list,
        calculate_diversity=args.annotation is not None,
        train_file=args.annotation)
    logger.info(scores)
    return scores


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--generation', type=str, required=True,
                        help='path to the generation file')
    parser.add_argument('--reference', type=str, required=True,
                        help='path to the reference file')
    parser.add_argument('--annotation', type=str, required=False,
                        help='path to vcg annotation. If not specified, do not compute novel and unique')
    return parser.parse_args(argv)


if __name__ == '__main__':
    main(parse_args())
