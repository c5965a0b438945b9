"""Batch generation CLI of the port: ``python -m kmbart_tpu_torch.vcg_generate``.

Twin of the root ``vcg_generate.py``: decode a VCG split with greedy or
beam settings, or sampling, and dump ``[{index, task_type, generations}]``
JSON. It takes the same flags, with ``--device`` (default ``cuda``;
``--cpu`` is ``--device cpu``) and ``--temperature``; ``--do_sample``
draws from a ``torch.Generator`` seeded with ``--seed``.
"""

import argparse
import json
from datetime import datetime

import torch

from kmbart_tpu_torch.data.collation import Collator
from kmbart_tpu_torch.data.datasets import VCGDataset
from kmbart_tpu_torch.data.loader import DataLoader
from kmbart_tpu_torch.data.tokenization import ConditionTokenizer
from kmbart_tpu_torch.utils.logger import Logger
from kmbart_tpu_torch.checkpoint.io import load_pretrained
from kmbart_tpu_torch.cli_common import (add_common_model_args, add_hardware_args,
                                         setup_device)
from kmbart_tpu_torch.generation.driver import generate_text


def main(args):
    device = setup_device(args)
    logger = Logger(log_file=args.log_dir)
    logger.info('Loading model...')

    tokenizer = ConditionTokenizer(assets_dir=args.tokenizer_dir)
    cfg, model, report = load_pretrained(args.checkpoint, device=device, seed=args.seed)
    for line in report:
        logger.info(line)
    logger.info('Loaded model from "{}" onto {}'.format(args.checkpoint, device))

    logger.info('Loading data...')
    collate_fn = Collator(tokenizer, has_label=False, max_img_num=cfg.max_img_num,
                          image_feature_size=cfg.image_feature_size)
    dataset = VCGDataset(args.data_dir, split=args.split, use_image=args.use_image,
                         use_event=args.use_event, eval_mode=True)
    loader = DataLoader(dataset, batch_size=args.batch_size, collate_fn=collate_fn,
                        num_workers=args.num_workers)

    start = datetime.now()
    logger.info('Start generation', pad=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    generated = generate_text(model, cfg, loader, tokenizer, args, logger=logger,
                              log_interval=1, generator=generator)
    logger.info('Generation complete in: ' + str(datetime.now() - start), pad=True)

    logger.info('Saving results...')
    with open(args.output_file, 'w') as outfile:
        json.dump(generated, outfile)
    logger.info('Saved results in "{}"'.format(args.output_file))


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--data_dir', required=True, type=str,
                        help='path to load data, output_dir of prepare_vcg')
    parser.add_argument('--output_file', required=True, type=str,
                        help='file to save the generated result')
    add_common_model_args(parser)
    parser.add_argument('--split', default='val', type=str,
                        help='generate for which split')
    parser.add_argument('--model', type=str, default='base',
                        help='base or large bart (informational)')
    parser.add_argument('--num_gen', default=1, type=int,
                        help='number of generated sentence')
    parser.add_argument('--num_beams', default=1, type=int,
                        help='level of beam search')
    parser.add_argument('--max_length', default=30, type=int,
                        help='max decode length')
    parser.add_argument('--do_sample', action='store_true',
                        help='use nucleus sample (seeded from --seed)')
    parser.add_argument('--top_p', default=1.0, type=float)
    parser.add_argument('--top_k', default=0, type=int)
    parser.add_argument('--temperature', default=None, type=float,
                        help="sampling temperature (default: the model config's)")
    add_hardware_args(parser)
    parser.set_defaults(use_event=True, use_image=True)
    args = parser.parse_args(argv)
    if args.checkpoint is None:
        raise ValueError('--checkpoint is required')
    return args


if __name__ == '__main__':
    main(parse_args())
