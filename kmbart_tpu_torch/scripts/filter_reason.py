"""Perplexity filtering of COMET-generated reasoning data:
``python -m kmbart_tpu_torch.scripts.filter_reason``.

Twin of scripts/filter_reason.py (the reference's scripts/filter_reason.py:
17-141): score each (event, inference) pair with a VCG-trained
conditional-generation model and keep the samples whose log-perplexity is
below ``--pp_threshold`` (3.5). A batch's perplexities come from one
teacher-forced forward (``bart.forward`` + ``lm_logits``), so on the card
its attentions and FFNs run the kernels K1 and K2.
"""

import argparse
import json
import os
from datetime import datetime

import torch

from kmbart_tpu_torch.checkpoint.io import load_pretrained
from kmbart_tpu_torch.cli_common import setup_device
from kmbart_tpu_torch.data.collation import Collator
from kmbart_tpu_torch.data.datasets import ReasonDataset
from kmbart_tpu_torch.data.loader import DataLoader
from kmbart_tpu_torch.data.tokenization import ConditionTokenizer
from kmbart_tpu_torch.models import bart
from kmbart_tpu_torch.training.trainer import to_device
from kmbart_tpu_torch.utils.logger import Logger


@torch.no_grad()
def batch_log_perplexity(model, cfg, batch):
    """log(perplexity) per row: minus the mean label log-prob over the valid
    label positions (the reference computes exp(-mean) and compares it with
    the threshold; the log is compared here, as in the JAX twin)."""
    hidden, _ = bart.forward(model.model, cfg, batch["input_ids"], batch.get("image_features"),
                             batch.get("attention_mask"),
                             decoder_input_ids=batch["decoder_input_ids"],
                             decoder_attention_mask=batch.get("decoder_attention_mask"))
    logits = bart.lm_logits(model.model, cfg, hidden, model.final_logits_bias)
    labels = batch["labels"]
    valid = labels >= 0
    logp = torch.log_softmax(logits, dim=-1)
    tok_lp = logp.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    mean_lp = torch.where(valid, tok_lp, 0.0).sum(dim=1) / valid.sum(dim=1).clamp(min=1)
    return -mean_lp


def filter_dataset(model, cfg, loader, args, logger, device):
    filtered_indices = []
    total_step = len(loader)
    start_time = datetime.now()
    for i, batch in enumerate(loader):
        log_pp = batch_log_perplexity(model, cfg, to_device(batch, device)).cpu().numpy()
        for j in range(len(log_pp)):
            if log_pp[j] < args.pp_threshold:
                filtered_indices.append(batch["dataset_index"][j])
        logger.info("Filtering, Step [{}/{}], ETA: {}".format(
            i + 1, total_step,
            str((total_step - (i + 1)) / (i + 1) * (datetime.now() - start_time))))
    return filtered_indices


def main(args):
    device = setup_device(args)
    logger = Logger(log_file=args.log_dir)
    logger.info("Loading model...")
    tokenizer = ConditionTokenizer(assets_dir=args.tokenizer_dir)
    cfg, model, _ = load_pretrained(args.checkpoint, device=device)
    logger.info('Loaded model from "{}"'.format(args.checkpoint))

    logger.info("Loading data...")
    collate_fn = Collator(tokenizer, has_label=True, max_img_num=cfg.max_img_num,
                          image_feature_size=cfg.image_feature_size)
    dataset = ReasonDataset(args.data_dir, split=args.split)
    loader = DataLoader(dataset, batch_size=args.batch_size, collate_fn=collate_fn,
                        num_workers=args.num_workers)

    start = datetime.now()
    logger.info("Start computing score", pad=True)
    indices = filter_dataset(model, cfg, loader, args, logger, device)
    logger.info("Filtering complete in: " + str(datetime.now() - start), pad=True)

    logger.info("Saving results...")
    data = [dataset.get_raw_data(i) for i in indices]
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, f"reason_{args.split}.json"), "w") as f:
        json.dump(data, f)
    logger.info(f"Remaining {len(data)}/{len(dataset)}")
    logger.info('Saved results in "{}"'.format(args.output_dir))


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--data_dir', required=True, type=str)
    parser.add_argument('--output_dir', required=True, type=str)
    parser.add_argument('--checkpoint', required=True, type=str)
    parser.add_argument('--tokenizer_dir', default=os.environ.get('KMBART_TOKENIZER_DIR'),
                        type=str)
    parser.add_argument('--log_dir', default=None, type=str)
    parser.add_argument('--split', default='train', type=str)
    parser.add_argument('--pp_threshold', default=3.5, type=float,
                        help='perplexity threshold for filtering')
    parser.add_argument('--device', default='cuda', type=str,
                        help='torch device to run on (cuda, cuda:N or cpu)')
    parser.add_argument('--cpu', dest='device', action='store_const', const='cpu',
                        help='run on host CPU (the same as --device cpu)')
    parser.add_argument('--amp', action='store_true',
                        help='kept for reference-CLI compatibility (bf16 is always on)')
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--num_workers', type=int, default=0)
    return parser.parse_args(argv)


if __name__ == '__main__':
    main(parse_args())
