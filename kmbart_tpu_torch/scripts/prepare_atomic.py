"""Train the text-image matching classifier on VCG events:
``python -m kmbart_tpu_torch.scripts.prepare_atomic``.

Twin of scripts/prepare_atomic.py (the reference's
scripts/prepare_atomic.py:27-286): fine-tune the reasoning classifier on
AtomicCollator's shuffled-pair negatives (shuffle ratio 0.5) over
VCGDataset with the port's AdamW, and write a checkpoint each epoch
(``model{epoch}/params.npz``, the JAX package's layout: [in, out]
kernels). The frozen text backbone is the port's BART encoder, mean-pooled
over the valid tokens (``--text_backbone``, or a tiny random one).
"""

import argparse
import os
from datetime import datetime

import numpy as np
import torch

from kmbart_tpu_torch.checkpoint.io import load_pretrained
from kmbart_tpu_torch.cli_common import setup_device
from kmbart_tpu_torch.data.datasets import VCGDataset
from kmbart_tpu_torch.data.loader import DataLoader
from kmbart_tpu_torch.data.tokenization import ConditionTokenizer
from kmbart_tpu_torch.models import bart
from kmbart_tpu_torch.models.conditional import init_conditional_model
from kmbart_tpu_torch.models.reasoning import (AtomicCollator, init_reasoning_params,
                                               reasoning_loss)
from kmbart_tpu_torch.training.adamw import AdamW
from kmbart_tpu_torch.utils.logger import Logger


def build_text_encoder(args, tokenizer, device):
    """Frozen text backbone: mean-pooled BART encoder states. Returns
    (encode(list[str]) -> fp32 numpy [B, d_model], d_model)."""
    if args.text_backbone:
        cfg, model, _ = load_pretrained(args.text_backbone, device=device)
    else:
        from kmbart_tpu_torch.config import tiny_config
        cfg = tiny_config(vocab_size=len(tokenizer) + 8, pad_token_id=tokenizer.pad_token_id)
        model = init_conditional_model(cfg, seed=0, device=device)

    @torch.no_grad()
    def encode(texts):
        rows = [tokenizer.encode(t)[:32] or [tokenizer.pad_token_id] for t in texts]
        width = max(len(r) for r in rows)
        ids = np.full((len(rows), width), tokenizer.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        ids, mask = torch.as_tensor(ids, device=device), torch.as_tensor(mask, device=device)
        h = bart.encode(model.model, cfg, ids, None, mask)
        pooled = (h * mask[..., None]).sum(dim=1) / mask.sum(dim=1, keepdim=True).clamp(min=1)
        return pooled.float().cpu().numpy()

    return encode, cfg.d_model


def save_params(path, params):
    """params.npz in the JAX package's layout ([in, out] kernels)."""
    os.makedirs(path, exist_ok=True)
    flat = {k: (v.T if v.ndim == 2 else v).detach().cpu().numpy() for k, v in params.items()}
    np.savez(os.path.join(path, "params.npz"), **flat)


def main(args):
    device = setup_device(args)
    timestamp = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    checkpoint_path = os.path.join(args.checkpoint_dir, timestamp)
    os.makedirs(checkpoint_path, exist_ok=True)
    logger = Logger()

    tokenizer = ConditionTokenizer(assets_dir=args.tokenizer_dir)
    encode, txt_dim = build_text_encoder(args, tokenizer, device)
    image_dim = args.image_seq_length * args.image_feature_size
    collate = AtomicCollator(encode, args.image_seq_length, args.image_feature_size,
                             args.shuffle_ratio, rng=np.random.default_rng(args.seed))
    dataset = VCGDataset(args.data_dir, split="train")
    loader = DataLoader(dataset, batch_size=args.batch_size, collate_fn=collate, shuffle=True,
                        num_workers=args.num_workers, drop_last=True, seed=args.seed)

    params = init_reasoning_params(torch.Generator(device=device).manual_seed(args.seed),
                                   txt_dim, image_dim, args.inner_dim, device=device)
    for p in params.values():
        p.requires_grad_(True)
    opt = AdamW(lr=args.lr)
    opt_state = opt.init(params)

    def step(batch):
        text, image, label = (torch.as_tensor(batch[k], device=device)
                              for k in ("text", "image", "label"))
        loss, _ = reasoning_loss(params, text, image, label.long())
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), opt.update(dict(zip(params, grads)), opt_state, params)

    logger.info("Start training", pad=True)
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        total_step = len(loader)
        start_time = datetime.now()
        for i, batch in enumerate(loader):
            loss, opt_state = step(batch)
            logger.info("Epoch [{}/{}], Step [{}/{}], Loss: {:.4f}, ETA: {}".format(
                epoch + 1, args.epochs, i + 1, total_step, float(loss),
                str((total_step - (i + 1)) / (i + 1) * (datetime.now() - start_time))))
        save_params(os.path.join(checkpoint_path, f"model{epoch}"), params)
        logger.info('Saved checkpoint at "{}"'.format(checkpoint_path))
    return params


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True, type=str)
    parser.add_argument("--checkpoint_dir", required=True, type=str)
    parser.add_argument("--tokenizer_dir", default=os.environ.get("KMBART_TOKENIZER_DIR"),
                        type=str)
    parser.add_argument("--text_backbone", default=None, type=str,
                        help="BART checkpoint dir for the frozen text encoder")
    parser.add_argument("--image_seq_length", type=int, default=10)
    parser.add_argument("--image_feature_size", type=int, default=2052)
    parser.add_argument("--inner_dim", type=int, default=512)
    parser.add_argument("--shuffle_ratio", type=float, default=0.5)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_workers", type=int, default=0)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on (cuda, cuda:N or cpu)")
    parser.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                        help="run on host CPU (the same as --device cpu)")
    parser.add_argument("--amp", action="store_true",
                        help="kept for reference-CLI compatibility (bf16 is always on)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
