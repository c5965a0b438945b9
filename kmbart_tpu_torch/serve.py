"""Serving CLI of the port: ``python -m kmbart_tpu_torch.serve``.

Twin of the root ``serve.py``: load a checkpoint and serve generation over
HTTP, through the static coalescing engine (serving/engine.py) or, with
``--continuous``, the slot-pool engine (serving/continuous.py). It takes the
same flags, with ``--device`` (default ``cuda``; ``--cpu`` is ``--device
cpu``).

    python -m kmbart_tpu_torch.serve --checkpoint ckpt/model0 \\
        --tokenizer_dir ASSETS --port 8000 --num_beams 5 --max_length 32
    curl -XPOST localhost:8000/generate -d '{"text": "<caption><event> ... </event>"}'
"""

import argparse
import os

from kmbart_tpu_torch.checkpoint.io import load_pretrained
from kmbart_tpu_torch.data.tokenization import ConditionTokenizer
from kmbart_tpu_torch.device import resolve_device
from kmbart_tpu_torch.serving.engine import GenerationEngine
from kmbart_tpu_torch.serving.http import serve
from kmbart_tpu_torch.utils.logger import Logger


def build_engine(args):
    """The engine the flags ask for, on ``--device``."""
    device = resolve_device(args.device)
    tokenizer = (ConditionTokenizer(assets_dir=args.tokenizer_dir)
                 if args.tokenizer_dir else None)
    cfg, model, _ = load_pretrained(args.checkpoint, device=device)
    if args.continuous:
        from kmbart_tpu_torch.serving.continuous import ContinuousGenerationEngine
        return ContinuousGenerationEngine(
            model, cfg, tokenizer=tokenizer, pool_size=args.pool_size,
            encoder_seq_len=args.encoder_seq_len, chunk_steps=args.chunk_steps,
            num_beams=args.num_beams, max_length=args.max_length, early_stopping=True)
    return GenerationEngine(
        model, cfg, tokenizer=tokenizer, max_batch_size=args.max_batch_size,
        encoder_seq_len=args.encoder_seq_len, max_wait_ms=args.max_wait_ms,
        batch_buckets=(tuple(int(b) for b in args.batch_buckets.split(","))
                       if args.batch_buckets else None),
        num_beams=args.num_beams, max_length=args.max_length, early_stopping=True)


def main(args):
    logger = Logger()
    logger.info("Loading model...")
    engine = build_engine(args)
    logger.info(f"Serving on http://{args.host}:{args.port}", pad=True)
    try:
        serve(engine, host=args.host, port=args.port, block=True)
    finally:
        engine.shutdown()


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True, type=str)
    parser.add_argument("--tokenizer_dir",
                        default=os.environ.get("KMBART_TOKENIZER_DIR"), type=str)
    parser.add_argument("--host", default="127.0.0.1", type=str)
    parser.add_argument("--port", default=8000, type=int)
    parser.add_argument("--max_batch_size", default=32, type=int)
    parser.add_argument("--batch_buckets", default=None, type=str,
                        help="comma-separated batch sizes to pad to "
                             "(default: engine.DEFAULT_BATCH_BUCKETS)")
    parser.add_argument("--encoder_seq_len", default=96, type=int)
    parser.add_argument("--max_wait_ms", default=5.0, type=float)
    parser.add_argument("--num_beams", default=5, type=int)
    parser.add_argument("--max_length", default=32, type=int)
    parser.add_argument("--continuous", action="store_true",
                        help="slot-pool continuous batching (serving/continuous.py): "
                             "requests admit into finished rows of the in-flight pool "
                             "at chunk granularity instead of bucket coalescing")
    parser.add_argument("--pool_size", default=112, type=int,
                        help="in-flight slot count for --continuous")
    parser.add_argument("--chunk_steps", default=4, type=int,
                        help="decode steps per pool chunk for --continuous")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on (cuda, cuda:N or cpu)")
    parser.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                        help="run on the host CPU (the same as --device cpu)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
