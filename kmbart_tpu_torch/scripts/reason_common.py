"""Shared driver of the port's COMET reasoning-generation CLIs.

Twin of scripts/reason_common.py (the reference's
scripts/prepare_{sbu,cc,coco,vcg}_reason.py): run the ATOMIC generator over
each dataset entry's caption or event on ``--device`` and write
``{split}{shard}.json`` rows (one per generated inference, task-typed) with
their ``_eval`` and ``_ref`` files; dump every ``--save_every`` items and
resume after the last saved index (scripts/prepare_sbu_reason.py:126-160);
``merge_shards`` concatenates the shards into ``reason_{split}*.json``.
"""

import argparse
import json
import os
from datetime import datetime

import torch


def build_generator(args):
    """COMET's GPT at ``--gpt_*`` widths (random weights from seed 0) on
    ``--device``, with the ``--model_file`` state dict laid over it."""
    from kmbart_tpu_torch.knowledge.atomic import AtomicGenerator
    from kmbart_tpu_torch.knowledge.bpe_gpt1 import GPT1BPE
    from kmbart_tpu_torch.knowledge.gpt import import_openai_gpt_state_dict, init_gpt_model

    enc = GPT1BPE(os.path.join(args.comet_vocab_dir, "vocab.json"),
                  os.path.join(args.comet_vocab_dir, "merges.txt"))
    n_vocab = len(enc.encoder) + 5 + 1  # +categories +<END> appended rows
    model = init_gpt_model(n_vocab, n_ctx=17 + 34 + 1, d_model=args.gpt_dim,
                           n_layers=args.gpt_layers, n_heads=args.gpt_heads,
                           device=args.device)
    if args.model_file:
        sd = torch.load(args.model_file, map_location="cpu", weights_only=True)
        _, ok = import_openai_gpt_state_dict(sd, model)
        print("comet weights loaded:", ok, flush=True)
    return AtomicGenerator(model, enc, sampling_algorithm=args.sampling_algorithm)


def get_text_data(entry, index, caption, generator):
    base = {"img_id": str(entry["img_id"]), "img_fn": entry.get("img_fn"), "index": index}
    res = generator.get_reason(caption)
    data = []
    for k in ("before", "after", "intent"):
        for ans in res[k]:
            data.append({**base, "event": caption, "task_type": k, "labels": ans})
    return data, res


def get_eval_data(entry, index, caption, ref_ans):
    base = {"img_id": str(entry["img_id"]), "img_fn": entry.get("img_fn"), "index": index}
    return [{**base, "event": caption, "task_type": t}
            for t in ("before", "after", "intent") if len(ref_ans[t])]


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f)


def process_split(args, split, entries, caption_key, generator=None):
    """Generate this shard's rows of ``entries``, resuming after the last
    index a previous run dumped. The generator is built from ``args``
    unless one is passed."""
    if generator is None:
        generator = build_generator(args)
    local = entries[args.shard::args.num_shards]
    suffix = str(args.shard)
    paths = {kind: os.path.join(args.output_dir, split + suffix + kind + ".json")
             for kind in ("", "_eval", "_ref")}
    if all(os.path.exists(p) for p in paths.values()):
        text_data, eval_data, ref_data = (_load(paths[k]) for k in ("", "_eval", "_ref"))
        start_idx = text_data[-1]["index"] if text_data else -1
    else:
        text_data, eval_data, ref_data = [], [], []
        start_idx = -1

    def dump():
        for kind, data in (("", text_data), ("_eval", eval_data), ("_ref", ref_data)):
            _dump(data, paths[kind])

    start_time = datetime.now()
    for i in range(start_idx + 1, len(local)):
        entry = local[i]
        caption = entry[caption_key]
        rows, ref_ans = get_text_data(entry, i, caption, generator)
        text_data += rows
        eval_data += get_eval_data(entry, i, caption, ref_ans)
        ref_data.append(ref_ans)
        print("shard{}, {}/{}, ETA: {}".format(
            args.shard, i, len(local),
            str((len(local) - (i + 1)) / (i + 1) * (datetime.now() - start_time))), flush=True)
        if i % args.save_every == 0:
            dump()
    dump()


def merge_shards(args, split):
    """Concatenate per-shard outputs into reason_{split}.json etc."""
    for kind, out_name in (("", f"reason_{split}.json"),
                           ("_eval", f"reason_{split}_eval.json"),
                           ("_ref", f"reason_{split}_ref.json")):
        merged = []
        for shard in range(args.num_shards):
            p = os.path.join(args.output_dir, f"{split}{shard}{kind}.json")
            if os.path.exists(p):
                merged += _load(p)
        _dump(merged, os.path.join(args.output_dir, out_name))


def make_parser(annot_help):
    parser = argparse.ArgumentParser()
    parser.add_argument("--annot_dir", type=str, required=True, help=annot_help)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--model_file", type=str, default=None,
                        help="COMET GPT checkpoint (a torch.save'd state dict)")
    parser.add_argument("--comet_vocab_dir", type=str, required=True,
                        help="dir with the GPT-1 vocab.json + merges.txt")
    parser.add_argument("--sampling_algorithm", type=str, default="greedy",
                        help="greedy | topk-N | beam-K")
    parser.add_argument("--splits", nargs="*", default=["train", "val"])
    parser.add_argument("--save_every", type=int, default=10000)
    parser.add_argument("--merge_only", action="store_true")
    parser.add_argument("--num_shards", default=1, type=int)
    parser.add_argument("--shard", default=0, type=int)
    # model-shape knobs: the COMET GPT-1 defaults match the pretrained
    # checkpoint; smaller values make smoke tests cheap
    parser.add_argument("--gpt_dim", default=768, type=int)
    parser.add_argument("--gpt_layers", default=12, type=int)
    parser.add_argument("--gpt_heads", default=12, type=int)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on (cuda, cuda:N or cpu)")
    parser.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                        help="run on host CPU (the same as --device cpu)")
    return parser


def run(caption_key, annot_help, argv=None):
    args = make_parser(annot_help).parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    for split in args.splits:
        if not args.merge_only:
            entries = _load(os.path.join(args.annot_dir, split + ".json"))
            process_split(args, split, entries, caption_key)
        merge_shards(args, split)
