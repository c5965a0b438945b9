"""VCG fine-tuning CLI of the port: ``python -m kmbart_tpu_torch.vcg_train``.

Twin of the root ``vcg_train.py``: fine-tune the conditional-generation
model on VCG with per-epoch ``model{N}/`` checkpoints (optionally every
``--save_every_steps`` steps too), optional validation loss and generation
score, a sample decode every 100 steps, and TensorBoard scalars. It takes
the same flags, with ``--device`` (default ``cuda``; ``--cpu`` is ``--device
cpu``). ``--multihost`` trains on several processes, one per card:
data parallel (the global batch is the feed groups' ``--batch_size`` rows
side by side), and with ``--model_parallel``, ``--sequence_parallel`` and
``--pipeline_stages`` tensor, sequence and pipeline parallel
(parallel/mesh.py), as the root CLI wires them (vcg_train.py:83-190);
``--zero1`` shards the AdamW moments over the data axis and
``--sharded_checkpoints`` writes the port's sharded format. Only rank 0
logs and writes npz checkpoints (the parts of a split model gathered
first), which are in the JAX package's format, so either package resumes
the other's. The sample decode and the generation score run on every
rank, each on its part of the model and its block of the rows
(``generate(..., grid=grid)``), as the JAX package decodes on the sharded
parameters; under ``--pipeline_stages`` they run on rank 0 alone on the
gathered whole model, where the JAX package gathers too.
"""

import argparse
import json
import os
from datetime import datetime

import numpy as np

from kmbart_tpu_torch.data.collation import Collator
from kmbart_tpu_torch.data.datasets import VCGDataset
from kmbart_tpu_torch.data.loader import DataLoader, ShardedSampler
from kmbart_tpu_torch.data.tokenization import ConditionTokenizer
from kmbart_tpu_torch.utils.logger import Logger
from kmbart_tpu_torch.checkpoint.io import jax_leaf_groups
from kmbart_tpu_torch.cli_common import (add_common_model_args, add_dropout_args,
                                         add_hardware_args, build_model_params,
                                         load_model_config, make_grid_from_args,
                                         make_train_state, pipeline_microbatches,
                                         save_train_checkpoint, setup_device,
                                         validate_batch_layout, whole_model)
from kmbart_tpu_torch.generation.api import generate
from kmbart_tpu_torch.models.conditional import conditional_loss, init_conditional_model
from kmbart_tpu_torch.parallel import distributed
from kmbart_tpu_torch.parallel.train_step import build_eval_step, build_train_step
from kmbart_tpu_torch.training.adamw import AdamW
from kmbart_tpu_torch.training.trainer import run_epoch
from kmbart_tpu_torch.training.validation import validate_generation_score, validate_loss


def main(args):
    device = setup_device(args)
    grid = make_grid_from_args(args)
    pp_active = grid is not None and grid.stage.size > 1
    # each feed group's batch splits into the pipeline's micro-batches, so
    # partial batches trim to a multiple of their count
    n_micro = pipeline_microbatches(args) if pp_active else 1
    validate_batch_layout(args, n_micro)
    is_main = distributed.is_main_process()
    timestamp = distributed.sync_timestamp(datetime.now().strftime("%Y-%m-%d-%H-%M-%S"))
    checkpoint_path = os.path.join(args.checkpoint_dir, timestamp)
    tb_writer = None
    log_dir = os.path.join(args.log_dir, timestamp) if args.log_dir else None
    if log_dir is not None and is_main:
        os.makedirs(log_dir, exist_ok=True)
        from kmbart_tpu_torch.utils.tb import SummaryWriter
        tb_writer = SummaryWriter(log_dir=log_dir)
    # rank-gated like the reference Logger (src/utils.py:42-79)
    logger = Logger(log_file=os.path.join(log_dir, 'log.txt') if (log_dir and is_main) else None,
                    enabled=is_main)

    os.makedirs(checkpoint_path, exist_ok=True)
    logger.info('Made checkpoint directory: "{}"'.format(checkpoint_path))
    logger.info('Running on {} ({} process(es){})'.format(
        device, distributed.world_size(), '' if grid is None else ', ' + repr(grid)), pad=True)
    for k, v in vars(args).items():
        logger.info('{}: {}'.format(k, v))

    logger.info('Loading model...')
    tokenizer = ConditionTokenizer(assets_dir=args.tokenizer_dir)
    cfg = load_model_config(args)
    model = build_model_params(args, cfg, init_conditional_model, device, logger)
    if grid is not None and grid.parallel:
        from kmbart_tpu_torch.parallel.tp import shard_model_
        shard_model_(model, cfg, grid)
        if grid.sequence_parallel:
            logger.info('Sequence parallelism active (TP degree {})'.format(grid.model.size))
        if pp_active:
            logger.info('Pipeline parallelism active ({} stages, {} microbatches)'.format(
                grid.stage.size, n_micro))
    optimizer = AdamW(lr=args.lr, groups=jax_leaf_groups(cfg))
    state, epoch, zero1 = make_train_state(args, cfg, model, optimizer, device, logger=logger,
                                           grid=grid)
    replicas, rank = distributed.data_feed(grid)

    logger.info('Loading data...')
    collate_fn = Collator(tokenizer, has_label=True, max_img_num=cfg.max_img_num,
                          image_feature_size=cfg.image_feature_size,
                          num_mrm_labels=cfg.num_labels,
                          rng=np.random.default_rng(args.seed))
    collate_fn_gen = Collator(tokenizer, has_label=False, max_img_num=cfg.max_img_num,
                              image_feature_size=cfg.image_feature_size)
    train_dataset = VCGDataset(args.data_dir, split='train', use_image=args.use_image,
                               use_event=args.use_event)
    train_loader = DataLoader(
        train_dataset, batch_size=args.batch_size, collate_fn=collate_fn,
        sampler=ShardedSampler(len(train_dataset), num_replicas=replicas, rank=rank,
                               shuffle=True, seed=args.seed),
        num_workers=args.num_workers, drop_last=True, batch_divisor=n_micro)
    val_dataset = VCGDataset(args.data_dir, split='val', use_image=args.use_image,
                             use_event=args.use_event)
    val_loader = DataLoader(val_dataset, batch_size=args.batch_size, collate_fn=collate_fn,
                            num_workers=args.num_workers,
                            sampler=ShardedSampler(len(val_dataset), num_replicas=replicas,
                                                   rank=rank, shuffle=False),
                            batch_divisor=n_micro)
    gen_dataset = VCGDataset(args.data_dir, split='val', use_image=args.use_image,
                             use_event=args.use_event, eval_mode=True)
    gen_loader = DataLoader(gen_dataset, batch_size=args.batch_size,
                            collate_fn=collate_fn_gen, num_workers=args.num_workers)
    with open(os.path.join(args.data_dir, 'val_ref.json')) as f:
        val_ref = json.load(f)

    if pp_active:
        from kmbart_tpu_torch.parallel.pp import pipelined_conditional_loss

        def model_loss(m, b, train, generator):
            return pipelined_conditional_loss(m, cfg, b, grid, n_micro=n_micro, train=train,
                                              generator=generator)
    else:
        def model_loss(m, b, train, generator):
            return conditional_loss(m, cfg, b, train=train, generator=generator,
                                    tp=None if grid is None else grid.tp)

    def loss_fn(m, b, generator):
        return model_loss(m, b, True, generator)[0], {}

    def eval_loss_fn(m, b, generator):
        return model_loss(m, b, False, None)[0], {}

    train_step = build_train_step(loss_fn, optimizer, grad_accum_steps=args.grad_accum_steps,
                                  zero1=zero1, grid=grid)
    eval_step = build_eval_step(eval_loss_fn, grid=grid)

    def decode_model(params):
        """(model, grid) to decode with: every rank's own part under the
        grid; under pipeline stages the whole model gathered to rank 0
        (None elsewhere), decoding alone."""
        if pp_active:
            return whole_model(params, cfg, grid, init_conditional_model), None
        return params, grid

    def callback(step, epoch, state, logger, **kwargs):
        if args.save_every_steps and (step + 1) % args.save_every_steps == 0:
            path = os.path.join(checkpoint_path, 'step{}'.format(state.step))
            save_train_checkpoint(path, cfg, state, epoch, args, zero1, grid)
            logger.info('Saved mid-epoch checkpoint at "{}"'.format(path))
        if (step + 1) % 100 == 0:
            inputs = collate_fn([train_dataset[0]])
            model, decode_grid = decode_model(state.params)
            if model is not None:
                out = generate(model, cfg,
                               {'input_ids': inputs['input_ids'],
                                'attention_mask': inputs['attention_mask'],
                                'image_features': inputs['image_features']},
                               max_length=args.max_length, grid=decode_grid)
            if not is_main:
                return
            ans = tokenizer.decode(out[0], skip_special_tokens=True)
            event = tokenizer.decode(inputs['input_ids'][0], skip_special_tokens=True)
            logger.info('Input ({} image): "{}"'.format(
                'with' if args.use_image else 'without', event))
            logger.info('Generated: "{}"'.format(ans))

    logger.info('Start training', pad=True)
    start = datetime.now()
    while epoch < args.epochs:
        logger.info('Epoch {}'.format(epoch + 1), pad=True)
        train_loader.set_epoch(epoch)
        state, _ = run_epoch(epoch, state, train_step, train_loader, args.seed,
                             device=device, epochs=args.epochs, logger=logger,
                             callback=callback, log_interval=1, tb_writer=tb_writer,
                             tb_interval=1)

        logger.info('Validating Epoch {}'.format(epoch + 1), pad=True)
        if args.validate_loss:
            validate_loss(epoch, state.params, eval_step, val_loader, device=device,
                          logger=logger, tb_writer=tb_writer)
        if args.validate_score:
            # every rank decodes (its part); rank 0 scores
            model, decode_grid = decode_model(state.params)
            if model is not None:
                validate_generation_score(epoch, model, cfg, gen_loader, val_ref,
                                          tokenizer, args, logger=logger, tb_writer=tb_writer,
                                          grid=decode_grid)

        current = os.path.join(checkpoint_path, 'model{}'.format(epoch))
        save_train_checkpoint(current, cfg, state, epoch, args, zero1, grid)
        logger.info('Saved checkpoint at "{}"'.format(checkpoint_path))
        epoch += 1
    logger.info('Training complete in: ' + str(datetime.now() - start), pad=True)
    distributed.barrier()
    if args.multihost:
        distributed.shutdown()
    return checkpoint_path


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--data_dir', required=True, type=str,
                        help='path to load data, output_dir of prepare_vcg')
    parser.add_argument('--checkpoint_dir', required=True, type=str,
                        help='where to save the checkpoint')
    add_common_model_args(parser)
    parser.add_argument('--epochs', default=40, type=int)
    parser.add_argument('--lr', default=1e-5, type=float)
    parser.add_argument('--num_gen', default=1, type=int,
                        help='number of generated sentence on validation.')
    parser.add_argument('--num_beams', default=1, type=int,
                        help='level of beam search on validation')
    parser.add_argument('--max_length', default=30, type=int,
                        help='max decode length')
    parser.add_argument('--continue_training', action='store_true')
    parser.add_argument('--save_every_steps', default=0, type=int,
                        help='also checkpoint every N steps (0 = per-epoch only)')
    parser.add_argument('--validate_loss', action='store_true')
    parser.add_argument('--validate_score', action='store_true')
    add_dropout_args(parser)
    add_hardware_args(parser, train=True)
    parser.set_defaults(use_event=True, use_image=True)
    args = parser.parse_args(argv)
    if args.checkpoint is None and args.model_config is None:
        raise ValueError('--model_config and --checkpoint cannot be empty at the same time')
    return args


if __name__ == '__main__':
    main(parse_args())
