"""Multi-task pretraining CLI of the port: ``python -m kmbart_tpu_torch.pretrain``.

Twin of the root ``pretrain.py``: the 16-name dataset registry, MLM + MRM +
attribute/relation pretraining of the pretraining model, per-epoch
``model{N}/`` checkpoints (optionally every ``--save_every_steps`` steps
too), a teacher-forced sample decode every 100 steps, and TensorBoard
scalars with the head losses. It takes the same flags, with ``--device``
(default ``cuda``; ``--cpu`` is ``--device cpu``), and ``--multihost``,
``--zero1``, ``--sharded_checkpoints`` and the tensor, sequence and
pipeline parallelism flags as ``vcg_train`` takes them (the root CLI wires
them at pretrain.py:127-190; under pipeline parallelism the four heads run
whole on every stage). Checkpoints
are in the JAX package's format, so either package resumes the other's, and
a pretraining checkpoint loads into the fine-tune model (``vcg_train
--checkpoint``) with the heads dropped.
"""

import argparse
import os
from datetime import datetime

import numpy as np

from kmbart_tpu_torch.data.collation import Collator
from kmbart_tpu_torch.data.datasets import (CCDataset, COCODataset, ConcatDataset,
                                            ReasonDataset, SBUDataset, VCGDataset, VGDataset)
from kmbart_tpu_torch.data.loader import DataLoader, ShardedSampler
from kmbart_tpu_torch.data.tokenization import ConditionTokenizer
from kmbart_tpu_torch.utils.logger import Logger
from kmbart_tpu_torch.checkpoint.io import jax_leaf_groups
from kmbart_tpu_torch.cli_common import (add_common_model_args, add_dropout_args,
                                         add_hardware_args, add_pretraining_args,
                                         build_model_params, load_model_config,
                                         make_grid_from_args, make_train_state,
                                         pipeline_microbatches, save_train_checkpoint,
                                         setup_device, validate_batch_layout, whole_model)
from kmbart_tpu_torch.models.pretraining import (forward_logits, init_pretraining_model,
                                                 pretraining_loss)
from kmbart_tpu_torch.parallel import distributed
from kmbart_tpu_torch.parallel.train_step import build_train_step
from kmbart_tpu_torch.training.adamw import AdamW
from kmbart_tpu_torch.training.trainer import run_epoch, to_device

DATASET_NAMES = (
    'coco_train', 'coco_val', 'coco_reason_train', 'coco_reason_val',
    'sbu_train', 'sbu_val', 'sbu_reason_train', 'sbu_reason_val',
    'vg_train', 'vg_val', 'cc_train', 'cc_val', 'cc_reason_train',
    'cc_reason_val', 'vcg_train', 'vcg_reason_train'
)


def build_datasets(args):
    """The dataset registry, in the root CLI's order (pretrain.py:45-80)."""
    ds = []

    def reason(name, split):
        if name in args.dataset:
            ds.append(ReasonDataset(args.dataset[name], split=split, use_image=args.use_image,
                                    use_event=args.use_event))

    for name, split in (('sbu_train', 'train'), ('sbu_val', 'val')):
        if name in args.dataset:
            ds.append(SBUDataset(args.dataset[name], split=split, use_image=args.use_image))
    reason('sbu_reason_train', 'train')
    reason('sbu_reason_val', 'val')
    for name, split in (('coco_train', 'train'), ('coco_val', 'val')):
        if name in args.dataset:
            ds.append(COCODataset(args.dataset[name], split=split, use_image=args.use_image))
    reason('coco_reason_train', 'train')
    reason('coco_reason_val', 'val')
    for name, split in (('vg_train', 'train'), ('vg_val', 'val')):
        if name in args.dataset:
            ds.append(VGDataset(args.dataset[name], split=split))
    for name, split in (('cc_train', 'train'), ('cc_val', 'val')):
        if name in args.dataset:
            ds.append(CCDataset(args.dataset[name], split=split, use_image=args.use_image))
    reason('cc_reason_train', 'train')
    reason('cc_reason_val', 'val')
    if 'vcg_train' in args.dataset:
        ds.append(VCGDataset(args.dataset['vcg_train'], split='train',
                             use_image=args.use_image, pretrain=True))
    reason('vcg_reason_train', 'train')
    return ConcatDataset(ds)


def main(args):
    device = setup_device(args)
    grid = make_grid_from_args(args)
    pp_active = grid is not None and grid.stage.size > 1
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
    model = build_model_params(args, cfg, init_pretraining_model, device, logger)
    if grid is not None and grid.parallel:
        from kmbart_tpu_torch.parallel.tp import shard_model_
        shard_model_(model, cfg, grid)
    optimizer = AdamW(lr=args.lr, groups=jax_leaf_groups(cfg, heads=True))
    state, epoch, zero1 = make_train_state(args, cfg, model, optimizer, device, heads=True,
                                           logger=logger, grid=grid)
    replicas, rank = distributed.data_feed(grid)

    logger.info('Loading data...')
    collate_fn = Collator(
        tokenizer, mlm_enabled=True, mlm_probability=args.mlm_probability,
        mrm_enabled=args.mrm_enabled, mrm_probability=args.mrm_probability,
        ap_enabled=args.ap_enabled, rp_enabled=args.rp_enabled, lm_max_len=args.lm_max_len,
        max_img_num=args.max_img_num, image_feature_size=cfg.image_feature_size,
        num_mrm_labels=cfg.num_labels, rng=np.random.default_rng(args.seed))
    train_dataset = build_datasets(args)
    train_loader = DataLoader(
        train_dataset, batch_size=args.batch_size, collate_fn=collate_fn,
        sampler=ShardedSampler(len(train_dataset), num_replicas=replicas, rank=rank,
                               shuffle=True, seed=args.seed),
        num_workers=args.num_workers, drop_last=True, batch_divisor=n_micro)

    def loss_fn(m, b, generator):
        if pp_active:
            from kmbart_tpu_torch.parallel.pp import pipelined_pretraining_loss
            loss, aux = pipelined_pretraining_loss(m, cfg, b, grid, n_micro=n_micro,
                                                   train=True, generator=generator)
        else:
            loss, aux = pretraining_loss(m, cfg, b, train=True, generator=generator,
                                         tp=None if grid is None else grid.tp)
        return loss, {k: v for k, v in aux['losses'].items() if k != 'loss'}

    train_step = build_train_step(loss_fn, optimizer, grad_accum_steps=args.grad_accum_steps,
                                  zero1=zero1, grid=grid)

    def callback(step, epoch, state, logger, **kwargs):
        if args.save_every_steps and (step + 1) % args.save_every_steps == 0:
            path = os.path.join(checkpoint_path, 'step{}'.format(state.step))
            save_train_checkpoint(path, cfg, state, epoch, args, zero1, grid)
            logger.info('Saved mid-epoch checkpoint at "{}"'.format(path))
        if step % 100 == 0:
            whole = whole_model(state.params, cfg, grid, init_pretraining_model)
            if not is_main:
                return
            data = collate_fn([train_dataset[0]])
            logits = forward_logits(whole, cfg, to_device(data, device))
            event_ids = np.array(data['input_ids'][0])
            event_ids[event_ids == -100] = tokenizer.unk_token_id
            ans = tokenizer.decode(logits[0].argmax(dim=-1).cpu().numpy())
            labels = np.array(data['labels'][0])
            labels[labels == -100] = tokenizer.unk_token_id
            logger.info('Input ({} image): "{}"'.format(
                'with' if args.use_image else 'without', tokenizer.decode(event_ids)))
            logger.info('Generated: "{}"'.format(ans))
            logger.info('Labels: "{}"'.format(tokenizer.decode(labels)))

    logger.info('Start training', pad=True)
    start = datetime.now()
    while epoch < args.epochs:
        logger.info('Epoch {}'.format(epoch + 1), pad=True)
        train_loader.set_epoch(epoch)
        state, _ = run_epoch(epoch, state, train_step, train_loader, args.seed,
                             device=device, epochs=args.epochs, logger=logger,
                             callback=callback, log_interval=1, tb_writer=tb_writer,
                             tb_interval=1)
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
    parser.add_argument('--dataset', action='append', nargs=2,
                        metavar=('DATASET_NAME', 'DATASET_PATH'), required=True,
                        help='append a dataset, one of "{}"'.format('", "'.join(DATASET_NAMES)))
    parser.add_argument('--checkpoint_dir', required=True, type=str,
                        help='where to save the checkpoint')
    add_common_model_args(parser)
    parser.add_argument('--epochs', default=40, type=int)
    parser.add_argument('--lr', default=1e-5, type=float)
    parser.add_argument('--num_gen', default=1, type=int)
    parser.add_argument('--num_beams', default=1, type=int)
    parser.add_argument('--continue_training', action='store_true')
    parser.add_argument('--save_every_steps', default=0, type=int,
                        help='also checkpoint every N steps (0 = per-epoch only)')
    parser.add_argument('--validate_loss', action='store_true')
    parser.add_argument('--validate_score', action='store_true')
    add_pretraining_args(parser)
    add_dropout_args(parser)
    add_hardware_args(parser, train=True)
    parser.set_defaults(use_event=True, use_image=True)
    args = parser.parse_args(argv)
    if args.checkpoint is None and args.model_config is None:
        raise ValueError('--model_config and --checkpoint cannot be empty at the same time')
    names = [k for k, _ in args.dataset]
    if len(names) != len(set(names)):
        raise ValueError('repeated datasets')
    args.dataset = {k: v for k, v in args.dataset}
    for name in names:
        if name not in DATASET_NAMES:
            raise ValueError('"{}" is not a valid dataset'.format(name))
    if ('vg_val' in args.dataset or 'vg_train' in args.dataset) and not args.use_image:
        raise ValueError('--no_image can not be set while using VG dataset')
    return args


if __name__ == '__main__':
    main(parse_args())
