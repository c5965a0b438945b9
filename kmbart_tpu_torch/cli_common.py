"""Shared CLI plumbing for the port's entry points.

Counterpart of kmbart_tpu/cli_common.py: the model/data path flags, the
dropout overrides, the loader flags, ``--device`` (``--cpu`` is the JAX
spelling of ``--device cpu``), ``--amp`` (a no-op, as there) and
``--debug_nans``, the model build (either model) with a checkpoint overlay,
and the train checkpoint. The training CLIs also take ``--multihost`` (one
process per card, parallel/distributed.py), ``--zero1`` (parallel/zero1.py)
and ``--sharded_checkpoints`` (checkpoint/sharded.py); tensor, sequence and
pipeline parallelism are not ported yet, and their flags are refused.
"""

import argparse
import json
import os

import torch

from kmbart_tpu_torch.config import MultiModalBartConfig
from kmbart_tpu_torch.device import resolve_device


def add_common_model_args(parser: argparse.ArgumentParser):
    parser.add_argument('--log_dir', default=None, type=str,
                        help='path to output log files, not output to file if not specified')
    parser.add_argument('--model_config', default=None, type=str,
                        help='path to load model config (JSON)')
    parser.add_argument('--checkpoint', default=None, type=str,
                        help='checkpoint dir (params.npz or pytorch_model.bin + config.json)')
    parser.add_argument('--tokenizer_dir', default=os.environ.get('KMBART_TOKENIZER_DIR'),
                        type=str, help='dir with vocab.json + merges.txt (BART BPE assets)')
    parser.add_argument('--no_event', dest='use_event', action='store_false',
                        help='not to use event descriptions')
    parser.add_argument('--no_image', dest='use_image', action='store_false',
                        help='not to use image features')


def add_dropout_args(parser):
    parser.add_argument('--dropout', default=None, type=float,
                        help='dropout rate for the transformer. This overwrites the model config')
    parser.add_argument('--classif_dropout', default=None, type=float,
                        help='dropout rate for the classification layers. This overwrites the model config')
    parser.add_argument('--attention_dropout', default=None, type=float,
                        help='dropout rate for the attention layers. This overwrites the model config')
    parser.add_argument('--activation_dropout', default=None, type=float,
                        help='dropout rate for the activation layers. This overwrites the model config')


def add_hardware_args(parser, train=False):
    parser.add_argument('--device', default='cuda', type=str,
                        help='torch device to run on (cuda, cuda:N or cpu)')
    parser.add_argument('--cpu', dest='device', action='store_const', const='cpu',
                        help='run on host CPU (the same as --device cpu)')
    parser.add_argument('--amp', action='store_true',
                        help='kept for reference-CLI compatibility (bf16 is always on)')
    parser.add_argument('--debug_nans', action='store_true',
                        help="enable autograd's anomaly detection (numerical-fault "
                             "detector; slow, for debugging only)")
    parser.add_argument('--batch_size', type=int, default=64, help='batch size')
    parser.add_argument('--num_workers', type=int, default=0,
                        help='#workers for data loader')
    parser.add_argument('--seed', type=int, default=42, help='seed for initialisation')
    if train:
        parser.add_argument('--grad_accum_steps', default=1, type=int,
                            help='split each batch into this many micro-batches and '
                                 'accumulate gradients before the optimizer update '
                                 '(batch_size must be divisible by it)')
        parser.add_argument('--multihost', action='store_true',
                            help='multi-process data-parallel training: join the process '
                                 'group that KMBART_COORDINATOR_ADDRESS, KMBART_NUM_PROCESSES '
                                 'and KMBART_PROCESS_ID (or torchrun) describe, NCCL on cards '
                                 'and gloo on the CPU, and shard data loading by process; '
                                 '--batch_size is per process (replaces the reference\'s '
                                 'NCCL rendezvous, src/utils.py:9-13)')
        parser.add_argument('--zero1', action='store_true',
                            help='ZeRO stage 1: shard the AdamW moments (2/3 of optimizer '
                                 'memory) over the processes instead of replicating them; '
                                 'params/grads stay plain DP (parallel/zero1.py)')
        parser.add_argument('--sharded_checkpoints', action='store_true',
                            help='save checkpoints as sharded state (torch.distributed.'
                                 'checkpoint, the port\'s own format: each process writes '
                                 'only what it owns). Default is the portable npz format.')
        for flag, kind in _NOT_PORTED:
            parser.add_argument(flag, default=None, **kind,
                                help='not ported yet: tensor, sequence and pipeline '
                                     'parallelism come in a later slice')


# the JAX package's mesh flags with no counterpart yet, refused by
# ``check_parallel_flags`` (kmbart_tpu/cli_common.py:49-75)
_NOT_PORTED = (('--model_parallel', {'type': int}),
               ('--sequence_parallel', {'action': 'store_const', 'const': True}),
               ('--pipeline_stages', {'type': int}),
               ('--pipeline_microbatches', {'type': int}),
               ('--pipeline_span_processes', {'action': 'store_const', 'const': True}))


def check_parallel_flags(parser, args):
    """Refuse, through ``parser.error``, the mesh flags the port has no
    counterpart for (a value that asks for nothing, such as
    ``--model_parallel 1``, passes)."""
    for flag, _ in _NOT_PORTED:
        value = getattr(args, flag[2:], None)
        if value is True or (value is not None and value > 1):
            parser.error(f'{flag} is not supported by the PyTorch port yet: it trains '
                         f'data parallel only (--multihost, --zero1); tensor, sequence '
                         f'and pipeline parallelism come in a later slice')


def add_pretraining_args(parser):
    """The multi-task flags of the root ``pretrain.py`` (:271-289)."""
    parser.add_argument('--no_mrm', dest='mrm_enabled', action='store_false',
                        help='do not use masked region modelling')
    parser.add_argument('--no_ap', dest='ap_enabled', action='store_false',
                        help='do not use attribute prediction (VG only)')
    parser.add_argument('--no_rp', dest='rp_enabled', action='store_false',
                        help='do not use relation prediction')
    parser.add_argument('--max_img_num', type=int, default=30)
    parser.add_argument('--lm_max_len', type=int, default=30)
    parser.add_argument('--mrm_probability', type=float, default=0.2)
    parser.add_argument('--mlm_probability', type=float, default=0.2)
    parser.set_defaults(mrm_enabled=True, rp_enabled=True, ap_enabled=True)


def setup_device(args):
    """``--debug_nans`` turns on ``torch.autograd.set_detect_anomaly``, the
    counterpart of ``jax_debug_nans``; returns the device of ``--device``
    (or ``--cpu``), and with ``--multihost`` joins the process group first
    (the device is then this rank's card)."""
    if getattr(args, 'debug_nans', False):
        torch.autograd.set_detect_anomaly(True)
    if getattr(args, 'multihost', False):
        from kmbart_tpu_torch.parallel.distributed import init_distributed
        return init_distributed(args.device)
    return resolve_device(args.device)


def apply_dropout_overrides(cfg, args):
    """CLI dropout flags override the JSON config."""
    overrides = {name: getattr(args, name) for name in
                 ('dropout', 'attention_dropout', 'classif_dropout', 'activation_dropout')
                 if getattr(args, name, None) is not None}
    return cfg.replace(**overrides) if overrides else cfg


def load_model_config(args):
    """--model_config, else the checkpoint's config.json; then the dropout
    overrides."""
    if args.model_config is not None:
        with open(args.model_config) as f:
            cfg = MultiModalBartConfig.from_dict(json.load(f))
    elif args.checkpoint:
        cfg = MultiModalBartConfig.from_json(os.path.join(args.checkpoint, 'config.json'))
    else:
        raise ValueError('--model_config and --checkpoint cannot be empty at the same time')
    return apply_dropout_overrides(cfg, args)


def build_model_params(args, cfg, init_model_fn, device, logger=None):
    """``init_model_fn(cfg, seed=--seed)`` (``init_conditional_model`` or
    ``init_pretraining_model``) with the checkpoint's weights laid over it
    (partial-load aware; weights the checkpoint lacks keep their
    initialisation), on ``device``. A sharded checkpoint's weights are
    read by ``make_train_state``."""
    from kmbart_tpu_torch.checkpoint.io import load_pretrained
    from kmbart_tpu_torch.checkpoint.sharded import has_sharded_state
    if args.checkpoint and not has_sharded_state(args.checkpoint):
        _, model, report = load_pretrained(args.checkpoint, config=cfg, device=device,
                                           seed=args.seed, init_model_fn=init_model_fn)
        if logger is not None:
            for line in report:
                logger.info(line)
        return model
    return init_model_fn(cfg, seed=args.seed, device=device)


def make_train_state(args, cfg, model, optimizer, device, heads=False, logger=None):
    """(TrainState, first epoch, ZeRO-1 layout or None): the state of a
    fresh run or, with ``--continue_training``, of the checkpoint (npz or
    sharded, written by any number of processes); with ``--zero1`` the
    moments are this rank's parts. A sharded checkpoint also gives the
    weights."""
    from kmbart_tpu_torch.checkpoint.io import load_training_data
    from kmbart_tpu_torch.checkpoint.sharded import (has_sharded_state, load_params_into,
                                                     load_sharded)
    from kmbart_tpu_torch.parallel import distributed
    from kmbart_tpu_torch.training.state import TrainState, model_tensors
    zero1 = None
    if getattr(args, 'zero1', False) and distributed.world_size() > 1:
        from kmbart_tpu_torch.parallel.zero1 import Zero1
        zero1 = Zero1(cfg, model_tensors(model), distributed.world_size(),
                      distributed.rank(), heads=heads)
    state = TrainState.create(model, optimizer)
    epoch = 0
    if args.checkpoint and has_sharded_state(args.checkpoint):
        if logger is not None:
            logger.info('Loading the sharded checkpoint at "{}"'.format(args.checkpoint))
        loaded = load_sharded(args.checkpoint, device=device)
        load_params_into(model, loaded['params'])
        if args.continue_training:
            state = state._replace(opt_state=loaded['opt_state'], step=loaded['step'])
            epoch = loaded['epoch'] + 1
    elif args.continue_training:
        td = load_training_data(args.checkpoint, cfg, device=device)
        epoch = td['epoch'] + 1
        if td['opt_state'] is not None:
            state = state._replace(opt_state=td['opt_state'], step=int(td['step'] or 0))
    if zero1 is not None:
        state = state._replace(opt_state=zero1.shard_state(state.opt_state))
    return state, epoch, zero1


def save_train_checkpoint(path, cfg, state, epoch, args=None, zero1=None):
    """Default: config.json + params.npz + training_data.npz in the JAX
    layout, written by rank 0 (ZeRO-1 moments are gathered first, a
    collective every rank joins). With ``--sharded_checkpoints``:
    config.json + ``sharded_state/``, each rank writing what it owns
    (checkpoint/sharded.py)."""
    from kmbart_tpu_torch.checkpoint.io import save_pretrained, save_training_data
    from kmbart_tpu_torch.parallel import distributed
    from kmbart_tpu_torch.training.state import model_tensors
    main = distributed.is_main_process()
    if getattr(args, 'sharded_checkpoints', False):
        from kmbart_tpu_torch.checkpoint.sharded import save_sharded
        os.makedirs(path, exist_ok=True)
        if main:
            cfg.save_json(os.path.join(path, 'config.json'))
        save_sharded(path, state, epoch, zero1=zero1)
        return
    opt_state = state.opt_state
    if zero1 is not None:
        opt_state = zero1.full_state(opt_state, model_tensors(state.params))
    if main:
        save_pretrained(path, cfg, state.params)
        save_training_data(path, cfg, opt_state=opt_state, epoch=epoch, step=state.step)
    distributed.barrier()
