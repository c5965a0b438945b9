"""Shared CLI plumbing for the port's entry points.

Counterpart of kmbart_tpu/cli_common.py: the model/data path flags, the
dropout overrides, the loader flags, ``--device`` (``--cpu`` is the JAX
spelling of ``--device cpu``), ``--amp`` (a no-op, as there) and
``--debug_nans``, the model build (either model) with a checkpoint overlay,
and the train checkpoint. The training CLIs also take ``--multihost`` (one
process per card, parallel/distributed.py), ``--zero1`` (parallel/zero1.py),
``--sharded_checkpoints`` (checkpoint/sharded.py) and the mesh flags of
tensor, sequence and pipeline parallelism (``--model_parallel``,
``--sequence_parallel``, ``--pipeline_stages``, ``--pipeline_microbatches``,
``--pipeline_span_processes``): ``make_grid_from_args`` lays the processes
out as ``make_mesh_from_args`` lays out the devices (parallel/mesh.py), with
its errors.
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
        parser.add_argument('--model_parallel', default=1, type=int,
                            help='tensor-parallel degree (grid = data x model; needs '
                                 '--multihost, one process a device, as data parallelism '
                                 'does): Megatron column/row-parallel attention and FFN, '
                                 'parallel/tp.py')
        parser.add_argument('--sequence_parallel', action='store_true',
                            help='with --model_parallel>1: shard the LN/dropout regions '
                                 'along the sequence dim (Megatron-SP; parallel/sp.py): '
                                 'same math, less replicated activation work/memory per '
                                 'TP shard')
        parser.add_argument('--pipeline_stages', default=1, type=int,
                            help='pipeline-parallel stage count (GPipe schedule, '
                                 'parallel/pp.py; needs --multihost; grid = data x stage, '
                                 'or data x stage x model with --model_parallel>1). Layer '
                                 'counts must divide it.')
        parser.add_argument('--pipeline_microbatches', default=0, type=int,
                            help='microbatches per pipeline (0 = stage count). The '
                                 'per-data-shard batch must be divisible by it; more '
                                 'microbatches shrink the GPipe bubble.')
        parser.add_argument('--pipeline_span_processes', action='store_true',
                            help='with --pipeline_stages>1: lay the stage axis outermost, '
                                 'each stage a contiguous block of processes (the '
                                 'DCN-pipeline layout). Processes sharing data shards load '
                                 'identical batches automatically.')


def make_grid_from_args(args):
    """The process grid of ``--multihost`` (parallel/mesh.py), or None for
    one process: the counterpart of kmbart_tpu/cli_common.py:296-319
    ``make_mesh_from_args``, with its errors, and with its default of
    ``KMBART_NO_FUSED_FFN=1`` under tensor or pipeline parallelism (K2 adds
    fc2's bias inside its body, once per rank on a row-parallel shard)."""
    mp = max(1, args.model_parallel)
    stages = max(1, args.pipeline_stages)
    if mp > 1 or stages > 1:
        os.environ.setdefault('KMBART_NO_FUSED_FFN', '1')
        if stages > 1 and args.sequence_parallel:
            raise ValueError('--pipeline_stages cannot be combined with '
                             '--sequence_parallel')
        if not args.multihost:
            raise ValueError('--model_parallel and --pipeline_stages need --multihost: the '
                             'port runs one process a device')
    if not args.multihost:
        return None
    from kmbart_tpu_torch.parallel.mesh import Grid
    return Grid(model_parallel=mp, stages=stages,
                span_processes=args.pipeline_span_processes and stages > 1,
                sequence_parallel=args.sequence_parallel)


def pipeline_microbatches(args):
    stages = max(1, args.pipeline_stages)
    return args.pipeline_microbatches if args.pipeline_microbatches > 0 else stages


def validate_batch_layout(args, n_data):
    """The train step splits each batch by grad_accum_steps first, so every
    accumulation micro-batch (batch_size / G) must itself divide the
    per-step divisor ``n_data`` (the pipeline's micro-batches under
    --pipeline_stages; a process feeds one data shard)."""
    G = max(1, args.grad_accum_steps)
    if args.batch_size % (G * n_data):
        raise ValueError(
            f'batch_size={args.batch_size} must be divisible by '
            f'grad_accum_steps={G} x per-step batch divisor {n_data} '
            f'(data shards, x pipeline microbatches under --pipeline_stages)')


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


def _local(full, cfg, grid):
    """A whole {name: tensor} -> this rank's parts (the identity off a
    split model)."""
    if grid is None or not grid.parallel:
        return full
    from kmbart_tpu_torch.parallel.tp import shard_params
    return shard_params(full, cfg, grid)


def make_train_state(args, cfg, model, optimizer, device, heads=False, logger=None,
                     grid=None):
    """(TrainState, first epoch, ZeRO-1 layout or None): the state of a
    fresh run or, with ``--continue_training``, of the checkpoint (npz or
    sharded, written by any number of processes); with ``--zero1`` the
    moments are this rank's parts. A sharded checkpoint also gives the
    weights. ``model`` is this rank's part of the model under a split
    ``grid`` (parallel/tp.py ``shard_model_``), and the checkpoint's whole
    tensors are cut to it."""
    from kmbart_tpu_torch.checkpoint.io import load_training_data
    from kmbart_tpu_torch.checkpoint.sharded import (has_sharded_state, load_params_into,
                                                     load_sharded)
    from kmbart_tpu_torch.parallel import distributed
    from kmbart_tpu_torch.training.state import TrainState, model_tensors
    zero1 = None
    data = grid.data if grid is not None else distributed.world_axis()
    if getattr(args, 'zero1', False) and data.size > 1:
        from kmbart_tpu_torch.parallel.zero1 import Zero1
        zero1 = Zero1(cfg, model_tensors(model), data.size, data.index, heads=heads, grid=grid)
    state = TrainState.create(model, optimizer)
    epoch = 0
    if args.checkpoint and has_sharded_state(args.checkpoint):
        if logger is not None:
            logger.info('Loading the sharded checkpoint at "{}"'.format(args.checkpoint))
        loaded = load_sharded(args.checkpoint, device=device)
        load_params_into(model, _local(loaded['params'], cfg, grid))
        if args.continue_training:
            opt = loaded['opt_state']
            opt = opt._replace(mu=_local(opt.mu, cfg, grid), nu=_local(opt.nu, cfg, grid))
            state = state._replace(opt_state=opt, step=loaded['step'])
            epoch = loaded['epoch'] + 1
    elif args.continue_training:
        td = load_training_data(args.checkpoint, cfg, device=device)
        epoch = td['epoch'] + 1
        if td['opt_state'] is not None:
            opt = td['opt_state']
            opt = opt._replace(mu=_local(opt.mu, cfg, grid), nu=_local(opt.nu, cfg, grid))
            state = state._replace(opt_state=opt, step=int(td['step'] or 0))
    if zero1 is not None:
        state = state._replace(opt_state=zero1.shard_state(state.opt_state))
    return state, epoch, zero1


def whole_tensors(tensors, cfg, grid):
    """This rank's {name: part} -> {name: whole tensor} on every rank (the
    identity off a split model); a collective under a split ``grid``."""
    if grid is None or not grid.parallel:
        return tensors
    from kmbart_tpu_torch.checkpoint.io import _has_heads, _leaf_map
    from kmbart_tpu_torch.parallel.tp import gather_params
    names = list(dict.fromkeys(n for n, *_ in _leaf_map(cfg, _has_heads(tensors))))
    return gather_params(tensors, cfg, grid, names)


def whole_model(model, cfg, grid, init_model_fn):
    """The whole model from this rank's part, on rank 0 (None elsewhere): a
    collective under a split ``grid`` (every rank calls it); the model
    itself otherwise. The trainers' decoding under pipeline stages, which
    runs on rank 0 alone as in the JAX package; without stages every rank
    decodes on its own part (``generate(..., grid=grid)``)."""
    from kmbart_tpu_torch.parallel import distributed
    from kmbart_tpu_torch.checkpoint.sharded import load_params_into
    from kmbart_tpu_torch.training.state import model_tensors
    if grid is None or not grid.parallel:
        return model
    full = whole_tensors(model_tensors(model), cfg, grid)
    if not distributed.is_main_process():
        return None
    device = next(iter(full.values())).device
    whole = init_model_fn(cfg, device=device)
    load_params_into(whole, full)
    return whole


def save_train_checkpoint(path, cfg, state, epoch, args=None, zero1=None, grid=None):
    """Default: config.json + params.npz + training_data.npz in the JAX
    layout, written by rank 0 (ZeRO-1 moments and the parts of a split
    model are gathered first, a collective every rank joins: the
    counterpart of ``host_replicated``, kmbart_tpu/cli_common.py:204). With
    ``--sharded_checkpoints``: config.json + ``sharded_state/``, each rank
    writing what it owns (checkpoint/sharded.py)."""
    from kmbart_tpu_torch.checkpoint.io import save_pretrained, save_training_data
    from kmbart_tpu_torch.parallel import distributed
    from kmbart_tpu_torch.training.state import model_tensors
    main = distributed.is_main_process()
    if getattr(args, 'sharded_checkpoints', False):
        from kmbart_tpu_torch.checkpoint.sharded import save_sharded
        os.makedirs(path, exist_ok=True)
        if main:
            cfg.save_json(os.path.join(path, 'config.json'))
        save_sharded(path, state, epoch, zero1=zero1, grid=grid)
        return
    tensors = model_tensors(state.params)
    opt_state = state.opt_state
    if zero1 is not None:
        opt_state = zero1.full_state(opt_state, tensors)
    params = whole_tensors(tensors, cfg, grid)
    if grid is not None and grid.parallel:
        opt_state = opt_state._replace(mu=whole_tensors(opt_state.mu, cfg, grid),
                                       nu=whole_tensors(opt_state.nu, cfg, grid))
    if main:
        save_pretrained(path, cfg, params)
        save_training_data(path, cfg, opt_state=opt_state, epoch=epoch, step=state.step)
    distributed.barrier()
