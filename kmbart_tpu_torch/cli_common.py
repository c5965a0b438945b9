"""Shared CLI plumbing for the port's entry points.

Counterpart of the parts of kmbart_tpu/cli_common.py that a one-device
PyTorch run needs: the model/data path flags, the dropout overrides, the
loader flags, ``--device`` (``--cpu`` is the JAX spelling of ``--device
cpu``), ``--amp`` (a no-op, as there) and ``--debug_nans``, the model build
(either model) with a checkpoint overlay, and the train checkpoint. The TPU
mesh flags (model,
sequence and pipeline parallelism, multihost, ZeRO-1, sharded checkpoints)
have no counterpart yet.
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
    (or ``--cpu``)."""
    if getattr(args, 'debug_nans', False):
        torch.autograd.set_detect_anomaly(True)
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
    initialisation), on ``device``."""
    from kmbart_tpu_torch.checkpoint.io import load_pretrained
    if args.checkpoint:
        _, model, report = load_pretrained(args.checkpoint, config=cfg, device=device,
                                           seed=args.seed, init_model_fn=init_model_fn)
        if logger is not None:
            for line in report:
                logger.info(line)
        return model
    return init_model_fn(cfg, seed=args.seed, device=device)


def save_train_checkpoint(path, cfg, state, epoch):
    """config.json + params.npz + training_data.npz in the JAX layout."""
    from kmbart_tpu_torch.checkpoint.io import save_pretrained, save_training_data
    save_pretrained(path, cfg, state.params)
    save_training_data(path, cfg, opt_state=state.opt_state, epoch=epoch, step=state.step)
