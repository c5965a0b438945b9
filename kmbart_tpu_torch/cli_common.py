"""Shared CLI plumbing for the port's entry points.

Counterpart of the parts of kmbart_tpu/cli_common.py that a one-device
PyTorch run needs: the model/data path flags, the loader flags, and
``--device`` in place of ``--cpu``. The TPU mesh flags (model/pipeline
parallelism, multihost, ZeRO-1) have no counterpart yet.
"""

import argparse
import os

import torch


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


def add_hardware_args(parser):
    parser.add_argument('--device', default='cuda', type=str,
                        help='torch device to run on (cuda, cuda:N or cpu)')
    parser.add_argument('--batch_size', type=int, default=64, help='batch size')
    parser.add_argument('--num_workers', type=int, default=0,
                        help='#workers for data loader')
    parser.add_argument('--seed', type=int, default=42, help='seed for initialisation')


def resolve_device(name):
    """The requested device; a CUDA device without a card raises (there is
    no quiet switch to the CPU)."""
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'--device {name} requested but no CUDA device is '
                           'available (pass --device cpu to run on the host)')
    return device
