"""Work counts against FLOPs and bytes worked out by hand at small shapes."""

import os

import torch

from conftest import ROOT
from gpubench.harness.peaks import PEAKS, bound_s
from gpubench.harness.registry import Registry
from gpubench.work import model

REG = Registry(ROOT)


def test_ffn_forward_and_backward():
    ffn = REG.work("ffn")
    N, D, F = 10, 4, 8
    x = torch.zeros(2, 5, D)
    w1 = torch.zeros(F, D)
    call = ffn.capture((x, w1, None, None, None), {}, grad=False)
    # two products of N·D·F multiply-adds; x and y in bf16, two fp32
    # weights and two fp32 biases
    assert ffn.count(call) == {"bf16_flops": 2 * 2 * N * D * F,
                               "nbytes": 2 * N * D + 2 * N * D + 4 * (D * F + F * D + F + D)}
    call["grad"] = True
    w = ffn.count(call)
    assert w["bf16_flops"] == 6 * 2 * N * D * F
    assert w["nbytes"] == 2 * (2 * 2 * N * D + 4 * (2 * D * F + F + D))


def test_lm_ce():
    lm = REG.work("lm_ce")
    N, D, V = 6, 4, 10
    trunk = torch.nn.Module()
    trunk.shared = torch.nn.Embedding(V, D)
    call = lm.capture((trunk, None, torch.zeros(2, 3, D), None, None), {}, grad=True)
    w = lm.count(call)
    assert w["bf16_flops"] == 3 * 2 * N * D * V
    # h (bf16), W (fp32), labels (int64), bias (fp32); dh (bf16), dW (fp32)
    assert w["nbytes"] == 2 * N * D + 4 * V * D + 8 * N + 4 * V + 2 * N * D + 4 * V * D


def test_beam_attention_counts_the_rows_the_ancestry_reads():
    ba = REG.work("beam_attn")
    B, K, T, D = 1, 2, 4, 8
    q = torch.zeros(B * K, D)
    cache = torch.zeros(B, K, T, D)
    # both beams descend through slot 0 at positions 0 and 1, their own at 2
    anc = torch.tensor([[0, 0, 0, 0], [0, 0, 1, 0]], dtype=torch.int32)
    call = ba.capture((q, cache, cache, anc, 2), {"num_beams": K, "num_heads": 2}, False)
    w = ba.count(call)
    rows, n = 4, 3            # (slot, position) pairs: (0,0) (0,1) (0,2) (1,2)
    assert w["bf16_flops"] == 4 * B * K * n * D
    assert w["nbytes"] == 2 * B * K * D + 4 * B * K * n + 4 * B * K * D + 2 * 2 * rows * D


def test_model_flops_by_hand():
    cfg = {"d_model": 4, "encoder_ffn_dim": 8, "decoder_ffn_dim": 8, "encoder_layers": 1,
           "decoder_layers": 1, "vocab_size": 10, "max_img_num": 2, "image_feature_size": 3,
           "num_labels": 5, "num_attributes": 3, "num_relations": 2}
    D, F, V = 4, 8, 10
    enc = 2 * 2 * 3 * D + (8 * 5 * D * D + 4 * 25 * D + 4 * 5 * D * F)
    assert model.encoder_flops(cfg, 5) == enc
    dec = (8 * 3 * D * D + 4 * 6 * D + 4 * 3 * D * D + 4 * 5 * D * D + 4 * 3 * 5 * D
           + 4 * 3 * D * F) + 2 * 3 * D * V
    assert model.decoder_flops(cfg, 3, 5) == dec
    mix = {"batch": 2, "enc_len": 5, "dec_len": 3}
    assert model.train_step_flops(cfg, mix) == 3.0 * 2 * (enc + dec)
    gen = {"batch": 2, "enc_len": 5, "generate": {"num_beams": 3}}
    step = lambda s: 8 * D * D + 4 * (s + 1) * D + 4 * D * D + 4 * 5 * D + 4 * D * F + 2 * D * V
    assert model.generate_flops(cfg, gen, 2) == 2 * enc + 2 * 4 * 5 * D * D \
        + 2 * 3 * (step(0) + step(1))


def test_bound_takes_the_larger_of_operations_and_bytes():
    p = PEAKS["NVIDIA H100 80GB HBM3"]
    assert bound_s(p, bf16_flops=989e12) == 1.0
    assert bound_s(p, bf16_flops=1.0, nbytes=3.35e12) == 1.0


def test_every_op_has_targets():
    for name in os.listdir(os.path.join(ROOT, "gpubench", "work")):
        if name.endswith(".py") and name not in ("__init__.py", "model.py"):
            op = REG.work(name[:-3])
            assert op.TARGETS and callable(op.capture) and callable(op.count)
