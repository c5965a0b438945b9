"""The plain reference agrees with the system's own paths on the CPU at the
tiny configuration, computed in float32 (where every cast of the system's
mixed-precision policy is the identity), dropout masks included."""

import json

import numpy as np
import pytest
import torch

from conftest import ROOT, SEED, TINY, tiny_mix
from gpubench.harness import feed
from gpubench.reference import bart as ref


def _cfg(heads):
    from kmbart_tpu_torch.config import MultiModalBartConfig
    with open(f"{ROOT}/gpubench/configs/kmbart-base-{'pretrain' if heads else 'vcg'}.json") as f:
        cfg = dict(json.load(f), **TINY, dtype="float32")
    return cfg, MultiModalBartConfig.from_dict(cfg)



def _model(heads, cfg, cfg_obj):
    from kmbart_tpu_torch.models.conditional import MultiModalBartForConditionalGeneration
    from kmbart_tpu_torch.models.pretraining import MultiModalBartForPreTraining
    model = (MultiModalBartForPreTraining if heads else MultiModalBartForConditionalGeneration)(
        cfg_obj)
    _, P = ref.make_params(cfg, SEED, torch.device("cpu"), heads=heads)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(P[n])
    return model


def _batch(cell, cfg):
    with open(f"{ROOT}/gpubench/workloads/{cell}.json") as f:
        traffic = json.load(f)["traffic"]
    with open(f"{ROOT}/gpubench/traffic/{traffic}.json") as f:
        mix = dict(json.load(f), **tiny_mix(cell))
    b = feed.make_batch(mix, cfg, SEED, 0)
    return {k: torch.as_tensor(v) if v.dtype != np.int64 else torch.as_tensor(v).long()
            for k, v in b.items()}


@pytest.mark.parametrize("heads", [False, True], ids=["vcg", "pretrain"])
def test_training_loss_and_gradients(heads):
    from kmbart_tpu_torch.models.conditional import conditional_loss
    from kmbart_tpu_torch.models.pretraining import pretraining_loss
    cfg, cfg_obj = _cfg(heads)
    cell = "pretrain-nomat-b768" if heads else "vcg-finetune-b1024"
    model = _model(heads, cfg, cfg_obj).train()
    b = _batch(cell, cfg)
    fn = pretraining_loss if heads else conditional_loss
    loss, _ = fn(model, cfg_obj, b, train=True, generator=torch.Generator().manual_seed(7))
    loss.backward()
    _, P = ref.make_params(cfg, SEED, torch.device("cpu"), heads=heads)
    for p in P.values():
        p.requires_grad_(True)
    B = b["input_ids"].shape[0]
    masks = ref.Dropout.draw(cfg["dropout"], torch.Generator().manual_seed(7), ref.dropout_sites(
        cfg, B, b["input_ids"].shape[1], b["decoder_input_ids"].shape[1]), "cpu")
    terms = ref.pretraining_terms if heads else ref.conditional_terms
    want, grads = ref.loss_and_grads(ref.Precision("fp32"), P, cfg, b, terms, masks,
                                     cfg["dropout"], block=3)
    assert abs(float(loss.detach()) - want) <= 1e-5 * abs(want)
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.grad, grads[n], rtol=1e-4, atol=1e-6, msg=n)


def test_decoder_logits():
    from kmbart_tpu_torch.models import bart
    cfg, cfg_obj = _cfg(False)
    model = _model(False, cfg, cfg_obj).eval()
    b = _batch("vcg-finetune-b1024", cfg)
    with torch.no_grad():
        h, _ = bart.forward(model.model, cfg_obj, b["input_ids"], b["image_features"],
                            b["attention_mask"], decoder_input_ids=b["decoder_input_ids"])
        got = bart.lm_logits(model.model, cfg_obj, h)
        _, P = ref.make_params(cfg, SEED, torch.device("cpu"))
        prec, drop = ref.Precision("fp32"), ref.Dropout(0.0)
        enc = ref.encode(prec, P, cfg, b["input_ids"], b["image_features"], b["attention_mask"],
                         drop)
        want = ref.lm_logits(prec, P, ref.decode(prec, P, cfg, b["decoder_input_ids"], enc,
                                               b["attention_mask"], None, drop))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_fp8_control_rounds_operands():
    prec = ref.Precision("fp8")
    x = torch.linspace(-1, 1, 101)
    r = prec.q(x)
    assert (r - x).abs().max() > 1e-3
    assert (r - x).abs().max() < 0.07


@pytest.mark.parametrize("early_stopping", [True, False])
def test_beam_search_serves_the_systems_rows_and_scores(early_stopping, monkeypatch):
    """The reference's beam search serves the system's rows, and scores them
    as the system's final hypothesis pool and as the teacher-forced pass do."""
    from kmbart_tpu_torch.generation import beam
    from kmbart_tpu_torch.generation.api import generate
    from gpubench.reference import beam as ref_beam
    cfg, cfg_obj = _cfg(False)
    cfg["init_std"] = 0.1
    model = _model(False, cfg, cfg_obj).eval()
    b = _batch("vcg-gen-beam5-b2048", cfg)
    K, L = 3, 10
    pools = []
    orig = beam._merge_pool

    def merge_pool(*a, **k):
        out = orig(*a, **k)
        pools.append(out[2])
        return out
    monkeypatch.setattr(beam, "_merge_pool", merge_pool)
    got = generate(model, cfg_obj, {k: b[k].numpy() for k in
                                    ("input_ids", "attention_mask", "image_features")},
                   num_beams=K, max_length=L, early_stopping=early_stopping)
    got_scores = pools[-1][:, 0].tolist()
    _, P = ref.make_params(cfg, SEED, torch.device("cpu"))
    prec = ref.Precision("fp32")
    enc = ref.encode(prec, P, cfg, b["input_ids"], b["image_features"], b["attention_mask"],
                     ref.Dropout(0.0))
    rows, scores = ref_beam.beam_search(prec, P, cfg, enc, b["attention_mask"], K, L,
                                        early_stopping)
    eos = cfg["eos_token_id"]
    for g, r in zip(got, rows):
        end = ref_beam.eos_position(r, eos)
        assert ref_beam.eos_position(g, eos) == end
        assert g[:end + 1].tolist() == r[:end + 1]
    forced, _ = ref_beam.teacher_forced(prec, P, cfg, enc, b["attention_mask"], rows, L, 1.0,
                                        2 * K)
    np.testing.assert_allclose(forced, scores, rtol=1e-5, atol=1e-5)
    # the system's decode step rounds the self-attention's q, K, V and
    # probabilities to bf16 at every dtype (ops/beam_attention.py, as K3
    # reads them), about 1e-3 on a logit here
    np.testing.assert_allclose(got_scores, scores, rtol=0, atol=1e-3)
