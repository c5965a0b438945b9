"""PyTorch port: the static engine held to ``generate()`` on the padded
batches it ran (its ``record`` hook, and ``chip_smoke.hold_static_engine``,
which the card's serve phase runs), and to the JAX package's engine on the
same requests; the near-tie test the card applies to requests that differ
from ``generate()`` at another batch (``chip_smoke.near_ties``); K2's
inference split, the same at every row count; and ``utils.profiling``
(``trace`` writing a Chrome trace). CPU, fp32; tokens compare exactly.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from kmbart_tpu.models.conditional import init_conditional_params
from kmbart_tpu.serving.engine import GenerationEngine as JaxEngine
from kmbart_tpu_torch.generation import beam
from kmbart_tpu_torch.generation.api import generate
from kmbart_tpu_torch.ops import ffn
from kmbart_tpu_torch.serving.engine import GenerationEngine
from kmbart_tpu_torch.utils import profiling
from tests._torch_port import port_config, port_model
from tests.test_torch_ffn_plan import _assert_partition, _intervals

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

GEN = dict(num_beams=2, max_length=8, early_stopping=True)


@pytest.fixture(scope="module")
def setup(tiny_cfg):
    cfg = tiny_cfg.replace(dtype="float32")
    params = init_conditional_params(jax.random.PRNGKey(0), cfg)
    return cfg, port_config(cfg), params, port_model(params, cfg)


def _requests(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        ids = rng.integers(4, 80, (1, 5 + i % 7)).astype(np.int32)
        ids[:, 1:3] = cfg.img_feat_id
        feats = rng.normal(size=(1, cfg.max_img_num, cfg.image_feature_size)).astype(np.float32)
        reqs.append((ids, feats))
    return reqs


def test_static_engine_rows_equal_generate_on_its_batches(setup):
    cfg, pcfg, params, model = setup
    reqs = _requests(cfg, 11)
    records = []
    engine = GenerationEngine(model, pcfg, max_batch_size=4, encoder_seq_len=16,
                              record=records, **GEN)
    jax_engine = JaxEngine(params, cfg, max_batch_size=4, encoder_seq_len=16, **GEN)
    try:
        futs = [engine.submit(ids, image_features=f) for ids, f in reqs]
        got = [f.result(timeout=120) for f in futs]
        jax_got = [jax_engine.submit(ids, image_features=f).result(timeout=300)
                   for ids, f in reqs]
    finally:
        engine.shutdown()
        jax_engine.shutdown()
    assert len(records) >= 3 and sum(len(r[3]) for r in records) == 11
    assert all(ids.shape[0] in engine.batch_buckets for ids, _, _, _ in records)
    held, where, traces = chip_smoke.hold_static_engine(torch, model, pcfg, records,
                                                        torch.device("cpu"), **GEN)
    assert held == 11 and len(traces) == len(records)
    assert traces[0][-1].keys() == {"final_scores"} and "cand_idx" in traces[0][0]
    for a, b in zip(got, jax_got):
        np.testing.assert_array_equal(a, np.asarray(b))
    # a request answered otherwise than its batch's generate() raises
    ids, mask, feats, futures = records[0]

    class Wrong:
        def __init__(self, fut):
            self.out = fut.result().copy()
            self.out[0, -1] += 1

        def result(self):
            return self.out

    with pytest.raises(AssertionError, match="differ from generate"):
        chip_smoke.hold_static_engine(torch, model, pcfg,
                                      [(ids, mask, feats, [Wrong(futures[0])] + futures[1:])],
                                      torch.device("cpu"), **GEN)

    # against generate() on all 11 at once: equal on the CPU, so no divergence
    t = torch.as_tensor
    beam.STEP_TRACE = ref_trace = []
    try:
        padded = np.full((11, 16), pcfg.pad_token_id, np.int32)
        for i, (r, _) in enumerate(reqs):
            padded[i, :r.shape[1]] = r[0]
        batch = {"input_ids": t(padded), "attention_mask": t((padded != pcfg.pad_token_id)
                                                             .astype(np.int32)),
                 "image_features": t(np.concatenate([f for _, f in reqs]))}
        ref = generate(model, pcfg, batch, trim=False, **GEN)
    finally:
        beam.STEP_TRACE = None
    report = chip_smoke.near_ties(np, np.concatenate(got), ref, [where[id(f)] for f in futs],
                                  traces, ref_trace)
    assert report == []


def _trace(cand_idx, rows, final):
    """One traced call of one sample (K = 1): per step its candidates and
    its row scores {flat index: score}."""
    steps = [{"cand_idx": torch.tensor([c]), "cand_scores": torch.zeros(1, len(c)),
              "row_idx": torch.tensor([list(r)]), "row_scores": torch.tensor([list(r.values())])}
             for c, r in zip(cand_idx, rows)]
    return steps + [{"final_scores": torch.tensor([final])}]


def test_near_ties_accepts_a_flip_within_the_noise_and_rejects_others():
    same = {5: -1.0, 6: -1.02, 7: -3.0}
    a = _trace([[5, 6], [5, 6]], [same, {5: -2.0, 6: -2.01, 7: -4.0}], [-2.0, -2.01])
    # step 2: the two calls order 5 and 6 the other way; their scores of the
    # same candidates differ by up to 0.02, the gap is 0.01; in ``far`` they
    # differ by 1.01, which is no rounding
    b = _trace([[5, 6], [6, 5]], [same, {5: -2.01, 6: -1.99, 7: -4.0}], [-1.99, -2.01])
    report = chip_smoke.near_ties(np, np.array([[0, 5, 5]]), np.array([[0, 5, 6]]), [(0, 0)],
                                  [a], b)
    assert report[0]["step"] == 2 and report[0]["near_tie"]
    assert report[0]["gap"] <= report[0]["noise"] < 0.03
    far = _trace([[5, 6], [6, 5]], [same, {5: -2.0, 6: -1.0, 7: -4.0}], [-1.0, -2.0])
    with pytest.raises(AssertionError, match="near-tie"):
        chip_smoke.near_ties(np, np.array([[0, 5, 5]]), np.array([[0, 5, 6]]), [(0, 0)],
                             [a], far)
    # equal candidates at every step: the final hypotheses decide
    fin = _trace([[5, 6], [5, 6]], [same, {5: -2.0, 6: -2.01, 7: -4.0}], [-2.0, -1.995])
    report = chip_smoke.near_ties(np, np.array([[0, 5, 5]]), np.array([[0, 5, 6]]), [(0, 0)],
                                  [a], fin)
    assert report[0]["step"] == "final" and report[0]["near_tie"]


@pytest.mark.parametrize("sms", [132, 114])
def test_k2_inference_split_is_the_same_at_every_row_count(sms):
    """The second GEMM of an inference call walks its depth in the same
    parts at 8 samples' decode step as at 160 samples' and at an encoder's
    rows, so a row's fp32 sums are added in the same order at every N; the
    training forward keeps the split that fills the card."""
    plans = [ffn.plan(n, 768, 3072, sms, invariant=True)[1]
             for n in (40, 160, 320, 560, 800, 4608, 9216)]
    assert {(g.splits, g.kper) for g in plans} == {(6, 8)}
    for g in plans:
        _assert_partition(_intervals(g.splits, g.kper * ffn.K_TILE, g.depth), g.depth)
        assert 1 <= g.ctas <= sms
    assert ffn.plan(37, 32, 64, sms, invariant=True)[1].splits == 1
    adaptive = {ffn.plan(n, 768, 3072, sms)[1].splits for n in (160, 560)}
    assert len(adaptive) == 2        # what the decode step used to do


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8)).sum()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "prof" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
