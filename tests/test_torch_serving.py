"""PyTorch port, serving: K3's ring mode, the continuous pool, the static
engine and the HTTP front end, on the CPU at fp32 (counterparts of
tests/test_continuous.py and tests/test_serving.py).

The pool's load-bearing property is the JAX package's: a sample's beam
decode does not depend on the other slots, so every slot's harvested output
equals the offline ``generate()`` for that sample alone, token for token,
whatever tick it was admitted at and whether its slot was used before. The
port's pool is held to the port's ``generate()`` and to the JAX package's.
"""

import json
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kmbart_tpu.config import MultiModalBartConfig
from kmbart_tpu.generation.api import generate as jax_generate
from kmbart_tpu.models.conditional import init_conditional_params
from kmbart_tpu.ops import pallas_beam_attention as jba
from kmbart_tpu_torch.generation.api import generate
from kmbart_tpu_torch.ops import beam_attention as ba
from kmbart_tpu_torch.serving import continuous
from kmbart_tpu_torch.serving.continuous import (ContinuousGenerationEngine, build_pool_fns,
                                                 init_pool_state)
from kmbart_tpu_torch.serving.engine import DEFAULT_BATCH_BUCKETS, GenerationEngine
from kmbart_tpu_torch.serving.http import serve
from tests._torch_port import port_config, port_model, to_jax

K, L, E = 2, 8, 12


# ---------------------------------------------------------------------------
# K3's ring mode (plain version) against the JAX ring mask + reference
# ---------------------------------------------------------------------------

RING_CASES = {  # (B, K, T, H, hd, ring_col, valid_counts)
    "wraps": (4, 3, 8, 2, 8, 2, [5, 8, 3, 7]),        # windows past column 0
    "valid-1": (3, 2, 8, 2, 8, 5, [1, 1, 1]),         # the first step after admit
    "valid-T": (3, 2, 8, 2, 16, 4, [8, 8, 8]),        # every column, ring_col anywhere
    "valid-T-col-last": (2, 3, 6, 4, 8, 5, [6, 6]),
    "mixed": (5, 4, 10, 2, 8, 0, [1, 10, 4, 2, 9]),
}


@pytest.mark.parametrize("case", list(RING_CASES.values()), ids=list(RING_CASES))
def test_k3_ring_plain_matches_jax(case):
    """The ring window read through stale ancestry: within 1e-5 of
    build_selection_mask_ring + beam_gather_attention_reference (the same
    bf16 roundings of q, K, V and p; fp32 sums in another order)."""
    B, Kb, T, H, hd, ring_col, valid = case
    D = H * hd
    rng = np.random.default_rng(sum(valid))
    q = (rng.normal(size=(B * Kb, D)) * hd ** -0.5).astype(np.float32)
    kc = rng.normal(size=(B, Kb, T, D)).astype(np.float32)
    vc = rng.normal(size=(B, Kb, T, D)).astype(np.float32)
    anc = rng.integers(0, Kb, size=(B * Kb, T)).astype(np.int32)
    valid = np.asarray(valid, np.int32)
    sel = jba.build_selection_mask_ring(jax.numpy.asarray(anc), Kb, ring_col,
                                        jax.numpy.asarray(valid), H)
    want = np.asarray(jba.beam_gather_attention_reference(
        to_jax(q), to_jax(kc), to_jax(vc), sel, num_beams=Kb, num_heads=H))
    args = [torch.from_numpy(a) for a in (q, kc, vc, anc)]
    kw = dict(num_beams=Kb, num_heads=H, valid_counts=torch.from_numpy(valid))
    got = ba.beam_gather_attention_plain(*args, ring_col, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the wrapper takes the plain version on the CPU
    np.testing.assert_array_equal(ba.beam_gather_attention(*args, ring_col, **kw).numpy(),
                                  got.numpy())
    # the mask itself: the JAX one-hot, entry for entry
    np.testing.assert_array_equal(
        ba.build_selection_mask_ring(args[3], Kb, ring_col, kw["valid_counts"], H)
        .float().numpy(), np.asarray(sel, np.float32))


def test_k3_ring_is_the_rotated_scalar_window():
    """A window of n columns ending at ring_col reads what the scalar mode
    reads at cache_index n - 1 once the columns are rotated to [0, n)."""
    B, Kb, T, H, hd, ring_col = 3, 2, 8, 2, 8, 1
    D = H * hd
    rng = np.random.default_rng(9)
    q = torch.from_numpy((rng.normal(size=(B * Kb, D)) * hd ** -0.5).astype(np.float32))
    kc = torch.from_numpy(rng.normal(size=(B, Kb, T, D)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(B, Kb, T, D)).astype(np.float32))
    anc = torch.from_numpy(rng.integers(0, Kb, size=(B * Kb, T)).astype(np.int32))
    valid = torch.tensor([1, 4, 8], dtype=torch.int32)
    kw = dict(num_beams=Kb, num_heads=H)
    ring = ba.beam_gather_attention_plain(q, kc, vc, anc, ring_col, valid_counts=valid, **kw)
    for b, n in enumerate(valid.tolist()):
        cols = [(ring_col - n + 1 + a) % T for a in range(n)]
        rows = slice(b * Kb, (b + 1) * Kb)
        scalar = ba.beam_gather_attention_plain(
            q[rows], kc[b:b + 1, :, cols], vc[b:b + 1, :, cols], anc[rows][:, cols], n - 1,
            **kw)
        torch.testing.assert_close(ring[rows], scalar, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the pool against generate()
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pool_setup():
    cfg = MultiModalBartConfig(
        vocab_size=300, d_model=64, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_position_embeddings=64, image_feature_size=20, max_img_num=4, dtype="float32")
    params = init_conditional_params(jax.random.PRNGKey(0), cfg)
    return cfg, port_config(cfg), params, port_model(params, cfg)


def _requests(cfg, seed, n):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        ids = rng.integers(4, cfg.vocab_size - 10, (1, E)).astype(np.int32)
        feats = rng.normal(size=(1, cfg.max_img_num, cfg.image_feature_size)).astype(np.float32)
        reqs.append((ids, np.ones((1, E), np.int32), feats))
    return reqs


def _references(setup, req):
    """The port's generate() and the JAX package's, which must agree."""
    cfg, pcfg, params, model = setup
    ids, mask, feats = req
    batch = {"input_ids": ids, "attention_mask": mask, "image_features": feats}
    kw = dict(max_length=L, num_beams=K, early_stopping=True, trim=False)
    ours = generate(model, pcfg, batch, **kw)
    np.testing.assert_array_equal(ours, np.asarray(jax_generate(params, cfg, batch, **kw)))
    return ours


def _pool(setup, B, chunk_steps):
    _, pcfg, _, model = setup
    pool = dict(pool_size=B, num_beams=K, max_length=L, encoder_seq_len=E)
    fns = build_pool_fns(model, pcfg, chunk_steps=chunk_steps, **pool)
    return fns, init_pool_state(model, pcfg, **pool)


def _admit_one(admit, state, slot, req):
    ids, mask, feats = (torch.from_numpy(a) for a in req)
    return admit(state, [slot], ids.long(), mask.long(), feats)


def _harvest(harvest, state):
    ready, out, _ = harvest(state)
    return ready.numpy(), out.numpy().astype(np.int32)


def test_pool_matches_generate_same_tick(pool_setup):
    B = 3
    (step_chunk, admit, harvest), state = _pool(pool_setup, B, chunk_steps=3)
    reqs = _requests(pool_setup[0], 0, B)
    for i, r in enumerate(reqs):
        _admit_one(admit, state, i, r)
    for _ in range(4):  # 12 ticks >= L - 1
        step_chunk(state)
    ready, out = _harvest(harvest, state)
    assert ready.all()
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(out[i], _references(pool_setup, r),
                                      err_msg=f"slot {i}")


def test_pool_matches_generate_staggered(pool_setup):
    """Admitted at different ticks (so windows wrap the ring), then a freed
    slot REUSED: every output still equals the solo generate()."""
    B = 2
    (step_chunk, admit, harvest), state = _pool(pool_setup, B, chunk_steps=2)
    reqs = _requests(pool_setup[0], 1, 3)
    _admit_one(admit, state, 0, reqs[0])
    step_chunk(state)                        # slot 0 at depth 3
    _admit_one(admit, state, 1, reqs[1])     # slot 1 joins late
    done = {}
    for _ in range(12):
        step_chunk(state)
        ready, out = _harvest(harvest, state)
        for i in range(B):
            if ready[i] and i not in done:
                done[i] = out[i]
        if len(done) == B:
            break
    assert len(done) == B
    np.testing.assert_array_equal(done[0], _references(pool_setup, reqs[0]))
    np.testing.assert_array_equal(done[1], _references(pool_setup, reqs[1]))
    # reuse slot 0 for a third request while slot 1 sits finished
    _admit_one(admit, state, 0, reqs[2])
    for _ in range(6):
        step_chunk(state)
    ready, out = _harvest(harvest, state)
    assert ready[0]
    np.testing.assert_array_equal(out[0], _references(pool_setup, reqs[2]))


def test_pool_inactive_slots_are_inert(pool_setup):
    """Stepping a pool with empty slots neither faults nor marks them
    ready, and leaves their bookkeeping as it was."""
    B = 2
    (step_chunk, admit, harvest), state = _pool(pool_setup, B, chunk_steps=2)
    req = _requests(pool_setup[0], 2, 1)[0]
    _admit_one(admit, state, 1, req)
    for _ in range(6):
        step_chunk(state)
    ready, out = _harvest(harvest, state)
    assert not ready[0] and ready[1]
    assert int(state["cur_len"][0]) == 0 and int(state["hyp_count"][0]) == 0
    np.testing.assert_array_equal(out[1], _references(pool_setup, req))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_setup(tiny_cfg):
    cfg = tiny_cfg.replace(dtype="float32")
    params = init_conditional_params(jax.random.PRNGKey(0), cfg)
    return cfg, port_config(cfg), params, port_model(params, cfg)


def _padded(cfg, ids, width=16):
    padded = np.full((ids.shape[0], width), cfg.pad_token_id, np.int32)
    padded[:, :ids.shape[1]] = ids
    return {"input_ids": padded, "attention_mask": (padded != cfg.pad_token_id).astype(np.int32)}


def test_engine_batches_and_resolves(engine_setup, np_rng):
    cfg, pcfg, params, model = engine_setup
    engine = GenerationEngine(model, pcfg, max_batch_size=8, encoder_seq_len=16,
                              max_length=8, num_beams=2, early_stopping=True)
    try:
        futures = []
        for i in range(5):
            ids = np_rng.integers(4, 80, (1, 6 + i)).astype(np.int32)
            futures.append((ids, engine.submit(ids)))
        for ids, fut in futures:
            out = fut.result(timeout=120)
            assert out.shape == (1, 8) and out[0, 0] == cfg.decoder_start_token_id
        # a coalesced request equals its solo generate(), the JAX package's too
        ids0, fut0 = futures[0]
        kw = dict(max_length=8, num_beams=2, early_stopping=True, trim=False)
        solo = generate(model, pcfg, _padded(cfg, ids0), **kw)
        np.testing.assert_array_equal(fut0.result(), solo)
        np.testing.assert_array_equal(
            solo, np.asarray(jax_generate(params, cfg, _padded(cfg, ids0), **kw)))
    finally:
        engine.shutdown()


def test_engine_multirow_and_errors(engine_setup, np_rng):
    cfg, pcfg, _, model = engine_setup
    engine = GenerationEngine(model, pcfg, max_batch_size=8, encoder_seq_len=16, max_length=6)
    try:
        ids = np_rng.integers(4, 80, (3, 7)).astype(np.int32)
        assert engine.submit(ids).result(timeout=120).shape == (3, 6)
        with pytest.raises(ValueError):
            engine.submit(np.full((9, 6), 5, np.int32))
        # a request that cannot run fails through its future; the engine serves on
        bad = engine.submit(ids, image_features=np.zeros((3, 2, 5), np.float32))
        with pytest.raises(Exception):
            bad.result(timeout=120)
        assert engine.submit(ids[:1]).result(timeout=120).shape == (1, 6)
    finally:
        engine.shutdown()


def test_engine_host_results_with_features(engine_setup, np_rng):
    """Futures resolve to host numpy arrays; ROI features ride along."""
    cfg, pcfg, _, model = engine_setup
    engine = GenerationEngine(model, pcfg, max_batch_size=4, encoder_seq_len=16, max_length=6)
    try:
        ids = np_rng.integers(4, 80, (2, 7)).astype(np.int32)
        ids[:, 1:3] = cfg.img_feat_id
        feats = np_rng.normal(size=(2, cfg.max_img_num, cfg.image_feature_size)
                              ).astype(np.float32)
        out = engine.submit(ids, image_features=feats).result(timeout=120)
        assert isinstance(out, np.ndarray) and out.shape == (2, 6)
    finally:
        engine.shutdown()


def test_bucket_selection():
    """A batch pads to the smallest bucket that holds it, capped by
    max_batch_size; the default tuple is the JAX package's."""
    eng = GenerationEngine.__new__(GenerationEngine)
    eng.max_batch_size = 112
    eng.batch_buckets = (8, 16, 32, 64, 96, 112)
    assert [eng._bucket_for(n) for n in (1, 8, 9, 70, 97, 300)] == [8, 8, 16, 96, 112, 112]
    assert DEFAULT_BATCH_BUCKETS == (8, 16, 32, 48, 64, 80, 96, 112, 160)
    assert tuple(b for b in DEFAULT_BATCH_BUCKETS if b <= 40) == (8, 16, 32)


def test_engine_under_load(engine_setup, np_rng):
    """A burst far larger than one batch drains fully: every future
    resolves with its own rows' shape, and rows never cross requests."""
    cfg, pcfg, _, model = engine_setup
    engine = GenerationEngine(model, pcfg, max_batch_size=8, encoder_seq_len=16,
                              max_length=6, num_beams=1, max_wait_ms=2.0)
    try:
        futures = []
        for i in range(40):
            n = 1 + (i % 3)
            ids = np_rng.integers(4, 80, (n, 5 + (i % 4))).astype(np.int32)
            futures.append((n, engine.submit(ids)))
        for n, fut in futures:
            out = fut.result(timeout=300)
            assert out.shape == (n, 6) and (out[:, 0] == cfg.decoder_start_token_id).all()
    finally:
        engine.shutdown()


def test_http_server(engine_setup, np_rng, toy_assets):
    """Health, a text request, a token-id request, and a bad request (400,
    the server serving on) over HTTP on 127.0.0.1."""
    from kmbart_tpu_torch.data.tokenization import ConditionTokenizer

    _, pcfg, _, model = engine_setup
    engine = GenerationEngine(model, pcfg, tokenizer=ConditionTokenizer(assets_dir=toy_assets),
                              max_batch_size=4, encoder_seq_len=24, max_length=8)
    server = serve(engine, port=0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(payload):
        req = urllib.request.Request(base + "/generate", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        assert len(post({"text": "a person waits"})["generations"]) == 1
        assert len(post({"input_ids": np_rng.integers(4, 80, (2, 6)).tolist()})
                   ["generations"]) == 2
        with pytest.raises(urllib.error.HTTPError) as err:
            post({"bogus": 1})
        assert err.value.code == 400
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
    finally:
        server.shutdown()
        engine.shutdown()


def _continuous(model, pcfg, **kw):
    opts = dict(pool_size=4, encoder_seq_len=16, chunk_steps=2, num_beams=2, max_length=8,
                early_stopping=True, admit_width=8)
    opts.update(kw)
    return ContinuousGenerationEngine(model, pcfg, **opts)


def _solo(model, pcfg, cfg, ids):
    return generate(model, pcfg, _padded(cfg, ids), max_length=8, num_beams=2,
                    early_stopping=True, trim=False)


def test_continuous_engine_resolves_and_matches(engine_setup, np_rng):
    """submit -> future; every output equals the solo generate() (the
    max_length width), through slot turnover; a multi-row submit re-joins.
    admit_width > pool_size: the drain admits no more than the free slots."""
    cfg, pcfg, _, model = engine_setup
    engine = _continuous(model, pcfg)
    try:
        futures = []
        for i in range(6):
            ids = np_rng.integers(4, 80, (1, 6 + (i % 3))).astype(np.int32)
            futures.append((ids, engine.submit(ids)))
        for ids, fut in futures:
            out = fut.result(timeout=180)
            assert out.shape == (1, 8)
            np.testing.assert_array_equal(out, _solo(model, pcfg, cfg, ids))
        ids = np_rng.integers(4, 80, (3, 7)).astype(np.int32)
        out = engine.submit(ids).result(timeout=180)
        np.testing.assert_array_equal(out, _solo(model, pcfg, cfg, ids))
    finally:
        engine.shutdown()


def test_continuous_failed_admit_fails_only_its_requests(engine_setup, np_rng, monkeypatch):
    """An admit that raises fails the requests it was admitting; a request
    already in flight and later requests are still served, and equal their
    solo generate()."""
    cfg, pcfg, _, model = engine_setup
    encode = continuous.bart.encode
    poison = 77

    def faulty_encode(m, c, input_ids, *args, **kw):
        if bool((input_ids == poison).any()):
            raise RuntimeError("admit fault")
        return encode(m, c, input_ids, *args, **kw)

    monkeypatch.setattr(continuous.bart, "encode", faulty_encode)
    engine = _continuous(model, pcfg, chunk_steps=1)
    try:
        first = np_rng.integers(4, 70, (1, 7)).astype(np.int32)
        fut_first = engine.submit(first)
        deadline = time.time() + 60
        while not engine._slot_req and not fut_first.done() and time.time() < deadline:
            time.sleep(0.001)
        bad = np.full((1, 7), poison, np.int32)
        with pytest.raises(RuntimeError, match="admit fault"):
            engine.submit(bad).result(timeout=180)
        later = np_rng.integers(4, 70, (2, 7)).astype(np.int32)
        out_later = engine.submit(later).result(timeout=180)
        np.testing.assert_array_equal(fut_first.result(timeout=180),
                                      _solo(model, pcfg, cfg, first))
        np.testing.assert_array_equal(out_later, _solo(model, pcfg, cfg, later))
    finally:
        engine.shutdown()
