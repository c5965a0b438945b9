"""PyTorch port, the fine-tune slice against the JAX package on the CPU:
three train steps from the same parameters on the same batches (losses,
parameters and AdamW state), the AdamW itself, the eval step, the
non-finite guard, gradient accumulation, skipped unused leaves, dropout
in the model, and train checkpoints crossing between the two packages in
both directions."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmbart_tpu.checkpoint.io import _flatten
from kmbart_tpu.checkpoint.io import load_pretrained as jax_load_pretrained
from kmbart_tpu.checkpoint.io import load_training_data as jax_load_training_data
from kmbart_tpu.checkpoint.io import save_pretrained as jax_save_pretrained
from kmbart_tpu.checkpoint.io import save_training_data as jax_save_training_data
from kmbart_tpu.models.conditional import conditional_loss as jax_conditional_loss
from kmbart_tpu.models.conditional import init_conditional_params
from kmbart_tpu.parallel.train_step import build_eval_step as jax_eval_step
from kmbart_tpu.parallel.train_step import build_train_step as jax_train_step
from kmbart_tpu.training.adamw import adamw as jax_adamw
from kmbart_tpu.training.state import TrainState as JaxTrainState
from kmbart_tpu_torch.checkpoint.io import (jax_leaf_groups, load_pretrained,
                                            load_training_data, params_to_jax,
                                            save_pretrained, save_training_data)
from kmbart_tpu_torch.models.conditional import conditional_loss
from kmbart_tpu_torch.parallel.train_step import build_eval_step, build_train_step
from kmbart_tpu_torch.training.adamw import AdamW
from kmbart_tpu_torch.training.state import TrainState, model_tensors
from tests._torch_port import port_model

LR = 1e-3


def _batch(cfg, rng, B=8, S=12, T=6):
    ids = rng.integers(4, 80, (B, S)).astype(np.int32)
    ids[:, 1:3] = cfg.img_feat_id
    mask = np.ones((B, S), np.int32)
    mask[1, -3:] = 0
    labels = rng.integers(4, 80, (B, T)).astype(np.int32)
    labels[0, -2:] = -100
    return dict(input_ids=ids, attention_mask=mask,
                image_features=rng.normal(size=(B, cfg.max_img_num, cfg.image_feature_size))
                .astype(np.float32),
                decoder_input_ids=rng.integers(4, 80, (B, T)).astype(np.int32),
                decoder_attention_mask=np.ones((B, T), np.int32), labels=labels)


def _t(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _jax_step(cfg, **kw):
    def loss_fn(p, b, rng):
        return jax_conditional_loss(p, cfg, b, train=False)[0], {}
    return jax_train_step(loss_fn, jax_adamw(lr=LR), donate=False, **kw)


def _port(params, cfg, **kw):
    model = port_model(params, cfg)
    opt = AdamW(lr=LR, groups=jax_leaf_groups(cfg))
    step = build_train_step(
        lambda m, b, g: (conditional_loss(m, cfg, b, train=False)[0], {}), opt, **kw)
    return TrainState.create(model, opt), step


def _np_tree(tree):
    return _flatten(jax.tree.map(np.asarray, tree))


def _assert_states_close(state, jstate, cfg, **tol):
    """Parameters, moments and step counts of the port against JAX's."""
    jp = _np_tree(jstate.params)
    for k, v in params_to_jax(state.params.state_dict(), cfg).items():
        np.testing.assert_allclose(v, jp[k], err_msg=k, **tol["params"])
    for field in ("mu", "nu"):
        want = _np_tree(getattr(jstate.opt_state, field))
        for k, v in params_to_jax(getattr(state.opt_state, field), cfg).items():
            np.testing.assert_allclose(v, want[k], err_msg=f"{field}/{k}", **tol[field])
    want = _np_tree(jstate.opt_state.leaf_steps)
    assert {k: int(v) for k, v in state.opt_state.leaf_steps.items()} == \
        {k: int(v) for k, v in want.items()}
    assert int(state.opt_state.step) == int(jstate.opt_state.step)


# bf16: the two sides round the same values at the same places but may sum
# in another order (and the port's fused FFN stands for JAX's composite on
# the CPU), so a near-zero gradient can change sign; an Adam step moves a
# parameter by at most about lr whatever the gradient's size, so three steps
# bound the parameter difference by a few lr, and the moments by a few
# percent of the leaf's largest moment
TOLERANCES = {
    "float32": {"loss": 1e-5, "params": dict(rtol=1e-5, atol=1e-5),
                "mu": dict(rtol=1e-5, atol=1e-5), "nu": dict(rtol=1e-5, atol=1e-8)},
    "bfloat16": {"loss": 1e-4, "params": dict(rtol=0, atol=6 * LR),
                 "mu": dict(rtol=0, atol=2e-3), "nu": dict(rtol=0, atol=5e-6)},
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_jax(tiny_cfg, dtype):
    cfg = tiny_cfg.replace(dtype=dtype)
    params = init_conditional_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    batches = [_batch(cfg, rng) for _ in range(3)]
    jstep = _jax_step(cfg)
    jstate = JaxTrainState.create(params)
    state, step = _port(params, cfg)
    tol = TOLERANCES[dtype]
    for b in batches:
        jstate, jm = jstep(jstate, b, jax.random.PRNGKey(0))
        state, m = step(state, _t(b), 0)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=tol["loss"])
        assert float(m["skipped"]) == 0.0
    assert state.step == int(jstate.step) == 3
    _assert_states_close(state, jstate, cfg, **tol)


# ---------------------------------------------------------------------------
# AdamW (ports of tests/test_train.py:30 and :362)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_decay,skip_unused", [(0.0, True), (0.01, True),
                                                      (0.01, False)])
def test_adamw_matches_jax_on_a_stacked_leaf(weight_decay, skip_unused):
    """A JAX leaf stacked over two layers is a group of two port tensors:
    same parameters, moments and per-leaf steps after four updates, with a
    step where one layer of the stack has a zero gradient and one where
    the other leaf has none."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(2, 5, 3)).astype(np.float32)
    b0 = rng.normal(size=(4,)).astype(np.float32)
    grads = [(rng.normal(size=(2, 5, 3)), rng.normal(size=(4,))) for _ in range(4)]
    grads[1][0][0] = 0.0
    grads[2] = (grads[2][0], np.zeros(4))
    kw = dict(lr=1e-2, eps=1e-6, weight_decay=weight_decay, skip_unused=skip_unused)
    jopt = jax_adamw(**kw)
    jp = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    js = jopt.init(jp)
    opt = AdamW(**kw, groups={"w": ["w.0", "w.1"], "b": ["b"]})
    tp = {"w.0": torch.tensor(w0[0]), "w.1": torch.tensor(w0[1]), "b": torch.tensor(b0)}
    ts = opt.init(tp)
    for gw, gb in grads:
        gw, gb = gw.astype(np.float32), gb.astype(np.float32)
        jp, js = jopt.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)}, js, jp)
        ts = opt.update({"w.0": torch.tensor(gw[0]), "w.1": torch.tensor(gw[1]),
                         "b": torch.tensor(gb)}, ts, tp)
    close = dict(rtol=1e-6, atol=1e-7)
    for field, jt, tt in (("params", jp, tp), ("mu", js.mu, ts.mu), ("nu", js.nu, ts.nu)):
        np.testing.assert_allclose(np.stack([tt["w.0"], tt["w.1"]]), np.asarray(jt["w"]),
                                   err_msg=field, **close)
        np.testing.assert_allclose(tt["b"].numpy(), np.asarray(jt["b"]), err_msg=field, **close)
    assert {k: int(v) for k, v in ts.leaf_steps.items()} == \
        {k: int(v) for k, v in js.leaf_steps.items()}
    assert int(ts.step) == int(js.step) == 4


def test_adamw_matches_torch_without_decay():
    """At weight decay 0 (where the decoupling orders agree) the port equals
    torch.optim.AdamW with eps 1e-6 to float tolerance."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(4)]
    p = torch.nn.Parameter(torch.tensor(w0))
    ref = torch.optim.AdamW([p], lr=1e-2, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.0)
    opt = AdamW(lr=1e-2, eps=1e-6)
    params = {"w": torch.tensor(w0)}
    state = opt.init(params)
    for g in grads:
        p.grad = torch.tensor(g)
        ref.step()
        state = opt.update({"w": torch.tensor(g)}, state, params)
    np.testing.assert_allclose(params["w"].numpy(), p.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_adamw_skips_unused_leaves():
    """A leaf whose gradient is exactly zero gets no update: moments keep
    their values, its step count does not advance, and no decayed moment
    drifts the parameter."""
    opt = AdamW(lr=1e-2, eps=1e-6)
    params = {"used": torch.ones(4), "unused": torch.ones(4)}
    state = opt.init(params)
    g1 = {"used": torch.full((4,), 0.5), "unused": torch.full((4,), 0.5)}
    g0 = {"used": torch.full((4,), 0.5), "unused": None}      # None: no gradient
    state = opt.update(g1, state, params)
    p_unused = params["unused"].clone()
    m_unused = state.mu["unused"].clone()
    for _ in range(3):
        state = opt.update(g0, state, params)
    assert torch.equal(params["unused"], p_unused)
    assert torch.equal(state.mu["unused"], m_unused)
    assert int(state.leaf_steps["unused"]) == 1
    assert int(state.leaf_steps["used"]) == 4
    assert int(state.step) == 4
    assert not torch.allclose(params["used"], torch.ones(4))


# ---------------------------------------------------------------------------
# eval step, guard, accumulation (ports of tests/test_train.py:159,173,263)
# ---------------------------------------------------------------------------

def test_eval_step(tiny_cfg):
    cfg = tiny_cfg.replace(dtype="float32")
    params = init_conditional_params(jax.random.PRNGKey(0), cfg)
    b = _batch(cfg, np.random.default_rng(2))
    want = jax_eval_step(lambda p, bb, r: (jax_conditional_loss(p, cfg, bb)[0], {}))(params, b)
    ev = build_eval_step(lambda m, bb, g: (conditional_loss(m, cfg, bb)[0], {}))
    got = ev(port_model(params, cfg), _t(b))
    assert not got["loss"].requires_grad
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)


def test_nonfinite_guard(tiny_cfg):
    """A batch with NaN gradients leaves parameters, moments and step
    counts as they were; a good batch still updates."""
    cfg = tiny_cfg
    params = init_conditional_params(jax.random.PRNGKey(0), cfg)
    good = _batch(cfg, np.random.default_rng(3), B=4)
    bad = dict(good, image_features=np.full_like(good["image_features"], np.nan))
    state, step = _port(params, cfg)
    before = {k: v.clone() for k, v in state.params.state_dict().items()}
    new, m = step(state, _t(bad), 0)
    assert float(m["skipped"]) == 1.0
    for k, v in new.params.state_dict().items():
        assert torch.equal(v, before[k]), k
    for field in ("mu", "nu"):
        assert all(not v.any() for v in getattr(new.opt_state, field).values())
    assert int(new.opt_state.step) == 0
    assert all(int(v) == 0 for v in new.opt_state.leaf_steps.values())
    assert new.step == 1          # the train step counter advances regardless
    new2, m2 = step(new, _t(good), 0)
    assert float(m2["skipped"]) == 0.0
    assert not torch.equal(new2.params.model.shared.weight, before["model.shared.weight"])


def test_grad_accumulation_matches_mean_of_micro_grads(tiny_cfg):
    """G = 2 applies AdamW to the mean of the two half-batch gradients, and
    equals the JAX package's accumulated step (fp32)."""
    cfg = tiny_cfg.replace(dtype="float32")
    params = init_conditional_params(jax.random.PRNGKey(0), cfg)
    b = _batch(cfg, np.random.default_rng(4))
    state, step = _port(params, cfg, grad_accum_steps=2)
    new, m = step(state, _t(b), 0)

    # by hand: the mean of the two half-batch gradients, one update
    ref_state, _ = _port(params, cfg)
    model = ref_state.params
    tensors = model_tensors(model)
    grads, loss_sum = {}, 0.0
    for half in (slice(0, 4), slice(4, 8)):
        model.zero_grad(set_to_none=True)
        loss, _ = conditional_loss(model, cfg, _t({k: v[half] for k, v in b.items()}))
        loss.backward()
        loss_sum += float(loss.detach())
        for n, t in tensors.items():
            if t.grad is not None:
                grads[n] = grads[n] + t.grad if n in grads else t.grad.clone()
    grads = {n: g / 2 for n, g in grads.items()}
    AdamW(lr=LR, groups=jax_leaf_groups(cfg)).update(grads, ref_state.opt_state,
                                                    model_tensors(model))
    np.testing.assert_allclose(float(m["loss"]), loss_sum / 2, rtol=1e-6)
    for k, v in new.params.state_dict().items():
        np.testing.assert_allclose(v.numpy(), model.state_dict()[k].numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=k)

    jstate, jm = _jax_step(cfg, grad_accum_steps=2)(JaxTrainState.create(params), b,
                                                    jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_states_close(new, jstate, cfg, **TOLERANCES["float32"])


# ---------------------------------------------------------------------------
# dropout in the model, and the per-step generator
# ---------------------------------------------------------------------------

def test_dropout_steps_are_reproducible_and_resumable(tiny_cfg):
    """With dropout 0.1 a train step differs from the eval loss; the same
    (seed, step) gives the same step, and a run resumed from a copy of its
    state after one step draws what the uninterrupted run draws."""
    cfg = tiny_cfg.replace(dtype="float32", dropout=0.1, attention_dropout=0.1,
                           activation_dropout=0.1)
    params = init_conditional_params(jax.random.PRNGKey(0), cfg)
    b = _t(_batch(cfg, np.random.default_rng(5)))
    opt = AdamW(lr=LR, groups=jax_leaf_groups(cfg))
    step = build_train_step(
        lambda m, bb, g: (conditional_loss(m, cfg, bb, train=True, generator=g)[0], {}), opt)

    def fresh():
        return TrainState.create(port_model(params, cfg), opt)

    with torch.no_grad():
        eval_loss = float(conditional_loss(fresh().params, cfg, b)[0])
    s1, m1 = step(fresh(), b, 7)
    s1b, m1b = step(fresh(), b, 7)
    assert float(m1["loss"]) == float(m1b["loss"]) != eval_loss
    assert float(step(fresh(), b, 8)[1]["loss"]) != float(m1["loss"])
    resumed = TrainState(params=copy.deepcopy(s1.params), opt_state=s1.opt_state,
                         step=s1.step)
    s2, m2 = step(s1, b, 7)
    r2, mr2 = step(resumed, b, 7)
    assert float(m2["loss"]) == float(mr2["loss"])
    for (k, v), w in zip(s2.params.state_dict().items(), r2.params.state_dict().values()):
        assert torch.equal(v, w), k


# ---------------------------------------------------------------------------
# train checkpoints between the two packages
# ---------------------------------------------------------------------------

def test_port_checkpoint_loads_in_jax(tiny_cfg, tmp_path):
    cfg = tiny_cfg.replace(dtype="float32")
    params = init_conditional_params(jax.random.PRNGKey(0), cfg)
    state, step = _port(params, cfg)
    state, _ = step(state, _t(_batch(cfg, np.random.default_rng(6))), 0)
    path = str(tmp_path / "model0")
    save_pretrained(path, cfg, state.params)
    save_training_data(path, cfg, opt_state=state.opt_state, epoch=0, step=state.step)

    _, jparams, _ = jax_load_pretrained(path, init_conditional_params)
    template = JaxTrainState.create(jparams).opt_state
    td = jax_load_training_data(path, opt_state_template=template)
    assert (td["epoch"], td["step"]) == (0, 1)
    jstate = JaxTrainState(params=jparams, opt_state=td["opt_state"], step=jnp.int32(1))
    _assert_states_close(state, jstate, cfg, params=dict(rtol=0, atol=0),
                         mu=dict(rtol=0, atol=0), nu=dict(rtol=0, atol=0))
    # and back into the port, unchanged
    _, model, _ = load_pretrained(path, device="cpu")
    back = load_training_data(path, cfg, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, state.params.state_dict()[k]), k
    for field in ("mu", "nu"):
        for k, v in getattr(back["opt_state"], field).items():
            assert torch.equal(v, getattr(state.opt_state, field)[k]), k


def test_jax_checkpoint_resumes_in_port(tiny_cfg, tmp_path):
    """A JAX state saved after one step resumes in the port, and the port's
    next step equals JAX's next step."""
    cfg = tiny_cfg.replace(dtype="float32")
    params = init_conditional_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(7)
    b1, b2 = _batch(cfg, rng), _batch(cfg, rng)
    jstep = _jax_step(cfg)
    jstate, _ = jstep(JaxTrainState.create(params), b1, jax.random.PRNGKey(0))
    path = str(tmp_path / "jax0")
    jax_save_pretrained(path, cfg, jax.tree.map(np.asarray, jstate.params))
    jax_save_training_data(path, opt_state=jax.tree.map(np.asarray, jstate.opt_state),
                           epoch=0, step=int(jstate.step))

    _, model, _ = load_pretrained(path, device="cpu")
    td = load_training_data(path, cfg, device="cpu")
    opt = AdamW(lr=LR, groups=jax_leaf_groups(cfg))
    state = TrainState(params=model, opt_state=td["opt_state"], step=td["step"])
    step = build_train_step(lambda m, bb, g: (conditional_loss(m, cfg, bb)[0], {}), opt)
    state, m = step(state, _t(b2), 0)
    jstate, jm = jstep(jstate, b2, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_states_close(state, jstate, cfg, **TOLERANCES["float32"])
