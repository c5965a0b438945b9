"""PyTorch port, the pretraining model against the JAX package on the CPU:
the classification head and the masked losses (including the twins of
tests/test_model.py's KL tests and its zero-mask test), ``pretraining_loss``
with its five loss keys and per-leaf gradients from the same parameters,
the LM-CE modes inside it, a three-step AdamW trajectory, and checkpoints
crossing between the packages and between the pretraining and fine-tune
models.

Tolerances: fp32 at 1e-5 (summation order only); bf16 losses at 1e-3
relative (the LM-CE kernels' plain versions against XLA's composite, which
round the same logits but sum in another order)."""

import math

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
from kmbart_tpu.models import heads as jheads
from kmbart_tpu.models.conditional import init_conditional_params
from kmbart_tpu.models.pretraining import init_pretraining_params
from kmbart_tpu.models.pretraining import pretraining_loss as jax_pretraining_loss
from kmbart_tpu.parallel.train_step import build_train_step as jax_train_step
from kmbart_tpu.training.adamw import adamw as jax_adamw
from kmbart_tpu.training.state import TrainState as JaxTrainState
from kmbart_tpu_torch.checkpoint.io import (jax_leaf_groups, load_pretrained,
                                            load_state_dict, load_training_data,
                                            params_from_jax, params_to_jax,
                                            save_pretrained, save_training_data)
from kmbart_tpu_torch.models import heads
from kmbart_tpu_torch.models.conditional import init_conditional_model
from kmbart_tpu_torch.models.pretraining import (forward_logits, init_pretraining_model,
                                                 pretraining_loss)
from kmbart_tpu_torch.parallel.train_step import build_train_step
from kmbart_tpu_torch.training.adamw import AdamW
from kmbart_tpu_torch.training.state import TrainState, model_tensors
from tests._torch_port import to_jax, to_np, to_torch

FP32 = dict(rtol=1e-5, atol=1e-5)
LOSS_KEYS = {"lm_loss", "mrm_loss", "attribute_loss", "relation_loss", "loss"}
LR = 1e-3


def _port(params, cfg):
    model = init_pretraining_model(cfg, device="cpu")
    load_state_dict(model, params_from_jax(params, cfg))
    return model


def _batch(cfg, rng, B=3, S=12, T=10, R=4):
    """A collator-shaped batch with rows present in every head, a cls
    position among the labels and -100 labels."""
    ids = rng.integers(4, 80, (B, S)).astype(np.int32)
    ids[:, 1:3] = cfg.img_feat_id
    labels = rng.integers(4, 80, (B, T)).astype(np.int32)
    labels[0, -2:] = -100
    labels[1, 3] = cfg.cls_token_id
    mrm_mask = np.zeros((B, T), bool)
    mrm_mask[1, 3] = mrm_mask[2, 4] = True
    soft = rng.dirichlet(np.ones(cfg.num_labels), (B, T)).astype(np.float32)
    soft[1, 3, 0] = 0.0                       # a zero target: 0 log 0 := 0
    rel_mask = np.zeros((B, R), bool)
    rel_mask[0, :2] = True
    return dict(
        input_ids=ids, attention_mask=np.ones((B, S), np.int32),
        image_features=rng.normal(size=(B, cfg.max_img_num, cfg.image_feature_size))
        .astype(np.float32),
        decoder_input_ids=rng.integers(4, 80, (B, T)).astype(np.int32),
        decoder_attention_mask=np.ones((B, T), np.int32), labels=labels,
        mrm_soft_labels=soft, mrm_mask=mrm_mask,
        attribute_labels=rng.integers(0, cfg.num_attributes, (B, T)).astype(np.int32),
        attribute_mask=(rng.random((B, T)) > 0.7).astype(np.float32),
        relation_pairs=rng.integers(0, T, (B, R, 2)).astype(np.int32),
        relation_labels=rng.integers(0, cfg.num_relations, (B, R)).astype(np.int32),
        relation_mask=rel_mask)


def _t(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# heads and losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classification_head_matches_jax(dtype):
    rng = np.random.default_rng(0)
    p = {"dense_kernel": rng.normal(size=(24, 16)) * 0.2, "dense_bias": rng.normal(size=16),
         "out_kernel": rng.normal(size=(16, 5)) * 0.2, "out_bias": rng.normal(size=5)}
    x = rng.normal(size=(2, 3, 24))
    want = jheads.classification_head({k: to_jax(v) for k, v in p.items()},
                                      to_jax(x, dtype), dtype=jnp.dtype(dtype))
    head = heads.BartClassificationHead(24, 16, 5)
    with torch.no_grad():
        head.dense.weight.copy_(to_torch(p["dense_kernel"].T))
        head.dense.bias.copy_(to_torch(p["dense_bias"]))
        head.out_proj.weight.copy_(to_torch(p["out_kernel"].T))
        head.out_proj.bias.copy_(to_torch(p["out_bias"]))
    got = heads.classification_head(head, to_torch(x, getattr(torch, dtype)),
                                    dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    tol = FP32 if dtype == "float32" else dict(rtol=0, atol=2 * 2.0 ** -8)
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)


def test_mrm_kl_exact_value():
    """Twin of tests/test_model.py::test_mrm_kl_exact_value: a one-hot
    target against a uniform prediction is log C, one or two rows."""
    C = 8
    logp = torch.log(torch.full((1, 3, C), 1.0 / C))
    soft = torch.zeros((1, 3, C))
    soft[0, 1, 0] = 1.0
    mask = torch.zeros((1, 3), dtype=torch.bool)
    mask[0, 1] = True
    loss, n = heads.masked_kl_div_batchmean(logp, soft, mask)
    assert int(n) == 1
    assert float(loss) == pytest.approx(math.log(C), rel=1e-6)
    soft[0, 2, 1] = 1.0
    mask[0, 2] = True
    loss2, n2 = heads.masked_kl_div_batchmean(logp, soft, mask)
    assert int(n2) == 2
    assert float(loss2) == pytest.approx(math.log(C), rel=1e-6)


def test_mrm_kl_matches_torch_and_jax():
    """Twin of tests/test_model.py::test_mrm_kl_matches_torch: equal to
    F.kl_div(reduction="batchmean") and to the JAX function; its gradient
    is finite where a target is zero."""
    rng = np.random.default_rng(0)
    C, R = 11, 5
    logits = rng.normal(size=(R, C)).astype(np.float32)
    targets = rng.dirichlet(np.ones(C), R).astype(np.float32)
    targets[2, 4] = 0.0
    ref = torch.nn.functional.kl_div(torch.log_softmax(torch.tensor(logits), dim=1),
                                     torch.tensor(targets), reduction="batchmean").item()
    x = torch.tensor(logits)[None].requires_grad_()
    loss, _ = heads.masked_kl_div_batchmean(torch.log_softmax(x, dim=-1),
                                            torch.tensor(targets)[None],
                                            torch.ones((1, R), dtype=torch.bool))
    assert float(loss.detach()) == pytest.approx(ref, rel=1e-5)
    want, _ = jheads.masked_kl_div_batchmean(jax.nn.log_softmax(jnp.asarray(logits)[None]),
                                             jnp.asarray(targets)[None], jnp.ones((1, R), bool))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-6)
    loss.backward()
    assert torch.isfinite(x.grad).all()


def test_masked_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 6, 9)) * 2
    labels = rng.integers(0, 9, (2, 6)).astype(np.int32)
    mask = rng.random((2, 6)) > 0.4
    want, n_j = jheads.masked_cross_entropy(to_jax(logits), jnp.asarray(labels),
                                            jnp.asarray(mask))
    labels_t = torch.from_numpy(labels).long()
    labels_t[~torch.from_numpy(mask)] = -100    # rows left out may hold any label
    got, n = heads.masked_cross_entropy(to_torch(logits), labels_t, torch.from_numpy(mask))
    assert int(n) == int(n_j)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_pretraining_loss_zero_masks(tiny_cfg):
    """Twin of tests/test_model.py::test_pretraining_loss_zero_masks: heads
    with no rows give exactly 0 (and no NaN in the gradient)."""
    cfg = tiny_cfg.replace(dtype="float32")
    rng = np.random.default_rng(2)
    b = _batch(cfg, rng, T=6, R=2)
    B, T = b["labels"].shape
    b.update(mrm_soft_labels=np.zeros((B, T, cfg.num_labels), np.float32),
             mrm_mask=np.zeros((B, T), bool), attribute_mask=np.zeros((B, T), np.float32),
             relation_mask=np.zeros((B, 2), bool))
    model = init_pretraining_model(cfg, device="cpu")
    total, aux = pretraining_loss(model, cfg, _t(b))
    for key in ("mrm_loss", "attribute_loss", "relation_loss"):
        assert float(aux["losses"][key].detach()) == 0.0
    assert set(aux["losses"]) == LOSS_KEYS and math.isfinite(float(total))
    total.backward()
    assert all(torch.isfinite(t.grad).all() for t in model.parameters() if t.grad is not None)
    assert model.mrm_head.dense.weight.grad is None or not model.mrm_head.dense.weight.grad.any()


# ---------------------------------------------------------------------------
# the loss and its gradients against the JAX package
# ---------------------------------------------------------------------------

def test_pretraining_loss_and_grads_match_jax(tiny_cfg):
    """fp32, the same parameters: the five losses and every leaf's gradient."""
    cfg = tiny_cfg.replace(dtype="float32")
    params = init_pretraining_params(jax.random.PRNGKey(0), cfg)
    b = _batch(cfg, np.random.default_rng(3))
    (_, jaux), jgrads = jax.value_and_grad(
        lambda p: jax_pretraining_loss(p, cfg, b), has_aux=True)(params)
    model = _port(params, cfg)
    total, aux = pretraining_loss(model, cfg, _t(b))
    total.backward()
    assert set(aux["losses"]) == set(jaux["losses"]) == LOSS_KEYS
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(aux["losses"][k].detach()),
                                   float(jaux["losses"][k]), rtol=1e-5, err_msg=k)
    want = _flatten(jgrads)
    got = params_to_jax({n: torch.zeros_like(t) if t.grad is None else t.grad
                         for n, t in model_tensors(model).items()}, cfg)
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, np.asarray(want[k]), err_msg=k, **FP32)
    # the aux logits are computed on access, equal to the JAX aux
    np.testing.assert_allclose(to_np(aux["logits"]), to_np(jaux["logits"]), **FP32)
    np.testing.assert_allclose(to_np(forward_logits(model, cfg, _t(b))),
                               to_np(jaux["logits"]), **FP32)


def test_lm_ce_modes_inside_the_loss(tiny_cfg, monkeypatch):
    """bf16 at d_model 128 and vocab 1100, where the fused LM-CE applies:
    the three modes give the same loss and gradients, close to the JAX
    package's composite."""
    cfg = tiny_cfg.replace(dtype="bfloat16", d_model=128, vocab_size=1100)
    params = init_pretraining_params(jax.random.PRNGKey(1), cfg)
    b = _batch(cfg, np.random.default_rng(4), T=8)
    want, _ = jax_pretraining_loss(params, cfg, b)
    runs = {}
    for mode in ("fwdbwd", "nomat", "bwd"):
        monkeypatch.setenv("KMBART_FUSED_CE_MODE", mode)
        model = _port(params, cfg)
        total, _ = pretraining_loss(model, cfg, _t(b))
        total.backward()
        runs[mode] = (float(total.detach()), model.model.shared.weight.grad.clone())
    for mode in ("nomat", "bwd"):
        assert runs[mode][0] == runs["fwdbwd"][0]
        assert torch.equal(runs[mode][1], runs["fwdbwd"][1]), mode
    np.testing.assert_allclose(runs["nomat"][0], float(want), rtol=1e-3)


def test_three_pretraining_steps_match_jax(tiny_cfg):
    """Three AdamW steps from the same parameters on the same batches:
    losses, parameters and moments within 1e-5 (fp32)."""
    cfg = tiny_cfg.replace(dtype="float32")
    params = init_pretraining_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(5)
    batches = [_batch(cfg, rng) for _ in range(3)]

    def jloss(p, bb, r):
        loss, aux = jax_pretraining_loss(p, cfg, bb)
        return loss, {k: v for k, v in aux["losses"].items() if k != "loss"}

    jstep = jax_train_step(jloss, jax_adamw(lr=LR), donate=False)
    jstate = JaxTrainState.create(params)
    opt = AdamW(lr=LR, groups=jax_leaf_groups(cfg, heads=True))

    def loss_fn(m, bb, g):
        loss, aux = pretraining_loss(m, cfg, bb)
        return loss, {k: v for k, v in aux["losses"].items() if k != "loss"}

    step = build_train_step(loss_fn, opt)
    state = TrainState.create(_port(params, cfg), opt)
    for b in batches:
        jstate, jm = jstep(jstate, b, jax.random.PRNGKey(0))
        state, m = step(state, _t(b), 0)
        for k in ("loss", "lm_loss", "mrm_loss", "attribute_loss", "relation_loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    jp = _flatten(jax.tree.map(np.asarray, jstate.params))
    for k, v in params_to_jax(state.params.state_dict(), cfg).items():
        np.testing.assert_allclose(v, jp[k], err_msg=k, **FP32)
    for field in ("mu", "nu"):
        want = _flatten(jax.tree.map(np.asarray, getattr(jstate.opt_state, field)))
        for k, v in params_to_jax(getattr(state.opt_state, field), cfg).items():
            np.testing.assert_allclose(v, want[k], err_msg=f"{field}/{k}", rtol=1e-5,
                                       atol=1e-5 if field == "mu" else 1e-8)
    want = _flatten(jax.tree.map(np.asarray, jstate.opt_state.leaf_steps))
    assert {k: int(v) for k, v in state.opt_state.leaf_steps.items()} == \
        {k: int(v) for k, v in want.items()}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_pretraining_checkpoint_round_trips(tiny_cfg, tmp_path):
    """The port's train checkpoint loads strictly in the JAX package as a
    pretraining TrainState with equal numbers, and back in the port; a JAX
    pretraining checkpoint loads in the port unchanged."""
    cfg = tiny_cfg.replace(dtype="float32")
    params = init_pretraining_params(jax.random.PRNGKey(0), cfg)
    opt = AdamW(lr=LR, groups=jax_leaf_groups(cfg, heads=True))
    step = build_train_step(lambda m, bb, g: (pretraining_loss(m, cfg, bb)[0], {}), opt)
    state, _ = step(TrainState.create(_port(params, cfg), opt),
                    _t(_batch(cfg, np.random.default_rng(6))), 0)
    path = str(tmp_path / "model0")
    save_pretrained(path, cfg, state.params)
    save_training_data(path, cfg, opt_state=state.opt_state, epoch=0, step=state.step)

    _, jparams, _ = jax_load_pretrained(path, init_pretraining_params)
    td = jax_load_training_data(path, opt_state_template=JaxTrainState.create(jparams)
                                .opt_state)
    assert (td["epoch"], td["step"]) == (0, 1)
    for k, v in params_to_jax(state.params.state_dict(), cfg).items():
        np.testing.assert_array_equal(v, np.asarray(_flatten(jparams)[k]), err_msg=k)
    mu = _flatten(jax.tree.map(np.asarray, td["opt_state"].mu))
    for k, v in params_to_jax(state.opt_state.mu, cfg).items():
        np.testing.assert_array_equal(v, mu[k], err_msg=k)
    assert int(td["opt_state"].leaf_steps["mrm_head"]["out_kernel"]) == 1

    _, model, _ = load_pretrained(path, device="cpu", init_model_fn=init_pretraining_model)
    back = load_training_data(path, cfg, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, state.params.state_dict()[k]), k
    for k, v in back["opt_state"].nu.items():
        assert torch.equal(v, state.opt_state.nu[k]), k
    assert set(back["opt_state"].leaf_steps) == set(jax_leaf_groups(cfg, heads=True))

    jpath = str(tmp_path / "jax0")
    jax_save_pretrained(jpath, cfg, jax.tree.map(np.asarray, params))
    _, model, _ = load_pretrained(jpath, device="cpu", init_model_fn=init_pretraining_model)
    want = _flatten(jax.tree.map(np.asarray, params))
    for k, v in params_to_jax(model.state_dict(), cfg).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_cross_loads_between_models(tiny_cfg, tmp_path):
    """A fine-tune checkpoint loads into the pretraining model with the
    heads at their initialisation, and a pretraining checkpoint into the
    fine-tune model with the heads dropped, as the JAX loader does with
    strict=False."""
    cfg = tiny_cfg.replace(dtype="float32")
    vcg, pre = str(tmp_path / "vcg"), str(tmp_path / "pre")
    jax_save_pretrained(vcg, cfg, jax.tree.map(
        np.asarray, init_conditional_params(jax.random.PRNGKey(1), cfg)))
    jax_save_pretrained(pre, cfg, jax.tree.map(
        np.asarray, init_pretraining_params(jax.random.PRNGKey(2), cfg)))

    fresh = init_pretraining_model(cfg, seed=7, device="cpu")
    _, model, report = load_pretrained(vcg, device="cpu", init_model_fn=init_pretraining_model,
                                       seed=7)
    _, jmodel, _ = jax_load_pretrained(vcg, init_pretraining_params, strict=False)
    assert not report
    trunk = {k: v for k, v in _flatten(jmodel).items() if k.startswith("model/")}
    got = params_to_jax(model.state_dict(), cfg)
    for k, v in trunk.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for name in ("mrm_head.dense.weight", "relation_head.out_proj.bias"):
        assert torch.equal(model.state_dict()[name], fresh.state_dict()[name])

    _, model, report = load_pretrained(pre, device="cpu")
    assert type(model) is type(init_conditional_model(cfg, device="cpu"))
    assert report == ["unused checkpoint keys: 12"]
    _, jmodel, _ = jax_load_pretrained(pre, init_conditional_params, strict=False)
    want = _flatten(jax.tree.map(np.asarray, jmodel))
    got = params_to_jax(model.state_dict(), cfg)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
