"""PyTorch port, host-side data and evaluation: the port keeps its own
copies of the JAX package's framework-free modules (tokenizer, collator,
datasets, loader, metrics, the C++ host helpers). On the fixture dataset
each copy gives exactly what the JAX package's module gives."""

import json
import os

import numpy as np
import pytest

from kmbart_tpu import _native as jax_native
from kmbart_tpu.data import collation as jcol
from kmbart_tpu.data import datasets as jds
from kmbart_tpu.data import loader as jloader
from kmbart_tpu.data.tokenization import ConditionTokenizer as JaxTokenizer
from kmbart_tpu.eval.metrics import compute_metric_inference as jax_metrics
from kmbart_tpu_torch import _native
from kmbart_tpu_torch.data import collation, datasets, loader
from kmbart_tpu_torch.data.tokenization import ConditionTokenizer
from kmbart_tpu_torch.eval.metrics import compute_metric_inference


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from tests.fixtures.make_dataset import make_dataset
    paths = make_dataset(str(tmp_path_factory.mktemp("dataeval")))
    tok_dir = paths["tokenizer"]
    return paths, JaxTokenizer(assets_dir=tok_dir), ConditionTokenizer(assets_dir=tok_dir)


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def test_tokenizer_matches_jax(data):
    _, jtok, tok = data
    assert len(tok) == len(jtok)
    for name in ("bos_token_id", "eos_token_id", "pad_token_id", "img_feat_id",
                 "cls_token_id", "begin_mlm_id", "end_mlm_id", "mask_token_id"):
        assert getattr(tok, name) == getattr(jtok, name), name
    text = "2 holds a cup of coffee, then walks across the street!"
    assert tok.encode(text) == jtok.encode(text)
    assert tok.decode(tok.encode(text)) == jtok.decode(jtok.encode(text))
    for kw in (dict(task_type="intent", img_num=3, event="1 sits at a table"),
               dict(task_type="caption", img_num=2, mlm="order some food"),
               dict(task_type="before", event="3 walks")):
        _assert_same(tok.encode_condition(**kw), jtok.encode_condition(**kw), str(kw))
    _assert_same(tok.encode_label("drink the coffee slowly", img_num=2),
                 jtok.encode_label("drink the coffee slowly", img_num=2))


@pytest.mark.parametrize("split,kw", [
    ("train", {}), ("val", dict(eval_mode=True)), ("train", dict(pretrain=True)),
    ("train", dict(use_event=False)), ("val", dict(use_image=False, eval_mode=True)),
], ids=["train", "eval", "pretrain", "no-event", "no-image"])
def test_vcg_dataset_rows_match_jax(data, split, kw):
    paths = data[0]
    mine = datasets.VCGDataset(paths["vcg"], split=split, **kw)
    ref = jds.VCGDataset(paths["vcg"], split=split, **kw)
    assert len(mine) == len(ref)
    for i in range(len(ref)):
        _assert_same(mine[i], ref[i], f"row {i}")


def test_other_datasets_match_jax(data):
    paths = data[0]
    pairs = [(datasets.COCODataset(paths["coco"]), jds.COCODataset(paths["coco"])),
             (datasets.VGDataset(paths["vg"]), jds.VGDataset(paths["vg"])),
             (datasets.ReasonDataset(paths["reason"]), jds.ReasonDataset(paths["reason"]))]
    for mine, ref in pairs:
        assert len(mine) == len(ref)
        for i in range(len(ref)):
            _assert_same(mine[i], ref[i], f"{type(ref).__name__} row {i}")


def _collate(mod, ds_mod, tok, paths, pretrain):
    if pretrain:
        ds = ds_mod.ConcatDataset([
            ds_mod.VCGDataset(paths["vcg"], split="train", pretrain=True),
            ds_mod.COCODataset(paths["coco"]), ds_mod.VGDataset(paths["vg"]),
            ds_mod.ReasonDataset(paths["reason"])])
        col = mod.Collator(tok, has_label=True, mlm_enabled=True, mrm_enabled=True,
                           ap_enabled=True, rp_enabled=True, mlm_probability=0.3,
                           mrm_probability=0.3, max_img_num=4, image_feature_size=20,
                           num_mrm_labels=7, rng=np.random.default_rng(5))
    else:
        ds = ds_mod.VCGDataset(paths["vcg"], split="train")
        col = mod.Collator(tok, has_label=True, max_img_num=4, image_feature_size=20,
                           rng=np.random.default_rng(5))
    rows = [ds[i] for i in range(len(ds))]
    return [col(rows[i:i + 6]) for i in range(0, len(rows), 6)]


@pytest.mark.parametrize("pretrain", [False, True], ids=["vcg", "pretraining"])
def test_collator_batches_match_jax(data, pretrain):
    paths, jtok, tok = data
    got = _collate(collation, datasets, tok, paths, pretrain)
    want = _collate(jcol, jds, jtok, paths, pretrain)
    _assert_same(got, want)


def test_loader_batches_match_jax(data):
    paths, jtok, tok = data

    def batches(ld_mod, col_mod, ds_mod, t):
        ds = ds_mod.VCGDataset(paths["vcg"], split="val", eval_mode=True)
        col = col_mod.Collator(t, has_label=False, max_img_num=4, image_feature_size=20)
        return list(ld_mod.DataLoader(ds, batch_size=4, collate_fn=col, num_workers=0,
                                      shuffle=False))

    _assert_same(batches(loader, collation, datasets, tok),
                 batches(jloader, jcol, jds, jtok))


def test_metrics_match_jax(data):
    paths = data[0]
    with open(os.path.join(paths["vcg"], "val_eval.json")) as f:
        entries = json.load(f)
    with open(os.path.join(paths["vcg"], "val_ref.json")) as f:
        refs = json.load(f)
    rng = np.random.default_rng(0)
    words = "order some food drink the coffee get to other side say hello wave".split()
    gens = [{"index": e["index"], "task_type": e["task_type"],
             "generations": [" ".join(rng.choice(words, int(rng.integers(2, 7))))
                             for _ in range(2)]} for e in entries]
    got = compute_metric_inference(gens, refs, verbose=False)
    want = jax_metrics(gens, refs, verbose=False)
    assert sorted(got) == sorted(want) == ["BLEU1", "BLEU2", "BLEU3", "BLEU4", "CIDEr",
                                           "METEOR"]
    for k in want:
        assert got[k] == want[k], k
    assert 0 < want["BLEU1"] <= 1


def test_native_helpers_match_jax():
    """The port's C++ host helpers build from native/ into its own build
    directory and agree with the JAX package's, or both fall back."""
    assert _native.available() == jax_native.available()
    if not _native.available():
        pytest.skip("no C++ toolchain: both packages use their Python fallbacks")
    assert os.path.dirname(_native._SO).endswith(os.path.join("kmbart_tpu_torch", "_build"))
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 1, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.4, (40, 2))], axis=1)
    scores = rng.uniform(size=40)
    np.testing.assert_array_equal(_native.nms(boxes, scores, 0.5),
                                  jax_native.nms(boxes, scores, 0.5))
    hyp, refs = [1, 2, 3, 4, 2, 3], [[1, 2, 3], [2, 3, 4, 2, 9]]
    for a, b in zip(_native.bleu_counts(hyp, refs), jax_native.bleu_counts(hyp, refs)):
        np.testing.assert_array_equal(a, b)
