"""PyTorch port, data-preparation CLIs: the ``prepare_vcg``,
``prepare_vcg_reason``, ``filter_reason`` and ``prepare_atomic`` twins
(``python -m kmbart_tpu_torch.scripts.<name>``) against the root scripts
on the CPU, on the same inputs and the same weights."""

import glob
import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from kmbart_tpu.vision import extractor as jex
from kmbart_tpu.vision import resnet as jres
from kmbart_tpu_torch.scripts import filter_reason as filter_twin
from kmbart_tpu_torch.scripts import prepare_atomic as atomic_twin
from kmbart_tpu_torch.scripts import prepare_vcg as vcg_twin
from kmbart_tpu_torch.scripts import prepare_vcg_reason as reason_twin
from tests.test_torch_knowledge import openai_gpt_state_dict
from tests.test_torch_vision import detector_state_dict, jax_detector_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _run_root(main, argv):
    old = sys.argv
    sys.argv = ["prog"] + argv
    try:
        main()
    finally:
        sys.argv = old


def _json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture()
def vcg_inputs(tmp_path):
    """VCG annotations with images and box metadata on disk, a depth-50
    extractor config and a detector checkpoint both packages load."""
    import cv2
    rng = np.random.default_rng(0)
    annot, data = tmp_path / "annots", tmp_path / "vcr"
    annot.mkdir()
    (data / "img").mkdir(parents=True)
    (data / "md").mkdir()
    splits = {"train": 2, "val": 1, "test": 1}
    k = 0
    for split, n in splits.items():
        rows = []
        for _ in range(n):
            h, w = 120, 160   # one padded shape: the root script compiles once
            cv2.imwrite(str(data / "img" / f"im{k}.jpg"), rng.integers(0, 256, (h, w, 3),
                                                                       dtype=np.uint8))
            xy = rng.uniform(0, 40, (3, 2))
            boxes = np.concatenate([xy, xy + rng.uniform(10, 50, (3, 2)), np.ones((3, 1))], 1)
            (data / "md" / f"im{k}.json").write_text(json.dumps(
                {"boxes": boxes.tolist(), "height": h, "width": w}))
            row = {"img_fn": f"img/im{k}.jpg", "metadata_fn": f"md/im{k}.json",
                   "split": split, "event": f"{k} stands near the door"}
            if split != "test":
                row.update(intent=[f"greet {k}"], before=[] if k == 1 else ["walk in"],
                           after=["sit down", "leave"])
            rows.append(row)
            k += 1
        (annot / f"{split}_annots.json").write_text(json.dumps(rows))
    yml = tmp_path / "extract.yaml"
    yml.write_text("MODEL:\n  RPN:\n    PRE_NMS_TOPK_TEST: 200\n    POST_NMS_TOPK_TEST: 24\n"
                   "  ROI_HEADS:\n    NUM_CLASSES: 11\n  BUA:\n    RPN:\n"
                   "      CONV_OUT_CHANNELS: 32\n    ATTRIBUTE:\n      NUM_CLASSES: 5\n"
                   "  RESNETS:\n    DEPTH: 50\nINPUT:\n  MIN_SIZE_TEST: 96\n"
                   "  MAX_SIZE_TEST: 160\n")
    weights = tmp_path / "det.pth"
    torch.save({k: torch.from_numpy(v) for k, v in detector_state_dict(5).items()},
               str(weights))
    return annot, data, yml, weights


def test_prepare_vcg_twin_matches_root(vcg_inputs, tmp_path, monkeypatch):
    """Index JSONs equal; feature pickles equal within a bf16 bound. The
    root script's extractor runs its ROI stage eagerly, for the reason
    tests/test_torch_vision.py's ``extractors`` fixture gives; its random
    initialisation, which the checkpoint overwrites, comes from numpy."""
    import scripts.prep_common as root_common
    from scripts.prepare_vcg import main as root_main

    annot, data, yml, weights = vcg_inputs
    monkeypatch.setattr(jex, "init_extractor_params",
                        lambda rng, **kw: jax_detector_params(0, **kw))
    monkeypatch.setattr(jres, "res5_head", jax.jit(jres.res5_head,
                                                    static_argnames=("dilation", "dtype")))
    build, built = root_common.build_extractor, []

    def build_eager(args):
        # one extractor for the three splits, so its jitted backbone compiles once
        if not built:
            built.append(build(args))
            built[0]._roi_features_j = built[0]._roi_features
        return built[0]

    monkeypatch.setattr(root_common, "build_extractor", build_eager)
    args = ["--annot_dir", str(annot), "--data_dir", str(data), "--config", str(yml),
            "--detector_weights", str(weights)]
    ref, out = tmp_path / "ref", tmp_path / "out"
    _run_root(root_main, args + ["--output_dir", str(ref)])
    vcg_twin.main(vcg_twin.parse_args(args + ["--output_dir", str(out), "--device", "cpu"]))

    names = sorted(os.path.basename(p) for p in glob.glob(str(ref / "*.json")))
    assert len(names) == 8
    for name in names:
        assert _json(out / name) == _json(ref / name), name
    pickles = sorted(glob.glob(str(ref / "*" / "*.pkl")))
    assert len(pickles) == 4
    for p in pickles:
        with open(p, "rb") as f:
            want = pickle.load(f)
        with open(out / os.path.relpath(p, ref), "rb") as f:
            got = pickle.load(f)
        assert set(got) == set(want) == {"image_features", "mrm_labels", "boxes"}
        np.testing.assert_array_equal(got["boxes"], want["boxes"])
        assert got["image_features"].shape == (4, 2048) and got["mrm_labels"].shape == (4, 11)
        # bf16, the scripts' dtype: the two differ in fp32 summation order, and
        # where that moves a bf16 rounding the difference travels through 19
        # bottlenecks; features are held to one bf16 ulp at their largest
        # magnitude (0.3 seen), class probabilities to one at 1 (1e-3 seen)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want["image_features"]).max())) - 7)
        np.testing.assert_allclose(got["image_features"], want["image_features"], rtol=0,
                                   atol=ulp)
        np.testing.assert_allclose(got["mrm_labels"], want["mrm_labels"], rtol=0, atol=2.0 ** -7)


@pytest.fixture()
def comet_inputs(tmp_path):
    """tests/test_knowledge.py's character vocabulary, three VCG events and
    a COMET state dict (d_model 32, 2 layers) of the generator's shapes."""
    vocab_dir = tmp_path / "gptvocab"
    vocab_dir.mkdir()
    vocab = {}
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789 '":
        vocab[ch] = len(vocab)
        vocab[ch + "</w>"] = len(vocab)
    for sp in ("none</w>", "<END>", "<xIntent>", "<xWant>", "<xNeed>", "<xReact>",
               "<xEffect>"):
        vocab[sp] = len(vocab)
    (vocab_dir / "vocab.json").write_text(json.dumps(vocab))
    (vocab_dir / "merges.txt").write_text("#version: toy\n")
    annot = tmp_path / "annot"
    annot.mkdir()
    events = ["person waits at the door", "2 pours tea for 1", "person runs"]
    (annot / "train.json").write_text(json.dumps(
        [{"img_id": str(i), "img_fn": f"im{i}.jpg", "event": e} for i, e in enumerate(events)]))
    model_file = tmp_path / "comet.pt"
    sd = openai_gpt_state_dict(1, len(vocab) + 6 + 52, 32, 2)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(model_file))
    return ["--annot_dir", str(annot), "--comet_vocab_dir", str(vocab_dir), "--splits", "train",
            "--save_every", "1", "--gpt_dim", "32", "--gpt_layers", "2", "--gpt_heads", "4",
            "--model_file", str(model_file)]


def test_prepare_vcg_reason_twin_matches_root_and_resumes(comet_inputs, tmp_path):
    """Greedy (tests/test_torch_knowledge.py holds beam search to the JAX
    generator)."""
    from scripts.reason_common import run as root_run

    args = comet_inputs
    ref, out = tmp_path / "ref", tmp_path / "out"
    _run_root(lambda: root_run(caption_key="event", annot_help="x"),
              args + ["--output_dir", str(ref)])
    twin_args = args + ["--output_dir", str(out), "--device", "cpu"]
    reason_twin.main(twin_args)
    outputs = ("train0.json", "train0_eval.json", "train0_ref.json", "reason_train.json",
               "reason_train_eval.json", "reason_train_ref.json")
    full = {name: _json(out / name) for name in outputs}
    for name in outputs:
        assert full[name] == _json(ref / name), name
    assert len(full["reason_train_ref.json"]) == 3 and full["reason_train.json"]
    # resume: a run cut after the first event picks up at the second
    for name, keep in (("train0.json", lambda r: r["index"] == 0),
                       ("train0_eval.json", lambda r: r["index"] == 0)):
        (out / name).write_text(json.dumps([r for r in full[name] if keep(r)]))
    (out / "train0_ref.json").write_text(json.dumps(full["train0_ref.json"][:1]))
    reason_twin.main(twin_args)
    for name in outputs:
        assert _json(out / name) == full[name], name
    # a run over finished outputs adds nothing
    reason_twin.main(twin_args)
    assert _json(out / "reason_train.json") == full["reason_train.json"]


def test_filter_reason_twin_keeps_the_same_rows(fixture_dataset, toy_assets, tmp_path):
    from kmbart_tpu.checkpoint.io import save_pretrained
    from kmbart_tpu.config import MultiModalBartConfig
    from kmbart_tpu.models.conditional import init_conditional_params
    from scripts.filter_reason import main as root_main, parse_args as root_parse

    cfg = MultiModalBartConfig.from_json(os.path.join(fixture_dataset, "config.json"))
    ckpt = tmp_path / "model0"
    save_pretrained(str(ckpt), cfg, init_conditional_params(jax.random.PRNGKey(0), cfg))
    args = ["--data_dir", os.path.join(fixture_dataset, "reason"), "--checkpoint", str(ckpt),
            "--tokenizer_dir", toy_assets, "--batch_size", "2"]

    # the threshold sits in the widest gap between the rows' log-perplexities
    # (the fixture's scores are spread over a few tenths)
    from kmbart_tpu_torch.checkpoint.io import load_pretrained
    from kmbart_tpu_torch.data.collation import Collator
    from kmbart_tpu_torch.data.datasets import ReasonDataset
    from kmbart_tpu_torch.data.loader import DataLoader
    from kmbart_tpu_torch.data.tokenization import ConditionTokenizer
    from kmbart_tpu_torch.training.trainer import to_device
    pcfg, model, _ = load_pretrained(str(ckpt), device="cpu")
    tok = ConditionTokenizer(assets_dir=toy_assets)
    loader = DataLoader(ReasonDataset(os.path.join(fixture_dataset, "reason")), batch_size=8,
                        collate_fn=Collator(tok, has_label=True, max_img_num=pcfg.max_img_num,
                                            image_feature_size=pcfg.image_feature_size))
    scores = np.sort(np.concatenate([filter_twin.batch_log_perplexity(
        model, pcfg, to_device(b, torch.device("cpu"))).numpy() for b in loader]))
    gap = int(np.argmax(np.diff(scores)))
    threshold = str(float(scores[gap] + scores[gap + 1]) / 2)

    ref, out = tmp_path / "ref", tmp_path / "out"
    old = sys.argv
    sys.argv = ["prog"] + args + ["--output_dir", str(ref), "--pp_threshold", threshold, "--cpu"]
    try:
        root_main(root_parse())
    finally:
        sys.argv = old
    filter_twin.main(filter_twin.parse_args(
        args + ["--output_dir", str(out), "--pp_threshold", threshold, "--device", "cpu"]))
    want = _json(ref / "reason_train.json")
    assert _json(out / "reason_train.json") == want
    assert 0 < len(want) < len(scores)


def test_prepare_atomic_twin_trains_an_epoch(fixture_dataset, toy_assets, tmp_path):
    args = atomic_twin.parse_args([
        "--data_dir", os.path.join(fixture_dataset, "vcg"), "--checkpoint_dir", str(tmp_path),
        "--tokenizer_dir", toy_assets, "--epochs", "1", "--batch_size", "4",
        "--image_seq_length", "4", "--image_feature_size", "20", "--inner_dim", "16",
        "--device", "cpu"])
    before = {k: v.detach().clone() for k, v in atomic_twin.init_reasoning_params(
        torch.Generator().manual_seed(args.seed), 32, 80, 16).items()}
    params = atomic_twin.main(args)
    assert any(not torch.equal(params[k].detach(), before[k]) for k in before)
    (saved,) = glob.glob(str(tmp_path / "*" / "model0" / "params.npz"))
    with np.load(saved) as z:
        assert z["txt_kernel"].shape == (32, 16) and z["image_kernel"].shape == (80, 16)
        assert z["out_kernel"].shape == (32, 2) and np.isfinite(z["out_kernel"]).all()
