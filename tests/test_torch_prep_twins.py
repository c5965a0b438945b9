"""PyTorch port, the COCO, Visual Genome, Conceptual Captions and SBU
preparation twins and the three caption-reasoning twins
(``python -m kmbart_tpu_torch.scripts.<name>``) against the root scripts
on the same synthetic annotations and images, without the feature step
(the extractor is held to the JAX package in tests/test_torch_vision.py and
the feature loop in tests/test_torch_prep_cli.py); the JSON they write must
be equal. Also ``read_image`` (OpenCV and PIL give the same array),
``delete_invalid`` and ``download_image`` (against a server on 127.0.0.1).
"""

import http.server
import json
import os
import sys
import threading

import cv2
import numpy as np
import pytest

from kmbart_tpu_torch.scripts import prep_common
from kmbart_tpu_torch.scripts import prepare_cc as cc_twin
from kmbart_tpu_torch.scripts import prepare_cc_reason as cc_reason_twin
from kmbart_tpu_torch.scripts import prepare_coco as coco_twin
from kmbart_tpu_torch.scripts import prepare_coco_reason as coco_reason_twin
from kmbart_tpu_torch.scripts import prepare_sbu as sbu_twin
from kmbart_tpu_torch.scripts import prepare_sbu_reason as sbu_reason_twin
from kmbart_tpu_torch.scripts import prepare_vg as vg_twin
from tests.test_torch_prep_cli import comet_inputs  # noqa: F401 (a fixture)

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


def _same_outputs(ref, out):
    names = sorted(n for n in os.listdir(ref) if n.endswith(".json"))
    assert names and names == sorted(n for n in os.listdir(out) if n.endswith(".json"))
    for name in names:
        assert _json(os.path.join(out, name)) == _json(os.path.join(ref, name)), name
    return names


def test_prepare_vg_twin_matches_root(tmp_path):
    """tests/test_scripts.py:62's annotations, plus an object without
    attributes, an image without relations and a relation predicate outside
    the vocabulary's top 1."""
    from scripts.prepare_vg import main as root_main
    annot = tmp_path / "annot"
    annot.mkdir()
    image_data = [{"image_id": i} for i in range(5)]
    region_data = [{"id": i, "regions": [
        {"region_id": 10 * i + j, "phrase": f"region {i} {j}", "x": 1, "y": 9,
         "height": 4, "width": 5} for j in range(2)]} for i in range(5)]
    object_data = [{"image_id": i, "objects": [
        {"object_id": 100 * i + j, "x": 0, "y": 8, "h": 3, "w": 3} for j in range(3)]}
        for i in range(5)]
    attribute_data = [{"image_id": i, "attributes": [
        {"object_id": 100 * i, "attributes": ["Red ", "big"]},
        {"object_id": 100 * i + 1, "attributes": ["small" if i % 2 else "Red"]}]}
        for i in range(5)]
    relation_data = [{"image_id": i, "relationships": [] if i == 3 else [
        {"object": {"object_id": 100 * i}, "subject": {"object_id": 100 * i + 1},
         "predicate": " ON " if i % 2 else "near"}]} for i in range(5)]
    for name, data in (("image_data", image_data), ("region_descriptions", region_data),
                       ("objects", object_data), ("attributes", attribute_data),
                       ("relationships", relation_data)):
        (annot / f"{name}.json").write_text(json.dumps(data))
    args = ["--annot_dir", str(annot), "--train_ratio", "0.6", "--num_relations", "1"]
    ref, out = tmp_path / "ref", tmp_path / "out"
    ref.mkdir()
    out.mkdir()
    _run_root(root_main, args + ["--output_dir", str(ref)])
    vg_twin.main(vg_twin.parse_args(args + ["--output_dir", str(out), "--device", "cpu"]))
    names = _same_outputs(ref, out)
    assert "attribute2id.json" in names and "val_region.json" in names
    train = _json(out / "train.json")
    assert len(train) == 3 and train["0"]["relations"][0]["predicate_id"] == 0
    assert train["1"]["relations"][0]["predicate_id"] == 1     # "on" is not in the top 1


def test_vg_boxes_count_y_from_the_bottom():
    """A box is [x, y - h, x + w, y]: Visual Genome's y is the bottom edge."""
    seen = {}

    class Extractor:
        def extract_feature(self, image, boxes):
            seen["boxes"] = boxes
            n = len(boxes)
            return {"features": np.arange(n * 3.0).reshape(n, 3), "scores": np.zeros((n, 2)),
                    "boxes": boxes}

    entry = {"img_id": 7, "regions": [{"region_id": 1, "x": 1, "y": 9, "h": 4, "w": 5}],
             "objects": [{"object_id": 2, "x": 0, "y": 8, "h": 3, "w": 3}]}
    out = vg_twin.image_data(entry, np.zeros((20, 30, 3), np.uint8), Extractor())
    np.testing.assert_array_equal(seen["boxes"], [[1, 5, 6, 9], [0, 5, 3, 8], [0, 0, 30, 20]])
    assert out["region_ids"] == [1] and out["object_ids"] == [2]
    np.testing.assert_array_equal(out["image_feature"], [6.0, 7.0, 8.0])
    assert out["object_features"].shape == (1, 3) and out["__img_id__"] == "7"


def test_prepare_coco_twin_matches_root(tmp_path):
    """tests/test_scripts.py:103's annotations, plus an image without
    captions and one without instances."""
    from scripts.prepare_coco import main as root_main
    annot = tmp_path / "annot"
    annot.mkdir()
    caps = {"images": [{"id": i, "file_name": f"{i}.jpg", "width": 10, "height": 8}
                       for i in (7, 8, 9)],
            "annotations": [{"image_id": 7, "caption": "a cat"},
                            {"image_id": 7, "caption": "one cat"},
                            {"image_id": 9, "caption": "a dog"}]}
    inst = {"annotations": [{"image_id": 7, "bbox": [1, 2, 3, 4]},
                            {"image_id": 8, "bbox": [0, 0, 5, 5]}]}
    for split in ("train", "val"):
        (annot / f"captions_{split}2014.json").write_text(json.dumps(caps))
        (annot / f"instances_{split}2014.json").write_text(json.dumps(inst))
    ref, out = tmp_path / "ref", tmp_path / "out"
    ref.mkdir()
    out.mkdir()
    _run_root(root_main, ["--annot_dir", str(annot), "--output_dir", str(ref)])
    coco_twin.main(coco_twin.parse_args(["--annot_dir", str(annot), "--output_dir", str(out),
                                         "--device", "cpu"]))
    assert len(_same_outputs(ref, out)) == 6
    rows = _json(out / "train.json")
    assert len(rows) == 3 and rows[0]["task_type"] == "caption"

    seen = {}

    class Extractor:
        def extract_feature(self, image, boxes):
            seen["boxes"] = boxes
            return {"features": np.zeros((len(boxes), 4)), "scores": np.zeros((len(boxes), 2)),
                    "boxes": boxes}

    entry = coco_twin.extract_data(caps, inst)[7]
    coco_twin.image_data(entry, np.zeros((8, 10, 3), np.uint8), Extractor())
    np.testing.assert_array_equal(seen["boxes"], [[1, 2, 4, 6], [0, 0, 10, 8]])


def _images(data_dir, n, skip=()):
    """Synthetic JPEGs named by index, one unreadable file and gaps."""
    rng = np.random.default_rng(0)
    os.makedirs(data_dir, exist_ok=True)
    for i in range(n):
        if i in skip:
            continue
        h, w = int(rng.integers(12, 40)), int(rng.integers(12, 40))
        cv2.imwrite(os.path.join(data_dir, f"{i}.jpg"),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    with open(os.path.join(data_dir, f"{n}.jpg"), "wb") as f:
        f.write(b"not an image")


def test_prepare_cc_index_twin_matches_root(tmp_path):
    from scripts.prepare_cc import main as root_main
    annot = tmp_path / "annot"
    annot.mkdir()
    caption = "A dog&amp;cat (cute) runs...  fast @photographer"
    for name, n in (("Train_GCC-training.tsv", 6), ("Validation_GCC-1.1.0-Validation.tsv", 4)):
        # --max_index -1 drops the last line, as the root script does
        (annot / name).write_text("".join(f"{caption} {i}\thttp://127.0.0.1/{i}.jpg\n"
                                          for i in range(n + 2)))
    data = tmp_path / "images"
    _images(str(data / "train"), 6, skip=(2,))
    _images(str(data / "val"), 4)
    args = ["--annot_dir", str(annot), "--data_dir", str(data), "--no_img_feat",
            "--max_index", "-1"]
    ref, out = tmp_path / "ref", tmp_path / "out"
    _run_root(root_main, args + ["--output_dir", str(ref)])
    cc_twin.main(cc_twin.parse_args(args + ["--output_dir", str(out), "--device", "cpu"]))
    _same_outputs(ref, out)
    train = _json(out / "train.json")
    assert [r["img_id"] for r in train] == [0, 1, 3, 4, 5]
    assert train[0]["labels"] == "A dog cat runs. fast"


def test_prepare_sbu_index_twin_matches_root(tmp_path):
    from scripts.prepare_sbu import main as root_main
    annot = tmp_path / "annot"
    annot.mkdir()
    (annot / "SBU_captioned_photo_dataset_captions.txt").write_text(
        "".join(f"a photo (of) {i}...  here @me\n" for i in range(12)))
    (annot / "SBU_captioned_photo_dataset_urls.txt").write_text(
        "".join(f"http://127.0.0.1/{i}.jpg\n" for i in range(12)))
    data = tmp_path / "images"
    _images(str(data), 10, skip=(4,))
    args = ["--annot_dir", str(annot), "--data_dir", str(data), "--no_img_feat",
            "--max_index", "-1", "--train_ratio", "0.75"]
    ref, out = tmp_path / "ref", tmp_path / "out"
    ref.mkdir()
    out.mkdir()
    _run_root(root_main, args + ["--output_dir", str(ref)])
    sbu_twin.main(sbu_twin.parse_args(args + ["--output_dir", str(out), "--device", "cpu"]))
    _same_outputs(ref, out)
    assert len(_json(out / "train.json")) == 6 and len(_json(out / "val.json")) == 3
    assert _json(out / "val.json")[0]["labels"] == "a photo 7. here @me"


def test_caption_reason_twins_match_root_and_resume(comet_inputs, tmp_path):  # noqa: F811
    """The COCO twin against the root ``reason_common.run``; the CC and SBU
    twins write the same files on the same captions; a run cut after the
    first caption resumes at the second."""
    from scripts.reason_common import run as root_run
    annot = tmp_path / "captions"
    annot.mkdir()
    (annot / "train.json").write_text(json.dumps(
        [{"img_id": i, "img_fn": f"{i}.jpg", "labels": c}
         for i, c in enumerate(["a man holds a cup", "2 dogs run", "person sits"])]))
    args = list(comet_inputs)
    args[args.index("--annot_dir") + 1] = str(annot)
    ref = tmp_path / "ref"
    _run_root(lambda: root_run(caption_key="labels", annot_help="x"),
              args + ["--output_dir", str(ref)])
    outs = {}
    for name, twin in (("coco", coco_reason_twin), ("cc", cc_reason_twin),
                       ("sbu", sbu_reason_twin)):
        outs[name] = tmp_path / name
        twin.main(args + ["--output_dir", str(outs[name]), "--device", "cpu"])
        _same_outputs(ref, outs[name])
    merged = _json(ref / "reason_train.json")
    assert merged and {r["task_type"] for r in merged} <= {"before", "after", "intent"}
    out = outs["coco"]
    full = {n: _json(out / n) for n in os.listdir(out) if n.endswith(".json")}
    (out / "train0.json").write_text(json.dumps([r for r in full["train0.json"]
                                                 if r["index"] == 0]))
    (out / "train0_eval.json").write_text(json.dumps([r for r in full["train0_eval.json"]
                                                      if r["index"] == 0]))
    (out / "train0_ref.json").write_text(json.dumps(full["train0_ref.json"][:1]))
    coco_reason_twin.main(args + ["--output_dir", str(out), "--device", "cpu"])
    for name, want in full.items():
        assert _json(out / name) == want, name


def test_read_image_is_the_same_with_opencv_and_pil(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    path = str(tmp_path / "im.png")
    cv2.imwrite(path, bgr)
    gray = str(tmp_path / "gray.png")
    cv2.imwrite(gray, bgr[..., 0])
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8 truncated")
    with_cv2 = [prep_common.read_image(p) for p in (path, gray)]
    assert prep_common.read_image(str(bad)) is None
    assert prep_common.read_image(str(tmp_path / "missing.jpg")) is None
    monkeypatch.setitem(sys.modules, "cv2", None)      # import cv2 now raises
    with_pil = [prep_common.read_image(p) for p in (path, gray)]
    for a, b in zip(with_cv2, with_pil):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(with_pil[0], bgr)
    assert prep_common.read_image(str(bad)) is None
    assert prep_common.read_image(str(tmp_path / "missing.jpg")) is None
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="OpenCV .* PIL"):
        prep_common.read_image(path)


def test_delete_invalid_removes_a_truncated_file_and_keeps_a_valid_one(tmp_path):
    rng = np.random.default_rng(2)
    cv2.imwrite(str(tmp_path / "0.jpg"), rng.integers(0, 256, (20, 30, 3), dtype=np.uint8))
    good = (tmp_path / "0.jpg").read_bytes()
    (tmp_path / "1.jpg").write_bytes(good[:len(good) // 3])
    cv2.imwrite(str(tmp_path / "2.jpg"), rng.integers(0, 256, (8, 30, 3), dtype=np.uint8))
    for i in range(4):           # 3.jpg does not exist
        prep_common.delete_invalid(i, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["0.jpg"]
    assert (tmp_path / "0.jpg").read_bytes() == good


def test_download_image_from_a_local_server(tmp_path):
    served = tmp_path / "served"
    served.mkdir()
    (served / "a.jpg").write_bytes(b"JPEG bytes")

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **k):
            super().__init__(*a, directory=str(served), **k)

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    out = tmp_path / "out"
    out.mkdir()
    try:
        prep_common.download_image(0, f"http://127.0.0.1:{port}/a.jpg", str(out))
        assert (out / "0.jpg").read_bytes() == b"JPEG bytes"
        (out / "1.jpg").write_bytes(b"kept")
        prep_common.download_image(1, f"http://127.0.0.1:{port}/a.jpg", str(out))
        assert (out / "1.jpg").read_bytes() == b"kept"      # an existing file is kept
        # a refused connection is printed and skipped
        prep_common.download_image(2, "http://127.0.0.1:1/none.jpg", str(out), timeout=2)
        assert not (out / "2.jpg").exists()
    finally:
        server.shutdown()
        server.server_close()
