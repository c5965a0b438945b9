"""PyTorch port, the rest of the VCG command surface: the ``vcg_eval`` twin
logs the same scores as the root ``vcg_eval.py``, ``save_torch_pretrained``
writes a ``pytorch_model.bin`` that both packages load back, the ``serve``
twin's flags build its engines (on the CPU only when asked), and the
``vcg_generate`` twin samples, reproducibly from ``--seed``."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kmbart_tpu.checkpoint.io import load_pretrained as jax_load_pretrained
from kmbart_tpu.checkpoint.io import save_pretrained as jax_save_pretrained
from kmbart_tpu.config import MultiModalBartConfig
from kmbart_tpu.models.conditional import init_conditional_params
from kmbart_tpu_torch.checkpoint.io import load_pretrained, params_from_jax
from kmbart_tpu_torch.checkpoint.torch_export import save_torch_pretrained
from kmbart_tpu_torch.serving.continuous import ContinuousGenerationEngine
from kmbart_tpu_torch.serving.engine import GenerationEngine
from tests._torch_port import port_config, port_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from tests.fixtures.make_dataset import make_dataset
    data = str(tmp_path_factory.mktemp("servecli"))
    make_dataset(data)
    cfg = MultiModalBartConfig.from_json(os.path.join(data, "config.json")).replace(
        dtype="float32")
    params = init_conditional_params(jax.random.PRNGKey(8), cfg)
    jax_save_pretrained(os.path.join(data, "ckpt"), cfg,
                        jax.tree_util.tree_map(np.asarray, params))
    return data


def _run(args):
    proc = subprocess.run([sys.executable] + args, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_vcg_eval_twin_logs_same_scores(data_dir, tmp_path):
    """The same generation and reference files: the same BLEU, METEOR,
    CIDEr and (with --annotation) Unique/Novel numbers, printed alike."""
    with open(os.path.join(data_dir, "vcg", "val_ref.json")) as f:
        refs = json.load(f)
    gens = []
    for i, ref in enumerate(refs):
        for task, sents in ref.items():
            # one exact and one altered sentence per entry
            gens.append({"index": i, "task_type": task,
                         "generations": [sents[0], sents[-1] + " again today"]})
    gen_file = str(tmp_path / "gen.json")
    with open(gen_file, "w") as f:
        json.dump(gens, f)
    args = ["--generation", gen_file, "--reference",
            os.path.join(data_dir, "vcg", "val_ref.json")]
    for extra in ([], ["--annotation", os.path.join(data_dir, "vcg", "train.json")]):
        want = _run(["vcg_eval.py"] + args + extra)
        got = _run(["-m", "kmbart_tpu_torch.vcg_eval"] + args + extra)
        assert "CIDEr" in got and got == want


@pytest.mark.parametrize("layer_norms", [False, True], ids=["vcg", "final-norms"])
def test_save_torch_pretrained_roundtrip(tmp_path, layer_norms):
    """The port's load_pretrained gives back every tensor exactly; the JAX
    package's reads the same file (without the stack-end layer norms,
    which its importer does not carry)."""
    cfg = MultiModalBartConfig(
        vocab_size=120, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=2, decoder_attention_heads=2, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_position_embeddings=40, image_feature_size=12,
        max_img_num=3, normalize_before=layer_norms, add_final_layer_norm=layer_norms,
        dtype="float32")
    params = init_conditional_params(jax.random.PRNGKey(2), cfg)
    model = port_model(params, cfg)
    path = str(tmp_path / "export")
    save_torch_pretrained(path, port_config(cfg), model)
    assert sorted(os.listdir(path)) == ["config.json", "pytorch_model.bin"]

    _, back, report = load_pretrained(path, device="cpu")
    want, got = model.state_dict(), back.state_dict()
    assert sorted(got) == sorted(want) and not report
    for name in want:
        assert torch.equal(got[name], want[name]), name
    if layer_norms:
        assert "model.decoder.layer_norm.weight" in torch.load(
            os.path.join(path, "pytorch_model.bin"), weights_only=True)
        return
    _, jax_params, _ = jax_load_pretrained(path, init_conditional_params, strict=False)
    flat_want = params_from_jax(jax.tree_util.tree_map(np.asarray, params), port_config(cfg))
    flat_got = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                               port_config(cfg))
    for name in flat_want:
        assert torch.equal(flat_got[name], flat_want[name]), name


@pytest.mark.parametrize("continuous", [False, True], ids=["static", "continuous"])
def test_serve_twin_flags_build_engine(data_dir, continuous):
    """The root serve.py's flags parse; the device defaults to the card,
    --cpu builds the engine on the CPU, --continuous picks the pool."""
    from kmbart_tpu_torch import serve
    flags = ["--checkpoint", os.path.join(data_dir, "ckpt"), "--encoder_seq_len", "24",
             "--max_length", "6", "--num_beams", "2", "--pool_size", "3",
             "--chunk_steps", "2", "--batch_buckets", "2,4", "--max_batch_size", "4"]
    flags += ["--continuous"] if continuous else []
    assert serve.parse_args(flags).device == "cuda"
    args = serve.parse_args(flags + ["--cpu"])
    assert args.device == "cpu"
    engine = serve.build_engine(args)
    try:
        assert isinstance(engine, ContinuousGenerationEngine if continuous
                          else GenerationEngine)
        assert engine.model.final_logits_bias.device.type == "cpu"
        if continuous:
            assert (engine.pool_size, engine.encoder_seq_len) == (3, 24)
        else:
            assert engine.batch_buckets == (2, 4)
        out = engine.submit(np.array([[0, 9, 10, 11, 2]], np.int32)).result(timeout=120)
        assert out.shape == (1, 6)
    finally:
        engine.shutdown()


def test_serve_twin_cuda_without_card_raises(data_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from kmbart_tpu_torch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_engine(serve.parse_args(["--checkpoint", os.path.join(data_dir, "ckpt")]))


def test_vcg_generate_twin_samples_from_seed(data_dir, tmp_path):
    """--do_sample with --top_k, --top_p and --temperature runs, and one
    --seed gives the same JSON twice."""
    from kmbart_tpu_torch import vcg_generate as twin
    outs = []
    for name, seed in (("a", "5"), ("b", "5")):
        out = str(tmp_path / f"{name}.json")
        twin.main(twin.parse_args([
            "--data_dir", os.path.join(data_dir, "vcg"), "--output_file", out,
            "--checkpoint", os.path.join(data_dir, "ckpt"),
            "--tokenizer_dir", os.path.join(data_dir, "tokenizer"), "--num_beams", "2",
            "--num_gen", "2", "--batch_size", "6", "--max_length", "10", "--do_sample",
            "--top_k", "8", "--top_p", "0.9", "--temperature", "0.8", "--seed", seed,
            "--device", "cpu"]))
        with open(out) as f:
            outs.append(json.load(f))
    assert len(outs[0]) == 18 and all(len(g["generations"]) == 2 for g in outs[0])
    assert outs[0] == outs[1]
