"""PyTorch port, entry point and isolation: the ``vcg_generate`` twin
writes the same JSON as the root CLI, the package imports neither jax nor
anything of ``kmbart_tpu``, and a CUDA request without a card (or a kernel
wrapper handed a tensor on another device) raises instead of falling
back."""

import ast
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kmbart_tpu.checkpoint.io import save_pretrained
from kmbart_tpu.config import MultiModalBartConfig
from kmbart_tpu.models.conditional import init_conditional_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "kmbart_tpu_torch")


def _gen_args(data, ckpt, out):
    return ["--data_dir", os.path.join(data, "vcg"), "--output_file", out,
            "--checkpoint", ckpt, "--tokenizer_dir", os.path.join(data, "tokenizer"),
            "--num_beams", "2", "--num_gen", "2", "--batch_size", "6",
            "--max_length", "10"]


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    from tests.fixtures.make_dataset import make_dataset
    data = str(tmp_path_factory.mktemp("torchcli"))
    make_dataset(data)
    cfg = MultiModalBartConfig.from_json(os.path.join(data, "config.json"))
    cfg = cfg.replace(dtype="float32")
    ckpt = os.path.join(data, "ckpt")
    params = init_conditional_params(jax.random.PRNGKey(3), cfg)
    save_pretrained(ckpt, cfg, jax.tree_util.tree_map(np.asarray, params))
    return data, ckpt


def test_vcg_generate_twin_writes_same_json(cli_setup, tmp_path):
    sys.path.insert(0, REPO)
    import vcg_generate
    from kmbart_tpu_torch import vcg_generate as twin

    data, ckpt = cli_setup
    ref_out, out = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    old = sys.argv
    sys.argv = ["vcg_generate"] + _gen_args(data, ckpt, ref_out) + ["--cpu"]
    try:
        vcg_generate.main(vcg_generate.parse_args())
    finally:
        sys.argv = old
    twin.main(twin.parse_args(_gen_args(data, ckpt, out) + ["--device", "cpu"]))
    with open(ref_out) as f:
        want = json.load(f)
    with open(out) as f:
        got = json.load(f)
    assert len(got) == 18 and all(len(g["generations"]) == 2 for g in got)
    assert got == want


def test_device_cuda_without_card_raises(cli_setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from kmbart_tpu_torch import vcg_generate as twin
    data, ckpt = cli_setup
    args = twin.parse_args(_gen_args(data, ckpt, str(tmp_path / "x.json")))
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main(args)


def test_kernel_wrappers_refuse_other_devices():
    """Only a CPU tensor selects the plain version: any other device goes
    to the kernel launch path, which refuses what it cannot run."""
    from kmbart_tpu_torch.ops import beam_attention, ffn, train_attention, vocab_stats
    m = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        train_attention.train_attention_flat(m(1, 8, 32), m(1, 8, 32), m(1, 8, 32), None,
                                             num_heads=4)
    with pytest.raises(ValueError, match="no kernel"):
        ffn.fused_ffn(m(4, 32), m(64, 32), m(64), m(32, 64), m(32))
    with pytest.raises(ValueError, match="no kernel"):
        beam_attention.beam_gather_attention(m(6, 32), m(2, 3, 5, 32), m(2, 3, 5, 32),
                                             m(6, 5).int(), 0, num_beams=3, num_heads=4)
    with pytest.raises(ValueError, match="no kernel"):
        vocab_stats.chunk_stats(m(4, 3000))


def test_port_imports_no_jax():
    """A fresh interpreter imports the port, generates on the CPU, and never
    loads jax or any module of kmbart_tpu."""
    code = (
        "import sys, numpy as np\n"
        "from kmbart_tpu_torch.config import tiny_config\n"
        "import kmbart_tpu_torch.vcg_generate, kmbart_tpu_torch.cli_common\n"
        "from kmbart_tpu_torch.models.conditional import init_conditional_model\n"
        "from kmbart_tpu_torch.generation.api import generate\n"
        "cfg = tiny_config(dtype='float32')\n"
        "out = generate(init_conditional_model(cfg, device='cpu'), cfg,\n"
        "               {'input_ids': np.array([[0, 5, 6, 7, 2]])}, num_beams=2,\n"
        "               max_length=6)\n"
        "assert out.shape[0] == 1\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules if m == 'kmbart_tpu' or m.startswith('kmbart_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# the port imports none of these, matched as a whole name or a dotted prefix
# (so kmbart_tpu_torch does not match kmbart_tpu): jax, the JAX package, and
# the root scripts/ package, whose twins live in kmbart_tpu_torch/scripts
_JAX_MODULES = ("jax", "jaxlib", "kmbart_tpu", "scripts")


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(PORT):
        yield from (os.path.join(root, name) for name in files if name.endswith(".py"))


def test_no_jax_import_in_source():
    """No module of the port (its data-preparation subpackages included),
    and not chip_smoke.py, imports jax, kmbart_tpu or the root scripts
    package."""
    offenders = []
    sources = list(_port_sources())
    for sub in ("vision", "knowledge", "scripts"):
        assert any(os.sep + os.path.join("kmbart_tpu_torch", sub) + os.sep in p
                   for p in sources), sub
    for module in ("parallel/distributed.py", "parallel/zero1.py", "checkpoint/sharded.py",
                   "parallel/mesh.py", "parallel/tp.py", "parallel/sp.py", "parallel/pp.py",
                   "utils/profiling.py", "scripts/prepare_coco.py", "scripts/prepare_vg.py",
                   "scripts/prepare_cc.py", "scripts/prepare_sbu.py",
                   "scripts/prepare_coco_reason.py", "scripts/prepare_cc_reason.py",
                   "scripts/prepare_sbu_reason.py"):
        assert os.path.join(PORT, *module.split("/")) in sources, module
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            else:
                continue
            offenders += [f"{path}: {m}" for m in mods
                          if any(m == j or m.startswith(j + ".") for j in _JAX_MODULES)]
    assert not offenders, offenders
