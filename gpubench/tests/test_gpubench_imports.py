"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the system under test either; top-level
module names are compared whole (``kmbart_tpu_torch`` begins with
``kmbart_tpu``)."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "gpubench")
FORBIDDEN = {"jax", "jaxlib", "flax", "kmbart_tpu"}


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources(BENCH)), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_imports(path):
    names = _top_level_imports(path)
    assert not names & FORBIDDEN
    if os.sep + "reference" + os.sep in path:
        assert "kmbart_tpu_torch" not in names


def test_a_run_loads_no_jax():
    """A whole run in a fresh interpreter ends with none of them loaded (the
    run itself exits 3 and names them if it finds one)."""
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {os.path.dirname(__file__)!r})\n"
        "from conftest import TINY, SEED, tiny_mix\n"
        "from gpubench.harness import runner\n"
        "rc = runner.main(['--workload', 'vcg-finetune-b1024', '--seed', str(SEED),\n"
        "                  '--seconds', '0.2', '--trace', '0'], root=%r,\n"
        "                 device=torch.device('cpu'), cfg_override=TINY,\n"
        "                 mix_override=tiny_mix('vcg-finetune-b1024'))\n"
        "bad = {m.split('.')[0] for m in sys.modules} & %r\n"
        "sys.exit(rc or (4 if bad else 0))\n" % (ROOT, FORBIDDEN))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
