"""Worker of tests/test_torch_parallel_generate.py: one rank of the PyTorch
port's generation over a split model on the CPU (gloo).

``python -m tests._torch_generate_workers <out_dir> <case>...`` runs the
cases (``CASES``) in one process group whose rendezvous comes from
KMBART_COORDINATOR_ADDRESS, KMBART_NUM_PROCESSES and KMBART_PROCESS_ID
(``start``, ``wait``). Each case loads ``<out_dir>/<params>.npz`` (JAX
layout, written by the test) into the tiny model at fp32 (``config.json``),
cuts it to the rank's part of its grid, and calls ``generate(...,
grid=grid)`` on the batch ``<out_dir>/<batch>.npz``; every rank writes the
array it got to ``<case>.rank<r>.npy``. A grid with pipeline stages must
raise ValueError: the case writes the message instead.

``python -m tests._torch_generate_workers cli <out.json> <vcg_train
argv>...`` runs the ``vcg_train`` twin with ``cli_common.whole_model``
made to raise, and rank 0 writes the token arrays, the generated lists
and the scores of ``--validate_score`` to ``out.json``.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from kmbart_tpu_torch.checkpoint.io import load_state_dict, params_from_jax
from kmbart_tpu_torch.config import MultiModalBartConfig
from kmbart_tpu_torch.generation.api import generate
from kmbart_tpu_torch.models.conditional import init_conditional_model
from kmbart_tpu_torch.parallel import distributed
from kmbart_tpu_torch.parallel.mesh import Grid
from kmbart_tpu_torch.parallel.tp import shard_model_

BEAM = dict(max_length=10, num_beams=3, early_stopping=True)
SAMPLE = dict(max_length=10, num_beams=3, early_stopping=True, do_sample=True, top_k=5)
SAMPLE_SEED = 11

# case -> (world size, grid options, params file, batch file, generate options)
CASES = {
    "dp2": (2, {}, "params0", "b16", BEAM),
    "tp2": (2, dict(model_parallel=2), "params1", "b8", dict(BEAM, num_return_sequences=2)),
    "tp2_greedy": (2, dict(model_parallel=2), "params1", "b8", dict(max_length=10)),
    "dp2_uneven": (2, {}, "params0", "b7", BEAM),
    "dp2_sample": (2, {}, "params0", "b8", SAMPLE),
    "tp2_sample": (2, dict(model_parallel=2), "params0", "b8", SAMPLE),
    "pp2_raises": (2, dict(stages=2), "params0", "b8", BEAM),
    "tp2_dp2": (4, dict(model_parallel=2), "params1", "b8",
                dict(BEAM, num_return_sequences=2)),
    # one row: data coordinate 1 holds an empty block
    "tp2_dp2_one_row": (4, dict(model_parallel=2), "params1", "b1", BEAM),
    # no generator given: the ranks must agree a seed
    "tp2_dp2_sample_unseeded": (4, dict(model_parallel=2), "params0", "b8", SAMPLE),
}


def make_batches(cfg, out_dir):
    """The inputs of tests/test_parallel_generate.py (B 16 from seed 3 and
    B 8 from seed 9, T 10, image slots 1-2) and slices of them, written as
    ``<name>.npz``; returns {name: batch}."""
    batches = {}
    for name, B, seed in (("b16", 16, 3), ("b8", 8, 9)):
        rng = np.random.default_rng(seed)
        T = 10
        ids = rng.integers(4, cfg.vocab_size - 30, (B, T)).astype(np.int32)
        ids[:, 1:3] = cfg.img_feat_id
        batches[name] = dict(
            input_ids=ids, attention_mask=np.ones((B, T), np.int32),
            image_features=rng.normal(size=(B, cfg.max_img_num, cfg.image_feature_size))
            .astype(np.float32))
    batches["b7"] = {k: v[:7] for k, v in batches["b16"].items()}
    batches["b1"] = {k: v[:1] for k, v in batches["b8"].items()}
    for name, batch in batches.items():
        np.savez(os.path.join(out_dir, f"{name}.npz"), **batch)
    return batches


def load_model(cfg, path):
    model = init_conditional_model(cfg, device="cpu")
    with np.load(path) as f:
        load_state_dict(model, params_from_jax(dict(f), cfg))
    return model


def run_case(out_dir, case, cfg):
    _, grid_kw, params, batch_name, kw = CASES[case]
    grid = Grid(**grid_kw)
    model = load_model(cfg, os.path.join(out_dir, f"{params}.npz"))
    if grid.model.size > 1:
        shard_model_(model, cfg, grid)
    with np.load(os.path.join(out_dir, f"{batch_name}.npz")) as f:
        batch = dict(f)
    generator = None
    if kw.get("do_sample") and not case.endswith("_unseeded"):
        generator = torch.Generator().manual_seed(SAMPLE_SEED)
    path = os.path.join(out_dir, f"{case}.rank{distributed.rank()}")
    try:
        out = generate(model, cfg, batch, grid=grid, generator=generator, **kw)
    except ValueError as e:
        if grid.stage.size == 1:
            raise
        with open(path + ".txt", "w") as f:
            f.write(str(e))
        return
    np.save(path + ".npy", out)


def main(out_dir, *cases):
    torch.set_num_threads(1)
    distributed.init_distributed("cpu")
    with open(os.path.join(out_dir, "config.json")) as f:
        cfg = MultiModalBartConfig.from_dict(json.load(f))
    for case in cases:
        run_case(out_dir, case, cfg)
    distributed.shutdown()


def cli(out_json, *argv):
    """The vcg_train twin on ``argv``, recording what --validate_score
    decodes and scores; ``whole_model`` raises."""
    from kmbart_tpu_torch import vcg_train
    from kmbart_tpu_torch.generation import driver
    from kmbart_tpu_torch.training import validation

    def whole_model(*a, **k):
        raise AssertionError("whole_model called without pipeline stages")

    record = {"tokens": [], "generated": [], "scores": []}
    generate_text, score = validation.generate_text, vcg_train.validate_generation_score
    tokens = driver.generate

    def recording_tokens(*a, **k):
        out = tokens(*a, **k)
        record["tokens"].append(out.tolist())
        return out

    def recording_generate_text(*a, **k):
        out = generate_text(*a, **k)
        record["generated"].append(out)
        return out

    def recording_score(*a, **k):
        scores = score(*a, **k)
        record["scores"].append(scores)
        return scores

    vcg_train.whole_model = whole_model
    driver.generate = recording_tokens
    validation.generate_text = recording_generate_text
    vcg_train.validate_generation_score = recording_score
    vcg_train.main(vcg_train.parse_args(list(argv)))
    # main() has left the process group: the rank comes from the rendezvous
    if os.environ.get("KMBART_PROCESS_ID", "0") == "0":
        with open(out_json, "w") as f:
            json.dump(record, f)


def start(out_dir, world, cases):
    """``world`` gloo ranks of this module over ``cases``, started; ``wait``
    collects them."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for r in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   KMBART_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   KMBART_NUM_PROCESSES=str(world), KMBART_PROCESS_ID=str(r))
        procs.append(subprocess.Popen([sys.executable, "-m", "tests._torch_generate_workers",
                                       str(out_dir), *cases], cwd=repo, env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def wait(procs, timeout=300):
    """Raises with the output of a rank that failed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{outs[r][-4000:]}"


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        cli(*sys.argv[2:])
    else:
        main(sys.argv[1], *sys.argv[2:])
