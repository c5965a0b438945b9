"""PyTorch port, generation over a split model on the CPU, held against the
JAX package: twins of tests/test_parallel_generate.py:21 (beam search with
the batch split over data ranks) and :53 (beam search on Megatron-TP
parameters on a data x model grid).

Gloo ranks of tests/_torch_generate_workers.py, at the tiny config in fp32
(2 + 2 layers, d_model 32, 4 heads), on the inputs that JAX test makes (B
16 and 8, T 10, two image slots; beam 3, max_length 10, early stopping):

- at 2 ranks: DP 2; TP 2 with num_return_sequences 2; greedy at TP 2; DP 2
  with B 7 (blocks of 4 and 3); beam sampling (top_k 5) at DP 2 and at
  TP 2; and a grid with pipeline stages, which raises;
- at 4 ranks: TP 2 x DP 2, the same with one row (an empty block), and
  sampling at TP 2 x DP 2 with no generator given.

Each deterministic case's tokens equal the JAX package's single-device
``generate`` exactly, output width included, and every case's (sampled
ones at the same generator seed) equal the port's one process; every rank
returns the same array (without a generator too: the ranks agree a seed).
"""

import json

import jax
import numpy as np
import pytest
import torch

from kmbart_tpu.generation.api import generate as jax_generate
from kmbart_tpu.models.conditional import init_conditional_params
from kmbart_tpu_torch.checkpoint.io import _flatten
from kmbart_tpu_torch.config import MultiModalBartConfig
from kmbart_tpu_torch.generation.api import generate
from kmbart_tpu_torch.parallel.distributed import all_gather_blocks, world_axis
from tests import _torch_generate_workers as workers
from tests._torch_port import port_config

JAX_CASES = ["dp2", "tp2", "tp2_greedy", "dp2_uneven", "tp2_dp2"]
RAN = [c for c in workers.CASES if c != "pp2_raises"]
CASES = [c for c in RAN if not c.endswith("_unseeded")]   # one process draws alike


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tiny_cfg):
    out = tmp_path_factory.mktemp("pgen")
    jcfg = tiny_cfg.replace(dtype="float32")
    cfg = port_config(jcfg)
    with open(out / "config.json", "w") as f:
        json.dump(jcfg.to_dict(), f)
    # the parameters of the two JAX tests (PRNGKey 0 and 1)
    params = {f"params{k}": init_conditional_params(jax.random.PRNGKey(k), jcfg)
              for k in (0, 1)}
    for name, tree in params.items():
        np.savez(out / f"{name}.npz", **_flatten(jax.tree.map(np.asarray, tree)))
    batches = workers.make_batches(cfg, str(out))
    # each world size once, for all its cases, both running while the
    # references are computed here
    procs = {world: workers.start(out, world, [c for c, v in workers.CASES.items()
                                               if v[0] == world])
             for world in (2, 4)}
    try:
        jax_refs = {}
        for case in JAX_CASES:
            _, _, p, b, kw = workers.CASES[case]
            jax_refs[case] = np.asarray(jax_generate(params[p], jcfg, batches[b], **kw))
        port_refs = {}
        for case in CASES:
            _, _, p, b, kw = workers.CASES[case]
            model = workers.load_model(cfg, out / f"{p}.npz")
            generator = (torch.Generator().manual_seed(workers.SAMPLE_SEED)
                         if kw.get("do_sample") else None)
            port_refs[case] = generate(model, cfg, batches[b], generator=generator, **kw)
    finally:
        for p in procs.values():
            workers.wait(p)
    got = {case: [np.load(out / f"{case}.rank{r}.npy") for r in range(workers.CASES[case][0])]
           for case in RAN}
    return out, got, jax_refs, port_refs


@pytest.mark.parametrize("case", JAX_CASES)
def test_split_generate_matches_jax_single_device(runs, case):
    _, got, jax_refs, _ = runs
    assert got[case][0].dtype == np.int32
    np.testing.assert_array_equal(got[case][0], jax_refs[case])   # tokens and width


@pytest.mark.parametrize("case", CASES)
def test_split_generate_matches_one_process(runs, case):
    _, got, _, port_refs = runs
    np.testing.assert_array_equal(got[case][0], port_refs[case])


@pytest.mark.parametrize("case", RAN)
def test_every_rank_returns_the_same_array(runs, case):
    _, got, _, _ = runs
    for r, arr in enumerate(got[case][1:], 1):
        np.testing.assert_array_equal(arr, got[case][0], err_msg=f"rank {r}")


def test_block_needs_the_whole_batch_noise(runs):
    """Data coordinate 1's rows decoded alone at the same seed, drawing only
    their own noise, give other tokens than those rows of one process: the
    whole-batch draw is what makes the sampled cases agree."""
    out, got, _, _ = runs
    _, _, p, b, kw = workers.CASES["dp2_sample"]
    with open(out / "config.json") as f:
        cfg = MultiModalBartConfig.from_dict(json.load(f))
    with np.load(out / f"{b}.npz") as f:
        block = {k: v[4:] for k, v in f.items()}
    alone = generate(workers.load_model(cfg, out / f"{p}.npz"), cfg, block, trim=False,
                     generator=torch.Generator().manual_seed(workers.SAMPLE_SEED), **kw)
    whole = got["dp2_sample"][0][4:]
    assert not np.array_equal(alone[:, :whole.shape[1]], whole)


def test_pipeline_grid_raises(runs):
    out, _, _, _ = runs
    for r in range(2):
        assert "does not run inside a pipeline" in (out / f"pp2_raises.rank{r}.txt").read_text()


def test_all_gather_blocks_one_rank():
    """The gather at a size-1 axis: the block's rows, the tag."""
    block = torch.tensor([[5, 6, 7], [8, 9, 10]])
    rows, tags = all_gather_blocks(block, 3, 1, world_axis(), tag=4)
    assert rows.tolist() == block.tolist() and tags == [4]
    rows, tags = all_gather_blocks(block[:0], 3, 1, world_axis(), tag=0)
    assert rows.shape == (0, 3) and tags == [0]
