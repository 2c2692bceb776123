"""The port's ZeRO-1 train step on the CPU, against the reference's ZeRO-1.

Reduced qwen2-1.5b (qwen2's own ``zero=1``), unscanned layers, one
data-parallel axis.  The port reduce-scatters each bucket through the
hook-driven machinery, updates its flat shard with
``Optimizer.flat_update`` and all-gathers the parameters; the reference
runs ``step_zero1`` on a one-device ``("data",)`` mesh.

* ``flat_update`` matches the reference's on the same numpy inputs, with
  a 0/1 decay mask, to the ZeRO-0 optimizer test's tolerance (1e-6).
* SGD-momentum parameters after 3 steps match the reference to 1e-5
  (float32 model).  AdamW's first step is ``lr * sign(g)`` and flips on
  gradients near zero, so for AdamW the loss and gradient-norm
  trajectories are compared, to rtol 1e-4.  Both at non-default
  hyperparameters and ``weight_decay > 0``.
* ZeRO-1 differs from ZeRO-0 exactly on the ``_no_decay`` leaves (F4):
  one step from random parameters, without clipping, is bit-equal on
  every decayed leaf and differs on every other one.
* Two gloo ranks in spawned processes end with identical parameters, and
  those match one rank that steps on both ranks' batches to 1e-5.  The
  same ranks run the tree-level ``bucketed_reduce_scatter`` and
  ``bucketed_allgather``, whose round trip is the mean over the ranks, bit
  for bit.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU ops run fastest on one thread, beside JAX's own pool
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs.base import ShapeConfig as RShapeConfig  # noqa: E402
from repro.core import bucketer as r_bucketer  # noqa: E402
from repro.data.pipeline import DataPipeline as RDataPipeline  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import registry as r_registry  # noqa: E402
from repro.optim import optimizers as r_optim  # noqa: E402
from repro.train import step as r_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import bucketer  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEQ, BATCH, STEPS = 32, 4, 3
HYPER = dict(weight_decay=0.1, adam_b1=0.8, adam_b2=0.9, adam_eps=1e-6,
             sgd_momentum=0.7)
TIMEOUT_S = 180


@pytest.fixture(scope="module", autouse=True)
def gloo_world_of_one(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _configs(pkg_registry, shape_cls, *, optimizer, zero=1, microbatch=0,
             pack_kernel=True, grad_clip=None, batch=BATCH):
    b = pkg_registry.reduced_arch("qwen2-1.5b")
    cfg = dataclasses.replace(b.cfg, dtype="float32")
    par = dataclasses.replace(b.parallel, dp_axes=("data",), zero=zero,
                              ep_axis="", scan_layers=False,
                              pack_kernel=pack_kernel, attn_chunk=32)
    run = b.run_config("train_4k", par)
    run = dataclasses.replace(
        run, model=cfg, shape=shape_cls("tiny", "train", SEQ, batch),
        microbatch=microbatch, learning_rate=1e-2, warmup_steps=0,
        optimizer=optimizer,
        grad_clip=run.grad_clip if grad_clip is None else grad_clip,
        **HYPER)
    return dataclasses.replace(b, cfg=cfg).model(par), run


def _port_run(arrays, *, optimizer, steps=STEPS, batches=None, **kw):
    model, run = _configs(registry, ShapeConfig, optimizer=optimizer, **kw)
    step_fn, init_fn, art = build_train_step(model, run, strategy="mgwfbp",
                                             device="cpu")
    state = init_fn(params=bridge.params_from_numpy(arrays, device="cpu"))
    pipe = DataPipeline(model.cfg, run.shape, seed=0)
    losses, norms = [], []
    for s in range(steps):
        batch = batches[s] if batches is not None else pipe.batch_at(s)
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    return bridge.params_to_numpy(state.params), losses, norms, art, state


def _ref_run(*, optimizer, microbatch=0):
    model, run = _configs(r_registry, RShapeConfig, optimizer=optimizer,
                          microbatch=microbatch)
    assert run.parallel.zero == 1
    mesh = make_mesh((1,), ("data",))
    step_fn, init_fn, art = r_step.build_train_step(model, run, mesh,
                                                    strategy="mgwfbp")
    state = jax.jit(init_fn)(jax.random.PRNGKey(0))
    # the reference's ZeRO-1 state: one flat moment dict per bucket
    assert len(state.opt_state) == art.plan.num_buckets
    arrays0 = {p: np.asarray(v) for p, v in
               r_bucketer.leaves_in_backward_order(state.params)}
    pipe = RDataPipeline(model.cfg, run.shape, seed=0)
    jstep = jax.jit(step_fn)
    losses, norms = [], []
    for s in range(STEPS):
        state, metrics = jstep(state, pipe.batch_at(s))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    arrays = {p: np.asarray(v) for p, v in
              r_bucketer.leaves_in_backward_order(state.params)}
    return arrays0, arrays, losses, norms, art


@pytest.mark.parametrize("name", ["adamw", "sgdm"])
def test_flat_update_matches_reference(name):
    """Two flat updates of one shard from the same numpy state, with a
    0/1 decay mask: float32 to 1e-6, as the ZeRO-0 optimizer test."""
    rng = np.random.default_rng(5)
    n = 1000
    p0 = rng.standard_normal(n).astype(np.float32)
    gs = [(3 * rng.standard_normal(n)).astype(np.float32) for _ in range(2)]
    mask = (rng.random(n) < 0.6).astype(np.float32)
    kw = dict(weight_decay=0.05, b1=0.8, b2=0.9, eps=1e-6, momentum=0.7)

    r_opt = r_optim.make_optimizer(name, **kw)
    rp, rs = jnp.asarray(p0), r_opt.init_leaf(jnp.asarray(p0))
    for step, g in enumerate(gs):
        rp, rs = r_opt.flat_update(jnp.asarray(g), rp, rs, jnp.int32(step),
                                   1e-2, jnp.asarray(mask))

    opt = optimizers.make_optimizer(name, **kw)
    for m in (torch.from_numpy(mask), torch.from_numpy(mask).bool()):
        tp = torch.from_numpy(p0.copy())
        ts = opt.init_leaf(tp)
        for step, g in enumerate(gs):
            opt.flat_update(torch.from_numpy(g.copy()), tp, ts, step, 1e-2, m)
        np.testing.assert_allclose(tp.numpy(), np.asarray(rp), rtol=1e-6,
                                   atol=1e-7)
        for k in ts:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(rs[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("microbatch", [0, 2], ids=["one_micro", "two_micro"])
def test_zero1_sgdm_params_match_reference(microbatch):
    arrays0, want, r_losses, r_norms, r_art = _ref_run(
        optimizer="sgdm", microbatch=microbatch)
    got, losses, norms, art, state = _port_run(
        arrays0, optimizer="sgdm", microbatch=microbatch)
    assert art.n_micro == (2 if microbatch else 1)
    assert art.plan.buckets == r_art.plan.buckets
    assert len(state.opt_state) == art.plan.num_buckets
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, r_norms, rtol=1e-5)
    assert list(got) == list(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=0, atol=1e-5,
                                   err_msg=p)


def test_zero1_adamw_trajectory_matches_reference():
    arrays0, _, r_losses, r_norms, _ = _ref_run(optimizer="adamw")
    _, losses, norms, _, _ = _port_run(arrays0, optimizer="adamw")
    np.testing.assert_allclose(losses, r_losses, rtol=1e-4)
    np.testing.assert_allclose(norms, r_norms, rtol=1e-4)


def _random_arrays(seed=0):
    """Every leaf drawn at random, biases and norm scales included, so
    that weight decay moves each of them."""
    model, _ = _configs(registry, ShapeConfig, optimizer="sgdm")
    rng = np.random.default_rng(seed)
    return {m.path: (0.1 * rng.standard_normal(m.shape)).astype(np.float32)
            for m in bucketer.leaf_metadata(model.init(None, device="meta"))}


@pytest.mark.parametrize("name", ["adamw", "sgdm"])
def test_zero1_differs_from_zero0_exactly_on_no_decay_leaves(name):
    arrays = _random_arrays()
    runs = {zero: _port_run(arrays, optimizer=name, zero=zero, steps=1,
                            grad_clip=0.0)[0] for zero in (0, 1)}
    decayed = [p for p in arrays if optimizers._no_decay(p)]
    exempt = [p for p in arrays if not optimizers._no_decay(p)]
    assert decayed and exempt
    assert any("b_q" in p for p in exempt) and \
        any("norm" in p for p in exempt)
    for p in decayed:
        np.testing.assert_array_equal(runs[1][p], runs[0][p], err_msg=p)
    for p in exempt:
        assert not np.array_equal(runs[1][p], runs[0][p]), p


WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[5])
from test_torch_zero1 import _configs
from repro_torch import bridge
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import comm, planner
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models import registry
from repro_torch.train.step import build_train_step

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
pack_kernel = sys.argv[6] == "1"
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
model, run = _configs(registry, ShapeConfig, optimizer="sgdm",
                      pack_kernel=pack_kernel)
step_fn, init_fn, art = build_train_step(model, run, strategy="wfbp",
                                         device="cpu")
arrays = dict(np.load(sys.argv[7]))
state = init_fn(params=bridge.params_from_numpy(arrays, device="cpu"))
pipe = DataPipeline(model.cfg, run.shape, seed=0,
                    batch_override=run.shape.global_batch // world,
                    shard=rank, num_shards=world)
losses = []
for s in range(2):
    state, metrics = step_fn(state, pipe.batch_at(s))
    losses.append(metrics["loss"].item())
np.savez(out, **bridge.params_to_numpy(state.params))

# the tree-level pair on odd sizes, which pad to the rank count
rng = np.random.default_rng([rank, 5])
tree = {"l": [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              for n in (33, 600, 7, 1025)]}
plan = planner.MergePlan(((0, 1), (2,), (3,)))
shards, metas = comm.bucketed_reduce_scatter(tree, plan, mean=True,
                                             use_kernel=pack_kernel)
back = comm.bucketed_allgather(shards, metas, tree, use_kernel=pack_kernel)
np.savez(out + ".tree.npz", *[t.numpy() for t in back["l"]])
dist.destroy_process_group()
print(json.dumps({"losses": losses, "buckets": art.plan.num_buckets}))
"""


@pytest.mark.parametrize("pack_kernel", [True, False],
                         ids=["slots", "plain"])
def test_zero1_two_ranks_match_one_rank(tmp_path, pack_kernel):
    """wfbp plans one bucket per tensor, so the plain layout's buckets
    have odd sizes and are padded to the rank count."""
    world = 2
    arrays = _random_arrays(seed=1)
    init = str(tmp_path / "init.npz")
    np.savez(init, **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(world), store, outs[r],
         str(ROOT / "tests"), "1" if pack_kernel else "0", init],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err
            logs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [dict(np.load(o)) for o in outs]
    assert logs[0]["buckets"] == len(arrays)
    per_rank = []
    for r in range(world):
        rng = np.random.default_rng([r, 5])
        per_rank.append([rng.standard_normal(n).astype(np.float32)
                         for n in (33, 600, 7, 1025)])
    for o in outs:
        back = np.load(o + ".tree.npz")
        for j, (a, b) in enumerate(zip(*per_rank)):
            np.testing.assert_array_equal(back[f"arr_{j}"],
                                          (a + b) / np.float32(world))
    for p in arrays:
        np.testing.assert_array_equal(ranks[0][p], ranks[1][p], err_msg=p)

    # one rank stepping on both ranks' batches, concatenated
    model, run = _configs(registry, ShapeConfig, optimizer="sgdm")
    pipes = [DataPipeline(model.cfg, run.shape, seed=0,
                          batch_override=BATCH // world, shard=r,
                          num_shards=world) for r in range(world)]
    batches = [{k: torch.cat([pp.batch_at(s)[k] for pp in pipes])
                for k in ("tokens", "labels")} for s in range(2)]
    want, losses, _, _, _ = _port_run(arrays, optimizer="sgdm", steps=2,
                                      batches=batches,
                                      pack_kernel=pack_kernel)
    np.testing.assert_allclose(np.mean([l["losses"] for l in logs], axis=0),
                               losses, rtol=1e-5)
    for p in arrays:
        np.testing.assert_allclose(ranks[0][p], want[p], rtol=0, atol=1e-5,
                                   err_msg=p)
