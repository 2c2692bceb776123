"""The hook-driven bucketed all-reduce across two ranks over gloo.

Each case spawns two worker processes (joined with a hard timeout).  Each
rank's gradients are drawn with numpy from a seed of its own; the loss is
built so that autograd marks leaves ready in another order than the
plan's.  The test checks that every reduced gradient is the mean over the
ranks, that every bucket is reduced exactly once per step, and that the
buckets are issued strictly in plan order.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
TIMEOUT_S = 120
SHAPES = [(33,), (4, 70), (600,), (7,), (128,), (3, 5, 7), (1024,), (9,)]

WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.core import bucketer, comm, planner

rank, world, store, use_kernel, plan_arg = sys.argv[1:6]
rank, world, use_kernel = int(rank), int(world), use_kernel == "1"
shapes = json.loads(sys.argv[6])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)

calls = []
_all_reduce = dist.all_reduce
def counting_all_reduce(t, *a, **kw):
    calls.append(t.numel())
    return _all_reduce(t, *a, **kw)
dist.all_reduce = counting_all_reduce

params = {"l": [torch.zeros(s, requires_grad=True) for s in shapes]}
for p in params["l"]:
    p.grad = torch.zeros_like(p)
grads = {"l": [p.grad for p in params["l"]]}
n = len(shapes)
if plan_arg.startswith("["):
    plan = planner.MergePlan(tuple(tuple(b) for b in json.loads(plan_arg)))
else:
    specs = [planner.TensorSpec(m.path, m.nbytes, 1e-4)
             for m in bucketer.leaf_metadata(params)]
    plan = planner.make_plan(plan_arg, specs)
sync = comm.BucketedAllReduce(grads, plan, mean=True, use_kernel=use_kernel)
ready = []
sync.attach(params, lambda i, p: ready.append(i))

out = {"steps": []}
for step in range(2):
    rng = np.random.default_rng([rank, step])
    coef = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    for p in params["l"]:
        p.grad.zero_()
    # terms built in a scrambled order, so leaves become ready out of plan
    # order (backward order is the reverse of the flatten order)
    perm = np.random.default_rng(7 + step).permutation(n)
    loss = sum((params["l"][i] * torch.from_numpy(coef[i])).sum()
               for i in perm)
    calls.clear(); ready.clear()
    sync.start()
    loss.backward()
    sync.finish()
    out["steps"].append({
        "issued": list(sync.issued), "ready": list(ready),
        "calls": list(calls),
        "grads": [p.grad.numpy().ravel().tolist() for p in params["l"]]})

# the non-overlapped entry point on a plain gradient tree
rng = np.random.default_rng([rank, 99])
tree = {"l": [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in shapes]}
red = comm.bucketed_allreduce(tree, plan, mean=True, use_kernel=use_kernel)
out["plain"] = [t.numpy().ravel().tolist() for t in red["l"]]
out["buckets"] = [list(b) for b in plan.buckets]
out["bucket_elems"] = [
    sum(bucketer.slot_elems(int(np.prod(shapes[n - 1 - i])), use_kernel)
        for i in b) for b in plan.buckets]
dist.destroy_process_group()
print(json.dumps(out))
"""


def _run_ranks(tmp_path, use_kernel, plan_arg):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(WORLD), store,
         "1" if use_kernel else "0", plan_arg, json.dumps(SHAPES)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _mean_over_ranks(seed_of_rank):
    per_rank = []
    for r in range(WORLD):
        rng = np.random.default_rng(seed_of_rank(r))
        per_rank.append([rng.standard_normal(s).astype(np.float32)
                         for s in SHAPES])
    return [(a + b) / np.float32(WORLD) for a, b in zip(*per_rank)]


@pytest.mark.parametrize("use_kernel", [True, False], ids=["slots", "plain"])
@pytest.mark.parametrize("plan_arg", [
    "wfbp", "single", "fixed:2048", "[[0, 1, 2], [3], [4, 5, 6], [7]]"],
    ids=["wfbp", "single", "fixed", "custom"])
def test_hook_driven_allreduce_is_mean_in_plan_order(tmp_path, use_kernel,
                                                     plan_arg):
    outs = _run_ranks(tmp_path, use_kernel, plan_arg)
    n_buckets = len(outs[0]["buckets"])
    for step in range(2):
        want = _mean_over_ranks(lambda r: [r, step])
        for out in outs:
            got = out["steps"][step]
            # every bucket reduced exactly once, strictly in plan order
            assert got["issued"] == list(range(n_buckets))
            assert got["calls"] == out["bucket_elems"]
            assert sorted(got["ready"]) == list(range(len(SHAPES)))
            for g, w in zip(got["grads"], want):
                np.testing.assert_array_equal(np.float32(g), w.ravel())
    if n_buckets > 1:
        # autograd's readiness order was not the plan's
        assert outs[0]["steps"][0]["ready"] != list(range(len(SHAPES)))
    want = _mean_over_ranks(lambda r: [r, 99])
    for out in outs:
        for g, w in zip(out["plain"], want):
            np.testing.assert_array_equal(np.float32(g), w.ravel())


def test_launcher_runs_two_ranks_on_cpu():
    """``python -m repro_torch.launch.train`` end to end: two gloo ranks,
    reduced qwen2-1.5b, the packed MG-WFBP step."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-1.5b", "--reduced", "--devices", "2", "--steps", "2",
         "--seq-len", "32", "--global-batch", "4", "--log-every", "1"],
        capture_output=True, text=True, env=env, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr
    assert "world=2" in res.stdout and "done at step 2" in res.stdout
    losses = [float(line.split("loss=")[1].split()[0])
              for line in res.stdout.splitlines() if "loss=" in line]
    assert len(losses) == 2 and np.isfinite(losses).all()
