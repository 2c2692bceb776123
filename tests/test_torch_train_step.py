"""The port's MG-WFBP train step, end to end on the CPU.

Reduced qwen2-1.5b, ZeRO-0, unscanned layers, one data-parallel axis.  The
port reduces over a gloo group of one rank, through the hook-driven
bucketed all-reduce; the reference runs on a one-device mesh with
``dp_axes=("data",)``, so that its packed Pallas path really runs.

* Merging is pure scheduling: every strategy, with the packed kernel path
  on or off, gives bit-identical parameters after 3 steps.
* On the same init and batches, the port's parameters after 3 SGD-momentum
  steps match the reference's to 1e-5 (float32 model).  AdamW's first
  step is ``lr * sign(g)`` and flips on gradients near zero, so for AdamW
  the loss trajectory is compared, to rtol 1e-4.
"""

import dataclasses

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
from repro.optim import clip as r_clip  # noqa: E402
from repro.optim import optimizers as r_optim  # noqa: E402
from repro.optim import schedule as r_schedule  # noqa: E402
from repro.train import step as r_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.kernels.bucket_pack import kernel as bp_kernel  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.optim import clip, optimizers, schedule  # noqa: E402
from repro_torch.train.step import build_train_step  # noqa: E402

SEQ, BATCH, STEPS = 32, 4, 3


@pytest.fixture(scope="module", autouse=True)
def gloo_world_of_one(tmp_path_factory):
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _configs(pkg_registry, shape_cls, *, dtype, pack_kernel, optimizer,
             microbatch):
    b = pkg_registry.reduced_arch("qwen2-1.5b")
    cfg = dataclasses.replace(b.cfg, dtype=dtype)
    par = dataclasses.replace(b.parallel, dp_axes=("data",), zero=0,
                              ep_axis="", scan_layers=False,
                              pack_kernel=pack_kernel, attn_chunk=32)
    run = dataclasses.replace(
        b.run_config("train_4k", par), model=cfg,
        shape=shape_cls("tiny", "train", SEQ, BATCH), microbatch=microbatch,
        learning_rate=1e-2, warmup_steps=0, optimizer=optimizer)
    return dataclasses.replace(b, cfg=cfg).model(par), run


def _port_run(strategy="mgwfbp", *, dtype="bfloat16", pack_kernel=True,
              optimizer="adamw", microbatch=0, arrays=None):
    model, run = _configs(registry, ShapeConfig, dtype=dtype,
                          pack_kernel=pack_kernel, optimizer=optimizer,
                          microbatch=microbatch)
    step_fn, init_fn, art = build_train_step(model, run, strategy=strategy,
                                             device="cpu")
    params = None if arrays is None else \
        bridge.params_from_numpy(arrays, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0), params=params)
    pipe = DataPipeline(model.cfg, run.shape, seed=0)
    losses = []
    for s in range(STEPS):
        state, metrics = step_fn(state, pipe.batch_at(s))
        losses.append(metrics["loss"].item())
    return bridge.params_to_numpy(state.params), losses, art


def _ref_run(*, optimizer, microbatch=0, dtype="float32"):
    model, run = _configs(r_registry, RShapeConfig, dtype=dtype,
                          pack_kernel=True, optimizer=optimizer,
                          microbatch=microbatch)
    mesh = make_mesh((1,), ("data",))
    step_fn, init_fn, art = r_step.build_train_step(model, run, mesh,
                                                    strategy="mgwfbp")
    state = jax.jit(init_fn)(jax.random.PRNGKey(0))
    arrays0 = {p: np.asarray(v) for p, v in
               r_bucketer.leaves_in_backward_order(state.params)}
    pipe = RDataPipeline(model.cfg, run.shape, seed=0)
    jstep = jax.jit(step_fn)
    losses = []
    for s in range(STEPS):
        state, metrics = jstep(state, pipe.batch_at(s))
        losses.append(float(metrics["loss"]))
    arrays = {p: np.asarray(v) for p, v in
              r_bucketer.leaves_in_backward_order(state.params)}
    return arrays0, arrays, losses, art


def test_strategies_and_kernel_path_bit_identical():
    runs = {}
    for strategy in ("wfbp", "single", "mgwfbp", "fixed:65536"):
        for pack_kernel in (True, False):
            params, losses, art = _port_run(strategy, pack_kernel=pack_kernel)
            runs[strategy, pack_kernel] = (params, losses, art)
    base_params, base_losses, _ = runs["mgwfbp", True]
    assert np.isfinite(base_losses).all()
    buckets = set()
    for key, (params, losses, art) in runs.items():
        buckets.add(art.plan.num_buckets)
        assert losses == base_losses, key
        for p in base_params:
            np.testing.assert_array_equal(params[p], base_params[p],
                                          err_msg=f"{key} {p}")
    assert len(buckets) > 1          # the strategies really plan differently


def test_step_packs_and_unpacks_once_per_bucket(monkeypatch):
    """The step reaches the kernel wrappers once per bucket per step.  On
    CPU tensors they take the plain versions and count no launch (the
    card's launch counts are checked by chip_smoke.py)."""
    calls = {"pack": 0, "unpack": 0}
    for name in calls:
        real = getattr(bp_kernel, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(bp_kernel, name, counted)
    bp_kernel.reset_launches()
    _, _, art = _port_run("wfbp")
    assert art.plan.num_buckets == art.plan.num_tensors == 26
    assert calls == {"pack": 26 * STEPS, "unpack": 26 * STEPS}
    assert bp_kernel.launches == {"bucket_pack": 0, "bucket_unpack": 0}


@pytest.mark.parametrize("microbatch", [0, 2], ids=["one_micro", "two_micro"])
def test_sgdm_params_match_reference(microbatch):
    arrays0, want, r_losses, r_art = _ref_run(optimizer="sgdm",
                                              microbatch=microbatch)
    got, losses, art = _port_run(dtype="float32", optimizer="sgdm",
                                 microbatch=microbatch, arrays=arrays0)
    assert art.n_micro == (2 if microbatch else 1)
    assert art.plan.buckets == r_art.plan.buckets
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    assert list(got) == list(want)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=0, atol=1e-5,
                                   err_msg=p)


def test_adamw_loss_trajectory_matches_reference():
    arrays0, _, r_losses, _ = _ref_run(optimizer="adamw")
    _, losses, _ = _port_run(dtype="float32", optimizer="adamw",
                             arrays=arrays0)
    np.testing.assert_allclose(losses, r_losses, rtol=1e-4)


def test_schedule_matches_reference():
    r_lr = r_schedule.warmup_cosine(3e-4, 100, 10000)
    lr = schedule.warmup_cosine(3e-4, 100, 10000)
    for step in (0, 1, 50, 99, 100, 101, 777, 5000, 9999, 10000, 20000):
        np.testing.assert_allclose(lr(step), float(r_lr(step)), rtol=3e-7,
                                   err_msg=str(step))


@pytest.mark.parametrize("name", ["adamw", "sgdm"])
def test_optimizer_and_clip_match_reference(name):
    """Two updates of a small tree, clipped first, from the same numpy
    state: float32 to 1e-6 (the bias correction's power may differ by an
    ulp between XLA and numpy)."""
    rng = np.random.default_rng(3)
    shapes = {"['a']": (16, 8), "['b'][0]['norm']": (8,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    gs = [{k: (5 * rng.standard_normal(s)).astype(np.float32)
           for k, s in shapes.items()} for _ in range(2)]
    kw = dict(weight_decay=0.01, b1=0.8, b2=0.9, eps=1e-6, momentum=0.7)

    r_opt = r_optim.make_optimizer(name, **kw)
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    rs = r_opt.init(rp)
    for step, g in enumerate(gs):
        rg = {k: jnp.asarray(v) for k, v in g.items()}
        rg, _ = r_clip.clip_by_global_norm(rg, 1.0)
        rp, rs = r_opt.update(rg, rp, rs, jnp.int32(step), 1e-2)

    opt = optimizers.make_optimizer(name, **kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = opt.init(tp)
    for step, g in enumerate(gs):
        tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
        norm = clip.global_norm(tg)
        np.testing.assert_allclose(
            norm.item(), float(r_clip.global_norm(
                {k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)
        clip.clip_by_global_norm(tg, 1.0, norm)
        opt.update(tg, tp, ts, step, 1e-2)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
