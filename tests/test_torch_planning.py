"""The port's planning core against the reference: the same specs and cost
model give the same buckets and the same simulated iteration time, to the
bit, for every ported strategy."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU ops run fastest on one thread, beside JAX's own pool
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.base import ShapeConfig as RShapeConfig  # noqa: E402
from repro.core import cost_model as r_cost  # noqa: E402
from repro.core import planner as r_planner  # noqa: E402
from repro.core import comm as r_comm  # noqa: E402
from repro.core import simulator as r_sim  # noqa: E402
from repro.models import registry as r_registry  # noqa: E402
from repro.obs import recorder as r_recorder  # noqa: E402
from repro.train import step as r_step  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import comm, cost_model, planner, simulator  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.obs import recorder  # noqa: E402
from repro_torch.train import step  # noqa: E402

STRATEGIES = ("wfbp", "single", "mgwfbp", "dp_optimal", "dp_incremental",
              "fixed:65536")


def _quickstart_profile():
    """The ResNet-50-like profile and cluster of examples/quickstart.py."""
    rng = np.random.default_rng(0)
    sizes = np.concatenate([
        rng.integers(256, 4096, 120),
        rng.integers(65536, 1 << 20, 35),
        np.array([2048 * 1000, 512 * 2048 * 4]),
    ])[:161]
    sizes = (sizes / sizes.sum() * 25.5e6).astype(int)
    t_b = sizes / sizes.sum() * 0.120
    a, b = r_cost.PAPER_CLUSTERS["cluster1_k80_10gbe"]
    return [int(s) * 4 for s in sizes], [float(t) for t in t_b], (a, b)


def _drawn_profile(seed):
    """Drawn like tests/prop_strategies.py: 1-8 tensors of 1 B - 4 MiB,
    1 us - 5 ms each, a in [0, 2 ms], b in [1e-11, 1e-8] s/B."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    sizes = [int(x) for x in rng.integers(1, (1 << 22) + 1, n)]
    times = [float(x) for x in rng.uniform(1e-6, 5e-3, n)]
    ab = (float(rng.uniform(0.0, 2e-3)), float(rng.uniform(1e-11, 1e-8)))
    return sizes, times, ab


PROFILES = [_quickstart_profile()] + [_drawn_profile(s) for s in range(6)]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("profile", range(len(PROFILES)),
                         ids=["quickstart"] + [f"drawn{s}" for s in range(6)])
def test_make_plan_and_simulate_bit_equal(profile, strategy):
    sizes, times, (a, b) = PROFILES[profile]
    r_specs = [r_planner.TensorSpec(f"t{i}", s, t)
               for i, (s, t) in enumerate(zip(sizes, times))]
    specs = [planner.TensorSpec(f"t{i}", s, t)
             for i, (s, t) in enumerate(zip(sizes, times))]
    r_model, model = r_cost.AllReduceModel(a, b), cost_model.AllReduceModel(a, b)
    r_plan = r_planner.make_plan(strategy, r_specs, r_model)
    plan = planner.make_plan(strategy, specs, model)
    assert plan.buckets == r_plan.buckets
    assert plan.strategy == r_plan.strategy
    r_res = r_sim.simulate(r_specs, r_plan, r_model, t_f=0.06)
    res = simulator.simulate(specs, plan, model, t_f=0.06)
    assert res.t_iter == r_res.t_iter
    assert res.t_c_no == r_res.t_c_no
    assert res.overlap_ratio == r_res.overlap_ratio
    assert plan.merged_flags() == r_plan.merged_flags()
    assert plan.bucket_bytes(specs) == r_plan.bucket_bytes(r_specs)
    assert recorder.plan_fingerprint(plan) == \
        r_recorder.plan_fingerprint(r_plan)
    assert comm.collective_bytes_of_plan(plan, sizes) == \
        r_comm.collective_bytes_of_plan(r_plan, sizes)


def test_production_comm_model_bit_equal():
    for args in [((4,), ("data",), ("data",)), ((1,), ("data",), ("data",)),
                 ((2, 4), ("pod", "data"), ("pod", "data"))]:
        r = r_cost.as_linear(r_cost.production_comm_model(*args))
        p = cost_model.as_linear(cost_model.production_comm_model(*args))
        assert (p.a, p.b) == (r.a, r.b), args


def test_unported_strategies_name_the_roadmap():
    specs = [planner.TensorSpec("t0", 4096, 1e-3)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        planner.make_plan("dp_batched", specs, cost_model.AllReduceModel(0, 0))


@pytest.mark.parametrize("mesh_shape,n_buckets", [((1,), 142), ((4,), 114)],
                         ids=["one_card", "four_ranks"])
def test_full_width_qwen2_plan_under_four_rank_prior(mesh_shape, n_buckets):
    """Full-width qwen2-1.5b at seq 1024, global batch 2: its 338 gradient
    tensors merged as the reference merges them, port on the meta device,
    reference on eval_shape.  The cost model is the 4-rank prior either
    way; the mesh shape sets the tokens per device that the backward-time
    model sees: 2048 on one card (142 buckets), 1024 when the batch is
    spread over four ranks (114 buckets)."""
    shape = (1024, 2)
    prior = ((4,), ("data",), ("data",))

    r_bundle = r_registry.get_arch("qwen2-1.5b")
    r_par = dataclasses.replace(r_bundle.parallel, dp_axes=("data",), zero=0,
                                scan_layers=False, pack_kernel=True)
    r_run = dataclasses.replace(
        r_bundle.run_config("train_4k", r_par),
        shape=RShapeConfig("smoke", "train", *shape))
    r_shapes = jax.eval_shape(
        lambda: r_bundle.model(r_par).init(jax.random.PRNGKey(0)))
    r_plan, _, r_specs, _ = r_step.build_plan(
        r_shapes, r_run, mesh_shape, ("data",), "mgwfbp",
        comm_model=r_cost.production_comm_model(*prior))

    bundle = registry.get_arch("qwen2-1.5b")
    par = dataclasses.replace(bundle.parallel, dp_axes=("data",), zero=0,
                              scan_layers=False, pack_kernel=True)
    run = dataclasses.replace(bundle.run_config("train_4k", par),
                              shape=ShapeConfig("smoke", "train", *shape))
    shapes = bundle.model(par).init(None, device="meta")
    plan, _, specs, _ = step.build_plan(
        shapes, run, mesh_shape, ("data",), "mgwfbp",
        comm_model=cost_model.production_comm_model(*prior))

    assert len(specs) == len(r_specs) == 338
    assert [(s.name, s.nbytes, s.t_b) for s in specs] == \
        [(s.name, s.nbytes, s.t_b) for s in r_specs]
    assert sum(s.nbytes for s in specs) == 2 * 1_543_714_304
    assert plan.num_buckets == r_plan.num_buckets == n_buckets
    assert plan.buckets == r_plan.buckets


def test_incremental_planner_updates_bit_equal():
    """``Planner.update`` through a stream of deltas (spec edits, a cost
    model swap, truncation, appends): the same plan and finish time as the
    reference's at every step, and the same recorded events."""
    sizes, times, (a, b) = _quickstart_profile()

    class Rec:
        def __init__(self):
            self.events = []

        def record(self, ev):
            self.events.append((ev.kind, ev.time, ev.source, ev.args))

    rng = np.random.default_rng(5)
    deltas = []
    for k in range(6):
        idx = [int(i) for i in rng.integers(0, 120, 3)]
        deltas.append(dict(
            updates={i: (f"t{i}", int(rng.integers(1, 1 << 20)),
                         float(rng.uniform(1e-5, 1e-3))) for i in idx},
            model=(a * (1 + k), b) if k % 2 else None,
            truncate=150 - k if k == 3 else None,
            append=((f"x{k}", 4096 * (k + 1), 2e-4),) if k >= 3 else ()))

    def drive(pl_mod, cm_mod):
        rec = Rec()
        spec = pl_mod.TensorSpec
        p = pl_mod.Planner([spec(f"t{i}", s, t) for i, (s, t)
                            in enumerate(zip(sizes, times))],
                           cm_mod.AllReduceModel(a, b), recorder=rec)
        out = [(p.plan().buckets, p.finish_time)]
        for d in deltas:
            p.update(pl_mod.SpecDelta(
                model=None if d["model"] is None else
                cm_mod.AllReduceModel(*d["model"]),
                updates={i: spec(*v) for i, v in d["updates"].items()},
                truncate=d["truncate"],
                append=tuple(spec(*v) for v in d["append"])))
            out.append((p.plan().buckets, p.finish_time))
        return out, rec.events

    assert drive(planner, cost_model) == drive(r_planner, r_cost)
