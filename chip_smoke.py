#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and the repository's sources; without a
card, or outside a checkout, it exits non-zero and prints no result.
Phases, each of which fails the run loudly:

1. Build the bucket pack/unpack kernels (K1, K2) from
   ``src/repro_torch/kernels/bucket_pack/csrc`` with ``nvcc`` for sm_90a.
2. Hold K1 and K2 bit-equal to their plain PyTorch versions at the main
   path's bucket shapes (the plan's largest, median and smallest bucket, a
   mixed-dtype bucket, a 40-member bucket, then every bucket of one step)
   and time each against its plain version, a one-call PyTorch yardstick
   and its bandwidth bound.
3. Small reference: reduced qwen2-1.5b in float32, 3 SGD steps on the card
   and on the CPU from the same parameters (the CPU path is the one the
   tests hold to the JAX reference).
4. The main path: full-width qwen2-1.5b, seq 1024, global batch 2, an NCCL
   group of one rank, the ``mgwfbp`` plan under the 4-rank cost prior;
   3 steps with the kernel launch counts read around them, one profiled
   step for the time breakdown, then 3 ``single`` steps from the same init,
   which must give bit-identical parameters.

The last lines are the card (``nvidia-smi``), one JSON object describing
each kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEQ, BATCH, STEPS = 1024, 2, 3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
FOUR_RANK_PRIOR = ((4,), ("data",), ("data",))
KERNELS = {
    "bucket_pack": ("src/repro_torch/kernels/bucket_pack/csrc/bucket_pack.cu",
                    "src/repro/kernels/bucket_pack/kernel.py:46"),
    "bucket_unpack": ("src/repro_torch/kernels/bucket_pack/csrc/bucket_pack.cu",
                      "src/repro/kernels/bucket_pack/kernel.py:80"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def bits(t):
    import torch
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


def bit_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        bool((bits(a) == bits(b)).all())


def max_abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# Configuration of the main path.
# ---------------------------------------------------------------------------

def main_path_config(reduced: bool = False, dtype: str | None = None):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import registry
    bundle = registry.reduced_arch("qwen2-1.5b") if reduced \
        else registry.get_arch("qwen2-1.5b")
    if dtype:
        bundle = dataclasses.replace(
            bundle, cfg=dataclasses.replace(bundle.cfg, dtype=dtype))
    shape = ShapeConfig("smoke", "train", 32 if reduced else SEQ,
                        4 if reduced else BATCH)
    par = dataclasses.replace(
        bundle.parallel, dp_axes=("data",), zero=0, scan_layers=False,
        pack_kernel=True, comm_strategy="mgwfbp",
        attn_chunk=min(bundle.parallel.attn_chunk, shape.seq_len))
    run = dataclasses.replace(bundle.run_config("train_4k", par),
                              model=bundle.cfg, shape=shape)
    return bundle, run, bundle.model(par)


def four_rank_prior():
    from repro_torch.core import cost_model
    return cost_model.production_comm_model(*FOUR_RANK_PRIOR)


# ---------------------------------------------------------------------------
# Phase 2: the kernels against their plain versions.
# ---------------------------------------------------------------------------

def pack_bytes(members, buf_dtype) -> int:
    """K1 reads every member once and writes the whole buffer once."""
    from repro_torch.kernels.bucket_pack import kernel as K
    out = sum(K.slot_elems(m.numel()) for m in members)
    return sum(m.numel() * m.element_size() for m in members) + \
        out * buf_dtype.itemsize


def unpack_bytes(members, buf_dtype) -> int:
    """K2 reads each member's elements of its slot and writes the member."""
    return sum(m.numel() * (m.element_size() + buf_dtype.itemsize)
               for m in members)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_bucket(name: str, members, reps: int = 10) -> dict:
    """K1/K2 on one bucket: bit-equal to the plain versions, the round trip
    the identity, and the times of kernel, plain version and yardstick."""
    import torch
    from repro_torch.kernels.bucket_pack import kernel as K
    table = K.MemberTable(members)
    buf = K.pack(table)
    want = K.pack_plain(members, buf.dtype)
    if not bit_equal(buf, want):
        raise AssertionError(f"{name}: K1 differs from pad-flat-cat "
                             f"(max abs err {max_abs_err(buf, want)})")
    outs = [torch.full_like(m, float("nan")) for m in members]
    out_table = K.MemberTable(outs)
    K.unpack(out_table, buf)
    plain = [torch.empty_like(m) for m in members]
    K.unpack_plain_into(plain, buf)
    for o, p, m in zip(outs, plain, members):
        if not (bit_equal(o, p) and bit_equal(o, m)):
            raise AssertionError(f"{name}: K2 differs from slice-view-cast "
                                 f"or the round trip is not the identity")
    flats = [m.reshape(-1) for m in members]
    views, off = [], 0
    for m in members:
        views.append(buf[off:off + m.numel()].view(m.shape))
        off += K.slot_elems(m.numel())
    r = {
        "pack_ms": cuda_ms(lambda: K.pack(table), reps),
        "pack_plain_ms": cuda_ms(lambda: K.pack_plain(members, buf.dtype),
                                 reps),
        "pack_cat_ms": cuda_ms(lambda: torch.cat(flats), reps),
        "pack_bound_ms": bound_ms(pack_bytes(members, buf.dtype)),
        "unpack_ms": cuda_ms(lambda: K.unpack(out_table, buf), reps),
        "unpack_plain_ms": cuda_ms(lambda: K.unpack_plain_into(plain, buf),
                                   reps),
        "unpack_foreach_copy_ms": cuda_ms(
            lambda: torch._foreach_copy_(plain, views), reps),
        "unpack_bound_ms": bound_ms(unpack_bytes(members, buf.dtype)),
    }
    mb = sum(m.numel() * m.element_size() for m in members) / 2**20
    log(f"  {name}: {len(members)} members, {mb:.2f} MiB, buffer "
        f"{str(buf.dtype).removeprefix('torch.')}: bit-equal; "
        + " ".join(f"{k}={v:.4f}" for k, v in r.items()))
    return r


def phase_kernels(device, plan, shapes) -> dict:
    """Every check of phase 2; returns the per-step numbers of each kernel
    for the JSON line."""
    import torch
    from repro_torch.kernels.bucket_pack import kernel as K
    gen = torch.Generator(device=device).manual_seed(1)
    grads = [torch.randn(s, dtype=torch.bfloat16, device=device,
                         generator=gen) for s in shapes]
    nbytes = [g.numel() * g.element_size() for g in grads]
    buckets = [[grads[i] for i in b] for b in plan.buckets]
    by_size = sorted(range(len(buckets)),
                     key=lambda k: sum(nbytes[i] for i in plan.buckets[k]))
    picks = {"largest": by_size[-1], "median": by_size[len(by_size) // 2],
             "smallest": by_size[0]}
    log(f"[kernels] {plan.num_buckets} buckets over {len(grads)} tensors, "
        f"{sum(nbytes) / 1e9:.3f} GB of bf16 gradients per step")
    for name, k in picks.items():
        check_bucket(f"{name} bucket #{k}", buckets[k])
    small = [m for k in by_size[:2] for m in buckets[k]]
    mixed = [m.float() if j % 2 else m for j, m in enumerate(small)]
    check_bucket("mixed f32/bf16 bucket", mixed)
    check_bucket("40-member bucket", grads[:40])

    # one step's worth: every bucket of the plan, as the train step runs them
    tables = [K.MemberTable(b) for b in buckets]
    bufs = [K.pack(t) for t in tables]
    err = 0.0
    for b, buf in zip(buckets, bufs):
        want = K.pack_plain(b, buf.dtype)
        err = max(err, max_abs_err(buf, want))
        if not bit_equal(buf, want):
            raise AssertionError("K1 differs from pad-flat-cat on the plan")
    outs = [[torch.empty_like(m) for m in b] for b in buckets]
    out_tables = [K.MemberTable(o) for o in outs]
    for t, buf in zip(out_tables, bufs):
        K.unpack(t, buf)
    for o, b in zip(outs, buckets):
        for x, m in zip(o, b):
            err = max(err, max_abs_err(x, m))
            if not bit_equal(x, m):
                raise AssertionError("K2 round trip differs on the plan")
    flats = [[m.reshape(-1) for m in b] for b in buckets]
    views = []
    for b, buf in zip(buckets, bufs):
        vs, off = [], 0
        for m in b:
            vs.append(buf[off:off + m.numel()].view(m.shape))
            off += K.slot_elems(m.numel())
        views.append(vs)

    step = {
        "bucket_pack": dict(
            ms=cuda_ms(lambda: [K.pack(t) for t in tables], 5),
            plain_ms=cuda_ms(lambda: [K.pack_plain(b) for b in buckets], 5),
            library_ms=cuda_ms(lambda: [torch.cat(f) for f in flats], 5),
            bound_ms=bound_ms(sum(pack_bytes(b, torch.bfloat16)
                                  for b in buckets)),
            max_abs_err=err),
        "bucket_unpack": dict(
            ms=cuda_ms(lambda: [K.unpack(t, buf)
                                for t, buf in zip(out_tables, bufs)], 5),
            plain_ms=cuda_ms(lambda: [K.unpack_plain_into(o, buf)
                                      for o, buf in zip(outs, bufs)], 5),
            library_ms=cuda_ms(lambda: [torch._foreach_copy_(o, v)
                                        for o, v in zip(outs, views)], 5),
            bound_ms=bound_ms(sum(unpack_bytes(b, torch.bfloat16)
                                  for b in buckets)),
            max_abs_err=err),
    }
    for name, r in step.items():
        log(f"[kernels] one step, {name}: "
            + " ".join(f"{k}={v:.4f}" for k, v in r.items())
            + f"  (library: {'torch.cat' if name == 'bucket_pack' else 'torch._foreach_copy_'})")
    return step


# ---------------------------------------------------------------------------
# Phases 3 and 4: the train step.
# ---------------------------------------------------------------------------

def train(model, run, device, strategy, *, steps=STEPS, params=None,
          group=None, comm_model=None, counted=False, profile=False):
    """``steps`` steps of the port's train step; returns the final
    parameters (flat, float32 copy), the losses, step times and what the
    launch counters read after the steps."""
    import torch
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels.bucket_pack import kernel as K
    from repro_torch.train.step import build_train_step
    from repro_torch.utils import tree
    step_fn, init_fn, art = build_train_step(
        model, run, group=group, strategy=strategy, comm_model=comm_model,
        device=device)
    gen = torch.Generator(device=device).manual_seed(run.seed)
    state = init_fn(gen, params=params)
    pipe = DataPipeline(model.cfg, run.shape, seed=run.seed)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if counted:
        K.reset_launches()
    losses, times = [], []
    for s in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, pipe.batch_at(s))
        losses.append(metrics["loss"].item())    # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(K.launches)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    final = [p.detach().clone() for p in tree.leaves(state.params)]
    # a step beyond the counted ones, after the snapshot of the parameters
    breakdown = profile_step(step_fn, state, pipe.batch_at(steps)) \
        if profile else None
    out = {"params": final, "losses": losses, "ms": times,
           "launches": launches, "peak_bytes": peak, "plan": art.plan,
           "breakdown": breakdown}
    del state, step_fn, init_fn
    return out


def profile_step(step_fn, state, batch, top: int = 12):
    """One step under torch.profiler: device time by kernel, and the share
    of the step's wall time the card was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        metrics["loss"].item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): the operator
    # rows of key_averages() repeat the time of the kernels they launch
    rows = [(e.device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.device_time_total
            and not e.key.startswith("step/")]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[profile] one mgwfbp step under the profiler: wall "
        f"{wall_ms:.2f} ms, summed device time {busy:.2f} ms over "
        f"{sum(r[1] for r in rows)} device events (streams may overlap)")
    for ms, n, key in rows[:top]:
        log(f"[profile]   {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    # the train step's spans (train/step.py) as ranges on the device's
    # timeline: from the first to the last kernel launched inside each
    spans = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
             if e.key.startswith("step/")
             and str(e.device_type).endswith("CUDA")}
    for key, ms in spans.items():
        log(f"[profile]   span {key}: {ms:.3f} ms on the device")
    for name in ("bucket_copy<true>", "bucket_copy<false>", "nccl",
                 "gemm", "elementwise"):
        hit = [r for r in rows if name in r[2]]
        log(f"[profile]   {name}: {sum(r[0] for r in hit):.3f} ms over "
            f"{sum(r[1] for r in hit)} launches")
    return {"wall_ms": wall_ms, "device_ms": busy}


def phase_small_reference(device):
    """Reduced qwen2-1.5b in float32, 3 SGD-momentum steps on the card and
    on the CPU from the same parameters: the card agrees with the CPU path,
    which tests/test_torch_train_step.py holds to the JAX reference."""
    import torch
    import torch.distributed as dist
    bundle, run, model = main_path_config(reduced=True, dtype="float32")
    run = dataclasses.replace(run, optimizer="sgdm", learning_rate=1e-2,
                              warmup_steps=0)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    gloo = dist.new_group(backend="gloo")
    cpu = train(model, run, "cpu", "mgwfbp", params=params, group=gloo)
    gpu = train(model, run, device, "mgwfbp", params=params)
    err = max(max_abs_err(a.cpu(), b) for a, b in
              zip(gpu["params"], cpu["params"]))
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(gpu["losses"], cpu["losses"]))
    log(f"[reference] reduced qwen2-1.5b f32, 3 sgdm steps: losses card "
        f"{gpu['losses']} cpu {cpu['losses']}; max |param diff| {err:.3e}, "
        f"max loss rel diff {loss_rel:.3e} (tolerance 1e-5 each)")
    if not (err <= 1e-5 and loss_rel <= 1e-5):
        raise AssertionError("the card disagrees with the CPU reference path")
    dist.destroy_process_group(gloo)


def phase_main_path(device, plan_expected) -> dict:
    """Returns the kernel launch counts of the counted mgwfbp steps."""
    import torch
    from repro_torch.utils import tree
    bundle, run, model = main_path_config()
    cfg = bundle.cfg
    log(f"[main] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; seq {SEQ}, "
        f"global batch {BATCH}, 1 rank (NCCL), remat "
        f"{run.parallel.remat}, optimizer {run.optimizer}")
    prior = four_rank_prior()
    mg = train(model, run, device, "mgwfbp", comm_model=prior, counted=True,
               profile=True)
    plan = mg["plan"]
    if plan.buckets != plan_expected.buckets:
        raise AssertionError("the step planned other buckets than phase 2")
    want = plan.num_buckets * STEPS
    log(f"[main] mgwfbp: {plan.num_buckets} buckets over "
        f"{plan.num_tensors} tensors; losses {mg['losses']}; step ms "
        f"{[round(t, 3) for t in mg['ms']]}; peak memory "
        f"{mg['peak_bytes'] / 2**30:.2f} GiB; launches {mg['launches']} "
        f"(want {want} each)")
    if not all(math.isfinite(x) for x in mg["losses"]):
        raise AssertionError("non-finite loss")
    if not abs(mg["losses"][0] - math.log(cfg.vocab_size)) < 1.0:
        raise AssertionError("first loss is far from ln(vocab) at init")
    if mg["launches"] != {"bucket_pack": want, "bucket_unpack": want}:
        raise AssertionError("the main path did not launch K1/K2 once per "
                             "bucket per step")
    shapes = [tuple(p.shape) for p in
              tree.leaves(model.init(None, device="meta"))]
    if [tuple(p.shape) for p in mg["params"]] != shapes or not all(
            bool(torch.isfinite(p).all()) for p in mg["params"]):
        raise AssertionError("parameters changed shape or are not finite")
    launches = mg["launches"]
    mg_params, mg_losses = mg["params"], mg["losses"]
    del mg
    torch.cuda.empty_cache()
    single = train(model, run, device, "single", comm_model=prior)
    same = all(bit_equal(a, b) for a, b in zip(mg_params, single["params"]))
    log(f"[main] single: {single['plan'].num_buckets} bucket; losses "
        f"{single['losses']}; step ms "
        f"{[round(t, 3) for t in single['ms']]}; params bit-identical to "
        f"mgwfbp: {same}")
    if not same or single["losses"] != mg_losses:
        raise AssertionError("single and mgwfbp disagree")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the "
              "card only", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.kernels.bucket_pack import kernel as K
    from repro_torch.train.step import build_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}; nvidia-smi: {card}")

    t0 = time.perf_counter()
    lib, nvcc_log = K.build()
    log(f"[build] {lib.name} with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1,
            device_id=device)
        try:
            bundle, run, model = main_path_config()
            shapes_tree = model.init(None, device="meta")
            plan, _, specs, _ = build_plan(shapes_tree, run, (1,), ("data",),
                                           comm_model=four_rank_prior())
            from repro_torch.core import bucketer
            shapes = [m.shape for m in bucketer.leaf_metadata(shapes_tree)]
            step = phase_kernels(device, plan, shapes)
            torch.cuda.empty_cache()
            phase_small_reference(device)
            torch.cuda.empty_cache()
            launches = phase_main_path(device, plan)
        finally:
            dist.destroy_process_group()

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = step[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"]})
    for line in card:
        print(line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
