#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and the repository's sources; without a
card, or outside a checkout, it exits non-zero and prints no result.
Phases, each of which fails the run loudly:

1. Build every kernel with ``nvcc`` for sm_90a, one ``nvcc`` per source,
   all started together: the bucket pack/unpack kernels (K1, K2,
   ``kernels/bucket_pack/csrc``), RMSNorm (K3, ``kernels/rmsnorm/csrc``)
   and flash attention (K4, ``kernels/flash_attention/csrc``).
2. Hold K1 and K2 bit-equal to their plain PyTorch versions at the main
   path's bucket shapes (the plan's largest, median and smallest bucket, a
   mixed-dtype bucket, a 40-member bucket, then every bucket of one step)
   and time each against its plain version, a one-call PyTorch yardstick
   and its bandwidth bound.  K1 also meets the edge cases of its chunk
   list (a zero-size member, a member 2 bytes off 16, mixed f32/bf16 into
   either buffer dtype, 1-element members, a member larger than a chunk),
   and is timed over a ZeRO-1 step's two passes (gradients and
   parameters: 284 launches) as well as ZeRO-0's one (142).
3. Small reference: reduced qwen2-1.5b in float32, 3 SGD steps on the card
   and on the CPU from the same parameters (the CPU path is the one the
   tests hold to the JAX reference).
4. The main path: full-width qwen2-1.5b, seq 1024, global batch 2, an NCCL
   group of one rank, the ``mgwfbp`` plan under the 4-rank cost prior;
   3 steps with the kernel launch counts read around them, one profiled
   step for the time breakdown, then 3 ``single`` steps from the same init,
   which must give bit-identical parameters.
4b. ZeRO-1, qwen2's own setting, at phase 4's shape and plan: 3 steps with
   the launch counts read around them (K1 twice per bucket, gradients and
   parameters; K2 once, the gathered parameters), one profiled step, then
   ``mgwfbp`` and ``single`` from the same init without clipping, which
   must give bit-identical parameters.  With clipping on they need not:
   the norm is summed over the plan's buckets, so its rounding, and with
   it the clip scale, depends on the plan.
4c. The Measure stage and the live replan loop, in the same one-rank NCCL
   group at phase 4's shape: the all-reduce fit ``T(M) = a + b*M`` from
   timed NCCL calls at 64 KiB-64 MiB (one rank moves no bytes between
   cards, so it is dispatch cost), the measured forward and backward of
   the full-width model split per tensor, the plans under the measured
   model against the 4-rank prior's, then ``closed_loop`` at ZeRO-0 seeded
   with ``wfbp`` for 6 steps: it must swap to fewer buckets, launch K1 and
   K2 once per bucket of the plan in force every step, and end with
   parameters bit-identical to 6 never-replanned ``wfbp`` steps.  Last,
   ZeRO-1 at qwen2's own setting from the measured plan (2 steps, K1
   twice per bucket), and ``closed_loop`` at ZeRO-1 must refuse.
5. The serving kernels K3 and K4 against their plain versions at the
   serving path's shapes and a few others, each within its stated
   tolerance, and timed against the plain version, one PyTorch call for
   the same function, and the card's bound, with the profiler's device
   time per launch.  K4 in bfloat16 runs the tensor-core kernel at every
   head dim (16, 32, 64, 96, 128), with ragged lengths, window 1, no mask,
   k/v as views of one tensor and Skv != Sq; the profiler must show the
   prefill shape's launches in ``flash_fwd_tc``.  K3's host time per call
   is printed part by part.
6. Small serving reference: reduced qwen2-1.5b in float32, greedy
   ``generate`` on the card (kernels) and on the CPU (plain versions) from
   the same parameters: identical tokens, prefill logits within 1e-4.
7. The serving path: full-width qwen2-1.5b, 8 requests of 1024 prompt
   tokens, 32 new tokens greedy; ``generate`` twice (warm-up, counted) with
   the K3/K4 launch counts read around the counted one, one profiled
   prefill, prefill against the plain versions on the card,
   prefill(S) plus one decode step against prefill(S+1), and two profiled
   decode steps; each profile lists the kernels it traced beside the
   launch counters.

The last lines are the card (``nvidia-smi``), one JSON object describing
each kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEQ, BATCH, STEPS = 1024, 2, 3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor cores, same sheet
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 8, 1024, 32
REPLAN_STEPS, ZERO1_MEASURED_STEPS = 6, 2
COMM_SIZES = (64 << 10, 1 << 20, 16 << 20, 64 << 20)
#: one tensor of each kind, for the measured profile's printout
PROFILED_LEAVES = ("['embed']", "['stages'][0]['blk00']['mlp']['w_up']",
                   "['stages'][0]['blk00']['norm1']")
FOUR_RANK_PRIOR = ((4,), ("data",), ("data",))
KERNELS = {
    "bucket_pack": ("src/repro_torch/kernels/bucket_pack/csrc/bucket_pack.cu",
                    "src/repro/kernels/bucket_pack/kernel.py:46"),
    "bucket_unpack": ("src/repro_torch/kernels/bucket_pack/csrc/bucket_pack.cu",
                      "src/repro/kernels/bucket_pack/kernel.py:80"),
    "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:25"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:84"),
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

def main_path_config(reduced: bool = False, dtype: str | None = None,
                     zero: int = 0, grad_clip: float | None = None):
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
        bundle.parallel, dp_axes=("data",), zero=zero, scan_layers=False,
        pack_kernel=True, comm_strategy="mgwfbp",
        attn_chunk=min(bundle.parallel.attn_chunk, shape.seq_len))
    run = dataclasses.replace(bundle.run_config("train_4k", par),
                              model=bundle.cfg, shape=shape)
    if grad_clip is not None:
        run = dataclasses.replace(run, grad_clip=grad_clip)
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


def k1_edge_cases(device) -> None:
    """K1 over the edge cases of its chunk list, into either buffer dtype,
    bit-equal to pad-flat-cat."""
    import torch
    from repro_torch.kernels.bucket_pack import kernel as K
    gen = torch.Generator(device=device).manual_seed(2)
    bf, f32 = torch.bfloat16, torch.float32

    def member(shape, dtype, off=False):
        x = torch.randn(shape, generator=gen, device=device).to(dtype)
        if off:            # a view one element into its storage
            host = torch.empty(x.numel() + 1, dtype=dtype, device=device)
            host[1:].copy_(x.reshape(-1))
            x = host[1:].view(shape)
        return x

    cases = {
        "zero-size members": [member((0,), bf), member((33,), bf),
                              member((0,), bf), member((1024,), bf)],
        "a member 2 bytes off 16": [member((1000,), bf),
                                    member((4, 300), bf, off=True),
                                    member((17,), bf)],
        "mixed f32/bf16": [member((33,), bf), member((70,), f32),
                           member((600,), bf), member((4, 128), f32),
                           member((4096,), f32)],
        "1-element members": [member((1,), dt) for dt in (bf, f32) * 3],
        "members larger than a chunk": [member((3, 20000), bf),
                                        member((70000,), f32),
                                        member((5,), bf)],
    }
    for name, members in cases.items():
        table = K.MemberTable(members)
        for dtype in (f32, bf):
            buf = K.pack(table, dtype)
            want = K.pack_plain(members, dtype)
            if not bit_equal(buf, want):
                raise AssertionError(f"K1 differs from pad-flat-cat on "
                                     f"{name} into {dtype} (max abs err "
                                     f"{max_abs_err(buf, want)})")
        lists = {str(dt).removeprefix("torch."): [len(x) for x in e[-1]]
                 for dt, e in table.pack_args.items()}
        log(f"  K1 edge case, {name}: bit-equal into float32 and bfloat16 "
            f"buffers; bulk/register chunks {lists}")


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
    k1_edge_cases(device)

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
    # the host's share of a launch: calls on the smallest bucket, whose
    # device time is shorter than the host's work
    k = by_size[0]
    host = {"k1_us": host_ns(lambda: K.pack(tables[k])) / 1e3,
            "cat_us": host_ns(lambda: torch.cat(flats[k])) / 1e3}
    torch.cuda.synchronize()
    step["bucket_pack"]["host_us_per_call"] = host["k1_us"]
    log(f"[kernels] host time per call, smallest bucket ({len(buckets[k])} "
        f"members): K1 {host['k1_us']:.2f} us, torch.cat "
        f"{host['cat_us']:.2f} us")
    for name, r in step.items():
        log(f"[kernels] one step, {name}: "
            + " ".join(f"{k}={v:.4f}" for k, v in r.items())
            + f"  (library: {'torch.cat' if name == 'bucket_pack' else 'torch._foreach_copy_'})")

    # a ZeRO-1 step packs every bucket twice: the gradients, then the
    # parameters (same shapes and dtype)
    params = [torch.randn(s, dtype=torch.bfloat16, device=device,
                          generator=gen) for s in shapes]
    pbuckets = [[params[i] for i in b] for b in plan.buckets]
    ptables = [K.MemberTable(b) for b in pbuckets]
    for b, t in zip(pbuckets, ptables):
        if not bit_equal(K.pack(t), K.pack_plain(b)):
            raise AssertionError("K1 differs from pad-flat-cat on the "
                                 "parameters' buckets")
    pflats = [[m.reshape(-1) for m in b] for b in pbuckets]
    zero1 = dict(
        launches=2 * len(tables),
        ms=cuda_ms(lambda: ([K.pack(t) for t in tables],
                            [K.pack(t) for t in ptables]), 5),
        library_ms=cuda_ms(lambda: ([torch.cat(f) for f in flats],
                                    [torch.cat(f) for f in pflats]), 5),
        bound_ms=2 * step["bucket_pack"]["bound_ms"])
    step["bucket_pack"]["zero1_step"] = zero1
    log("[kernels] one ZeRO-1 step, bucket_pack (gradients and parameters): "
        + " ".join(f"{k}={v:.4f}" for k, v in zero1.items())
        + "  (library: torch.cat)")
    return step


# ---------------------------------------------------------------------------
# Phases 3 and 4: the train step.
# ---------------------------------------------------------------------------

def train(model, run, device, strategy, *, steps=STEPS, params=None,
          group=None, comm_model=None, tb_table=None, counted=False,
          profile=False, label="mgwfbp"):
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
        tb_table=tb_table, device=device)
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
    breakdown = profile_step(step_fn, state, pipe.batch_at(steps), label) \
        if profile else None
    out = {"params": final, "losses": losses, "ms": times,
           "launches": launches, "peak_bytes": peak, "plan": art.plan,
           "breakdown": breakdown}
    del state, step_fn, init_fn
    return out


#: the profiler's names of the port's train-path kernels
PROFILE_KERNELS = {"bucket_pack": "pack_chunks_kernel",
                   "bucket_unpack": "unpack_tiles_kernel"}


def profile_step(step_fn, state, batch, label: str, top: int = 12):
    """One step under torch.profiler: device time by kernel, and the share
    of the step's wall time the card was busy.  Returns the wall and busy
    times and, per K1/K2, ``(device ms, launches)``."""
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
    log(f"[profile] one {label} step under the profiler: wall "
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
    out = {"wall_ms": wall_ms, "device_ms": busy,
           "idle_share": 1 - busy / wall_ms}
    for name in (*PROFILE_KERNELS.values(), "nccl", "gemm", "elementwise"):
        hit = [r for r in rows if name in r[2]]
        out[name] = (sum(r[0] for r in hit), sum(r[1] for r in hit))
        log(f"[profile]   {name}: {out[name][0]:.3f} ms over "
            f"{out[name][1]} launches")
    log(f"[profile]   idle share of the wall time (summed device time, "
        f"streams may overlap): {out['idle_share']:.3f}")
    return out


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
    """Returns the kernel launch counts of the counted mgwfbp steps and the
    profiled step's breakdown."""
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
    out = {"launches": mg["launches"], "breakdown": mg["breakdown"]}
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
    return out


def phase_zero1(device, plan_expected, card) -> dict:
    """Phase 4b: ZeRO-1 at phase 4's shape and plan.  Returns the kernel
    launch counts of the counted mgwfbp steps.  Only the runs without
    clipping are compared bit for bit: with clipping, the norm is a sum
    over the plan's buckets, so its rounding depends on the plan."""
    import torch
    from repro_torch.utils import tree
    bundle, run, model = main_path_config(zero=1)
    cfg = bundle.cfg
    prior = four_rank_prior()
    log(f"[zero1] {cfg.name} full width, seq {SEQ}, global batch {BATCH}, "
        f"1 rank (NCCL), ZeRO-{run.parallel.zero}, optimizer "
        f"{run.optimizer}, grad_clip {run.grad_clip}, weight decay "
        f"{run.weight_decay} (norms and biases exempt)")
    z = train(model, run, device, "mgwfbp", comm_model=prior, counted=True,
              profile=True, label="ZeRO-1 mgwfbp")
    plan = z["plan"]
    if plan.buckets != plan_expected.buckets:
        raise AssertionError("ZeRO-1 planned other buckets than phase 2")
    n = plan.num_buckets * STEPS
    want = {"bucket_pack": 2 * n, "bucket_unpack": n}
    log(f"[zero1] mgwfbp: {plan.num_buckets} buckets; losses {z['losses']}; "
        f"step ms {[round(t, 3) for t in z['ms']]}; peak memory "
        f"{z['peak_bytes'] / 2**30:.2f} GiB; launches {z['launches']} (want "
        f"{want}); card {card}")
    if not all(math.isfinite(x) for x in z["losses"]):
        raise AssertionError("non-finite ZeRO-1 loss")
    if not abs(z["losses"][0] - math.log(cfg.vocab_size)) < 1.0:
        raise AssertionError("first ZeRO-1 loss is far from ln(vocab)")
    if z["launches"] != want:
        raise AssertionError("ZeRO-1 did not launch K1 twice and K2 once "
                             "per bucket per step")
    shapes = [tuple(p.shape) for p in
              tree.leaves(model.init(None, device="meta"))]
    if [tuple(p.shape) for p in z["params"]] != shapes or not all(
            bool(torch.isfinite(p).all()) for p in z["params"]):
        raise AssertionError("ZeRO-1 parameters changed shape or are not "
                             "finite")
    out = {"launches": z["launches"], "breakdown": z["breakdown"],
           "ms": z["ms"], "peak_bytes": z["peak_bytes"]}
    del z
    torch.cuda.empty_cache()
    _, run0, model0 = main_path_config(zero=1, grad_clip=0.0)
    runs = {}
    for strategy in ("mgwfbp", "single"):
        r = train(model0, run0, device, strategy, comm_model=prior)
        runs[strategy] = (r["params"], r["losses"], r["plan"].num_buckets)
        log(f"[zero1] grad_clip 0, {strategy}: {r['plan'].num_buckets} "
            f"buckets; losses {r['losses']}; step ms "
            f"{[round(t, 3) for t in r['ms']]}")
        del r
        torch.cuda.empty_cache()
    same = all(bit_equal(a, b) for a, b in
               zip(runs["mgwfbp"][0], runs["single"][0]))
    log(f"[zero1] grad_clip 0: single and mgwfbp parameters bit-identical: "
        f"{same}")
    if not same or runs["mgwfbp"][1] != runs["single"][1]:
        raise AssertionError("ZeRO-1 single and mgwfbp disagree without "
                             "clipping")
    return out


def measure_costs(device, card, model, run):
    """Phase 4c, parts 1-3: the comm fit, the loss profile, and the plans
    under the measured model against the prior's.  Returns the model,
    ``t_f`` and the per-tensor table."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import bucketer, profiler
    from repro_torch.core.simulator import simulate
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.train import replan
    from repro_torch.train.step import build_plan
    cm = replan.measure_comm_model(dist.group.WORLD, ("data",), COMM_SIZES,
                                   n_warmup=3, n_iters=20,
                                   name="nccl_one_rank", device=device)
    log(f"[measure] NCCL all-reduce of float32 buffers on one rank at "
        f"{[n >> 10 for n in COMM_SIZES]} KiB, least squares: a = "
        f"{cm.a * 1e6:.3f} us, b = {cm.b * 1e9:.6f} ns/B, T(64 MiB) = "
        f"{cm.time(64 << 20) * 1e6:.3f} us; one rank's all-reduce moves no "
        f"bytes between cards, so this fit is dispatch cost only; card "
        f"{card}")
    if not cm.a > 0:
        raise AssertionError("the measured all-reduce latency a is 0: no "
                             "merge would pay")

    params = model.init(torch.Generator(device=device).manual_seed(run.seed),
                        device=device)
    batch = {k: v.to(device) for k, v in
             DataPipeline(model.cfg, run.shape, seed=run.seed)
             .batch_at(0).items()}
    metas = bucketer.leaf_metadata(params)
    t_f, tb = profiler.measure_loss_profile(
        lambda p, b: model.loss(p, b)[0], (params, batch), metas,
        n_warmup=2, n_iters=5)
    del params, batch
    torch.cuda.empty_cache()
    t_b = sum(tb.values())
    prior_tb = profiler.analytic_tb(BATCH * SEQ)
    log(f"[measure] full-width loss profile, batch {BATCH} x {SEQ}: t_f "
        f"{t_f * 1e3:.3f} ms (no_grad forward), t_b {t_b * 1e3:.3f} ms in "
        f"total over {len(tb)} tensors (VJP minus forward, split by size); "
        f"analytic_tb under the TPU priors sums to "
        f"{sum(prior_tb(m) for m in metas) * 1e3:.3f} ms")
    for path in PROFILED_LEAVES:
        m = next(m for m in metas if m.path == path)
        log(f"[measure]   t_b {path} {m.shape}: {tb[path] * 1e6:.3f} us "
            f"(analytic {prior_tb(m) * 1e6:.3f} us)")
    if not (t_f > 0 and t_b > 0 and list(tb) == [m.path for m in metas]):
        raise AssertionError("the loss profile is empty or not positive")

    shapes = model.init(None, device="meta")
    sims, plans = {}, {}
    for strategy in ("wfbp", "mgwfbp", "dp_optimal"):
        plan, _, specs, _ = build_plan(shapes, run, (1,), ("data",),
                                       strategy, tb_table=tb, comm_model=cm)
        plans[strategy] = plan
        sims[strategy] = simulate(specs, plan, cm, t_f)
        log(f"[measure] {strategy:10s} under the measured model: "
            f"{plan.num_buckets} buckets, simulated t_iter "
            f"{sims[strategy].t_iter * 1e3:.6f} ms, non-overlapped comm "
            f"{sims[strategy].t_c_no * 1e6:.3f} us")
    prior, _, _, _ = build_plan(shapes, run, (1,), ("data",),
                                comm_model=four_rank_prior())
    # every strategy's specs carry the same measured t_b
    sim = simulate(specs, prior, cm, t_f)
    log(f"[measure] the 4-rank TPU prior's mgwfbp plan: {prior.num_buckets} "
        f"buckets (the measured mgwfbp plan's buckets: "
        f"{prior.buckets == plans['mgwfbp'].buckets}); under the measured "
        f"model t_iter {sim.t_iter * 1e3:.6f} ms, non-overlapped comm "
        f"{sim.t_c_no * 1e6:.3f} us")
    best = sims["dp_optimal"].t_iter
    if not all(best <= r.t_iter * (1 + 1e-12) for r in sims.values()):
        raise AssertionError("dp_optimal is not the best plan under the "
                             "measured model")
    return cm, t_f, tb


def phase_measured_replan(device, card) -> dict:
    """Phase 4c: measure, plan, then the live replan loop at ZeRO-0 and
    measured-cost ZeRO-1.  Returns K1/K2 launch counts per path."""
    import torch
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels.bucket_pack import kernel as K
    from repro_torch.obs.recorder import FlightRecorder
    from repro_torch.train import replan
    from repro_torch.utils import tree
    bundle, run, model = main_path_config()
    cm, t_f, tb = measure_costs(device, card, model, run)

    rec = FlightRecorder()
    ctl, init_fn, art = replan.closed_loop(
        model, run, strategy="wfbp", tb_table=tb, comm_model=cm, t_f=t_f,
        recorder=rec, warmup=1, interval=2, hysteresis=1e-9, device=device)
    state = init_fn(torch.Generator(device=device).manual_seed(run.seed))
    pipe = DataPipeline(model.cfg, run.shape, seed=run.seed)
    steps, losses = [], []
    K.reset_launches()
    for s in range(REPLAN_STEPS):
        in_force = ctl.plan.num_buckets
        before, refits = dict(K.launches), len(ctl.decisions)
        state, metrics = ctl.step_fn(state, pipe.batch_at(s))
        losses.append(metrics["loss"].item())
        steps.append({"buckets": in_force,
                      "launches": {k: K.launches[k] - before[k]
                                   for k in before},
                      "ms": rec.iterations()[-1].t_iter * 1e3,
                      "residual": ctl.monitor.residual()})
        d = ctl.decisions[-1] if len(ctl.decisions) > refits else None
        log(f"[replan] step {s}: {in_force} buckets in force, launches "
            f"{steps[-1]['launches']}, {steps[-1]['ms']:.3f} ms, loss "
            f"{losses[-1]:.6f}, drift residual {steps[-1]['residual']:.4f}"
            + ("" if d is None else
               f"; refit: stretch {d.stretch:.4f}, a {d.model.a * 1e6:.3f} "
               f"us, b {d.model.b * 1e9:.6f} ns/B, {d.old_plan.num_buckets}"
               f" -> {d.new_plan.num_buckets} buckets, predicted "
               f"{d.predicted_old * 1e3:.6f} -> {d.predicted_new * 1e3:.6f}"
               f" ms, swapped {d.swapped}"))
    launches = dict(K.launches)
    state.grad_sync.check(state.grads)
    final = [p.detach().clone() for p in tree.leaves(state.params)]
    del state
    torch.cuda.empty_cache()
    swaps = [d for d in ctl.decisions if d.swapped]
    if not swaps:
        raise AssertionError("the replan loop never swapped")
    if any(d.new_plan.num_buckets >= d.old_plan.num_buckets or
           d.predicted_new > d.predicted_old for d in swaps):
        raise AssertionError("a swap did not merge or did not predict a win")
    if not rec.events("planner_update"):
        raise AssertionError("the planner recorded no planner_update event")
    for st in steps:
        if st["launches"] != {"bucket_pack": st["buckets"],
                              "bucket_unpack": st["buckets"]}:
            raise AssertionError("K1/K2 launches differ from the plan in "
                                 f"force: {st}")
    if len({st["buckets"] for st in steps}) < 2:
        raise AssertionError("no step ran under the swapped plan")
    ref = train(model, run, device, "wfbp", steps=REPLAN_STEPS,
                comm_model=cm, tb_table=tb)
    same = all(bit_equal(a, b) for a, b in zip(final, ref["params"]))
    log(f"[replan] {len(swaps)} swaps; never-replanned wfbp: losses "
        f"{ref['losses']}, step ms {[round(t, 3) for t in ref['ms']]}; "
        f"parameters bit-identical: {same}")
    if not same or ref["losses"] != losses:
        raise AssertionError("the replanned run differs from wfbp")
    del ref, final
    torch.cuda.empty_cache()

    _, run1, model1 = main_path_config(zero=1)
    z = train(model1, run1, device, "mgwfbp", steps=ZERO1_MEASURED_STEPS,
              comm_model=cm, tb_table=tb, counted=True)
    n = z["plan"].num_buckets * ZERO1_MEASURED_STEPS
    log(f"[replan] ZeRO-1 from the measured plan: {z['plan'].num_buckets} "
        f"buckets; losses {z['losses']}; step ms "
        f"{[round(t, 3) for t in z['ms']]}; launches {z['launches']}")
    if z["launches"] != {"bucket_pack": 2 * n, "bucket_unpack": n} or \
            not all(math.isfinite(x) for x in z["losses"]):
        raise AssertionError("measured-cost ZeRO-1 went wrong")
    zero1_launches = z["launches"]
    del z
    torch.cuda.empty_cache()
    try:
        replan.closed_loop(model1, run1, strategy="wfbp", device=device)
    except NotImplementedError as e:
        log(f"[replan] closed_loop at ZeRO-1 refuses: {e}")
    else:
        raise AssertionError("closed_loop accepted ZeRO-1")
    return {name: {"replan": {"launches": launches[name],
                              "per_step": [st["launches"][name]
                                           for st in steps],
                              "buckets_per_step": [st["buckets"]
                                                   for st in steps]},
                   "zero1_measured": {"launches": zero1_launches[name]}}
            for name in launches}


# ---------------------------------------------------------------------------
# Phase 5: the serving kernels against their plain versions.
# ---------------------------------------------------------------------------

def check_close(name: str, got, want, rtol: float, atol: float) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere; returns
    the max abs error."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: got {got.dtype} {tuple(got.shape)}, "
                             f"want {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = max_abs_err(g, w)
    worst = float(((g - w).abs() / (atol + rtol * w.abs())).max())
    log(f"  {name}: max abs err {err:.3e}; worst |err| / (atol + rtol|want|)"
        f" {worst:.3f} (rtol {rtol:g}, atol {atol:g})")
    if worst > 1.0:
        raise AssertionError(f"{name}: the kernel disagrees with its plain "
                             f"version")
    return err


def randn(shape, dtype, device, seed):
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head: the work K4 must do."""
    import torch
    q = torch.arange(sq)[:, None]
    k = torch.arange(skv)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        mask &= k <= q
    if window:
        mask &= k > q - window
    return int(mask.sum())


def device_us(fn, reps: int, names) -> dict:
    """``fn()`` ``reps`` times under torch.profiler: for each kernel name,
    (device us per launch, launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        hit = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and name in e.key]
        n = sum(e.count for e in hit)
        out[name] = (sum(e.device_time_total for e in hit) / max(n, 1), n)
    return out


def host_ns(fn, n: int = 2000) -> float:
    """Host nanoseconds per call of ``fn`` over ``n`` calls."""
    fn()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n


def rmsnorm_host_breakdown(device) -> None:
    """K3's host cost by part, at decode's shape [8, 1, 1536] bf16: what
    a wrapper that checked every call paid for each part ("was") and
    what this one pays ("now")."""
    import ctypes

    import torch
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.rmsnorm import ops as rn
    x = randn((SERVE_REQUESTS, 1, 1536), torch.bfloat16, device, 60)
    sc = randn((1536,), torch.bfloat16, device, 61)
    x2 = x.reshape(-1, 1536)
    y = torch.empty_like(x)
    lib = RK._lib()
    p = ctypes.c_void_p
    lib.rmsnorm.argtypes = [p, ctypes.c_int, ctypes.c_longlong, p,
                            ctypes.c_int, p, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_float, p]
    lib.rmsnorm.restype = ctypes.c_int
    key = (x.shape, x.stride(), x.dtype, x.device, sc.shape, sc.stride(),
           sc.dtype, sc.device, 1e-6)
    fn, args, raw_stream, index = RK._signatures.get(key) or \
        RK._signature(x, sc, 1e-6, key)
    stream = raw_stream(index)
    parts = {
        "reshape to [R, D] and back (was)": lambda: x.reshape(
            -1, 1536).reshape(x.shape),
        "checks, _check (was every call)": lambda: RK._check(x, sc),
        "signature key + lookup (now)": lambda: RK._signatures.get(
            (x.shape, x.stride(), x.dtype, x.device, sc.shape, sc.stride(),
             sc.dtype, sc.device, 1e-6)),
        "torch.empty(shape, dtype, device) (was)": lambda: torch.empty(
            x2.shape, dtype=x.dtype, device=x.device),
        "torch.empty_like (now)": lambda: torch.empty_like(x),
        "torch.cuda.current_stream().cuda_stream (was)":
            lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "torch._C._cuda_getCurrentRawStream (now)":
            lambda: raw_stream(index),
        "ctypes rmsnorm, 10 arguments + launch (was)": lambda: lib.rmsnorm(
            x2.data_ptr(), 1, x2.stride(0), sc.data_ptr(), 1, y.data_ptr(),
            x2.shape[0], 1536, 1e-6, stream),
        "ctypes rmsnorm_packed, 5 arguments + launch (now)": lambda: fn(
            x.data_ptr(), sc.data_ptr(), y.data_ptr(), args, stream),
        "whole call, ops.rmsnorm (now)": lambda: rn.rmsnorm(x, sc),
    }
    log("[serving kernels] K3 host time per call by part, [8, 1, 1536] bf16 "
        "(perf_counter_ns over 2000 calls each)")
    for name, f in parts.items():
        log(f"  {name}: {host_ns(f) / 1e3:.2f} us")
    torch.cuda.synchronize()


def phase_serving_kernels(device) -> dict:
    """K3 and K4 at every case; returns the numbers of each kernel at the
    serving path's main shape for the JSON line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.rmsnorm import ops as rn
    bf16, f32 = torch.bfloat16, torch.float32
    eps = 1e-6
    rows = SERVE_REQUESTS * SERVE_PROMPT
    out = {}

    log("[serving kernels] K3 rmsnorm against its plain version")
    main_err = 0.0
    for i, (shape, dt) in enumerate([((rows, 1536), bf16),
                                     ((SERVE_REQUESTS, 1536), bf16),
                                     ((SERVE_REQUESTS, 1, 1536), bf16),
                                     ((100, 300), f32),
                                     ((7 * 13, 65), bf16)]):
        x = randn(shape, dt, device, 10 + i)
        sc = randn(shape[-1:], dt, device, 20 + i)
        tol = 2e-2 if dt == bf16 else 1e-5
        err = check_close(f"{list(shape)} {str(dt)[6:]}",
                          rn.rmsnorm(x, sc, eps=eps),
                          RK.rmsnorm_plain(x, sc, eps), tol, 1e-5)
        if i < 2:
            main_err = max(main_err, err)
            nbytes = 2 * x.numel() * x.element_size() + \
                sc.numel() * sc.element_size()
            r = dict(ms=cuda_ms(lambda: rn.rmsnorm(x, sc, eps=eps), 20),
                     plain_ms=cuda_ms(lambda: RK.rmsnorm_plain(x, sc, eps),
                                      20),
                     library_ms=cuda_ms(lambda: F.rms_norm(
                         x, (shape[-1],), sc, eps), 20),
                     bound_ms=bound_ms(nbytes))
            dev_us, n = device_us(lambda: rn.rmsnorm(x, sc, eps=eps), 20,
                                  ["rmsnorm_rows"])["rmsnorm_rows"]
            r["device_ms"] = dev_us / 1e3
            log(f"  {list(shape)} timing: " + " ".join(
                f"{k}={v:.4f}" for k, v in r.items())
                + f"  (library: F.rms_norm; device_ms from the profiler, "
                f"{n} of 20 launches traced)")
            if r["ms"] > r["library_ms"]:
                log(f"  {list(shape)}: K3 misses its target, ms "
                    f"{r['ms']:.4f} > F.rms_norm {r['library_ms']:.4f}")
            if i == 0:
                out["rmsnorm"] = r
    out["rmsnorm"]["max_abs_err"] = main_err
    out["rmsnorm"]["per"] = f"one launch at [{rows}, 1536] bf16"
    rmsnorm_host_breakdown(device)

    log("[serving kernels] K4 flash_attention against its plain version "
        "(bf16: flash_fwd_tc on the tensor cores; f32: SIMT flash_fwd)")
    cases = [  # b, sq, skv, hq, hkv, d, dtype, causal, window, kv view
        (SERVE_REQUESTS, SERVE_PROMPT, SERVE_PROMPT, 12, 2, 128, bf16, True,
         0, False),
        (2, 257, 257, 4, 1, 128, f32, True, 0, False),
        (2, 128, 128, 4, 2, 64, f32, False, 0, False),
        (1, 64, 64, 2, 2, 96, f32, True, 0, False),
        (2, 130, 130, 4, 2, 16, bf16, True, 0, True),
        (2, 128, 128, 4, 2, 32, bf16, False, 0, True),
        (2, 128, 128, 4, 2, 64, bf16, True, 0, True),
        (2, 200, 200, 4, 2, 96, bf16, True, 0, True),
        (2, 257, 257, 4, 1, 128, bf16, True, 37, False),
        (2, 100, 100, 4, 2, 128, bf16, True, 0, True),
        (2, 40, 40, 4, 1, 16, bf16, True, 1, False),
        (2, 257, 257, 4, 1, 128, bf16, True, 1, True),
        (2, 100, 300, 4, 2, 128, bf16, False, 0, True),
        (2, 300, 100, 4, 2, 64, bf16, True, 0, True),
    ]
    for i, (b, sq, skv, hq, hkv, d, dt, causal, window, kv_view) in \
            enumerate(cases):
        q = randn((b, sq, hq, d), dt, device, 30 + i)
        if kv_view:                     # k and v as views of one tensor
            kv = randn((b, skv, 2, hkv, d), dt, device, 40 + i)
            k, v = kv[:, :, 0], kv[:, :, 1]
        else:
            k = randn((b, skv, hkv, d), dt, device, 40 + i)
            v = randn((b, skv, hkv, d), dt, device, 50 + i)
        tol = 2e-2 if dt == bf16 else 2e-5
        name = (f"[{b},{sq}/{skv},{hq}/{hkv},{d}] {str(dt)[6:]} "
                f"{'causal' if causal else 'full'}"
                + (f" window {window}" if window else "")
                + (" kv views" if kv_view else ""))
        err = check_close(name, fa.flash_attention(q, k, v, causal=causal,
                                                   window=window),
                          FK.attention_plain(q, k, v, causal=causal,
                                             window=window), tol, tol)
        if i == 0:
            flops = 4 * d * b * hq * attention_pairs(sq, skv, causal, window)
            nbytes = 2 * (q.numel() + k.numel() + v.numel()) * \
                q.element_size()
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            r = dict(ms=cuda_ms(lambda: fa.flash_attention(q, k, v), 20),
                     plain_ms=cuda_ms(lambda: FK.attention_plain(q, k, v), 5),
                     library_ms=cuda_ms(
                         lambda: F.scaled_dot_product_attention(
                             qt, kt, vt, is_causal=True, enable_gqa=True),
                         20),
                     bound_ms=max(flops / BF16_FLOPS_PER_S,
                                  nbytes / HBM_BYTES_PER_S) * 1e3,
                     max_abs_err=err)
            before = FK.launches["flash_attention"]
            prof = device_us(lambda: fa.flash_attention(q, k, v), 10,
                             ["flash_fwd_tc<", "flash_fwd<"])
            counted = FK.launches["flash_attention"] - before - 1
            r["device_ms"] = prof["flash_fwd_tc<"][0] / 1e3
            log(f"  prefill shape timing: {flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB; " + " ".join(
                    f"{k}={v:.4f}" for k, v in r.items())
                + f"; {flops / r['ms'] / 1e9:.1f} TFLOP/s (device "
                f"{flops / r['device_ms'] / 1e9:.1f}), SDPA "
                f"{flops / r['library_ms'] / 1e9:.1f}  (library: "
                f"F.scaled_dot_product_attention)")
            log(f"  profiler over {counted} launches (the wrapper's "
                f"count): traced flash_fwd_tc {prof['flash_fwd_tc<'][1]}, "
                f"{prof['flash_fwd_tc<'][0]:.1f} us each; traced SIMT "
                f"flash_fwd {prof['flash_fwd<'][1]}")
            if not prof["flash_fwd_tc<"][1] or prof["flash_fwd<"][1]:
                raise AssertionError("bf16 K4 did not run flash_fwd_tc")
            if r["ms"] > 2 * r["library_ms"]:
                log(f"  K4 misses its target: ms {r['ms']:.4f} > 2 x SDPA "
                    f"{2 * r['library_ms']:.4f}")
            r["bound_by"] = "operations" if flops / BF16_FLOPS_PER_S > \
                nbytes / HBM_BYTES_PER_S else "bytes"
            r["per"] = (f"one launch at q [{b},{sq},{hq},{d}], k/v "
                        f"[{b},{skv},{hkv},{d}] bf16 causal")
            out["flash_attention"] = r
            del qt, kt, vt
    bad = torch.zeros((1, 8, 2, 24), device=device)
    try:
        fa.flash_attention(bad, bad, bad)
    except ValueError as e:
        log(f"  D=24 on the card raises ValueError: {e}")
    else:
        raise AssertionError("K4 took an unsupported head dim on the card")
    return out


# ---------------------------------------------------------------------------
# Phases 6 and 7: the serving path.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Route the serving forward through the kernels' plain versions on the
    card, for the reference comparison only: the port itself has no such
    path, and its wrappers raise rather than fall back."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.rmsnorm import ops as rn
    saved = rn.rmsnorm, fa.flash_attention
    rn.rmsnorm = lambda x, s, *, eps=1e-6: RK.rmsnorm_plain(x, s, eps)
    fa.flash_attention = lambda q, k, v, *, causal=True, window=0: \
        FK.attention_plain(q, k, v, causal=causal, window=window)
    try:
        yield
    finally:
        rn.rmsnorm, fa.flash_attention = saved


def serving_model(reduced: bool, dtype: str | None = None):
    from repro_torch.models import registry
    bundle = registry.reduced_arch("qwen2-1.5b") if reduced \
        else registry.get_arch("qwen2-1.5b")
    if dtype:
        bundle = dataclasses.replace(
            bundle, cfg=dataclasses.replace(bundle.cfg, dtype=dtype))
    return bundle, bundle.model(dataclasses.replace(bundle.parallel,
                                                    scan_layers=False))


def reset_serving_launches():
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rmsnorm import kernel as RK
    RK.reset_launches()
    FK.reset_launches()


def serving_launches() -> dict:
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rmsnorm import kernel as RK
    return {**RK.launches, **FK.launches}


def rel_to_max(got, want) -> float:
    return max_abs_err(got, want) / max(float(want.float().abs().max()),
                                        1e-6)


def phase_serving_reference(device):
    """Reduced qwen2-1.5b in float32: the card (kernels) and the CPU (plain
    versions, which tests/test_torch_serve.py holds to the JAX reference)
    give the same greedy tokens and prefill logits within 1e-4."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.utils import tree
    bundle, model = serving_model(reduced=True, dtype="float32")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    card = tree.tree_map(lambda t: t.to(device), params)
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, bundle.cfg.vocab_size, (n,), generator=gen,
                             dtype=torch.int32) for n in (24, 17, 24, 9)]
    cpu_out = ServeEngine(model, params, max_len=48,
                          device="cpu").generate(prompts, 12)
    reset_serving_launches()
    gpu_out = ServeEngine(model, card, max_len=48,
                          device=device).generate(prompts, 12)
    launches = serving_launches()
    toks = torch.stack([p[:9] for p in prompts])
    with torch.inference_mode():
        want, _ = model.prefill(params, {"tokens": toks}, max_len=16)
        got, _ = model.prefill(card, {"tokens": toks.to(device)},
                               max_len=16)
    err = max_abs_err(got.cpu(), want)
    scale = max(1.0, float(want.abs().max()))
    log(f"[serve reference] reduced qwen2-1.5b f32, 4 prompts, 12 new tokens"
        f" greedy: tokens identical {gpu_out == cpu_out}; launches "
        f"{launches}; prefill logits max abs diff {err:.3e} (tolerance "
        f"1e-4 x max(1, max|logit|) = {1e-4 * scale:.3e})")
    layers = bundle.cfg.num_layers
    if launches != {"rmsnorm": (2 * layers + 1) * 12,
                    "flash_attention": layers}:
        raise AssertionError("the reduced engine did not run the kernels")
    if gpu_out != cpu_out or not err <= 1e-4 * scale:
        raise AssertionError("the card disagrees with the CPU serving path")


def profile_serving(label: str, fn, top: int = 12) -> dict:
    """``fn()`` once under torch.profiler: device time by kernel and the
    card's busy share of the wall time, with the K3/K4 launch counters read
    around the same call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    reset_serving_launches()
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = serving_launches()
    rows = [(e.device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.device_time_total]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[serve profile] {label} under the profiler: wall {wall_ms:.2f} ms,"
        f" summed device time {busy:.2f} ms over "
        f"{sum(r[1] for r in rows)} device events: busy share "
        f"{busy / wall_ms:.3f}")
    for ms, n, key in rows[:top]:
        log(f"[serve profile]   {ms:9.3f} ms  x{n:<5d} {key[:90]}")
    for name in ("flash_fwd_tc<", "flash_fwd<", "rmsnorm_rows", "nvjet",
                 "gemm", "elementwise"):
        hit = [r for r in rows if name in r[2]]
        log(f"[serve profile]   {name}: {sum(r[0] for r in hit):.3f} ms over "
            f"{sum(r[1] for r in hit)} launches")
    # the kernels as the trace lists them one by one, against the counters
    kernels = sorted((e for e in prof.events()
                      if str(e.device_type).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
    traced = {"rmsnorm": sum("rmsnorm_rows" in e.name for e in kernels),
              "flash_attention": sum("flash_fwd" in e.name for e in kernels)}
    log(f"[serve profile]   launch counters {counted}; kernels in the trace "
        f"{traced}; first device events: "
        + ", ".join(e.name[:40] for e in kernels[:6]))
    return {"wall_ms": wall_ms, "device_ms": busy, "counted": counted,
            "traced": traced}


def phase_serving_main(device) -> dict:
    """Returns the K3/K4 launch counts of the counted ``generate``."""
    import statistics

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.utils import flops, tree
    bundle, model = serving_model(reduced=False)
    cfg = bundle.cfg
    b, s, new = SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW
    max_len = s + new + 8
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    n_params = flops.param_counts(params)[0]
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}"
        f", heads {cfg.num_heads}/{cfg.num_kv_heads}x"
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
        f", {cfg.dtype}, {n_params:,} parameters; {b} requests x {s} prompt tokens, {new} new tokens "
        f"greedy, max_len {max_len}")
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab_size, (s + 1,), generator=gen,
                             dtype=torch.int32) for _ in range(b)]
    extra = torch.stack(prompts).to(device)      # the S+1 check's tokens
    prompts = [p[:s] for p in prompts]
    engine = ServeEngine(model, params, max_len=max_len, device=device)
    t0 = time.perf_counter()
    engine.generate(prompts, new)
    log(f"[serve] warm-up generate: {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_serving_launches()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, new)
    total_s = time.perf_counter() - t0
    launches = serving_launches()
    peak = torch.cuda.max_memory_allocated()
    prefill_ms, decode_ms = engine.step_ms[0], engine.step_ms[1:]
    shape = ShapeConfig("serve", "prefill", s, b)
    mf = flops.model_flops(cfg, params, shape, "prefill")["model_flops"]
    per_layer = 2 * b * max_len * cfg.num_kv_heads * \
        cfg.resolved_head_dim * 2                # k and v, bf16
    log(f"[serve] counted generate: {total_s * 1e3:.1f} ms for {b * new} "
        f"tokens = {b * new / total_s:.1f} tokens/s; prefill "
        f"{prefill_ms:.2f} ms = {mf / prefill_ms / 1e9:.2f} model TFLOP/s "
        f"({mf / 1e12:.2f} TFLOP); decode ms per token: median "
        f"{statistics.median(decode_ms):.3f}, min {min(decode_ms):.3f}, max "
        f"{max(decode_ms):.3f}; peak memory {peak / 2**30:.2f} GiB; KV cache "
        f"{per_layer * cfg.num_layers / 1e6:.1f} MB; launches {launches}")
    want = {"rmsnorm": (2 * cfg.num_layers + 1) * new,
            "flash_attention": cfg.num_layers}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    if any(len(o) != new for o in outs) or not all(
            0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("generated tokens out of [0, vocab)")
    log(f"[serve] first tokens: req0 {outs[0][:8]}, req1 {outs[1][:8]}")

    toks = extra[:, :s]
    profile_serving("one prefill", lambda: model.prefill(
        params, {"tokens": toks}, max_len=max_len))
    with torch.inference_mode():
        got, cache = model.prefill(params, {"tokens": toks}, max_len=max_len)
        with plain_kernels():
            want_logits, _ = model.prefill(params, {"tokens": toks},
                                           max_len=max_len)
        rel = rel_to_max(got, want_logits)
        if not torch.isfinite(got.float()).all():
            raise AssertionError("non-finite prefill logits")
        lg, _ = model.decode_step(params, cache, extra[:, s:], s)
        longer, _ = model.prefill(params, {"tokens": extra}, max_len=max_len)
        rel_dec = rel_to_max(lg[:, 0], longer)
    log(f"[serve] prefill logits {tuple(got.shape)} {got.dtype}: kernels "
        f"against plain versions on the card, max abs diff / max |logit| = "
        f"{rel:.3e}; prefill({s}) + one decode step against prefill({s + 1})"
        f": {rel_dec:.3e} (tolerance 2e-2 each)")
    if not (rel <= 2e-2 and rel_dec <= 2e-2):
        raise AssertionError("the serving path disagrees with itself")
    nxt = torch.argmax(lg[:, 0], dim=-1)[:, None].to(torch.int32)
    # twice: a kernel missing from the trace in one profile and not the
    # other is the profiler's, not the path's
    for pos in (s + 1, s + 2):
        profile_serving(f"one decode step at {pos}",
                        lambda: model.decode_step(params, cache, nxt, pos))
    del cache, params, engine
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
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rmsnorm import kernel as RK
    with ThreadPoolExecutor(3) as pool:       # one nvcc per source at once
        builds = list(pool.map(lambda m: m.build(), (K, RK, FK)))
    log(f"[build] {', '.join(lib.name for lib, _ in builds)} with nvcc for "
        f"sm_90a in {time.perf_counter() - t0:.1f} s")
    for lib, nvcc_log in builds:
        for line in nvcc_log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "Performance Loss",
                                       "setmaxnreg")):
                log(f"[build]   {lib.name.split('_')[0]}: {line.strip()}")

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
            zero0 = phase_main_path(device, plan)
            torch.cuda.empty_cache()
            zero1 = phase_zero1(device, plan, card)
            torch.cuda.empty_cache()
            measured = phase_measured_replan(device, card)
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    serve = phase_serving_kernels(device)
    torch.cuda.empty_cache()
    phase_serving_reference(device)
    torch.cuda.empty_cache()
    # K1/K2 launches are read on the slice's path (ZeRO-1, phase 4b);
    # phase 4's ZeRO-0 counts and both profiles' device times stand beside
    launches = dict(zero1["launches"])
    launches.update(phase_serving_main(device))
    for name, key in PROFILE_KERNELS.items():
        step[name]["per"] = (f"one ZeRO-0 train step ({plan.num_buckets} "
                             f"buckets)")
        step[name]["launches_by_path"] = {
            f"zero{z}": {"launches": r["launches"][name],
                         "device_ms_per_step": r["breakdown"][key][0],
                         "profiled_launches": r["breakdown"][key][1]}
            for z, r in ((0, zero0), (1, zero1))}
        step[name]["launches_by_path"].update(measured[name])
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = {**step, **serve}[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r.get("bound_by", "bytes"),
            "library_ms": r["library_ms"], "per": r["per"],
            **{k: r[k] for k in ("zero1_step", "launches_by_path",
                                 "host_us_per_call") if k in r}})
    for line in card:
        print(line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
