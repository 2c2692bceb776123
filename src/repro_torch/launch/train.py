"""Training launcher: a plain MG-WFBP step loop over the port.

On the card (the default)::

    python -m repro_torch.launch.train --arch qwen2-1.5b --steps 20 \\
        --seq-len 1024 --global-batch 2 --strategy mgwfbp

On the CPU with gloo, ``--devices N`` runs N ranks as N processes::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --reduced --steps 5 --devices 2

The flags are the reference launcher's, and so is the ZeRO mode: the
arch's own ``ParallelConfig.zero`` (ZeRO-1 for qwen2-1.5b), printed as
``zero=`` in the header line.  Checkpointing (``--ckpt-dir``,
``--ckpt-every``, ``--resume``) and fault recovery are not ported yet, so
those flags are refused rather than accepted and ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-scale)")
    ap.add_argument("--devices", type=int, default=0,
                    help="run N ranks on the CPU (gloo) instead of one card")
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def run(args, rank: int = 0, world: int = 1, store_path: str = "") -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models import registry
    from repro_torch.train.step import build_train_step

    on_cpu = args.devices > 0
    device = torch.device("cpu") if on_cpu else torch.device("cuda", 0)
    if not on_cpu:
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if on_cpu else "nccl",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        bundle = registry.reduced_arch(args.arch) if args.reduced \
            else registry.get_arch(args.arch)
        shape = SHAPES[args.shape]
        if args.global_batch or args.seq_len:
            shape = ShapeConfig(shape.name, shape.kind,
                                args.seq_len or shape.seq_len,
                                args.global_batch or shape.global_batch)
        # the port's slice: the arch's ZeRO mode, unscanned layers, packed
        # buckets
        par = dataclasses.replace(
            bundle.parallel, dp_axes=("data",), scan_layers=False,
            pack_kernel=True,
            attn_chunk=min(bundle.parallel.attn_chunk, shape.seq_len))
        run_cfg = dataclasses.replace(bundle.run_config(args.shape, par),
                                      shape=shape)
        model = bundle.model(par)
        step_fn, init_fn, art = build_train_step(model, run_cfg,
                                                 strategy=args.strategy,
                                                 device=device)
        if rank == 0:
            print(f"arch={bundle.cfg.name} device={device} world={world} "
                  f"zero={par.zero} plan={art.plan.strategy}:{art.plan.num_buckets} buckets "
                  f"over {art.plan.num_tensors} tensors", flush=True)
        gen = torch.Generator(device=device).manual_seed(run_cfg.seed)
        state = init_fn(gen)
        pipe = DataPipeline(bundle.cfg, shape, seed=run_cfg.seed,
                            batch_override=shape.global_batch // world,
                            shard=rank, num_shards=world)
        for s in range(args.steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, pipe.batch_at(s))
            loss = float(metrics["loss"])           # waits for the step
            dt = time.perf_counter() - t0
            if rank == 0 and s % args.log_every == 0:
                print(f"step {s:5d} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"{dt * 1e3:.0f}ms", flush=True)
        if rank == 0:
            print(f"done at step {state.step}", flush=True)
    finally:
        dist.destroy_process_group()


def _spawned(rank: int, args, world: int, store_path: str) -> None:
    run(args, rank, world, store_path)


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    for flag, value in (("--resume", args.resume or None),
                        ("--ckpt-dir", args.ckpt_dir),
                        ("--ckpt-every", args.ckpt_every)):
        if value is not None:
            raise SystemExit(f"{flag}: checkpointing is not ported yet")
    world = max(args.devices, 1)
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        if world == 1:
            run(args, 0, 1, store)
            return
        import torch.multiprocessing as mp
        mp.start_processes(_spawned, args=(args, world, store),
                           nprocs=world, start_method="spawn")


if __name__ == "__main__":
    main()
