"""Serving launcher: batched generation with a KV cache (port of
``repro.launch.serve``).

On the card (the default)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --requests 8 --prompt-len 1024 --max-new 32

On the CPU, at a reduced width::

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
        --device cpu --requests 2 --prompt-len 8 --max-new 4

The flags are the reference launcher's plus ``--device``.  Parameters and
prompts are random, from torch generators seeded 0 and 7; they are not the
reference's ``jax.random`` draws.  The engine serves on one device, so
``--devices`` above 1 is refused (sharded serving is ROADMAP item 9).
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    if args.devices > 1:
        raise SystemExit("--devices: the port serves on one device")

    import torch

    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine

    device = torch.device(args.device)
    bundle = registry.reduced_arch(args.arch) if args.reduced \
        else registry.get_arch(args.arch)
    model = bundle.model(dataclasses.replace(bundle.parallel,
                                             scan_layers=False))
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    engine = ServeEngine(model, params,
                         max_len=args.prompt_len + args.max_new + 8,
                         temperature=args.temperature, device=device)
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, bundle.cfg.vocab_size, (args.prompt_len,),
                             generator=gen, dtype=torch.int32)
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=args.max_new)
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    print(f"arch={bundle.cfg.name} device={device}: generated {total} tokens "
          f"for {args.requests} requests in {dt:.2f}s ({total / dt:.1f} "
          f"tok/s incl. prefill and first-call set-up)")
    for i, o in enumerate(outs[:2]):
        print(f"  req{i}: {o[:12]}...")


if __name__ == "__main__":
    main()
