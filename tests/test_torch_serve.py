"""The port's serving path against the reference's, on reduced qwen2-1.5b
with ``scan_layers=False`` on both sides.

Parameters are made by the reference's init and carried over with
``bridge``; caches travel with ``bridge.cache_to_numpy`` and
``cache_from_numpy``.  On the CPU the port's serving forward takes the
plain versions of its kernels (K3 RMSNorm, K4 flash attention), which
``tests/test_torch_serving_kernels.py`` holds to the Pallas kernels.

* prefill: last-token logits (rtol 1e-5) and the primed cache (k, v to
  1e-5, ``slot_pos`` exact), float32, for a full-attention stack and for
  one with a sliding-window layer whose prompt wraps its ring buffer;
* decode_step from a cache the reference primed, for 6 steps, two of them
  past the end of the cache (the reference clamps to the last slot);
* prefill(S) plus one decode step against prefill(S+1), in bfloat16;
* ``ServeEngine.generate``: identical greedy tokens for prompts of lengths
  10 and 5 (left-padded with token 0, no pad mask);
* sampling, and the launcher on the CPU.
"""

import dataclasses
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

from repro.core import bucketer as r_bucketer  # noqa: E402
from repro.models import registry as r_registry  # noqa: E402
from repro.serve import sampling as r_sampling  # noqa: E402
from repro.serve.engine import ServeEngine as RServeEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as RK  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import sampling  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.utils import flops  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S = 2, 12
MAX_LEN = S + 4
VARIANTS = {"dense": {}, "window8": {"sliding_window": 8,
                                     "global_interval": 2}}


def _models(dtype="float32", **cfg_kw):
    out = []
    for reg in (r_registry, registry):
        b = reg.reduced_arch("qwen2-1.5b")
        cfg = dataclasses.replace(b.cfg, dtype=dtype, **cfg_kw)
        par = dataclasses.replace(b.parallel, scan_layers=False)
        out.append(dataclasses.replace(b, cfg=cfg).model(par))
    return out


def _params(r_model, seed=0):
    tree = jax.jit(r_model.init)(jax.random.PRNGKey(seed))
    arrays = {p: np.asarray(v)
              for p, v in r_bucketer.leaves_in_backward_order(tree)}
    return tree, bridge.params_from_numpy(arrays, device="cpu")


def _cache_arrays(cache) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(cache)[0]}


def _tokens(vocab, shape, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _assert_caches_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        if path.endswith("['slot_pos']"):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            # k/v of the second layer carry the float32 rounding of the
            # first (XLA's and torch's sums differ in order): up to 2e-6
            # on values of order 1
            np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                       rtol=1e-5, atol=1e-5, err_msg=path)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_matches_reference(variant):
    r_model, model = _models(**VARIANTS[variant])
    tree, params = _params(r_model)
    toks = _tokens(model.cfg.vocab_size, (B, S))
    r_logits, r_cache = r_model.prefill(tree, {"tokens": jnp.asarray(toks)},
                                        max_len=MAX_LEN)
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                  max_len=MAX_LEN)
    assert logits.shape == (B, model.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               rtol=1e-5, atol=1e-6)
    got = bridge.cache_to_numpy(cache)
    _assert_caches_equal(got, _cache_arrays(r_cache))
    if variant == "window8":
        # the local layer keeps a ring of 8 slots holding positions 4..11
        assert got["[0]['blk00']['k']"].shape[1] == 8
        assert sorted(got["[0]['blk00']['slot_pos']"]) == list(range(4, 12))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_steps_from_reference_cache(variant):
    r_model, model = _models(**VARIANTS[variant])
    tree, params = _params(r_model)
    toks = _tokens(model.cfg.vocab_size, (B, S))
    _, r_cache = r_model.prefill(tree, {"tokens": jnp.asarray(toks)},
                                 max_len=MAX_LEN)
    cache = bridge.cache_from_numpy(_cache_arrays(r_cache), device="cpu")
    steps = _tokens(model.cfg.vocab_size, (6, B, 1), seed=3)
    decode = jax.jit(r_model.decode_step)
    for i, tok in enumerate(steps):
        pos = S + i        # 16 and 17 lie past the 16-slot cache
        r_logits, r_cache = decode(tree, r_cache, jnp.asarray(tok),
                                   jnp.int32(pos))
        logits, cache = model.decode_step(params, cache,
                                          torch.from_numpy(tok), pos)
        assert logits.shape == (B, 1, model.cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                                   rtol=1e-5, atol=1e-6, err_msg=f"pos {pos}")
        _assert_caches_equal(bridge.cache_to_numpy(cache),
                             _cache_arrays(r_cache))


def test_cache_bridge_round_trip_bf16():
    r_model, model = _models("bfloat16")
    want = _cache_arrays(r_model.init_cache(B, MAX_LEN))
    want["[1]['blk00']['k']"] = np.asarray(
        jax.random.normal(jax.random.PRNGKey(0),
                          want["[1]['blk00']['k']"].shape, jnp.bfloat16))
    cache = bridge.cache_from_numpy(want, device="cpu")
    assert cache[1]["blk00"]["k"].dtype == torch.bfloat16
    assert cache[1]["blk00"]["slot_pos"].dtype == torch.int32
    back = bridge.cache_to_numpy(cache)
    _assert_caches_equal(back, want)
    # the port's own empty cache has the reference's paths, shapes, dtypes
    mine = bridge.cache_to_numpy(model.init_cache(B, MAX_LEN, device="cpu"))
    _assert_caches_equal(mine, _cache_arrays(r_model.init_cache(B, MAX_LEN)))


def test_prefill_then_decode_matches_longer_prefill():
    """The port's analog of tests/test_decode.py: in bfloat16, one decode
    step after prefill(S) gives prefill(S+1)'s last logits."""
    _, model = _models("bfloat16")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, (B, 41)))
    with torch.inference_mode():
        gt, _ = model.prefill(params, {"tokens": toks}, max_len=48)
        _, cache = model.prefill(params, {"tokens": toks[:, :40]},
                                 max_len=48)
        lg, _ = model.decode_step(params, cache, toks[:, 40:41], 40)
    gt, lg = gt.float().numpy(), lg[:, 0].float().numpy()
    rel = np.abs(lg - gt).max() / max(np.abs(gt).max(), 1e-6)
    assert rel < 1e-3, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_matches_reference(dtype):
    r_model, model = _models(dtype)
    tree, params = _params(r_model)
    lens = (10, 5)
    r_eng = RServeEngine(r_model, tree, max_len=64)
    want = r_eng.generate([jnp.arange(n, dtype=jnp.int32) for n in lens],
                          max_new_tokens=6)
    eng = ServeEngine(model, params, max_len=64, device="cpu")
    RK.reset_launches()
    FK.reset_launches()
    got = eng.generate([torch.arange(n, dtype=torch.int32) for n in lens],
                       max_new_tokens=6)
    assert got == want
    assert all(len(o) == 6 for o in got)
    # on the CPU the wrappers take the plain versions: no launch counted
    assert RK.launches["rmsnorm"] == 0
    assert FK.launches["flash_attention"] == 0


def test_engine_sampled_tokens_stay_in_vocab():
    """temperature > 0 draws from the engine's seeded torch generator; the
    draws are reproducible in the port but are not jax.random's."""
    _, model = _models()
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [Request(torch.arange(6, dtype=torch.int32)).prompt]
    outs = [ServeEngine(model, params, max_len=32, temperature=0.8, seed=5,
                        device="cpu").generate(prompts, 5) for _ in range(2)]
    assert outs[0] == outs[1]
    assert all(0 <= t < model.cfg.vocab_size for t in outs[0][0])


def test_greedy_sampling():
    logits = np.array([[0.0, 5.0, 1.0], [9.0, 0.0, 0.0], [2.0, 7.0, 7.0]],
                      np.float32)
    got = sampling.greedy(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(r_sampling.greedy(jnp.asarray(logits))))
    np.testing.assert_array_equal(got.numpy(), [[1], [0], [1]])


def test_temperature_topk():
    logits = torch.tensor([[0.0, 10.0, 9.9, -5.0]])
    gen = torch.Generator().manual_seed(0)
    for _ in range(10):
        t = sampling.temperature(logits, gen, temp=0.5, top_k=2)
        assert t.dtype == torch.int32 and t.shape == (1, 1)
        assert int(t[0, 0]) in (1, 2)


def test_model_flops_on_meta_tree():
    b = registry.get_arch("qwen2-1.5b")
    model = b.model(dataclasses.replace(b.parallel, scan_layers=False))
    meta = model.init(None, device="meta")
    total, active = flops.param_counts(meta)
    assert total == active == 1_543_714_304
    from repro_torch.configs.base import ShapeConfig
    f = flops.model_flops(b.cfg, meta, ShapeConfig("p", "prefill", 1024, 8),
                          "prefill")
    assert f["tokens"] == 8192
    assert f["model_flops"] == 2.0 * total * 8192


def test_serve_launcher_on_cpu():
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
           "--device", "cpu", "--requests", "2", "--prompt-len", "8",
           "--max-new", "4"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=240,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr
    assert "generated 8 tokens for 2 requests" in res.stdout
    assert "req1:" in res.stdout
