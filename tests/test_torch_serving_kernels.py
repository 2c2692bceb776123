"""The serving kernels' plain versions in the port against the reference.

The same numpy inputs go through the reference's Pallas kernels (interpret
mode) and their jnp oracles, and through the port's wrappers, which take
the plain PyTorch versions for tensors on the CPU:

* K3, RMSNorm: float32 to rtol 1e-5, bfloat16 to 2e-2 (the tolerances of
  ``tests/test_kernels.py``; the two sides sum x² in another order).
* K4, flash attention: causal, window 37 and non-causal, with padding
  (257 rows against blocks of 64) and D = 96; float32 to 2e-5, bfloat16
  to 2e-2.

The CUDA kernels themselves are held to the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU ops run fastest on one thread, beside JAX's own pool
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro.kernels.rmsnorm import ops as rn_ops  # noqa: E402
from repro.kernels.rmsnorm import ref as rn_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_fa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as t_fa_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as RK  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as t_rn  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as t_rn_ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """One float32 numpy array as a JAX and a torch array of ``dtype``:
    both round to nearest even, so they hold the same values."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# K3: RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 64, 128), (100, 300), (7, 13, 65),
                                   (1, 256), (3, 1536)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_matches_reference(shape, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    s = rng.standard_normal(shape[-1:]).astype(np.float32)
    jx, tx = _pair(x, dtype)
    js, ts = _pair(s, dtype)
    got = t_rn.rmsnorm(tx, ts)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for want in (rn_ops.rmsnorm(jx, js, block_rows=64, interpret=True),
                 rn_ref.rmsnorm_ref(jx, js)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol,
                                   atol=1e-5)
    # the port's oracle is its plain version, and the wrapper counts only
    # launches of the kernel
    before = RK.launches["rmsnorm"]
    np.testing.assert_array_equal(_f32(t_rn_ref.rmsnorm_ref(tx, ts)),
                                  _f32(got))
    assert RK.launches["rmsnorm"] == before


def test_rmsnorm_eps_reaches_the_plain_version():
    x = torch.zeros(2, 8)
    s = torch.ones(8)
    # rsqrt(0 + eps) * 0 is 0 for any eps; a large eps shrinks the output
    y = torch.ones(2, 8)
    np.testing.assert_allclose(t_rn.rmsnorm(y, s, eps=3.0).numpy(), 0.5,
                               rtol=1e-6)
    assert torch.equal(t_rn.rmsnorm(x, s), x)


# ---------------------------------------------------------------------------
# K4: flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,sq,skv,hq,hkv,d", [
    (2, 128, 128, 4, 2, 64),
    (2, 257, 257, 4, 1, 128),
    (1, 64, 64, 2, 2, 96),
], ids=["gqa2_d64", "pad257_d128", "mha_d96"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 37),
                                           (False, 0)],
                         ids=["causal", "window37", "full"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_matches_reference(b, sq, skv, hq, hkv, d, causal,
                                           window, dtype):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    got = t_fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    tol = 2e-5 if dtype == "float32" else 2e-2
    kernel = fa_ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    block_q=64, block_k=64, interpret=True)
    oracle = fa_ref.attention_ref(jq, jk, jv, causal=causal, window=window)
    for want in (kernel, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol,
                                   atol=tol)
    np.testing.assert_array_equal(
        _f32(t_fa_ref.attention_ref(tq, tk, tv, causal=causal,
                                    window=window)), _f32(got))


def test_flash_attention_rows_with_every_key_masked():
    """A window of 1 leaves each row its own key only, so most key blocks
    are fully masked for every row: they must add nothing (p is multiplied
    by the mask, although exp(-1e30 - (-1e30)) = 1)."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
               for _ in range(3))
    got = t_fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True, window=1)
    np.testing.assert_allclose(got.numpy(), v, rtol=1e-6, atol=1e-6)
    want = fa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, window=1,
                                  block_q=16, block_k=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_rejects_bad_gqa():
    q = torch.zeros((1, 8, 3, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError):
        t_fa.flash_attention(q, k, k)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(jnp.zeros((1, 8, 3, 16)),
                               jnp.zeros((1, 8, 2, 16)),
                               v=jnp.zeros((1, 8, 2, 16)), interpret=True)


def test_flash_attention_cpu_takes_any_head_dim():
    """The head-dim limit is the CUDA kernel's; the plain version on the
    CPU takes any D and counts no launch."""
    before = FK.launches["flash_attention"]
    q = torch.randn(1, 5, 2, 24)
    out = t_fa.flash_attention(q, q, q, causal=False)
    assert out.shape == q.shape
    assert FK.launches["flash_attention"] == before
    assert 24 not in FK.HEAD_DIMS
