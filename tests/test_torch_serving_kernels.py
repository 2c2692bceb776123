"""The serving kernels' plain versions in the port against the reference.

The same numpy inputs go through the reference's Pallas kernels (interpret
mode) and their jnp oracles, and through the port's wrappers, which take
the plain PyTorch versions for tensors on the CPU:

* K3, RMSNorm: float32 to rtol 1e-5, bfloat16 to 2e-2 (the tolerances of
  ``tests/test_kernels.py``; the two sides sum x² in another order).
* K4, flash attention: causal, window 37 and non-causal, with padding
  (257 rows against blocks of 64) and D = 96; float32 to 2e-5, bfloat16
  to 2e-2.

Two things the card path adds are pinned here without a card: K3's
``_check``, which refuses each layout, dtype and device the kernel does
not take (the card runs it once per call signature), and K4's one
numerical departure, p rounded to bfloat16 before p·v, done in plain
PyTorch and held to the Pallas kernel within the bf16 tolerance.

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


# ---------------------------------------------------------------------------
# K3's checks, which the card path runs once per call signature
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make,exc,match", [
    (lambda: (torch.zeros(4, 8), torch.ones(8)), RuntimeError,
     "CUDA device"),
    (lambda: (torch.zeros(()), torch.ones(1)), ValueError, "scalar"),
    (lambda: (torch.zeros(4, 8, dtype=torch.float16), torch.ones(8)),
     TypeError, "float32 or bfloat16"),
    (lambda: (torch.zeros(4, 8), torch.ones(8, dtype=torch.float64)),
     TypeError, "float32 or bfloat16"),
    (lambda: (torch.zeros(8, 4).t(), torch.ones(8)), ValueError,
     "unit stride"),
    (lambda: (torch.zeros(4, 8), torch.ones(16)[::2]), ValueError,
     "unit stride"),
    (lambda: (torch.zeros(3, 2, 8).transpose(0, 1), torch.ones(8)),
     ValueError, "one stride apart"),
    (lambda: (torch.zeros(4, 8), torch.ones(7)), ValueError,
     "scale must be"),
], ids=["device", "rank", "dtype", "scale_dtype", "stride", "scale_stride",
        "row_stride", "scale_shape"])
def test_rmsnorm_check_refuses(make, exc, match):
    """Every refusal of K3's card path, on CPU tensors: ``_check`` tests
    the device last, so each other refusal shows here."""
    x, scale = make()
    with pytest.raises(exc, match=match):
        RK._check(x, scale)


def test_rmsnorm_row_stride_of_views():
    """The row stride K3 reads ``x [..., D]`` with: contiguous rows, the
    last position of each request (prefill's final norm), size-1 dims of
    any stride, and leading dims that no single stride describes."""
    assert RK._row_stride(torch.zeros(4, 8)) == 8
    assert RK._row_stride(torch.zeros(8, 5, 8)[:, -1:]) == 40
    assert RK._row_stride(torch.zeros(2, 1, 8)) == 8
    assert RK._row_stride(torch.zeros(1, 8)) == 8
    assert RK._row_stride(torch.zeros(3, 2, 8).transpose(0, 1)) is None
    assert RK._row_stride(torch.zeros(6, 8)[::2]) == 16


# ---------------------------------------------------------------------------
# K4's one numerical departure: p rounded to bfloat16 before p·v
# ---------------------------------------------------------------------------

def _attention_p_bf16(q, k, v, *, causal, window, block_k=128):
    """Blockwise online softmax over tiles of ``block_k`` keys, as the
    card's bfloat16 K4 computes it: float32 scores of the bf16 inputs,
    float32 m, l and acc, l summed from the float32 p, and p rounded to
    bfloat16 for the p·v product."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)                        # [b, hq, sq, d]
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(hq // hkv, 1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(hq // hkv, 1)
    m = torch.full((b, hq, sq, 1), FK.NEG_INF)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    q_pos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, block_k):
        k_pos = torch.arange(k0, min(k0 + block_k, skv))[None, :]
        mask = torch.ones((sq, k_pos.shape[1]), dtype=torch.bool)
        if causal:
            mask &= k_pos <= q_pos
        if window:
            mask &= k_pos > q_pos - window
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2) / d ** 0.5
        s = torch.where(mask, s, FK.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new) * mask
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ \
            vf[:, :, k0:k0 + block_k]
        m = m_new
    o = acc / l.clamp_min(1e-30)
    return o.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window", [
    (2, 128, 4, 2, 64, True, 0),
    (2, 257, 4, 1, 128, True, 37),
    (1, 100, 8, 1, 32, False, 0),
], ids=["causal_gqa2", "window37_gqa4", "full_gqa8"])
def test_flash_attention_p_in_bf16_within_tolerance(b, s, hq, hkv, d, causal,
                                                    window):
    """The card's bf16 K4 rounds p to bfloat16 for p·v, where the Pallas
    kernel multiplies float32 p by float32 v.  That rounding, done here in
    plain PyTorch, stays within the bf16 tolerance (2e-2) of the Pallas
    kernel in interpret mode and of the port's plain version."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "bfloat16") for a in (q, k, v))
    got = _attention_p_bf16(tq, tk, tv, causal=causal, window=window)
    kernel = fa_ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    block_q=64, block_k=64, interpret=True)
    plain = FK.attention_plain(tq, tk, tv, causal=causal, window=window)
    for want in (_f32(kernel), _f32(plain)):
        np.testing.assert_allclose(_f32(got), want, rtol=2e-2, atol=2e-2)
    # the rounding is a real departure: some output moves by a bf16 step
    assert np.abs(_f32(got) - _f32(plain)).max() > 0
