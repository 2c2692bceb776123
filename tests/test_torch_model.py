"""The port's dense LM against the reference's, on reduced qwen2-1.5b in
float32 so that the comparison checks the algorithm: the same parameters
(carried over through the bridge) and the same batch give the same loss
and the same per-leaf gradients."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU ops run fastest on one thread, beside JAX's own pool
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeConfig as RShapeConfig  # noqa: E402
from repro.core import bucketer as r_bucketer  # noqa: E402
from repro.data.pipeline import DataPipeline as RDataPipeline  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import registry as r_registry  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import bucketer  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.models import layers, registry  # noqa: E402

SEQ, BATCH = 48, 2


def _models(attn_chunk, remat="block"):
    r_b = r_registry.reduced_arch("qwen2-1.5b")
    b = registry.reduced_arch("qwen2-1.5b")
    r_cfg = dataclasses.replace(r_b.cfg, dtype="float32")
    cfg = dataclasses.replace(b.cfg, dtype="float32")
    r_par = dataclasses.replace(r_b.parallel, scan_layers=False, zero=0,
                                attn_chunk=attn_chunk, remat=remat)
    par = dataclasses.replace(b.parallel, scan_layers=False, zero=0,
                              attn_chunk=attn_chunk, remat=remat)
    return (dataclasses.replace(r_b, cfg=r_cfg).model(r_par),
            dataclasses.replace(b, cfg=cfg).model(par))


def _ref_params(r_model, seed=0):
    tree = jax.jit(r_model.init)(jax.random.PRNGKey(seed))
    return tree, {p: np.asarray(v) for p, v in
                  r_bucketer.leaves_in_backward_order(tree)}


def _batch(cfg, seed=0):
    r = RDataPipeline(cfg, RShapeConfig("t", "train", SEQ, BATCH), seed=seed
                      ).batch_at(3)
    t = DataPipeline(cfg, ShapeConfig("t", "train", SEQ, BATCH), seed=seed
                     ).batch_at(3)
    return r, t


def test_batches_byte_identical():
    r_model, model = _models(64)
    r, t = _batch(model.cfg)
    for k in ("tokens", "labels"):
        assert t[k].dtype == torch.int32
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(r[k]))


def test_bridge_round_trip_and_order():
    r_model, model = _models(64)
    tree, arrays = _ref_params(r_model)
    params = bridge.params_from_numpy(arrays, device="cpu")
    back = bridge.params_to_numpy(params)
    assert list(back) == [m.path for m in r_bucketer.leaf_metadata(tree)]
    assert [m.path for m in bucketer.leaf_metadata(params)] == list(back)
    for p, a in arrays.items():
        np.testing.assert_array_equal(back[p], a)
    # the port's own init builds the same tree: paths, shapes and dtypes
    mine = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert [(m.path, m.shape) for m in bucketer.leaf_metadata(mine)] == \
        [(m.path, m.shape) for m in r_bucketer.leaf_metadata(tree)]


@pytest.mark.parametrize("attn_chunk", [64, 16], ids=["one_chunk", "chunked"])
def test_loss_and_grads_match_reference(attn_chunk):
    r_model, model = _models(attn_chunk)
    tree, arrays = _ref_params(r_model)
    r_b, t_b = _batch(model.cfg)

    (r_loss, r_metrics), r_grads = jax.jit(jax.value_and_grad(
        r_model.loss, has_aux=True))(tree, r_b)
    r_grads = {p: np.asarray(v)
               for p, v in r_bucketer.leaves_in_backward_order(r_grads)}

    params = bridge.params_from_numpy(arrays, device="cpu")
    for _, p in bucketer.leaves_in_backward_order(params):
        p.requires_grad_(True)
    loss, metrics = model.loss(params, t_b)
    loss.backward()
    loss = loss.detach()

    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["tokens"]),
                               float(r_metrics["tokens"]))
    grads = {p: v.grad.numpy()
             for p, v in bucketer.leaves_in_backward_order(params)}
    assert list(grads) == list(r_grads)
    for p in grads:
        np.testing.assert_allclose(grads[p], r_grads[p], rtol=1e-4,
                                   atol=1e-5, err_msg=p)


@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("chunk", [48, 16, 20])
def test_attention_matches_reference(chunk, window):
    """The chunked online-softmax attention, GQA 4:1, causal and sliding
    window, including a chunk that does not divide the sequence."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, SEQ, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, SEQ, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, SEQ, 1, 16)).astype(np.float32)
    want = r_layers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window, chunk=chunk)
    got = layers.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True, window=window,
                           chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    ref = layers.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               window=window)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
