"""Bucket pack/unpack in the port against the reference, bit for bit.

The same numpy inputs go through the reference's Pallas kernels (interpret
mode), its ``pack_ref``/``unpack_ref`` oracle and ``core.bucketer``, and
through the port's plain PyTorch versions and its ``core.bucketer``.  The
CUDA kernels themselves are held to the plain versions by
``tests/test_torch_cuda.py`` on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU ops run fastest on one thread, beside JAX's own pool
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import bucketer as r_bucketer  # noqa: E402
from repro.kernels.bucket_pack import ops as r_ops  # noqa: E402
from repro.kernels.bucket_pack import ref as r_ref  # noqa: E402
from repro_torch.core import bucketer  # noqa: E402
from repro_torch.kernels.bucket_pack import kernel as K  # noqa: E402
from repro_torch.kernels.bucket_pack import ops, ref  # noqa: E402

F32, BF16 = "float32", "bfloat16"

# (shapes, dtypes): the reference's test_kernels.py shapes in f32 and bf16,
# a mixed f32/bf16 bucket, and 40 leaves (beyond the reference's 32-source
# chunking)
CASES = {
    f"{name}_{dt}": (shapes, [dt] * len(shapes))
    for name, shapes in [
        ("three", [(33,), (128, 7), (512,)]),
        ("one", [(1,)]),
        ("five", [(5, 5), (1000,), (3, 5, 7), (2048,), (17,)]),
    ]
    for dt in (F32, BF16)
}
CASES["mixed"] = ([(33,), (70,), (600,), (4, 128)], [BF16, F32, BF16, F32])
CASES["forty"] = ([(7,)] * 20 + [(3, 11)] * 20, [F32] * 30 + [BF16] * 10)


def _inputs(case, seed=0):
    shapes, dtypes = CASES[case]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    j = [jnp.asarray(a).astype(dt) for a, dt in zip(arrays, dtypes)]
    t = [torch.from_numpy(a).to(getattr(torch, dt))
         for a, dt in zip(arrays, dtypes)]
    return j, t


def _bits(x) -> np.ndarray:
    """Raw bits of a jax array or torch tensor, as unsigned integers."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        return x.contiguous().view(view[x.dtype]).numpy().view(
            np.uint32 if x.dtype == torch.float32 else np.uint16)
    x = np.asarray(x)
    return x.view(np.uint32 if x.dtype.itemsize == 4 else np.uint16)


def _same_dtype(t, j):
    assert str(t.dtype).removeprefix("torch.") == jnp.dtype(j.dtype).name


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_pack_bit_equal_to_reference(case):
    j, t = _inputs(case)
    want = r_ref.pack_ref(j)
    got = ref.pack_ref(t)
    _same_dtype(got, want)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the reference's own kernel path (interpret mode) builds the same bytes
    np.testing.assert_array_equal(_bits(r_ops.pack(j, interpret=True)),
                                  _bits(want))
    # and so does the port's list-level wrapper on CPU tensors
    np.testing.assert_array_equal(_bits(ops.pack(t)), _bits(want))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_unpack_bit_equal_to_reference(case):
    j, t = _inputs(case)
    buf_j = r_ref.pack_ref(j)
    buf_t = ref.pack_ref(t)
    shapes = [x.shape for x in j]
    want = r_ref.unpack_ref(buf_j, shapes, [x.dtype for x in j])
    got = ref.unpack_ref(buf_t, [tuple(s) for s in shapes],
                         [x.dtype for x in t])
    got_ops = ops.unpack(buf_t, shapes, [x.dtype for x in t])
    for g, go, w, x in zip(got, got_ops, want, t):
        _same_dtype(g, w)
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(_bits(g), _bits(w))
        np.testing.assert_array_equal(_bits(go), _bits(w))
        # the round trip is the identity (the buffer dtype holds each
        # member exactly: bf16 -> f32 -> bf16 loses nothing)
        np.testing.assert_array_equal(_bits(g), _bits(x))


@pytest.mark.parametrize("aligned", [False, True], ids=["plain", "slots"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bucketer_pack_bit_equal_both_layouts(case, aligned):
    j, t = _inputs(case)
    want = r_bucketer.pack(j, use_kernel=aligned)
    got = bucketer.pack(t, use_kernel=aligned)
    _same_dtype(got, want)
    np.testing.assert_array_equal(_bits(got), _bits(want))

    r_metas = [r_bucketer.LeafMeta(f"l{i}", x.shape, x.dtype, x.size,
                                   x.nbytes) for i, x in enumerate(j)]
    metas = [bucketer.LeafMeta(f"l{i}", tuple(x.shape), x.dtype, x.numel(),
                               x.numel() * x.element_size())
             for i, x in enumerate(t)]
    assert bucketer.packed_elems(metas, aligned) == \
        r_bucketer.packed_elems(r_metas, aligned) == got.numel()
    outs = bucketer.unpack(got, metas, use_kernel=aligned)
    for o, r, x in zip(outs, r_bucketer.unpack(want, r_metas,
                                               use_kernel=aligned), t):
        np.testing.assert_array_equal(_bits(o), _bits(r))
        np.testing.assert_array_equal(_bits(o), _bits(x))


def test_member_table_guards():
    t = [torch.ones(600), torch.ones(7)]
    table = K.MemberTable(t)
    assert table.offsets == [0, 1024] and table.total == 1536
    table.check(t)
    with pytest.raises(RuntimeError, match="moved"):
        table.check([torch.ones(600), t[1]])
    with pytest.raises(ValueError, match="empty"):
        K.MemberTable([])
