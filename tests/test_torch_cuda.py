"""The port on the card: the CUDA kernels against their plain versions, and
the train step and the serving engine going through them.  Every test here
needs an NVIDIA GPU and skips without one; on a machine with a card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports neither JAX nor the reference package, so it runs where
only the port is installed.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.kernels.bucket_pack import kernel as K  # noqa: E402
from repro_torch.models import registry  # noqa: E402

pytestmark = pytest.mark.cuda

F32, BF16 = torch.float32, torch.bfloat16
CASES = {
    "three_f32": ([(33,), (128, 7), (512,)], [F32] * 3),
    "three_bf16": ([(33,), (128, 7), (512,)], [BF16] * 3),
    "one_bf16": ([(1,)], [BF16]),
    "five_f32": ([(5, 5), (1000,), (3, 5, 7), (2048,), (17,)], [F32] * 5),
    "mixed": ([(33,), (70,), (600,), (4, 128)], [BF16, F32, BF16, F32]),
    "forty": ([(7,)] * 20 + [(3, 11)] * 20, [F32] * 30 + [BF16] * 10),
    "wide": ([(1536, 259), (8960,), (256, 1536)], [BF16] * 3),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA only")
    return torch.device("cuda")


def _bits(t):
    return t.view({F32: torch.int32, BF16: torch.int16}[t.dtype])


def _members(case, device, misaligned=False):
    shapes, dtypes = CASES[case]
    rng = np.random.default_rng(0)
    out = []
    for s, dt in zip(shapes, dtypes):
        a = torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        t = a.to(device=device, dtype=dt)
        if misaligned:
            # a contiguous view one element into a larger storage: not
            # 16-byte aligned, so the kernels take their scalar path
            host = torch.empty(t.numel() + 1, dtype=dt, device=device)
            host[1:].copy_(t.reshape(-1))
            t = host[1:].view(s)
        out.append(t)
    return out


@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_bit_equal_to_plain(case, misaligned, cuda):
    members = _members(case, cuda, misaligned)
    table = K.MemberTable(members)
    before = dict(K.launches)
    buf = K.pack(table)
    want = K.pack_plain(members)
    torch.cuda.synchronize()
    assert buf.dtype == want.dtype
    assert torch.equal(_bits(buf), _bits(want))
    outs = [torch.full_like(m, float("nan")) for m in members]
    K.unpack(K.MemberTable(outs), buf)
    plain = [torch.empty_like(m) for m in members]
    K.unpack_plain_into(plain, buf)
    torch.cuda.synchronize()
    for o, p, m in zip(outs, plain, members):
        assert torch.equal(_bits(o), _bits(p))
        assert torch.equal(_bits(o), _bits(m))
    assert K.launches["bucket_pack"] == before["bucket_pack"] + 1
    assert K.launches["bucket_unpack"] == before["bucket_unpack"] + 1


def test_wrappers_raise_rather_than_fall_back(cuda):
    members = _members("three_f32", cuda)
    table = K.MemberTable(members)
    bad = torch.empty(table.total + 1, device=cuda)[1:]     # misaligned
    with pytest.raises(ValueError, match="aligned"):
        K.unpack(table, bad)
    with pytest.raises(ValueError):
        K.unpack(table, torch.empty(table.total - K.TILE, device=cuda))
    with pytest.raises(TypeError):
        K.MemberTable([torch.ones(8, device=cuda, dtype=torch.float16)])


def test_train_step_launches_once_per_bucket(cuda, tmp_path):
    import torch.distributed as dist
    from repro_torch.train.step import build_train_step
    b = registry.reduced_arch("qwen2-1.5b")
    par = dataclasses.replace(b.parallel, dp_axes=("data",), zero=0,
                              scan_layers=False, pack_kernel=True,
                              attn_chunk=32)
    run = dataclasses.replace(b.run_config("train_4k", par),
                              shape=ShapeConfig("tiny", "train", 32, 4))
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp_path, "store"), 1), rank=0, world_size=1)
    try:
        params = {}
        for strategy in ("wfbp", "single"):
            step_fn, init_fn, art = build_train_step(
                b.model(par), run, strategy=strategy, device=cuda)
            state = init_fn(torch.Generator(device=cuda).manual_seed(0))
            pipe = DataPipeline(b.cfg, run.shape, seed=0)
            K.reset_launches()
            for s in range(3):
                state, metrics = step_fn(state, pipe.batch_at(s))
            torch.cuda.synchronize()
            want = art.plan.num_buckets * 3
            assert K.launches == {"bucket_pack": want, "bucket_unpack": want}
            assert np.isfinite(metrics["loss"].item())
            params[strategy] = [p.detach().clone() for p in
                                state.params["stages"][0]["blk00"]["attn"]
                                .values()]
        for a, w in zip(params["wfbp"], params["single"]):
            assert torch.equal(_bits(a), _bits(w))
    finally:
        dist.destroy_process_group()


# K1 over its chunk list: (shapes, member dtypes, misaligned member indices)
EDGE = {
    "zero_size": ([(0,), (33,), (0,), (1024,)], [BF16] * 4, ()),
    "off_by_2_bytes": ([(1000,), (4, 300), (17,)], [BF16] * 3, (1,)),
    "mixed": ([(33,), (70,), (600,), (4, 128), (4096,)],
              [BF16, F32, BF16, F32, F32], ()),
    "one_element": ([(1,)] * 6, [BF16, F32] * 3, ()),
    "forty": ([(7,)] * 20 + [(3, 11)] * 20, [F32] * 30 + [BF16] * 10, ()),
    "larger_than_a_chunk": ([(3, 20000), (70000,), (5,)], [BF16, F32, BF16],
                            ()),
}


def _edge_members(case, device):
    shapes, dtypes, off = EDGE[case]
    rng = np.random.default_rng(1)
    out = []
    for j, (s, dt) in enumerate(zip(shapes, dtypes)):
        a = torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        t = a.to(device=device, dtype=dt)
        if j in off:
            host = torch.empty(t.numel() + 1, dtype=dt, device=device)
            host[1:].copy_(t.reshape(-1))
            t = host[1:].view(s)
        out.append(t)
    return out


@pytest.mark.parametrize("buf_dtype", [F32, BF16], ids=["f32_buf",
                                                         "bf16_buf"])
@pytest.mark.parametrize("case", sorted(EDGE))
def test_k1_chunk_list_bit_equal_to_plain(case, buf_dtype, cuda):
    members = _edge_members(case, cuda)
    if case == "off_by_2_bytes":
        assert members[1].data_ptr() % 16 == 2
    table = K.MemberTable(members)
    for _ in range(2):           # the second call reuses the cached lists
        buf = K.pack(table, buf_dtype)
        torch.cuda.synchronize()
        want = K.pack_plain(members, buf_dtype)
        assert buf.dtype == want.dtype and buf.shape == want.shape
        assert torch.equal(_bits(buf), _bits(want))
    assert list(table.pack_args) == [buf_dtype]


def test_k1_k2_raise_on_moved_storage_and_bad_buffer(cuda):
    members = _members("three_bf16", cuda)
    table = K.MemberTable(members)
    with pytest.raises(RuntimeError, match="moved"):
        table.check([members[0], members[1].clone(), members[2]])
    with pytest.raises(ValueError):
        K.pack(table, torch.float16)
    with pytest.raises(ValueError, match="aligned"):
        K.unpack(table, torch.empty(table.total + 1, dtype=BF16,
                                    device=cuda)[1:])
    with pytest.raises(ValueError):
        K.unpack(table, K.pack(table).float()[:-1])


def test_zero1_step_launches_and_plans_agree(cuda, tmp_path):
    """ZeRO-1 packs each bucket twice a step (gradients, then parameters)
    and unpacks it once (the gathered parameters).  Without clipping, two
    plans give bit-identical parameters."""
    import torch.distributed as dist
    from repro_torch.train.step import build_train_step
    b = registry.reduced_arch("qwen2-1.5b")
    par = dataclasses.replace(b.parallel, dp_axes=("data",), zero=1,
                              scan_layers=False, pack_kernel=True,
                              attn_chunk=32)
    run = dataclasses.replace(b.run_config("train_4k", par),
                              shape=ShapeConfig("tiny", "train", 32, 4),
                              grad_clip=0.0)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp_path, "store"), 1), rank=0, world_size=1)
    try:
        params = {}
        for strategy in ("wfbp", "single"):
            step_fn, init_fn, art = build_train_step(
                b.model(par), run, strategy=strategy, device=cuda)
            state = init_fn(torch.Generator(device=cuda).manual_seed(0))
            pipe = DataPipeline(b.cfg, run.shape, seed=0)
            K.reset_launches()
            for s in range(3):
                state, metrics = step_fn(state, pipe.batch_at(s))
            torch.cuda.synchronize()
            n = art.plan.num_buckets * 3
            assert K.launches == {"bucket_pack": 2 * n, "bucket_unpack": n}
            assert np.isfinite(metrics["loss"].item())
            assert len(state.opt_state) == art.plan.num_buckets
            params[strategy] = [p.detach().clone() for p in
                                state.params["stages"][0]["blk00"]["attn"]
                                .values()]
        for a, w in zip(params["wfbp"], params["single"]):
            assert torch.equal(_bits(a), _bits(w))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The serving kernels: K3 (RMSNorm) and K4 (flash attention).
# ---------------------------------------------------------------------------

def _randn(shape, dtype, device, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _close(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,dtype,scale_dtype,offset", [
    ((100, 300), F32, F32, 0),
    ((7 * 13, 65), BF16, BF16, 0),
    ((64, 1536), BF16, BF16, 0),
    ((8, 1536), BF16, F32, 0),
    ((33, 128), F32, BF16, 1),          # rows not 16-byte aligned
    ((8, 1, 1536), BF16, BF16, -1),     # one row of each request: strided
], ids=["f32_300", "bf16_65", "bf16_1536", "bf16_x_f32_scale", "misaligned",
        "strided_rows"])
def test_rmsnorm_kernel_matches_plain(shape, dtype, scale_dtype, offset,
                                      cuda):
    from repro_torch.kernels.rmsnorm import kernel as RK, ops as rn
    if offset < 0:          # the last position of [8, 5, 1536], as prefill
        x = _randn((shape[0], 5, shape[2]), dtype, cuda)[:, -1:, :]
    else:
        n = shape[0] * shape[1]
        x = _randn(n + offset, dtype, cuda)[offset:].view(shape)
    s = _randn(shape[-1:], scale_dtype, cuda, seed=1)
    before = RK.launches["rmsnorm"]
    got = rn.rmsnorm(x, s, eps=1e-6)
    torch.cuda.synchronize()
    assert RK.launches["rmsnorm"] == before + 1
    _close(got, RK.rmsnorm_plain(x, s, 1e-6), 1e-5 if dtype == F32 else 2e-2)


@pytest.mark.parametrize("b,s,skv,hq,hkv,d,dtype,causal,window", [
    (2, 257, 257, 4, 1, 128, F32, True, 0),
    (2, 128, 128, 4, 2, 64, BF16, True, 37),
    (1, 64, 64, 2, 2, 96, F32, False, 0),
    (1, 100, 100, 8, 8, 32, BF16, True, 0),
    (2, 40, 40, 4, 2, 16, F32, True, 1),
    # bfloat16 runs the tensor-core kernel: every head dim, ragged lengths,
    # window 1 (fully masked tiles), no mask, and Skv != Sq
    (2, 130, 130, 4, 2, 16, BF16, True, 0),
    (2, 128, 128, 4, 2, 32, BF16, False, 0),
    (2, 128, 128, 4, 2, 64, BF16, True, 0),
    (2, 200, 200, 4, 2, 96, BF16, True, 0),
    (2, 257, 257, 4, 1, 128, BF16, True, 0),
    (2, 100, 100, 4, 2, 128, BF16, True, 0),
    (2, 40, 40, 4, 2, 16, BF16, True, 1),
    (2, 257, 257, 4, 1, 128, BF16, True, 1),
    (2, 128, 128, 4, 2, 128, BF16, False, 0),
    (2, 100, 300, 4, 2, 128, BF16, False, 0),
    (2, 300, 100, 4, 2, 64, BF16, True, 0),
], ids=["pad257_f32", "window37_bf16", "full_d96_f32", "mha_d32_bf16",
        "window1_d16_f32", "d16_bf16", "full_d32_bf16", "d64_bf16",
        "d96_bf16", "pad257_d128_bf16", "ragged100_bf16", "window1_d16_bf16",
        "window1_d128_bf16", "full_d128_bf16", "skv_longer_bf16",
        "skv_shorter_bf16"])
def test_flash_attention_kernel_matches_plain(b, s, skv, hq, hkv, d, dtype,
                                              causal, window, cuda):
    from repro_torch.kernels.flash_attention import kernel as FK, ops as fa
    q = _randn((b, s, hq, d), dtype, cuda, 0)
    # k and v as strided views of one [B, Skv, 2, Hkv, D] tensor
    kv = _randn((b, skv, 2, hkv, d), dtype, cuda, 1)
    k, v = kv[:, :, 0], kv[:, :, 1]
    before = FK.launches["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FK.launches["flash_attention"] == before + 1
    want = FK.attention_plain(q, k, v, causal=causal, window=window)
    _close(got, want, 2e-5 if dtype == F32 else 2e-2)


def test_rmsnorm_signature_cache_still_raises(cuda):
    """A repeated call signature skips K3's checks; a new one, even of the
    same shape, runs them all and raises as before."""
    from repro_torch.kernels.rmsnorm import kernel as RK
    x = _randn((16, 256), BF16, cuda)
    s = _randn((256,), BF16, cuda, seed=1)
    before = RK.launches["rmsnorm"]
    first = RK.rmsnorm_rows(x, s)
    second = RK.rmsnorm_rows(x, s)
    torch.cuda.synchronize()
    assert RK.launches["rmsnorm"] == before + 2
    assert torch.equal(first, second)
    _close(first, RK.rmsnorm_plain(x, s), 2e-2)
    bad = torch.zeros((256, 16), dtype=BF16, device=cuda).t()
    with pytest.raises(ValueError, match="unit stride"):
        RK.rmsnorm_rows(bad, s)
    with pytest.raises(TypeError):
        RK.rmsnorm_rows(x.half(), s)
    with pytest.raises(ValueError, match="one stride apart"):
        RK.rmsnorm_rows(_randn((3, 2, 256), BF16, cuda).transpose(0, 1), s)
    assert RK.launches["rmsnorm"] == before + 2


def test_serving_kernels_raise_rather_than_fall_back(cuda):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import kernel as RK
    q = torch.zeros((1, 8, 4, 24), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)                     # D = 24
    with pytest.raises(ValueError):
        fa.flash_attention(torch.zeros((1, 8, 3, 16), device=cuda),
                           torch.zeros((1, 8, 2, 16), device=cuda),
                           torch.zeros((1, 8, 2, 16), device=cuda))
    q = torch.zeros((1, 8, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention(q, q.transpose(1, 3).contiguous().transpose(1, 3),
                           q)
    with pytest.raises(RuntimeError, match="CUDA device"):
        fa.flash_attention(q, q.cpu(), q)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    qb = torch.zeros(1 * 8 * 2 * 32 + 1, dtype=BF16, device=cuda)[1:]
    qb = qb.view(1, 8, 2, 32)                   # not 16-byte aligned
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention(qb, qb, qb)
    x = torch.zeros((4, 64), device=cuda)
    with pytest.raises(RuntimeError, match="CUDA device"):
        RK.rmsnorm_rows(x, torch.ones(64))
    with pytest.raises(ValueError, match="unit stride"):
        RK.rmsnorm_rows(torch.zeros((64, 4), device=cuda).t(),
                        torch.ones(64, device=cuda))


def test_serve_engine_launches_kernels(cuda):
    """Reduced qwen2-1.5b in float32, greedy: the card (kernels) and the CPU
    (plain versions) give the same tokens, and the counters read one K3
    launch per norm and one K4 launch per layer's prefill attention."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.utils import tree
    b = registry.reduced_arch("qwen2-1.5b")
    b = dataclasses.replace(b, cfg=dataclasses.replace(b.cfg,
                                                       dtype="float32"))
    model = b.model(dataclasses.replace(b.parallel, scan_layers=False))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [torch.arange(10, dtype=torch.int32),
               torch.arange(5, dtype=torch.int32)]
    want = ServeEngine(model, params, max_len=32,
                       device="cpu").generate(prompts, 6)
    card_params = tree.tree_map(lambda t: t.to(cuda), params)
    RK.reset_launches()
    FK.reset_launches()
    got = ServeEngine(model, card_params, max_len=32,
                      device=cuda).generate(prompts, 6)
    layers = b.cfg.num_layers
    assert RK.launches["rmsnorm"] == (2 * layers + 1) * 6
    assert FK.launches["flash_attention"] == layers
    assert got == want


# ---------------------------------------------------------------------------
# The Measure stage and the live replan loop on the card.
# ---------------------------------------------------------------------------

def test_nccl_comm_fit_one_rank(cuda, tmp_path):
    """One rank's NCCL all-reduce moves no bytes between cards: the fit is
    dispatch cost.  An NCCL group refuses buffers on the CPU."""
    import torch.distributed as dist
    from repro_torch.train import replan
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp_path, "store"), 1), rank=0, world_size=1)
    try:
        m = replan.measure_comm_model(dist.group.WORLD, ("data",),
                                      (1 << 16, 1 << 20, 1 << 24),
                                      n_warmup=2, n_iters=5)
        assert m.a >= 0.0 and m.b >= 0.0 and m.time(1 << 20) > 0.0
        with pytest.raises(ValueError):
            replan.measure_comm_model(dist.group.WORLD, ("data",),
                                      (1 << 16,), device="cpu")
    finally:
        dist.destroy_process_group()


def test_closed_loop_swap_on_the_card(cuda, tmp_path):
    """Reduced qwen2-1.5b, seeded with wfbp: the loop swaps to fewer
    buckets, K1 and K2 launch once per bucket of the plan in force each
    step, and the parameters stay bit-identical to never-replanned wfbp."""
    import torch.distributed as dist
    from repro_torch.core.cost_model import AllReduceModel
    from repro_torch.train import replan
    from repro_torch.train.step import build_train_step
    from repro_torch.utils import tree
    b = registry.reduced_arch("qwen2-1.5b")
    par = dataclasses.replace(b.parallel, dp_axes=("data",), zero=0,
                              scan_layers=False, pack_kernel=True,
                              attn_chunk=32)
    run = dataclasses.replace(b.run_config("train_4k", par),
                              shape=ShapeConfig("tiny", "train", 32, 4))
    prior = AllReduceModel(1e-4, 1e-9)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp_path, "store"), 1), rank=0, world_size=1)
    try:
        step_fn, init_fn, _ = build_train_step(
            b.model(par), run, strategy="wfbp", comm_model=prior,
            device=cuda)
        state = init_fn(torch.Generator(device=cuda).manual_seed(0))
        pipe = DataPipeline(b.cfg, run.shape, seed=0)
        for s in range(6):
            state, _ = step_fn(state, pipe.batch_at(s))
        want = [p.detach().clone() for p in tree.leaves(state.params)]
        del state
        ctl, init_fn, _ = replan.closed_loop(
            b.model(par), run, strategy="wfbp", comm_model=prior, warmup=1,
            interval=2, hysteresis=1e-9, device=cuda)
        state = init_fn(torch.Generator(device=cuda).manual_seed(0))
        per_step = []
        for s in range(6):
            in_force = ctl.plan.num_buckets
            K.reset_launches()
            state, metrics = ctl.step_fn(state, pipe.batch_at(s))
            torch.cuda.synchronize()
            assert K.launches == {"bucket_pack": in_force,
                                  "bucket_unpack": in_force}
            per_step.append(in_force)
        assert ctl.swaps and len(set(per_step)) > 1
        assert per_step[-1] < per_step[0]
        state.grad_sync.check(state.grads)
        for a, w in zip(tree.leaves(state.params), want):
            assert torch.equal(_bits(a), _bits(w))
    finally:
        dist.destroy_process_group()
