"""The port on the card: the CUDA kernels against their plain versions, and
the train step going through them.  Every test here needs an NVIDIA GPU
and skips without one; on a machine with a card run

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
