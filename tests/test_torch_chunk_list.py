"""K1's chunk list (``kernel.chunk_rows``), checked on the CPU.

The CUDA kernel that walks the list runs only on the card
(``tests/test_torch_cuda.py``).  What it is handed is built in Python, so
here a plain emulation of the kernel's two paths writes the buffer from
the rows of CPU members, and the result is held bit for bit to
``pack_plain``.  Each row is also held to what its path needs: bulk rows
are same-dtype, 16-byte aligned at both ends, a 16-byte multiple and at
most one shared-memory stage; register rows marked ``vec`` are 16-byte
aligned at both ends; and every buffer element is written exactly once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.bucket_pack import kernel as K  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
CASES = {
    "zero_size": ([(0,), (33,), (0,), (1024,)], [BF16] * 4),
    "one_element": ([(1,)] * 5, [BF16, F32, BF16, F32, BF16]),
    "mixed": ([(33,), (70,), (600,), (4, 128)], [BF16, F32, BF16, F32]),
    "forty": ([(7,)] * 20 + [(3, 11)] * 20, [F32] * 30 + [BF16] * 10),
    "larger_than_a_chunk": ([(3, 20000), (8200,), (5,)], [BF16, F32, BF16]),
    "qwen2_block": ([(1536,), (256,), (1536, 256), (1536, 1536)], [BF16] * 4),
}


def _members(case, misaligned):
    shapes, dtypes = CASES[case]
    rng = np.random.default_rng(0)
    out = []
    for s, dt in zip(shapes, dtypes):
        t = torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt)
        if misaligned:
            # one element into a larger storage: 2 or 4 bytes off 16
            host = torch.empty(t.numel() + 1, dtype=dt)
            host[1:].copy_(t.reshape(-1))
            t = host[1:].view(s)
        out.append(t)
    return out


def _bits(t):
    return t.view({F32: torch.int32, BF16: torch.int16}[t.dtype])


def _emulate(members, table, rows_pair, buf_dtype, cap_bytes):
    """What the kernel writes, row by row, with every check of a row."""
    buf = torch.full((table.total,), float("nan"), dtype=buf_dtype)
    written = np.zeros(table.total, np.int64)
    bsz = buf_dtype.itemsize
    spans = [(m.data_ptr(), m.numel() * m.element_size(), m)
             for m in members]
    for kind, rows in zip(("bulk", "reg"), rows_pair):
        for src, dst, nz, dv in rows.tolist():
            n, zeros = nz & 0xFFFFFFFF, nz >> 32
            code, vec = dv & 0xFFFFFFFF, dv >> 32
            dt = {0: F32, 1: BF16}[code]
            if kind == "bulk":
                assert dt == buf_dtype and vec == 0 and zeros == 0
                assert src % 16 == 0 and (n * bsz) % 16 == 0
                assert (dst * bsz) % 16 == 0 and 0 < n * bsz <= cap_bytes
            else:
                assert n * max(dt.itemsize, bsz) <= cap_bytes or n == 0
                if vec:
                    assert src % 16 == 0 and (dst * bsz) % 16 == 0
            if n:
                ptr, nbytes, m = next(s for s in spans
                                      if s[0] <= src < s[0] + s[1])
                assert m.dtype == dt and src + n * dt.itemsize <= ptr + nbytes
                e = (src - ptr) // dt.itemsize
                buf[dst:dst + n] = m.reshape(-1)[e:e + n].to(buf_dtype)
            buf[dst + n:dst + n + zeros] = 0
            written[dst:dst + n + zeros] += 1
    assert (written == 1).all()
    return buf


@pytest.mark.parametrize("cap_bytes", [K.MIN_CHUNK_BYTES, 2080,
                                       K.CHUNK_BYTES],
                         ids=["min_chunk", "odd_chunk", "full_chunk"])
@pytest.mark.parametrize("buf_dtype", [F32, BF16], ids=["f32_buf",
                                                         "bf16_buf"])
@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_list_packs_like_pad_flat_cat(case, misaligned, buf_dtype,
                                            cap_bytes):
    members = _members(case, misaligned)
    table = K.MemberTable(members)
    rows = K.chunk_rows(table.ptrs, table.sizes,
                        [m.dtype for m in members], table.offsets,
                        buf_dtype, cap_bytes)
    got = _emulate(members, table, rows, buf_dtype, cap_bytes)
    want = K.pack_plain(members, buf_dtype)
    assert torch.equal(_bits(got), _bits(want))
    bulk, reg = rows
    same = [m.dtype == buf_dtype for m in members]
    if not misaligned and any(same) and sum(
            m.numel() * m.element_size() for m, s in zip(members, same)
            if s) >= 16 * len(members):
        assert len(bulk)                 # aligned same-dtype data goes bulk
    if misaligned and buf_dtype == BF16 and all(m.dtype == BF16
                                                for m in members):
        # 2 bytes off 16: nothing may take the bulk path
        assert not len(bulk)


def test_chunk_bytes_spreads_small_buckets():
    sms = 132
    full = K.CHUNK_BYTES * sms * K.PACK_BLOCKS_PER_SM
    assert K.chunk_bytes(10 * full, sms) == K.CHUNK_BYTES
    assert K.chunk_bytes(full, sms) == K.CHUNK_BYTES
    assert K.chunk_bytes(full // 4, sms) == K.CHUNK_BYTES // 4
    assert K.chunk_bytes(1000, sms) == K.MIN_CHUNK_BYTES
    for n in (1000, 12345678, full // 3):
        assert K.chunk_bytes(n, sms) % 32 == 0
