"""Oracle for bucket pack/unpack under the reference's names: the plain
PyTorch versions that sit beside the kernels in ``kernel.py``."""

from repro_torch.kernels.bucket_pack.kernel import (  # noqa: F401
    TILE, pad_flat, pack_plain as pack_ref, unpack_plain as unpack_ref)
