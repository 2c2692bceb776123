"""Oracle for the flash-attention kernel under the reference's name: the
plain PyTorch version (full materialization) that sits beside the kernel in
``kernel.py``."""

from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    NEG_INF, attention_plain as attention_ref)
