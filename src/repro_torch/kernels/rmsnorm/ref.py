"""Oracle for the fused RMSNorm kernel under the reference's name: the
plain PyTorch version that sits beside the kernel in ``kernel.py``."""

from repro_torch.kernels.rmsnorm.kernel import (  # noqa: F401
    rmsnorm_plain as rmsnorm_ref)
