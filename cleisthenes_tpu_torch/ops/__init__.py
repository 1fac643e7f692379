"""The crypto plane of the port: CUDA kernels, their plain PyTorch
versions, and the host (numpy + native C++) reference backend, behind
the same ``BatchCrypto`` / ``ErasureCoder`` seam as the reference's
``cleisthenes_tpu.ops``."""

from cleisthenes_tpu_torch.ops.backend import (
    BatchCrypto,
    ErasureCoder,
    get_backend,
)

__all__ = ["BatchCrypto", "ErasureCoder", "get_backend"]
