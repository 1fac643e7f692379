"""Multi-device parallelism for the crypto plane (SURVEY.md §2.2, §5.7-5.8)."""

from cleisthenes_tpu_torch.parallel.mesh import CryptoMesh, make_crypto_mesh

__all__ = ["CryptoMesh", "make_crypto_mesh"]
