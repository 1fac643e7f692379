"""Native (C++) host kernels, loaded via ctypes.

Copies of ``cleisthenes_tpu/native``'s batched SHA-256 and 256-bit
Montgomery modexp sources, compiled on demand with the system g++ into
``cleisthenes_tpu_torch/_build/native/``.  They serve the host half of
the lockstep epoch: CP-challenge and keystream hashing, and the BBA /
decryption-share modexp engine (``ModEngine('cpu')``).
"""

from cleisthenes_tpu_torch.native.build import load_modpow, load_sha256

__all__ = ["load_modpow", "load_sha256"]
