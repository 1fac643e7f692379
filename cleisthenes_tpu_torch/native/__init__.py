"""Native (C++) host kernels, loaded via ctypes.

Copies of ``cleisthenes_tpu/native``'s batched SHA-256, 256-bit
Montgomery modexp and GF(2^8) Reed-Solomon sources, compiled on demand
with the system g++ into ``cleisthenes_tpu_torch/_build/native/``.  They
serve the host half of the lockstep epoch — CP-challenge and keystream
hashing, and the BBA / decryption-share modexp engine
(``ModEngine('cpu')``) — and the ``'cpp'`` erasure backend
(ops/rs_cpp.py).  ``native_available()`` reports whether the GF(2^8)
library built; selecting ``crypto_backend='cpp'`` without it raises.
"""

from cleisthenes_tpu_torch.native.build import (
    load_gf256,
    load_modpow,
    load_sha256,
    native_available,
)

__all__ = ["load_gf256", "load_modpow", "load_sha256", "native_available"]
