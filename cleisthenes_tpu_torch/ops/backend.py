"""The BatchCrypto / ErasureCoder seam of the port.

The counterpart of ``cleisthenes_tpu/ops/backend.py``: the per-epoch
crypto (RS encode/decode, Merkle forests and proofs, TPKE share ops,
coin combine) sits behind ``BatchCrypto``/``ErasureCoder``, selected by
``Config.crypto_backend``:

- ``'cuda'``: the RBC data plane — RS codec (ops/rs_cuda.py; past
  256 validators the GF(2^16) codec of ops/rs16.py) and
  Merkle forest / branch checks (ops/merkle.py ``CudaMerkle`` over
  ops/sha256_cuda.py) — in hand-written CUDA kernels on
  ``Config.device``.  On a CPU device the same wrappers run their plain
  PyTorch versions (the tests' setting); a CUDA device on a machine
  without a GPU raises.  The BBA coin and decryption-share modexp runs
  on the CUDA Montgomery kernels too (ops/modmath.py ``ModEngine('cuda')``
  over ops/modexp_cuda.py), on the same device.
- ``'cpu'``: numpy GF tables, native batched SHA-256 and the native
  Montgomery modexp kernel — the reference's ``'cpu'`` backend.
- ``'cpp'``: the reference's ``'cpp'`` backend — the GF(2^8) codec in
  the native host kernel (ops/rs_cpp.py, native/gf256.cpp); hashing and
  modexp on the ``'cpu'`` implementations.
"""

from __future__ import annotations

import abc
from typing import Sequence

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The torch device a ``'cuda'`` backend object runs on.  A CUDA
    device needs a visible GPU: without one this raises instead of
    carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' to run the kernels' plain "
                "PyTorch versions, or crypto_backend='cpu'"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


class ErasureCoder(abc.ABC):
    """Systematic (n, k) Reed-Solomon codec over GF(2^8) (GF(2^16) for
    the ops/rs16.py coders, whose ``MAX_N`` is 65536).

    Shards are byte matrices: ``data`` is (k, L), full shard sets are
    (n, L) with rows 0..k-1 the data shards and rows k..n-1 parity
    (reference rbc/rbc.go:98-100 `shard`, :88-90 `interpolate`).
    """

    MAX_N = 256

    def __init__(self, n: int, k: int):
        if not (1 <= k <= n <= self.MAX_N):
            raise ValueError(
                f"need 1 <= k <= n <= {self.MAX_N}, got n={n} k={k}"
            )
        self.n = n
        self.k = k

    @abc.abstractmethod
    def encode(self, data: np.ndarray) -> np.ndarray:
        """(k, L) data shards -> (n, L) data+parity shards."""

    def _normalize_indices(self, indices: Sequence[int]) -> tuple:
        out = tuple(int(i) for i in indices)
        if len(out) != self.k or len(set(out)) != self.k:
            raise ValueError(
                f"need exactly k={self.k} distinct shard indices, got {out}"
            )
        if not all(0 <= i < self.n for i in out):
            raise ValueError(f"shard indices out of range [0, {self.n}): {out}")
        return out

    def decode(self, indices: Sequence[int], shards: np.ndarray) -> np.ndarray:
        """Reconstruct the (k, L) data shards from any k survivors.

        ``indices``: which of the n shard rows the k given shards are
        (distinct, ascending not required).  ``shards``: (k, L).
        """
        indices = self._normalize_indices(indices)
        shards = np.ascontiguousarray(shards, dtype=np.uint8)
        if shards.ndim != 2 or shards.shape[0] != self.k:
            raise ValueError(f"expected (k={self.k}, L) shards, got {shards.shape}")
        if indices == tuple(range(self.k)):
            return shards.copy()
        return self._decode_impl(indices, shards)

    @abc.abstractmethod
    def _decode_impl(self, indices: tuple, shards: np.ndarray) -> np.ndarray:
        """Backend decode after validation; indices are k distinct ints
        and not the identity pattern."""

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """(B, k, L) -> (B, n, L); default loops, backends override."""
        return np.stack([self.encode(d) for d in data])

    def decode_batch(
        self, indices: np.ndarray, shards: np.ndarray
    ) -> np.ndarray:
        """(B, k) indices + (B, k, L) shards -> (B, k, L) data."""
        return np.stack(
            [self.decode(list(ix), sh) for ix, sh in zip(indices, shards)]
        )


def make_erasure_coder(
    backend: str, n: int, k: int, device="cuda"
) -> ErasureCoder:
    if n > ErasureCoder.MAX_N:
        # past the GF(2^8) shard-index ceiling (the reference's hard
        # limit): the GF(2^16) coders.  The native C++ kernel is
        # 8-bit-only, so 'cpp' serves these rosters from the host
        # reference path.
        from cleisthenes_tpu_torch.ops.rs16 import (
            Cpu16ErasureCoder,
            Cuda16ErasureCoder,
        )

        if backend in ("cpu", "cpp"):
            return Cpu16ErasureCoder(n, k)
        if backend == "cuda":
            return Cuda16ErasureCoder(n, k, device=device)
        raise ValueError(f"unknown erasure backend {backend!r}")
    if backend == "cpu":
        from cleisthenes_tpu_torch.ops.rs_cpu import CpuErasureCoder

        return CpuErasureCoder(n, k)
    if backend == "cpp":
        from cleisthenes_tpu_torch.ops.rs_cpp import CppErasureCoder

        return CppErasureCoder(n, k)
    if backend == "cuda":
        from cleisthenes_tpu_torch.ops.rs_cuda import CudaErasureCoder

        return CudaErasureCoder(n, k, device=device)
    raise ValueError(f"unknown erasure backend {backend!r}")


class BatchCrypto:
    """Bundle of crypto-plane backends for one (n, f) configuration;
    ``get_backend(config)`` is the single construction point used by
    the protocol layer."""

    def __init__(self, backend: str, n: int, f: int, k: int, device="cuda"):
        from cleisthenes_tpu_torch.ops.merkle import make_merkle

        self.backend = backend
        self.n = n
        self.f = f
        self.k = k
        self.erasure = make_erasure_coder(backend, n, k, device=device)
        # the card the modexp engine runs on (a 'cuda' backend's)
        self.device = resolve_device(device) if backend == "cuda" else None
        # the native backend accelerates the GF plane; hashing and
        # modexp stay on their cpu reference implementations ('cuda'
        # hashes on the card too)
        self.merkle = make_merkle(self.engine_backend, device=device)

    @property
    def engine_backend(self) -> str:
        """Backend name for the modexp engine (tpke/coin)."""
        return "cpu" if self.backend == "cpp" else self.backend

    def decode_recheck_batch(self, indices, shards):
        """RBC delivery check: decode + re-encode + Merkle roots
        (docs/RBC-EN.md:37-39) for a batch of instances.

        Returns ``(data (B, k, L), roots (B, 32) uint8, dispatches)``.
        The 'cuda' backend runs the chain as one device-resident call
        (ops/rs_cuda.py ``decode_recheck``); the host backend and the
        GF(2^16) coders (n > 256) take the 3-step sequence."""
        fused = getattr(self.erasure, "decode_recheck_batch", None)
        if fused is not None:
            data, roots = fused(indices, shards)
            return data, roots, 1
        data = self.erasure.decode_batch(indices, shards)
        full = self.erasure.encode_batch(data)
        trees = self.merkle.build_batch(full)
        roots = np.stack(
            [np.frombuffer(t.root, dtype=np.uint8) for t in trees]
        )
        return data, roots, 3

    def tpke(self, pub):
        """Threshold-decryption service bound to this backend."""
        from cleisthenes_tpu_torch.ops.tpke import Tpke

        return Tpke(pub, backend=self.engine_backend, device=self.device)

    def coin(self, pub):
        """Common-coin service bound to this backend."""
        from cleisthenes_tpu_torch.ops.coin import CommonCoin

        return CommonCoin(
            pub, backend=self.engine_backend, device=self.device
        )


def get_backend(config) -> BatchCrypto:
    # k comes from Config.data_shards, the single source of the
    # N - 2f formula (validated there against n >= 3f+1).
    return BatchCrypto(
        config.crypto_backend,
        config.n,
        config.f,
        config.data_shards,
        device=config.device,
    )
