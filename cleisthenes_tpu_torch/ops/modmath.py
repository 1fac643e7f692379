"""Batched 256-bit modular arithmetic: the host engine.

The engine under threshold-encryption share issue/verify and the
common-coin combine (reference docs/THRESHOLD_ENCRYPTION-EN.md:33-36,
docs/BBA-EN.md:163-181).  This is the host part of
``cleisthenes_tpu/ops/modmath.py``: the group parameters, the byte
codecs and ``ModEngine('cpu')`` over the native Montgomery kernel
(native/modpow256.cpp, python ``pow`` when the toolchain is missing).

The device Montgomery programs (the reference's ``_pow_fused``,
``_dual_pow_fused``, ``_pow_fused_grouped`` and ``mont_mul_batch``)
are the port's slice 2 (ROADMAP.md): until then the ``'cuda'`` crypto
backend routes every modexp here, as the reference's ``'cpp'`` backend
does (``BatchCrypto.engine_backend``).

The group: Z_p* with a fixed 256-bit safe prime p = 2q+1, operating in
the order-q quadratic-residue subgroup generated by g=4.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence

import numpy as np

# 256-bit safe prime p = 2q + 1 (generated deterministically, seed
# 20260729, 64-round Miller-Rabin) and the prime order q of the QR
# subgroup; g = 4 generates it.
P = 0xFFB28EF6A7CB6CEE1758160402FB047422834BD4AF8E388BD0BB1F438E9DA767
Q = (P - 1) // 2
G = 4


def exps_to_bytes(exps: Sequence[int]) -> np.ndarray:
    """(B,) ints -> (B, 32) uint8 big-endian (the packed exponent form
    the device kernels take)."""
    return np.frombuffer(
        b"".join(e.to_bytes(32, "big") for e in exps), dtype=np.uint8
    ).reshape(len(exps), 32)


def ints_to_bytes33(xs: Sequence[int]) -> np.ndarray:
    """(B,) ints -> (B, 33) uint8 little-endian (264-bit capacity)."""
    return np.frombuffer(
        b"".join(x.to_bytes(33, "little") for x in xs), dtype=np.uint8
    ).reshape(len(xs), 33)


def bytes33_to_ints(arr: np.ndarray) -> List[int]:
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    return [int.from_bytes(row.tobytes(), "little") for row in arr]


@dataclasses.dataclass(frozen=True)
class GroupParams:
    """One multiplicative group: safe prime p = 2q + 1 and a generator
    g of the order-q QR subgroup.  Hashable: engines cache per group."""

    p: int
    q: int
    g: int

    @property
    def nbytes(self) -> int:
        """Byte width of a group element (transcript hashing width)."""
        return (self.p.bit_length() + 7) // 8


DEFAULT_GROUP = GroupParams(p=P, q=Q, g=G)


def _ints_to_bytes32le(xs: Sequence[int]) -> np.ndarray:
    """(B,) ints < 2^256 -> (B, 32) uint8 little-endian (the native
    kernel's ABI layout: 4 u64 limbs)."""
    return np.frombuffer(
        b"".join(x.to_bytes(32, "little") for x in xs), dtype=np.uint8
    ).reshape(len(xs), 32)


def _bytes32le_to_ints(arr: np.ndarray) -> List[int]:
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    return [int.from_bytes(row.tobytes(), "little") for row in arr]


def _native_modpow():
    """The compiled Montgomery kernel (native/modpow256.cpp), or None."""
    from cleisthenes_tpu_torch.native.build import load_modpow

    return load_modpow()


class ModEngine:
    """Host-facing batched modexp over one GroupParams group.

    ``'cpu'`` is the only backend of this slice: the native C++
    Montgomery kernel for <=256-bit odd moduli when the toolchain
    builds it, else python ``pow()`` (which also serves arbitrarily
    large moduli).
    """

    def __init__(self, backend: str = "cpu", group: GroupParams = DEFAULT_GROUP):
        if backend != "cpu":
            raise ValueError(
                f"modexp backend {backend!r}: the port's device modexp "
                "is slice 2 (ROADMAP.md); only 'cpu' exists"
            )
        self.backend = backend
        self.group = group
        fits256 = group.p.bit_length() <= 256 and group.p % 2 == 1
        self._nat = _native_modpow() if fits256 else None
        # keep the modulus buffer alive for the pointer's lifetime
        self._mod_arr = (
            np.frombuffer(group.p.to_bytes(32, "little"), dtype=np.uint8).copy()
            if self._nat
            else None
        )

    def pow_batch_grouped(self, groups: Sequence[tuple]) -> List[List[int]]:
        """[[base^e for e in exps] per (base, exps) group] — the
        shared-base wave shape, flattened into one ``pow_batch``."""
        flat_b: List[int] = []
        flat_e: List[int] = []
        for base, exps in groups:
            flat_b.extend([base] * len(exps))
            flat_e.extend(exps)
        flat = self.pow_batch(flat_b, flat_e)
        out = []
        off = 0
        for _base, exps in groups:
            out.append(flat[off : off + len(exps)])
            off += len(exps)
        return out

    def pow_batch(self, bases: Sequence[int], exps: Sequence[int]) -> List[int]:
        """[b_i^e_i mod p] for all i in one native call."""
        assert len(bases) == len(exps)
        if not bases:
            return []
        gp = self.group.p
        if self._nat is None:
            return [pow(b, e, gp) for b, e in zip(bases, exps)]
        # reduce mod P first: python-pow semantic parity for any int
        # input; out-of-range exponents raise in to_bytes — loudly
        base_b = _ints_to_bytes32le([b % gp for b in bases])
        exp_b = _ints_to_bytes32le(exps)
        out = np.empty((len(bases), 32), dtype=np.uint8)
        self._nat.modpow256_batch(
            base_b.ctypes.data,
            exp_b.ctypes.data,
            self._mod_arr.ctypes.data,
            out.ctypes.data,
            len(bases),
        )
        return _bytes32le_to_ints(out)

    def dual_pow_batch(
        self,
        u1: Sequence[int],
        e1: Sequence[int],
        u2: Sequence[int],
        e2: Sequence[int],
    ) -> List[int]:
        """[u1_i^e1_i * u2_i^e2_i mod p] — the CP-verification op."""
        assert len(u1) == len(e1) == len(u2) == len(e2)
        if not u1:
            return []
        gp = self.group.p
        if self._nat is None:
            return [
                pow(a, x, gp) * pow(b, y, gp) % gp
                for a, x, b, y in zip(u1, e1, u2, e2)
            ]
        u1_b = _ints_to_bytes32le([u % gp for u in u1])
        e1_b = _ints_to_bytes32le(e1)
        u2_b = _ints_to_bytes32le([u % gp for u in u2])
        e2_b = _ints_to_bytes32le(e2)
        out = np.empty((len(u1), 32), dtype=np.uint8)
        self._nat.dualpow256_batch(
            u1_b.ctypes.data,
            e1_b.ctypes.data,
            u2_b.ctypes.data,
            e2_b.ctypes.data,
            self._mod_arr.ctypes.data,
            out.ctypes.data,
            len(u1),
        )
        return _bytes32le_to_ints(out)


@functools.cache
def get_engine(backend: str = "cpu", group: GroupParams = DEFAULT_GROUP) -> ModEngine:
    """Process-cached engine per (backend, group); ModEngine is
    stateless apart from its loaded kernel."""
    return ModEngine(backend, group=group)


def get_engine_degraded(
    backend: str, group: GroupParams = DEFAULT_GROUP
) -> ModEngine:
    """The reference's "accelerate when possible" engine lookup.  With
    no device modexp in this slice every backend name the protocol
    layer passes resolves to the host engine."""
    return get_engine("cpu", group)


def host_pow_batch(
    bases: Sequence[int],
    exps: Sequence[int],
    group: GroupParams = DEFAULT_GROUP,
) -> List[int]:
    """Host-side [b_i^e_i mod group.p] through the native kernel."""
    return get_engine("cpu", group).pow_batch(list(bases), list(exps))


def host_pow(base: int, exp: int, group: GroupParams = DEFAULT_GROUP) -> int:
    return host_pow_batch([base], [exp], group)[0]


__all__ = [
    "P",
    "Q",
    "G",
    "GroupParams",
    "DEFAULT_GROUP",
    "ModEngine",
    "get_engine",
    "get_engine_degraded",
    "host_pow",
    "host_pow_batch",
    "exps_to_bytes",
    "ints_to_bytes33",
    "bytes33_to_ints",
]
