"""The Merkle root of one proposal's shards, by hashlib.

Leaf digest SHA-256(0x00 || shard), interior node SHA-256(0x01 || left
|| right); a leaf set pads to the next power of two with the digest of
the fixed string ``cleisthenes-tpu:empty-leaf``.
"""

from __future__ import annotations

import hashlib

import numpy as np

EMPTY_LEAF = hashlib.sha256(b"cleisthenes-tpu:empty-leaf").digest()


def root(shards: np.ndarray) -> bytes:
    """(n, L) uint8 shards -> 32-byte root."""
    level = [hashlib.sha256(b"\x00" + row.tobytes()).digest() for row in shards]
    width = 1
    while width < len(level):
        width *= 2
    level += [EMPTY_LEAF] * (width - len(level))
    while len(level) > 1:
        level = [
            hashlib.sha256(b"\x01" + level[i] + level[i + 1]).digest()
            for i in range(0, len(level), 2)
        ]
    return level[0]
