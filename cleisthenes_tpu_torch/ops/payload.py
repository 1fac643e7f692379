"""Payload <-> shard-matrix conversion for RBC.

The reference's RBC splits a proposed batch into N pieces with N-2f
parity (docs/RBC-EN.md:28-31, rbc/rbc.go:98-100).  Here a byte payload
becomes a (k, L) uint8 matrix with a 4-byte length prefix and zero
padding; L is rounded up to a lane-friendly multiple so repeated epoch
sizes hit the same compiled TPU kernel shapes.
"""

from __future__ import annotations

import struct

import numpy as np

LANE_MULTIPLE = 128  # TPU lane width; also bounds jit retraces


def split_payload(payload: bytes, k: int, lane_multiple: int = LANE_MULTIPLE) -> np.ndarray:
    """bytes -> (k, L) uint8 data-shard matrix (length-prefixed, padded)."""
    framed = struct.pack(">I", len(payload)) + payload
    per_shard = -(-len(framed) // k)  # ceil
    per_shard = -(-per_shard // lane_multiple) * lane_multiple
    buf = np.zeros(k * per_shard, dtype=np.uint8)
    buf[: len(framed)] = np.frombuffer(framed, dtype=np.uint8)
    return buf.reshape(k, per_shard)


def join_payload(data_shards: np.ndarray) -> bytes:
    """(k, L) uint8 data-shard matrix -> original bytes."""
    flat = np.ascontiguousarray(data_shards, dtype=np.uint8).reshape(-1)
    if flat.size < 4:
        raise ValueError("shard matrix too small to hold length prefix")
    (length,) = struct.unpack(">I", flat[:4].tobytes())
    if length > flat.size - 4:
        raise ValueError(
            f"corrupt payload: declared length {length} exceeds capacity {flat.size - 4}"
        )
    return flat[4 : 4 + length].tobytes()
