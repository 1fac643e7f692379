"""Batched host-side SHA-256: one native call per wave.

The lockstep executor and the live hub both end every crypto wave
with a host loop that hashes one short transcript per share (CP
challenges) or per Merkle node — at N=128 that is ~265k hashlib calls
per epoch, and the Python call overhead dwarfs the compression work.
``sha256_rows`` hashes a whole (m, stride) row-matrix in one ctypes
crossing via native/sha256rows.cpp, degrading to a hashlib loop when
the toolchain is unavailable (identical digests either way — the
native kernel is plain FIPS 180-4, selftested at load).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np

from cleisthenes_tpu_torch.native.build import load_sha256


def sha256_rows(
    rows: np.ndarray, lens: Optional[np.ndarray] = None
) -> np.ndarray:
    """Digest each row of a (m, stride) uint8 matrix -> (m, 32) uint8.

    ``lens`` gives per-row message lengths (defaults to the full
    stride for every row)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    if rows.ndim != 2:
        raise ValueError(f"rows must be 2-D, got shape {rows.shape}")
    m, stride = rows.shape
    out = np.empty((m, 32), dtype=np.uint8)
    if m == 0:
        return out
    lens32 = None
    if lens is not None:
        lens32 = np.ascontiguousarray(lens, dtype=np.int32)
        if lens32.shape != (m,):
            raise ValueError("lens must be (m,)")
        if int(lens32.min()) < 0 or int(lens32.max()) > stride:
            # the native kernel casts straight to size_t: an
            # out-of-range length would read past the row (and the
            # fallback would silently truncate — reject in both)
            raise ValueError("lens values must be in [0, stride]")
    lib = load_sha256()
    if lib is not None:
        if lens32 is None:
            lib.sha256_rows_fixed(
                rows.ctypes.data, m, stride, stride, out.ctypes.data
            )
        else:
            lib.sha256_rows(
                rows.ctypes.data, m, stride, lens32.ctypes.data,
                out.ctypes.data,
            )
        return out
    # degraded path: identical digests, one hashlib call per row
    if lens32 is None:
        for i in range(m):
            out[i] = np.frombuffer(
                hashlib.sha256(rows[i].tobytes()).digest(), dtype=np.uint8
            )
    else:
        for i in range(m):
            out[i] = np.frombuffer(
                hashlib.sha256(rows[i, : int(lens32[i])].tobytes()).digest(),
                dtype=np.uint8,
            )
    return out


def ints_to_be_rows(values: Sequence[int], nbytes: int) -> np.ndarray:
    """(m, nbytes) big-endian byte matrix from Python ints — the
    transcript field encoder (same bytes as int.to_bytes per item)."""
    m = len(values)
    # one join + one frombuffer for the whole column: per-item
    # frombuffer assignments were a top-5 profile line at N=128
    buf = b"".join(v.to_bytes(nbytes, "big") for v in values)
    return np.frombuffer(buf, dtype=np.uint8).reshape(m, nbytes).copy()


__all__ = ["sha256_rows", "ints_to_be_rows"]
