"""The crypto-plane device mesh: multi-device sharding by explicit tiles.

The port of ``cleisthenes_tpu/parallel/mesh.py``.  SURVEY.md §2.2/§5.7
pin the two parallel axes this framework owns:

- ``'v'`` — the validator/instance axis.  N concurrent RBC instances
  produce N independent tensor workloads per epoch; sharding the batch
  axis over 'v' is the data-parallel axis.
- ``'l'`` — the shard-length axis.  RS coding is GF(2)-linear along a
  shard's byte columns, so the length axis shards cleanly — the
  framework's sequence-parallel analogue.

Placement policy per kernel family, as in the reference:

- RS encode/decode (ops/rs_cuda.py): batch over 'v', length over 'l'
  (``put_vl``); the contraction is over the k-shard axis, so the tiles
  need no exchange.  Per-instance decode matrices cut over 'v' only
  (``put_v``).
- Merkle forest / branch verify / modexp (ops/merkle.py,
  ops/modmath.py): independent across the batch, so the batch axis cuts
  over ALL devices flat (``put_flat``).

PyTorch has no GSPMD partitioner, and in one process ``torch.distributed``
does not apply, so the port places tiles itself: each ``put_*`` cuts a
host array into ``Tile``s, one a device (a tensor and the block of the
whole it holds), the caller launches its kernel once per tile on the
tile's device, and ``gather`` copies the results back into one array in
the reference's order, after every tile has launched.

The device list may repeat a device: the tests shard over eight handles
of the CPU (the kernels' plain versions), the counterpart of the eight
virtual CPU devices the reference's tests force, and one card can carry
a (2, 4) mesh as eight handles of itself.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


def validate_mesh_shape(mesh_shape) -> Tuple[int, int]:
    """Normalize/validate a (v, l) mesh shape (shared by Config and
    CryptoMesh so both layers accept exactly the same shapes)."""
    ms = tuple(mesh_shape)
    # bool is an int subclass: (True, True) must not validate as (1, 1)
    if len(ms) != 2 or any(
        isinstance(d, bool) or (not isinstance(d, int)) or d < 1 for d in ms
    ):
        raise ValueError(
            f"mesh_shape must be two positive ints (v, l), got {mesh_shape!r}"
        )
    return ms


def default_devices(device, count: int) -> List[torch.device]:
    """The mesh devices a caller naming ``device`` gets: ``count``
    handles of the CPU for a CPU device, else the first ``count``
    visible cards; raises ValueError when fewer cards are visible
    (never a smaller mesh)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * count
    if dev.type != "cuda":
        raise ValueError(f"unsupported mesh device {str(dev)!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < count:
        raise ValueError(f"a mesh of {count} devices needs {count} cards, have {have}")
    return [torch.device("cuda", i) for i in range(count)]


class DeviceGrid(NamedTuple):
    """The (v, l) grid of devices: ``devices`` an object array of
    ``torch.device``, row-major over ``axis_names``."""

    devices: np.ndarray
    axis_names: Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class Tile:
    """One device's block of a placed array: the block as a tensor on
    its device, and where it sits in the whole — ``rows`` of axis 0 and
    ``cols`` of the last axis (all of it unless the array was cut over
    'l')."""

    tensor: torch.Tensor
    rows: slice
    cols: slice = slice(None)

    def index(self) -> tuple:
        """The block's index into an output of the whole's layout."""
        if self.cols == slice(None):
            return (self.rows,)
        return (self.rows, Ellipsis, self.cols)


def _to(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    # a contiguous, writable copy where the block is a strided or
    # read-only view (the codecs hand in views of bytes objects)
    return torch.from_numpy(np.require(a, requirements="CW")).to(dev)


def _block(size: int, parts: int, what: str) -> int:
    if size % parts:
        raise ValueError(f"{what} of {size} does not cut into {parts} equal blocks")
    return size // parts


class CryptoMesh:
    """A ('v', 'l') grid of torch devices plus the placement helpers the
    crypto plane uses.

    ``mesh_shape=(v, l)`` is ``Config.mesh_shape``.  ``devices``
    defaults from ``device`` (``default_devices``): v*l handles of the
    CPU, or the first v*l cards; an explicit list may repeat a device.
    """

    def __init__(
        self,
        mesh_shape: Tuple[int, int],
        devices: Optional[Sequence] = None,
        device="cuda",
    ):
        v, l = validate_mesh_shape(mesh_shape)
        if devices is None:
            devices = default_devices(device, v * l)
        if len(devices) < v * l:
            raise ValueError(
                f"mesh {mesh_shape} needs {v * l} devices, have {len(devices)}"
            )
        grid = np.empty(v * l, dtype=object)
        grid[:] = [torch.device(d) for d in devices[: v * l]]
        self.shape = (v, l)
        self.n_devices = v * l
        self.mesh = DeviceGrid(grid.reshape(v, l), ("v", "l"))

    @property
    def flat_devices(self) -> List[torch.device]:
        """The devices in ('v', 'l') order."""
        return list(self.mesh.devices.reshape(-1))

    # -- placement ---------------------------------------------------------

    def put_vl(self, x: np.ndarray) -> List[Tile]:
        """Cut a (B, ..., L) array batch-over-'v', length-over-'l': tile
        (i, j) on ``devices[i, j]``, in ('v', 'l') order.  B and L must
        divide by v and l (``pad_rows``, ``pad_cols``)."""
        v, l = self.shape
        bv = _block(x.shape[0], v, "batch")
        bl = _block(x.shape[-1], l, "length")
        tiles = []
        for (i, j), dev in np.ndenumerate(self.mesh.devices):
            rows = slice(i * bv, (i + 1) * bv)
            cols = slice(j * bl, (j + 1) * bl)
            tiles.append(Tile(_to(x[rows, ..., cols], dev), rows, cols))
        return tiles

    def put_v(self, x: np.ndarray) -> List[Tile]:
        """Cut an array batch-over-'v', each block repeated over 'l'
        (per-instance matrices whose trailing axes are contractions);
        the tiles pair with ``put_vl``'s, in ('v', 'l') order."""
        bv = _block(x.shape[0], self.shape[0], "batch")
        tiles = []
        for (i, _j), dev in np.ndenumerate(self.mesh.devices):
            rows = slice(i * bv, (i + 1) * bv)
            tiles.append(Tile(_to(x[rows], dev), rows))
        return tiles

    def put_flat(self, *arrays: np.ndarray) -> Tuple[List[Tile], ...]:
        """Cut each array's batch axis over every device in ('v', 'l')
        order; returns one tile list per input."""
        out = []
        for a in arrays:
            b = _block(a.shape[0], self.n_devices, "batch")
            out.append([
                Tile(_to(a[d * b : (d + 1) * b], dev), slice(d * b, (d + 1) * b))
                for d, dev in enumerate(self.flat_devices)
            ])
        return tuple(out)

    @staticmethod
    def gather(tiles: Sequence[Tile], outs: Sequence[torch.Tensor], shape, dtype=np.uint8) -> np.ndarray:
        """One host array of ``shape`` from per-tile results: ``outs[i]``
        is tile i's block of the output (its rows, and its columns when
        cut over 'l').  Callers launch every tile before this first copy
        back, so tiles on several cards overlap."""
        out = np.empty(shape, dtype=dtype)
        for t, o in zip(tiles, outs):
            out[t.index()] = o.cpu().numpy()
        return out

    # -- batch padding -----------------------------------------------------

    @staticmethod
    def pad_rows(a: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
        """Pad axis 0 up to a multiple by repeating row 0 (valid data,
        so padded lanes execute the same math); returns (padded,
        original_len)."""
        b = a.shape[0]
        pad = (-b) % multiple
        if pad:
            a = np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
        return a, b

    @staticmethod
    def pad_cols(a: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
        """Zero-pad the LAST axis up to a multiple; returns (padded,
        original_len).  Used for the 'l' (shard-length) axis, where
        byte columns are independent under GF coding."""
        l = a.shape[-1]
        pad = (-l) % multiple
        if pad:
            widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
            a = np.pad(a, widths)
        return a, l

    @staticmethod
    def pad_zero_rows(a: np.ndarray, multiple: int) -> np.ndarray:
        """Zero-pad axis 0 up to a multiple (the hash and modexp
        batches' padding, whose rows are cut off after)."""
        pad = (-a.shape[0]) % multiple
        if not pad:
            return a
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


def make_crypto_mesh(
    mesh_shape: Optional[Tuple[int, int]],
    devices: Optional[Sequence] = None,
    device="cuda",
) -> Optional[CryptoMesh]:
    """None-passthrough constructor (mesh_shape=None = single-device)."""
    if mesh_shape is None:
        return None
    return CryptoMesh(tuple(mesh_shape), devices, device=device)


__all__ = [
    "CryptoMesh",
    "DeviceGrid",
    "Tile",
    "default_devices",
    "make_crypto_mesh",
    "validate_mesh_shape",
]
