"""The flagship step and its multi-device dry run.

The port of the reference's ``__graft_entry__.py``.  ``flagship(n, f,
length)`` is one epoch's batched RBC crypto plane across all N
validators at once: GF(2^8) Reed-Solomon encode (K1 ``rs_encode``) and
the SHA-256 Merkle forest (K5 ``build_forest``), on one device.

``dryrun_multichip(n_devices)`` shards that step over a ('v', 'l') mesh
(parallel/mesh.py).  The framework's parallel axes (SURVEY.md §2.2) map
onto the classic ML-parallelism names as:

  - 'v' (validator axis)  = data-parallel: each device owns a slice of
    the N concurrent RBC instances' tensors.
  - 'l' (shard-length axis) = sequence-parallel: the RS product is
    length-parallel (the contraction is over the k-shard axis), so L
    shards across devices; the Merkle stage then needs whole shards,
    so each 'v' row gathers its length tiles over 'l' before the forest
    — the gather the reference's compiler inserts as an all-gather.

Where the reference lets GSPMD place and partition, the port places
tiles itself and launches each kernel once a tile on the tile's device.
Both default to the card; ``devices`` may list one card several times
(or the CPU, whose tiles run the kernels' plain versions).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from cleisthenes_tpu_torch.ops import gf256
from cleisthenes_tpu_torch.ops.rs_cuda import mark_systematic, rs_encode
from cleisthenes_tpu_torch.ops.sha256_cuda import build_forest

# the dry run's roster and batch: N=64/f=21, a 256-tx lockstep epoch
DRYRUN_N, DRYRUN_F, DRYRUN_BATCH, DRYRUN_KEY_SEED = 64, 21, 256, 5


def encode_matrix(n: int, k: int, device) -> torch.Tensor:
    """The (n, k) systematic RS matrix on ``device``, checked for
    ``rs_encode`` (``mark_systematic``)."""
    host = gf256.systematic_rs_matrix(n, k)
    enc = torch.from_numpy(np.ascontiguousarray(host, dtype=np.uint8)).to(device)
    mark_systematic(enc, host)
    return enc


def flagship(n: int, f: int, length: int, device="cuda"):
    """Build (step, example_args) for an (n, f) roster on ``device``.

    ``step(data)``: data (B, k, L) uint8, every validator's proposal
    shards -> (roots (B, 32) uint8, encoded (B, n, L) uint8), the
    Merkle roots each RBC VAL round broadcasts plus the full shard
    sets; the example batch is B = n proposals of ``length`` bytes a
    shard from ``default_rng(0)``, as the reference's."""
    k = n - 2 * f
    dev = torch.device(device)
    enc = encode_matrix(n, k, dev)

    def epoch_crypto_step(data: torch.Tensor):
        encoded = rs_encode(enc, data)
        forest = build_forest(encoded)  # (B, 2p-1, 32), root row last
        return forest[:, -1, :], encoded

    rng = np.random.default_rng(0)
    data = torch.from_numpy(
        rng.integers(0, 256, size=(n, k, length), dtype=np.uint8)
    ).to(dev)
    return epoch_crypto_step, (data,)


def entry(device="cuda"):
    """(step, example_args) at the single-device check's roster."""
    return flagship(n=8, f=2, length=256, device=device)


def mesh_dims(n_devices: int):
    """The reference's (v, l) choice for ``n_devices``."""
    v_dim = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    return v_dim, n_devices // v_dim


def dryrun_multichip(
    n_devices: int,
    devices: Optional[Sequence] = None,
    n: int = DRYRUN_N,
    f: int = DRYRUN_F,
    batch: int = DRYRUN_BATCH,
    key_seed: int = DRYRUN_KEY_SEED,
) -> dict:
    """Run the epoch step sharded over an n_devices ('v', 'l') mesh, then
    one lockstep epoch on the sharded crypto plane.

    RS encode runs on each (v, l) tile; each 'v' row gathers its length
    tiles over 'l' (onto every device of the row, as the reference's
    output sharding P('v', None, None)) and builds its forest; the root
    checksum reduces across 'v'.  Asserts the input tiles (n/v, k, L/l)
    and the gathered blocks (n/v, n, L) on every device, then runs a
    ``LockstepCluster`` epoch of ``batch`` txs with ``mesh_shape=(v,
    l)`` on the same devices, which must commit every tx.  ``devices``
    defaults to the first n_devices cards (fewer raise).  Returns the
    roots, the encoded shards, the checksum and the epoch's batches."""
    from cleisthenes_tpu_torch.config import Config
    from cleisthenes_tpu_torch.parallel.mesh import CryptoMesh
    from cleisthenes_tpu_torch.protocol.spmd import LockstepCluster

    v_dim, l_dim = mesh_dims(n_devices)
    mesh = CryptoMesh((v_dim, l_dim), devices)
    grid = mesh.mesh.devices
    # a scale where sharding matters: a 10k-tx batch proposal at N=64
    # RS-shards to ~450 B, rounded up to the 'l'-divisible 512
    length = max(512, 64 * l_dim)
    length += (-length) % l_dim
    k = n - 2 * f
    _step, (data,) = flagship(n=n, f=f, length=length, device=grid[0, 0])
    data = data.cpu().numpy()
    data, _ = mesh.pad_rows(data, v_dim)

    tiles = mesh.put_vl(data)
    assert len(tiles) == n_devices, len(tiles)
    assert [t.tensor.device for t in tiles] == mesh.flat_devices
    in_shapes = {tuple(t.tensor.shape) for t in tiles}
    assert in_shapes == {(data.shape[0] // v_dim, k, length // l_dim)}, in_shapes
    encs = {}
    enc_tiles = []
    for t in tiles:
        dev = t.tensor.device
        if dev not in encs:
            encs[dev] = encode_matrix(n, k, dev)
        enc_tiles.append(rs_encode(encs[dev], t.tensor))
    # the gather over 'l': every device of a 'v' row gets the row's
    # whole shards; each row hashes its forest once, on its first device
    blocks, roots = [], []
    for i in range(v_dim):
        row = enc_tiles[i * l_dim : (i + 1) * l_dim]
        for j in range(l_dim):
            dev = grid[i, j]
            blocks.append(torch.cat([e.to(dev) for e in row], dim=-1))
        roots.append(build_forest(blocks[i * l_dim])[:, -1, :])
    out_shapes = {tuple(b.shape) for b in blocks}
    assert len(blocks) == n_devices
    assert out_shapes == {(data.shape[0] // v_dim, n, length)}, out_shapes
    # the cross-'v' reduce of the roots' checksum
    dev0 = grid[0, 0]
    checksum = int(sum(r.to(dev0).to(torch.int64).sum() for r in roots))
    encoded = np.concatenate(
        [blocks[i * l_dim].cpu().numpy() for i in range(v_dim)]
    )[:n]
    root_rows = np.concatenate([r.cpu().numpy() for r in roots])[:n]
    assert encoded.shape == (n, n, length), encoded.shape
    assert checksum > 0

    # the lockstep executor over the same mesh at the same roster: one
    # complete epoch (RS/Merkle/coin/TPKE waves) with the crypto plane
    # mesh-sharded
    cfg = Config(
        n=n,
        batch_size=batch,
        crypto_backend="cuda",
        device=str(dev0),
        mesh_shape=(v_dim, l_dim),
    )
    cluster = LockstepCluster(
        config=cfg, key_seed=key_seed, mesh_devices=mesh.flat_devices
    )
    for i in range(batch):
        cluster.submit(b"graft-tx-%03d" % i)
    cluster.run_epoch()
    committed = sum(len(b) for b in cluster.committed())
    assert committed == batch, committed
    print(
        f"dryrun_multichip ok: mesh "
        f"{dict(zip(mesh.mesh.axis_names, grid.shape))}, roster n={n} "
        f"f={f}, encoded {encoded.shape} ({len(blocks)} blocks of "
        f"{tuple(blocks[0].shape)} across {n_devices} devices), root "
        f"checksum {checksum}, lockstep N={n} epoch committed "
        f"{committed} txs on the sharded plane",
        flush=True,
    )
    return {
        "mesh": mesh.shape,
        "roots": root_rows,
        "encoded": encoded,
        "checksum": checksum,
        "in_tile_shape": in_shapes.pop(),
        "out_block_shape": out_shapes.pop(),
        "batches": list(cluster.committed()),
    }


__all__ = ["dryrun_multichip", "entry", "flagship", "mesh_dims"]
