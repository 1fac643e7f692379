"""The branch verify (K6, csrc/sha256.cu ``merkle_verify``) on the
edge inputs that ``chip_smoke.py``'s ``edge_phase`` gives the card, held
here through its plain version to the JAX package's ``verify_branches``
(JAX on the CPU): one-leaf trees (D = 0), odd leaf lengths, indices with
bits above 31 (the kernel, like the reference's callers, reads their low
32 bits), a ragged B and one tampered leaf, sibling and index in every 32
branches.  A numpy model of the kernel's per-level select (left and right
words chosen by a mask from the index bit, then one node hash) gives the
plain version's digests, and the SASS check's arithmetic is pinned on
the counts it read on the card.  Tolerance zero."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleisthenes_tpu.ops import sha256_xla
from cleisthenes_tpu_torch.csrc import sass_ops
from cleisthenes_tpu_torch.ops import sha256_cuda

import chip_smoke as cs

# (tag, trees, leaves a tree, L, index bits above 31)
EDGES = [
    ("depth0", 37, 1, 45, False),
    ("odd_L", 5, 8, 101, False),
    ("high_index_bits", 4, 16, 64, True),
    ("ragged_B", 10, 10, 33, False),
]


def _case(tag, b, n, length, high):
    """(roots, leaves, branches, indices, expected verdicts) of every leaf
    of b seeded trees, tampered per 32 branches as chip_smoke.py does."""
    rng = np.random.default_rng(len(tag) * 1000 + n)
    shards = rng.integers(0, 256, (b, n, length), dtype=np.uint8)
    forest = sha256_cuda.build_forest_plain(torch.from_numpy(shards)).numpy()
    br, idx = cs.tree_branches(np, forest, n)
    leaves = shards.reshape(b * n, length).copy()
    if high:
        idx |= (np.arange(b * n, dtype=np.int64) % 0x7FFFFFFF + 1) << 32
    expect = cs.tamper_per_warp(np, leaves, br, idx)
    roots = np.repeat(forest[:, -1], n, 0)
    return roots, leaves, br, idx, expect


@pytest.mark.parametrize("tag,b,n,length,high", EDGES)
def test_verify_plain_matches_reference_on_edges(tag, b, n, length, high):
    roots, leaves, br, idx, expect = _case(tag, b, n, length, high)
    want = np.asarray(sha256_xla.verify_branches(
        jnp.asarray(roots), jnp.asarray(leaves), jnp.asarray(br),
        jnp.asarray(idx.astype(np.uint32)),  # the low 32 bits, as the reference takes them
    ))
    got = sha256_cuda.verify_branches(*(torch.from_numpy(a) for a in (roots, leaves, br, idx)))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, expect) and not expect.all()


def _words(digest: bytes) -> np.ndarray:
    return np.frombuffer(digest, dtype=">u4").astype(np.uint32)


def select_model(leaves, br, idx) -> np.ndarray:
    """The kernel's level loop in numpy: per level a mask of all ones
    where the running digest is the right child (bit d of the index's low
    32 bits), left = cur ^ ((cur ^ sib) & mask), right = sib ^ ((cur ^
    sib) & mask), then one node hash; (B, 32) digests."""
    out = np.zeros((len(idx), 32), dtype=np.uint8)
    for i in range(len(idx)):
        cur = _words(hashlib.sha256(b"\x00" + leaves[i].tobytes()).digest())
        x = int(idx[i]) & 0xFFFFFFFF
        for lvl in range(br.shape[1]):
            sib = _words(br[i, lvl].tobytes())
            mask = np.uint32(-(x & 1) & 0xFFFFFFFF)
            d = (cur ^ sib) & mask
            msg = b"\x01" + (cur ^ d).astype(">u4").tobytes() + (sib ^ d).astype(">u4").tobytes()
            cur = _words(hashlib.sha256(msg).digest())
            x >>= 1
        out[i] = np.frombuffer(cur.astype(">u4").tobytes(), np.uint8)
    return out


@pytest.mark.parametrize("tag,b,n,length,high", EDGES)
def test_branch_free_select_gives_the_plain_digests(tag, b, n, length, high):
    _roots, leaves, br, idx, _expect = _case(tag, b, n, length, high)
    plain = sha256_cuda.branch_digests_plain(*(torch.from_numpy(a) for a in (leaves, br, idx)))
    assert np.array_equal(select_model(leaves, br, idx), plain.numpy())


def test_tree_branches_and_tampering():
    """chip_smoke.py's branch assembly is the reference host Merkle's
    ``branch``, and its tampering flips one leaf, one sibling and one
    index in each 32 branches, each verdict then False."""
    from cleisthenes_tpu.ops.merkle import CpuMerkle

    rng = np.random.default_rng(5)
    shards = rng.integers(0, 256, (3, 7, 20), dtype=np.uint8)
    forest = sha256_cuda.build_forest_plain(torch.from_numpy(shards)).numpy()
    br, idx = cs.tree_branches(np, forest, 7)
    trees = CpuMerkle().build_batch(shards)
    for t in range(3):
        for j in range(7):
            assert [row.tobytes() for row in br[7 * t + j]] == trees[t].branch(j)
    assert np.array_equal(idx, np.tile(np.arange(7), 3))
    leaves = shards.reshape(21, 20).copy()
    expect = cs.tamper_per_warp(np, leaves, br, idx)
    assert np.flatnonzero(~expect).tolist() == [1, 7, 13]


def test_sass_check_counts_one_node():
    """sass_ops' one-node check on the counts the card's SASS gave
    (sm_90a, nvcc 12.8): the shipped kernel 6,531 ALU instructions, its
    leaf part 3,493, a node 2,675 (one copy); with the branch on the index
    bit put back the kernel holds 9,190 (two)."""
    counts = {"_ZN41_GLOBAL__N_merkle_verify_kernelEPKh": 6531, "probe_leaf": 3493,
              "probe_node": 2675}
    assert round(sass_ops.verify_nodes(counts)) == 1
    counts["_ZN41_GLOBAL__N_merkle_verify_kernelEPKh"] = 9190
    assert round(sass_ops.verify_nodes(counts)) == 2


def test_sha_bound_splits_pipes():
    """The SHA bounds count instructions by pipe: the probes' SASS
    histograms (sm_90a, nvcc 12.8) give ``SHA_BLOCK_OPS`` and
    ``SHA_NODE_OPS`` (IMADs issue on the FMA pipe, VIADD's pipe is not
    known), and a bound is the larger of the INT32-pipe count over that
    pipe's rate and the whole count over the issue rate."""
    compress = {"SHF": 672, "LOP3": 352, "IADD3": 241, "IMAD": 118, "ULDC": 33, "LDG": 24,
                "NOP": 11, "STG": 8, "LDC": 3, "EXIT": 1, "BRA": 1}
    node = {"SHF": 1284, "LOP3": 683, "IADD3": 453, "IMAD": 228, "LDC": 35, "VIADD": 26,
            "LDG": 16, "NOP": 15, "STG": 8, "ULDC": 1, "LEA": 1, "EXIT": 1, "BRA": 1}
    assert sass_ops.pipe_split(compress) == sass_ops.SHA_BLOCK_OPS == (1265, 1383)
    assert sass_ops.pipe_split(node) == sass_ops.SHA_NODE_OPS == (2421, 2675)
    assert cs.ISSUE_OPS_PER_S == 2 * cs.INT32_OPS_PER_S
    # N=512's verify: 262,144 branches of a 129-byte leaf (3 blocks), D=9
    ops = cs.sha_ops(262144 * 3, 262144 * 9)
    assert ops == (262144 * (3 * 1265 + 9 * 2421), 262144 * (3 * 1383 + 9 * 2675))
    ms, by = cs.bound(262144 * (32 + 128 + 9 * 32 + 8 + 1), *ops)
    assert by == "operations" and ms == pytest.approx(ops[0] / cs.INT32_OPS_PER_S * 1e3)
    assert ms < cs.bound(0, 262144 * (3 * 1383 + 9 * 2675))[0]
    # all issued, none known to be INT32-pipe work: the issue rate bounds it
    ms, by = cs.bound(0, 0, 10**9)
    assert by == "operations" and ms == pytest.approx(10**9 / cs.ISSUE_OPS_PER_S * 1e3)
    ms, _ = cs.tc_bound(0, 0, 7.9e15, 10**9, 3 * 10**9)
    assert ms == pytest.approx(3 * 10**9 / cs.ISSUE_OPS_PER_S * 1e3)
